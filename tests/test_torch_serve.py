"""PyTorch port vs JAX reference: greedy generation through ``Engine``.

B = 2 prompts of 24 tokens, so the prefill's quantized linears see
B·S = 48 > 32 rows and take the GEMM path while every decode step (B = 2
rows) takes the GEMV path; 6 new tokens.  The reference runs in float32
under ``force_impl("interpret")`` (its Pallas kernels).  Tolerance: none —
the greedy tokens must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro.train.serve import Engine as JEngine
from repro_torch import bridge
from repro_torch.core import peqa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import registry
from repro_torch.train.serve import Engine

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = tiny_llama_pair()
    fp, jq = reference_params(jcfg, seed=2)
    model = peqa.quantize_params(bridge.to_module(to_numpy(fp), tcfg,
                                                  device="cpu"),
                                 tcfg.quant, device="cpu")
    api = registry.build(tcfg, device="cpu")
    return (JEngine(jregistry.build(jcfg), jq),
            Engine(api, model, device="cpu"))


def test_greedy_tokens_equal_reference(engines, monkeypatch):
    jeng, eng = engines
    rows = {"quant_gemv": [], "quant_matmul": []}
    for name in rows:
        orig = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda x, *a, _n=name, _o=orig:
                            rows[_n].append(x.shape[0]) or _o(x, *a))
    toks = tokens(2, 24, eng.api.cfg.vocab_size, seed=3)
    with jops.force_impl("interpret"):
        want = np.asarray(jeng.generate(jnp.asarray(toks), 6))
    got = eng.generate(toks, 6)
    assert got.shape == (2, 30)
    np.testing.assert_array_equal(got.numpy(), want)
    n_lin = eng.api.cfg.n_layers * 7
    assert rows["quant_matmul"] == [48] * n_lin           # the prefill
    assert rows["quant_gemv"] == [2] * (n_lin * 5)        # 5 decode steps


def test_tight_cache_len_matches_default(engines):
    _, eng = engines
    toks = tokens(1, 5, eng.api.cfg.vocab_size, seed=4)
    np.testing.assert_array_equal(eng.generate(toks, 3, cache_len=7).numpy(),
                                  eng.generate(toks, 3).numpy())


@pytest.mark.parametrize("cache_len", [0, -1, 6])
def test_cache_len_errors_match_reference(engines, cache_len):
    jeng, eng = engines
    toks = tokens(1, 5, eng.api.cfg.vocab_size, seed=5)
    with pytest.raises(ValueError) as jerr:
        with jops.force_impl("interpret"):
            jeng.generate(jnp.asarray(toks), 3, cache_len=cache_len)
    with pytest.raises(ValueError) as terr:
        eng.generate(toks, 3, cache_len=cache_len)
    assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_engine_without_device_raises_without_card(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, eng = engines
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(eng.api, eng.model)

