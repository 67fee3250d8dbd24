"""PyTorch port vs JAX reference: the dense family's two cache options.

  * ``kv_cache_dtype="int8"``: ``attention.quantize_kv`` (symmetric,
    amax/127 floored at 1e-8, half to even, ±127, a float16 scale per
    (token, head)) against the reference's — codes bit-equal, scales
    equal; a generation's cache leaves against the reference's; the
    reference's continuous-batching case (``test_serve_continuous.py``'s
    int8 engine) through the port's ``Engine.serve``.
  * ``swa_window`` (a ring cache of ``min(window, seq_len)`` slots):
    generations that wrap the ring twice, from a prompt shorter and one
    longer than the window (the prefill's roll of the last keys), against
    the reference's; the reference's ``swa_window=6`` continuous-batching
    case in the port.
  * The speculative scheduler's refusals of both options, with the
    reference's reasons.

Models: ``make_tiny(get_config("qwen2-7b"))`` (biases, GQA 4/4 at the tiny
size) and the reference's ``paper_lm`` serving model, PEQA 4-bit, float32,
weights made by the reference.  Tolerances: caches and logits atol/rtol
1e-4 (float32 sums in other orders); an int8 cache's codes and scales
equal (a value within 1e-4 of a rounding boundary could flip a code by
one; on these inputs none does); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import attention as jattention
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig as TQuant
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.models import attention, registry
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine

from test_torch_configs import to_numpy, tokens
from test_torch_dense_archs import policy_tree, tiny_pair
from _torch_threads import _one_torch_thread  # noqa: F401


def _qwen_engines(**kw):
    jcfg, tcfg = tiny_pair("qwen2-7b", **kw)
    tree = policy_tree("qwen2-7b", "peqa")
    return (JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(tree, tcfg, device="cpu"), device="cpu"))


def _paper_engines(**kw):
    """The reference's continuous-batching test model in both packages."""
    base = dict(n_layers=2, d_model=64, n_heads=2, d_ff=96, vocab=128)
    jcfg = jconfigs.paper_lm(**base).replace(
        tuning=JTuning(mode="peqa"), quant=JQuant(bits=4, n_grid=2), **kw)
    tcfg = tconfigs.paper_lm(**base).replace(
        tuning=TTuning(mode="peqa"), quant=TQuant(bits=4, n_grid=2), **kw)
    japi = jregistry.build(jcfg)
    rng = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(japi.init(rng), jcfg, rng)
    return (JEngine(japi, jax.tree.map(jnp.array, p)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(to_numpy(p), tcfg, device="cpu"),
                   device="cpu"))


# --------------------------------------------------------------- int8 cache

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                       # a zero row: the 1e-8 floor
    x[1, 2, 1, :4] = [127.0, 0.5, -0.5, 1.5]   # halves: round to even
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, js = jattention.quantize_kv(jnp.asarray(x, jdt))
    tq, ts = attention.quantize_kv(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jattention.dequantize_kv(jq, js, jdt)
    td = attention.dequantize_kv(tq, ts, tdt)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd, np.float32))


def test_int8_generation_cache_matches_reference():
    """Prefill of 2 × 10 tokens, then 3 decode steps into a 16-slot int8
    cache: logits, and every cache leaf (codes, scales) after each."""
    jeng, eng = _qwen_engines(kv_cache_dtype="int8")
    japi, api = jeng.api, eng.api
    toks = tokens(2, 10, api.cfg.vocab_size, seed=6)
    jl, jcache = japi.prefill(jeng.params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(eng.model, {"tokens": torch.from_numpy(toks)})
    assert set(tcache) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    jfull = jax.tree.map(lambda d, s: d.at[:, :, :10].set(s),
                         japi.init_cache(2, 16), jcache)
    tfull = api.init_cache(2, 16)
    for key in tfull:
        assert tfull[key].dtype == {"k": torch.int8, "v": torch.int8}.get(
            key, torch.float16)
        tfull[key][:, :, :10] = tcache[key]
    for pos in (10, 11, 12):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jfull = japi.decode_step(jeng.params, jfull, jnp.asarray(nxt),
                                     jnp.int32(pos))
        with torch.inference_mode():
            tl, tfull = api.decode_step(eng.model, tfull,
                                        torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tfull[key].numpy(),
                                      np.asarray(jfull[key]), err_msg=key)


def test_int8_continuous_serving_matches_reference():
    """The reference's ``test_continuous_int8_kv_cache`` case: 3 requests
    through 2 slots; tokens equal to the reference's serve and to the
    port's lockstep generation."""
    jeng, eng = _paper_engines(kv_cache_dtype="int8")
    reqs = [dict(tokens=np.arange(5, dtype=np.int32) * (i + 2) % 128,
                 n_new=4 + 3 * i) for i in range(3)]
    jrep = jeng.serve([JRequest(**r) for r in reqs], JServeConfig(n_slots=2))
    trep = eng.serve([Request(**r) for r in reqs], ServeConfig(n_slots=2))
    assert trep.tokens == jrep.tokens
    for r, got in zip(reqs, trep.tokens):
        want = eng.generate(r["tokens"][None], r["n_new"])[0, 5:]
        assert got == want.tolist()


# ---------------------------------------------------------- the ring cache

@pytest.mark.parametrize("prompt", [4, 9])
def test_ring_generation_wraps_twice_like_the_reference(prompt):
    """``swa_window=5``: the ring holds 5 slots, and 12 new tokens wrap it
    at least twice; a 9-token prompt also exercises the prefill's roll of
    its last 5 keys into ring order."""
    jeng, eng = _qwen_engines(swa_window=5)
    japi, api = jeng.api, eng.api
    toks = tokens(2, prompt, api.cfg.vocab_size, seed=8)
    jl, jcache = japi.prefill(jeng.params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(eng.model, {"tokens": torch.from_numpy(toks)})
    assert tcache["k"].shape[2] == min(5, prompt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)
    n_new = 12
    assert prompt + n_new - 2 >= 2 * 5
    want = np.asarray(jeng.generate(jnp.asarray(toks), n_new))
    np.testing.assert_array_equal(eng.generate(toks, n_new).numpy(), want)
    # a ring wraps: a cache_len under prompt + n_new - 1 is legal
    short = prompt + 1
    np.testing.assert_array_equal(
        eng.generate(toks, n_new, cache_len=short).numpy(),
        np.asarray(jeng.generate(jnp.asarray(toks), n_new, cache_len=short)))


def test_sliding_window_continuous_matches_lockstep():
    """The reference's case: ``swa_window=6``, 3 requests through 2 slots —
    tokens equal to the reference's serve and the port's lockstep."""
    jeng, eng = _paper_engines(swa_window=6)
    reqs = [dict(tokens=np.arange(4, dtype=np.int32) * (i + 1) % 128,
                 n_new=3 + 2 * i) for i in range(3)]
    jrep = jeng.serve([JRequest(**r) for r in reqs], JServeConfig(n_slots=2))
    trep = eng.serve([Request(**r) for r in reqs], ServeConfig(n_slots=2))
    assert trep.tokens == jrep.tokens
    assert trep.prefill_compiles == jrep.prefill_compiles  # no bucketing
    for r, got in zip(reqs, trep.tokens):
        want = eng.generate(r["tokens"][None], r["n_new"])[0, 4:]
        assert got == want.tolist()


# ---------------------------------------------------- speculative refusals

@pytest.mark.parametrize("kw", [dict(swa_window=6),
                                dict(kv_cache_dtype="int8")])
def test_speculative_refusals_match_reference(kw):
    jeng, eng = _paper_engines(**kw)
    reqs = [dict(tokens=np.arange(4, dtype=np.int32), n_new=3)]
    with pytest.raises(ValueError) as jerr:
        jeng.serve([JRequest(**r) for r in reqs],
                   JServeConfig(n_slots=2, scheduler="speculative"))
    with pytest.raises(ValueError) as terr:
        eng.serve([Request(**r) for r in reqs],
                  ServeConfig(n_slots=2, scheduler="speculative"))
    assert str(terr.value) == str(jerr.value)
    assert ("ring cache" if "swa_window" in kw else "quantized KV") \
        in str(terr.value)
