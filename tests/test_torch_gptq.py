"""PyTorch port vs JAX reference: OPTQ (GPTQ), the LoRA+OPTQ arm's
backbone (``repro_torch.core.gptq`` against ``repro.core.gptq``).

  * the column loop fed the reference's own inverse factor, scales and
    zeros gives the reference's codes exactly (the same float64 operations
    in the same order);
  * ``gptq_quantize_matrix`` end to end: scales and zeros rtol 1e-6 (the
    port's RTN grid, as ``test_torch_quant.py``), codes equal in ≥ 99.9% of
    the entries — the two float64 Cholesky factorisations (LAPACK through
    numpy and through torch) may differ in their last bits, which can flip
    a code at a rounding tie, and the error feedback then moves the columns
    after it a little (every case here is equal in all entries);
  * GPTQ beats RTN on the output error under correlated inputs, as the
    reference's ``test_gptq_beats_rtn_on_output_error`` shows;
  * ``gptq_quantize_transformer`` on 2-layer tiny models (llama3.2-1b's
    GQA, starcoder2-7b's LayerNorm, GELU and biases) against the
    reference's: codes ≥ 99.9% equal, scales rtol 1e-6, the quantized
    model's loss rtol 1e-5 (float32), then LoRA on top with the arm's mask;
  * the plane layout is refused, with the reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuant
from repro.core import gptq as jgptq
from repro.core import policies as jpolicies
from repro.core.quant import rtn_quantize as jrtn
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig
from repro_torch.core import gptq, lora, policies
from repro_torch.core.quant import QuantSpec, dequantize, rtn_quantize
from repro_torch.models import registry

from test_torch_configs import tokens, to_numpy
from test_torch_policies import fp_tree, pair
from _torch_threads import _one_torch_thread  # noqa: F401


def correlated_inputs(t, m, seed=0):
    """Inputs with strong feature correlations (where GPTQ shines), as the
    reference's test makes them."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(t, m // 4))
    mixer = rng.normal(size=(m // 4, m)) / np.sqrt(m // 4)
    return (base @ mixer + 0.1 * rng.normal(size=(t, m))).astype(np.float32)


def _case(n, m, t, seed, dead=()):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, m)).astype(np.float32)
    x = correlated_inputs(t, m, seed)
    x[:, list(dead)] = 0.0
    return w, x


def _reference_factors(w, x, qcfg, damp=0.01):
    """The reference's hinv, scales and zeros, computed as its
    ``gptq_quantize_matrix`` computes them (numpy float64)."""
    w = np.asarray(w, np.float64)
    h = 2.0 * (x.T.astype(np.float64) @ x.astype(np.float64))
    dead = np.diag(h) == 0
    h[dead, dead] = 1.0
    w[:, dead] = 0.0
    h += np.eye(w.shape[1]) * damp * np.mean(np.diag(h))
    hinv = np.linalg.cholesky(np.linalg.inv(h)).T
    _, s, z = jrtn(jnp.asarray(w, jnp.float32), qcfg.spec(),
                   n_grid=qcfg.n_grid)
    return w, hinv, np.asarray(s, np.float64), np.asarray(z, np.float64)


QCASES = [dict(bits=4, n_grid=8), dict(bits=3, n_grid=8),
          dict(bits=4, group_size=16, n_grid=4), dict(bits=2, n_grid=1)]


@pytest.mark.parametrize("qkw", QCASES)
def test_column_loop_gives_the_reference_codes(qkw):
    w, x = _case(24, 64, 256, seed=1, dead=(5, 40))
    jq = JQuant(**qkw)
    want, _, _ = jgptq.gptq_quantize_matrix(w, x, jq)
    w64, hinv, s, z = _reference_factors(w, x, jq)
    got = gptq.gptq_columns(torch.from_numpy(w64), torch.from_numpy(hinv),
                            torch.from_numpy(s), torch.from_numpy(z),
                            jq.spec().levels)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("qkw", QCASES)
def test_gptq_matrix_matches_reference(qkw):
    w, x = _case(32, 128, 384, seed=2, dead=(7,))
    want_q, want_s, want_z = jgptq.gptq_quantize_matrix(w, x, JQuant(**qkw))
    q, s, z = gptq.gptq_quantize_matrix(torch.from_numpy(w),
                                        torch.from_numpy(x),
                                        QuantConfig(**qkw))
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-6)
    np.testing.assert_allclose(z.numpy(), want_z, rtol=1e-6, atol=1e-6)
    assert (q.numpy() == want_q).mean() >= 0.999
    assert int(q.max()) <= QuantConfig(**qkw).spec().levels


def test_gptq_beats_rtn_on_output_error():
    w = np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)
    x = correlated_inputs(512, 64)
    qcfg = QuantConfig(bits=3, n_grid=8)
    spec = qcfg.spec()
    q_rtn, s_rtn, z_rtn = rtn_quantize(torch.from_numpy(w), spec, n_grid=8)
    w_rtn = dequantize(q_rtn, s_rtn, z_rtn, spec).numpy()
    q_g, s_g, z_g = gptq.gptq_quantize_matrix(torch.from_numpy(w),
                                              torch.from_numpy(x), qcfg)
    w_g = dequantize(q_g, s_g, z_g, QuantSpec(bits=3, packed=False)).numpy()
    err_rtn = np.linalg.norm(x @ (w_rtn - w).T)
    err_g = np.linalg.norm(x @ (w_g - w).T)
    assert err_g < err_rtn * 0.95, (err_g, err_rtn)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-7b"])
def test_gptq_transformer_matches_reference(arch):
    """Sequential OPTQ over the 2-layer tiny model from the same weights
    and calibration tokens, then the LoRA+OPTQ arm on top of it."""
    jcfg, tcfg = pair(arch, "lora_optq")
    qkw = dict(bits=3, n_grid=6)
    jcfg = jcfg.replace(quant=JQuant(**qkw))
    tcfg = tcfg.replace(quant=QuantConfig(**qkw))
    fp = fp_tree(arch)
    calib = tokens(4, 32, tcfg.vocab_size, seed=6)
    want = to_numpy(jgptq.gptq_quantize_transformer(
        jax.tree.map(jnp.asarray, fp), jcfg, jnp.asarray(calib)))
    model = bridge.to_module(fp, tcfg, device="cpu")
    gptq.gptq_quantize_transformer(model, tcfg, torch.from_numpy(calib))
    got, fw = _flat(bridge.to_tree(model)), _flat(want)
    assert got.keys() == fw.keys()
    for key, arr in fw.items():
        if key.endswith("qw"):
            codes = lambda a: np.stack([(a[..., None] >> (4 * i)) & 0xF
                                        for i in range(8)], -1)
            assert (codes(got[key]) == codes(arr)).mean() >= 0.999, key
        elif key.endswith(("scale", "zero")):
            np.testing.assert_allclose(got[key], arr, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], arr, err_msg=key)
    batch = {"tokens": calib[:2, :-1], "labels": calib[:2, 1:]}
    peqa_cfg = jcfg.replace(tuning=jcfg.tuning.__class__(mode="peqa"))
    jloss = float(jregistry.build(peqa_cfg).loss_fn(
        jax.tree.map(jnp.asarray, want),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        loss = registry.build(tcfg, device="cpu").loss_fn(model, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    # the arm: an adapter on the OPTQ backbone, only it trains
    lora.add_lora(model, torch.Generator().manual_seed(0), tcfg.tuning)
    mask = policies.make_mask(model, tcfg)
    assert {n.rsplit(".", 1)[-1] for n, v in mask.items() if v} == \
        {"lora_a", "lora_b"}
    with torch.no_grad():
        assert float(registry.build(tcfg, device="cpu").loss_fn(
            model, tb)) == float(loss)            # lora_b = 0: no change
    assert jpolicies.trainable_count(
        jax.tree.map(jnp.asarray, bridge.to_tree(model)),
        jpolicies.make_mask(bridge.to_tree(model), jcfg)) == \
        policies.trainable_count(model, mask)


def test_plane_layout_is_refused():
    _, tcfg = pair("llama3.2-1b", "lora_optq")
    plane = tcfg.replace(quant=QuantConfig(layout="plane"))
    model = bridge.to_module(fp_tree("llama3.2-1b"), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="nibble words"):
        gptq.gptq_quantize_transformer(model, plane,
                                       torch.zeros(1, 4, dtype=torch.long))
