"""PyTorch port vs JAX reference: AlphaTuning's binary-coding quantization
(``repro_torch.core.alphatuning`` against ``repro.core.alphatuning``).

  * ``bcq_decompose``: alphas rtol 1e-5 and signs equal in ≥ 99.9% of the
    entries — the refinement re-derives each sign from a float32 residual
    whose sums run in another order, so an entry within an ulp of 0 may
    take the other sign (every case here is equal in all entries);
  * ``alphatuning_params`` and ``alphatuning_mask`` on the tiny
    llama3.2-1b's stacked weights, keyed by the reference's paths: the same
    leaves and shapes, the int8 signs, only ``alpha1`` trainable;
  * ``bcq_weight`` equals Σ α_b B_b, and ``linear_apply_bcq`` forward and
    backward on bridged tensors (the reference's BCQ leaves of one layer):
    the output within 1e-5 of the reference's (float32) or 2⁻⁸ of its
    largest magnitude (bfloat16), the ``alpha1`` gradient within 1e-4
    (float32) or 5e-2 (bfloat16) in ℓ2, and no gradient for ``alpha_rest``
    or the signs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuant
from repro.core import alphatuning as jat
from repro_torch.configs.base import QuantConfig
from repro_torch.core import alphatuning as at

from test_torch_policies import fp_tree
from _torch_threads import _one_torch_thread  # noqa: F401


def _flat(tree):
    return {"/" + "/".join(str(getattr(k, "key", k)) for k in kp):
            np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_bcq_decompose_matches_reference(bits):
    w = np.random.default_rng(bits).normal(size=(48, 96)).astype(np.float32)
    ja, js = jat.bcq_decompose(jnp.asarray(w), bits)
    ta, ts = at.bcq_decompose(torch.from_numpy(w), bits)
    assert ta.shape == (bits, 48) and ts.shape == (bits, 48, 96)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
    assert (ts.numpy() == np.asarray(js)).mean() >= 0.999
    assert set(np.unique(ts.numpy())) <= {-1.0, 1.0}
    np.testing.assert_allclose(at.bcq_apply(ta, ts).numpy(),
                               np.asarray(jat.bcq_apply(ja, js)),
                               rtol=1e-5, atol=1e-6)


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in _flat(tree).items()}


@pytest.fixture(scope="module")
def bcq_trees():
    fp = fp_tree("llama3.2-1b")
    want = jat.alphatuning_params(jax.tree.map(jnp.asarray, fp), JQuant())
    got = at.alphatuning_params(_tensors(fp), QuantConfig())
    return want, got


def test_alphatuning_params_and_mask_match_reference(bcq_trees):
    want, got = bcq_trees
    fw = _flat(want)
    assert got.keys() == fw.keys()
    for path, arr in fw.items():
        t = got[path]
        assert tuple(t.shape) == arr.shape, path
        if path.endswith("/signs"):
            assert t.dtype == torch.int8
            assert (t.numpy() == arr).mean() >= 0.999, path
        else:
            np.testing.assert_allclose(t.numpy(), arr, rtol=1e-5, atol=1e-7,
                                       err_msg=path)
    mask = at.alphatuning_mask(got)
    jmask = _flat(jat.alphatuning_mask(want))
    assert mask == {k: bool(v) for k, v in jmask.items()}
    assert {p.rsplit("/", 1)[-1] for p, v in mask.items() if v} == {"alpha1"}
    entry = at.linear_entry(got, "/layers/attn/wq")
    assert set(entry) == {"alpha1", "alpha_rest", "signs"}
    alphas = torch.cat([entry["alpha1"][..., None, :], entry["alpha_rest"]],
                       -2)
    np.testing.assert_allclose(
        at.bcq_weight(entry).numpy(),
        torch.einsum("lbn,lbnm->lnm", alphas, entry["signs"].float()).numpy(),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lin", ["/layers/attn/wk", "/layers/mlp/down"])
def test_linear_apply_bcq_forward_and_alpha1_grad(bcq_trees, lin, dtype):
    want, _ = bcq_trees
    layer = {k: v[1] for k, v in _flat(want).items()
             if k.rsplit("/", 1)[0] == lin}
    p = {k.rsplit("/", 1)[-1]: v for k, v in layer.items()}
    m = p["signs"].shape[-1]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, m)).astype(np.float32)
    ct = rng.normal(size=(2, 5, p["signs"].shape[-2])).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)

    def jloss(a1):
        y = jat.linear_apply_bcq(
            {**{k: jnp.asarray(v) for k, v in p.items()}, "alpha1": a1}, jx)
        return (y.astype(jnp.float32) * ct).sum(), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(p["alpha1"]))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tp["alpha1"].requires_grad_(True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = at.linear_apply_bcq(tp, tx)
    assert y.dtype == tx.dtype
    (y.to(torch.float32) * torch.from_numpy(ct)).sum().backward()
    jy = np.asarray(jy.astype(jnp.float32))
    bf16 = dtype == "bfloat16"
    if bf16:
        assert np.abs(y.detach().float().numpy() - jy).max() <= \
            2 ** -8 * np.abs(jy).max()
    else:
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5,
                                   atol=1e-5)
    g, jg = tp["alpha1"].grad.numpy(), np.asarray(jg)
    assert np.linalg.norm(g - jg) <= (5e-2 if bf16 else 1e-4) \
        * np.linalg.norm(jg)
    assert tp["alpha_rest"].grad is None and tp["signs"].grad is None
