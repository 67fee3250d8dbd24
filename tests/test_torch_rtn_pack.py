"""PyTorch port vs JAX reference: min/max RTN quantize-and-pack (K3 nibbles,
K6b bit-planes) and the conversion path through it.

  * ``ops.rtn_pack`` (on CPU tensors: the plain version of K3 / K6b)
    against the reference's ``rtn_pack_pallas(..., interpret=True)`` and
    ``ref.rtn_pack_ref(w, spec, n_grid=1)``, at the shapes of the
    reference's own kernel test plus one with K > 2048 and groups (the TPU
    kernel then runs several K blocks): nibble and plane codes of 4, 3 and 2
    bits, per-channel and grouped.  Tolerances: codes bit-equal (int32 views
    of the reference's uint32 words); scales rtol 1e-6; zeros rtol 1e-5 /
    atol 1e-5 — the reference's own kernel-test tolerances (its jitted
    kernel may fold the division by ``levels`` into a reciprocal multiply).
  * ``quantize_params`` under ``QuantConfig(n_grid=1)`` in both packages on
    the tiny llama: equal codes, the port's route through ``ops.rtn_pack``.
  * Symmetric specs: ``ops.rtn_pack`` refuses them, ``quantize_leaf`` keeps
    ``rtn_quantize`` for them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantSpec as JSpec
from repro.kernels import ref as jref
from repro.kernels.rtn_pack import rtn_pack_pallas
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig
from repro_torch.core import peqa
from repro_torch.core.quant import QuantSpec, pack_codes, rtn_quantize
from repro_torch.kernels import ops
from repro_torch.kernels import rtn_pack as rp

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from test_torch_model import _assert_trees_match
from _torch_threads import _one_torch_thread  # noqa: F401


SHAPES = [(32, 128, None), (64, 256, 64), (16, 2048, 512), (16, 4096, 128)]
SPECS = [("nibble", 4), ("nibble", 3), ("nibble", 2), ("plane", 4),
         ("plane", 3), ("plane", 2)]


def _weights(n, k, seed=11):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _assert_pack_close(port, ref, what):
    qw, s, z = (np.asarray(t) for t in ref)
    tq, ts, tz = (t.numpy() for t in port)
    assert tq.dtype == np.int32 and tq.shape == qw.shape, what
    np.testing.assert_array_equal(tq, qw.view(np.int32), err_msg=what)
    np.testing.assert_allclose(ts, s, rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(tz, z, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("layout,bits", SPECS)
@pytest.mark.parametrize("n,k,group", SHAPES)
def test_rtn_pack_matches_reference_kernel_and_ref(n, k, group, layout, bits):
    w = _weights(n, k)
    jspec = JSpec(bits=bits, group_size=group, layout=layout)
    port = ops.rtn_pack(torch.from_numpy(w),
                        QuantSpec(bits=bits, group_size=group, layout=layout))
    _assert_pack_close(port, rtn_pack_pallas(jnp.asarray(w), spec=jspec,
                                             interpret=True), "pallas")
    _assert_pack_close(port, jref.rtn_pack_ref(jnp.asarray(w), jspec, n_grid=1),
                       "rtn_pack_ref")


@pytest.mark.parametrize("layout", ["nibble", "plane"])
def test_rtn_pack_plain_routes_agree(layout):
    """The wrappers' CPU path, the ``torch`` impl and ``rtn_quantize`` + pack
    are one function; the wrappers count no launch on the CPU."""
    w = torch.from_numpy(_weights(24, 256, seed=3)).to(torch.bfloat16)
    spec = QuantSpec(bits=3, group_size=64, layout=layout)
    fn = rp.rtn_pack_planes if layout == "plane" else rp.rtn_pack
    before = fn.launches
    got = ops.rtn_pack(w, spec)
    assert fn.launches == before
    with ops.force_impl("torch"):
        want = ops.rtn_pack(w, spec)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    q, s, z = rtn_quantize(w, spec, n_grid=1)
    assert torch.equal(got[1], s) and torch.equal(got[2], z)
    if layout == "nibble":
        assert torch.equal(got[0], pack_codes(q))


@pytest.mark.parametrize("layout", ["nibble", "plane"])
def test_quantize_params_min_max_matches_reference(layout, monkeypatch):
    jcfg, tcfg = tiny_llama_pair(n_grid=1, layout=layout)
    fp, jq = reference_params(jcfg)
    calls = []
    real = ops.rtn_pack

    def spy(w, spec):
        calls.append(tuple(w.shape))
        return real(w, spec)
    monkeypatch.setattr(ops, "rtn_pack", spy)
    model = peqa.quantize_params(bridge.to_module(to_numpy(fp), tcfg,
                                                  device="cpu"),
                                 tcfg.quant, device="cpu")
    assert len(calls) == 7 * tcfg.n_layers
    _assert_trees_match(to_numpy(jq), bridge.to_tree(model))


def test_symmetric_spec_refused_by_rtn_pack_kept_by_quantize_leaf(monkeypatch):
    w = torch.from_numpy(_weights(16, 128, seed=5))
    spec = QuantSpec(bits=4, group_size=32, symmetric=True)
    with pytest.raises(NotImplementedError, match="asymmetric"):
        ops.rtn_pack(w, spec)
    monkeypatch.setattr(ops, "rtn_pack",
                        lambda *a: pytest.fail("symmetric spec took rtn_pack"))
    got = peqa.quantize_leaf(w, QuantConfig(bits=4, group_size=32,
                                            symmetric=True, n_grid=1))
    q, s, z = rtn_quantize(w, spec, n_grid=1)
    assert torch.equal(got["qw"], pack_codes(q))
    assert torch.equal(got["scale"], s) and torch.equal(got["zero"], z)


@pytest.mark.parametrize("bad", [
    dict(shape=(8, 100), bits=4, group=None, plane=False),   # K % 8
    dict(shape=(8, 48), bits=4, group=None, plane=True),     # K % 32
    dict(shape=(8, 64), bits=4, group=24, plane=False),      # group ∤ K
    dict(shape=(8, 64), bits=5, group=None, plane=False),    # > 4 bits
    dict(shape=(4, 8, 64), bits=4, group=None, plane=False)])
def test_pack_wrappers_refuse_what_the_kernels_do_not_take(bad):
    w = torch.zeros(bad["shape"])
    fn = rp.rtn_pack_planes if bad["plane"] else rp.rtn_pack
    with pytest.raises(ValueError):
        fn(w, bad["bits"], bad["group"])
