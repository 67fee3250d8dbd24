"""PyTorch port vs JAX reference: packing and RTN quantization
(``repro_torch/core/quant.py`` against ``repro/core/quant.py``).

Inputs are made by numpy from a seed and handed to both packages.

Tolerances: packed words and codes are compared bit for bit; scales and
zeros at rtol 1e-6.  The shrink grid search compares float32 errors, and the
two packages may differ in the last ulp of a shrink factor (XLA folds the
linspace with its own rounding) or of a summed error (reduction order).
Either can flip the choice between two shrinks whose errors tie to float32
precision.  ``_assert_rtn_close`` therefore accepts a group whose choice
differs only if the port's error for the reference's choice is within a
relative 1e-5 of the port's own (a near-tie) — and at most 1% of groups; every
other group must have bit-equal codes.  With the seeds below no group flips,
so the exact branch is what runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq
from _torch_threads import _one_torch_thread  # noqa: F401


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(8,), (3, 16), (5, 7, 64)])
def test_pack_unpack_bitexact(shape):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, shape).astype(np.uint8)
    want = np.asarray(jq.pack_codes(jnp.asarray(codes)))
    got = tq.pack_codes(_t(codes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the sign-extending int32 shift must not leak into the top nibble
    back = tq.unpack_codes(got)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.unpack_codes(jnp.asarray(want))))


def test_unpack_truncates_like_reference():
    codes = np.random.default_rng(1).integers(0, 16, (4, 32)).astype(np.uint8)
    packed = tq.pack_codes(_t(codes))
    np.testing.assert_array_equal(tq.unpack_codes(packed, 20).numpy(),
                                  codes[:, :20])


def test_pack_rejects_ragged_k():
    with pytest.raises(ValueError):
        tq.pack_codes(torch.zeros(3, 12, dtype=torch.uint8))


def _group_errors(w, q, s, z, spec):
    """Per-group squared error of (codes, scale, zero) under the port."""
    wg = tq._grouped(w, spec)
    qg = q.reshape(wg.shape).to(torch.float32)
    deq = s[..., None] * (qg - z[..., None])
    return ((deq - wg) ** 2).sum(-1)


def _assert_rtn_close(w, spec, jres, tres):
    jcodes, js, jz = (np.asarray(a) for a in jres)
    tcodes, ts, tz = (a.numpy() for a in tres)
    n, m = w.shape
    g = js.shape[1]
    differ = (jcodes.reshape(n, g, -1) != tcodes.reshape(n, g, -1)).any(-1) \
        | ~np.isclose(ts, js, rtol=1e-6, atol=0) \
        | ~np.isclose(tz, jz, rtol=1e-6, atol=1e-6)
    if differ.any():
        wt = _t(w)
        e_port = _group_errors(wt, tres[0], tres[1], tres[2], spec).numpy()
        e_ref = _group_errors(wt, _t(jcodes), _t(js), _t(jz), spec).numpy()
        near = np.abs(e_ref - e_port) <= 1e-5 * np.maximum(e_port, 1e-30)
        assert near[differ].all(), "a group's shrink differs beyond a near-tie"
        assert differ.mean() <= 0.01, f"{differ.sum()} groups flipped"
    keep = ~np.repeat(differ[..., None], m // g, -1).reshape(n, m)
    np.testing.assert_array_equal(tcodes[keep], jcodes[keep])


@pytest.mark.parametrize("group", [None, 32, 128])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_rtn_quantize_matches_reference(bits, group):
    rng = np.random.default_rng(bits * 10 + (group or 0))
    w = (rng.normal(size=(48, 256)) * 0.05).astype(np.float32)
    jspec = jq.QuantSpec(bits=bits, group_size=group)
    tspec = tq.QuantSpec(bits=bits, group_size=group)
    jres = jq.rtn_quantize(jnp.asarray(w), jspec, n_grid=20)
    tres = tq.rtn_quantize(_t(w), tspec, n_grid=20)
    assert tres[0].dtype == torch.uint8
    assert tres[1].shape == (48, tspec.n_groups(256))
    _assert_rtn_close(w, tspec, jres, tres)


@pytest.mark.parametrize("symmetric", [False, True])
def test_rtn_plain_minmax_matches_reference(symmetric):
    """n_grid=1: no search, so the result must be exact."""
    w = (np.random.default_rng(7).normal(size=(32, 64)) * 0.1).astype(np.float32)
    jres = jq.rtn_quantize(jnp.asarray(w), jq.QuantSpec(bits=4, group_size=16,
                                                        symmetric=symmetric),
                           n_grid=1)
    tres = tq.rtn_quantize(_t(w), tq.QuantSpec(bits=4, group_size=16,
                                               symmetric=symmetric), n_grid=1)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_dequantize_matches_reference():
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(16, 64)) * 0.05).astype(np.float32)
    spec = tq.QuantSpec(bits=4, group_size=32)
    q, s, z = tq.rtn_quantize(_t(w), spec, n_grid=4)
    want = jq.dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                         jnp.asarray(z.numpy()),
                         jq.QuantSpec(bits=4, group_size=32))
    np.testing.assert_array_equal(tq.dequantize(q, s, z, spec).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("kw", [dict(layout="plane", bits=5),
                                dict(packed=False), dict(bits=8)])
def test_unported_layouts_raise(kw):
    with pytest.raises(NotImplementedError):
        tq.QuantSpec(**kw).check_ported()
