"""PyTorch port vs JAX reference: the quantized matmul.

On the CPU the port's ``ops.quant_matmul`` runs the kernels' plain version;
it is held against the reference's Pallas kernels run in interpret mode —
``quant_gemv_pallas`` for M ∈ {1, 4, 32}, ``quant_matmul_pallas`` for
M ∈ {33, 64} — on the same seeded inputs.

Tolerance: ``quant_matmul.error_bound`` — the two sum the same float32
products in different orders (the Pallas kernels in K blocks of 512), so
they may differ by twice the recursive-summation bound K·2⁻²⁴·Σ|x·ŵ|
(about 1e-5 of the output's scale here); a bf16 output adds one bf16 ulp.

The CUDA kernels themselves are held to the plain version on the card by
``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QTensor
from repro.core.quant import QuantSpec as JSpec
from repro.kernels import quant_matmul as jqm
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from _torch_threads import _one_torch_thread  # noqa: F401


N, K = 96, 256


def _operands(m, group, bits, dtype, seed=0, n=N, k=K):
    """Seeded numpy inputs, quantized by the reference: (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) * 0.05).astype(np.float32)
    qt = QTensor.quantize(jnp.asarray(w), JSpec(bits=bits, group_size=group),
                          n_grid=2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    qw, s, z = (np.asarray(a) for a in (qt.qw, qt.scale, qt.zero))
    targs = (torch.from_numpy(qw.view(np.int32).copy()),
             torch.from_numpy(s.copy()), torch.from_numpy(z.copy()))
    return (jx, qt.qw, qt.scale, qt.zero), (tx, *targs)


def _assert_within_bound(got, want, targs):
    bound = qm.error_bound(*targs, got)
    err = (got.float() - want.float()).abs()
    assert (err <= bound).all(), f"max err {err.max():.3e}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("m", [1, 4, 32])
def test_plain_matches_pallas_gemv(m, group, bits, dtype):
    jargs, targs = _operands(m, group, bits, dtype, seed=m + bits)
    want = jqm.quant_gemv_pallas(*jargs, spec=JSpec(bits=bits, group_size=group),
                                 interpret=True)
    got = ops.quant_matmul(*targs, QuantSpec(bits=bits, group_size=group))
    assert got.dtype == targs[0].dtype and got.shape == (m, N)
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    _assert_within_bound(got, want, targs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("m", [33, 64])
def test_plain_matches_pallas_gemm(m, group, bits, dtype):
    jargs, targs = _operands(m, group, bits, dtype, seed=m + bits)
    want = jqm.quant_matmul_pallas(*jargs,
                                   spec=JSpec(bits=bits, group_size=group),
                                   interpret=True)
    got = ops.quant_matmul(*targs, QuantSpec(bits=bits, group_size=group))
    assert got.dtype == targs[0].dtype and got.shape == (m, N)
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    _assert_within_bound(got, want, targs)


def test_misaligned_view_is_copied_by_ops():
    _, (x, qw, s, z) = _operands(4, None, 4, "f32")
    view = torch.cat([torch.zeros(1), x.flatten()])[1:].reshape(x.shape)
    assert view.data_ptr() % 16
    torch.testing.assert_close(ops.quant_matmul(view, qw, s, z, QuantSpec()),
                               qm.quant_matmul_plain(x, qw, s, z),
                               rtol=0, atol=0)


def test_leading_dims_flatten_like_reference():
    _, (x, qw, s, z) = _operands(12, None, 4, "f32")
    y = ops.quant_matmul(x.reshape(3, 4, K), qw, s, z, QuantSpec())
    torch.testing.assert_close(y.reshape(12, N),
                               ops.quant_matmul(x, qw, s, z, QuantSpec()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,kernel", [(1, "quant_gemv"), (32, "quant_gemv"),
                                      (33, "quant_matmul"),
                                      (64, "quant_matmul")])
def test_dispatch_by_rows(monkeypatch, m, kernel):
    """M ≤ GEMV_MAX_M = 32 goes to the GEMV, larger M to the GEMM."""
    calls = []
    for name in ("quant_gemv", "quant_matmul"):
        orig = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda *a, _n=name, _o=orig:
                            calls.append(_n) or _o(*a))
    _, targs = _operands(m, None, 4, "f32")
    ops.quant_matmul(*targs, QuantSpec())
    assert calls == [kernel]


def test_cpu_tensors_take_plain_version_without_launch():
    before = (qm.quant_gemv.launches, qm.quant_matmul.launches)
    for m in (4, 40):
        _, targs = _operands(m, None, 4, "f32")
        torch.testing.assert_close(
            ops.quant_matmul(*targs, QuantSpec()),
            qm.quant_matmul_plain(*targs), rtol=0, atol=0)
    assert (qm.quant_gemv.launches, qm.quant_matmul.launches) == before


def test_forced_torch_impl_and_unknown_impl():
    _, targs = _operands(4, None, 4, "f32")
    with ops.force_impl("torch"):
        assert ops.default_impl() == "torch"
        ops.quant_matmul(*targs, QuantSpec())
    assert ops.default_impl() == "cuda"
    for name in ("palas", "triton"):
        with pytest.raises(ValueError, match="unknown quant_matmul impl"):
            with ops.force_impl(name):
                pass
    assert ops.default_impl() == "cuda"


@pytest.mark.parametrize("spec", [QuantSpec(layout="plane", bits=5),
                                  QuantSpec(packed=False),
                                  QuantSpec(bits=8)])
def test_unported_specs_raise(spec):
    _, targs = _operands(4, None, 4, "f32")
    with pytest.raises(NotImplementedError):
        ops.quant_matmul(*targs, spec)


def _bad_operands():
    _, (x, qw, s, z) = _operands(4, 32, 4, "f32")
    return [
        ("k not a multiple of 8", (x[:, :250].contiguous(), qw, s, z)),
        ("qw width", (x, qw[:, :-1].contiguous(), s, z)),
        ("float16 x", (x.half(), qw, s, z)),
        ("uint8 codes", (x, qw.to(torch.uint8), s, z)),
        ("groups not dividing K", (x, qw, s[:, :3].contiguous(),
                                   z[:, :3].contiguous())),
        ("scale rows", (x, qw, s[:-1].contiguous(), z[:-1].contiguous())),
        ("non-contiguous x", (x.T.contiguous().T, qw, s, z)),
        ("1-d x", (x[0], qw, s, z)),
        ("x not 16-byte aligned",
         (torch.cat([torch.zeros(1), x.flatten()])[1:].reshape(x.shape),
          qw, s, z)),
    ]


@pytest.mark.parametrize("case", range(9))
def test_bad_operands_raise(case):
    why, args = _bad_operands()[case]
    for fn in (qm.quant_gemv, qm.quant_matmul):
        with pytest.raises((ValueError, TypeError)):
            fn(*args)


def test_gemv_refuses_more_than_32_rows():
    _, targs = _operands(33, None, 4, "f32")
    with pytest.raises(ValueError, match="M <= 32"):
        qm.quant_gemv(*targs)
