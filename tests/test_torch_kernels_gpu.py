"""The port's CUDA kernels against their plain version, on the card.

Marked ``gpu``; every test skips without a CUDA device (decided while the
test runs, so every xdist worker collects the same tests).  This file
imports only torch and the port, so it also runs on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: ``quant_matmul.error_bound`` (two float32 summation orders, plus
one bf16 ulp for bf16 outputs).  K5 (``quant_gemv_tasks``) is held to its
plain version within that bound and to K1 bit for bit: each of its rows
must equal K1's row under that row's task scales.  K6a (the ``*_planes``
kernels) is held to its plain version within that bound and to its nibble
kernel bit for bit: reading the top p of b' planes under ``shift = b' − p``
must equal the nibble kernel on ``q >> shift`` under ``draft_scales``.
"""
import pytest
import torch

from repro_torch.core.quant import (QuantSpec, draft_scales, pack_codes,
                                    pack_codes_planes, rtn_quantize)
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(m, n, k, group, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(n, k, generator=g) * k ** -0.5
    q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group), n_grid=4)
    x = torch.randn(m, k, generator=g).to(dtype)
    return [t.to(device) for t in (x, pack_codes(q), s, z)]


def _assert_within_bound(got, plain, args):
    assert got.dtype == plain.dtype and got.shape == plain.shape
    err = (got.float() - plain.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= qm.error_bound(*args, plain)).all(), \
        f"max err {err.max().item():.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 32, 12])
@pytest.mark.parametrize("m", [1, 4, 13, 32, 33, 200])
def test_kernel_matches_plain_on_card(cuda, m, group, dtype):
    """Ragged N (100), K not a multiple of 32 (264 with groups of 12, whose
    boundaries fall inside packed words: the GEMV's per-code group path)."""
    k = 264 if group == 12 else 512
    args = _operands(m, 100, k, group, dtype, cuda, seed=m)
    fn = qm.quant_gemv if m <= 32 else qm.quant_matmul
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_within_bound(got, qm.quant_matmul_plain(*args), args)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(2048, 2048), (512, 2048), (8192, 2048),
                                 (2048, 8192)])
def test_kernels_at_llama_shapes(cuda, n, k):
    for m in (4, 300):
        args = _operands(m, n, k, None, torch.bfloat16, cuda, seed=n + k)
        got = ops.quant_matmul(*args, QuantSpec())
        torch.cuda.synchronize()
        _assert_within_bound(got, qm.quant_matmul_plain(*args), args)


@pytest.mark.gpu
def test_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    monkeypatch.setattr(qm, "quant_matmul_plain",
                        lambda *a: pytest.fail("plain version on the card"))
    for m in (4, 64):
        args = _operands(m, 96, 256, None, torch.bfloat16, cuda)
        ops.quant_matmul(*args, QuantSpec())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    x, qw, s, z = _operands(4, 96, 256, None, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="several devices"):
        qm.quant_gemv(x, qw.cpu(), s, z)
    with pytest.raises(ValueError, match="16-byte"):
        qm.quant_gemv(torch.cat([x.flatten()[:1], x.flatten()])[1:]
                      .reshape(x.shape), qw, s, z)


def _task_stacks(n_tasks, s, z, seed):
    g = torch.Generator().manual_seed(seed)
    ss = torch.stack([s.cpu() * (0.8 + 0.4 * torch.rand(s.shape, generator=g))
                      for _ in range(n_tasks)])
    zs = torch.stack([z.cpu() + torch.rand(z.shape, generator=g) - 0.5
                      for _ in range(n_tasks)])
    return ss.to(s.device).contiguous(), zs.to(z.device).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 128, 12])
@pytest.mark.parametrize("n_tasks", [1, 4])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32])
def test_k5_rows_bitwise_k1_and_within_bound_of_plain(cuda, m, n_tasks,
                                                      group, dtype):
    k = 264 if group == 12 else 512
    x, qw, s, z = _operands(m, 100, k, group, dtype, cuda, seed=7 * m + k)
    ss, zs = _task_stacks(n_tasks, s, z, seed=m)
    ids = torch.tensor([(3 * i + 1) % n_tasks for i in range(m)],
                       dtype=torch.int32, device=cuda)
    before = qm.quant_gemv_tasks.launches
    got = qm.quant_gemv_tasks(x, qw, ss, zs, ids)
    torch.cuda.synchronize()
    assert qm.quant_gemv_tasks.launches == before + 1
    plain = qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
    err = (got.float() - plain.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= qm.error_bound(x, qw, ss, zs, plain, task_ids=ids)).all(), \
        f"max err {err.max().item():.3e}"
    for t in range(n_tasks):
        rows = (ids == t).nonzero().flatten()
        k1 = qm.quant_gemv(x, qw, ss[t], zs[t])
        assert torch.equal(got[rows], k1[rows]), f"task {t}"


@pytest.mark.gpu
def test_slotted_cuda_tensors_never_take_plain_version(cuda, monkeypatch):
    monkeypatch.setattr(qm, "quant_matmul_plain",
                        lambda *a: pytest.fail("plain version on the card"))
    for m in (8, 64):
        x, qw, s, z = _operands(m, 96, 256, None, torch.bfloat16, cuda)
        ss, zs = _task_stacks(3, s, z, seed=m)
        ids = torch.arange(m, dtype=torch.int32, device=cuda) % 3
        ops.quant_matmul_slotted(x, qw, ss, zs, ids, QuantSpec())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 128, 12])
@pytest.mark.parametrize("bits,p", [(4, 4), (4, 3), (4, 2), (4, 1), (3, 3),
                                    (3, 2)])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 33, 256])
def test_plane_kernels_bitwise_nibble_and_within_bound(cuda, m, bits, p,
                                                       group, dtype):
    """K6a at M <= 32 (the GEMV, and its task form over 3 tasks) and above
    (the GEMM), ragged N (100); groups of 12 straddle packed words (the
    GEMV's per-code path)."""
    k = 288 if group == 12 else 512
    g = torch.Generator().manual_seed(31 * m + 7 * p + k)
    w = torch.randn(100, k, generator=g) * k ** -0.5
    q, s, z = rtn_quantize(w, QuantSpec(bits=bits, group_size=group), n_grid=4)
    x = torch.randn(m, k, generator=g).to(dtype)
    shift = bits - p
    sd, zd = draft_scales(s, z, bits, p)
    x, planes, s, z, sd, zd, nib = (
        t.to(cuda).contiguous()
        for t in (x, pack_codes_planes(q, bits), s, z, sd, zd,
                  pack_codes(q >> shift)))
    gemv = m <= qm.GEMV_MAX_M
    fn, nfn = ((qm.quant_gemv_planes, qm.quant_gemv) if gemv
               else (qm.quant_matmul_planes, qm.quant_matmul))
    before = fn.launches
    got = fn(x, planes, s, z, p, shift)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, nfn(x, nib, sd, zd))
    plain = qm.quant_matmul_planes_plain(x, planes, s, z, p, shift)
    err = (got.float() - plain.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= qm.error_bound(x, planes, s, z, plain,
                                  planes=(p, shift))).all()
    if not gemv:
        return
    ss, zs = _task_stacks(3, s, z, seed=m + p)
    ids = torch.tensor([(3 * i + 1) % 3 for i in range(m)], dtype=torch.int32,
                       device=cuda)
    got = qm.quant_gemv_tasks_planes(x, planes, ss, zs, ids, p, shift)
    sdd, zdd = draft_scales(ss, zs, bits, p)
    assert torch.equal(got, qm.quant_gemv_tasks(x, nib, sdd.contiguous(),
                                                zdd.contiguous(), ids))
    plain = qm.quant_matmul_tasks_planes_plain(x, planes, ss, zs, ids, p,
                                               shift)
    err = (got.float() - plain.float()).abs()
    assert (err <= qm.error_bound(x, planes, ss, zs, plain, task_ids=ids,
                                  planes=(p, shift))).all()


@pytest.mark.gpu
def test_plane_ops_never_take_plain_version_and_refuse_short_buffers(
        cuda, monkeypatch):
    monkeypatch.setattr(qm, "quant_matmul_planes_plain",
                        lambda *a, **k: pytest.fail("plain version on the card"))
    g = torch.Generator().manual_seed(0)
    q, s, z = rtn_quantize(torch.randn(96, 256, generator=g) * 0.06,
                           QuantSpec(bits=4), n_grid=4)
    planes, s, z = (t.to(cuda) for t in (pack_codes_planes(q, 4), s, z))
    spec = QuantSpec(bits=4, layout="plane")
    for m in (8, 64):
        x = torch.randn(m, 256, generator=g).to(torch.bfloat16).to(cuda)
        ops.quant_matmul(x, planes, s, z, spec, draft_bits=3)
        ops.quant_matmul_slotted(x, planes, s[None], z[None],
                                 torch.zeros(m, dtype=torch.int32,
                                             device=cuda), spec, draft_bits=3)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="planes"):
        qm.quant_gemv_planes(x[:8], planes[:2].contiguous(), s, z, 3)
