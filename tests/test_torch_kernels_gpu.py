"""The port's CUDA kernels against their plain version, on the card.

Marked ``gpu``; every test skips without a CUDA device (decided while the
test runs, so every xdist worker collects the same tests).  This file
imports only torch and the port, so it also runs on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: ``quant_matmul.error_bound`` (two float32 summation orders, plus
one bf16 ulp for bf16 outputs); for every GEMV and GEMM on its tensor-core
route (bf16 x, K and the group size multiples of 64: ``tc_route``) its
factored form, derived in its docstring (for the GEMV with its K split,
``gemv=True``), which also bounds the kernel's distance from its emulation
``quant_matmul_factored_plain`` / ``quant_gemv_factored_plain`` — bitwise
equality with the emulation is not asked, since the tensor cores' order of
summation inside a k-step is not reproducible on the CPU.  Bitwise, on
both GEMV routes: K1, K5, K1-plane and K5-plane rows at M ∈ {1, 2, 4, 8,
16} equal the same rows at M = 32, at the llama3.2-1b linears; the tied
head's rows at M = 8 equal them at M = 32; and on a 2-layer llama3.2-1b at
full width every op of a speculative verify (M = 32) gives the bits of the
matching decode steps (M = 8), under ``"dense"`` and ``"chunked"``
(``models.row_trace``).  K5
(``quant_gemv_tasks``) is held to its plain version within that bound and
to K1 bit for bit: each of its rows must equal K1's row under that row's
task scales.  K6a (the ``*_planes`` kernels) is held to its plain version
within that bound and to its nibble kernel bit for bit: reading the top p
of b' planes under ``shift = b' − p`` must equal the nibble kernel on
``q >> shift`` under ``draft_scales``.  K3 and K6b (``rtn_pack``,
``rtn_pack_planes``) must equal their plain version bit for bit: codes,
scales and zeros.  K4 (``flash_attention``) is held to its plain version
within ``flash_attention.error_bound`` (for bf16 its tensor-core form:
split-P product, split keys for Sq ≤ 4), and its logsumexp output within
``flash_attention.lse_error_bound``, o's bits unchanged by it.  The
training slice: the autograd ``quant_matmul`` on CUDA tensors (K2 forward,
the plain route's gradients bit for bit on the same inputs, ds and dz
within ``ops.qmm_grad_bound`` of float64), and no autograd node on the
serving path.
"""
import pytest
import torch

from repro_torch.core.quant import (QuantSpec, draft_scales, pack_codes,
                                    pack_codes_planes, rtn_quantize)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import rtn_pack as rp


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


def _assert_within_bound(got, plain, args, factored=False, gemv=False):
    assert got.dtype == plain.dtype and got.shape == plain.shape
    err = (got.float() - plain.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= qm.error_bound(*args, plain, factored=factored,
                                  gemv=gemv)).all(), \
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
    _assert_within_bound(got, qm.quant_matmul_plain(*args), args,
                         factored=qm.tc_route(args[0], args[2]),
                         gemv=fn is qm.quant_gemv)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(2048, 2048), (512, 2048), (8192, 2048),
                                 (2048, 8192)])
def test_kernels_at_llama_shapes(cuda, n, k):
    for m in (4, 300):
        args = _operands(m, n, k, None, torch.bfloat16, cuda, seed=n + k)
        got = ops.quant_matmul(*args, QuantSpec())
        torch.cuda.synchronize()
        _assert_within_bound(got, qm.quant_matmul_plain(*args), args,
                             factored=True, gemv=m <= qm.GEMV_MAX_M)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("n,k", [(2048, 2048), (512, 2048), (8192, 2048),
                                 (2048, 8192)])
@pytest.mark.parametrize("m", [33, 200, 1024])
def test_k2_tensor_cores_within_bound_of_plain_and_emulation(cuda, m, n, k,
                                                             group):
    """K2's tensor-core route at the llama3.2-1b linears: within the
    factored bound of the plain version and of the emulation of its
    arithmetic (per group, f32 sums of x·q and x in k-steps of 16)."""
    args = _operands(m, n, k, group, torch.bfloat16, cuda, seed=m + n + k)
    assert qm.tc_route(args[0], args[2])
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    _assert_within_bound(got, qm.quant_matmul_plain(*args), args,
                         factored=True)
    _assert_within_bound(got, qm.quant_matmul_factored_plain(*args), args,
                         factored=True)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("m,n", [(1024, 8192), (1000, 8190), (1024, 2048),
                                 (1000, 2040), (1024, 512), (1000, 500)])
def test_k2_every_tile_bitwise_planes_and_within_bound(cuda, m, n, group):
    """Each tile shape of K2's tensor-core route (128 × 256 per-channel at
    N = 8192, 128 × 128 at 2048, 64 × 64 at 512), full and ragged (M and N
    not multiples of the tile, N not of 8): within the factored bound of
    the plain version, and K2-plane bit for bit K2 on q >> (4 − p) under
    draft_scales."""
    k = 2048
    g = torch.Generator().manual_seed(m + n)
    w = torch.randn(n, k, generator=g) * k ** -0.5
    q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group), n_grid=2)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16)
    x, qw, s, z = (t.to(cuda) for t in (x, pack_codes(q), s, z))
    assert qm.tc_route(x, s)
    got = qm.quant_matmul(x, qw, s, z)
    torch.cuda.synchronize()
    _assert_within_bound(got, qm.quant_matmul_plain(x, qw, s, z),
                         [x, qw, s, z], factored=True)
    planes = pack_codes_planes(q, 4).to(cuda)
    for p in (4, 3):
        sd, zd = draft_scales(s, z, 4, p)
        nib = pack_codes(q >> (4 - p)).to(cuda)
        assert torch.equal(qm.quant_matmul_planes(x, planes, s, z, p, 4 - p),
                           qm.quant_matmul(x, nib, sd.contiguous(),
                                           zd.contiguous()))


@pytest.mark.gpu
def test_cuda_tensor_never_takes_plain_version(cuda, monkeypatch):
    monkeypatch.setattr(qm, "quant_matmul_plain",
                        lambda *a: pytest.fail("plain version on the card"))
    monkeypatch.setattr(qm, "quant_matmul_factored_plain",
                        lambda *a, **k: pytest.fail("emulation on the card"))
    monkeypatch.setattr(qm, "quant_gemv_factored_plain",
                        lambda *a, **k: pytest.fail("emulation on the card"))
    for m in (4, 64, 1024):
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
    tc = qm.tc_route(x, s)
    assert (err <= qm.error_bound(x, qw, ss, zs, plain, task_ids=ids,
                                  factored=tc, gemv=tc)).all(), \
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
    factored = qm.tc_route(x, s)
    before = fn.launches
    got = fn(x, planes, s, z, p, shift)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, nfn(x, nib, sd, zd))
    plain = qm.quant_matmul_planes_plain(x, planes, s, z, p, shift)
    err = (got.float() - plain.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= qm.error_bound(x, planes, s, z, plain, planes=(p, shift),
                                  factored=factored, gemv=gemv)).all()
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
                                  planes=(p, shift), factored=factored,
                                  gemv=True)).all()


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


def _tie_weights(n, k, bits, group, seed):
    """Rows whose every w/s + z is a half-integer: round half to even
    decides every code (roundf would round them all away from zero)."""
    half = 1 << (bits - 1)
    s0 = 0.25
    g = torch.Generator().manual_seed(seed)
    group = group or k
    vals = (torch.arange(-half, half - 1, dtype=torch.float32) + 0.5) * s0
    w = vals[torch.randint(0, len(vals), (n, k), generator=g)]
    w = w.reshape(n, k // group, group)
    w[..., 0] = -half * s0                   # the range: s = s0, z = half
    w[..., 1] = (half - 1) * s0
    return w.reshape(n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 128, 32])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("plane", [False, True], ids=["nibble", "plane"])
@pytest.mark.parametrize("weights", ["normal", "ties"])
def test_rtn_pack_bitwise_plain(cuda, weights, plane, bits, group, dtype):
    """K3 / K6b on ragged N (100), K 512 (per-channel: one block-wide group;
    group 128: a warp per group; group 32: 16 groups of one lane-width)."""
    n, k = 100, 512
    if weights == "ties":
        w = _tie_weights(n, k, bits, group, seed=bits)
    else:
        g = torch.Generator().manual_seed(3 * bits + (group or 0))
        w = torch.randn(n, k, generator=g) * k ** -0.5
    w = w.to(dtype).to(cuda)
    fn, plain = ((rp.rtn_pack_planes, rp.rtn_pack_planes_plain) if plane
                 else (rp.rtn_pack, rp.rtn_pack_plain))
    before = fn.launches
    got = fn(w, bits, group)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(w, bits, group)
    for a, b, name in zip(got, want, ("qw", "scale", "zero")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("n,k", [(2048, 2048), (512, 2048), (8192, 2048),
                                 (2048, 8192)])
def test_rtn_pack_at_llama_shapes(cuda, n, k, group, dtype):
    """The conversion's own shapes: llama3.2-1b's four linears, f32 (the
    checkpoint's dtype) and bf16, per-channel and group 128."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).to(dtype)
    for plane in (False, True):
        spec = QuantSpec(bits=4, group_size=group,
                         layout="plane" if plane else "nibble")
        got = ops.rtn_pack(w, spec)
        with ops.force_impl("torch"):
            want = ops.rtn_pack(w, spec)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("n,k,group", [
    (1, 32, None), (3, 32, None), (1, 8192, None), (3, 8192, 128),
    (5, 2048, None),       # R = 4 rows a tile: a last tile of one row
    (7, 1024, 32),         # R = 8: one short tile
    (300, 96, 32), (9, 9216, None), (2, 12288, 128),    # K > 8192: a row
    (6, 96, 48), (4, 264, 12), (6, 40, 8), (3, 40, None), (5, 64, 16)])
def test_rtn_pack_edges_bitwise_plain(cuda, n, k, group, bits, dtype):
    """What a tile of whole rows can get wrong: N of 1 and 3, N no multiple
    of a tile's rows, K of 32 and 8192 and above (one row a tile), groups
    of 32 and 128, and groups that are no multiple of a 32-code chunk (48,
    16) or of a nibble word (12; K 264 and 40 take 8-code chunks)."""
    g = torch.Generator().manual_seed(n * k + bits)
    w = (torch.randn(n, k, generator=g) * k ** -0.5).to(dtype).to(cuda)
    for plane in (False, True):
        if plane and k % 32:
            continue
        fn, plain = ((rp.rtn_pack_planes, rp.rtn_pack_planes_plain) if plane
                     else (rp.rtn_pack, rp.rtn_pack_plain))
        got = fn(w, bits, group)
        torch.cuda.synchronize()
        want = plain(w, bits, group)
        for a, b, name in zip(got, want, ("qw", "scale", "zero")):
            assert a.shape == b.shape and torch.equal(a, b), (plane, name)


@pytest.mark.gpu
def test_rtn_pack_cuda_tensors_never_take_plain_version(cuda, monkeypatch):
    monkeypatch.setattr(rp, "rtn_pack_plain",
                        lambda *a: pytest.fail("plain version on the card"))
    monkeypatch.setattr(rp, "rtn_pack_planes_plain",
                        lambda *a: pytest.fail("plain version on the card"))
    w = torch.randn(64, 256, device=cuda)
    for layout in ("nibble", "plane"):
        ops.rtn_pack(w, QuantSpec(bits=4, layout=layout))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="divide"):
        rp.rtn_pack(w, 4, 48)


def _attention_inputs(b, sq, sk, hq, hkv, d, dtype, device, seed,
                      strided=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g)
    k = torch.randn(b, sk, hkv, d, generator=g)
    v = torch.randn(b, sk, hkv, d, generator=g)
    q, k, v = (t.to(dtype).to(device) for t in (q, k, v))
    if strided:                  # a layer's slice of a stacked (L, B, …) cache
        k = torch.stack([torch.zeros_like(k), k])[1]
        v = torch.stack([v, torch.zeros_like(v)])[0]
        q = torch.cat([q, q], dim=2)[:, :, :hq]
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,causal,window,offset",
    [(2, 32, 32, 2, 2, 16, True, None, None),
     (1, 8, 24, 4, 4, 8, True, None, 16),
     (2, 32, 32, 2, 2, 16, True, 12, None),
     (1, 16, 48, 2, 2, 8, False, None, None),
     (4, 256, 256, 32, 8, 64, True, None, None),     # the prefill
     (8, 1, 512, 32, 8, 64, True, None, "slots"),    # slot decode
     (8, 4, 512, 32, 8, 64, True, None, "slots"),    # slot verify
     (3, 5, 70, 6, 2, 128, True, 20, "slots"),
     (2, 7, 40, 3, 1, 40, False, 9, 5),
     (2, 3, 50, 4, 2, 64, True, None, "negative")])  # rows that see no key
def test_flash_attention_within_bound_of_plain(cuda, b, sq, sk, hq, hkv, d,
                                               causal, window, offset, dtype):
    q, k, v = _attention_inputs(b, sq, sk, hq, hkv, d, dtype, cuda,
                                seed=b * sk + d, strided=sk == 70)
    if offset == "slots":
        offset = torch.linspace(20, min(300, sk - sq), b).to(torch.int64
                                                              ).to(cuda)
    elif offset == "negative":
        offset = torch.tensor([-2, 30], device=cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             offset=offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     offset=offset)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    assert torch.isfinite(got).all()
    err = (got.float() - plain.float()).abs()
    bound = fa.error_bound(q, k, v, plain)
    assert (err <= bound).all(), f"max err {err.max().item():.3e}"
    if torch.is_tensor(offset) and (offset < 0).any():
        assert torch.equal(got[0, :2], torch.zeros_like(got[0, :2]))


@pytest.mark.gpu
def test_chunked_attention_cuda_never_takes_plain_version(cuda, monkeypatch):
    from repro_torch.kernels import ref
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain version on the card"))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: pytest.fail("plain version on the card"))
    q, k, v = _attention_inputs(2, 4, 64, 8, 2, 64, torch.bfloat16, cuda, 0)
    ops.attention(q, k, v, offset=torch.tensor([3, 40], device=cuda),
                  impl="chunked")
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q[..., :60], k[..., :60], v[..., :60])


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("sk", [288, 512])
@pytest.mark.parametrize("offsets", ["rows", "int"])
def test_flash_attention_split_keys_within_bound(cuda, sq, sk, offsets):
    """Decode and verify (Sq ≤ 4) at llama3.2-1b's heads: the keys split
    over decode_splits(Sq, Sk) blocks of SPLIT_KEYS keys, offsets spread
    over 20–300; one counted launch per call; within the bound of the plain
    version, and of the emulation of the split arithmetic."""
    b = 8 if offsets == "rows" else 4
    q, k, v = _attention_inputs(b, sq, sk, 32, 8, 64, torch.bfloat16, cuda,
                                seed=sk + sq)
    offset = (torch.linspace(20, 300, b).round().to(torch.int64).to(cuda)
              if offsets == "rows" else sk - 22)
    splits = fa.decode_splits(sq, sk)
    assert splits == -(-sk // fa.SPLIT_KEYS) > 1
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, offset=offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert torch.isfinite(got).all()
    for want in (fa.flash_attention_plain(q, k, v, offset=offset),
                 fa.flash_attention_split_plain(q, k, v, offset=offset,
                                                splits=splits,
                                                chunk=fa.SPLIT_KEYS)):
        err = (got.float() - want.float()).abs()
        assert (err <= fa.error_bound(q, k, v, want)).all(), \
            f"max err {err.max().item():.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("offsets", ["rows", "int"])
def test_flash_attention_bits_do_not_depend_on_the_capacity(cuda, sq,
                                                            offsets):
    """K4 over caches of 304, 307, 1100 and 4096 rows whose visible keys
    are the same (the rows past them hold other values in each): bit-equal
    outputs, decode and verify, one position or one a row."""
    b = 8 if offsets == "rows" else 4
    q, k, v = _attention_inputs(b, sq, 4096, 32, 8, 64, torch.bfloat16, cuda,
                                seed=sq)
    offset = (torch.linspace(20, 300 - sq, b).round().to(torch.int64).to(cuda)
              if offsets == "rows" else 300 - sq)
    seen = 300                     # keys 0..299: every query's visible range
    outs = []
    for i, cap in enumerate((304, 307, 1100, 4096)):
        kc, vc = k[:, :cap].clone(), v[:, :cap].clone()
        kc[:, seen:] = float(i + 1)
        vc[:, seen:] = -float(i + 1)
        outs.append(fa.flash_attention(q, kc, vc, offset=offset))
    torch.cuda.synchronize()
    assert all(torch.isfinite(o).all() for o in outs)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.gpu
def test_dense_decode_on_the_card_takes_k4(cuda, two_layer_llama,
                                          monkeypatch):
    """Under attn_impl="dense" a decode step and a verify of the 2-layer
    llama3.2-1b on the card launch K4 once a layer, all S queries in one
    launch, and never the plain einsum."""
    from repro_torch.kernels import ref
    from repro_torch.models import registry
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain einsum on the card"))
    cfg, model, _ = two_layer_llama["nibble"]
    api = registry.build(cfg.replace(attn_impl="dense"))
    cache = {key: t.clone() for key, t in two_layer_llama["cache"].items()}
    pos = torch.arange(8, device=cuda) * 31 + 20
    for s in (1, 4):
        toks = torch.randint(0, cfg.vocab_size, (8, s),
                             generator=torch.Generator().manual_seed(s)
                             ).to(cuda)
        before = fa.flash_attention.launches
        step = api.decode_step if s == 1 else api.decode_verify
        with torch.inference_mode():
            logits, cache = step(model, cache, toks, pos)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + cfg.n_layers
        assert torch.isfinite(logits).all()


@pytest.mark.gpu
def test_flash_attention_split_cuda_never_takes_plain_version(cuda,
                                                              monkeypatch):
    for name in ("flash_attention_plain", "flash_attention_split_plain",
                 "split_p_product"):
        monkeypatch.setattr(fa, name, lambda *a, **k: pytest.fail(
            "plain version on the card"))
    q, k, v = _attention_inputs(8, 1, 512, 32, 8, 64, torch.bfloat16, cuda, 1)
    for sq in (1, 4, 64):
        ops.attention(q.expand(8, sq, 32, 64).contiguous(), k, v,
                      offset=torch.arange(8, device=cuda) * 40 + 20,
                      impl="chunked")
    torch.cuda.synchronize()


LLAMA_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
# and one whose K the tensor-core GEMV splits over 4 blocks
GEMV_SHAPES = LLAMA_SHAPES + [(48, 32768)]
_llama = {}


def _llama_operands(n, k, group):
    """RTN codes of N(0, 1/K) weights at a llama3.2-1b linear, 4 task
    stacks and their 4-plane form, made on the card once per shape."""
    key = (n, k, group)
    if key not in _llama:
        g = torch.Generator(device="cuda").manual_seed(n + k + (group or 0))
        w = torch.randn(n, k, generator=g, device="cuda") * k ** -0.5
        q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group),
                               n_grid=4)
        ss, zs = _task_stacks(4, s, z, seed=n + k)
        x = torch.randn(32, k, generator=g, device="cuda")
        _llama[key] = (x, pack_codes(q), s.contiguous(), z.contiguous(), ss,
                       zs, pack_codes_planes(q, 4))
    return _llama[key]


_GEMV_FORMS = ["k1", "k5", "k1_planes", "k5_planes"]


def _gemv_form(form, qw, s, z, ss, zs, planes):
    """(M-row call of the form's GEMV) — the planes forms read the 3-plane
    draft, the task forms 4 tasks, row i under task i % 4."""
    def ids(m):
        return torch.arange(m, dtype=torch.int32, device="cuda") % 4
    return {
        "k1": lambda x: qm.quant_gemv(x, qw, s, z),
        "k5": lambda x: qm.quant_gemv_tasks(x, qw, ss, zs, ids(x.shape[0])),
        "k1_planes": lambda x: qm.quant_gemv_planes(x, planes, s, z, 3, 1),
        "k5_planes": lambda x: qm.quant_gemv_tasks_planes(
            x, planes, ss, zs, ids(x.shape[0]), 3, 1),
    }[form]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("form", _GEMV_FORMS)
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("n,k", GEMV_SHAPES)
def test_gemv_rows_do_not_depend_on_m(cuda, n, k, group, form, route):
    """Row i of K1, K5, K1-plane and K5-plane gives the same bits at M = 1,
    2, 4, 8 and 16 as at M = 32, on the tensor-core route (bf16 x) and the
    SIMT route (f32 x): a verify of 8 slots × 4 tokens gives the bits of 4
    decode steps of 8 slots."""
    x, qw, s, z, ss, zs, planes = _llama_operands(n, k, group)
    x = x.to(torch.bfloat16 if route == "mma" else torch.float32)
    assert qm.tc_route(x, s) == (route == "mma")
    fn = _gemv_form(form, qw, s, z, ss, zs, planes)
    full = fn(x)
    for m in (1, 2, 4, 8, 16):
        assert torch.equal(fn(x[:m].contiguous()), full[:m]), f"M = {m}"


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", LLAMA_SHAPES + [(96, 256), (48, 32768)])
def test_gemv_block_split_matches_mirror(cuda, n, k):
    """The built kernel splits K over the blocks the emulation assumes
    (``gemv_block_split``): 2 for the down projection, 4 at (48, 32768),
    1 elsewhere."""
    assert qm.gemv_tc_split(n, k) == qm.gemv_block_split(n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 8, 32])
@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("n,k", GEMV_SHAPES)
def test_gemv_tensor_cores_within_bound_of_plain_and_emulation(cuda, n, k,
                                                               group, m):
    """The GEMV's tensor-core route at the llama3.2-1b linears: within the
    factored bound (with the GEMV's K split) of the plain version and of
    the emulation ``quant_gemv_factored_plain``; K5 likewise against its
    emulation under 4 tasks."""
    x, qw, s, z, ss, zs, _ = _llama_operands(n, k, group)
    x = x[:m].to(torch.bfloat16).contiguous()
    before = qm.quant_gemv.launches
    got = qm.quant_gemv(x, qw, s, z)
    torch.cuda.synchronize()
    assert qm.quant_gemv.launches == before + 1
    args = [x, qw, s, z]
    _assert_within_bound(got, qm.quant_matmul_plain(*args), args,
                         factored=True, gemv=True)
    _assert_within_bound(got, qm.quant_gemv_factored_plain(*args), args,
                         factored=True, gemv=True)
    ids = torch.arange(m, dtype=torch.int32, device=cuda) % 4
    got = qm.quant_gemv_tasks(x, qw, ss, zs, ids)
    emu = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids)
    err = (got.float() - emu.float()).abs()
    assert (err <= qm.error_bound(x, qw, ss, zs, emu, task_ids=ids,
                                  factored=True, gemv=True)).all()


@pytest.mark.gpu
def test_head_rows_do_not_depend_on_m(cuda):
    """The tied head (one bf16 GEMM with f32 output over the 128256 × 2048
    table): rows at M = 8 equal the same rows at M = 32."""
    from repro_torch import configs
    from repro_torch.models import common
    cfg = configs.get_config("llama3.2-1b")
    emb = common.Embed(cfg, device=cuda)
    emb.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(32, 1, cfg.d_model, device=cuda).to(torch.bfloat16)
    full = common.head_apply(None, emb, x, cfg)
    assert torch.equal(common.head_apply(None, emb, x[:8], cfg), full[:8])


@pytest.mark.gpu
def test_tied_head_training_on_the_card(cuda):
    """``ops.dot_f32`` with grad on: logits bit-equal to the serving call
    (one bf16 GEMM with f32 output either way); dx and demb within their
    float32 summation bounds of float64 (plus one bf16 rounding)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    m, d, v = 512, 2048, 32768
    x = torch.randn(m, d, generator=gen, device=cuda).to(torch.bfloat16)
    emb = (torch.randn(v, d, generator=gen, device=cuda) * 0.02
           ).to(torch.bfloat16)
    dy = torch.randn(m, v, generator=gen, device=cuda) * 1e-3
    with torch.no_grad():
        serve = ops.dot_f32(x, emb)
    xg, eg = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    y = ops.dot_f32(xg, eg)
    assert torch.equal(y.detach(), serve)
    y.backward(dy)
    xd, ed, dyd = x.double(), emb.double(), dy.double()
    for got, want, mag, n in ((xg.grad, dyd @ ed, dyd.abs() @ ed.abs(), v),
                              (eg.grad, dyd.T @ xd, dyd.abs().T @ xd.abs(),
                               m)):
        bound = 2 * n * 2.0 ** -24 * mag + want.abs() * 2.0 ** -8
        assert ((got.double() - want).abs() <= bound).all()


@pytest.fixture(scope="module")
def two_layer_llama():
    """llama3.2-1b at full width, 2 layers, PEQA 4-bit per-channel, its
    4-plane repack, a 4-task resident stack of each, and a 512-slot cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.core.quant import unpack_codes
    from repro_torch.core.scale_bank import ResidentStack, ScaleBank
    from repro_torch.models import registry, transformer
    from repro_torch.models.linear import Linear
    cfg = configs.get_config("llama3.2-1b").replace(
        n_layers=2, tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))
    api = registry.build(cfg)
    model, _ = policies.prepare(api.init(0), cfg)
    cfg_p = cfg.replace(quant=QuantConfig(bits=4, group_size=None, n_grid=20,
                                          layout="plane"))
    plane = transformer.Transformer(cfg_p, device="meta")
    srcs = dict(model.named_modules())
    with torch.no_grad():
        for name, mod in plane.named_modules():
            if isinstance(mod, Linear):
                lin = srcs[name]
                mod.set_quantized(pack_codes_planes(unpack_codes(lin.qw), 4),
                                  lin.scale.detach().clone(),
                                  lin.zero.detach().clone(), cfg_p.quant.spec())
            for pname, prm in list(mod._parameters.items()):
                if prm is not None and prm.is_meta:
                    mod._parameters[pname] = srcs[name]._parameters[pname]
    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(4)
    for t in range(1, 4):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    warm = [f"t{t}" for t in range(4)]
    cache = api.init_cache(8, 512)
    for key in cache:
        cache[key].normal_(generator=torch.Generator(device="cuda"
                                                     ).manual_seed(0))
    return {"nibble": (cfg, model, ResidentStack(bank, model, 4,
                                                 warm=warm).stack),
            "plane": (cfg_p, plane, ResidentStack(bank, plane, 4,
                                                  warm=warm).stack),
            "cache": cache}


@pytest.mark.gpu
@pytest.mark.parametrize("tasked", [True, False], ids=["tasks", "untasked"])
@pytest.mark.parametrize("layout", ["nibble", "plane"])
@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_decode_verify_rows_equal_op_by_op(cuda, two_layer_llama, impl,
                                           layout, tasked):
    """One speculative verify of 8 slots × 4 tokens (M = 32) against the 4
    matching decode steps (M = 8) on a 2-layer llama3.2-1b at full width:
    every op's rows bit-equal (embedding, norms, linears, RoPE, attention,
    head, argmax), and each op kind alone on equal inputs likewise."""
    from repro_torch.models import registry, row_trace
    cfg, model, stack = two_layer_llama[layout]
    api = registry.build(cfg.replace(attn_impl=impl))
    cache = two_layer_llama["cache"]
    pos = torch.arange(8, device=cuda) * 31 + 20
    ids = torch.arange(8, dtype=torch.int32, device=cuda) % 4
    toks = torch.randint(0, cfg.vocab_size, (8, 4),
                         generator=torch.Generator().manual_seed(5)).to(cuda)
    st, tid = (stack, ids) if tasked else (None, None)
    rep = row_trace.compare_verify(api, model, cache, toks, pos, st, tid)
    assert rep["first_differing"] is None, rep["first_differing"]
    assert rep["logits_equal"] and rep["argmax_equal"]
    iso = row_trace.isolated_ops(model, cfg, cache, pos, 4, st, tid)
    assert all(r["equal"] for r in iso.values()), \
        [k for k, r in iso.items() if not r["equal"]]


# ------------------------------------------------------------ training slice

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,window,offset",
    [(8, 256, 256, 32, 8, 64, None, None),           # the training step's
     (2, 32, 32, 2, 2, 16, 12, None),
     (3, 5, 70, 6, 2, 128, 20, "slots"),
     (8, 4, 512, 32, 8, 64, None, "slots"),          # split keys: the combine
     (2, 3, 50, 4, 2, 64, None, "negative")])        # rows that see no key
def test_flash_attention_logsumexp_within_bound_and_o_unchanged(
        cuda, b, sq, sk, hq, hkv, d, window, offset, dtype):
    """K4's logsumexp output against the plain version's, within
    ``flash_attention.lse_error_bound``; o bit-equal whether or not it is
    asked for; −inf exactly where a row sees no key."""
    q, k, v = _attention_inputs(b, sq, sk, hq, hkv, d, dtype, cuda,
                                seed=7 * sk + d)
    if offset == "slots":
        offset = torch.linspace(20, min(300, sk - sq), b).to(torch.int64
                                                              ).to(cuda)
    elif offset == "negative":
        offset = torch.tensor([-2, 30], device=cuda)
    kw = dict(window=window, offset=offset)
    o_only = fa.flash_attention(q, k, v, **kw)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert torch.equal(o, o_only)
    _, plain = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert torch.equal(torch.isneginf(lse), torch.isneginf(plain))
    seen = torch.isfinite(plain)
    err = (lse - plain).abs()[seen]
    assert (err <= fa.lse_error_bound(q, k, plain)[seen]).all(), \
        f"max err {err.max().item():.3e}"


def _grad_case(m, n, k, group, dtype, device):
    x, qw, s, z = _operands(m, n, k, group, dtype, device, seed=m + n)
    x.requires_grad_(True)
    s.requires_grad_(True)
    z.requires_grad_(True)
    dy = (torch.randn(m, n, generator=torch.Generator().manual_seed(n)) * 0.1
          ).to(dtype).to(device)
    return x, qw, s, z, dy


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,n,k,group", [(2048, 512, 2048, None),
                                         (256, 2048, 512, 128),
                                         (64, 96, 256, 64)])
def test_autograd_quant_matmul_on_the_card(cuda, m, n, k, group, dtype):
    """The autograd ``quant_matmul`` on CUDA tensors: its forward is the
    kernel (K2, one launch) within ``error_bound`` of the plain route; its
    backward gives the plain route's gradients bit for bit on the same
    (x, dy) — both run ``quant_matmul_bwd`` — and ds, dz within
    ``qmm_grad_bound`` of the float64 Eq. (2), dx within its float32
    summation bound of the float64 dy·Ŵ."""
    spec = QuantSpec(bits=4, group_size=group)
    x, qw, s, z, dy = _grad_case(m, n, k, group, dtype, cuda)
    before = qm.quant_matmul.launches
    y = ops.quant_matmul(x, qw, s, z, spec)
    assert qm.quant_matmul.launches == before + 1
    y.backward(dy)
    grads = [t.grad.clone() for t in (x, s, z)]
    with ops.force_impl("torch"):
        for t in (x, s, z):
            t.grad = None
        yp = ops.quant_matmul(x, qw, s, z, spec)
        yp.backward(dy)
    _assert_within_bound(y.detach(), yp.detach(), (x.detach(), qw, s.detach(),
                         z.detach()), factored=qm.tc_route(x, s))
    for got, t in zip(grads, (x, s, z)):
        assert torch.equal(got, t.grad)
    # against float64
    from repro_torch.core.quant import unpack_codes
    g = s.shape[1]
    xd, dyd = x.detach().double(), dy.double()
    c = (dyd.T @ xd).reshape(n, g, k // g)
    codes = unpack_codes(qw, k).double().reshape(n, g, k // g)
    ds = (c * (codes - z.detach().double()[..., None])).sum(-1)
    dz = -s.detach().double() * c.sum(-1)
    bds, bdz = ops.qmm_grad_bound(x.detach(), qw, s.detach(), z.detach(),
                                  spec, dy)
    assert ((grads[1].double() - ds).abs() <= bds).all()
    assert ((grads[2].double() - dz).abs() <= bdz).all()
    from repro_torch.kernels import ref
    w = ref.dequant_ref(qw, s.detach(), z.detach(), (n, k), spec, dtype)
    dx = dyd @ w.double()
    bound = 2 * n * 2.0 ** -24 * (dyd.abs() @ w.double().abs())
    if dtype == torch.bfloat16:
        bound = bound + dx.abs() * 2.0 ** -8
    assert ((grads[0].double() - dx).abs() <= bound).all()


@pytest.mark.gpu
def test_serving_path_makes_no_autograd_node(cuda, two_layer_llama):
    """With trainable scales (requires_grad) the serving path still takes
    the direct kernel call: no autograd node, the same launches and bits
    as without them; with grad on, the training forward makes the node."""
    from repro_torch.models import registry
    cfg, model, _ = two_layer_llama["nibble"]
    api = registry.build(cfg)
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    tokens = torch.randint(0, api.cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3)).to(cuda)
    outs = []
    for train in (False, True):
        for n, p in model.named_parameters():
            p.requires_grad_(train and n.endswith(".scale"))
        before = qm.quant_matmul.launches
        with torch.inference_mode():
            logits, _ = api.prefill(model, {"tokens": tokens})
        assert logits.grad_fn is None
        assert qm.quant_matmul.launches - before == api.cfg.n_layers * 7
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])
    loss = api.loss_fn(model, {"tokens": tokens, "labels": tokens})
    assert loss.grad_fn is not None
    loss.backward()
    grads = [p.grad for n, p in model.named_parameters()
             if n.endswith(".scale")]
    assert grads and all(g is not None and torch.isfinite(g).all()
                         for g in grads)
    for n, p in model.named_parameters():
        p.grad = None
        p.requires_grad_(flags[n])


# ------------------------------------------------ the dense family at 7B

# (Hq, Hkv) of qwen2-7b, starcoder2-7b and granite-34b (MQA), heads of 128
DENSE_7B_HEADS = [(28, 4), (36, 4), (48, 1)]
# qwen2-7b's four linear shapes (N, K): q/o, k/v, gate/up, down
QWEN_SHAPES = [(3584, 3584), (512, 3584), (18944, 3584), (3584, 18944)]


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv", DENSE_7B_HEADS)
@pytest.mark.parametrize("case", ["prefill", "window", "decode", "verify",
                                  "ring"])
def test_flash_attention_at_head_dim_128(cuda, case, hq, hkv):
    """K4's D = 128 instantiation at the 7B models' head layouts (GQA
    groups of 7, 9 and 48): the prefill (B 2 × 256, causal, and under a
    64-key window), a slot-pool decode and verify (B 8 over 512 keys,
    offsets spread over 20–300) and a ring's decode (offsets past the last
    key: every key visible), within ``error_bound`` of plain; the decode
    and verify bit-equal across capacities of 304 and 1100 rows, and the
    ring's bit-equal to the same keys at offset Sk − Sq."""
    prefill = case in ("prefill", "window")
    b, sq, sk = (2, 256, 256) if prefill else (
        8, 4 if case == "verify" else 1, 512)
    q, k, v = _attention_inputs(b, sq, sk, hq, hkv, 128, torch.bfloat16,
                                cuda, seed=hq + sq)
    window = 64 if case == "window" else None
    offset = None if prefill else (
        torch.tensor([sk, sk + 7, 3 * sk, sk + 100] * 2, device=cuda)
        if case == "ring" else
        torch.linspace(20, 300 - sq, b).round().to(torch.int64).to(cuda))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window, offset=offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    plain = fa.flash_attention_plain(q, k, v, window=window, offset=offset)
    assert torch.isfinite(got).all()
    err = (got.float() - plain.float()).abs()
    assert (err <= fa.error_bound(q, k, v, plain)).all(), \
        f"max err {err.max().item():.3e}"
    if case == "ring":
        assert torch.equal(got, fa.flash_attention(q, k, v, offset=sk - sq))
    if case in ("decode", "verify"):
        for cap in (304, 1100):
            kc = torch.full((b, cap, hkv, 128), 3.0, dtype=k.dtype,
                            device=cuda)
            vc = torch.full_like(kc, -3.0)
            kc[:, :300], vc[:, :300] = k[:, :300], v[:, :300]
            ref = fa.flash_attention(q, k[:, :300].contiguous(),
                                     v[:, :300].contiguous(), offset=offset)
            assert torch.equal(fa.flash_attention(q, kc, vc, offset=offset),
                               ref), cap


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", QWEN_SHAPES)
def test_gemv_and_gemm_at_qwen2_shapes(cuda, n, k):
    """K1 (M = 4), K5 (M = 8 over 4 tasks) and K2 (M = 1024) at qwen2-7b's
    linears, bf16, per-channel: within the factored bound of plain (K1 and
    K5 with the GEMV's K split), K5's rows bit-equal to K1's under their
    tasks, K1's rows at M = 1–16 bit-equal to M = 32, and the built
    kernel's K split the mirror's."""
    x, qw, s, z, ss, zs, _ = _llama_operands(n, k, None)
    x = x.to(torch.bfloat16)
    assert qm.gemv_tc_split(n, k) == qm.gemv_block_split(n, k)
    full = qm.quant_gemv(x, qw, s, z)
    for m in (1, 2, 4, 8, 16):
        assert torch.equal(qm.quant_gemv(x[:m].contiguous(), qw, s, z),
                           full[:m]), f"M = {m}"
    args = [x[:4].contiguous(), qw, s, z]
    _assert_within_bound(qm.quant_gemv(*args), qm.quant_matmul_plain(*args),
                         args, factored=True, gemv=True)
    ids = torch.arange(8, dtype=torch.int32, device=cuda) % 4
    x8 = x[:8].contiguous()
    got = qm.quant_gemv_tasks(x8, qw, ss, zs, ids)
    plain = qm.quant_matmul_tasks_plain(x8, qw, ss, zs, ids)
    err = (got.float() - plain.float()).abs()
    assert (err <= qm.error_bound(x8, qw, ss, zs, plain, task_ids=ids,
                                  factored=True, gemv=True)).all()
    for i in range(8):
        t = int(ids[i])
        assert torch.equal(got[i], qm.quant_gemv(x8, qw, ss[t], zs[t])[i])
    g = torch.Generator(device="cuda").manual_seed(n + 3)
    xm = torch.randn(1024, k, generator=g, device=cuda).to(torch.bfloat16)
    args = [xm, qw, s, z]
    assert qm.tc_route(xm, s)
    _assert_within_bound(qm.quant_matmul(*args),
                         qm.quant_matmul_plain(*args), args, factored=True)


@pytest.mark.gpu
def test_layernorm_rows_do_not_depend_on_m(cuda):
    """starcoder2-7b's LayerNorm (d 4608) on the card: rows at M = 1–32
    bit-equal to the same rows at M = 32 (both of its row means reduce a
    padded 32-row tensor), and within 2⁻⁸ of a float64 LayerNorm."""
    from repro_torch import configs
    from repro_torch.models import common
    cfg = configs.get_config("starcoder2-7b")
    norm = common.Norm(cfg, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        norm.g.normal_(1.0, 0.1, generator=g)
        norm.b.normal_(0.0, 0.1, generator=g)
    x = (torch.randn(32, 1, cfg.d_model, generator=g, device=cuda) * 3 + 1
         ).to(torch.bfloat16)
    full = common.norm_apply(norm, x, cfg)
    for m in range(1, 33):
        assert torch.equal(common.norm_apply(norm, x[:m], cfg), full[:m]), m
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    want = (xd - mu) / torch.sqrt(((xd - mu) ** 2).mean(-1, keepdim=True)
                                  + cfg.norm_eps) * norm.g.double() \
        + norm.b.double()
    assert ((full.double() - want).abs() <= 2 ** -8 * want.abs() + 1e-6).all()


@pytest.mark.gpu
def test_fp_linear_takes_the_tensor_cores_within_f32_bound(cuda):
    """An fp linear with bf16 x (qwen2-7b's untied head, cut to 8192 rows):
    ``ops.dot_f32`` — a bf16 GEMM with a float32 output — then bf16; y
    within the float32 summation bound of float64 plus its bf16 rounding,
    and with grad on the same bits, dx and dw within their bounds."""
    from repro_torch.models import linear
    n, k, m = 8192, 3584, 64
    lin = linear.Linear(k, n, device=cuda)
    lin.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, m // 2, k, generator=g, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        y = linear.apply(lin, x)
    assert y.dtype == torch.bfloat16
    wb = lin.w.detach().to(torch.bfloat16).double()
    xd = x.double().reshape(m, k)
    want = xd @ wb.T
    bound = 2 * k * 2.0 ** -24 * (xd.abs() @ wb.abs().T) \
        + want.abs() * 2.0 ** -8
    assert ((y.reshape(m, n).double() - want).abs() <= bound).all()
    xg = x.clone().requires_grad_(True)
    yg = linear.apply(lin, xg)
    assert torch.equal(yg.detach(), y)
    dy = torch.randn(2, m // 2, n, generator=g, device=cuda).to(torch.bfloat16)
    yg.backward(dy)
    dyd = dy.double().reshape(m, n)
    for got, want, mag, terms in (
            (xg.grad.reshape(m, k), dyd @ wb, dyd.abs() @ wb.abs(), n),
            (lin.w.grad, dyd.T @ xd, dyd.abs().T @ xd.abs(), m)):
        bound = 2 * terms * 2.0 ** -24 * mag + want.abs() * 2.0 ** -8
        assert ((got.double() - want).abs() <= bound).all()
    assert lin.w.grad.dtype == torch.float32


# ------------------------------------------------ the comparison arms

@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "block"])
def test_lora_optq_step_takes_k2_and_computes_dx_only(cuda, monkeypatch,
                                                      remat):
    """A LoRA-on-quantized-backbone train step of a 2-layer llama3.2-1b at
    full width (B 2 × 128 tokens: K2 at M = 256): K2 once a quantized
    linear in the forward (and again in the recompute under remat
    "block"), no GEMV; the quantized backward asked for dx only (no ds, no
    dz: the scales are frozen), and not at all by layer 0's q/k/v; the codes, scales and zeros bit-equal after
    the update, every adapter moved."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TrainConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state
    cfg = configs.get_config("llama3.2-1b").replace(
        n_layers=2, remat=remat, tuning=TuningConfig(mode="lora_optq"),
        quant=QuantConfig(bits=4, n_grid=1))
    api = registry.build(cfg)
    model, mask = policies.prepare(api.init(0), cfg)
    with torch.no_grad():                     # a non-zero adapter
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0, 0.02, generator=torch.Generator(
                    device="cuda").manual_seed(7))
    needs = []
    bwd = ops.quant_matmul_bwd
    monkeypatch.setattr(ops, "quant_matmul_bwd", lambda *a, **k: (
        needs.append(tuple(a[-1]) if len(a) > 6 else k.get("need"))
        or bwd(*a, **k)))
    frozen = {n: t.clone() for n, t in list(model.named_parameters())
              + list(model.named_buffers()) if not mask.get(n)}
    adapters = {n: p.detach().clone() for n, p in model.named_parameters()
                if mask[n]}
    assert adapters and all("lora" in n for n in adapters)
    tcfg = TrainConfig(steps=1, batch_size=2, seq_len=128)
    opt = make_optimizer(tcfg.optim, 1)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt)
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    k2, k1 = qm.quant_matmul.launches, qm.quant_gemv.launches
    state, metrics = ts(state, {"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    n_lin = cfg.n_layers * 7
    assert qm.quant_matmul.launches - k2 == n_lin * (2 if remat == "block"
                                                     else 1)
    assert qm.quant_gemv.launches == k1
    # layer 0's q, k and v read the frozen table's rows: nothing upstream
    # wants a gradient, so their products make no autograd node
    assert len(needs) == n_lin - 3 and all(nd == (True, False, False)
                                           for nd in needs)
    assert torch.isfinite(metrics["loss"])
    for n, t in list(model.named_parameters()) + list(model.named_buffers()):
        if n in frozen:
            assert torch.equal(t, frozen[n]), n
    assert all(not torch.equal(p, adapters[n])
               for n, p in model.named_parameters() if n in adapters)
    assert opt.state_bytes(state["opt"]) == 8 * sum(
        t.numel() for t in adapters.values())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 2048])
def test_lora_delta_on_the_card_within_bound(cuda, m):
    """The adapter's delta at llama3.2-1b's q projection (r 4, bf16 x):
    the first product ``ops.dot_f32`` rounded to bf16 within its float32
    summation bound of float64 plus one bf16 rounding, the second likewise
    from that intermediate; ``linear.apply`` adds exactly that delta after
    the K2/K1 product."""
    from repro_torch.models import linear
    k, n, r = 2048, 2048, 4
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn(r, k, generator=g, device=cuda) * k ** -0.5
    b = torch.randn(n, r, generator=g, device=cuda) * 0.02
    u = 2.0 ** -24
    t = ops.dot_f32(x, a.to(torch.bfloat16)).to(torch.bfloat16)
    xd, ad = x.double(), a.to(torch.bfloat16).double()
    want = xd @ ad.T
    bound = 2 * k * u * (xd.abs() @ ad.abs().T) + want.abs() * 2.0 ** -8
    assert ((t.double() - want).abs() <= bound).all()
    delta = linear.lora_delta(x, a, b)
    td, bd = t.double(), b.to(torch.bfloat16).double()
    want = td @ bd.T
    bound = 2 * r * u * (td.abs() @ bd.abs().T) + want.abs() * 2.0 ** -8
    assert ((delta.double() - want).abs() <= bound).all()
    lin = linear.Linear(k, n, device=cuda)
    lin.reset_parameters(torch.Generator(device="cuda").manual_seed(2))
    spec = QuantSpec(bits=4)
    q, s, z = rtn_quantize(lin.w.detach(), spec, n_grid=1)
    lin.set_quantized(pack_codes(q), s, z, spec)
    with torch.no_grad():
        base = linear.apply(lin, x)
        lin.set_lora(a, b)
        assert torch.equal(linear.apply(lin, x), base + delta)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,group", [(512, 2048, None), (256, 1024, 128)])
def test_gptq_graphed_column_loop_equals_eager(cuda, n, m, group):
    """GPTQ's column loop replayed from its CUDA graph (captured at the
    first matrix of a shape, replayed for the next) gives the eager loop's
    codes, scales and zeros bit for bit."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import gptq
    qcfg = QuantConfig(bits=4, group_size=group, n_grid=8)
    g = torch.Generator(device="cuda").manual_seed(n)
    graphs = {}
    for _ in range(2):
        w = torch.randn(n, m, generator=g, device=cuda) * m ** -0.5
        x = torch.randn(1024, m // 4, generator=g, device=cuda) @ \
            torch.randn(m // 4, m, generator=g, device=cuda)
        eager = gptq.gptq_quantize_matrix(w, x, qcfg)
        graphed = gptq.gptq_quantize_matrix(w, x, qcfg, graphs=graphs)
        assert all(torch.equal(a, b) for a, b in zip(eager, graphed))
    assert len(graphs) == 1


@pytest.mark.gpu
def test_layer_by_layer_build_of_granite_is_bit_equal_at_a_lower_peak(cuda):
    """A 2-layer granite-34b at full width (d_model 6144, d_ff 24576, vocab
    49152; PEQA 4-bit per-channel, n_grid 20, bf16) built by
    ``policies.build`` and by ``api.init`` then ``policies.prepare``: every
    tensor bit-equal, and the layer-by-layer build's peak (above what was
    allocated before it) below the whole build's."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.models import registry
    cfg = configs.get_config("granite-34b").replace(
        n_layers=2, tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))
    api = registry.build(cfg)

    def built(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, _ = fn()
        torch.cuda.synchronize()
        return model, torch.cuda.max_memory_allocated() - base

    streamed, peak_s = built(lambda: policies.build(api, 0))
    whole, peak_w = built(lambda: policies.prepare(api.init(0), cfg))
    ts = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tw = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    assert ts.keys() == tw.keys()
    for name in tw:
        assert torch.equal(ts[name], tw[name]), name
    assert peak_s < peak_w, (peak_s, peak_w)


# ------------------------------------- the moe family: the expert grid axis

# (E, N, K) of deepseek-moe-16b's experts (gate/up over d_model 2048, down
# over d_ff 1408) and mixtral-8x7b's (d_ff 14336 over d_model 4096), each
# with the capacity rows C of a decode step (1), a verify-sized call (32)
# and the prefill of 4 × 256 tokens (deepseek 120, mixtral 320)
EXPERT_CASES = [(64, 1408, 2048, c) for c in (1, 4, 120)] \
    + [(64, 2048, 1408, c) for c in (1, 32, 120)] \
    + [(8, 14336, 4096, c) for c in (1, 320)] \
    + [(8, 4096, 14336, c) for c in (1, 320)]


def _expert_operands(e, c, n, k, group, dtype, device, seed=0):
    """E RTN-quantized N(0, 1/K) weights stacked (E, N, …) and x (E, C, K)
    on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    qws, ss, zs = [], [], []
    for _ in range(e):
        w = torch.randn(n, k, generator=g, device=device) * k ** -0.5
        q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group),
                               n_grid=4)
        qws.append(pack_codes(q))
        ss.append(s)
        zs.append(z)
    x = torch.randn(e, c, k, generator=g, device=device).to(dtype)
    return x, torch.stack(qws), torch.stack(ss), torch.stack(zs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("e,n,k,c", EXPERT_CASES)
def test_moe_expert_axis_bitwise_2d_and_within_bound(cuda, e, n, k, c, dtype):
    """One expert-axis launch (K1 at C ≤ 32, K2 above) over all E experts:
    slice e bit for bit the 2-D kernel's launch on expert e's operands
    (the same tile code and tile shape), and every slice within
    ``error_bound`` of ``quant_matmul_plain`` on that expert (factored on
    the tensor-core route, with ``gemv`` for the GEMV).  Per-channel at
    every shape; groups of 128 at deepseek's gate/up."""
    groups = [None, 128] if (n, k) == (1408, 2048) else [None]
    for group in groups:
        x, qw, s, z = _expert_operands(e, c, n, k, group, dtype, cuda)
        gemv = c <= qm.GEMV_MAX_M
        fn2, fne = ((qm.quant_gemv, qm.quant_gemv_experts) if gemv
                    else (qm.quant_matmul, qm.quant_matmul_experts))
        before = fne.launches
        y = fne(x, qw, s, z)
        assert fne.launches == before + 1 and y.shape == (e, c, n)
        tc = qm.tc_route(x[0], s[0])
        assert tc == (dtype == torch.bfloat16)
        for i in range(e):
            assert torch.equal(y[i], fn2(x[i], qw[i], s[i], z[i])), i
            plain = qm.quant_matmul_plain(x[i], qw[i], s[i], z[i])
            _assert_within_bound(y[i], plain, (x[i], qw[i], s[i], z[i]),
                                 factored=tc, gemv=gemv)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 40])
def test_moe_expert_op_on_the_card(cuda, c, monkeypatch):
    """``ops.quant_matmul_experts`` on CUDA tensors launches the expert-axis
    GEMV (C ≤ 32) or GEMM once and never the plain version; its autograd
    gradients equal the plain route's bit for bit on the same (x, dy)
    (both run ``quant_matmul_experts_bwd``)."""
    spec = QuantSpec(bits=4)
    x, qw, s, z = _expert_operands(6, c, 256, 512, None, torch.bfloat16,
                                   cuda, seed=3)
    dy = (torch.randn(6, c, 256, device=cuda) * 0.1).to(torch.bfloat16)
    fn = qm.quant_gemv_experts if c <= 32 else qm.quant_matmul_experts
    grads = []
    for impl in ("cuda", "torch"):
        xs, ss, zs = (t.clone().requires_grad_(True) for t in (x, s, z))
        with ops.force_impl(impl):
            before = fn.launches
            y = ops.quant_matmul_experts(xs, qw, ss, zs, spec)
            assert fn.launches == before + (impl == "cuda")
        y.backward(dy)
        grads.append([t.grad for t in (xs, ss, zs)])
    for got, want in zip(*grads):
        assert torch.equal(got, want)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")
    monkeypatch.setattr(qm, "quant_matmul_experts_plain", refuse)
    with torch.no_grad():
        ops.quant_matmul_experts(x, qw, s, z, spec)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_moe_tiny_model_on_the_card(cuda, arch):
    """``make_tiny`` of each MoE config in bf16 on the card: ``generate``
    launches one expert-axis GEMM per expert linear for the prefill and one
    expert-axis GEMV per expert linear a decode step (C = 1), and the
    prefill's logits through the kernels lie within 2⁻⁵ of their largest
    magnitude of the plain route's."""
    from repro_torch import configs
    from repro_torch.core import policies
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine
    cfg = configs.make_tiny(configs.get_config(arch)).replace(
        dtype="bfloat16", d_model=256, head_dim=64, d_ff=256)
    api = registry.build(cfg)
    model, _ = policies.build(api, 0)
    prompt = torch.randint(0, cfg.vocab_size, (4, 48),
                           generator=torch.Generator().manual_seed(1))
    for kern in ops.KERNELS:
        kern.launches = 0
    Engine(api, model).generate(prompt, 3)
    n = 3 * cfg.n_layers
    assert qm.quant_matmul_experts.launches == n
    assert qm.quant_gemv_experts.launches == 2 * n
    with torch.inference_mode():
        lk, _ = api.prefill(model, {"tokens": prompt.to(cuda)})
        with ops.force_impl("torch"):
            lp, _ = api.prefill(model, {"tokens": prompt.to(cuda)})
    assert (lk - lp).abs().max() <= 2 ** -5 * lp.abs().max()
