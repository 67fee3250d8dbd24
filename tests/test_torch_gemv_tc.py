"""The tensor-core GEMV's arithmetic (K1, K5 and their K6a plane forms),
emulated on the CPU, and the decode / verify path's row invariance.

``csrc/quant_gemv.cu``'s tensor-core route (bf16 x, K and the group size
whole 64-code blocks) computes y = Σ s·(Σ x·q − z·Σ x) with the 8 warps of
each of S blocks (``quant_matmul.gemv_block_split``, from N and K) splitting
K into slices of whole 64-code blocks, a group's partial sums flushed at
each group boundary and slice end, the slices' partial y summed in slice
order (``quant_matmul.gemv_segments``).
``quant_matmul.quant_gemv_factored_plain`` emulates it.  Tolerance:
``quant_matmul.error_bound(..., factored=True, gemv=True)``, K2's factored
bound with G replaced by P + W (P the pieces ``gemv_segments`` cuts K
into, W = 8·S the slices):
(n·2⁻²³ + (K + 2·(P + W) + 6)·2⁻²⁴)·Σ|x|·|s|·(q + |z|), derived in its
docstring.  It bounds any two of the kernel, the emulation and the
plain version; the reference's interpret-mode ``quant_gemv_pallas`` and the
exact product sum the same products as the plain version.

Bitwise, inside the port: the emulation's rows at M ∈ {1, 2, 4, 8, 16, 32}
equal the same rows at M = 32; its K5 rows equal K1's under each row's
task; its plane forms equal the nibble form on q >> (4 − p) under
``draft_scales``.  The schedule (``gemv_segments``) tiles K in whole
groups, and its block split has no M to depend on.  Cases: per-channel,
groups of 128 and of 64 (a 64-code block each); K = 384, so some of the
8 warps get no block.

``models.row_trace`` on a tiny float32 model on the CPU: the per-op
comparison runs, and the ops the port made row-invariant (the RMSNorm, the
dense decode attention) are so here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.quant import QTensor
from repro.kernels import quant_matmul as jqm
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core import quant as tq
from repro_torch.core.scale_bank import ResidentStack, ScaleBank
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import registry, row_trace
from _torch_threads import _one_torch_thread  # noqa: F401


M, N, K = 32, 48, 384                  # K: 6 blocks of 64 over 8 warps
K_SPLIT = 8192                         # 128 blocks: K split over 2 blocks
GROUPS = [None, 128, 64]
CODES = ["nibble", (4, 3), (4, 2)]
T = 3


def _operands(group, codes, seed, k=K):
    """bf16 x (M, k), the reference's quantization of seeded weights, task
    stacks (T, N, G) and ids (M,): (jax args, port args, planes or None,
    (scale stack, zero stack, ids) for the port, the same for jax)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, k)) * 0.05).astype(np.float32)
    layout = "nibble" if codes == "nibble" else "plane"
    bits, p = (4, 4) if codes == "nibble" else codes
    qt = QTensor.quantize(jnp.asarray(w), jq.QuantSpec(
        bits=bits, group_size=group, layout=layout), n_grid=2)
    x = torch.from_numpy(rng.normal(size=(M, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    qw = torch.from_numpy(np.asarray(qt.qw).view(np.int32).copy())
    s = torch.from_numpy(np.array(qt.scale))
    z = torch.from_numpy(np.array(qt.zero))
    f = rng.uniform(0.8, 1.2, size=(T,) + tuple(s.shape)).astype(np.float32)
    f[0] = 1.0
    ss = s[None] * torch.from_numpy(f)
    zs = torch.stack([z, z + 0.25, z - 0.5])
    ids = torch.tensor([i % T for i in range(M)], dtype=torch.int32)
    planes = None
    jss, jzs = jnp.asarray(ss.numpy()), jnp.asarray(zs.numpy())
    if layout == "plane":
        jss, jzs = jq.draft_scales(jss, jzs, bits, p)
        planes = (p, bits - p)
    jx = jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    jspec = jq.QuantSpec(bits=p, group_size=group, layout=layout)
    return ((jx, qt.qw, jss, jzs, jspec, jnp.asarray(ids.numpy())),
            (x, qw, s, z), planes, (ss, zs, ids))


def _plain(targs, planes):
    if planes is None:
        return qm.quant_matmul_plain(*targs)
    return qm.quant_matmul_planes_plain(*targs, *planes)


def _assert_within(got, want, targs, planes, tasks=None):
    x, qw, s, z = targs
    if tasks is not None:
        s, z, ids = tasks
        bound = qm.error_bound(x, qw, s, z, got, task_ids=ids, planes=planes,
                               factored=True, gemv=True)
    else:
        bound = qm.error_bound(x, qw, s, z, got, planes=planes,
                               factored=True, gemv=True)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= bound).all(), f"max err {err.max():.3e}"


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_within_bound_of_plain(group, codes):
    _, targs, planes, _ = _operands(group, codes, seed=1)
    got = qm.quant_gemv_factored_plain(*targs, planes=planes)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _assert_within(got, _plain(targs, planes), targs, planes)


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_within_bound_of_reference_pallas(group, codes):
    jargs, targs, planes, _ = _operands(group, codes, seed=2)
    jx, jqw, jss, jzs, jspec, _ = jargs
    want = jqm.quant_gemv_pallas(jx, jqw, jss[0], jzs[0], spec=jspec,
                                 interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = qm.quant_gemv_factored_plain(*targs, planes=planes)
    _assert_within(got, want, targs, planes)


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", GROUPS)
def test_gemv_tasks_factored_within_bound_of_reference_pallas(group, codes):
    jargs, targs, planes, tasks = _operands(group, codes, seed=3)
    jx, jqw, jss, jzs, jspec, jids = jargs
    want = jqm.quant_gemv_pallas(jx, jqw, jss, jzs, task_ids=jids,
                                 spec=jspec, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    x, qw, _, _ = targs
    ss, zs, ids = tasks
    got = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids,
                                       planes=planes)
    _assert_within(got, want, targs, planes, tasks)


@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_within_bound_of_exact_product(group):
    _, targs, _, _ = _operands(group, "nibble", seed=4)
    x, qw, s, z = targs
    q = tq.unpack_codes(qw, K).double()
    g = s.shape[1]
    w = (s.double()[:, :, None] * (q.reshape(N, g, K // g)
                                   - z.double()[:, :, None])).reshape(N, K)
    exact = x.double() @ w.T
    got = qm.quant_gemv_factored_plain(*targs)
    _assert_within(got, exact, targs, None)


@pytest.mark.parametrize("tasked", [False, True], ids=["k1", "k5"])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32])
def test_gemv_factored_rows_do_not_depend_on_m(m, tasked):
    _, targs, _, tasks = _operands(128, "nibble", seed=5)
    x, qw, s, z = targs
    if tasked:
        ss, zs, ids = tasks
        full = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids)
        part = qm.quant_gemv_factored_plain(x[:m], qw, ss, zs,
                                            task_ids=ids[:m])
    else:
        full = qm.quant_gemv_factored_plain(x, qw, s, z)
        part = qm.quant_gemv_factored_plain(x[:m], qw, s, z)
    assert torch.equal(part, full[:m])


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_split_over_blocks(group, codes):
    """K split over 2 blocks (16 slices of 8 blocks): within the bound of
    plain, K5 within it under each row's task, rows the same at M = 1, 8
    and 32."""
    _, targs, planes, tasks = _operands(group, codes, seed=8, k=K_SPLIT)
    assert qm.gemv_block_split(N, K_SPLIT) == 2
    x, qw, _, _ = targs
    got = qm.quant_gemv_factored_plain(*targs, planes=planes)
    _assert_within(got, _plain(targs, planes), targs, planes)
    ss, zs, ids = tasks
    got5 = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids,
                                        planes=planes)
    plain5 = (qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
              if planes is None else qm.quant_matmul_tasks_planes_plain(
                  x, qw, ss, zs, ids, *planes))
    _assert_within(got5, plain5, targs, planes, tasks)
    for m in (1, 8):
        assert torch.equal(qm.quant_gemv_factored_plain(
            x[:m], *targs[1:], planes=planes), got[:m])


@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_task_rows_equal_k1_rows(group):
    _, targs, _, tasks = _operands(group, "nibble", seed=6)
    x, qw, _, _ = targs
    ss, zs, ids = tasks
    got = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids)
    for t in range(T):
        k1 = qm.quant_gemv_factored_plain(x, qw, ss[t], zs[t])
        assert torch.equal(got[ids == t], k1[ids == t])


@pytest.mark.parametrize("p", [4, 3, 2])
@pytest.mark.parametrize("group", GROUPS)
def test_gemv_factored_planes_equal_nibble(group, p):
    _, targs, _, tasks = _operands(group, "nibble", seed=7)
    x, qw, s, z = targs
    codes = tq.unpack_codes(qw, K)
    planes = tq.pack_codes_planes(codes, 4)
    nib = tq.pack_codes(codes >> (4 - p))
    sd, zd = tq.draft_scales(s, z, 4, p)
    got = qm.quant_gemv_factored_plain(x, planes, s, z, planes=(p, 4 - p))
    assert torch.equal(got, qm.quant_gemv_factored_plain(x, nib, sd, zd))
    ss, zs, ids = tasks
    ssd, zsd = tq.draft_scales(ss, zs, 4, p)
    got = qm.quant_gemv_factored_plain(x, planes, ss, zs, task_ids=ids,
                                       planes=(p, 4 - p))
    assert torch.equal(got, qm.quant_gemv_factored_plain(
        x, nib, ssd, zsd, task_ids=ids))


@pytest.mark.parametrize("n,k,g", [(48, 384, 1), (48, 384, 6),
                                   (2048, 2048, 1), (512, 2048, 16),
                                   (2048, 8192, 64), (48, 64, 1),
                                   (512, 2048, 1), (8192, 2048, 1)])
def test_gemv_segments_tile_k_in_groups(n, k, g):
    segs = qm.gemv_segments(n, k, g)
    assert [(a, b) for _, a, b, _ in segs] == sorted(
        (a, b) for _, a, b, _ in segs)
    assert segs[0][1] == 0 and segs[-1][2] == k
    for (_, _, b, _), (_, a, _, _) in zip(segs, segs[1:]):
        assert a == b
    gs = k // g
    for w, a, b, gi in segs:
        assert a % qm.TC_TILE_K == 0 and b % qm.TC_TILE_K == 0
        assert a // gs == gi and (b - 1) // gs == gi
    slices = [w for w, *_ in segs]
    assert slices == sorted(slices)
    assert max(slices) < qm.GEMV_KSPLIT * qm.gemv_block_split(n, k)


# the llama3.2-1b linears: q/o (2048, 2048), k/v (512, 2048), gate/up
# (8192, 2048), down (2048, 8192); then other shapes
@pytest.mark.parametrize("n,k,split", [(2048, 2048, 1), (512, 2048, 1),
                                       (8192, 2048, 1), (2048, 8192, 2),
                                       (48, 384, 1), (512, 8192, 2),
                                       (48, 32768, 4), (8192, 8192, 1)])
def test_gemv_block_split(n, k, split):
    assert qm.gemv_block_split(n, k) == split
    # every warp of every block keeps at least 8 64-code blocks
    assert (k // qm.TC_TILE_K >= qm.GEMV_KSPLIT * qm.GEMV_MIN_WARP_BLOCKS
            * split or split == 1)


@pytest.fixture(scope="module")
def tiny():
    cfg = tconfigs.paper_lm(n_layers=2, d_model=64, n_heads=2, d_ff=96,
                            vocab=128).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, n_grid=2, layout="plane"))
    api = registry.build(cfg, device="cpu")
    model, _ = policies.prepare(api.init(0), cfg, device="cpu")
    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(0)
    bank.tasks["t1"] = {k: (v * rng.uniform(0.9, 1.1, v.shape)
                            ).astype(v.dtype)
                        for k, v in bank.tasks["t0"].items()}
    stack = ResidentStack(bank, model, 2, warm=["t0", "t1"],
                          device="cpu").stack
    cache = api.init_cache(4, 32)
    for k in cache:
        cache[k].normal_(generator=torch.Generator().manual_seed(0))
    return cfg, model, stack, cache


@pytest.mark.parametrize("tasked", [False, True], ids=["untasked", "tasks"])
def test_row_trace_isolated_ops_on_cpu(tiny, tasked):
    cfg, model, stack, cache = tiny
    pos = torch.tensor([3, 5, 7, 9])
    ids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    got = row_trace.isolated_ops(model, cfg, cache, pos, 4,
                                 stack if tasked else None,
                                 ids if tasked else None)
    assert set(got) >= {"linear.wq", "linear.down", "norm", "head", "rope",
                        "attention.dense", "attention.chunked", "argmax"}
    for op in ("norm", "rope", "attention.dense", "argmax"):
        assert got[op]["equal"], op


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_row_trace_compare_verify_on_cpu(tiny, impl):
    cfg, model, stack, cache = tiny
    api = registry.build(cfg.replace(attn_impl=impl), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 3),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([3, 5, 7, 9])
    ids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    rep = row_trace.compare_verify(api, model, cache, toks, pos, stack, ids)
    names = [r["op"] for r in rep["ops"]]
    assert names[0] == "embed#1" and names[-1] == "argmax#1"
    assert names[-2] == "head#1"
    assert sum(n.startswith("attention#") for n in names) == cfg.n_layers
    # the ops before the first attention see equal inputs on the CPU too
    first = names.index("attention#1")
    assert all(r["equal"] for r in rep["ops"][:first])
    if impl == "dense":
        assert rep["ops"][first]["equal"]
