"""The arithmetic of the tensor-core kernels, emulated on the CPU, against the
plain versions, the JAX reference's Pallas kernels (interpret mode) and an
exact float64 product.

K2's tensor-core route (``csrc/quant_matmul.cu``, bf16 x) computes per group
g the factored sum y = Σ_g s·(Σ x·q − z·Σ x): bf16 x and 4-bit codes are
exact, the products too, and only the f32 sums round.
``quant_matmul.quant_matmul_factored_plain`` emulates it (f32 sums, one
k-step of 16 at a time).  Tolerance: ``quant_matmul.error_bound(...,
factored=True)``, (n·2⁻²³ + (K + 2G + 6)·2⁻²⁴)·Σ|x|·|s|·(q + |z|) with n =
K/G, derived in its docstring: the two sums are subtracted, so the bound
grows with Σ|x|·(q + |z|)·|s| and not Σ|x·ŵ|, and the tensor cores'
accumulation is taken at u = 2⁻²³ (it need not round to nearest).  It bounds
any two of the kernel, the emulation and the plain version; the reference's
interpret-mode kernel and the exact product sum the same products as the
plain version within the plain version's share of it.  Cases:
per-channel, group 128 and group 12 (groups that straddle k-steps); nibble
codes and the plane drafts (bits, p) = (4, 3), (4, 2).

K4's bf16 kernel (``csrc/flash_attention.cu``) splits P into bf16 hi + lo
for P·V and, for Sq ≤ 4, the keys across blocks whose partials a second
launch combines.  ``flash_attention.flash_attention_split_plain`` emulates
both.  Tolerance: ``flash_attention.error_bound`` on bf16 operands,
vmax·(4δ + (2⁸ + 8·Sk + 32)·2⁻²⁴) with δ = (3D + 2)·2⁻²⁴·S, derived in its
docstring (2⁸·2⁻²⁴ = 2⁻¹⁶ is the hi + lo split's relative error), plus one
bf16 ulp.  Cases: 1, 2 and 5 splits, causal and a window, a scalar and a
(B,) offset, Sq 1 and 4; compared on the rows that see a key (a row that
sees none is 0 in the port, the mean of V in the reference's kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.quant import QTensor
from repro.kernels import quant_matmul as jqm
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.core import quant as tq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ref
from _torch_threads import _one_torch_thread  # noqa: F401


M, N, K = 40, 48, 384                 # K: 3 groups of 128, 32 of 12
CODES = ["nibble", (4, 3), (4, 2)]


def _k2_operands(group, codes, seed):
    """bf16 x and the reference's quantization of seeded weights: (jax
    args for quant_matmul_pallas with their spec, port args, planes or
    None)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
    layout = "nibble" if codes == "nibble" else "plane"
    bits, p = (4, 4) if codes == "nibble" else codes
    qt = QTensor.quantize(jnp.asarray(w), jq.QuantSpec(
        bits=bits, group_size=group, layout=layout), n_grid=2)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    qw = torch.from_numpy(np.asarray(qt.qw).view(np.int32).copy())
    s = torch.from_numpy(np.array(qt.scale))
    z = torch.from_numpy(np.array(qt.zero))
    js, jz = qt.scale, qt.zero
    planes = None
    if layout == "plane":
        js, jz = jq.draft_scales(qt.scale, qt.zero, bits, p)
        planes = (p, bits - p)
    jx = jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    jspec = jq.QuantSpec(bits=p, group_size=group, layout=layout)
    return (jx, qt.qw, js, jz, jspec), (x, qw, s, z), planes


def _assert_k2_within(got, want, targs, planes):
    bound = qm.error_bound(*targs, got, planes=planes, factored=True)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert (err <= bound).all(), f"max err {err.max():.3e}"


def _k2_plain(targs, planes):
    if planes is None:
        return qm.quant_matmul_plain(*targs)
    return qm.quant_matmul_planes_plain(*targs, *planes)


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", [None, 128, 12])
def test_k2_factored_within_bound_of_plain(group, codes):
    _, targs, planes = _k2_operands(group, codes, seed=1)
    got = qm.quant_matmul_factored_plain(*targs, planes=planes)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _assert_k2_within(got, _k2_plain(targs, planes), targs, planes)


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", [None, 128, 12])
def test_k2_factored_within_bound_of_reference_pallas(group, codes):
    jargs, targs, planes = _k2_operands(group, codes, seed=2)
    jx, jqw, js, jz, jspec = jargs
    want = jqm.quant_matmul_pallas(jx, jqw, js, jz, spec=jspec,
                                   interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = qm.quant_matmul_factored_plain(*targs, planes=planes)
    _assert_k2_within(got, want, targs, planes)


@pytest.mark.parametrize("codes", CODES, ids=str)
@pytest.mark.parametrize("group", [None, 128, 12])
def test_k2_factored_within_bound_of_exact_product(group, codes):
    _, targs, planes = _k2_operands(group, codes, seed=3)
    x, qw, s, z = targs
    if planes is None:
        q = tq.unpack_codes(qw, K).double()
        sd, zd = s.double(), z.double()
    else:
        q = tq.unpack_codes_planes(qw, K, planes[0]).double()
        sd, zd = s.double() * 2 ** planes[1], z.double() / 2 ** planes[1]
    g = s.shape[1]
    w = (sd[:, :, None] * (q.reshape(N, g, K // g) - zd[:, :, None])
         ).reshape(N, K)
    exact = x.double() @ w.T
    got = qm.quant_matmul_factored_plain(*targs, planes=planes)
    _assert_k2_within(got, exact, targs, planes)


def test_k2_factored_plain_steps_each_group_from_its_start():
    """Groups of 12 are not whole k-steps of 16: the emulation restarts its
    sums at every group, so it equals the per-group dot computed alone."""
    _, (x, qw, s, z), _ = _k2_operands(12, "nibble", seed=4)
    got = qm.quant_matmul_factored_plain(x, qw, s, z)
    q = tq.unpack_codes(qw, K).float()
    xf = x.float()
    out = torch.zeros(M, N)
    for gi in range(K // 12):
        sl = slice(12 * gi, 12 * gi + 12)
        out = out + s[:, gi] * (xf[:, sl] @ q[:, sl].T
                                - z[:, gi] * xf[:, sl].sum(1, keepdim=True))
    assert torch.equal(got, out.to(torch.bfloat16))


# ---------------------------------------------------------------- K4

B, SK, HQ, HKV, D = 3, 320, 4, 2, 16
WINDOW = 40


def _k4_inputs(sq, seed):
    """bf16-exact q, k, v (as bf16 torch tensors)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                  ).to(torch.bfloat16)
                 for shape in ((B, sq, HQ, D), (B, SK, HKV, D),
                               (B, SK, HKV, D)))


def _offset(kind, sq):
    if kind == "scalar":
        return SK - sq - 30
    return torch.tensor([20, 150, SK - sq], dtype=torch.int64)


def _seen(sq, causal, window, offset):
    """(B, Sq, 1, 1): rows that see at least one key."""
    mask = ref.visible(B, sq, SK, causal, window, offset, "cpu")
    if mask.dim() == 2:
        mask = mask.expand(B, sq, SK)
    return mask.any(-1)[:, :, None, None]


K4_CASES = [(splits, sq, kind, window)
            for splits in (1, 2, 5) for sq in (1, 4)
            for kind in ("scalar", "rows") for window in (None, WINDOW)]


def _assert_k4_within(got, want, q, k, v, seen):
    bound = fa.error_bound(q, k, v, got)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert ((err <= bound) | ~seen).all(), f"max err {err.max():.3e}"


@pytest.mark.parametrize("splits,sq,kind,window", K4_CASES)
def test_k4_split_emulation_within_bound_of_plain(splits, sq, kind, window):
    q, k, v = _k4_inputs(sq, seed=splits + 10 * sq)
    offset = _offset(kind, sq)
    kw = dict(causal=True, window=window, offset=offset)
    got = fa.flash_attention_split_plain(q, k, v, splits=splits, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_k4_within(got, ref.flash_attention_ref(q, k, v, **kw), q, k, v,
                      _seen(sq, True, window, offset))


@pytest.mark.parametrize("splits,sq,kind,window", K4_CASES)
def test_k4_split_emulation_within_bound_of_reference_pallas(splits, sq, kind,
                                                             window):
    q, k, v = _k4_inputs(sq, seed=splits + 10 * sq + 100)
    offset = _offset(kind, sq)
    got = fa.flash_attention_split_plain(q, k, v, splits=splits, causal=True,
                                         window=window, offset=offset)
    rep = HQ // HKV
    qf, kf, vf = (t.float().numpy().transpose(0, 2, 1, 3) for t in (q, k, v))
    offs = [int(offset)] * B if kind == "scalar" else offset.tolist()
    want = np.concatenate([np.asarray(flash_attention_pallas(
        jnp.asarray(qf[i:i + 1]),
        jnp.repeat(jnp.asarray(kf[i:i + 1]), rep, axis=1),
        jnp.repeat(jnp.asarray(vf[i:i + 1]), rep, axis=1),
        causal=True, window=window, offset=offs[i], block_q=sq, block_k=64,
        interpret=True)) for i in range(B)])
    want = torch.from_numpy(want.transpose(0, 2, 1, 3).copy())
    _assert_k4_within(got, want, q, k, v, _seen(sq, True, window, offset))


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_k4_split_p_product_keeps_sixteen_bits(splits):
    """hi + lo carries each f32 weight to within 2⁻¹⁶ of itself, and the
    combine of any split count of one row's partials is the same softmax."""
    rng = np.random.default_rng(splits)
    p = torch.from_numpy(rng.uniform(0, 1, size=(7, 64)).astype(np.float32))
    eye = torch.eye(64)
    back = fa.split_p_product(p, eye)
    assert ((back - p).abs() <= 2.0 ** -16 * p).all()
    q, k, v = _k4_inputs(1, seed=5)
    one = fa.flash_attention_split_plain(q, k, v, splits=1, offset=SK - 1)
    many = fa.flash_attention_split_plain(q, k, v, splits=splits,
                                          offset=SK - 1)
    _assert_k4_within(many, one, q, k, v, torch.ones(B, 1, 1, 1, dtype=bool))


def _split_bounds(sq, sk):
    """The key range [start, end) of each split of a bf16 K4 call."""
    c = fa.SPLIT_KEYS
    return [(b, min(sk, b + c)) for b in range(0, fa.decode_splits(sq, sk)
                                                * c, c)]


def test_decode_splits_follow_the_cache_length():
    """Decode and verify (Sq ≤ 4) split the keys into SPLIT_KEYS-key splits,
    whole 64-key tiles, as many as Sk needs and no cap; Sq > 4 does not
    split."""
    c = fa.SPLIT_KEYS
    assert c % 64 == 0 and c in (64, 128, 256)
    for sq in (1, 4):
        for sk in (1, 10, c, c + 1, 288, 304, 307, 512, 1100, 4096):
            assert fa.decode_splits(sq, sk) == -(-sk // c)
    assert fa.decode_splits(5, 512) == 1
    assert fa.decode_splits(1, 4096) == 4096 // c


def test_split_boundaries_do_not_depend_on_the_capacity():
    """Below the shorter of two capacities (a greedy pool's 304, a
    speculative pool's 307, and 1100 and 4096) the splits' boundaries are
    the same, so a longer cache only adds splits past the visible keys."""
    caps = (304, 307, 1100, 4096)
    for sq in (1, 4):
        for a in caps:
            for b in caps:
                short = min(a, b)
                assert [e for s, e in _split_bounds(sq, a) if s < short] \
                    [:-1] == [e for s, e in _split_bounds(sq, b)
                              if s < short][:-1]
                assert [s for s, _ in _split_bounds(sq, a) if s < short] == \
                    [s for s, _ in _split_bounds(sq, b) if s < short]


@pytest.mark.parametrize("sq,kind", [(1, "scalar"), (4, "scalar"),
                                     (1, "rows"), (4, "rows")])
def test_split_emulation_equal_across_capacities(sq, kind):
    """The kernel's arithmetic (``flash_attention_split_plain`` with its own
    split) gives the same bits for two caches whose visible keys are the
    same and whose capacities differ (304 and 1100; the rows past the
    visible keys hold other values)."""
    rng = np.random.default_rng(sq)
    b, hq, hkv, d = 2, 8, 2, 64
    q = torch.from_numpy(rng.normal(size=(b, sq, hq, d)).astype(np.float32)
                         ).to(torch.bfloat16)
    long_k, long_v = (torch.from_numpy(rng.normal(size=(b, 1100, hkv, d))
                                       .astype(np.float32)).to(torch.bfloat16)
                      for _ in range(2))
    offset = 290 if kind == "scalar" else torch.tensor([131, 299])
    outs = []
    for cap in (304, 1100):
        k, v = long_k[:, :cap].clone(), long_v[:, :cap].clone()
        k[:, 303:] = 7.0 * (cap == 1100)       # rows no query sees
        v[:, 303:] = -5.0 * (cap == 1100)
        outs.append(fa.flash_attention_split_plain(
            q, k, v, offset=offset, splits=fa.decode_splits(sq, cap),
            chunk=fa.SPLIT_KEYS))
    assert torch.equal(outs[0], outs[1])
    one = fa.flash_attention_split_plain(q, long_k[:, :fa.SPLIT_KEYS],
                                         long_v[:, :fa.SPLIT_KEYS],
                                         offset=fa.SPLIT_KEYS - sq)
    split = fa.flash_attention_split_plain(
        q, long_k, long_v, offset=fa.SPLIT_KEYS - sq,
        splits=fa.decode_splits(sq, 1100), chunk=fa.SPLIT_KEYS)
    assert torch.equal(one, split)
