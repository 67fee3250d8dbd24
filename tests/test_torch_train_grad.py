"""PyTorch port vs JAX reference: the training gradients.

  * ``ops.quant_matmul``'s backward (dx, ds and, with trainable zeros, dz)
    against ``jax.vjp`` of the reference's ``ops.quant_matmul`` (impl
    ``xla``: its custom VJP ``_qmm_bwd``), for nibble and bit-plane codes,
    per-channel and groups of 32 and 64, float32 and bfloat16 x.  The codes
    get no gradient; with grad disabled, or nothing requiring it, no
    autograd node is made (the serving path).
  * ``ops.attention(impl="chunked")``'s backward against ``jax.vjp`` of
    the reference's ``chunked_attention`` (offset None, GQA, a window, key
    blocks of the default and of 8), and the plain logsumexp against the
    reference's ``_fwd``.

Tolerances.  ds and dz: ``ops.qmm_grad_bound`` (both packages sum the same
float32 products of c = dyᵀx and of the group sums in different orders).
dx: both multiply the same Ŵ (dequantized in x's dtype by the same
float32 arithmetic) by dy and sum N products in float32, so each is within
N·2⁻²⁴·Σ|dy·Ŵ| of the exact sum; the bound is twice that, plus one ulp of
x's dtype for the final rounding (bf16: 2⁻⁸ relative).  Attention (Sk ≤ 32
keys, D = 16): every gradient is a float32 sum of at most ~100 terms of
magnitude ≤ 1 taken in other orders, so float32 agrees to rtol 1e-4 /
atol 1e-5; a bf16 gradient adds one bf16 rounding (rtol 2⁻⁷).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QTensor
from repro.core.quant import QuantSpec as JSpec
from repro.core.quant import unpack_codes_planes as j_unpack_codes_planes
from repro.kernels import chunked_attention as jca
from repro.kernels import ops as jops
from repro_torch.core.quant import QuantSpec, unpack_codes, unpack_codes_planes
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from _torch_threads import _one_torch_thread  # noqa: F401


M, N, K = 48, 40, 128
U = 2.0 ** -24
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qmm_case(group, layout, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
    jspec = JSpec(bits=4, group_size=group, layout=layout)
    qt = QTensor.quantize(jnp.asarray(w), jspec, n_grid=2)
    x = rng.normal(size=(2, M // 2, K)).astype(np.float32)
    dy = rng.normal(size=(2, M // 2, N)).astype(np.float32)
    qw, s, z = (np.array(a) for a in (qt.qw, qt.scale, qt.zero))
    tspec = QuantSpec(bits=4, group_size=group, layout=layout)
    return jspec, tspec, (x, qw, s, z, dy)


def _graph_nodes(t: torch.Tensor) -> set:
    """Names of the autograd nodes behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in seen:
            seen.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    return seen


def _ulp(t: torch.Tensor) -> torch.Tensor:
    mant = {torch.float32: 23, torch.bfloat16: 7}[t.dtype]
    mag = t.to(torch.float32).abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["nibble", "plane"])
@pytest.mark.parametrize("group", [None, 32, 64])
def test_quant_matmul_backward_matches_reference(group, layout, dtype):
    jspec, tspec, (x, qw, s, z, dy) = _qmm_case(group, layout, dtype,
                                                seed=(group or 0) + len(layout))
    jx, jdy = jnp.asarray(x, JDT[dtype]), jnp.asarray(dy, JDT[dtype])
    y_ref, vjp = jax.vjp(
        lambda a, sc, zr: jops.quant_matmul(a, jnp.asarray(qw), sc, zr, jspec,
                                            impl="xla"),
        jx, jnp.asarray(s), jnp.asarray(z))
    dx_ref, ds_ref, dz_ref = (torch.from_numpy(np.array(a, np.float32))
                              for a in vjp(jdy))

    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
    ts = torch.from_numpy(s.copy()).requires_grad_(True)
    tz = torch.from_numpy(z.copy()).requires_grad_(True)
    tqw = torch.from_numpy(qw.view(np.int32).copy())
    y = ops.quant_matmul(tx, tqw, ts, tz, tspec)
    assert y.grad_fn is not None and y.dtype == TDT[dtype]
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_ref, np.float32),
                               rtol=1e-2 if dtype == "bf16" else 1e-5,
                               atol=1e-2 if dtype == "bf16" else 1e-5)
    tdy = torch.from_numpy(dy).to(TDT[dtype])
    y.backward(tdy)
    assert tqw.grad is None and not tqw.requires_grad

    x2d, dy2d = tx.detach().reshape(-1, K), tdy.reshape(-1, N)
    bds, bdz = ops.qmm_grad_bound(x2d, tqw, ts.detach(), tz.detach(), tspec,
                                  dy2d)
    assert ((ts.grad - ds_ref).abs() <= bds).all(), \
        f"ds max err {(ts.grad - ds_ref).abs().max():.3e}"
    assert ((tz.grad - dz_ref).abs() <= bdz).all(), \
        f"dz max err {(tz.grad - dz_ref).abs().max():.3e}"
    w = ref.dequant_ref(tqw, ts.detach(), tz.detach(), (N, K), tspec,
                        torch.float32)
    mag = (dy2d.float().abs() @ w.abs()).reshape(tx.shape)
    bound = 2 * N * U * mag + _ulp(dx_ref.to(TDT[dtype]))
    err = (tx.grad.float() - dx_ref).abs()
    assert (err <= bound).all(), f"dx max err {err.max():.3e}"


def test_quant_matmul_backward_is_the_analytic_formula():
    """ds and dz equal the paper's Eq. (2) written out in float64."""
    _, tspec, (x, qw, s, z, dy) = _qmm_case(32, "nibble", "f32", seed=7)
    ts = torch.from_numpy(s.copy()).requires_grad_(True)
    tz = torch.from_numpy(z.copy()).requires_grad_(True)
    tqw = torch.from_numpy(qw.view(np.int32).copy())
    ops.quant_matmul(torch.from_numpy(x), tqw, ts, tz, tspec).backward(
        torch.from_numpy(dy))
    c = (torch.from_numpy(dy).double().reshape(-1, N).T
         @ torch.from_numpy(x).double().reshape(-1, K)).reshape(N, -1, 32)
    q = unpack_codes(tqw, K).double().reshape(N, -1, 32)
    zd = torch.from_numpy(z).double()[..., None]
    np.testing.assert_allclose(ts.grad.numpy(), (c * (q - zd)).sum(-1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), -torch.from_numpy(s).double()
                               * c.sum(-1), rtol=1e-5, atol=1e-6)


def test_no_autograd_node_on_the_serving_path():
    _, tspec, (x, qw, s, z, _) = _qmm_case(None, "plane", "f32", seed=3)
    tx = torch.from_numpy(x)
    ts = torch.from_numpy(s.copy()).requires_grad_(True)
    tz = torch.from_numpy(z.copy())
    tqw = torch.from_numpy(qw.view(np.int32).copy())
    with torch.no_grad():
        assert ops.quant_matmul(tx, tqw, ts, tz, tspec).grad_fn is None
    with torch.inference_mode():
        assert ops.quant_matmul(tx, tqw, ts, tz, tspec).grad_fn is None
    # grad mode on, nothing requires grad: the direct forward
    assert ops.quant_matmul(tx, tqw, ts.detach(), tz, tspec).grad_fn is None
    y = ops.quant_matmul(tx, tqw, ts, tz, tspec)
    assert "_QuantMatmulBackward" in _graph_nodes(y)
    # the speculative draft is forward only, as in the reference
    with pytest.raises(ValueError, match="forward only"):
        ops.quant_matmul(tx, tqw, ts, tz, tspec, draft_bits=3)
    with torch.no_grad():
        ops.quant_matmul(tx, tqw, ts, tz, tspec, draft_bits=3)
    # the backward reads the codes as the reference's unpack does
    np.testing.assert_array_equal(
        unpack_codes_planes(tqw, K, 4).numpy(),
        np.asarray(j_unpack_codes_planes(jnp.asarray(qw), K, 4)))


def _attn_inputs(b, sq, sk, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    do = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


ATTN_CASES = [  # (b, sq, sk, hq, hkv, d, window)
    (2, 24, 24, 4, 2, 16, None),      # GQA, offset None (Sk − Sq = 0)
    (1, 16, 32, 4, 4, 16, None),      # Sk > Sq: ends aligned
    (2, 24, 24, 4, 1, 16, 8),         # one KV head, a window
]


@pytest.mark.parametrize("block", [None, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_backward_matches_reference(case, dtype, block):
    b, sq, sk, hq, hkv, d, window = case
    q, k, v, do = _attn_inputs(b, sq, sk, hq, hkv, d, dtype, seed=sq + hkv)
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v, do))
    blk = block or jca.DEFAULT_BLOCK
    o_ref, vjp = jax.vjp(lambda a, bb, c: jca.chunked_attention(
        a, bb, c, True, window, None, None, blk), jq, jk, jv)
    grads_ref = [np.asarray(g, np.float32) for g in vjp(jdo)]

    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True)
                  for a in (q, k, v))
    tdo = torch.from_numpy(do).to(TDT[dtype])
    if block is None:
        o = ops.attention(tq, tk, tv, causal=True, window=window,
                          impl="chunked")
        assert "_ChunkedAttentionBackward" in _graph_nodes(o)
        o.backward(tdo)
        got = [t.grad for t in (tq, tk, tv)]
    else:
        o, lse = ops._chunked_forward(tq.detach(), tk.detach(), tv.detach(),
                                      True, window, None, None, True)
        got = ops.chunked_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                        o, lse, tdo, window=window,
                                        block=block)
    rtol, atol = (2 ** -7, 1e-3) if dtype == "bf16" else (1e-4, 1e-5)
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(o_ref, np.float32),
                               rtol=rtol, atol=atol)
    for name, g, want in zip("qkv", got, grads_ref):
        assert g.dtype == TDT[dtype], name
        np.testing.assert_allclose(g.float().numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_logsumexp_matches_reference_fwd(case):
    b, sq, sk, hq, hkv, d, window = case
    q, k, v, _ = _attn_inputs(b, sq, sk, hq, hkv, d, "f32", seed=1)
    out_ref, lse_ref = jca._fwd(*(jnp.asarray(a) for a in (q, k, v)), True,
                                window, d ** -0.5, sk - sq, jca.DEFAULT_BLOCK)
    o, lse = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                window=window, return_lse=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_ref).reshape(b, hq, sq),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_ref),
                               rtol=1e-4, atol=1e-5)
    o_only = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                window=window)
    assert torch.equal(o, o_only)


def test_row_with_no_key_gets_minus_inf_and_zero_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _attn_inputs(1, 4, 4, 2, 1, 16, "f32", seed=5))
    # offset −2: queries 0 and 1 sit before every key
    o, lse = ops._chunked_forward(q, k, v, True, None, None, -2, True)
    assert torch.isneginf(lse[:, :, :2]).all() and torch.isfinite(
        lse[:, :, 2:]).all()
    dq, dk, dv = ops.chunked_attention_bwd(q, k, v, o, lse, do, offset=-2)
    assert (dq[:, :2] == 0).all()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tied_head_backward_matches_reference(dtype):
    """``ops.dot_f32`` (logits, dx, demb) against ``jax.vjp`` of the
    reference's tied head, the einsum with a float32 output.  Each value is
    a float32 sum of the same exact products taken in other orders (over D
    for the logits, V for dx, M for demb), so it is within 2·n·2⁻²⁴·Σ|·| of
    the reference's, plus one ulp of the operand dtype for dx's and demb's
    last rounding.  No autograd node is made without grad."""
    rng = np.random.default_rng(11)
    m, d, v = 24, 32, 96
    x = rng.normal(size=(2, m // 2, d)).astype(np.float32)
    emb = (rng.normal(size=(v, d)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(2, m // 2, v)).astype(np.float32)
    jx, je = jnp.asarray(x, JDT[dtype]), jnp.asarray(emb, JDT[dtype])
    y_ref, vjp = jax.vjp(lambda a, e: jnp.einsum(
        "...d,vd->...v", a, e, preferred_element_type=jnp.float32), jx, je)
    dx_ref, de_ref = (torch.from_numpy(np.array(a, np.float32))
                      for a in vjp(jnp.asarray(dy)))

    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
    te = torch.from_numpy(emb).to(TDT[dtype]).requires_grad_(True)
    y = ops.dot_f32(tx, te)
    assert y.dtype == torch.float32 and "_DotF32Backward" in _graph_nodes(y)
    y.backward(torch.from_numpy(dy))
    xf, ef = tx.detach().float(), te.detach().float()
    dyf = torch.from_numpy(dy)
    for name, got, want, mag, n in (
            ("logits", y.detach(), torch.from_numpy(np.array(y_ref)),
             xf.abs() @ ef.abs().T, d),
            ("dx", tx.grad.float(), dx_ref, dyf.abs() @ ef.abs(), v),
            ("demb", te.grad.float(), de_ref,
             dyf.reshape(-1, v).abs().T @ xf.reshape(-1, d).abs(), m)):
        bound = 2 * n * U * mag
        if name != "logits":
            bound = bound + _ulp(want.to(TDT[dtype]))
        err = (got - want).abs()
        assert (err <= bound).all(), f"{name} max err {err.max():.3e}"
    with torch.no_grad():
        assert ops.dot_f32(tx, te).grad_fn is None
