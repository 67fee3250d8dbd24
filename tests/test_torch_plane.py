"""PyTorch port vs JAX reference: bit-plane codes and the plane branch of the
quantized matmul (K6a), on the CPU.

  * Layout: ``pack_codes_planes`` bit-equal to the reference's (int32 views
    of its uint32 words) for bits 2, 3, 4; bijective; the top p planes
    decode to ``q >> (b − p)``; ``draft_scales`` as the reference's.
  * Ops: the port's plane ops (their plain versions on CPU tensors) against
    the reference's Pallas kernels in interpret mode, ``quant_gemv_pallas``
    (K1, and K5 over 4 tasks) and ``quant_matmul_pallas`` (K2), with the
    reference's spec view ``bits = p`` on a bits'-plane buffer.  The draft
    (p < bits') hands the reference ``draft_scales`` and the port the
    draft width p.  Tolerance rtol 1e-5, atol 1e-4 (tests/test_gemv.py):
    float32 sums in different orders; the reference's interpret kernels are
    not even bit-equal to their own blocked replays on this jax.
  * Inside the port: plane rows bit-equal to the nibble path on the codes
    ``q >> (b − p)`` under ``draft_scales`` — the contract K6a keeps on the
    card.
  * PEQA with ``layout="plane"``: codes bit-equal to the reference's,
    scales rtol 1e-6 (the shrink grid's last-ulp difference), sizes equal;
    the bridge round trip and ``dequantize_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import peqa as jpeqa
from repro.core import quant as jq
from repro.kernels import quant_matmul as jqm
from repro_torch import bridge
from repro_torch.core import peqa
from repro_torch.core import quant as tq
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from test_torch_model import _assert_trees_match
from _torch_threads import _one_torch_thread  # noqa: F401


BN, BK = 64, 128          # multi-block reference grids at these shapes
N, K, T = 96, 256, 4
RTOL, ATOL = 1e-5, 1e-4


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("bits", [2, 3, 4])
def test_plane_pack_bitexact_and_bijective(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 2 ** bits, (5, 7, 96)).astype(np.uint8)
    want = np.asarray(jq.pack_codes_planes(jnp.asarray(q), bits))
    got = tq.pack_codes_planes(_t(q), bits)
    assert got.dtype == torch.int32 and got.shape == (bits, 5, 7, 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tq.unpack_codes_planes(got).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_codes_planes(got, 40).numpy(),
        np.asarray(jq.unpack_codes_planes(jnp.asarray(want), 40)))


@pytest.mark.parametrize("bits,draft", [(3, 2), (4, 2), (4, 3), (4, 1)])
def test_plane_prefix_is_truncation(bits, draft):
    rng = np.random.default_rng(10 * bits + draft)
    q = rng.integers(0, 2 ** bits, (6, 64)).astype(np.uint8)
    p = tq.pack_codes_planes(_t(q), bits)
    np.testing.assert_array_equal(tq.unpack_codes_planes(p[:draft]).numpy(),
                                  q >> (bits - draft))
    np.testing.assert_array_equal(
        tq.unpack_codes_planes(p, bits=draft).numpy(), q >> (bits - draft))


def test_draft_scales_decode_identity():
    """s·(q − z) == s_d·(q_p − z_d) on codes whose dropped planes are zero,
    within s·2^(b−p) otherwise; the values equal the reference's."""
    bits, draft = 4, 2
    rng = np.random.default_rng(3)
    q = rng.integers(0, 16, (8, 32)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (8, 1)).astype(np.float32)
    z = rng.uniform(0.0, 15.0, (8, 1)).astype(np.float32)
    sd, zd = (a.numpy() for a in tq.draft_scales(_t(s), _t(z), bits, draft))
    jsd, jzd = jq.draft_scales(jnp.asarray(s), jnp.asarray(z), bits, draft)
    np.testing.assert_array_equal(sd, np.asarray(jsd))
    np.testing.assert_array_equal(zd, np.asarray(jzd))
    qp = np.floor(q / 4.0)
    approx = sd * (qp - zd)
    np.testing.assert_allclose(approx, s * (qp * 4.0 - z), rtol=1e-6)
    assert np.all(np.abs(s * (q - z) - approx) < s * 4.0)


def test_plane_spec_validation_like_reference():
    for kw, k in ((dict(layout="plane"), 48), (dict(layout="planar"), 64),
                  (dict(bits=9, layout="plane"), 64)):
        with pytest.raises(ValueError) as jerr:
            jq.QuantSpec(**kw).validate(k)
        with pytest.raises(ValueError) as terr:
            tq.QuantSpec(**kw).validate(k)
        assert str(terr.value) == str(jerr.value)
    spec = tq.QuantSpec(bits=3, layout="plane")
    assert spec.plane and not spec.packs
    spec.check_ported()


# ---------------------------------------------------------------- ops

def _operands(m, group, bits, seed, n_tasks=None):
    """Seeded inputs quantized by the reference into ``bits`` planes:
    (x, reference QTensor, port planes, scales, zeros[, task stacks, ids])."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
    qt = jq.QTensor.quantize(jnp.asarray(w),
                             jq.QuantSpec(bits=bits, group_size=group,
                                          layout="plane"), n_grid=2)
    x = rng.normal(size=(m, K)).astype(np.float32)
    out = [x, qt, _words(qt.qw), np.asarray(qt.scale), np.asarray(qt.zero)]
    if n_tasks:
        s, z = out[3], out[4]
        ss = np.stack([s * rng.uniform(0.8, 1.2, s.shape)
                       for _ in range(n_tasks)]).astype(np.float32)
        zs = np.stack([z + rng.uniform(-0.5, 0.5, z.shape)
                       for _ in range(n_tasks)]).astype(np.float32)
        ids = rng.permutation(np.arange(m) % n_tasks).astype(np.int32)
        out += [ss, zs, ids]
    return out


PLANES = [(4, 4), (4, 3), (4, 1), (3, 2)]


@pytest.mark.parametrize("bits,p", PLANES)
@pytest.mark.parametrize("group", [32, 64, None])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_plane_gemv_matches_reference_interpret(m, group, bits, p):
    x, qt, planes, s, z = _operands(m, group, bits, seed=m + bits * 10 + p)
    js, jz = jq.draft_scales(qt.scale, qt.zero, bits, p)
    want = jqm.quant_gemv_pallas(
        jnp.asarray(x), qt.qw, js, jz,
        spec=jq.QuantSpec(bits=p, group_size=group, layout="plane"),
        block_n=BN, block_k=BK, interpret=True)
    got = ops.quant_matmul(_t(x), planes, _t(s), _t(z),
                           tq.QuantSpec(bits=bits, group_size=group,
                                        layout="plane"), draft_bits=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bits,p", PLANES)
@pytest.mark.parametrize("group", [32, 64, None])
def test_plane_gemv_tasks_matches_reference_interpret(group, bits, p):
    x, qt, planes, _, _, ss, zs, ids = _operands(8, group, bits, seed=p,
                                                 n_tasks=T)
    assert len(set(ids.tolist())) >= 3
    jss, jzs = jq.draft_scales(jnp.asarray(ss), jnp.asarray(zs), bits, p)
    want = jqm.quant_gemv_pallas(
        jnp.asarray(x), qt.qw, jss, jzs, task_ids=jnp.asarray(ids),
        spec=jq.QuantSpec(bits=p, group_size=group, layout="plane"),
        block_n=BN, block_k=BK, interpret=True)
    got = ops.quant_matmul_slotted(
        _t(x), planes, _t(ss), _t(zs), _t(ids),
        tq.QuantSpec(bits=bits, group_size=group, layout="plane"),
        draft_bits=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bits,p", PLANES)
@pytest.mark.parametrize("group", [32, 64, None])
def test_plane_gemm_matches_reference_interpret(group, bits, p):
    x, qt, planes, s, z = _operands(40, group, bits, seed=40 + p)
    js, jz = jq.draft_scales(qt.scale, qt.zero, bits, p)
    want = jqm.quant_matmul_pallas(
        jnp.asarray(x), qt.qw, js, jz,
        spec=jq.QuantSpec(bits=p, group_size=group, layout="plane"),
        block_m=32, block_n=BN, block_k=BK, interpret=True)
    got = ops.quant_matmul(_t(x), planes, _t(s), _t(z),
                           tq.QuantSpec(bits=bits, group_size=group,
                                        layout="plane"), draft_bits=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bits,p", PLANES + [(2, 1)])
@pytest.mark.parametrize("m", [3, 40])
def test_plane_rows_bitwise_nibble_path(m, bits, p):
    """The plain plane path IS the nibble path on ``q >> (b − p)`` under
    ``draft_scales``, bit for bit — single-task and per-task."""
    rng = np.random.default_rng(m + p)
    w = _t((rng.normal(size=(N, K)) * 0.05).astype(np.float32))
    q, s, z = tq.rtn_quantize(w, tq.QuantSpec(bits=bits, group_size=64),
                              n_grid=2)
    x = _t(rng.normal(size=(m, K)).astype(np.float32))
    planes, shift = tq.pack_codes_planes(q, bits), bits - p
    nib = tq.pack_codes(q >> shift)
    sd, zd = tq.draft_scales(s, z, bits, p)
    assert torch.equal(qm.quant_matmul_planes_plain(x, planes, s, z, p, shift),
                       qm.quant_matmul_plain(x, nib, sd, zd))
    ss, zs = torch.stack([s, s * 1.1, s * 0.9]), torch.stack([z, z + 0.3, z])
    ids = torch.tensor([i % 3 for i in range(m)], dtype=torch.int32)
    ssd, zsd = tq.draft_scales(ss, zs, bits, p)
    assert torch.equal(
        qm.quant_matmul_tasks_planes_plain(x, planes, ss, zs, ids, p, shift),
        qm.quant_matmul_tasks_plain(x, nib, ssd, zsd, ids))


def test_plane_reads_refuse_short_buffers_and_stray_shifts():
    q = torch.randint(0, 16, (N, K), dtype=torch.uint8)
    planes = tq.pack_codes_planes(q, 4)
    s, z = torch.ones(N, 1), torch.zeros(N, 1)
    x = torch.randn(4, K)
    with pytest.raises(ValueError, match="planes"):
        qm.quant_gemv_planes(x, planes[:2].contiguous(), s, z, 3)
    with pytest.raises(ValueError, match="cannot read 3 planes"):
        ops.quant_matmul(x, planes[:2].contiguous(), s, z,
                         tq.QuantSpec(bits=3, layout="plane"))
    with pytest.raises(ValueError, match="cannot read 5 planes"):
        ops.quant_matmul(x, planes, s, z,
                         tq.QuantSpec(bits=4, layout="plane"), draft_bits=5)
    with pytest.raises(ValueError, match="bit-plane"):
        ops.quant_matmul(x, tq.pack_codes(q), s, z, tq.QuantSpec(),
                         draft_bits=3)


# ---------------------------------------------------------------- PEQA

@pytest.fixture(scope="module")
def plane_pair():
    jcfg, tcfg = tiny_llama_pair(layout="plane", n_grid=4)
    fp, jqt = reference_params(jcfg)
    return jcfg, tcfg, to_numpy(fp), to_numpy(jqt)


def test_quantize_params_plane_matches_reference(plane_pair):
    jcfg, tcfg, fp_np, jq_np = plane_pair
    model = peqa.quantize_params(bridge.to_module(fp_np, tcfg, device="cpu"),
                                 tcfg.quant, device="cpu")
    qw = dict(model.named_buffers())["layers.0.mlp.down.qw"]
    assert qw.shape == (4, tcfg.d_model, tcfg.d_ff // 32)
    _assert_trees_match(jq_np, bridge.to_tree(model))
    assert peqa.model_size_bytes(model, tcfg.quant) == \
        jpeqa.model_size_bytes(jq_np, jcfg.quant)


def test_bridge_round_trip_and_dequantize_plane(plane_pair):
    jcfg, tcfg, _, jq_np = plane_pair
    model = bridge.to_module(jq_np, tcfg, device="cpu")
    assert dict(model.named_buffers())["layers.1.attn.wq.qw"].shape == \
        jq_np["layers"]["attn"]["wq"]["qw"].shape[1:]
    back = bridge.to_tree(model)
    for a, b in zip(jax.tree.leaves(jq_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)
    want = jpeqa.dequantize_params(jq_np, jcfg.quant)
    got = bridge.to_tree(peqa.dequantize_params(model, tcfg.quant))
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(b, np.asarray(a))
