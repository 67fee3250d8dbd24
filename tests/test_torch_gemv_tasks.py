"""PyTorch port vs JAX reference: the per-slot task-scale GEMV (K5).

On the CPU the port's ``ops.quant_matmul_slotted`` runs K5's plain version
(the plain matmul once per task present, rows selected).  It is held against
the reference's Pallas kernel in interpret mode —
``quant_gemv_pallas(..., task_ids=...)`` — and against the reference's naive
gather oracle ``ref.quant_matmul_tasks_ref``, on the same seeded inputs.

Tolerance: rtol 1e-5, atol 1e-4, the reference's own for its slotted kernel
(tests/test_gemv.py).  It cannot be bitwise across the two packages: the
float32 sums run in different orders, and on this jax the reference's
interpret-mode kernel is not even bit-equal to its own blocked replay.
Inside the port, each row IS bit-equal to the plain path under its task.

The CUDA kernel itself is held to K1 (bitwise) and to the plain version on
the card by ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QTensor
from repro.core.quant import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ref
from _torch_threads import _one_torch_thread  # noqa: F401


N, K, T = 96, 256, 4


def _operands(m, group, seed=0, n_tasks=T):
    """Seeded numpy inputs quantized by the reference, per-task scales and
    zeros perturbed from them, mixed task ids over >= 3 distinct tasks:
    (jax args, torch args), each (x, qw, scale_stack, zero_stack, ids)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
    qt = QTensor.quantize(jnp.asarray(w), JSpec(bits=4, group_size=group),
                          n_grid=2)
    s, z = np.asarray(qt.scale), np.asarray(qt.zero)
    ss = np.stack([s * rng.uniform(0.8, 1.2, s.shape) for _ in range(n_tasks)]
                  ).astype(np.float32)
    zs = np.stack([z + rng.uniform(-0.5, 0.5, z.shape) for _ in range(n_tasks)]
                  ).astype(np.float32)
    x = rng.normal(size=(m, K)).astype(np.float32)
    ids = (np.arange(m) * 3 + 1) % min(n_tasks, 3) if m < 3 else \
        rng.permutation(np.arange(m) % n_tasks)
    ids = ids.astype(np.int32)
    qw = np.asarray(qt.qw)
    jargs = (jnp.asarray(x), qt.qw, jnp.asarray(ss), jnp.asarray(zs),
             jnp.asarray(ids))
    targs = (torch.from_numpy(x), torch.from_numpy(qw.view(np.int32).copy()),
             torch.from_numpy(ss), torch.from_numpy(zs),
             torch.from_numpy(ids))
    return jargs, targs


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("group", [None, 32, 64])
def test_slotted_matches_reference_k5(m, group):
    jargs, targs = _operands(m, group, seed=m + (group or 0))
    jx, jqw, jss, jzs, jids = jargs
    spec = JSpec(bits=4, group_size=group)
    want = np.asarray(jqm.quant_gemv_pallas(jx, jqw, jss, jzs, task_ids=jids,
                                            spec=spec, interpret=True))
    oracle = np.asarray(jref.quant_matmul_tasks_ref(jx, jqw, jss, jzs, jids,
                                                    (N, K), spec))
    got = ops.quant_matmul_slotted(*targs, QuantSpec(group_size=group))
    assert got.dtype == torch.float32 and got.shape == (m, N)
    assert len(set(targs[4].tolist())) >= min(m, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-4)
    # the port's own oracle agrees with the reference's
    mine = ref.quant_matmul_tasks_ref(*targs, (N, K), QuantSpec())
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [1, 5, 8, 32, 40])
def test_rows_bit_equal_to_plain_path_under_their_task(m):
    """Row i == ``ops.quant_matmul`` under ``scale_stack[task_ids[i]]``, bit
    for bit, on both routes (K5 for M <= 32, per-task K2 above)."""
    _, (x, qw, ss, zs, ids) = _operands(m, 32, seed=m)
    got = ops.quant_matmul_slotted(x, qw, ss, zs, ids, QuantSpec())
    for i, t in enumerate(ids.tolist()):
        plain = ops.quant_matmul(x, qw, ss[t], zs[t], QuantSpec())
        assert torch.equal(got[i], plain[i]), (i, t)


def test_large_m_route_is_k2_per_task_present(monkeypatch):
    """M > 32 (the slotted prefill) runs K2 once per task present — the
    plain version on CPU tensors — and equals the per-task plain select."""
    calls = []
    for name in ("quant_gemv_tasks", "quant_matmul"):
        orig = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda *a, _n=name, _o=orig:
                            calls.append(_n) or _o(*a))
    _, (x, qw, ss, zs, ids) = _operands(40, None, seed=3)
    ids[:] = torch.tensor([2, 0] * 20, dtype=torch.int32)
    got = ops.quant_matmul_slotted(x, qw, ss, zs, ids, QuantSpec())
    assert calls == ["quant_matmul", "quant_matmul"]
    want = qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
    assert torch.equal(got, want)
    calls.clear()
    ops.quant_matmul_slotted(x[:8], qw, ss, zs, ids[:8], QuantSpec())
    assert calls == ["quant_gemv_tasks"]


def test_leading_dims_flatten_like_reference():
    _, (x, qw, ss, zs, ids) = _operands(8, None, seed=4)
    y = ops.quant_matmul_slotted(x.reshape(2, 4, K), qw, ss, zs, ids,
                                 QuantSpec())
    assert y.shape == (2, 4, N)
    assert torch.equal(y.reshape(8, N),
                       ops.quant_matmul_slotted(x, qw, ss, zs, ids,
                                                QuantSpec()))


def test_row_mismatch_raises_reference_message():
    jargs, targs = _operands(5, None, seed=5)
    jx, jqw, jss, jzs, jids = jargs
    with pytest.raises(ValueError) as jerr:
        jops.quant_matmul_slotted(jx, jqw, jss, jzs, jids[:4], JSpec())
    with pytest.raises(ValueError) as terr:
        ops.quant_matmul_slotted(*targs[:4], targs[4][:4], QuantSpec())
    assert str(terr.value) == str(jerr.value)


def test_forced_torch_impl_and_cpu_count_no_launch():
    _, targs = _operands(8, 64, seed=6)
    before = qm.quant_gemv_tasks.launches
    got = ops.quant_matmul_slotted(*targs, QuantSpec(group_size=64))
    with ops.force_impl("torch"):
        forced = ops.quant_matmul_slotted(*targs, QuantSpec(group_size=64))
    assert torch.equal(got, forced)
    assert qm.quant_gemv_tasks.launches == before


def _bad_k5_operands():
    _, (x, qw, ss, zs, ids) = _operands(5, None, seed=7)
    return [
        ("int64 ids", (x, qw, ss, zs, ids.long())),
        ("ids length", (x, qw, ss, zs, ids[:4].contiguous())),
        ("2-d scale", (x, qw, ss[0], zs[0], ids)),
        ("stacks differ", (x, qw, ss, zs[:2].contiguous(), ids)),
        ("stack rows", (x, qw, ss[:, :-1].contiguous(), zs[:, :-1].contiguous(),
                        ids)),
        ("33 rows", (torch.zeros(33, K), qw, ss, zs,
                     torch.zeros(33, dtype=torch.int32))),
        ("float16 x", (x.half(), qw, ss, zs, ids)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_k5_wrapper_refuses_what_it_cannot_take(case):
    why, args = _bad_k5_operands()[case]
    with pytest.raises((ValueError, TypeError)):
        qm.quant_gemv_tasks(*args)


def test_task_id_outside_the_stack_raises_in_plain_version():
    _, (x, qw, ss, zs, ids) = _operands(5, None, seed=8)
    ids[2] = T
    with pytest.raises(ValueError, match="outside the stack"):
        qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)


def test_error_bound_with_task_ids_is_per_row():
    _, (x, qw, ss, zs, ids) = _operands(8, 32, seed=9)
    plain = qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
    bound = qm.error_bound(x, qw, ss, zs, plain, task_ids=ids)
    for i, t in enumerate(ids.tolist()):
        row = qm.error_bound(x[i:i + 1], qw, ss[t], zs[t], plain[i:i + 1])
        # the bound is itself a float32 matmul, summed in an M-dependent
        # order: equal to float32 rounding
        torch.testing.assert_close(bound[i], row[0], rtol=1e-5, atol=0)
