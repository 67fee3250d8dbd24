"""PyTorch port vs JAX reference: continuous batching and multi-task serving.

Configuration: ``tiny_llama_pair()`` (GQA llama, float32, PEQA 4-bit); the
reference quantizes it and three task scale sets are made from its scales
with a seeded numpy generator, then handed to both packages' banks.

  * The slotted model functions (per-slot position vector, mixed task ids,
    ``last_pos``) against the reference's under ``force_impl("interpret")``
    (its K5 Pallas kernel in interpret mode): logits and cache within 1e-4,
    float32 summed in different orders.
  * ``Engine.serve`` under ``drain``, ``resident`` and ``auto`` on the
    reference's mixed-task traffic (``tests/test_serve_mixed_task.py``)
    against the reference's ``serve`` on its default CPU path: tokens and
    every scheduler counter EXACTLY equal (greedy tokens of float32 paths).
  * Inside the port: resident tokens == drain tokens, resident drain-free.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scale_bank as jsb
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.core import scale_bank as sb
from repro_torch.models import registry
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine

from test_serve_mixed_task import TASKS, _requests
from test_torch_configs import reference_params, tiny_llama_pair, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


COUNTERS = ("scheduler", "steps", "decoded", "switches", "idle_slot_steps",
            "task_drain_idle_slot_steps", "resident_installs",
            "prefill_compiles", "bubble_slot_steps", "peak_queue_depth",
            "tier_device_hits", "tier_host_hits", "tier_disk_loads",
            "prefetch_issued", "prefetch_hidden_s", "bank_disk_loads",
            "bank_host_evictions")
PER_REQUEST = ("status", "tokens", "arrival_s", "admit_s", "first_token_s",
               "finish_s", "scale_tier", "swap_wait_s")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_llama_pair()
    _, jq = reference_params(jcfg, seed=0)
    jq_np = to_numpy(jq)
    base = jsb.extract_scales(jq)
    rng = np.random.default_rng(7)
    sets = {TASKS[0]: base}
    for t in TASKS[1:]:
        sets[t] = {k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
                   for k, v in base.items()}
    return jcfg, tcfg, jq_np, sets


def _engines(setup, root=None):
    """(reference engine, port engine) over banks holding the same sets —
    in memory, or both opened on the npz files in ``root``."""
    jcfg, tcfg, jq_np, sets = setup
    jbank, tbank = jsb.ScaleBank(root), sb.ScaleBank(root)
    if root is None:
        for t, s in sets.items():
            jbank.tasks[t] = s
            tbank.tasks[t] = s
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, jq_np),
                   bank=jbank)
    teng = Engine(registry.build(tcfg, device="cpu"),
                  bridge.to_module(jq_np, tcfg, device="cpu"), bank=tbank,
                  device="cpu")
    return jeng, teng


def _port_requests(reqs):
    return [Request(tokens=r.tokens, n_new=r.n_new, task=r.task,
                    eos_id=r.eos_id, arrival_s=r.arrival_s,
                    arrival_step=r.arrival_step) for r in reqs]


def _serve_both(setup, reqs, root=None, **cfg):
    jeng, teng = _engines(setup, root)
    return (jeng.serve(reqs, JServeConfig(**cfg)),
            teng.serve(_port_requests(reqs), ServeConfig(**cfg)))


def _assert_reports_equal(jrep, trep):
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert len(trep.requests) == len(jrep.requests)
    for jm, tm in zip(jrep.requests, trep.requests):
        for key in PER_REQUEST:
            assert getattr(tm, key) == getattr(jm, key), (tm.rid, key)


@pytest.fixture(scope="module")
def reports(setup):
    """{scheduler: (reference report, port report)} on the reference's
    9-request, 3-task traffic, 3 slots."""
    reqs = _requests(setup[0])
    return {s: _serve_both(setup, reqs, n_slots=3, scheduler=s)
            for s in ("drain", "resident")}


@pytest.mark.parametrize("b,s,last", [(1, 20, 13), (2, 24, 19)])
def test_slotted_prefill_and_decode_logits_match_reference(setup, b, s, last):
    """B·S = 20 rows take K5's route, 48 rows the per-task K2 route."""
    jcfg, tcfg, jq_np, sets = setup
    jeng, teng = _engines(setup)
    japi, api = jeng.api, teng.api
    jrs = jsb.ResidentStack(jeng.bank, jeng.params, 3, warm=TASKS)
    trs = sb.ResidentStack(teng.bank, teng.model, 3, warm=TASKS, device="cpu")
    toks = tokens(b, s, tcfg.vocab_size, seed=11 + b)
    ids = np.array([2, 1][:b], np.int32)
    with jops.force_impl("interpret"):
        jl, jc = japi.prefill_slotted(
            jeng.params, jrs.stack,
            {"tokens": jnp.asarray(toks), "last_pos": jnp.int32(last)},
            jnp.asarray(ids))
    with torch.no_grad():
        tl, tc = api.prefill_slotted(
            teng.model, trs.stack,
            {"tokens": torch.from_numpy(toks).long(), "last_pos": last},
            torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=1e-4)

    # two decode steps of a 3-slot pool, each slot at its own position and
    # task; slot 2 has no sequence (garbage that must not leak)
    cap = 32
    jfull = japi.init_cache(3, cap)
    jfull = jax.tree.map(lambda d, x: d.at[:, :b, :s].set(x), jfull, jc)
    tfull = api.init_cache(3, cap)
    for key in tfull:
        tfull[key][:, :b, :s] = tc[key]
    pos = np.array([last + 1, s - 3, 0][:3], np.int64)
    tids = np.array([0, 2, 1], np.int32)
    nxt = np.array([[5], [7], [0]], np.int32)
    for _ in range(2):
        with jops.force_impl("interpret"):
            jl, jfull = japi.decode_step_slotted(
                jeng.params, jrs.stack, jfull, jnp.asarray(nxt),
                jnp.asarray(pos.astype(np.int32)), jnp.asarray(tids))
        with torch.no_grad():
            tl, tfull = api.decode_step_slotted(
                teng.model, trs.stack, tfull, torch.from_numpy(nxt).long(),
                torch.from_numpy(pos), torch.from_numpy(tids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        pos += 1
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    np.testing.assert_allclose(tfull["v"].numpy(), np.asarray(jfull["v"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sched", ["drain", "resident"])
def test_serve_matches_reference(reports, sched):
    jrep, trep = reports[sched]
    assert trep.scheduler == sched
    assert all(t is not None for t in trep.tokens)
    _assert_reports_equal(jrep, trep)


def test_port_resident_equals_drain_and_is_drain_free(reports):
    drain, resident = reports["drain"][1], reports["resident"][1]
    assert resident.tokens == drain.tokens                  # token-for-token
    assert resident.task_drain_idle_slot_steps == 0
    assert drain.task_drain_idle_slot_steps > 0
    assert resident.steps < drain.steps
    assert resident.switches == 0 and drain.switches > 0
    assert resident.resident_installs == len(TASKS)
    assert resident.bubble_slot_steps == drain.bubble_slot_steps == 0


@pytest.mark.parametrize("n_slots", [3, 4])
def test_small_resident_stack_stays_exact(setup, reports, n_slots):
    """resident_tasks=2 < 3 tasks: rows churn, pinned-row stalls are
    metered, tokens stay exact — and more slots than rows cannot
    deadlock admission."""
    jrep, trep = _serve_both(setup, _requests(setup[0]), n_slots=n_slots,
                             scheduler="resident", resident_tasks=2)
    _assert_reports_equal(jrep, trep)
    assert trep.tokens == reports["drain"][1].tokens
    assert trep.resident_installs > len(TASKS)


def test_auto_resolves_like_reference(setup):
    reqs = _requests(setup[0], n=3)
    jrep, trep = _serve_both(setup, reqs, n_slots=3, scheduler="auto")
    assert trep.scheduler == "resident"
    _assert_reports_equal(jrep, trep)
    reqs[1] = JRequest(tokens=reqs[1].tokens, n_new=reqs[1].n_new)  # no task
    jrep, trep = _serve_both(setup, reqs, n_slots=3, scheduler="auto")
    assert trep.scheduler == "drain"
    _assert_reports_equal(jrep, trep)


def test_admission_control_on_the_virtual_clock_matches_reference(setup):
    """Arrivals in virtual seconds, a queue bound and a shed deadline:
    served / rejected / shed outcomes and every timestamp as the
    reference's."""
    reqs = [JRequest(tokens=(np.arange(3 + i % 4, dtype=np.int32) * (i + 2))
                     % 128, n_new=3 + i % 3, task=TASKS[i % 3],
                     arrival_s=0.5 * (i // 2)) for i in range(10)]
    jrep, trep = _serve_both(setup, reqs, n_slots=2, scheduler="auto",
                             queue_bound=2, shed_after_s=3.0, prefill_s=0.5)
    _assert_reports_equal(jrep, trep)
    assert trep.n_served and (trep.n_rejected or trep.n_shed)


@pytest.mark.parametrize("sched", ["drain", "resident"])
def test_tiered_bank_from_disk_matches_reference(setup, tmp_path, sched):
    """Both banks open the same npz files; the virtual disk lane, install
    cost, prefetch and a 2-task host tier are metered as the reference's."""
    jcfg, _, jq_np, sets = setup
    writer = jsb.ScaleBank(str(tmp_path))
    params = jax.tree.map(jnp.asarray, jq_np)
    for t, s in sets.items():
        writer.add(t, jsb.apply_scales(params, s))
    reqs = _requests(jcfg)
    for i, r in enumerate(reqs):
        r.arrival_step = 2 * i
    jrep, trep = _serve_both(setup, reqs, root=str(tmp_path), n_slots=3,
                             scheduler=sched, host_cache_tasks=2,
                             disk_load_s=1.5, install_s=0.25)
    _assert_reports_equal(jrep, trep)
    assert trep.bank_disk_loads > 0


def test_scheduler_errors_match_reference(setup):
    jeng, teng = _engines(setup)
    untasked = [JRequest(tokens=np.arange(4, dtype=np.int32), n_new=4)]
    cases = [
        (jeng, teng, untasked, "names a task"),
        (JEngine(jeng.api, jeng.params), Engine(teng.api, teng.model,
                                                 device="cpu"),
         _requests(setup[0], n=3), "ScaleBank"),
    ]
    for jeng_, teng_, reqs, match in cases:
        with pytest.raises(ValueError, match=match) as jerr:
            jeng_.serve(reqs, JServeConfig(n_slots=2, scheduler="resident"))
        with pytest.raises(ValueError) as terr:
            teng_.serve(_port_requests(reqs),
                        ServeConfig(n_slots=2, scheduler="resident"))
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        JServeConfig(n_slots=2, scheduler="residnet")
    with pytest.raises(ValueError) as terr:
        ServeConfig(n_slots=2, scheduler="residnet")
    assert str(terr.value) == str(jerr.value)


def test_speculative_is_not_ported_yet(setup):
    """Speculative serving is ported (tests/test_torch_serve_speculative.py)
    but, as in the reference, needs bit-plane codes: this nibble backbone
    raises the reference's message."""
    jeng, teng = _engines(setup)
    reqs = _requests(setup[0], n=3)
    with pytest.raises(ValueError, match="plane") as jerr:
        jeng.serve(reqs, JServeConfig(n_slots=2, scheduler="speculative"))
    with pytest.raises(ValueError, match="plane") as terr:
        teng.serve(_port_requests(reqs),
                   ServeConfig(n_slots=2, scheduler="speculative"))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="ServeConfig"):
        teng.serve([], 3)


def test_task_rows_are_validated_on_the_host(setup):
    """A stack row outside the resident stack never reaches the kernel."""
    _, teng = _engines(setup)
    teng._ensure_resident(3)
    pool = teng.open_pool(2, 16)
    req = Request(tokens=np.arange(4), n_new=3, task=TASKS[1])
    with pytest.raises(ValueError, match="outside the resident stack"):
        teng.admit(pool, req, task_row=3)
    slot = teng.admit(pool, req, task_row=1)
    pool.slotted = True
    pool.tid[slot] = -1
    with pytest.raises(ValueError, match="outside the resident stack"):
        teng.step(pool)
