"""PyTorch port vs JAX reference: self-speculative serving on a bit-plane
backbone (``Engine.serve(..., ServeConfig(scheduler="speculative"))``).

Configuration: the reference's own fixture (tests/test_serve_speculative.py):
``paper_lm`` with 2 layers, d_model 64, d_ff 96, vocab 128, PEQA 4-bit
bit-planes, three task scale sets (the base and two seeded scalings),
bridged into the port.

  * ``decode_verify`` and its slotted form: logits within 1e-4 of the
    reference's (float32, different summation orders).
  * ``serve`` reports equal to the reference's, untasked and with the
    resident scheduler underneath, at spec_k 2 and 3: tokens, steps, draft
    steps, proposed and accepted drafts per request, every scheduler
    counter and timestamp (greedy argmaxes of float32 paths, as in
    tests/test_torch_serve_continuous.py).
  * Inside the port: speculative tokens == greedy tokens for every draft
    width; stale cache rows are never read; the draft reads the target's
    own code buffers; a task switch reaches the next draft.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core import scale_bank as sb
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import registry
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine

from test_torch_serve_continuous import COUNTERS, PER_REQUEST
from _torch_threads import _one_torch_thread  # noqa: F401


TASKS = ("t0", "t1", "t2")
SPEC_COUNTERS = COUNTERS + ("draft_steps", "draft_proposed", "draft_accepted")
SPEC_PER_REQUEST = PER_REQUEST + ("draft_proposed", "draft_accepted")


def _cfgs(layout="plane"):
    kw = dict(n_layers=2, d_model=64, n_heads=2, d_ff=96, vocab=128)
    j = jconfigs.paper_lm(**kw).replace(
        tuning=JTuning(mode="peqa"),
        quant=JQuant(bits=4, n_grid=2, layout=layout))
    t = tconfigs.paper_lm(**kw).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, n_grid=2, layout=layout))
    return j, t


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    rng = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(rng), jcfg, rng)
    p = jax.tree.map(np.asarray, p)
    sets = {TASKS[0]: jsb.extract_scales(p)}
    rngs = np.random.default_rng(7)
    for t in TASKS[1:]:
        sets[t] = {k: (v * rngs.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
                   for k, v in sets[TASKS[0]].items()}
    return jcfg, tcfg, p, sets


def _port_engine(setup, with_bank=True):
    _, tcfg, p, sets = setup
    bank = None
    if with_bank:
        bank = sb.ScaleBank()
        for t, s in sets.items():
            bank.tasks[t] = s
    return Engine(registry.build(tcfg, device="cpu"),
                  bridge.to_module(p, tcfg, device="cpu"), bank=bank,
                  device="cpu")


def _ref_engine(setup, with_bank=True):
    jcfg, _, p, sets = setup
    bank = None
    if with_bank:
        bank = jsb.ScaleBank()
        for t, s in sets.items():
            bank.tasks[t] = s
    return JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, p),
                   bank=bank)


def _requests(tasked, n=9, cls=Request):
    # staggered budgets force mid-loop evict + re-admit
    return [cls(tokens=(np.arange(4, dtype=np.int32) * (i + 1)) % 128,
                n_new=(4, 6, 8)[i % 3],
                task=TASKS[i % 3] if tasked else None) for i in range(n)]


@pytest.fixture(scope="module")
def reports(setup):
    """{(tasked, spec_k): (reference report, port report)} on the
    reference's 9-request traffic, 3 slots."""
    out = {}
    for tasked in (False, True):
        for k in (2, 3):
            cfg = dict(n_slots=3, scheduler="speculative", spec_k=k)
            out[tasked, k] = (
                _ref_engine(setup, tasked).serve(
                    _requests(tasked, cls=JRequest), JServeConfig(**cfg)),
                _port_engine(setup, tasked).serve(
                    _requests(tasked), ServeConfig(**cfg)))
    return out


@pytest.mark.parametrize("slotted", [False, True])
def test_decode_verify_matches_reference(setup, slotted):
    jcfg, tcfg, p, sets = setup
    japi, tapi = jregistry.build(jcfg), registry.build(tcfg, device="cpu")
    model = bridge.to_module(p, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    b, s, c = 3, 4, 24
    cache = {k: rng.normal(size=(2, b, c, tcfg.n_kv_heads, tcfg.d_head)
                           ).astype(np.float32) for k in ("k", "v")}
    toks = rng.integers(0, 128, (b, s)).astype(np.int32)
    pos = np.array([3, 11, 17], np.int32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    if slotted:
        jrs = jsb.ResidentStack(jsb.ScaleBank(), p, 3, warm=())
        trs = sb.ResidentStack(sb.ScaleBank(), model, 3, device="cpu")
        for t in TASKS:
            jrs.bank.tasks[t] = sets[t]
            trs.bank.tasks[t] = sets[t]
            jrs.ensure(t)
            trs.ensure(t)
        ids = np.array([2, 0, 1], np.int32)
        jl, jc = japi.decode_verify_slotted(p, jrs.stack, jcache,
                                            jnp.asarray(toks),
                                            jnp.asarray(pos), jnp.asarray(ids))
        tl, tc = tapi.decode_verify_slotted(model, trs.stack, tcache,
                                            torch.from_numpy(toks).long(),
                                            torch.from_numpy(pos).long(),
                                            torch.from_numpy(ids))
    else:
        jl, jc = japi.decode_verify(p, jcache, jnp.asarray(toks),
                                    jnp.asarray(pos))
        tl, tc = tapi.decode_verify(model, tcache,
                                    torch.from_numpy(toks).long(),
                                    torch.from_numpy(pos).long())
    assert tl.shape == (b, s, tcfg.vocab_size)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tasked,spec_k", [(False, 2), (False, 3), (True, 2),
                                           (True, 3)])
def test_speculative_report_matches_reference(reports, tasked, spec_k):
    jrep, trep = reports[tasked, spec_k]
    assert trep.scheduler == "speculative"
    assert all(t is not None for t in trep.tokens)
    for key in SPEC_COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    for jm, tm in zip(jrep.requests, trep.requests):
        for key in SPEC_PER_REQUEST:
            assert getattr(tm, key) == getattr(jm, key), (tm.rid, key)
    assert trep.draft_steps == spec_k * trep.steps     # no idle jumps
    assert 0 <= trep.draft_accepted <= trep.draft_proposed
    if tasked:
        assert trep.task_drain_idle_slot_steps == 0     # resident underneath


@pytest.mark.parametrize("tasked", [False, True])
def test_speculative_tokens_equal_port_greedy(setup, reports, tasked):
    greedy = _port_engine(setup, tasked).serve(
        _requests(tasked), ServeConfig(n_slots=3, scheduler="auto"))
    assert greedy.scheduler == ("resident" if tasked else "drain")
    for k in (2, 3):
        assert reports[tasked, k][1].tokens == greedy.tokens


@pytest.mark.parametrize("draft_bits", [1, 2, 3])
def test_speculative_draft_bits_equal_greedy(setup, draft_bits):
    greedy = _port_engine(setup, False).serve(
        _requests(False, n=4), ServeConfig(n_slots=2, scheduler="auto"))
    spec = _port_engine(setup, False).serve(
        _requests(False, n=4),
        ServeConfig(n_slots=2, scheduler="speculative", spec_k=2,
                    draft_bits=draft_bits))
    assert spec.tokens == greedy.tokens
    assert spec.draft_steps > 0


def test_rollback_poison_stale_rows_never_read(setup):
    """Rows past each slot's committed position are dead: fill them with a
    large finite sentinel after a speculative round and the following
    greedy decode emits the same tokens."""
    eng = _port_engine(setup, False)
    reqs = _requests(False, n=2)
    cache_len = max(r.n_prompt + int(r.n_new) for r in reqs) + 2
    pool = eng.open_pool(2, cache_len)
    for i, r in enumerate(reqs):
        eng.admit(pool, r, rid=i)
    eng.spec_step(pool, 2, 3)            # leaves rejected draft rows behind
    poisoned = eng.open_pool(2, cache_len)
    for key in ("pos", "active", "tok", "tid"):
        setattr(poisoned, key, getattr(pool, key).copy())
    poisoned.meta = copy.deepcopy(pool.meta)
    for key, leaf in pool.cache.items():
        bad = leaf.clone()
        for slot in range(2):
            bad[:, slot, int(pool.pos[slot]):] = 1e4
        poisoned.cache[key] = bad
    for _ in range(4):
        assert eng.step(pool).tolist() == eng.step(poisoned).tolist()


def test_draft_reads_the_target_code_buffers(setup, monkeypatch):
    """Every draft launch gets a target ``qw`` buffer itself (same data
    pointer), with a read width below the stored planes."""
    eng = _port_engine(setup, False)
    targets = {b.data_ptr(): b.shape[0] for n, b in eng.model.named_buffers()
               if n.endswith("qw")}
    seen = []
    real = qm.quant_gemv_planes

    def spy(x, qw, scale, zero, bits, shift=0):
        seen.append((qw.data_ptr(), bits, shift))
        return real(x, qw, scale, zero, bits, shift)
    monkeypatch.setattr(qm, "quant_gemv_planes", spy)
    pool = eng.open_pool(2, 24)
    for i, r in enumerate(_requests(False, n=2)):
        eng.admit(pool, r, rid=i)
    seen.clear()
    eng.spec_step(pool, 2, 3)
    reads = [(bits, shift) for _, bits, shift in seen]
    # spec_k draft steps, then one verify, over 2 layers × 7 linears
    assert reads == [(3, 1)] * (2 * 14) + [(4, 0)] * 14
    assert all(ptr in targets for ptr, _, _ in seen)


def test_task_switch_reaches_the_next_draft(setup):
    """After ``switch_task`` the drafts decode under the new live scales:
    the same counters as an engine that started on that task (a draft
    that kept the old task's scales would keep the old acceptance)."""
    reqs = _requests(False)
    cfg = ServeConfig(n_slots=3, scheduler="speculative", spec_k=3)
    eng = _port_engine(setup)
    eng.switch_task("t0")
    before = eng.serve(reqs, cfg)
    eng.switch_task("t2")
    after = eng.serve(reqs, cfg)
    fresh = _port_engine(setup)
    fresh.switch_task("t2")
    want = fresh.serve(reqs, cfg)
    assert after.tokens != before.tokens
    for key in ("tokens", "steps", "draft_steps", "draft_proposed",
                "draft_accepted"):
        assert getattr(after, key) == getattr(want, key), key
    assert [m.draft_accepted for m in after.requests] == \
        [m.draft_accepted for m in want.requests]


def test_speculative_requires_plane_backbone(setup):
    _, tcfg = _cfgs("nibble")
    api = registry.build(tcfg, device="cpu")
    model, _ = policies.prepare(api.init(0), tcfg, device="cpu")
    eng = Engine(api, model, device="cpu")
    with pytest.raises(ValueError, match="plane"):
        eng.serve(_requests(False, n=2),
                  ServeConfig(n_slots=2, scheduler="speculative"))


def test_speculative_draft_bits_validation(setup):
    cfg = dict(n_slots=2, scheduler="speculative", draft_bits=4)
    with pytest.raises(ValueError, match="draft_bits") as jerr:
        _ref_engine(setup, False).serve(_requests(False, n=2, cls=JRequest),
                                        JServeConfig(**cfg))
    with pytest.raises(ValueError, match="draft_bits") as terr:
        _port_engine(setup, False).serve(_requests(False, n=2),
                                         ServeConfig(**cfg))
    assert str(terr.value) == str(jerr.value)


def test_speculative_respects_budget(setup):
    """A round proposing past n_new emits exactly n_new tokens."""
    rep = _port_engine(setup, False).serve(
        [Request(tokens=np.arange(4, dtype=np.int32), n_new=3)],
        ServeConfig(n_slots=2, scheduler="speculative", spec_k=4))
    assert rep.n_served == 1
    assert len(rep.requests[0].tokens) == 3
    assert rep.requests[0].draft_proposed % 4 == 0
