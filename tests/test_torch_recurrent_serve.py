"""PyTorch port vs JAX reference: the recurrent families (xlstm-125m, ssm;
zamba2-7b, hybrid) served, checkpointed and trained.

  * the slot pool's per-leaf cache record: every xlstm leaf position-free
    (−1), zamba2's shared-block K/V paged along dim 2 and its SSM and conv
    states −1 — the reference's own record —, and ``_has_seq_leaf``;
  * drain ``Engine.serve`` of ``tests/test_serve_families.py``'s
    ``_CHUNKED_SHAPES`` over two tasks against the reference's
    ``Engine.serve`` and each request's own ``generate``; an xlstm request
    longer than the pool admitted (no seq leaf); a prompt whose length the
    chunked scan refuses raises before the pool is touched;
  * the resident and speculative refusals word for word;
  * a reference ScaleBank's task dict with nested (n_groups, n_m, N, G)
    leaves installed and extracted unchanged, and checkpoints both ways;
  * 3 train steps, peqa (remat "block") and full (remat "none"), against
    ``repro.train.step.build_train_step``.

Configuration and weights as ``test_torch_xlstm.py``.  Tolerances: tokens
and scheduler counters equal; the train steps' loss rtol 1e-5, every
untrained leaf bit-equal; under peqa the gradient norm rtol 1e-4 and each
trained leaf's update within 1e-3 of the reference's in ℓ2; under full
the gradient norm rtol 1e-3 and the updates within 2e-2.  Full mode's
step-1 gradients agree to 3e-5 of each leaf's norm, but Adam's first
update divides every element by its own magnitude (plus eps 1e-8), so an
element whose gradient is within float32 noise of eps moves by another
fraction of lr: that puts 1.7e-3 (xlstm's ``sb``) and 2.4e-3 (zamba2's
``out_proj``) between the updates from step 1, and zamba2's dynamics
carry it to 1.8e-4 of the gradient norm at step 2 and 1e-2 of the token
table's update at step 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import TrainConfig as JTrain
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.serve import ServeConfig as JServeConfig
from repro.train import step as jstep
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, TrainConfig
from repro_torch.core import policies
from repro_torch.core import scale_bank as sb
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve import Request, ServeConfig
from repro_torch.train import step
from repro_torch.train.serve import Engine
from repro_torch.train.state import make_state

from test_serve_families import _CHUNKED_SHAPES
from test_torch_xlstm import ARCHS, flat, policy_tree, tiny_pair
from _torch_threads import _one_torch_thread  # noqa: F401


OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
TASKS = ("t0", "t1")


def _engines(arch, bank=False):
    jcfg, tcfg = tiny_pair(arch)
    tree = policy_tree(arch, "peqa")
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    eng = Engine(registry.build(tcfg, device="cpu"),
                 bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    if bank:
        base = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
        rng = np.random.default_rng(5)
        sets = {TASKS[0]: base, TASKS[1]: {
            k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
            for k, v in base.items()}}
        jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
        for t, s in sets.items():
            jeng.bank.tasks[t] = s
            eng.bank.tasks[t] = s
    return jeng, eng


def _requests(cfg, cls):
    rs = np.random.default_rng(9)
    return [cls(tokens=rs.integers(0, cfg.vocab_size, s).astype(np.int32),
                n_new=n, task=TASKS[i % 2], arrival_step=a)
            for i, (s, n, a) in enumerate(_CHUNKED_SHAPES)]


# ----------------------------------------------------- the per-leaf record

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_record_matches_reference(arch):
    """xlstm: every leaf position-free, the sLSTM states' batch dim 1 and
    the mLSTM state's 2; zamba2: attn_k / attn_v paged along dim 2 with
    batch dim 1, the stacked SSM and conv states −1 with batch dim 2, the
    tail's −1 with batch dim 1 — as the reference's record."""
    jeng, eng = _engines(arch)
    bdims, sdims = eng._cache_dims()
    jb, js = jeng._cache_dims()
    assert (bdims, sdims) == ({k: int(v) for k, v in jb.items()},
                              {k: int(v) for k, v in js.items()})
    if arch == "xlstm-125m":
        assert set(sdims.values()) == {-1} and not eng._has_seq_leaf()
        assert bdims == {"s_c": 1, "s_n": 1, "s_m": 1, "s_h": 1, "m_S": 2}
    else:
        assert sdims == {"attn_k": 2, "attn_v": 2, "ssm": -1, "conv": -1,
                         "ssm_tail": -1, "conv_tail": -1}
        assert bdims == {"attn_k": 1, "attn_v": 1, "ssm": 2, "conv": 2,
                         "ssm_tail": 1, "conv_tail": 1}
        assert eng._has_seq_leaf()


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", ARCHS)
def test_drain_serve_matches_reference_and_generate(arch):
    """Five requests (prompts 8–24, each one chunk or a multiple of it)
    over two tasks through two slots under drain: tokens and scheduler
    counters equal to the reference's, every budget served, and each
    request's tokens equal to its own ``generate`` under its task's
    scales (the SSM states written whole per slot at admit)."""
    jeng, eng = _engines(arch, bank=True)
    cfg = eng.api.cfg
    jrep = jeng.serve(_requests(cfg, JRequest),
                      JServeConfig(n_slots=2, scheduler="drain"))
    trep = eng.serve(_requests(cfg, Request),
                     ServeConfig(n_slots=2, scheduler="drain"))
    for key in ("scheduler", "steps", "decoded", "switches",
                "idle_slot_steps", "bubble_slot_steps",
                "task_drain_idle_slot_steps", "prefill_compiles"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.tokens == jrep.tokens
    reqs = _requests(cfg, Request)
    assert [len(t) for t in trep.tokens] == [r.n_new for r in reqs]
    for req, got in zip(reqs, trep.tokens):
        eng.switch_task(req.task)
        out = eng.generate(req.tokens[None], req.n_new)
        assert out[0, req.n_prompt:].tolist() == got


@pytest.mark.parametrize("arch", ARCHS)
def test_admit_capacity_and_ragged_prompts(arch):
    """A prompt of 12 tokens (chunk 8) raises the scan's message at admit
    and leaves the pool as it was; on xlstm a request longer than the
    pool's capacity is admitted (it has no position), on zamba2 it is
    refused — as the reference."""
    jeng, eng = _engines(arch)
    cfg = eng.api.cfg
    pool = eng.open_pool(2, 16)
    before = {k: v.clone() for k, v in pool.cache.items()}
    ragged = Request(tokens=np.arange(12, dtype=np.int32), n_new=2)
    with pytest.raises(ValueError, match="seq 12 % chunk 8 != 0"):
        eng.admit(pool, ragged)
    assert not pool.active.any() and not pool._prefill_keys
    assert all(torch.equal(pool.cache[k], v) for k, v in before.items())
    long = dict(tokens=np.arange(16, dtype=np.int32) % cfg.vocab_size,
                n_new=8)
    jpool = jeng.open_pool(2, 16)
    if arch == "xlstm-125m":
        assert eng.admit(pool, Request(**long)) == 0
        jeng.admit(jpool, JRequest(**long))
        assert pool.tok[0] == jpool.tok[0]
    else:
        with pytest.raises(ValueError) as terr:
            eng.admit(pool, Request(**long))
        with pytest.raises(ValueError) as jerr:
            jeng.admit(jpool, JRequest(**long))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_reference(arch):
    """The resident scheduler (no slotted step) and the speculative one (no
    verify): the reference's messages, word for word."""
    jeng, eng = _engines(arch, bank=True)
    cfg = eng.api.cfg
    for sched in ("resident", "speculative"):
        with pytest.raises(ValueError) as jerr:
            jeng.serve(_requests(cfg, JRequest),
                       JServeConfig(n_slots=2, scheduler=sched))
        with pytest.raises(ValueError) as terr:
            eng.serve(_requests(cfg, Request),
                      ServeConfig(n_slots=2, scheduler=sched))
        assert str(terr.value) == str(jerr.value), sched
        reason = "recurrent state layers" if sched == "resident" \
            else "no multi-token verify step"
        assert reason in str(terr.value)


# ----------------------------------------------- scale bank and checkpoints

@pytest.mark.parametrize("arch", ARCHS)
def test_scale_bank_task_round_trips_with_nested_stacks(arch):
    """The reference's ``extract_scales`` of the tree — nested leaves
    (2, 1, N, G) on xlstm's mLSTMs, (2, 3, N, G) on zamba2's grouped
    Mamba2 blocks, the shared block's unstacked — installed into the port
    and extracted back unchanged, its npz file likewise."""
    tree = policy_tree(arch, "peqa")
    want = {k: np.asarray(v) * 1.5 for k, v in jsb.extract_scales(
        jax.tree.map(jnp.asarray, tree)).items()}
    nested = "mlstm/wq/scale" if arch == "xlstm-125m" \
        else "mamba_groups/zproj/scale"
    assert want[nested].shape[:2] == ((2, 1) if arch == "xlstm-125m"
                                      else (2, 3))
    model = bridge.to_module(tree, tiny_pair(arch)[1], device="cpu")
    sb.apply_scales(model, want)
    got = sb.extract_scales(model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if arch == "zamba2-7b":
        assert got["shared/attn/wq/scale"].shape == (64, 1)
    with pytest.raises(ValueError, match="scale shape mismatch"):
        sb.apply_scales(model, {nested: want[nested][:1]})


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_both_ways(arch, tmp_path):
    """A reference checkpoint of a PEQA model restored into the port, and
    the port's restored into the reference: every array equal."""
    jcfg, tcfg = tiny_pair(arch)
    tree = policy_tree(arch, "peqa")
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(tree, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(3)}
    JManager(str(tmp_path / "ref")).save(3, jstate)
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    restored, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        bridge.state_to_tree(state))
    bridge.load_state(state, restored)
    got = flat(bridge.state_to_tree(state)["params"])
    assert got.keys() == flat(tree).keys()
    for key, want in flat(tree).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    CheckpointManager(str(tmp_path / "port")).save(
        3, bridge.state_to_tree(state))
    back, extra = JManager(str(tmp_path / "port")).restore(jstate)
    assert extra["step"] == 3
    for key, want in flat(tree).items():
        np.testing.assert_array_equal(flat(back["params"])[key], want,
                                      err_msg=key)


# ----------------------------------------------------------------- training

@pytest.mark.parametrize("arch,mode,remat",
                         [(a, m, r) for a in ARCHS
                          for m, r in (("peqa", "block"), ("full", "none"))])
def test_train_steps_match_reference(arch, mode, remat):
    """3 steps on 2 × 16-token batches of the synthetic corpus (two chunks
    each): under peqa only the scales move (codes, zeros, ``sr``, ``sb``,
    ``A_log``, ``ssm_D``, ``dt_bias``, ``conv``, norms and table
    bit-equal); under full every float leaf."""
    jcfg, tcfg = tiny_pair(arch, mode, remat=remat)
    start = policy_tree(arch, mode)
    data = pipeline.PackedLM(synthetic.corpus(tcfg.vocab_size, 2000, seed=4),
                             2, 16)
    batches = [data.batch_at(i) for i in range(3)]
    jp = jax.tree.map(jnp.asarray, start)
    jmask = jpolicies.make_mask(jp, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(0)}
    jts = jstep.build_train_step(jregistry.build(jcfg), jcfg,
                                 JTrain(optim=JOptim(**OCFG)), jmask, jopt)
    jhist = []
    for batch in batches:
        jstate, m = jts(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jhist.append({k: float(v) for k, v in m.items()})
    model = bridge.to_module(start, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(registry.build(tcfg, device="cpu"), tcfg,
                               TrainConfig(optim=OptimConfig(**OCFG)), mask,
                               opt)
    thist = []
    for batch in batches:
        state, m = ts(state, batch)
        thist.append({k: float(v) for k, v in m.items()})
    assert opt.state_bytes(state["opt"]) == jopt.state_bytes(jstate["opt"])
    norm_rtol, upd_rtol = (1e-4, 1e-3) if mode == "peqa" else (1e-3, 2e-2)
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=norm_rtol)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-7)
    fs, fw, fg = flat(start), flat(jstate["params"]), flat(
        bridge.to_tree(state["params"]))
    assert fw.keys() == fg.keys() == fs.keys()
    trained = [k for k in fw if not np.array_equal(fs[k], fw[k])]
    if mode == "peqa":
        assert trained and all(k.endswith("scale") for k in trained)
    else:
        want = {"slstm/sr/r", "slstm/sb/b", "mlstm/gf/w"} \
            if arch == "xlstm-125m" else {
                "mamba_groups/A_log", "mamba_tail/conv/w",
                "shared/ln1/g", "mamba_groups/dt_bias"}
        assert want <= set(trained)
    for key in fw:
        a, b, s0 = fw[key], fg[key], fs[key]
        if key not in trained:
            np.testing.assert_array_equal(b, a, err_msg=key)
            continue
        upd_ref = a.astype(np.float64) - s0
        upd = b.astype(np.float64) - s0
        assert np.linalg.norm(upd - upd_ref) <= \
            upd_rtol * np.linalg.norm(upd_ref), key
