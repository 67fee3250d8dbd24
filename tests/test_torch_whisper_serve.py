"""PyTorch port vs JAX reference: the encdec family (whisper-medium),
serving, checkpoints and training.

  * the slot pool's per-leaf cache record (``train.serve.cache_dims``):
    whisper's self K/V page along dim 2, its cross K/V have no sequence
    dim (−1), every leaf's batch dim is 1 — as the reference's
    ``Engine._cache_dims`` derives them —, and the decoder families' fp,
    int8 and ring caches give the layout the pool used to assume;
  * a cross K/V leaf of the wrong extent refused at admit and at
    ``generate``'s re-home;
  * drain ``Engine.serve`` of frame-prefixed requests over two tasks
    against the reference's ``Engine.serve`` and each request's own
    ``generate``; the resident, speculative and missing-frames refusals
    word for word;
  * checkpoints both ways;
  * 3 train steps, peqa and full, against
    ``repro.train.step.build_train_step``.

Configuration and weights as ``test_torch_whisper.py``.  Tolerances:
tokens and scheduler counters equal; the train steps' loss rtol 1e-5,
gradient norm rtol 1e-4, each trained leaf's update within 1e-3 of the
reference's in ℓ2, every other leaf bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
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
import repro_torch.configs as tconfigs
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
from repro_torch.train.serve import Engine, cache_dims
from repro_torch.train.state import make_state

from test_torch_configs import tokens
from test_torch_whisper import flat, frames, policy_tree, tiny_pair
from _torch_threads import _one_torch_thread  # noqa: F401


OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
TASKS = ("t0", "t1")


def _engines(bank=False):
    jcfg, tcfg = tiny_pair("peqa")
    tree = policy_tree("peqa")
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


def _requests(cfg, cls, tasked=True):
    rs = np.random.default_rng(9)
    shapes = [(6, 5, 0), (9, 3, 0), (4, 7, 1), (12, 4, 2), (5, 6, 2),
              (7, 2, 4)]
    fr = frames(len(shapes), cfg, seed=6)
    return [cls(tokens=rs.integers(0, cfg.vocab_size, s).astype(np.int32),
                n_new=n, task=TASKS[i % 2] if tasked else None,
                arrival_step=a, prefix=fr[i])
            for i, (s, n, a) in enumerate(shapes)]


# ----------------------------------------------------- the per-leaf record

def test_whisper_cache_record_marks_cross_kv_position_free():
    """The reference's ``test_whisper_cross_kv_is_position_free`` on the
    port: self K/V seq dim 2, cross K/V −1, every batch dim 1 — the
    reference's own record."""
    jeng, eng = _engines()
    bdims, sdims = eng._cache_dims()
    assert sdims == {"k": 2, "v": 2, "xk": -1, "xv": -1}
    assert bdims == {"k": 1, "v": 1, "xk": 1, "xv": 1}
    jb, js = jeng._cache_dims()
    assert (bdims, sdims) == ({k: int(v) for k, v in jb.items()},
                              {k: int(v) for k, v in js.items()})
    assert eng._cache_dims() is eng._cache_dims()      # memoised


@pytest.mark.parametrize("kw", [dict(), dict(kv_cache_dtype="int8"),
                                dict(swa_window=4)],
                         ids=["fp", "int8", "ring4"])
def test_decoder_cache_records_equal_the_old_constants(kw):
    """Dense caches — fp, int8 with its scales, a 4-slot ring (probed below
    its window) — page every leaf along dim 2 and admit along dim 1, the
    constants the pool used before the record, and the reference's record
    agrees."""
    for arch in ("llama3.2-1b", "qwen2-7b"):
        cfg = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(**kw)
        api = registry.build(cfg, device="cpu")
        eng = Engine(api, torch.nn.Module(), device="cpu")
        bdims, sdims = eng._cache_dims()
        keys = {"k", "v"} | ({"k_scale", "v_scale"} if kw.get(
            "kv_cache_dtype") else set())
        assert bdims == dict.fromkeys(keys, 1), (arch, bdims)
        assert sdims == dict.fromkeys(keys, 2), (arch, sdims)
        jcfg = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(**kw)
        jb, js = JEngine(jregistry.build(jcfg), {})._cache_dims()
        assert sdims == {k: int(v) for k, v in js.items()}
        assert bdims == {k: int(v) for k, v in jb.items()}
    # a probe at the default length would see no seq dim in the ring
    blind = cache_dims(api.init_cache, 2, 8)[1]
    if kw.get("swa_window"):
        assert set(blind.values()) == {-1}


def test_tampered_cross_kv_is_refused():
    """A cross K/V leaf whose frame extent differs from the pool's is
    refused at admit, its message naming the seq dim; an intact batch-1
    prefill cache is admitted, its cross K/V written as one whole slot
    row."""
    _, eng = _engines()
    cfg = eng.api.cfg
    pool = eng.open_pool(2, 32)
    batch = {"tokens": torch.from_numpy(tokens(1, 5, cfg.vocab_size)).long(),
             "frames": torch.from_numpy(frames(1, cfg, seed=3))}
    with torch.inference_mode():
        _, pcache = eng.api.prefill(eng.model, batch)
    bad = dict(pcache, xk=torch.cat([pcache["xk"], pcache["xk"]], dim=2))
    with pytest.raises(ValueError, match="seq dim -1"):
        eng._check_admit_shapes(pool, bad)
    eng._check_admit_shapes(pool, pcache)
    eng._admit_write(pool, pcache, 1)
    assert torch.equal(pool.cache["xk"][:, 1:2], pcache["xk"])
    assert torch.equal(pool.cache["k"][:, 1:2, :5], pcache["k"])
    assert not pool.cache["xk"][:, 0].any()
    real = eng.api.prefill

    def tampered(model, b):
        logits, cache = real(model, b)
        return logits, dict(cache, xk=torch.cat([cache["xk"]] * 2, dim=2))
    eng.api = dataclasses.replace(eng.api, prefill=tampered)
    with pytest.raises(ValueError, match="no seq dim"):
        eng.generate(batch["tokens"], 2, prefix=batch["frames"])


# ------------------------------------------------------------------ serving

def test_drain_serve_matches_reference_and_generate():
    """Six frame-prefixed requests over two tasks through two slots under
    drain: tokens and scheduler counters equal to the reference's, every
    budget served, and each request's tokens equal to its own
    ``generate`` under its task's scales."""
    jeng, eng = _engines(bank=True)
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
        out = eng.generate(req.tokens[None], req.n_new,
                           prefix=req.prefix[None])
        assert out[0, req.n_prompt:].tolist() == got


def test_refusals_match_reference():
    """The resident scheduler (no slotted step), the speculative one (no
    verify) and a request without frames: the reference's messages, word
    for word."""
    jeng, eng = _engines(bank=True)
    cfg = eng.api.cfg
    for sched in ("resident", "speculative"):
        with pytest.raises(ValueError) as jerr:
            jeng.serve(_requests(cfg, JRequest),
                       JServeConfig(n_slots=2, scheduler=sched))
        with pytest.raises(ValueError) as terr:
            eng.serve(_requests(cfg, Request),
                      ServeConfig(n_slots=2, scheduler=sched))
        assert str(terr.value) == str(jerr.value), sched
    bare = dict(tokens=np.arange(4, dtype=np.int32), n_new=2)
    calls = (
        (lambda: jeng.generate(jnp.zeros((1, 4), jnp.int32), n_new=2),
         lambda: eng.generate(np.zeros((1, 4), np.int64), 2)),
        (lambda: jeng.admit(jeng.open_pool(2, 32), JRequest(**bare)),
         lambda: eng.admit(eng.open_pool(2, 32), Request(**bare))))
    for jcall, tcall in calls:
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
        assert "requires prefix state 'frames'" in str(terr.value)


# ------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_both_ways(tmp_path):
    """A reference checkpoint of a PEQA whisper restored into the port, and
    the port's restored into the reference: every array equal."""
    jcfg, tcfg = tiny_pair("peqa")
    tree = policy_tree("peqa")
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

@pytest.mark.parametrize("mode,remat", [("peqa", "block"), ("full", "none")])
def test_train_steps_match_reference(mode, remat):
    """3 steps on 2 × 16-token batches of the synthetic corpus, each behind
    its own seeded frames: under peqa only the scales move (codes, zeros,
    ``pos``, norms and table bit-equal); under full every float leaf, the
    position tables included."""
    jcfg, tcfg = tiny_pair(mode, remat=remat)
    start = policy_tree(mode)
    data = pipeline.PackedLM(synthetic.corpus(tcfg.vocab_size, 2000, seed=4),
                             2, 16)
    batches = [dict(data.batch_at(i), frames=frames(2, tcfg, seed=10 + i))
               for i in range(3)]
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
        assert step.to_device(batch, "cpu")["frames"].dtype == torch.float32
        state, m = ts(state, batch)
        thist.append({k: float(v) for k, v in m.items()})
    assert opt.state_bytes(state["opt"]) == jopt.state_bytes(jstate["opt"])
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-7)
    fs, fw, fg = flat(start), flat(jstate["params"]), flat(
        bridge.to_tree(state["params"]))
    assert fw.keys() == fg.keys() == fs.keys()
    trained = [k for k in fw if not np.array_equal(fs[k], fw[k])]
    if mode == "peqa":
        assert trained and all(k.endswith("scale") for k in trained)
    else:
        assert {"enc/pos", "dec/pos", "dec/embed/emb"} <= set(trained)
    for key in fw:
        a, b, s0 = fw[key], fg[key], fs[key]
        if key not in trained:
            np.testing.assert_array_equal(b, a, err_msg=key)
            continue
        upd_ref = a.astype(np.float64) - s0
        upd = b.astype(np.float64) - s0
        assert np.linalg.norm(upd - upd_ref) <= \
            1e-3 * np.linalg.norm(upd_ref), key
