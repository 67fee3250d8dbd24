"""The port's checkpoints: the reference's on-disk format, both ways.

``repro_torch.ckpt.checkpoint.CheckpointManager`` writes what
``repro.ckpt.checkpoint.CheckpointManager`` writes (``step_XXXXXXXX/`` with
``manifest.json`` and ``arrays.npz`` under the reference's flattened
names), and the port's train state goes in and out of it through
``bridge.state_to_tree`` / ``bridge.load_state``.  Checked: a round trip,
a torn write skipped, keep-k, async save, a reference checkpoint restored
into the port and a port checkpoint into the reference (every array
equal), and a resumed ``train.loop.train`` run whose losses equal an
uninterrupted one's bit for bit (the batches are a function of the step,
and the state is restored exactly); the same both ways for the comparison
arms' leaves (``lora``, ``lora_optq``, ``qat``), and a resumed LoRA run.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import TrainConfig as JTrain
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.train import step as jstep
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, TrainConfig
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop, step
from repro_torch.train.state import make_state

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


OCFG = dict(lr=1e-3, warmup_steps=1)


def _batches(vocab, n=4):
    data = pipeline.PackedLM(synthetic.corpus(vocab, 1500, seed=2), 2, 16)
    return data, [data.batch_at(i) for i in range(n)]


def _port_state(tcfg, tree):
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    return api, mask, opt, state


def _reference_state(jcfg, batch):
    """The reference's PEQA state after one train step (moments non-zero)."""
    fp, _ = reference_params(jcfg)
    params, mask = jpolicies.prepare(fp, jcfg)
    start = to_numpy(params)
    opt = jmake_optimizer(JOptim(**OCFG), 10)
    state = {"params": params, "opt": opt.init(params, mask),
             "step": jnp.int32(0)}
    ts = jstep.build_train_step(jregistry.build(jcfg), jcfg,
                                JTrain(optim=JOptim(**OCFG)), mask, opt)
    state, _ = ts(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return start, state


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=str(path))


def _trained_port_state(tmp_path=None):
    jcfg, tcfg = tiny_llama_pair("peqa")
    _, jq = reference_params(jcfg)
    api, mask, opt, state = _port_state(tcfg, to_numpy(jq))
    _, batches = _batches(tcfg.vocab_size)
    ts = step.build_train_step(api, tcfg, TrainConfig(
        optim=OptimConfig(**OCFG)), mask, opt)
    state, _ = ts(state, batches[0])
    return jcfg, tcfg, state


def test_round_trip_keep_k_and_async(tmp_path):
    _, _, state = _trained_port_state()
    tree = bridge.state_to_tree(state)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"note": "x"})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "step_00000003")) == \
        ["arrays.npz", "manifest.json"]
    out, extra = mgr.restore(tree)
    assert extra == {"note": "x", "step": 3}
    _assert_trees_equal(tree, out)
    # into a fresh state: every tensor and moment back, in place
    _, tcfg = tiny_llama_pair("peqa")
    fresh = _port_state(tcfg, tree["params"])[3]
    bridge.load_state(fresh, out)
    _assert_trees_equal(tree, bridge.state_to_tree(fresh))
    assert fresh["step"] == 1 and int(fresh["opt"]["count"]) == 1


def test_torn_write_is_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"a": np.arange(6, dtype=np.float32), "b": [torch.ones(3)]}
    mgr.save(1, tree)
    mgr.save(2, tree)
    with open(tmp_path / "step_00000002" / "arrays.npz", "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    assert mgr.latest_valid_step() == 1
    out, extra = mgr.restore(tree)
    assert extra["step"] == 1
    np.testing.assert_array_equal(out["b"][0], np.ones(3, np.float32))
    (tmp_path / "step_00000003.tmp").mkdir()      # a write cut before rename
    assert mgr.all_steps() == [1, 2]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jcfg, tcfg = tiny_llama_pair("peqa")
    _, batches = _batches(tcfg.vocab_size)
    start, jstate = _reference_state(jcfg, batches[0])
    JManager(str(tmp_path)).save(1, jstate)
    _, _, _, state = _port_state(tcfg, start)
    restored, extra = CheckpointManager(str(tmp_path)).restore(
        bridge.state_to_tree(state))
    bridge.load_state(state, restored)
    assert extra["step"] == 1
    _assert_trees_equal(to_numpy(jstate), bridge.state_to_tree(state))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jcfg, _, state = _trained_port_state()
    CheckpointManager(str(tmp_path)).save(1, bridge.state_to_tree(state))
    _, batches = _batches(jcfg.vocab_size)
    _, jlike = _reference_state(jcfg, batches[1])
    restored, extra = JManager(str(tmp_path)).restore(jlike)
    assert extra["step"] == 1
    _assert_trees_equal(bridge.state_to_tree(state), restored)


@pytest.mark.parametrize("compression", [None, "int8"])
def test_resumed_run_equals_uninterrupted(tmp_path, compression):
    jcfg, tcfg = tiny_llama_pair("peqa")
    _, jq = reference_params(jcfg)
    data, _ = _batches(tcfg.vocab_size)
    ocfg = OptimConfig(grad_compression=compression, **OCFG)

    def run(steps, ckpt_dir):
        api, mask, opt, state = _port_state(tcfg, to_numpy(jq))
        tc = TrainConfig(steps=steps, log_every=1, ckpt_every=2, optim=ocfg)
        ts = step.build_train_step(api, tcfg, tc, mask, opt)
        return loop.train(state, ts, data, tc, ckpt_dir=ckpt_dir,
                          log=lambda msg: None)

    _, whole = run(5, None)
    run(3, str(tmp_path))                         # "crashes" after step 3
    state, resumed = run(5, str(tmp_path))        # resumes from step 3
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[3:]]
    assert state["step"] == 5
    assert CheckpointManager(str(tmp_path)).all_steps()[-1] == 5


@pytest.mark.parametrize("mode", ["lora", "lora_optq", "qat"])
def test_arm_checkpoint_round_trip_both_ways(tmp_path, mode):
    """A reference checkpoint of a comparison arm after one train step
    (moments non-zero: the adapter's, or QAT's for every float tensor) —
    lora_a/lora_b beside w or beside qw/scale/zero, QAT's w + scale + zero
    in one subtree — restored into the port, and the port's written back
    and restored into the reference: every array equal."""
    jcfg, tcfg = tiny_llama_pair(mode)
    _, batches = _batches(tcfg.vocab_size)
    start, jstate = _reference_state(jcfg, batches[0])
    JManager(str(tmp_path / "ref")).save(1, jstate)
    _, mask, _, state = _port_state(tcfg, start)
    restored, extra = CheckpointManager(str(tmp_path / "ref")).restore(
        bridge.state_to_tree(state))
    bridge.load_state(state, restored)
    assert extra["step"] == 1
    _assert_trees_equal(to_numpy(jstate), bridge.state_to_tree(state))
    names = set(state["opt"]["mv"])
    leaves = {"lora": {"lora_a", "lora_b"}, "lora_optq": {"lora_a", "lora_b"},
              "qat": {"w", "scale", "zero", "g", "emb"}}[mode]
    assert names and {n.rsplit(".", 1)[-1] for n in names} == leaves
    CheckpointManager(str(tmp_path / "port")).save(
        1, bridge.state_to_tree(state))
    back, extra = JManager(str(tmp_path / "port")).restore(jstate)
    assert extra["step"] == 1
    _assert_trees_equal(bridge.state_to_tree(state), back)


@pytest.mark.parametrize("mode", ["lora", "lora_optq"])
def test_resumed_lora_run_equals_uninterrupted(tmp_path, mode):
    """A LoRA arm's run resumed from its checkpoint (the adapter and its
    moments) gives the uninterrupted run's losses bit for bit."""
    jcfg, tcfg = tiny_llama_pair(mode)
    _, tree = reference_params(jcfg)
    data, _ = _batches(tcfg.vocab_size)
    ocfg = OptimConfig(**OCFG)

    def run(steps, ckpt_dir):
        api, mask, opt, state = _port_state(tcfg, to_numpy(tree))
        tc = TrainConfig(steps=steps, log_every=1, ckpt_every=2, optim=ocfg)
        ts = step.build_train_step(api, tcfg, tc, mask, opt)
        return loop.train(state, ts, data, tc, ckpt_dir=ckpt_dir,
                          log=lambda msg: None)

    whole_state, whole = run(5, None)
    run(3, str(tmp_path))
    state, resumed = run(5, str(tmp_path))
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[3:]]
    _assert_trees_equal(bridge.state_to_tree(whole_state),
                        bridge.state_to_tree(state))


def test_watchdog_flags_a_slow_step():
    hung = []
    wd = loop.Watchdog(0.05, on_hang=hung.append)
    try:
        wd.step_begin()
        import time
        time.sleep(0.2)
        wd.step_end()
    finally:
        wd.close()
    assert hung and wd.slowest >= 0.2
