"""PyTorch port vs JAX reference: the launchers (``repro_torch.launch.serve``,
``repro_torch.launch.train``), run in-process on the CPU.

  * ``mixed_workload`` and ``family_workload`` give the reference's
    requests for every family;
  * ``--continuous`` exits 0 under every scheduler (speculative on
    ``--layout plane``), over each traffic kind; ``--mesh 1,2 --device
    cpu`` serves on two gloo ranks (continuous, and lockstep under
    ``--no-logitshard``), what the mesh cannot serve and
    ``REPRO_FAKE_DEVICES`` are refused with a clear ``SystemExit``; the
    tuning restores the backbone;
  * ``launch.train`` (``--tiny``): the loss falls over 12 steps, a second
    run resumes from the checkpoint, the reference's ``CheckpointManager``
    restores that checkpoint, ``--grad-compression int8`` runs, a vlm and
    an encdec reach their eval with prefixed eval batches, and a mesh is
    refused.

The family smoke (``--family-smoke``) is tests/test_torch_launch_families.py.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.optim.adamw import make_optimizer as jmake_optimizer
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core.scale_bank import ScaleBank
from repro_torch.dist import context
from repro_torch.launch import serve, train

from test_torch_ckpt import _assert_trees_equal
from _torch_threads import _one_torch_thread  # noqa: F401


CPU = ["--device", "cpu"]


def _exact(reqs):
    return [(r.tokens.dtype.str, r.tokens.tobytes(), r.n_new, r.task,
             r.arrival_step, r.arrival_s, r.eos_id,
             None if r.prefix is None else (r.prefix.shape,
                                            r.prefix.tobytes()))
            for r in reqs]


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_family_workload_equals_reference(arch):
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch))
    jcfg = jconfigs.make_tiny(jconfigs.get_config(arch))
    for seed in (11, 12):
        assert _exact(serve.family_workload(cfg, seed)) == \
            _exact(jserve.family_workload(jcfg, seed))


@pytest.mark.parametrize("tasks,batch,n_new,n,vocab", [
    (["taskA", "taskB"], 4, 16, 12, 512), (["a", "b", "c"], 3, 3, 10, 7),
    ([None], 8, 2, 24, 128256)])
def test_mixed_workload_equals_reference(tasks, batch, n_new, n, vocab):
    assert _exact(serve.mixed_workload(tasks, batch, n_new, n, vocab)) == \
        _exact(jserve.mixed_workload(tasks, batch, n_new, n, vocab))


# -------------------------------------------------------- launch.serve CLI

def _serve_main(*flags):
    with pytest.raises(SystemExit) as exc:
        serve.main([*CPU, "--tune-steps", "2", "--continuous", *flags])
    return exc.value.code


@pytest.mark.parametrize("flags", [
    ["--scheduler", "auto"],
    ["--scheduler", "resident", "--traffic", "poisson"],
    ["--scheduler", "drain", "--traffic", "trace"],
    ["--scheduler", "speculative", "--layout", "plane", "--traffic",
     "poisson"]], ids=["auto", "resident", "drain", "speculative"])
def test_serve_continuous_exits_zero(flags, capsys):
    assert _serve_main(*flags) == 0
    out = capsys.readouterr().out
    assert "[serve] continuous OK" in out
    if "speculative" in flags:
        assert "speculative == greedy" in out


def test_serve_tiered_bank(tmp_path, capsys):
    """``--bank-root``: the tuned sets persist as npz and the serve goes
    through the re-opened tiered bank (host LRU of one task)."""
    root = str(tmp_path / "bank")
    assert _serve_main("--traffic", "poisson", "--scheduler", "resident",
                       "--bank-root", root, "--host-cache", "1") == 0
    out = capsys.readouterr().out
    assert "tiered bank: 2 tasks indexed" in out and "[serve] tiers:" in out
    assert sorted(ScaleBank(root).tasks) == ["taskA", "taskB"]


def test_serve_lockstep_path(capsys):
    serve.main([*CPU, "--tune-steps", "2", "--n-new", "4"])
    out = capsys.readouterr().out
    assert out.count("switch=") == 4 and "tuned taskB" in out


@pytest.mark.parametrize("argv,env,why", [
    (["--mesh", "1,3"], None, "n_heads=4 is not divisible by the model "
                              "axis (3)"),
    (["--mesh", "1,2", "--no-logitshard", "--family-smoke"], None,
     "--family-smoke runs off the mesh"),
    ([], "8", "--device cpu --mesh D,M")],
    ids=["mesh", "no-logitshard", "fake-devices"])
def test_serve_mesh_flags_refused(argv, env, why, monkeypatch):
    """What the mesh flags still refuse, with a reason: a mesh the config
    does not split over, the family smoke on a mesh, and the fake-device
    variable (one process a rank: it points at ``--mesh``)."""
    if env is not None:
        monkeypatch.setenv("REPRO_FAKE_DEVICES", env)
    with pytest.raises(SystemExit) as exc:
        serve.main([*CPU, *argv])
    assert why in str(exc.value.code)


@pytest.mark.parametrize("flags,want", [
    (["--continuous", "--scheduler", "resident"], "[serve] continuous OK"),
    (["--no-logitshard", "--n-new", "4"], "switch=")],
    ids=["continuous", "no-logitshard"])
def test_serve_on_a_cpu_mesh(flags, want, capfd):
    """``--mesh 1,2 --device cpu``: two gloo ranks serve their shards; the
    continuous run passes its gates on every rank, the lockstep loop runs
    each task twice with the logits gathered."""
    args = [*CPU, "--mesh", "1,2", "--tune-steps", "2", *flags]
    if "--continuous" in flags:
        with pytest.raises(SystemExit) as exc:
            serve.main(args)
        assert exc.value.code in (0, None)
    else:
        serve.main(args)
    out = capfd.readouterr().out
    assert "2 ranks over gloo on cpu" in out and want in out
    assert "a swap moves" in out
    if "--no-logitshard" in flags:
        assert out.count("switch=") == 4


def test_serve_moe_on_a_cpu_mesh(capfd):
    """``--tiny --mesh 1,2 --arch mixtral-8x7b``: two gloo ranks serve
    their d_ff shards of every expert in drain mode (an MoE model has no
    slotted step) and pass the continuous gates."""
    with pytest.raises(SystemExit) as exc:
        serve.main([*CPU, "--mesh", "1,2", "--arch", "mixtral-8x7b",
                    "--continuous", "--scheduler", "drain", "--tune-steps",
                    "2"])
    assert exc.value.code in (0, None)
    out = capfd.readouterr().out
    assert "2 ranks over gloo on cpu" in out and "a swap moves" in out
    assert "[serve] continuous OK" in out


def test_serve_whisper_on_a_cpu_mesh(capfd):
    """``--tiny --mesh 1,2 --arch whisper-medium --continuous``: the tasks
    tuned on frame-prefixed batches, then two gloo ranks serve their
    shards a stream whose every request carries its encoder frames (drain:
    an encdec has no slotted step) and pass the continuous gates."""
    with pytest.raises(SystemExit) as exc:
        serve.main([*CPU, "--mesh", "1,2", "--arch", "whisper-medium",
                    "--continuous", "--tune-steps", "2"])
    assert exc.value.code in (0, None)
    out = capfd.readouterr().out
    assert "2 ranks over gloo on cpu" in out and "a swap moves" in out
    assert "continuous[drain]" in out and "[serve] continuous OK" in out


def test_place_prompt_off_mesh_only():
    """Off the mesh the prompt itself; on a mesh a rank's data block of
    rows (every row where the batch does not divide the data axis)."""
    prompt = np.arange(32, dtype=np.int32).reshape(4, 8)
    assert serve.place_prompt(prompt) is prompt
    for d in range(2):
        got = serve.place_prompt(prompt, ctx=context.coords(2, 2, d, 1))
        assert torch.equal(got, torch.from_numpy(prompt[2 * d:2 * d + 2]))
    got = serve.place_prompt(prompt[:3], ctx=context.coords(2, 1, 1))
    assert got.shape == (3, 8)


def test_tiny_cannot_be_turned_off():
    """As in the reference (``store_true`` with ``default=True``)."""
    assert serve.parse_args([]).tiny is True


def test_tuning_restores_the_backbone():
    args = serve.parse_args(CPU)
    cfg, api, backbone, mask = serve.build_model(args)
    before = {n: t.clone() for n, t in backbone.state_dict().items()}
    bank = ScaleBank()
    losses = serve.tune_tasks(api, backbone, mask, ["t0", "t1"], 3, bank,
                              log=lambda m: None)
    after = backbone.state_dict()
    assert all(torch.equal(before[n], after[n]) for n in before)
    assert sorted(losses) == ["t0", "t1"]
    a, b = bank.tasks["t0"], bank.tasks["t1"]
    assert any(not np.array_equal(a[k], b[k]) for k in a)


# -------------------------------------------------------- launch.train CLI

TRAIN = [*CPU, "--tiny", "--batch", "4", "--seq", "32"]


def _reference_like(mode="peqa"):
    """The reference's train state for the tiny config (structure only)."""
    jcfg = jconfigs.make_tiny(jconfigs.get_config("llama3.2-1b")).replace(
        tuning=JTuning(mode=mode), quant=JQuant(bits=4, group_size=None))
    rng = jax.random.PRNGKey(0)
    params, mask = jpolicies.prepare(
        jregistry.build(jcfg).init(rng), jcfg, rng)
    opt = jmake_optimizer(JOptim(), 12)
    return {"params": params, "opt": opt.init(params, mask),
            "step": jnp.int32(0)}


def test_train_loss_falls_resumes_and_crosses_to_reference(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    state, hist = train.main([*TRAIN, "--steps", "12", "--ckpt-dir", ckpt])
    assert [h["step"] for h in hist] == [1, 10]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    restored, extra = JManager(ckpt).restore(_reference_like())
    assert extra["step"] == 12
    _assert_trees_equal(bridge.state_to_tree(state), restored)
    capsys.readouterr()
    state2, hist2 = train.main([*TRAIN, "--steps", "14", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "[train] resumed from checkpoint step 12" in out
    assert [h["step"] for h in hist2] == [13]
    assert np.isfinite(hist2[0]["loss"]) and state2["step"] == 14


def test_train_int8_grad_compression(capsys):
    _, hist = train.main([*TRAIN, "--steps", "3", "--grad-compression",
                          "int8"])
    assert np.isfinite(hist[0]["loss"])
    assert "final loss=" in capsys.readouterr().out


def test_train_moe_on_a_cpu_mesh(tmp_path, capsys):
    """``--tiny --mesh 1,2 --arch deepseek-moe-16b``: two gloo ranks train
    their expert shards; the loss is finite and the checkpoint written."""
    ckpt = str(tmp_path / "moe")
    _, hist = train.main([*TRAIN, "--mesh", "1,2", "--arch",
                          "deepseek-moe-16b", "--steps", "3", "--ckpt-dir",
                          ckpt])
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    assert JManager(ckpt).latest_valid_step() == 3


def test_train_llava_on_a_cpu_mesh(tmp_path, capsys):
    """``--tiny --mesh 1,2 --arch llava-next-mistral-7b --steps 4``: two
    gloo ranks train their shards on batches with seeded image-embedding
    prefixes; the loss is finite and the checkpoint written."""
    ckpt = str(tmp_path / "llava")
    _, hist = train.main([*TRAIN, "--mesh", "1,2", "--arch",
                          "llava-next-mistral-7b", "--steps", "4",
                          "--ckpt-dir", ckpt])
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    assert JManager(ckpt).latest_valid_step() == 4


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-medium"])
def test_train_prefixed_family_reaches_eval(arch, monkeypatch, capsys):
    """``launch.train --tiny`` of a family with prefix state reaches its
    eval (every 2 steps here, over every eval batch of the held-out split,
    each behind its own seeded prefix): the eval loss is finite."""
    monkeypatch.setattr(train, "TrainConfig",
                        functools.partial(train.TrainConfig, eval_every=2))
    _, hist = train.main([*TRAIN, "--arch", arch, "--steps", "2"])
    out = capsys.readouterr().out
    evals = re.findall(r"step 2 eval_loss=(\S+)", out)
    assert len(evals) == 1 and np.isfinite(float(evals[0]))
    assert hist and np.isfinite(hist[0]["loss"])


@pytest.mark.parametrize("mesh", ["debug", "pod", "multipod"])
def test_train_mesh_refused(mesh):
    """What training on a mesh still refuses: the reference's TPU pod
    meshes, and a global batch the debug mesh's data axis (2) does not
    divide (``tests/test_torch_dist_train_ckpt.py`` trains on meshes)."""
    with pytest.raises(SystemExit) as exc:
        train.main([*TRAIN, "--batch", "3", "--mesh", mesh])
    assert {"debug": "global batch of 3 rows is not divisible by the data "
                     "axis (2)",
            "pod": "(16, 16) ('data', 'model'): 256 devices",
            "multipod": "(2, 16, 16) ('pod', 'data', 'model'): 512 devices",
            }[mesh] in str(exc.value.code)
