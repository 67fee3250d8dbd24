"""PyTorch port: checkpoints of training on a (data, model) mesh, the
training CLI on a mesh, and what training on a mesh refuses.

The mesh config of ``tests/test_torch_dist_train.py`` (``paper_lm(n_layers=2,
d_model=128, n_heads=4, d_ff=256, vocab=512)``, PEQA 4-bit, float32), its
weights built by the reference; gloo ranks on the CPU.

  * ``loop.train`` at (1, 2) writes its checkpoint at step 2 — the whole
    state, gathered over the model axis, in the reference's format: the
    reference's ``CheckpointManager`` restores it, its codes are the start's
    bit for bit, and its scales and moments are the port's unsharded run's
    within 1e-4 in ℓ2.  Restored off the mesh and at (2, 2), the next step's
    loss is the (1, 2) run's own next step within rtol 1e-5 (float32 sums
    in another order); a checkpoint written off the mesh restores at (2, 1)
    likewise.
  * ``python -m repro_torch.launch.train --device cpu --tiny --mesh 1,2``
    twice on one checkpoint directory: the second run resumes at step 12,
    and the first run's step-1 loss is the ``--mesh none`` run's within
    rtol 1e-5.
  * The refusals, each with its reason: ``--mesh pod`` / ``multipod`` (the
    reference's TPU pod shapes), ``lora_optq`` on MoE (no OPTQ backbone,
    as off the mesh), an arch whose heads the
    model axis does not divide (xlstm-125m at M 3), a global batch the
    data axis does not divide, ``remat="dots"``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
from repro.optim.adamw import make_optimizer as jmake_optimizer
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, TrainConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.dist import backend, context
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop, step

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from test_torch_dist_train import OCFG, _batches, _cfgs, _named
from test_torch_train import _port_run
from _torch_threads import _one_torch_thread  # noqa: F401


CPU = ["--device", "cpu", "--tiny", "--batch", "4", "--seq", "32"]


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = _cfgs("peqa_block")
    rng = jax.random.PRNGKey(0)
    params, jmask = jpolicies.prepare(jregistry.build(jcfg).init(rng), jcfg,
                                      rng)
    start = to_numpy(params)
    batches = _batches() + [_batches()[0]]      # 4 global batches
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    ranks.save_tree(os.path.join(tmp, "start.npz"), start)
    on_mesh, off_mesh = os.path.join(tmp, "mesh"), os.path.join(tmp, "off")
    # written at (1, 2) after 2 steps; then its own 3rd step
    backend.spawn(ranks.ckpt_rank, 2, "cpu", (1, 2), tmp, tcfg, OCFG,
                  batches, on_mesh, 2, 1, threads=1)
    written = torch.load(os.path.join(tmp, "ckpt1x2_0.pt"),
                         weights_only=False)
    whole = JManager(on_mesh).restore(
        {"params": params,
         "opt": jmake_optimizer(JOptim(**OCFG), 10).init(params, jmask),
         "step": np.int32(0)})
    # the port's unsharded run: 2 steps, then the checkpoint restored off
    # the mesh and its 3rd step
    _, _, _, unsharded = _port_run(tcfg, start, batches[:2], OCFG)
    _, _, _, state = _port_run(tcfg, start, [], OCFG)
    tree, extra = CheckpointManager(on_mesh).restore(
        bridge.state_to_tree(state))
    state = bridge.load_state(state, tree)
    api = registry.build(tcfg, device="cpu")
    tc = TrainConfig(steps=2, ckpt_every=10 ** 6, optim=OptimConfig(**OCFG))

    def step_fn(st):
        return step.build_train_step(
            api, tcfg, tc, policies.make_mask(st["params"], tcfg),
            make_optimizer(OptimConfig(**OCFG), 10))
    off = float(step_fn(state)(state, batches[2])[1]["loss"])
    # restored at (2, 2): its 3rd step
    backend.spawn(ranks.ckpt_rank, 4, "cpu", (2, 2), tmp, tcfg, OCFG,
                  batches, on_mesh, 3, 0, threads=1)
    at22 = torch.load(os.path.join(tmp, "ckpt2x2_0.pt"), weights_only=False)
    # a checkpoint written off the mesh (2 steps), restored at (2, 1)
    _, _, _, st = _port_run(tcfg, start, [], OCFG)
    loop.train(st, step_fn(st), ranks._Batches(batches), tc,
               ckpt_dir=off_mesh, log=lambda m: None)
    backend.spawn(ranks.ckpt_rank, 2, "cpu", (2, 1), tmp, tcfg, OCFG,
                  batches, off_mesh, 3, 0, threads=1)
    at21 = torch.load(os.path.join(tmp, "ckpt2x1_0.pt"), weights_only=False)
    return {"start": start, "tcfg": tcfg, "written": written, "whole": whole,
            "extra": extra, "unsharded": unsharded, "off": off,
            "at22": at22, "at21": at21}


def test_mesh_checkpoint_is_the_reference_format(run):
    tree, extra = run["whole"]
    assert extra["step"] == run["extra"]["step"] == 2
    assert int(tree["step"]) == 2 and int(tree["opt"]["count"]) == 2
    tcfg = run["tcfg"]
    got = _named(jax.tree.map(np.asarray, tree["params"]), tcfg)
    start = _named(run["start"], tcfg)
    want = run["unsharded"]
    params = dict((*want["params"].named_parameters(),
                   *want["params"].named_buffers()))
    for n, t in got.items():
        if n.endswith("qw"):
            assert torch.equal(t, start[n]), n           # codes unchanged
        elif not torch.equal(params[n].detach(), start[n]):   # trained
            upd = t.double() - start[n].double()
            upd_ref = params[n].detach().double() - start[n].double()
            assert torch.linalg.norm(upd - upd_ref) <= \
                1e-4 * torch.linalg.norm(upd_ref), n
        else:
            assert torch.equal(t, start[n]), n
    moments = _flat(tree["opt"]["mv"])
    for n, (m, v) in want["opt"]["mv"].items():
        path = bridge.ref_path(n).strip("/")
        for i, ref in enumerate((m, v)):
            arr = moments[f"{path}/{i}"]
            got_m = torch.from_numpy(np.asarray(bridge._layer(arr, n)))
            assert torch.linalg.norm((got_m - ref).double()) <= \
                1e-4 * torch.linalg.norm(ref.double()), (n, i)


@pytest.mark.parametrize("where", ["off_mesh", "2x2", "2x1_from_off_mesh"])
def test_checkpoint_next_step_loss(run, where):
    own = run["written"]["after"][0]           # (1, 2)'s own 3rd step
    assert [h["step"] for h in run["written"]["hist"]] == [1, 2]
    if where == "off_mesh":
        got = run["off"]
    else:
        res = run["at22" if where == "2x2" else "at21"]
        assert "[train] resumed from checkpoint step 2" in res["logs"]
        assert [h["step"] for h in res["hist"]] == [3] and res["step"] == 3
        got = res["hist"][0]["loss"]
    np.testing.assert_allclose(got, own, rtol=1e-5)


def test_cli_mesh_resumes_and_matches_off_mesh(tmp_path):
    ckpt = str(tmp_path / "run")
    _, hist = launch_train.main([*CPU, "--mesh", "1,2", "--steps", "12",
                                 "--ckpt-dir", ckpt])
    assert [h["step"] for h in hist] == [1, 10]
    assert hist[-1]["loss"] < hist[0]["loss"]
    _, again = launch_train.main([*CPU, "--mesh", "1,2", "--steps", "14",
                                  "--ckpt-dir", ckpt])
    assert [h["step"] for h in again] == [13]    # resumed at step 12
    _, none = launch_train.main([*CPU, "--steps", "12"])
    np.testing.assert_allclose(hist[0]["loss"], none[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(hist[0]["grad_norm"], none[0]["grad_norm"],
                               rtol=1e-5)


@pytest.mark.parametrize("argv,reason", [
    (["--mesh", "pod"], "256 devices"),
    (["--mesh", "multipod"], "512 devices"),
    (["--mesh", "1,2", "--mode", "lora_optq", "--arch",
      "deepseek-moe-16b"], "lora_optq on MoE: the reference's GPTQ"),
    (["--mesh", "1,3", "--arch", "xlstm-125m"], "n_heads=4 is not "
                                                "divisible by the model "
                                                "axis (3)"),
    (["--mesh", "3,1"], "global batch of 4 rows is not divisible by the "
                        "data axis (3)"),
], ids=["pod", "multipod", "arm", "family", "batch"])
def test_cli_mesh_refusals(argv, reason):
    with pytest.raises(SystemExit) as exc:
        launch_train.main([*CPU, *argv])
    assert reason in str(exc.value.code)


def test_training_refusals_name_what_is_not_ported():
    cfg = tconfigs.paper_lm(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                            vocab=512).replace(
        tuning=TuningConfig(mode="peqa"))
    mesh = context.coords(2, 2)
    registry.check_supported(cfg, mesh=mesh, train=True, batch=4)
    with pytest.raises(NotImplementedError,
                       match=r"not trained on a \(2, 2\) mesh: remat='dots'"):
        registry.check_supported(cfg.replace(remat="dots"), mesh=mesh,
                                 train=True)
    registry.check_supported(cfg.replace(remat="dots"), mesh=mesh)  # serves
    with pytest.raises(NotImplementedError, match="global batch of 6"):
        registry.check_supported(cfg, mesh=context.coords(4, 1), batch=6)
