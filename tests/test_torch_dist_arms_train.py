"""PyTorch port vs JAX reference: the comparison arms (``lora``,
``lora_optq``, ``qat``) trained on a (data, model) mesh.

The cases of ``tests/test_torch_dist_arms.py`` (tiny ``paper_lm`` under QV4
and QKVO16, tiny granite-34b with its one KV head under QKVO16; every
``lora_b`` drawn at random so that ``lora_a``'s gradient is not zero),
remat "block".  The port's gloo ranks (``_torch_dist_ranks.py::
train_cases``, one spawn a mesh, one intra-op thread) cut their shard of
the whole train state at (1, 1), (1, 2), (2, 2) and (1, 4) and take one
step on a 4 × 16 batch.

  * At (1, 1) the loss is bit-equal to the port's unsharded ``loss_fn``
    on the same batch, and every trained gradient within 1e-5 of its
    ``backward()``'s in ℓ2 (the vocab-parallel cross entropy's backward is
    another formula of the same gradient, rounded its own way).
  * At M > 1 the loss and every trained gradient (the model-partial ones
    — a column-parallel ``lora_a``, ``wo``'s ``lora_b``, a shared KV
    head's ``lora_b``, QAT's row-parallel scales and zeros — summed over
    the model axis, all over the data axis, reassembled from the model
    ranks) against the reference's ``jax.value_and_grad`` of its
    unsharded ``loss_fn`` on the same global batch: the loss rtol 1e-5,
    each gradient leaf within 1e-4 of the reference's in ℓ2, the step's
    ``grad_norm`` rtol 1e-4 of the reference gradient's norm (each leaf
    counted once).
  * The step's collective record: all-reduces only, their count on each
    axis ``step.mesh_collectives``' and the numbers written out here (the
    arms add none to the forward's row-parallel sums; the partial bucket
    is there for every arm).
  * The whole-state tree gathered after the step (``whole_tree``) cut
    again (``load_shard``) gives each rank's shard back bit for bit; cut
    at another model axis (in process) it puts back together to itself;
    it loads off the mesh.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpolicies  # noqa: F401  (tree())
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs.base import OptimConfig
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import backend, context, sharding
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train.state import load_shard, make_state

import _torch_dist_ranks as ranks
from test_torch_dist_arms import CASES, MESHES, SPLIT, cfgs, tree
from _torch_threads import _one_torch_thread  # noqa: F401


B, S = 4, 16
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
CASE_MESH = [(n, k) for n in CASES for k in SPLIT]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]
# the model-axis all-reduces of one step at L = 2: the forward 2L + 1, the
# recompute L under "block", the backward 2L (+ 1 where the table trains:
# qat), the cross entropy 3, the partial bucket 1, the norm 1
MODEL_REDUCES = {"lora": 16, "lora_optq": 16, "qat": 17}


def _arm(name):
    return cfgs(name)[1].tuning.mode


def _batch(cfg):
    data = pipeline.PackedLM(synthetic.corpus(cfg.vocab_size, 4000, seed=5),
                             B, S)
    return data.batch_at(0)


def _named(t, cfg):
    model = bridge.to_module(t, cfg, device="cpu")
    return {n: x.detach() for n, x in (*model.named_parameters(),
                                       *model.named_buffers())}


def _reference(name, batch):
    """The reference's loss and gradient of a case's tree on the whole
    batch, by port name."""
    jcfg, tcfg = cfgs(name)
    api = jregistry.build(jcfg)
    params = jax.tree.map(jnp.asarray, tree(name))
    loss, g = jax.jit(jax.value_and_grad(api.loss_fn, allow_int=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    g = jax.tree.map(lambda p, d: np.asarray(p) if not np.issubdtype(
        np.asarray(p).dtype, np.floating) else np.asarray(d), params, g)
    return {"loss": float(loss), "grads": _named(g, tcfg)}


def _unsharded(name, batch):
    """The port's unsharded loss and trained gradients."""
    cfg = cfgs(name)[1]
    model = bridge.to_module(tree(name), cfg, device="cpu")
    mask = policies.make_mask(model, cfg)
    api = registry.build(cfg, device="cpu")
    from repro_torch.train.step import to_device
    loss = api.loss_fn(model, to_device(batch, "cpu"))
    loss.backward()
    return {"loss": loss.detach(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if mask[n]}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("armtrain"))
    ref, cases, batches, port = {}, {}, {}, {}
    for name in CASES:
        tcfg = cfgs(name)[1]
        batches[name] = _batch(tcfg)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), tree(name))
        ref[name] = _reference(name, batches[name])
        port[name] = _unsharded(name, batches[name])
        cases[name] = (tcfg, OCFG)
    out = {"ref": ref, "port": port}
    for key, shape in MESHES.items():
        world = shape[0] * shape[1]
        backend.spawn(ranks.train_cases, world, "cpu", shape, tmp, cases,
                      batches, "armtrain", threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"armtrain{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _first(rs):
    return sorted((r for r in rs if r["coords"][0] == 0),
                  key=lambda r: r["coords"][1])


def _unshard(rs, name, what):
    first = _first(rs)
    return sharding.unshard([r[name][what] for r in first],
                            kv_share=first[0][name]["kv_share"])


@pytest.mark.parametrize("name", CASES)
def test_mesh_1x1_matches_unsharded(run, name):
    res, want = run["1x1"][0][name], run["port"][name]
    assert res["loss"] == float(want["loss"])
    assert res["grads"].keys() == want["grads"].keys()
    for n, g in want["grads"].items():
        assert torch.linalg.norm((res["grads"][n] - g).double()) <= \
            1e-5 * torch.linalg.norm(g.double()), n


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_mesh_gradients_match_reference(run, name, key):
    rs, want = run[key], run["ref"][name]
    for r in rs:
        np.testing.assert_allclose(r[name]["loss"], want["loss"], rtol=1e-5)
    grads = _unshard(rs, name, "grads")
    assert grads.keys() == run["port"][name]["grads"].keys()
    kinds = rs[0][name]["kinds"]
    if _arm(name) == "qat":
        assert kinds["layers.0.attn.wo.scale"] == sharding.PARTIAL
    else:
        assert kinds["layers.0.attn.wq.lora_a"] == sharding.PARTIAL
        assert torch.linalg.norm(grads["layers.0.attn.wq.lora_a"]) > 0
    sq = 0.0
    for n, g in grads.items():
        w = want["grads"][n]
        assert g.shape == w.shape, n
        assert torch.linalg.norm((g - w).double()) <= \
            1e-4 * torch.linalg.norm(w.double()) + 1e-12, n
        sq += float((w.double() ** 2).sum())
    for r in rs:
        np.testing.assert_allclose(r[name]["metrics"]["grad_norm"],
                                   np.sqrt(sq), rtol=1e-4)
        np.testing.assert_allclose(r[name]["metrics"]["loss"],
                                   want["loss"], rtol=1e-5)
        assert r[name]["metrics"] == rs[0][name]["metrics"]


@pytest.mark.parametrize("name,key", [(n, k) for n in CASES
                                      for k in MESHES])
def test_mesh_step_collectives(run, name, key):
    for r in run[key]:
        rec, want = r[name]["record"], r[name]["want"]
        assert {e["kind"] for e in rec} == {"all_reduce"}
        counts = {axis: sum(e["axis"] == axis for e in rec)
                  for axis in context.AXES}
        assert counts == want == {"model": MODEL_REDUCES[_arm(name)],
                                  "data": 3}


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_whole_state_checkpoint(run, name, key):
    rs = run[key]
    for r in rs:
        assert r[name]["restored"], r["coords"]
    tree_ = rs[0][name]["tree"]
    cfg = cfgs(name)[1]
    named = _named(tree_["params"], cfg)
    trained = _unshard(rs, name, "trained")
    for n, t in trained.items():
        assert torch.equal(named[n], t), n
    # off the mesh, and cut at another model axis
    model = bridge.to_module(tree(name), cfg, device="cpu")
    mask = policies.make_mask(model, cfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    bridge.load_state(state, tree_)
    assert state["step"] == 1
    whole = dict((*state["params"].named_parameters(),
                  *state["params"].named_buffers()))
    for n, t in whole.items():
        assert torch.equal(t.detach(), named[n]), n
    m = 4 if MESHES[key][1] != 4 else 2
    from repro_torch.train.state import shard_state
    shards = [load_shard(shard_state(state, context.coords(1, m, 0, r), cfg),
                         tree_, context.coords(1, m, 0, r))
              for r in range(m)]
    back = sharding.unshard([s["params"] for s in shards])
    for n, t in back.items():
        assert torch.equal(t, named[n]), n
    mv = [{n: pair[0] for n, pair in s["opt"]["mv"].items()} for s in shards]
    moments = sharding.unshard(mv, kv_share=sharding.kv_share(cfg, m))
    for n, t in moments.items():
        assert torch.equal(t, state["opt"]["mv"][n][0]), n
