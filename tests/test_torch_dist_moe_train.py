"""PyTorch port vs JAX reference: PEQA and full training of the moe family
on a (data, model) mesh — deepseek-moe-16b's experts sharded whole
(``"expert"``) and mixtral-8x7b's d_ff sharded (``"tensor"``).

Configurations: ``make_tiny`` of both (2 layers, d_model 64; deepseek 8
experts and one shared expert, mixtral 4 experts), 4 bits, float32, in
five cases: PEQA under remat "block" and "none", ``full`` (the router
trains) under both, and deepseek on 4 bit-planes.  The reference builds
the weights; the port's gloo ranks (``_torch_dist_ranks.py::
moe_train_rank``, one intra-op thread each) cut their shard of the whole
train state at (1, 2), (1, 4) and (2, 2) — the plane case at (1, 2) and
(2, 2): a quarter of the shared expert's d_ff is not whole 32-code words —
and take one step on a 4 × 16 batch with no mask.

  * The loss and every trained gradient (the model-partial ones summed
    over the model axis, all over the data axis, reassembled from the
    model ranks) against the reference's ``jax.value_and_grad`` of its
    unsharded ``loss_fn`` — at data 1 on the whole batch, at data 2 the
    mean over the two data blocks (each block's capacity and aux loss, as
    the reference's sharded block; every row keeps all its tokens, so the
    global token mean is the blocks' mean): the loss rtol 1e-5, each
    gradient leaf within 1e-4 of the reference's in ℓ2, the step's
    ``grad_norm`` rtol 1e-4 of the reference gradient's norm.  The
    router's gradient under ``full`` is held like every other leaf: the
    aux term is counted once, not M times.
  * The step's collective record: all-reduces only, their count on each
    axis ``step.mesh_collectives``' and the numbers written out here for
    L = 2; the codes bit-equal to where they started; every rank's
    metrics equal.
  * The whole-state tree gathered after the step (``whole_tree``) holds
    the start's codes bit for bit (a plane expert stack gathered on E)
    and the reassembled trained leaves; cut again (``load_shard``) it
    gives each rank's shard back bit for bit; it loads off the mesh.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import backend, context, sharding

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


B, S = 4, 16
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
# name: (arch, mode, remat, layout)
CASES = {
    "deepseek_peqa_block": ("deepseek-moe-16b", "peqa", "block", "nibble"),
    "deepseek_full_none": ("deepseek-moe-16b", "full", "none", "nibble"),
    "deepseek_plane_none": ("deepseek-moe-16b", "peqa", "none", "plane"),
    "mixtral_peqa_none": ("mixtral-8x7b", "peqa", "none", "nibble"),
    "mixtral_full_block": ("mixtral-8x7b", "full", "block", "nibble"),
}
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
# the model-axis all-reduces of one step at L = 2, as for the dense family:
# forward 2L + 1 (one a block for attention, one for the MoE block's routed
# and shared sums together, the lookup's), the recompute L under "block",
# the backward 2L (+ 1 where the table trains: full), the cross entropy 3,
# the partial bucket 1 (PEQA: the row-parallel scales; full: the router),
# the norm 1
MODEL_REDUCES = {"deepseek_peqa_block": 16, "deepseek_full_none": 15,
                 "deepseek_plane_none": 14, "mixtral_peqa_none": 14,
                 "mixtral_full_block": 17}


def _meshes(name):
    return ["1x2", "2x2"] if CASES[name][3] == "plane" else list(MESHES)


CASE_MESH = [(n, k) for n in CASES for k in _meshes(n)]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]


def _cfgs(name):
    arch, mode, remat, layout = CASES[name]
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode),
        quant=JQuant(bits=4, n_grid=2, layout=layout), remat=remat)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode),
        quant=QuantConfig(bits=4, n_grid=2, layout=layout), remat=remat)
    return j, t


def _batch(vocab):
    data = pipeline.PackedLM(synthetic.corpus(vocab, 4000, seed=5), B, S)
    return data.batch_at(0)


def _named(tree, cfg):
    model = bridge.to_module(tree, cfg, device="cpu")
    return {n: t.detach() for n, t in (*model.named_parameters(),
                                       *model.named_buffers())}


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The reference's float32 weights of an arch's tiny config (its mode,
    layout and remat do not change them)."""
    jcfg, _ = _cfgs(next(n for n, c in CASES.items() if c[0] == arch))
    return jregistry.build(jcfg).init(jax.random.PRNGKey(1))


def _reference(jcfg, tcfg, batch):
    """The reference's start tree and, for a data axis of 1 and of 2, its
    loss and gradient on the batch — over 2, the mean over the two data
    blocks — by port name."""
    api = jregistry.build(jcfg)
    params, _ = jpolicies.prepare(_init(tcfg.name[len("tiny-"):]), jcfg,
                                  jax.random.PRNGKey(1))
    grad_fn = jax.jit(jax.value_and_grad(api.loss_fn, allow_int=True))
    out = {}
    for n_data in (1, 2):
        losses, grads = [], []
        for d in range(n_data):
            rows = slice(d * B // n_data, (d + 1) * B // n_data)
            loss, g = grad_fn(params, {k: jnp.asarray(v[rows])
                                       for k, v in batch.items()})
            losses.append(float(loss))
            grads.append(g)
        # integer leaves get float0 gradients: put the codes back so the
        # tree converts, and compare the float leaves only
        mean = jax.tree.map(
            lambda p, *gs: np.asarray(p) if not np.issubdtype(
                np.asarray(p).dtype, np.floating)
            else np.mean([np.asarray(g) for g in gs], axis=0),
            params, *grads)
        out[n_data] = {"loss": float(np.mean(losses)),
                       "grads": _named(mean, tcfg)}
    return to_numpy(params), out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moetrain"))
    ref, cases = {}, {}
    for name in CASES:
        jcfg, tcfg = _cfgs(name)
        start, by_data = _reference(jcfg, tcfg, _batch(tcfg.vocab_size))
        for n_data, want in by_data.items():
            ref[(name, n_data)] = want
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), start)
        ref[name] = {"start": _named(start, tcfg), "cfg": tcfg,
                     "tree": start}
        cases[name] = (tcfg, OCFG)
    out = {"ref": ref}
    for key, shape in MESHES.items():
        mine = {n: c for n, c in cases.items() if key in _meshes(n)}
        world = shape[0] * shape[1]
        backend.spawn(ranks.moe_train_rank, world, "cpu", shape, tmp, mine,
                      _batch(512), threads=1)      # both tiny vocabs
        out[key] = [torch.load(os.path.join(tmp, f"moetrain{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _first(rs):
    return sorted((r for r in rs if r["coords"][0] == 0),
                  key=lambda r: r["coords"][1])


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_mesh_gradients_match_reference(run, name, key):
    rs = run[key]
    want = run["ref"][(name, MESHES[key][0])]
    for r in rs:
        np.testing.assert_allclose(r[name]["loss"], want["loss"], rtol=1e-5)
    grads = sharding.unshard([r[name]["grads"] for r in _first(rs)])
    kinds = rs[0][name]["kinds"]
    assert grads
    if CASES[name][1] == "full":
        assert "layers.0.moe.router.w" in grads
        assert kinds["layers.0.moe.router.w"] == sharding.PARTIAL
    sq = 0.0
    for n, g in grads.items():
        w = want["grads"][n]
        assert g.shape == w.shape, n
        assert torch.linalg.norm((g - w).double()) <= \
            1e-4 * torch.linalg.norm(w.double()), n
        sq += float((w.double() ** 2).sum())
    for r in rs:
        np.testing.assert_allclose(r[name]["metrics"]["grad_norm"],
                                   np.sqrt(sq), rtol=1e-4)
        np.testing.assert_allclose(r[name]["metrics"]["loss"],
                                   want["loss"], rtol=1e-5)
        assert r[name]["metrics"] == rs[0][name]["metrics"]


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_mesh_step_collectives(run, name, key):
    for r in run[key]:
        rec, want = r[name]["record"], r[name]["want"]
        assert {e["kind"] for e in rec} == {"all_reduce"}
        counts = {axis: sum(e["axis"] == axis for e in rec)
                  for axis in context.AXES}
        assert counts == want == {"model": MODEL_REDUCES[name], "data": 3}


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_whole_state_checkpoint(run, name, key):
    rs, ref = run[key], run["ref"][name]
    for r in rs:
        assert r[name]["restored"], r["coords"]
    tree = rs[0][name]["tree"]
    named = _named(tree["params"], ref["cfg"])
    codes = sharding.unshard([r[name]["codes"] for r in _first(rs)]) \
        if CASES[name][3] == "nibble" else None
    for n, t in named.items():
        if not t.is_floating_point():         # the codes, bit for bit
            assert torch.equal(t, ref["start"][n]), n
            if codes is not None:
                assert torch.equal(codes[n], t), n
    trained = sharding.unshard([r[name]["trained"] for r in _first(rs)])
    for n, t in trained.items():
        assert torch.equal(named[n], t), n
    # and off the mesh: the tree loads into a whole state
    from repro_torch.configs.base import OptimConfig
    from repro_torch.core import policies
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.state import make_state
    model = bridge.to_module(ref["tree"], ref["cfg"], device="cpu")
    mask = policies.make_mask(model, ref["cfg"])
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    bridge.load_state(state, tree)
    assert state["step"] == 1
    for n, t in (*state["params"].named_parameters(),
                 *state["params"].named_buffers()):
        assert torch.equal(t.detach(), named[n]), n
