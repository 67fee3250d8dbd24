"""PyTorch port vs JAX reference: PEQA training on a (data, model) mesh.

The mesh config of ``tests/test_torch_dist_serve.py``: ``paper_lm(n_layers=2,
d_model=128, n_heads=4, d_ff=256, vocab=512)``, float32, 4-bit.  The
reference builds the weights here; the port's ranks — gloo on the CPU,
spawned once a mesh, (1, 2), (2, 1) and (2, 2) — rebuild the whole model
from them, cut their shard of the whole train state and take 3 steps on the
global batches (``tests/_torch_dist_ranks.py::train_rank``).  Every case:
peqa under remat none and block, ``"chunked"``, peqa_z, ``group_size=32``
(the row-parallel groups split over the model axis), 4 bit-planes,
``full`` and ``grad_compression="int8"``.  The batches carry a mask that
keeps a different number of tokens in every row, so a mean of the ranks'
means would differ from the global token mean.

  * Against the reference's unsharded ``build_train_step`` on the same
    global batches, with ``tests/test_torch_train.py``'s float32
    tolerances: loss rtol 1e-5, ``grad_norm`` rtol 1e-4, the trained
    values' updates within 1e-3 of the reference's in ℓ2 (reassembled from
    the model ranks, ``sharding.unshard``), the codes bit-equal to where
    they started, every data rank's shard bit-equal to data rank 0's
    (int8: its first step, ``REF_STEPS``).
  * Against the port's unsharded step: loss and ``grad_norm`` rtol 1e-5,
    atol 1e-6 (the sums add in another order), the eval loss after the
    steps the same, the updates and the reassembled Adam moments within
    1e-4 in ℓ2.
  * Step 1's collective record: all-reduces only, none gathering a
    vocab-extent tensor, their count on each axis that of
    ``step.mesh_collectives`` and of the numbers written out here for L = 2.
  * A step whose every ``backward()`` runs on another thread, where no
    ``use_mesh`` is installed (autograd's device thread on the card), is
    bit-equal to the same step run in place.
  * ``compressed_psum`` over each axis against the reference's under
    ``jax.vmap(..., axis_name=)`` on the same per-rank gradients.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
from repro.optim import compression as jcompression
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.train import step as jstep
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import backend, context, sharding
from repro_torch.models import registry
from repro_torch.train import step

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from test_torch_train import _port_run
from _torch_threads import _one_torch_thread  # noqa: F401


MESHES = [(1, 2), (2, 1), (2, 2)]
IDS = ["1x2", "2x1", "2x2"]
KW = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
B, S, STEPS = 4, 32, 3
# name: (mode, quant fields, attn_impl, remat, grad_compression)
CASES = {
    "peqa": ("peqa", {}, "dense", "none", None),
    "peqa_block": ("peqa", {}, "dense", "block", None),
    "chunked": ("peqa", {}, "chunked", "block", None),
    "peqa_z": ("peqa_z", {}, "dense", "none", None),
    "group32": ("peqa", {"group_size": 32}, "dense", "block", None),
    "planes": ("peqa", {"layout": "plane"}, "dense", "none", None),
    "full": ("full", {}, "dense", "block", None),
    "int8": ("peqa", {}, "dense", "none", "int8"),
}
# the model-axis all-reduces of one step at L = 2: forward 2L + 1, the
# recompute L under "block", the backward 2L (+ 1 where the table trains),
# the cross entropy 3, the partial bucket (PEQA) 1, the norm 1, int8's max
# bucket 1
MODEL_REDUCES = {"peqa": 14, "peqa_block": 16, "chunked": 16, "peqa_z": 14,
                 "group32": 16, "planes": 14, "full": 16, "int8": 15}
THREADED = "peqa_block"
# int8's codes are a step function of the gradient: an element within the
# float32 noise of the two packages' gradients of a rounding boundary takes
# either code, and Adam's first steps turn a 0 / ±1 code into an update of
# about 0 / ±lr.  The port's own unsharded int8 step already differs so
# from the reference's (a few elements a leaf: updates up to 18% apart in
# ℓ2 after one step, loss 1.3e-5 apart at step 2), so the int8 case is held
# to the reference at its first step's loss and gradient norm (the first
# codes' norm) and to the port's unsharded step in full
REF_STEPS = {"int8": 1}


def _ocfg(name):
    comp = CASES[name][4]
    return dict(OCFG, grad_compression=comp) if comp else dict(OCFG)


def _cfgs(name):
    mode, quant, attn, remat, _ = CASES[name]
    kw = dict(attn_impl=attn, remat=remat)
    j = jconfigs.paper_lm(**KW).replace(
        tuning=JTuning(mode=mode), quant=JQuant(bits=4, n_grid=2, **quant),
        **kw)
    t = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode=mode),
        quant=QuantConfig(bits=4, n_grid=2, **quant), **kw)
    return j, t


def _batches():
    """3 global batches of 4 × 32 with a mask keeping 32 − 5·i tokens of
    row i."""
    data = pipeline.PackedLM(synthetic.corpus(KW["vocab"], 4000, seed=4),
                             B, S)
    mask = (np.arange(S)[None, :] >= 5 * np.arange(B)[:, None]
            ).astype(np.float32)
    return [dict(data.batch_at(i), mask=mask) for i in range(STEPS)]


def _reference(jcfg, batches, ocfg):
    rng = jax.random.PRNGKey(0)
    api = jregistry.build(jcfg)
    params, mask = jpolicies.prepare(api.init(rng), jcfg, rng)
    start = to_numpy(params)
    opt = jmake_optimizer(JOptim(**ocfg), 10)
    state = {"params": params, "opt": opt.init(params, mask),
             "step": jnp.int32(0)}
    ts = jstep.build_train_step(api, jcfg, JTrain(optim=JOptim(**ocfg)),
                                mask, opt)
    hist = []
    for b in batches:
        state, m = ts(state, {k: jnp.asarray(v) for k, v in b.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return start, to_numpy(state["params"]), hist


def _named(tree, cfg):
    model = bridge.to_module(tree, cfg, device="cpu")
    return {n: t.detach() for n, t in (*model.named_parameters(),
                                       *model.named_buffers())}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    batches = _batches()
    tmp = str(tmp_path_factory.mktemp("train"))
    cases, ref = {}, {}
    for name in CASES:
        jcfg, tcfg = _cfgs(name)
        start, want, jhist = _reference(jcfg, batches, _ocfg(name))
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), start)
        got, thist, _, state = _port_run(tcfg, start, batches, _ocfg(name))
        api = registry.build(tcfg, device="cpu")
        ev = float(step.build_eval_step(api, tcfg)(state["params"],
                                                   batches[0]))
        ref[name] = {"start": _named(start, tcfg), "want": _named(want, tcfg),
                     "jhist": jhist, "thist": thist, "eval": ev,
                     "port": {n: p.detach() for n, p in
                              state["params"].named_parameters()},
                     "moments": state["opt"]["mv"]}
        cases[name] = (tcfg, _ocfg(name))
    grads = np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32)
    out = {"ref": ref, "grads": grads}
    for shape, key in zip(MESHES, IDS):
        world = shape[0] * shape[1]
        backend.spawn(ranks.train_rank, world, "cpu", shape, tmp, cases,
                      batches, THREADED, grads, threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"train{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _whole(rs, name, what):
    """The model ranks' (data rank 0) ``what`` of case ``name``, put back
    together."""
    first = sorted((r for r in rs if r["coords"][0] == 0),
                   key=lambda r: r["coords"][1])
    return sharding.unshard([r[name][what] for r in first])


def _update_close(got, want, start, tol, name):
    upd = got.double() - start.double()
    upd_ref = want.double() - start.double()
    assert torch.linalg.norm(upd - upd_ref) <= \
        tol * torch.linalg.norm(upd_ref), name


CASE_IDS = [(c, m) for c in CASES for m in IDS]


@pytest.mark.parametrize("name,key", CASE_IDS,
                         ids=[f"{c}-{m}" for c, m in CASE_IDS])
def test_mesh_train_matches_reference(run, name, key):
    rs, ref = run[key], run["ref"][name]
    n_steps = REF_STEPS.get(name, STEPS)
    for r in rs:
        for t, j in zip(r[name]["hist"][:n_steps], ref["jhist"]):
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-7)
    # every data rank holds the same shard as data rank 0
    for r in rs:
        twin = next(q for q in rs if q["coords"] == (0, r["coords"][1]))
        for what in ("trained", "codes"):
            for n, t in r[name][what].items():
                assert torch.equal(t, twin[name][what][n]), (n, r["coords"])
    trained = _whole(rs, name, "trained")
    assert trained
    for n, t in trained.items():
        if n_steps == STEPS:
            _update_close(t, ref["want"][n], ref["start"][n], 1e-3, n)
    for n, t in _whole(rs, name, "codes").items():
        assert torch.equal(t, ref["start"][n]), n        # frozen, bit-equal
    untrained = set(ref["start"]) - set(trained) - set(
        _whole(rs, name, "codes"))
    for n in untrained:          # frozen parameters: the reference's start
        assert torch.equal(ref["want"][n], ref["start"][n]), n


@pytest.mark.parametrize("name,key", CASE_IDS,
                         ids=[f"{c}-{m}" for c, m in CASE_IDS])
def test_mesh_train_matches_unsharded_port(run, name, key):
    rs, ref = run[key], run["ref"][name]
    for r in rs:
        for t, u in zip(r[name]["hist"], ref["thist"]):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(t[k], u[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[name]["eval"], ref["eval"], rtol=1e-5,
                                   atol=1e-6)
    for n, t in _whole(rs, name, "trained").items():
        _update_close(t, ref["port"][n], ref["start"][n], 1e-4, n)
    first = sorted((r for r in rs if r["coords"][0] == 0),
                   key=lambda r: r["coords"][1])
    for i in range(2):                   # the first and the second moment
        got = sharding.unshard([{n: p[i] for n, p in r[name]["moments"]
                                 .items()} for r in first])
        assert got.keys() == ref["moments"].keys()
        for n, t in got.items():
            want = ref["moments"][n][i]
            assert torch.linalg.norm((t - want).double()) <= \
                1e-4 * torch.linalg.norm(want.double()), (n, i)


@pytest.mark.parametrize("name,key", CASE_IDS,
                         ids=[f"{c}-{m}" for c, m in CASE_IDS])
def test_mesh_step_collectives(run, name, key):
    for r in run[key]:
        rec, want = r[name]["record"], r[name]["want"]
        assert {e["kind"] for e in rec} == {"all_reduce"}
        assert context.allgather_extent_count(rec, KW["vocab"]) == 0
        counts = {axis: sum(e["axis"] == axis for e in rec)
                  for axis in context.AXES}
        assert counts == want == {"model": MODEL_REDUCES[name], "data": 3}
        # no collective carries rows of vocab-extent logits (a flat
        # gradient bucket may happen to hold vocab elements)
        assert all(len(e["shape"]) == 1 or KW["vocab"] not in e["shape"]
                   for e in rec)


@pytest.mark.parametrize("key", IDS)
def test_backward_on_another_thread(run, key):
    for r in run[key]:
        a, b = r[THREADED], r["threaded"]
        assert a["hist"] == b["hist"]
        for n, t in a["trained"].items():
            assert torch.equal(t, b["trained"][n]), n


@pytest.mark.parametrize("key", IDS)
@pytest.mark.parametrize("axis", context.AXES)
def test_compressed_psum_matches_reference(run, key, axis):
    grads = run["grads"]
    for r in run[key]:
        d, m = r["coords"]
        shape = MESHES[IDS.index(key)]
        group = [dd * shape[1] + m for dd in range(shape[0])] \
            if axis == "data" else [d * shape[1] + mm
                                    for mm in range(shape[1])]
        want = jax.vmap(lambda g: jcompression.compressed_psum(g, "i"),
                        axis_name="i")(jnp.asarray(grads[group]))
        mine = group.index(d * shape[1] + m)
        np.testing.assert_array_equal(r["psum"][axis].numpy(),
                                      np.asarray(want[mine]))
