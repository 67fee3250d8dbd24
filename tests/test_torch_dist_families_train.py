"""PyTorch port vs JAX reference: PEQA and full training of the vlm and
encdec families and of KV heads fewer than the model ranks on a (data,
model) mesh.

Configurations: ``make_tiny`` of llava-next-mistral-7b (8 prefix rows of
image embeddings), whisper-medium (2 encoder and 2 decoder layers, 12
frames), granite-34b (one KV head; the ``full`` case with q/k/v biases,
which then train) and llama3.2-1b with 2 KV heads, 4 bits, float32, under
remat "block" or "none".  The reference builds the weights; the port's
gloo ranks (``_torch_dist_ranks.py::train_cases``, one spawn a mesh, one
intra-op thread) cut their shard of the whole train state at (1, 2) and
(2, 2) — granite's and the 2-KV-head model's also at (1, 4): two and four
ranks a KV head — and take one step on a 4 × 16 batch (with its prefix)
and no mask.

  * The loss and every trained gradient (the model-partial ones — the
    row-parallel scales and a shared KV head's ``wk``/``wv`` leaves —
    summed over the model axis, all over the data axis, reassembled from
    the model ranks) against the reference's ``jax.value_and_grad`` of
    its unsharded ``loss_fn`` on the same global batch: the loss rtol
    1e-5, each gradient leaf within 1e-4 of the reference's in ℓ2, the
    step's ``grad_norm`` rtol 1e-4 of the reference gradient's norm.
  * The step's collective record: all-reduces only, their count on each
    axis ``step.mesh_collectives``' and the numbers written out here for
    L = 2 (whisper: 2 encoder and 2 decoder layers); every rank's metrics
    equal.
  * The whole-state tree gathered after the step (``whole_tree``) holds
    the start's codes bit for bit and the reassembled trained leaves; cut
    again (``load_shard``) it gives each rank's shard back bit for bit;
    it loads off the mesh.
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
# name: (arch, mode, remat, changes)
CASES = {
    "llava_peqa_block": ("llava-next-mistral-7b", "peqa", "block", {}),
    "whisper_peqa_block": ("whisper-medium", "peqa", "block", {}),
    "whisper_full_none": ("whisper-medium", "full", "none", {}),
    "granite_peqa_none": ("granite-34b", "peqa", "none", {}),
    "granite_full_block": ("granite-34b", "full", "block",
                           dict(qkv_bias=True)),
    "gqa2_peqa_block": ("llama3.2-1b", "peqa", "block",
                        dict(n_kv_heads=2)),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# the model-axis all-reduces of one step at L = 2: a decoder's forward
# 2L + 1, its recompute L under "block", its backward 2L (+ 1 where the
# table trains: full), the cross entropy 3, the partial bucket 1, the
# norm 1; whisper's forward 2·2 + 3·2 + 1, its recompute 2 + 2·2 under
# "block", its backward 2·2 + 3·2 + 1 (the encoder output) + 1 (the head),
# less each stack's first norm's under PEQA
MODEL_REDUCES = {"llava_peqa_block": 16, "whisper_peqa_block": 32,
                 "whisper_full_none": 27, "granite_peqa_none": 14,
                 "granite_full_block": 17, "gqa2_peqa_block": 16}


def _meshes(name):
    kv = name.startswith(("granite_peqa", "gqa2"))
    return list(MESHES) if kv else ["1x2", "2x2"]


CASE_MESH = [(n, k) for n in CASES for k in _meshes(n)]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]


def _cfgs(name):
    arch, mode, remat, change = CASES[name]
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode), quant=JQuant(bits=4, n_grid=2),
        remat=remat, **change)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode), quant=QuantConfig(bits=4, n_grid=2),
        remat=remat, **change)
    return j, t


def _batch(cfg):
    """A 4 × 16 batch of a synthetic corpus with the family's prefix:
    image embeddings (vlm) or frames (encdec)."""
    data = pipeline.PackedLM(synthetic.corpus(cfg.vocab_size, 4000, seed=5),
                             B, S)
    return pipeline.with_prefix(data.batch_at(0), cfg, 6)


def _named(tree, cfg):
    model = bridge.to_module(tree, cfg, device="cpu")
    return {n: t.detach() for n, t in (*model.named_parameters(),
                                       *model.named_buffers())}


@functools.lru_cache(maxsize=None)
def _init(arch, change):
    """The reference's float32 weights of an arch's tiny config."""
    name = next(n for n, c in CASES.items()
                if c[0] == arch and tuple(sorted(c[3].items())) == change)
    jcfg, _ = _cfgs(name)
    return jregistry.build(jcfg).init(jax.random.PRNGKey(1))


def _reference(jcfg, tcfg, batch, name):
    """The reference's start tree and its loss and gradient on the whole
    batch, by port name."""
    api = jregistry.build(jcfg)
    arch, _, _, change = CASES[name]
    params, _ = jpolicies.prepare(_init(arch, tuple(sorted(change.items()))),
                                  jcfg, jax.random.PRNGKey(1))
    loss, g = jax.jit(jax.value_and_grad(api.loss_fn, allow_int=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    # integer leaves get float0 gradients: put the codes back so the tree
    # converts, and compare the float leaves only
    g = jax.tree.map(lambda p, d: np.asarray(p) if not np.issubdtype(
        np.asarray(p).dtype, np.floating) else np.asarray(d), params, g)
    return to_numpy(params), {"loss": float(loss), "grads": _named(g, tcfg)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("famtrain"))
    ref, cases, batches = {}, {}, {}
    for name in CASES:
        jcfg, tcfg = _cfgs(name)
        batches[name] = _batch(tcfg)
        start, want = _reference(jcfg, tcfg, batches[name], name)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), start)
        ref[name] = {"start": _named(start, tcfg), "cfg": tcfg,
                     "tree": start, **want}
        cases[name] = (tcfg, OCFG)
    out = {"ref": ref}
    for key, shape in MESHES.items():
        mine = {n: c for n, c in cases.items() if key in _meshes(n)}
        world = shape[0] * shape[1]
        backend.spawn(ranks.train_cases, world, "cpu", shape, tmp, mine,
                      batches, threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"famtrain{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _first(rs):
    return sorted((r for r in rs if r["coords"][0] == 0),
                  key=lambda r: r["coords"][1])


def _unshard(rs, name, what):
    first = _first(rs)
    return sharding.unshard([r[name][what] for r in first],
                            kv_share=first[0][name]["kv_share"])


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_mesh_gradients_match_reference(run, name, key):
    rs, want = run[key], run["ref"][name]
    for r in rs:
        np.testing.assert_allclose(r[name]["loss"], want["loss"], rtol=1e-5)
    grads = _unshard(rs, name, "grads")
    kinds = rs[0][name]["kinds"]
    cfg = want["cfg"]
    assert grads
    stack = "dec.layers.0" if cfg.family == "encdec" else "layers.0"
    wk = f"{stack}.attn.wk.{'w' if cfg.tuning.mode == 'full' else 'scale'}"
    assert wk in grads
    shared = cfg.n_kv_heads < MESHES[key][1]
    assert kinds[wk] == (sharding.PARTIAL if shared else sharding.SHARDED)
    if cfg.qkv_bias and cfg.tuning.mode == "full":
        assert kinds[f"{stack}.attn.wk.b"] == kinds[wk]
        assert f"{stack}.attn.wk.b" in grads
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
    codes = _unshard(rs, name, "codes")
    for n, t in named.items():
        if not t.is_floating_point():         # the codes, bit for bit
            assert torch.equal(t, ref["start"][n]), n
            assert torch.equal(codes[n], t), n
    trained = _unshard(rs, name, "trained")
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
