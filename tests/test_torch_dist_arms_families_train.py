"""PyTorch port vs JAX reference: the ``lora`` and ``qat`` arms of every
family but the dense one, trained on a (1, 2) mesh.

The cases of ``tests/test_torch_dist_arms_families.py`` (llava, whisper,
xlstm, zamba2, deepseek-moe under ``"expert"`` and mixtral under
``"tensor"``, each under ``lora`` with random ``lora_b`` and ``qat`` with
groups of 16), remat "block".  The port's gloo ranks
(``_torch_dist_ranks.py::train_cases``, one spawn, one intra-op thread)
cut their shard of the whole train state and take one step on a 4 × 16
batch (with the family's prefix).

  * The loss and every trained gradient (the model-partial ones — a
    column-parallel ``lora_a``, ``wo``'s ``lora_b``, zamba2's shared-block
    adapters applied in each group, QAT's row-parallel scales and zeros
    and an expert stack's ``down`` groups — summed over the model axis,
    reassembled from the model ranks) against the reference's
    ``jax.value_and_grad`` of its unsharded ``loss_fn`` on the same batch:
    the loss rtol 1e-5, each gradient leaf within ``LEAF_TOL`` of the
    reference's in ℓ2 (1e-4; zamba2's 1e-3, as
    ``tests/test_torch_dist_recurrent_train.py`` states why), the step's
    ``grad_norm`` rtol 1e-4 of the reference gradient's norm.
  * The step's collective record: all-reduces only, their count on each
    axis ``step.mesh_collectives``'; every rank's metrics equal.
  * The whole-state tree gathered after the step, cut again
    (``load_shard``), gives each rank's shard and moments back bit for
    bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import backend, context, sharding

import _torch_dist_ranks as ranks
from test_torch_dist_arms_families import CASES, cfgs, tree
from _torch_threads import _one_torch_thread  # noqa: F401


B, S = 4, 16
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
LEAF_TOL = {"hybrid": 1e-3}
# a model-partial leaf each case trains
PARTIAL = {
    "llava_lora": "layers.0.attn.wq.lora_a",
    "whisper_lora": "dec.layers.0.xattn.wv.lora_a",
    "xlstm_lora": "mlstm.0.0.wq.lora_a",
    "zamba2_lora": "shared.attn.wo.lora_b",
    "deepseek_lora": "layers.0.attn.wo.lora_b",
    "mixtral_lora": "layers.0.attn.wk.lora_a",
    "llava_qat": "layers.0.attn.wo.scale",
    "whisper_qat": "dec.layers.0.xattn.wo.zero",
    "xlstm_qat": "mlstm.0.0.gi.scale",
    "zamba2_qat": "shared.attn.wo.scale",
    "deepseek_qat": "layers.0.attn.wo.scale",
    "mixtral_qat": "layers.0.moe.experts.down.scale",
}


def _batch(cfg):
    data = pipeline.PackedLM(synthetic.corpus(cfg.vocab_size, 4000, seed=5),
                             B, S)
    return pipeline.with_prefix(data.batch_at(0), cfg, 6)


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("armfamtrain"))
    ref, cases, batches = {}, {}, {}
    for name in CASES:
        tcfg = cfgs(name)[1].replace(remat="block")
        batches[name] = _batch(tcfg)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), tree(name))
        ref[name] = _reference(name, batches[name])
        cases[name] = (tcfg, OCFG)
    backend.spawn(ranks.train_cases, 2, "cpu", (1, 2), tmp, cases, batches,
                  "armfamtrain", threads=1)
    return {"ref": ref,
            "ranks": [torch.load(os.path.join(tmp, f"armfamtrain1x2_{r}.pt"),
                                 weights_only=False) for r in range(2)]}


@pytest.mark.parametrize("name", CASES)
def test_mesh_gradients_match_reference(run, name):
    rs, want = run["ranks"], run["ref"][name]
    for r in rs:
        np.testing.assert_allclose(r[name]["loss"], want["loss"], rtol=1e-5)
    rs = sorted(rs, key=lambda r: r["coords"][1])
    grads = sharding.unshard([r[name]["grads"] for r in rs],
                             kv_share=rs[0][name]["kv_share"])
    assert grads.keys() == {n for n in want["grads"]
                            if n in rs[0][name]["trained"]}
    partial = PARTIAL[name]
    assert rs[0][name]["kinds"][partial] == sharding.PARTIAL
    assert torch.linalg.norm(grads[partial]) > 0
    tol = LEAF_TOL.get(cfgs(name)[1].family, 1e-4)
    sq = 0.0
    for n, g in grads.items():
        w = want["grads"][n]
        assert g.shape == w.shape, n
        assert torch.linalg.norm((g - w).double()) <= \
            tol * torch.linalg.norm(w.double()) + 1e-12, n
        sq += float((w.double() ** 2).sum())
    for r in rs:
        np.testing.assert_allclose(r[name]["metrics"]["grad_norm"],
                                   np.sqrt(sq), rtol=1e-4)
        np.testing.assert_allclose(r[name]["metrics"]["loss"],
                                   want["loss"], rtol=1e-5)
        assert r[name]["metrics"] == rs[0][name]["metrics"]


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_collectives(run, name):
    for r in run["ranks"]:
        rec, want = r[name]["record"], r[name]["want"]
        assert {e["kind"] for e in rec} == {"all_reduce"}
        counts = {axis: sum(e["axis"] == axis for e in rec)
                  for axis in context.AXES}
        assert counts == want and want["model"] > 0


@pytest.mark.parametrize("name", CASES)
def test_whole_state_checkpoint(run, name):
    for r in run["ranks"]:
        assert r[name]["restored"], r["coords"]
