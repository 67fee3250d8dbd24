"""PyTorch port vs JAX reference: lockstep serving on a (data, model) mesh.

The reference's mesh config (``tests/test_serve_sharded.py``):
``paper_lm(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)``,
PEQA 4-bit, float32, and a task B of seeded rescalings of task A's scales.
The reference builds the weights here; the port's ranks — gloo on the CPU,
spawned once a mesh, (1, 2) and (2, 2) — rebuild the port's model from
them, cut their shards and serve (``tests/_torch_dist_ranks.py``).

  * ``generate`` on the mesh gives the tokens of the port's unsharded
    engine and of the reference's host ``Engine``, under task A and, after
    ``switch_task("B")``, under task B (which steers the continuation);
    the prefill logits hold to both within rtol 1e-5, atol 1e-4 (float32:
    the row-parallel sums add in another order).
  * A task swap issues no collective, and a rank's swap moves fewer bytes
    than the whole set (``local_nbytes``, equal to the reference's).
  * A ``logitshard`` decode step gathers no vocab-extent tensor; without
    it, one (lockstep and slot-pool steps).
  * The slot pool's cache leaves are the rank's blocks of ``cache_specs``.
  * ``bf16_reduce`` in bf16: the row-parallel sums run in bf16, and the
    logits hold to the reference's bf16 logits within 2⁻⁴ of their largest
    magnitude (bf16 activations, rounded in other places).
"""
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
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.dist import backend, context
from repro_torch.dist import sharding

import _torch_dist_ranks as ranks
from _torch_threads import _one_torch_thread  # noqa: F401


MESHES = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]
N_NEW = 6
KW = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)
BF16_TOL = 2.0 ** -4


def _cfgs():
    j = jconfigs.paper_lm(**KW).replace(
        tuning=JTuning(mode="peqa"), quant=JQuant(bits=4, n_grid=2))
    t = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=2))
    return j, t


def task_sets(p):
    """Task A (the model's scales) and B (seeded rescalings, the
    reference test's)."""
    a = jsb.extract_scales(p)
    rng = np.random.default_rng(7)
    return {"A": a, "B": {k: (v * rng.uniform(0.5, 1.5, v.shape)
                              ).astype(v.dtype) for k, v in a.items()}}


def write_inputs(tmp, p, sets, name="dense"):
    """The reference tree and the task bank, where the ranks read them."""
    ranks.save_tree(os.path.join(tmp, f"{name}.npz"), p)
    os.makedirs(os.path.join(tmp, "bank"), exist_ok=True)
    for t, s in sets.items():
        np.savez(os.path.join(tmp, "bank", f"{t}.npz"), **s)


def load_ranks(tmp, name, world):
    return [torch.load(os.path.join(tmp, f"{name}{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = _cfgs()
    rng = jax.random.PRNGKey(0)
    api = jregistry.build(jcfg)
    p, _ = jpolicies.prepare(api.init(rng), jcfg, rng)
    p = jax.tree.map(np.asarray, p)
    sets = task_sets(p)
    prompt = np.tile(np.arange(8, dtype=np.int32)[None], (4, 1))
    ref = {}
    bank = jsb.ScaleBank()
    for t, s in sets.items():
        bank.tasks[t] = s
    host = JEngine(api, jax.tree.map(jnp.asarray, p), bank=bank)
    for t in ("A", "B"):
        host.switch_task(t)
        ref[f"tokens_{t}"] = np.asarray(host.generate(jnp.asarray(prompt),
                                                      n_new=N_NEW))
        pt = jsb.apply_scales(jax.tree.map(jnp.asarray, p), sets[t])
        ref[f"logits_{t}"] = np.asarray(api.prefill(
            pt, {"tokens": jnp.asarray(prompt)})[0])
    jb = jcfg.replace(dtype="bfloat16", bf16_reduce=True)
    ref["bf16_logits"] = np.asarray(jregistry.build(jb).prefill(
        jax.tree.map(jnp.asarray, p), {"tokens": jnp.asarray(prompt)})[0]
        ).astype(np.float32)
    tb = tcfg.replace(dtype="bfloat16", bf16_reduce=True)
    out = {"ref": ref, "sets": sets}
    for shape, key in zip(MESHES, IDS):
        tmp = str(tmp_path_factory.mktemp(f"serve{key}"))
        write_inputs(tmp, p, sets)
        world = shape[0] * shape[1]
        backend.spawn(ranks.serve_rank, world, "cpu", shape, tmp, tcfg, tb,
                      torch.from_numpy(prompt), N_NEW, threads=1)
        out[key] = load_ranks(tmp, "serve", world)
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("key", IDS)
def test_generate_equals_unsharded_and_reference(run, key):
    for r in run[key]:
        for t in ("A", "B"):
            np.testing.assert_array_equal(r[f"tokens_{t}"].numpy(),
                                          run["ref"][f"tokens_{t}"])
            assert torch.equal(r[f"tokens_{t}"], r[f"host_tokens_{t}"])
            _close(r[f"logits_{t}"], run["ref"][f"logits_{t}"])
            _close(r[f"logits_{t}"], r[f"host_logits_{t}"])


@pytest.mark.parametrize("key", IDS)
def test_switch_task_steers_and_moves_nothing(run, key):
    r0 = run[key][0]
    assert not torch.equal(r0["tokens_A"], r0["tokens_B"])
    for r in run[key]:
        assert r["swap_record"] == []
        assert r["switch_s"] > 0
        assert r["local_nbytes"] < r["nbytes"]
    shape = MESHES[IDS.index(key)]
    jbank = jsb.ScaleBank()
    jbank.tasks["B"] = run["sets"]["B"]

    class Ctx:
        axis_sizes = {"data": shape[0], "model": shape[1]}
    assert r0["local_nbytes"] == jbank.local_nbytes("B", Ctx())


@pytest.mark.parametrize("key", IDS)
def test_logitshard_decode_gathers_no_vocab(run, key):
    vocab = KW["vocab"]
    for r in run[key]:
        for step in ("decode", "cont"):
            assert context.allgather_extent_count(r[f"{step}_ls"], vocab) == 0
            assert context.allgather_extent_count(r[f"{step}_base"],
                                                  vocab) >= 1
        assert torch.equal(r["tokens_ls"], r["tokens_base"])
        # the winner reduce moves O(B) scalars, never a vocab row
        ls = context.collective_stats(r["decode_ls"])
        base = context.collective_stats(r["decode_base"])
        assert ls["total_bytes"] < base["total_bytes"]


@pytest.mark.parametrize("key", IDS)
def test_pool_cache_is_the_rank_block_of_cache_specs(run, key):
    shape = MESHES[IDS.index(key)]
    for r in run[key]:
        assert r["pool_shapes"] == r["spec_shapes"]
        k = r["pool_shapes"]["k"]
        assert k[1] == 4 // shape[0] and k[3] == KW["n_heads"] // shape[1]
    rows = sorted({r["rows"] for r in run[key]})
    assert rows == [(i * 4 // shape[0], (i + 1) * 4 // shape[0])
                    for i in range(shape[0])]


@pytest.mark.parametrize("key", IDS)
def test_bf16_reduce_matches_reference(run, key):
    want = run["ref"]["bf16_logits"]
    tol = BF16_TOL * np.abs(want).max()
    for r in run[key]:
        got = r["bf16_logits"].float().numpy()
        assert np.abs(got - want).max() <= tol
        sums = [e for e in r["bf16_decode"] if e["kind"] == "all_reduce"
                and len(e["shape"]) == 3]
        assert sums and {e["dtype"] for e in sums} == {"bfloat16"}


def test_test_config_shards_over_two_not_three():
    _, tcfg = _cfgs()
    assert sharding.shard_problems(tcfg, 2) == []
    assert sharding.shard_problems(tcfg, 3)
