"""PyTorch port vs JAX reference: continuous and speculative serving and the
shard-local samplers on a (data, model) mesh.

The reference's mesh configs (``tests/test_serve_sharded.py``): the dense
``paper_lm(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)`` with
tasks A and B on its ``_CONT_TEST`` traffic, and the 1-layer d 64 plane
config on its ``_SPEC_SHARD_TEST`` traffic.  The port's ranks — gloo on
the CPU, spawned once a mesh, (1, 2) and (2, 2) — serve their shards
(``tests/_torch_dist_ranks.py``).

  * Resident and drain ``serve`` on the mesh give the reference host
    engine's tokens and scheduler counters, and each request's tokens are
    the reference's lockstep ``generate`` under its task; a resident row
    install issues no collective.
  * Speculative serving on the plane backbone gives greedy's tokens (the
    reference host engine's) in fewer target steps.
  * Every sharded sampler returns, bit for bit, what its off-mesh form
    returns on the whole logits — ties across and within vocab blocks
    included (the reference's lg[0,7] = lg[0,300] and lg[2,130] =
    lg[2,131]) —, and argmax and top-k equal ``jnp.argmax`` and
    ``lax.top_k``.
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
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.dist import backend, sampling

import _torch_dist_ranks as ranks
from test_torch_dist_serve import (IDS, KW, MESHES, _cfgs, load_ranks,
                                   task_sets, write_inputs)
from _torch_threads import _one_torch_thread  # noqa: F401


PLANE_KW = dict(n_layers=1, d_model=64, n_heads=2, d_ff=128, vocab=128)
COUNTERS = ("steps", "scheduler", "switches", "bubble_slot_steps",
            "idle_slot_steps", "decoded", "task_drain_idle_slot_steps")
SAMPLERS = ("argmax", "argmax_masked", "topk", "sample", "top_p",
            "top_p_half")


def _plane_cfgs():
    j = jconfigs.paper_lm(**PLANE_KW).replace(
        tuning=JTuning(mode="peqa"),
        quant=JQuant(bits=4, n_grid=2, layout="plane"))
    t = tconfigs.paper_lm(**PLANE_KW).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, n_grid=2, layout="plane"))
    return j, t


def _prepared(jcfg):
    rng = jax.random.PRNGKey(0)
    api = jregistry.build(jcfg)
    p, _ = jpolicies.prepare(api.init(rng), jcfg, rng)
    return api, jax.tree.map(np.asarray, p)


def _logits():
    """{name: ((B, V) float32 logits, (B,) active mask)}: the reference's
    tie case and its sampling case."""
    rng = np.random.default_rng(7)
    tie = rng.normal(size=(4, 512)).astype(np.float32)
    tie[0, 7] = tie[0, 300] = 99.0          # a tie ACROSS vocab blocks
    tie[2, 130] = tie[2, 131] = 55.0        # a tie WITHIN one
    samp = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 64))
                      * 3.0, np.float32)
    act4 = np.array([True, False, True, True])
    act8 = np.array([True, True, False, True, False, True, True, True])
    return {"tie": (torch.from_numpy(tie), torch.from_numpy(act4)),
            "sample": (torch.from_numpy(samp), torch.from_numpy(act8))}


def _off_mesh(lg, active):
    b = lg.shape[0]
    vals, idx = sampling.shard_topk(None, b, 5)(lg)
    return {"argmax": sampling.shard_argmax(None, b)(lg),
            "argmax_masked": sampling.shard_argmax_masked(None, b, fill=3)(
                lg, active),
            "topk_values": vals, "topk_indices": idx,
            "sample": sampling.shard_sample(None, b, 0.8)(lg, 42),
            "top_p": sampling.shard_top_p(None, b, 0.9, 0.8)(lg, 42),
            "top_p_half": sampling.shard_top_p(None, b, 0.5, 0.8)(lg, 42)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = _cfgs()
    api, p = _prepared(jcfg)
    sets = task_sets(p)
    bank = jsb.ScaleBank()
    for t, s in sets.items():
        bank.tasks[t] = s
    host = JEngine(api, jax.tree.map(jnp.asarray, p), bank=bank)
    jreqs = [JRequest(tokens=r.tokens, n_new=r.n_new, task=r.task,
                      arrival_step=r.arrival_step)
             for r in ranks._cont_requests(KW["vocab"])]
    ref = {}
    host.switch_task("A")
    ref["resident"] = host.serve(jreqs, JServeConfig(n_slots=4))
    host.switch_task("A")
    ref["drain"] = host.serve(jreqs, JServeConfig(n_slots=4,
                                                  scheduler="drain"))
    ref["lockstep"] = []
    for r in jreqs:
        host.switch_task(r.task)
        ref["lockstep"].append([int(t) for t in np.asarray(host.generate(
            jnp.asarray(r.tokens)[None], n_new=r.n_new))[0, 6:]])
    jp, tp = _plane_cfgs()
    api_p, pp = _prepared(jp)
    ref["greedy"] = JEngine(api_p, jax.tree.map(jnp.asarray, pp)).serve(
        [JRequest(tokens=r.tokens, n_new=r.n_new)
         for r in ranks._spec_requests(PLANE_KW["vocab"])],
        JServeConfig(n_slots=4))
    logits = _logits()
    out = {"ref": ref, "logits": logits}
    for shape, key in zip(MESHES, IDS):
        tmp = str(tmp_path_factory.mktemp(f"cont{key}"))
        write_inputs(tmp, p, sets)
        ranks.save_tree(os.path.join(tmp, "plane.npz"), pp)
        world = shape[0] * shape[1]
        backend.spawn(ranks.cont_rank, world, "cpu", shape, tmp, tcfg, tp,
                      logits, threads=1)
        out[key] = load_ranks(tmp, "cont", world)
    return out


def _counters(rep):
    return {k: getattr(rep, k) for k in COUNTERS}


@pytest.mark.parametrize("key", IDS)
def test_resident_serve_equals_host_and_lockstep(run, key):
    ref = run["ref"]["resident"]
    for r in run[key]:
        got = r["resident"]
        assert got["tokens"] == ref.tokens
        assert {k: got[k] for k in COUNTERS} == _counters(ref)
        assert got["scheduler"] == "resident" and got["switches"] == 0
        assert got["bubble_slot_steps"] == 0
        assert got["tokens"] == run["ref"]["lockstep"]


@pytest.mark.parametrize("key", IDS)
def test_drain_serve_equals_host(run, key):
    ref = run["ref"]["drain"]
    for r in run[key]:
        got = r["drain"]
        assert got["tokens"] == ref.tokens == r["resident"]["tokens"]
        assert {k: got[k] for k in COUNTERS} == _counters(ref)
        assert got["switches"] >= 1


@pytest.mark.parametrize("key", IDS)
def test_resident_install_issues_no_collective(run, key):
    for r in run[key]:
        assert r["install_record"] == []


@pytest.mark.parametrize("key", IDS)
def test_speculative_equals_greedy_in_fewer_steps(run, key):
    ref = run["ref"]["greedy"]
    for r in run[key]:
        greedy, spec = r["greedy"], r["speculative"]
        assert greedy["tokens"] == ref.tokens
        assert spec["scheduler"] == "speculative"
        assert spec["tokens"] == greedy["tokens"]
        assert all(t is not None for t in spec["tokens"])
        assert spec["steps"] < greedy["steps"]
        assert (spec["acceptance_rate"] or 0.0) > 0.0


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("key", IDS)
def test_sharded_sampler_is_bit_exact(run, key, sampler):
    names = ("topk_values", "topk_indices") if sampler == "topk" \
        else (sampler,)
    for case, (lg, act) in run["logits"].items():
        want = _off_mesh(lg, act)
        for r in run[key]:
            got = r["samplers"][case]
            for n in names:
                assert torch.equal(got[n], want[n]), (case, n)
        if sampler == "argmax":
            np.testing.assert_array_equal(
                want["argmax"].numpy(),
                np.asarray(jnp.argmax(jnp.asarray(lg.numpy()), axis=-1)))
        if sampler == "topk":
            v, i = jax.lax.top_k(jnp.asarray(lg.numpy()), 5)
            np.testing.assert_array_equal(want["topk_values"].numpy(),
                                          np.asarray(v))
            np.testing.assert_array_equal(want["topk_indices"].numpy(),
                                          np.asarray(i))
    tie = run[key][0]["samplers"]["tie"]["argmax"]
    assert int(tie[0]) == 7 and int(tie[2]) == 130
