"""PyTorch port vs JAX reference: the comparison arms (``lora``,
``lora_optq``, ``qat``) cut and served on a (data, model) mesh.

Configurations: a tiny ``paper_lm`` (2 layers, d_model 64, 4 heads, d_ff
128, vocab 256) under QV4 (adapters of rank 4 on ``wq`` / ``wv``) and
QKVO16 (rank 16 on ``wq`` / ``wk`` / ``wv`` / ``wo``), and tiny
granite-34b (one KV head) under QKVO16, each arm 4 bits, float32.  The
reference builds every tree (``policies.prepare``: RTN under
``lora_optq``), and its ``lora_b`` is drawn at random (seeded numpy), so
that the adapters change the outputs.

  * The cut (in process): the shards of model ranks 0..M−1, M 2 and 4, put
    back together bit for bit (``unshard``); a column-parallel linear
    keeps ``lora_a`` whole (``PARTIAL``) and cuts ``lora_b`` by output (a
    shared KV head's by its group: ``PARTIAL``); the row-parallel ``wo``
    cuts ``lora_a`` by input (``SHARDED``) and keeps ``lora_b`` whole
    (``PARTIAL``); QAT's ``w`` takes ``w``'s rule and its scales PEQA's.
  * ``merge_lora`` on each shard of the ``lora`` arm, put back together,
    equals ``merge_lora`` of the whole model bit for bit (each entry of
    B·A is the same r-term sum on a block).
  * Serving, from gloo ranks (``_torch_dist_ranks.py::arms_serve_rank``,
    one spawn a mesh, one intra-op thread): at (1, 1) ``generate`` and the
    prefill logits are bit-equal to the port's unsharded engine; at
    (1, 2), (2, 2) and (1, 4) ``generate`` with and without logitshard
    gives the reference host ``Engine``'s tokens, and the prefill logits
    hold to the reference's within rtol 1e-5, atol 1e-4 (float32: the
    row-parallel sums, and the row-parallel adapter's delta joined to
    them, add in another order).
  * A decode step's collective record is a PEQA shard's: the adapters and
    the fake quantizer add no collective.
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
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import lora
from repro_torch.dist import backend, context, sharding

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
# name: (model, adapters); the adapters' (rank, targets)
MODELS = {"qv4": ("paper_lm", (4, ("wq", "wv"))),
          "qkvo16": ("paper_lm", (16, ("wq", "wk", "wv", "wo"))),
          "granite": ("granite-34b", (16, ("wq", "wk", "wv", "wo")))}
ARMS = ("lora", "lora_optq", "qat")
CASES = [f"{m}_{a}" for m in MODELS for a in ARMS]
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
SPLIT = [k for k in MESHES if k != "1x1"]
CASE_MESH = [(n, k) for n in CASES for k in SPLIT]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]
B, S, N_NEW = 4, 6, 5


def cfgs(name):
    """(reference config, port config) of a case."""
    model, arm = name.rsplit("_", 1) if not name.endswith("lora_optq") \
        else (name[:-len("_lora_optq")], "lora_optq")
    arch, (r, targets) = MODELS[model]
    tun = dict(mode=arm, lora_rank=r, lora_targets=targets)
    if arch == "paper_lm":
        j, t = jconfigs.paper_lm(**KW), tconfigs.paper_lm(**KW)
    else:
        j = jconfigs.make_tiny(jconfigs.get_config(arch))
        t = tconfigs.make_tiny(tconfigs.get_config(arch))
    return (j.replace(tuning=JTuning(**tun), quant=JQuant(bits=4, n_grid=2)),
            t.replace(tuning=TuningConfig(**tun),
                      quant=QuantConfig(bits=4, n_grid=2)))


@functools.lru_cache(maxsize=None)
def tree(name):
    """The reference's tree of a case (numpy leaves), every ``lora_b``
    drawn from N(0, 0.3²)."""
    jcfg, _ = cfgs(name)
    key = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(key), jcfg, key)
    p = to_numpy(p)
    rng = np.random.default_rng(11)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "lora_b":
                node[k] = rng.normal(0.0, 0.3, v.shape).astype(v.dtype)
    fill(p)
    return p


def model(name):
    _, tcfg = cfgs(name)
    return tcfg, bridge.to_module(tree(name), tcfg, device="cpu")


def tensors(module):
    return {n: t.detach() for n, t in (*module.named_parameters(),
                                       *module.named_buffers())}


def shards(name, m):
    cfg, whole = model(name)
    return whole, [sharding.shard_model(whole, cfg, context.coords(1, m, 0, r))
                   for r in range(m)]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_cut_then_unshard_is_the_whole_model(name, m):
    whole, parts = shards(name, m)
    want = tensors(whole)
    got = sharding.unshard(parts)
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    cfg = cfgs(name)[1]
    kinds = sharding.leaf_kinds(parts[0])
    share = sharding.kv_share(cfg, m)
    attn = "layers.0.attn"
    if cfg.tuning.mode == "qat":
        assert kinds[f"{attn}.wq.w"] == kinds[f"{attn}.wq.scale"] \
            == sharding.SHARDED
        assert kinds[f"{attn}.wo.scale"] == sharding.PARTIAL
        assert parts[0].layers[0].attn.wo.w.shape[-1] == cfg.d_model // m
        return
    r = cfg.tuning.lora_rank
    for t in cfg.tuning.lora_targets:
        lin = getattr(parts[0].layers[0].attn, t)
        if t == "wo":
            assert tuple(lin.lora_a.shape) == (r, cfg.d_model // m)
            assert tuple(lin.lora_b.shape) == (cfg.d_model, r)
            assert kinds[f"{attn}.wo.lora_a"] == sharding.SHARDED
            assert kinds[f"{attn}.wo.lora_b"] == sharding.PARTIAL
            continue
        assert tuple(lin.lora_a.shape) == (r, cfg.d_model)
        assert lin.lora_b.shape[0] == lin.out_features
        assert kinds[f"{attn}.{t}.lora_a"] == sharding.PARTIAL
        grouped = share > 1 and t in ("wk", "wv")
        assert kinds[f"{attn}.{t}.lora_b"] == (
            sharding.PARTIAL if grouped else sharding.SHARDED)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("_lora")])
def test_merge_lora_on_shards(name, m):
    whole, parts = shards(name, m)
    tun = cfgs(name)[1].tuning
    for p in parts:
        lora.merge_lora(p, tun)
        assert not any(mod.has_lora for mod in p.modules()
                       if hasattr(mod, "has_lora"))
    got = sharding.unshard(parts)
    want = tensors(lora.merge_lora(whole, tun))
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert torch.equal(got[n], t), n


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("arms"))
    prompt = np.random.default_rng(1).integers(0, 256, (B, S)).astype(
        np.int32)
    ref, cases = {}, {}
    for name in CASES:
        jcfg, tcfg = cfgs(name)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), tree(name))
        api = jregistry.build(jcfg)
        jp = jax.tree.map(jnp.asarray, tree(name))
        ref[name] = {
            "tokens": np.asarray(JEngine(api, jp).generate(
                jnp.asarray(prompt), n_new=N_NEW)),
            "logits": np.asarray(api.prefill(
                jp, {"tokens": jnp.asarray(prompt)})[0])}
        cases[name] = tcfg
    out = {"ref": ref, "cases": cases}
    for key, shape in MESHES.items():
        world = shape[0] * shape[1]
        backend.spawn(ranks.arms_serve_rank, world, "cpu", shape, tmp, cases,
                      torch.from_numpy(prompt), N_NEW, threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"armserve{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


@pytest.mark.parametrize("name", CASES)
def test_mesh_1x1_is_bit_equal_to_unsharded(run, name):
    res = run["1x1"][0][name]
    for ls in (True, False):
        assert torch.equal(res[f"tokens_{ls}"], res["host_tokens"])
        assert torch.equal(res[f"logits_{ls}"], res["host_logits"])
    np.testing.assert_array_equal(res["host_tokens"].numpy(),
                                  run["ref"][name]["tokens"])


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_generate_matches_reference(run, name, key):
    want = run["ref"][name]
    host = run["1x1"][0][name]["host_tokens"]
    for r in run[key]:
        res = r[name]
        for ls in (True, False):
            np.testing.assert_array_equal(res[f"tokens_{ls}"].numpy(),
                                          want["tokens"])
            assert torch.equal(res[f"tokens_{ls}"], host)
            np.testing.assert_allclose(res[f"logits_{ls}"].numpy(),
                                       want["logits"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_decode_adds_no_collective(run, name, key):
    """Every arm's decode step records what the same mesh's other arms
    record, and a model-axis sum a row-parallel linear and the lookup:
    the PEQA shard's count (``tests/test_torch_dist_serve.py``)."""
    model_name = name.rsplit("_", 1)[0] if not name.endswith("lora_optq") \
        else name[:-len("_lora_optq")]
    cfg = run["cases"][name]
    for r in run[key]:
        for ls in (True, False):
            rec = [(e["kind"], e["axis"], e["shape"])
                   for e in r[name][f"decode_{ls}"]]
            for arm in ARMS:
                other = [(e["kind"], e["axis"], e["shape"])
                         for e in r[f"{model_name}_{arm}"][f"decode_{ls}"]]
                assert rec == other, arm
            sums = sum(1 for k, a, _ in rec
                       if k == "all_reduce" and a == "model"
                       and _[-1] == cfg.d_model)
            assert sums == 2 * cfg.n_layers + 1
