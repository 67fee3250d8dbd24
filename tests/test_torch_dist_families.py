"""PyTorch port vs JAX reference: the vlm and encdec families and KV heads
fewer than the model ranks, cut and served on a (data, model) mesh.

Configurations: ``make_tiny`` of llava-next-mistral-7b (vlm: 8 prefix
rows), whisper-medium (encdec: 2 encoder layers over 12 frames) and
granite-34b (one KV head: MQA), PEQA 4-bit, float32; for the cut also
granite with q/k/v biases and tiny llama3.2-1b with 2 KV heads (GQA).

  * The cut: the shards of model ranks 0..M−1 put back together bit for
    bit (``unshard``) — n_kv 1 at M 2 and 4, n_kv 2 at M 4 (two ranks a
    KV head), llava and whisper at M 2 and 4 —; a shared KV head's
    ``wk``/``wv`` (codes, scales, zeros, bias) is the same on the ranks
    that share it, marked ``tp = "kv"``, and is the one their query heads
    group onto; whisper's cross-attention q/k/v are column-parallel and
    its ``wo`` row-parallel, its positions and norms whole.
  * ``spec_for_path``'s grouped rule (``KVGroup``), ``leaf_kind``,
    ``cache_specs`` (the KV-head dim where the reference shards head_dim)
    and ``local_shape``; ``validate_for_mesh`` on the reference's own
    trees equals the reference's (empty), and on the shards.
  * Serving, from gloo ranks (``_torch_dist_ranks.py::
    families_serve_rank``, one spawn a mesh, one intra-op thread) at
    (1, 2) and (2, 2): ``generate`` with the image or frame prefix, with
    and without logitshard, gives the reference host ``Engine``'s tokens
    and the port's unsharded engine's (run on rank 0); the prefill logits
    hold to the reference's within rtol 1e-5, atol 1e-4 (float32: the
    row-parallel sums add in another order); a logitshard decode step
    gathers no vocab-extent tensor, one without; drain serving of the
    reference's ``family_workload`` (prefixes included) gives the
    unsharded engine's tokens; the slot pool's cache leaves are the rank's
    blocks of ``cache_specs``; a task swap moves no collective, fewer
    bytes than the whole set, and leaves the shard equal to the cut of the
    swapped whole model.
  * The refusals that remain, word for word: ssm and hybrid on a mesh,
    the LoRA and QAT arms, and a KV-head count that neither divides the
    model axis nor is divided by it.
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
from repro.dist import sharding as jsharding
from repro.launch.serve import family_workload as jfamily_workload
from repro.models import registry as jregistry
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core.peqa import ref_path
from repro_torch.dist import backend, context, sharding
from repro_torch.launch.serve import family_workload
from repro_torch.models import registry

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ARCHS = {"llava": "llava-next-mistral-7b", "whisper": "whisper-medium",
         "granite": "granite-34b"}
# the cut's configurations beyond the served ones: (arch, changes)
CUTS = {**{n: (a, {}) for n, a in ARCHS.items()},
        "granite_bias": ("granite-34b", dict(qkv_bias=True)),
        "gqa2": ("llama3.2-1b", dict(n_kv_heads=2))}
CUT_M = [("llava", 2), ("llava", 4), ("whisper", 2), ("whisper", 4),
         ("granite", 2), ("granite", 4), ("granite_bias", 2),
         ("gqa2", 4)]
B, S, N_NEW = 4, 6, 5
CASE_MESH = [(n, k) for n in ARCHS for k in MESHES]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]


def _cfgs(name):
    arch, change = CUTS[name]
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode="peqa"), quant=JQuant(bits=4, n_grid=2),
        **change)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=2),
        **change)
    return j, t


def _prefix(cfg, seed=3):
    """The prompt's per-row prefix: image embeddings (vlm), frames
    (encdec), or None."""
    rows = {"vlm": cfg.n_img_tokens, "encdec": cfg.enc_frames}.get(
        cfg.family)
    if rows is None:
        return None
    return np.random.default_rng(seed).normal(
        size=(B, rows, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's PEQA tree of a cut configuration (numpy leaves)."""
    jcfg, _ = _cfgs(name)
    key = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(key), jcfg, key)
    return to_numpy(p)


def _model(name):
    _, tcfg = _cfgs(name)
    return tcfg, bridge.to_module(_tree(name), tcfg, device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("families"))
    prompt = np.random.default_rng(1).integers(0, 512, (B, S)).astype(
        np.int32)
    ref, cases, prefixes, reqs = {}, {}, {}, {}
    for name in ARCHS:
        jcfg, tcfg = _cfgs(name)
        p = _tree(name)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), p)
        api = jregistry.build(jcfg)
        pre = _prefix(tcfg)
        batch = {"tokens": jnp.asarray(prompt)}
        jpre = None
        if pre is not None:
            jpre = jnp.asarray(pre)
            batch[api.caps.prefix_key] = jpre
        jp = jax.tree.map(jnp.asarray, p)
        ref[name] = {
            "tokens": np.asarray(JEngine(api, jp).generate(
                jnp.asarray(prompt), n_new=N_NEW, prefix=jpre)),
            "logits": np.asarray(api.prefill(jp, batch)[0])}
        cases[name] = tcfg
        prefixes[name] = None if pre is None else torch.from_numpy(pre)
        reqs[name] = family_workload(tcfg)
        # the port's stream is the reference's, prefixes included
        for r, jr in zip(reqs[name], jfamily_workload(jcfg)):
            assert np.array_equal(r.tokens, jr.tokens)
            assert (r.prefix is None) == (jr.prefix is None)
            if r.prefix is not None:
                assert np.array_equal(r.prefix, jr.prefix)
    out = {"ref": ref, "cases": cases}
    for key, shape in MESHES.items():
        world = shape[0] * shape[1]
        backend.spawn(ranks.families_serve_rank, world, "cpu", shape, tmp,
                      cases, torch.from_numpy(prompt), prefixes, N_NEW, reqs,
                      threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"famserve{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_generate_matches_reference(run, name, key):
    want = run["ref"][name]
    host = run[key][0][name]["host_tokens"]
    for r in run[key]:
        res = r[name]
        for ls in (True, False):
            np.testing.assert_array_equal(res[f"tokens_{ls}"].numpy(),
                                          want["tokens"])
        assert torch.equal(res["tokens_True"], host)
        _close(res["logits"], want["logits"])


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_logitshard_decode_gathers_no_vocab(run, name, key):
    vocab = run["cases"][name].vocab_size
    for r in run[key]:
        res = r[name]
        assert context.allgather_extent_count(res["decode_True"], vocab) == 0
        assert context.allgather_extent_count(res["decode_False"],
                                              vocab) >= 1


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_drain_serving_equals_unsharded(run, name, key):
    want = run[key][0][name]["host_drain"]
    for r in run[key]:
        got = r[name]["drain"]
        assert got["tokens"] == want["tokens"]
        assert all(t is not None for t in got["tokens"])
        assert got["steps"] == want["steps"]


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_pool_cache_is_the_rank_block_of_cache_specs(run, name, key):
    cfg, shape = run["cases"][name], MESHES[key]
    for r in run[key]:
        res = r[name]
        assert res["pool_shapes"] == res["spec_shapes"]
        heads = res["pool_shapes"]["k"][3]
        assert heads == max(cfg.n_kv_heads // shape[1], 1)
        assert res["kv_share"] == (shape[1] if cfg.n_kv_heads == 1 else 1)


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_swap_is_local(run, name, key):
    for r in run[key]:
        res = r[name]
        assert res["swap_record"] == []
        assert res["swap_equal"]
        assert res["local_nbytes"] < res["nbytes"]


@pytest.mark.parametrize("name,m", CUT_M, ids=[f"{n}-{m}" for n, m in CUT_M])
def test_cut_then_unshard_is_the_whole_model(name, m):
    cfg, model = _model(name)
    shards = [sharding.shard_model(model, cfg, context.coords(1, m, 0, r))
              for r in range(m)]
    whole = sharding.unshard(shards)
    mine = dict((*model.named_parameters(), *model.named_buffers()))
    assert sorted(whole) == sorted(mine)
    for n, t in mine.items():
        assert whole[n].dtype == t.dtype and torch.equal(whole[n], t), n
    share = sharding.kv_share(cfg, m)
    assert all(s.kv_share == share for s in shards)
    stack = shards[1].dec if cfg.family == "encdec" else shards[1]
    layer = stack.layers[0]
    assert layer.attn.wq.tp == "col" and layer.attn.wo.tp == "row"
    assert layer.attn.wq.out_features == cfg.n_heads * cfg.d_head // m
    kv = layer.attn.wk
    if share > 1:
        assert kv.tp == "kv" and kv.out_features == cfg.d_head
        # the ranks of a group hold the same KV head: the one rank r's
        # query heads r·H/M … group onto (head r // share of n_kv)
        for r, s in enumerate(shards):
            lin = s.layers[0].attn.wk
            head = r * (cfg.n_heads // m) // (cfg.n_heads // cfg.n_kv_heads)
            assert head == r // share
            rows = slice(head * cfg.d_head, (head + 1) * cfg.d_head)
            assert torch.equal(lin.qw, model.layers[0].attn.wk.qw[rows])
            assert torch.equal(lin.scale,
                               model.layers[0].attn.wk.scale[rows])
            if cfg.qkv_bias:
                assert torch.equal(lin.b, model.layers[0].attn.wk.b[rows])
    else:
        assert kv.tp == "col"
        assert kv.out_features == cfg.n_kv_heads * cfg.d_head // m
    if cfg.family == "encdec":
        xa = layer.xattn
        assert xa.wq.tp == xa.wk.tp == xa.wv.tp == "col"
        assert xa.wo.tp == "row"
        assert xa.wk.out_features == cfg.n_kv_heads * cfg.d_head // m
        enc = shards[1].enc
        assert enc.layers[0].mlp.down.tp == "row"
        assert torch.equal(enc.pos, model.enc.pos)
        assert torch.equal(stack.pos, model.dec.pos)
        assert stack.embed.vocab_start == cfg.vocab_size // m
        assert torch.equal(layer.ln2.b, model.dec.layers[0].ln2.b)
    flat = {ref_path(n): t
            for n, t in (*model.named_parameters(), *model.named_buffers())}
    assert sharding.validate_for_mesh(flat, {"data": 1, "model": m},
                                      kv_share=share) == []


def test_grouped_kv_rule():
    g2 = sharding.KVGroup(2)
    assert sharding.spec_for_path("layers/attn/wk/qw", 3) == \
        (None, "model")
    assert sharding.spec_for_path("layers/attn/wk/qw", 3, kv_share=2) == \
        (None, g2)
    assert sharding.spec_for_path("layers/attn/wv/scale", 2, kv_share=2) \
        == (g2,)
    assert sharding.spec_for_path("layers/attn/wk/b", 2, kv_share=2) == \
        (None, g2)
    for path in ("layers/attn/wq/qw", "layers/attn/wo/qw",
                 "layers/mlp/up/scale", "layers/ln1/g"):
        assert sharding.spec_for_path(path, 3, kv_share=2) == \
            sharding.spec_for_path(path, 3)
    assert sharding.leaf_kind("layers/attn/wk/scale", 2, 2) == \
        sharding.PARTIAL
    assert sharding.leaf_kind("layers/attn/wk/scale", 2) == sharding.SHARDED
    assert sharding.leaf_kind("layers/attn/wq/scale", 2, 2) == \
        sharding.SHARDED
    granite = tconfigs.make_tiny(tconfigs.get_config("granite-34b"))
    assert [sharding.kv_share(granite, m) for m in (1, 2, 4)] == [1, 2, 4]
    gqa = granite.replace(n_kv_heads=2)
    assert [sharding.kv_share(gqa, m) for m in (2, 4)] == [1, 2]
    assert sharding.model_block(g2, 4, 3) == (2, 1)
    assert sharding.local_shape((4, 32), (None, g2), {"data": 1,
                                                      "model": 4}) == (4, 16)
    # the cache: the reference shards head_dim where the KV heads do not
    # divide the model axis; the port keeps each rank's KV head whole
    shape = (2, 4, 24, 1, 16)
    cache = {"k": np.zeros(shape, np.float32)}
    ctx = context.coords(1, 2)
    jctx = type("C", (), {"model_size": 2, "model_axis": "model",
                          "data_axes": ("data",)})()
    want = tuple(jsharding.cache_specs(jctx, cache, 4, False,
                                       n_kv_heads=1)["k"])
    assert sharding.cache_specs(ctx, cache, 4, False, n_kv_heads=1)["k"] \
        == want == (None, None, None, None, "model")
    assert sharding.cache_specs(ctx, cache, 4, False, n_kv_heads=1,
                                kv_share=2)["k"] == (
        None, None, None, sharding.KVGroup(2), None)


@pytest.mark.parametrize("name", list(ARCHS))
def test_validate_reference_trees(name):
    """The port's rules on the reference's own tree give the reference's
    problems (none) at M = 2 and 4, and the grouped rule none either."""
    tree = _tree(name)
    flat = bridge._flatten(tree)
    _, tcfg = _cfgs(name)
    for m in (2, 4):
        mesh = {"data": 1, "model": m}
        jmesh = type("M", (), {"shape": mesh,
                               "axis_names": tuple(mesh)})()
        want = jsharding.validate_for_mesh(tree, jmesh)
        assert want == []
        assert sharding.validate_for_mesh(flat, mesh) == want
        assert sharding.validate_for_mesh(
            flat, mesh, kv_share=sharding.kv_share(tcfg, m)) == []


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_recurrent_families_refused_on_a_mesh(arch):
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch))
    registry.check_supported(cfg)
    with pytest.raises(NotImplementedError) as e:
        registry.check_supported(cfg, mesh=context.coords(1, 2))
    assert str(e.value) == (
        f"{cfg.name}: not served on a (1, 2) mesh: "
        + registry.MESH_FAMILY_REASON.format(fam=cfg.family))


@pytest.mark.parametrize("arch", list(ARCHS.values()))
@pytest.mark.parametrize("mode", ["lora", "qat"])
def test_arms_refused_on_a_mesh(arch, mode):
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode))
    with pytest.raises(NotImplementedError) as e:
        registry.check_supported(cfg, mesh=context.coords(1, 2), train=True)
    assert str(e.value) == (f"{cfg.name}: not trained on a (1, 2) mesh: "
                            + registry.MESH_ARM_REASON.format(mode=mode))


def test_kv_heads_that_neither_divide_refused():
    cfg = tconfigs.make_tiny(tconfigs.get_config("llama3.2-1b")).replace(
        tuning=TuningConfig(mode="peqa"), n_heads=6, n_kv_heads=2,
        vocab_size=384, d_ff=192)
    assert sharding.shard_problems(cfg, 3) == [
        "n_kv_heads=2 neither divides nor is divided by the model axis "
        "(3): a rank holds whole KV heads, or one KV head that model ranks "
        "share"]
    with pytest.raises(NotImplementedError, match="neither divides"):
        registry.check_supported(cfg, mesh=context.coords(1, 3))
    assert sharding.shard_problems(cfg, 2) == []
    assert sharding.shard_problems(cfg.replace(n_kv_heads=1), 3) == []
