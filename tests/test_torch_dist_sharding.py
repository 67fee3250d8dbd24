"""PyTorch port vs JAX reference: the partition rules and the shard cut
(``repro_torch.dist.sharding``), in one process.

  * ``spec_for_path`` gives the reference's spec for every leaf path of
    the reference's dense, bit-plane, LoRA, full and MoE (tensor- and
    expert-parallel) trees; ``validate_for_mesh`` the reference's problems;
    ``stacked_scale_specs`` the reference's on a resident stack.
  * ``cache_specs`` places the batch dim structurally when batch ==
    n_layers, as the reference's does (the data axes spelled as a tuple,
    which jax 0.9's ``PartitionSpec`` shortens to the axis name).
  * The shards of model ranks 0..M−1, cut from the whole quantized model
    (nibble, plane, per-group), put back together bit for bit
    (``unshard``); each linear is marked column- or row-parallel.
  * ``ScaleBank.local_nbytes`` is below ``nbytes`` and equals the
    reference's.
  * What this slice does not shard is refused with a reason: a KV-head
    count that neither divides the model axis nor is divided by it, head,
    d_ff or vocab counts it does not divide, a local input extent that
    breaks a kernel's words or groups, and ``lora_optq`` where it is
    refused off the mesh too; every family is accepted where the model
    axis divides it, and every arm (``lora_a`` / ``lora_b`` on the
    row-parallel ``wo`` the one LoRA exception to the reference's rules,
    ROADMAP §3).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.core.treepath import path_str
from repro.dist import sharding as jsharding
from repro.models import registry as jregistry
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core import scale_bank as sb
from repro_torch.dist import backend, context, sharding
from repro_torch.models import registry
from repro_torch.train.serve import Engine, cache_dims, cache_model_dims
from _torch_threads import _one_torch_thread  # noqa: F401


KW = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)


# the recurrent trees and their reference arch
RECURRENT = {"xlstm": "xlstm-125m", "zamba2": "zamba2-7b"}
# the places the port's rules differ from the reference's: Mamba2's
# B/C projections stay whole (every head's local scan reads all of
# d_state), where the reference's rule cuts them by output (ROADMAP §3)
SPEC_EXCEPTIONS = ("bproj", "cproj")
# and the one LoRA exception: the row-parallel wo's adapter cuts lora_a by
# input and keeps lora_b whole, where the reference cuts lora_b by output
# (ROADMAP §3); {leaf: (the port's spec, the reference's) at ndim 2}
LORA_WO = {"lora_a": ((None, "model"), ()), "lora_b": ((), ("model",))}


def _jcfg(kind):
    if kind in RECURRENT:
        return jconfigs.make_tiny(jconfigs.get_config(RECURRENT[kind])
                                  ).replace(tuning=JTuning(mode="peqa"),
                                            quant=JQuant(bits=4, n_grid=2))
    if kind.startswith("moe"):
        cfg = jconfigs.make_tiny(jconfigs.get_config("mixtral-8x7b"))
        if kind == "moe_expert":
            cfg = cfg.replace(moe=cfg.moe.__class__(
                **{**cfg.moe.__dict__, "expert_sharding": "expert"}))
        return cfg.replace(tuning=JTuning(mode="peqa"),
                           quant=JQuant(bits=4, n_grid=2))
    mode = {"lora": "lora", "full": "full", "qat": "qat",
            "qkvo16": "lora_optq"}.get(kind, "peqa")
    tun = dict(lora_rank=16, lora_targets=("wq", "wk", "wv", "wo")) \
        if kind == "qkvo16" else {}
    layout = "plane" if kind == "plane" else "nibble"
    return jconfigs.paper_lm(**KW).replace(
        tuning=JTuning(mode=mode, **tun),
        quant=JQuant(bits=4, n_grid=2, layout=layout))


TREES = ("dense", "plane", "lora", "qkvo16", "qat", "full", "moe_tensor",
         "moe_expert", "xlstm", "zamba2")
_cache = {}


def _tree(kind):
    if kind not in _cache:
        cfg = _jcfg(kind)
        rng = jax.random.PRNGKey(0)
        p, _ = jpolicies.prepare(jregistry.build(cfg).init(rng), cfg, rng)
        _cache[kind] = jax.tree.map(np.asarray, p)
    return _cache[kind]


def _flat(tree):
    return {path_str(kp): leaf
            for kp, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", TREES)
def test_spec_for_path_equals_reference(kind):
    flat = _flat(_tree(kind))
    assert any("model" in sharding.spec_for_path(p, np.ndim(a))
               for p, a in flat.items())
    for path, leaf in flat.items():
        want = tuple(jsharding.spec_for_path(path, np.ndim(leaf)))
        if any(p in SPEC_EXCEPTIONS for p in path.split("/")):
            assert "model" in want, path
            assert sharding.spec_for_path(path, np.ndim(leaf)) == (), path
            continue
        parts = path.split("/")
        if parts[-2] == "wo" and parts[-1] in LORA_WO:
            mine, theirs = LORA_WO[parts[-1]]
            nd = np.ndim(leaf)          # the reference's (L, …) stack
            assert want == tuple([None] * (nd - 2)) + theirs \
                if theirs else want == (), path
            assert sharding.spec_for_path(path, nd) == (
                tuple([None] * (nd - 2)) + mine if mine else ()), path
            continue
        assert sharding.spec_for_path(path, np.ndim(leaf)) == want, path
        # the port's per-layer tensors: the same rule one dim down
        if np.ndim(leaf) > 1 and path.startswith("layers/"):
            got = sharding.spec_for_path(path, np.ndim(leaf) - 1)
            assert got == tuple(jsharding.spec_for_path(
                path, np.ndim(leaf) - 1)), path


@pytest.mark.parametrize("model", [2, 3, 5])
@pytest.mark.parametrize("kind", ("dense", "plane", "moe_expert"))
def test_validate_for_mesh_equals_reference(kind, model):
    tree = _tree(kind)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": model},
                                 axis_names=("data", "model"))
    want = jsharding.validate_for_mesh(tree, mesh)
    assert sharding.validate_for_mesh(_flat(tree), mesh.shape) == want
    assert (want == []) == (model == 2)


def _port(cfg=None, seed=0):
    cfg = cfg or tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=2))
    api = registry.build(cfg, device="cpu")
    return cfg, api, policies.build(api, seed)[0]


def test_validate_for_mesh_on_a_module():
    _, _, model = _port()
    specs = sharding.param_specs(model)
    assert specs["layers.0.attn.wq.qw"] == ("model",)       # (N, K/8)
    assert specs["layers.1.mlp.down.qw"] == (None, "model")
    assert specs["layers.1.mlp.down.scale"] == ()
    assert specs["embed.emb"] == ("model",)
    assert sharding.validate_for_mesh(model, context.coords(2, 4)) == []
    probs = sharding.validate_for_mesh(model, {"data": 1, "model": 3})
    assert probs and all("not divisible by 3" in p for p in probs)


@pytest.mark.parametrize("with_dims", [True, False])
def test_cache_specs_equal_reference_at_batch_eq_layers(with_dims):
    jcfg = _jcfg("dense")
    tcfg, api, _ = _port()
    japi = jregistry.build(jcfg)
    ctx = context.coords(2, 4)
    jctx = types.SimpleNamespace(model_size=4, data_axes=("data",),
                                 model_axis="model")
    cache = api.init_cache(2, 16, device="meta")
    jcache = jax.eval_shape(lambda: japi.init_cache(2, 16))
    bdims = cache_dims(api.init_cache, 2, 8)[0] if with_dims else None
    jdims = jsharding.cache_batch_dims(japi.init_cache, 2, 16) \
        if with_dims else None
    got = sharding.cache_specs(ctx, cache, 2, True,
                               n_kv_heads=tcfg.n_kv_heads, batch_dims=bdims)
    want = jsharding.cache_specs(jctx, jcache, 2, True,
                                 n_kv_heads=jcfg.n_kv_heads, batch_dims=jdims)
    # jax 0.9's PartitionSpec spells the one-axis tuple ("data",) as "data"
    # (the spelling the reference's own mesh test trips on); the same axes
    one = lambda spec: tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                             else a for a in spec)
    assert {k: one(v) for k, v in got.items()} == \
        {k: one(tuple(v)) for k, v in want.items()}
    if with_dims:          # dim 0 is the layer stack, dim 1 the batch
        assert all(s[1] == ("data",) and s[0] is None and s[3] == "model"
                   for s in got.values())
    # the structural model dim (the dim the shard config cuts) places the
    # dense leaves as the reference's extent rule does
    local = registry.build(sharding.shard_config(tcfg, 4), device="cpu")
    mdims = cache_model_dims(api.init_cache, local.init_cache)
    assert mdims == {"k": 3, "v": 3}
    assert sharding.cache_specs(ctx, cache, 2, True,
                                n_kv_heads=tcfg.n_kv_heads, batch_dims=bdims,
                                model_dims=mdims) == got


# the recurrent leaves' model dim, the port's layout: (whole shape's dim
# the shard cuts, the reference's extent rule's)
RECURRENT_LAYOUT = {
    # (n_groups, B, H = n_kv_heads, hd): the sLSTM state whole, where the
    # reference's rule matches n_kv_heads; m_S (n_groups, n_m, B, H, hd +
    # 1, hd) on its heads, as the reference's
    "xlstm": {**{k: (-1, 2) for k in ("s_c", "s_n", "s_m", "s_h")},
              "m_S": (3, 3)},
    # the SSM state (G, every, B, H, hd, st) on H, where the reference's
    # fallback takes d_state; the conv window (…, d_conv − 1, d_inner) on
    # d_inner and the shared block's K/V on their heads, as the reference's
    "zamba2": {"ssm": (3, 5), "ssm_tail": (2, 4), "conv": (4, 4),
               "conv_tail": (3, 3), "attn_k": (3, 3), "attn_v": (3, 3)},
}


@pytest.mark.parametrize("kind", list(RECURRENT))
def test_cache_specs_recurrent_layout(kind):
    """``cache_specs(model_dims=)`` puts each recurrent leaf's model dim
    where the shard's pool holds it; the reference's extent rule gives
    the dense leaves' placement and misplaces the sLSTM state and the SSM
    state (``RECURRENT_LAYOUT``)."""
    jcfg = _jcfg(kind)
    tcfg = tconfigs.make_tiny(tconfigs.get_config(RECURRENT[kind])).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=2))
    api = registry.build(tcfg, device="cpu")
    local = registry.build(sharding.shard_config(tcfg, 2), device="cpu")
    japi = jregistry.build(jcfg)
    ctx = context.coords(1, 2)
    jctx = types.SimpleNamespace(model_size=2, data_axes=("data",),
                                 model_axis="model")
    cache = api.init_cache(2, 16, device="meta")
    jcache = jax.eval_shape(lambda: japi.init_cache(2, 16))
    bdims = cache_dims(api.init_cache, 2, 8)[0]
    mdims = cache_model_dims(api.init_cache, local.init_cache)
    got = sharding.cache_specs(ctx, cache, 2, False,
                               n_kv_heads=tcfg.n_kv_heads, batch_dims=bdims,
                               model_dims=mdims)
    want = jsharding.cache_specs(
        jctx, jcache, 2, False, n_kv_heads=jcfg.n_kv_heads,
        batch_dims=jsharding.cache_batch_dims(japi.init_cache, 2, 16))
    layout = RECURRENT_LAYOUT[kind]
    assert sorted(got) == sorted(layout)
    for key, (port, ref) in layout.items():
        assert mdims[key] == port, key
        assert [d for d, a in enumerate(got[key]) if a == "model"] == (
            [] if port < 0 else [port]), key
        assert [d for d, a in enumerate(tuple(want[key]))
                if a == "model"] == [ref], key
        # the pool the shard config makes is the rank's block of the spec
        whole, mine = cache[key].shape, local.init_cache(2, 16,
                                                         device="meta")[key]
        assert sharding.local_shape(whole, got[key], ctx.axis_sizes) == \
            tuple(mine.shape), key


def test_stacked_scale_specs_equal_reference():
    _, _, model = _port()
    base = sb.extract_scales(model, include_zero=True)
    stack = sb.stack_scales(base, [base, base, base])
    got = sharding.stacked_scale_specs(stack)
    want = jsharding.stacked_scale_specs(stack)

    def walk(g, w):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k])
        else:
            assert g == tuple(w)
    walk(got, want)
    assert got["layers"]["attn"]["wq"]["scale"] == (None, None, "model")
    assert got["layers"]["attn"]["wo"]["scale"] == ()
    with pytest.raises(ValueError, match="non-scale leaf"):
        sharding.stacked_scale_specs({"layers": {"wq": {"qw": base[
            "layers/attn/wq/scale"]}}})


def _cut_and_check(cfg, model, m):
    shards = [sharding.shard_model(model, cfg, context.coords(1, m, 0, r))
              for r in range(m)]
    whole = sharding.unshard(shards)
    mine = dict((*model.named_parameters(), *model.named_buffers()))
    assert sorted(whole) == sorted(mine)
    for name, t in mine.items():
        assert whole[name].dtype == t.dtype and torch.equal(whole[name], t), \
            name
    return shards


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("layout", ["nibble", "plane"])
def test_cut_then_unshard_is_the_whole_model(layout, m):
    cfg = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, n_grid=2, layout=layout))
    _, _, model = _port(cfg)
    shards = _cut_and_check(cfg, model, m)
    lin = shards[1].layers[0]
    assert lin.attn.wq.tp == lin.mlp.up.tp == lin.mlp.gate.tp == "col"
    assert lin.attn.wo.tp == lin.mlp.down.tp == "row"
    assert lin.attn.wq.out_features == KW["d_model"] // m
    assert lin.mlp.down.in_features == KW["d_ff"] // m
    assert shards[1].embed.vocab_start == KW["vocab"] // m
    assert all(t.is_contiguous() for t in shards[1].buffers())
    # the shards share no storage with the whole model
    ptrs = {t.data_ptr() for t in (*model.parameters(), *model.buffers())}
    assert not ptrs & {t.data_ptr() for t in shards[0].parameters()}


def test_cut_per_group_scales():
    cfg = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, n_grid=2, group_size=32))
    _, _, model = _port(cfg)
    shards = _cut_and_check(cfg, model, 2)
    for r, s in enumerate(shards):
        wo = s.layers[0].attn.wo
        assert wo.scale.shape == (KW["d_model"], KW["d_model"] // 32)
        assert wo.tp_groups == (2 * r, 2 * r + 2)


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_local_nbytes_equals_reference(shape):
    _, _, model = _port()
    bank = sb.ScaleBank()
    bank.add("A", model, include_zero=True)
    jbank = jsb.ScaleBank()
    jbank.tasks["A"] = bank.tasks["A"]
    ctx = context.coords(*shape)
    jctx = types.SimpleNamespace(axis_sizes=ctx.axis_sizes)
    assert bank.local_nbytes("A", ctx) < bank.nbytes("A")
    assert bank.local_nbytes("A", ctx) == jbank.local_nbytes("A", jctx)
    assert bank.local_nbytes("A") == bank.nbytes("A")
    # a rank's block of the set is what apply_scales installs
    local = sharding.shard_model(model, _port()[0], ctx)
    sb.apply_scales(local, bank.tasks["A"], ctx=ctx)
    assert local.layers[1].attn.wq.scale.shape[0] == KW["d_model"] // shape[1]


@pytest.mark.parametrize("change,m,what", [
    (dict(n_heads=6, n_kv_heads=2, d_model=96), 3, "n_kv_heads=2 neither "
     "divides nor is divided by the model axis (3)"),
    (dict(vocab_size=511), 2, "vocab_size=511"),
    (dict(d_ff=250), 4, "d_ff=250"),
    (dict(quant=QuantConfig(bits=4, group_size=64)), 4, "groups of 64"),
    (dict(quant=QuantConfig(bits=4, layout="plane"), d_model=96), 2,
     "32-code words")],
    ids=["mqa", "vocab", "d_ff", "group", "plane_word"])
def test_unshardable_configs_refused(change, m, what):
    cfg = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"), **change)
    probs = sharding.shard_problems(cfg, m)
    assert any(what in p for p in probs), probs
    with pytest.raises(NotImplementedError, match="not served on a"):
        registry.check_supported(cfg, mesh=context.coords(1, m))


@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS
                                  if tconfigs.get_config(a).family != "dense"
                                  or tconfigs.get_config(a).moe is not None])
def test_other_families_refused_on_a_mesh(arch):
    """Every other family — moe, vlm, encdec, ssm and hybrid — is served
    on a mesh (``tests/test_torch_dist_moe.py``,
    ``tests/test_torch_dist_families.py``,
    ``tests/test_torch_dist_recurrent.py``) and refused only where the
    model axis does not divide its heads or experts."""
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch))
    registry.check_supported(cfg)
    registry.check_supported(cfg, mesh=context.coords(1, 2))
    with pytest.raises(NotImplementedError, match="not divisible by "
                                                  "the model axis"):
        registry.check_supported(cfg, mesh=context.coords(1, 3))


@pytest.mark.parametrize("mode", ["lora", "lora_optq", "qat"])
def test_arms_accepted_on_a_mesh(mode):
    """Every arm is served and trained on a mesh (``tests/
    test_torch_dist_arms*.py``): the dense and vlm families under each,
    every other family under ``lora`` and ``qat``."""
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
            tuning=TuningConfig(mode=mode))
        if mode == "lora_optq" and cfg.family not in ("dense", "vlm"):
            continue
        registry.check_supported(cfg, mesh=context.coords(2, 2))
        registry.check_supported(cfg, mesh=context.coords(1, 2), train=True,
                                 batch=4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b",
                                  "whisper-medium", "xlstm-125m",
                                  "zamba2-7b"])
def test_lora_optq_refusals_hold_on_a_mesh(arch):
    """``lora_optq``'s refusals off the mesh (no OPTQ backbone for MoE,
    encdec, ssm or hybrid) hold on it, word for word."""
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode="lora_optq"))
    with pytest.raises(NotImplementedError) as off:
        registry.check_supported(cfg)
    with pytest.raises(NotImplementedError) as on:
        registry.check_supported(cfg, mesh=context.coords(1, 2), train=True)
    assert str(on.value) == str(off.value)
    assert "lora_optq on" in str(on.value)


def test_lora_optq_planes_refused_on_a_mesh():
    cfg = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="lora_optq"),
        quant=QuantConfig(bits=4, layout="plane"))
    with pytest.raises(NotImplementedError) as off:
        registry.check_supported(cfg)
    with pytest.raises(NotImplementedError) as on:
        registry.check_supported(cfg, mesh=context.coords(1, 2))
    assert str(on.value) == str(off.value)
    assert "lora_optq on layout='plane' is refused" in str(on.value)


@pytest.mark.parametrize("path,ndim,share,kind", [
    ("layers/attn/wq/lora_a", 2, 1, "partial"),
    ("layers/attn/wq/lora_b", 2, 1, "sharded"),
    ("layers/attn/wk/lora_b", 2, 2, "partial"),
    ("layers/attn/wv/lora_b", 2, 1, "sharded"),
    ("layers/attn/wo/lora_a", 2, 1, "sharded"),
    ("layers/attn/wo/lora_b", 2, 1, "partial"),
    ("layers/attn/wo/lora_b", 3, 2, "partial"),
    ("layers/attn/wo/w", 2, 1, "sharded"),
    ("layers/attn/wo/scale", 2, 1, "partial")])
def test_lora_and_qat_leaf_kinds(path, ndim, share, kind):
    """A LoRA leaf kept whole on a split linear has a model-partial
    gradient; QAT's leaves are PEQA's and full mode's."""
    assert sharding.leaf_kind(path, ndim, share) == kind


def test_engine_takes_the_rank_shard_only():
    cfg, api, model = _port()
    ctx = context.coords(1, 2, device="cpu")
    with pytest.raises(ValueError, match="shard_model"):
        Engine(api, model, ctx=ctx)
    odd = cfg.replace(vocab_size=510)
    with pytest.raises(ValueError, match="logitshard needs vocab 510"):
        Engine(registry.build(odd, device="cpu"), model,
               ctx=context.coords(1, 4), logitshard=True)
    # a coords context cuts a shard but runs no collective
    local = sharding.shard_model(model, cfg, ctx)
    with pytest.raises(RuntimeError, match="no process groups"):
        Engine(api, local, ctx=ctx).generate(np.zeros((1, 4), np.int64), 2)


@pytest.mark.parametrize("bf16_reduce", [False, True])
def test_cut_marks_the_reduce_dtype(bf16_reduce):
    """The cut records ``cfg.bf16_reduce`` on every row-parallel linear,
    which ``row_reduce`` reads: the activation dtype under it, else
    float32; column-parallel linears reduce nothing and carry no mark."""
    cfg = tconfigs.paper_lm(**KW).replace(
        tuning=TuningConfig(mode="peqa"), bf16_reduce=bf16_reduce)
    _, _, model = _port(cfg)
    local = sharding.shard_model(model, cfg, context.coords(1, 2, 0, 1))
    for layer in local.layers:
        for lin in (layer.attn.wo, layer.mlp.down):
            assert lin.tp_reduce_bf16 is bf16_reduce
        for lin in (layer.attn.wq, layer.mlp.up):
            assert not hasattr(lin, "tp_reduce_bf16")


def test_engine_refuses_a_shard_off_the_context_device():
    """A rank's shard must already lie where its mesh context says: the
    engine refuses one elsewhere instead of moving it there."""
    cfg, api, model = _port()
    local = sharding.shard_model(model, cfg, context.coords(1, 2, 0, 1))
    with pytest.raises(ValueError, match="shard lies on meta"):
        Engine(api, local.to("meta"), ctx=context.coords(1, 2, 0, 1,
                                                         device="cpu"))


def test_rank_device_is_the_card_unless_asked(monkeypatch):
    """``backend.device()`` — what ``make_ctx``, ``make_debug_mesh`` and a
    ``coords`` context default to — is where ``backend.init`` placed the
    rank, else the card (refused here, where there is none); never the CPU
    unless it is asked for."""
    assert backend.device("cpu") == torch.device("cpu")
    assert context.coords(1, 2).device is None
    monkeypatch.setattr(backend, "_rank_device", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.device()
    monkeypatch.setattr(backend, "_rank_device", torch.device("cpu"))
    assert backend.device() == torch.device("cpu")
