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
    breaks a kernel's words or groups, the ssm and hybrid families, and
    the LoRA and QAT arms.
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
from repro_torch.train.serve import Engine, cache_dims
from _torch_threads import _one_torch_thread  # noqa: F401


KW = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512)


def _jcfg(kind):
    if kind.startswith("moe"):
        cfg = jconfigs.make_tiny(jconfigs.get_config("mixtral-8x7b"))
        if kind == "moe_expert":
            cfg = cfg.replace(moe=cfg.moe.__class__(
                **{**cfg.moe.__dict__, "expert_sharding": "expert"}))
        return cfg.replace(tuning=JTuning(mode="peqa"),
                           quant=JQuant(bits=4, n_grid=2))
    mode = {"lora": "lora", "full": "full"}.get(kind, "peqa")
    layout = "plane" if kind == "plane" else "nibble"
    return jconfigs.paper_lm(**KW).replace(
        tuning=JTuning(mode=mode), quant=JQuant(bits=4, n_grid=2,
                                                layout=layout))


TREES = ("dense", "plane", "lora", "full", "moe_tensor", "moe_expert")
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
    """The ssm and hybrid families are refused on a mesh; the moe, vlm and
    encdec families are served there (``tests/test_torch_dist_moe.py``,
    ``tests/test_torch_dist_families.py``) and refused where the model
    axis does not divide their heads or experts."""
    cfg = tconfigs.make_tiny(tconfigs.get_config(arch))
    registry.check_supported(cfg)
    if cfg.family in ("moe", "vlm", "encdec"):
        registry.check_supported(cfg, mesh=context.coords(1, 2))
        with pytest.raises(NotImplementedError, match="not divisible by "
                                                      "the model axis"):
            registry.check_supported(cfg, mesh=context.coords(1, 3))
        return
    with pytest.raises(NotImplementedError,
                       match="dense, moe, vlm and encdec families only"):
        registry.check_supported(cfg, mesh=context.coords(1, 2))


@pytest.mark.parametrize("mode", ["lora", "lora_optq", "qat"])
def test_arms_refused_on_a_mesh(mode):
    cfg = tconfigs.paper_lm(**KW).replace(tuning=TuningConfig(mode=mode))
    with pytest.raises(NotImplementedError, match=f"the {mode} arm"):
        registry.check_supported(cfg, mesh=context.coords(2, 2))


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
