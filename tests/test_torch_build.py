"""The layer-by-layer build (``core.policies.build``) against the whole
build (``api.init`` then ``policies.prepare``), on the CPU.

A quantizing arm's model is built block by block: each block's float32
weights are drawn and quantized before the next block exists.  The draws
come in the whole build's order, so every tensor — codes, scales, zeros,
biases, norms, the table, the head, a LoRA arm's adapter — must be
bit-equal to the whole build's.  Configurations: ``make_tiny`` of
llama3.2-1b (tied head), qwen2-7b (q/k/v biases, untied head) and
llava-next-mistral-7b, under ``peqa``, ``peqa_z`` and ``lora_optq``, with
nibble and bit-plane codes (``lora_optq`` refuses planes), per-channel and
in groups; the fp arms (``full``, ``lora``, ``qat``) take the whole build
unchanged.  The draw order itself is pinned against a walk over a whole
model's ``modules()``, as the port drew before the build streamed.
"""
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.models import linear, registry, transformer
from _torch_threads import _one_torch_thread  # noqa: F401


ARCHS = ("llama3.2-1b", "qwen2-7b", "llava-next-mistral-7b")


def _cfg(arch, mode, **quant):
    return tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode), quant=QuantConfig(n_grid=4, **quant))


def _tensors(model):
    return dict(list(model.named_parameters()) + list(model.named_buffers()))


def _assert_equal_models(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert ta[name].dtype == tb[name].dtype, name
        assert torch.equal(ta[name], tb[name]), name
    for (name, ma), (_, mb) in zip(a.named_modules(), b.named_modules()):
        if isinstance(ma, linear.Linear):
            assert ma.spec == mb.spec, name


CASES = [(arch, mode, quant) for arch in ARCHS
         for mode, quant in (("peqa", {}),
                             ("peqa", dict(layout="plane")),
                             ("peqa", dict(group_size=32, bits=3)),
                             ("peqa_z", {}),
                             ("peqa_z", dict(layout="plane", group_size=32)),
                             ("lora_optq", {}))]


@pytest.mark.parametrize("arch,mode,quant", CASES)
def test_streamed_build_is_bit_equal_to_the_whole_build(arch, mode, quant):
    cfg = _cfg(arch, mode, **quant)
    api = registry.build(cfg, device="cpu")
    streamed, smask = policies.build(api, 5)
    whole, wmask = policies.prepare(api.init(5), cfg, device="cpu")
    assert smask == wmask
    assert any(getattr(m, "quantized", False) for m in streamed.modules())
    _assert_equal_models(streamed, whole)
    if cfg.tie_embeddings:
        assert streamed.lm_head is None
    else:
        assert "w" in streamed.lm_head._parameters   # the head stays fp


@pytest.mark.parametrize("mode", ["full", "lora", "qat"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-7b"])
def test_fp_arms_take_the_whole_build(arch, mode):
    cfg = _cfg(arch, mode)
    api = registry.build(cfg, device="cpu")
    built, bmask = policies.build(api, 2)
    whole, wmask = policies.prepare(api.init(2), cfg, device="cpu")
    assert bmask == wmask
    assert not any(getattr(m, "quantized", False) for m in built.modules())
    _assert_equal_models(built, whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_draw_order_is_a_walk_over_the_whole_model(arch):
    """``api.init`` (block by block, from ``meta``) draws what the port's
    earlier whole-model init drew: the table, then every linear in
    ``modules()`` order of a model made whole."""
    cfg = _cfg(arch, "full")
    gen = torch.Generator().manual_seed(9)
    old = transformer.Transformer(cfg, device="cpu")
    old.embed.reset_parameters(gen)
    for mod in old.modules():
        if isinstance(mod, linear.Linear):
            mod.reset_parameters(gen)
    new = registry.build(cfg, device="cpu").init(9)
    assert all(t.device.type == "cpu" for t in _tensors(new).values())
    _assert_equal_models(new, old)


def test_each_block_is_quantized_before_the_next_exists():
    """``api.init``'s transform sees block 0, block 1, …, the head in
    order; when it is handed a piece, every earlier block already holds
    codes in place of its float32 weights (the transform here is the one
    ``policies.build`` passes)."""
    cfg = _cfg("qwen2-7b", "peqa").replace(n_layers=4)
    api = registry.build(cfg, device="cpu")
    seen = []

    def transform(name, mod):
        for done_name, done in seen:
            assert all(m.quantized for m in done.modules()
                       if isinstance(m, linear.Linear)), done_name
        seen.append((name, mod))
        policies.peqa.quantize_module(mod, cfg.quant, prefix=name)

    model = api.init(0, transform=transform)
    assert [name for name, _ in seen] == [f"layers.{i}" for i in range(4)] \
        + ["lm_head"]
    assert all(t.device.type == "cpu" for t in _tensors(model).values())
    # lm_head is excluded from quantization: it alone keeps its fp weight
    fp = [n for n, m in model.named_modules()
          if isinstance(m, linear.Linear) and not m.quantized]
    assert fp == ["lm_head"]
    _assert_equal_models(model, policies.build(api, 0)[0])
