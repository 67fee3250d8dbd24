"""PyTorch port vs JAX reference: weight bridge, PEQA decomposition, and the
dense model's prefill and decode step.

Configuration: ``make_tiny(get_config("llama3.2-1b"))`` with 2 KV heads
(GQA), float32, PEQA 4-bit.  The reference makes the weights; both packages
quantize them; the reference runs under ``force_impl("interpret")`` so its
quantized linears are the Pallas kernels themselves.

Tolerances: codes bit-equal, scales and zeros rtol 1e-6; logits atol/rtol
1e-4 (float32, different summation orders and transcendental libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import peqa as jpeqa
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs.base import MoEConfig
from repro_torch.core import peqa, policies
from repro_torch.models import registry

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = tiny_llama_pair()
    fp, jq = reference_params(jcfg)
    return jcfg, tcfg, to_numpy(fp), jq


def _port_quantized(tcfg, fp_np):
    model = bridge.to_module(fp_np, tcfg, device="cpu")
    return peqa.quantize_params(model, tcfg.quant, device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_match(ref, port):
    assert jax.tree.structure(ref) == jax.tree.structure(port)
    for (path, a), b in zip(_leaves(ref), jax.tree.leaves(port)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.uint32:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


def test_bridge_round_trip_fp(pair):
    _, tcfg, fp_np, _ = pair
    back = bridge.to_tree(bridge.to_module(fp_np, tcfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(fp_np)
    for a, b in zip(jax.tree.leaves(fp_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)


def test_bridge_round_trip_peqa_and_paths(pair):
    _, tcfg, _, jq = pair
    jq_np = to_numpy(jq)
    model = bridge.to_module(jq_np, tcfg, device="cpu")
    names = dict(model.named_buffers())
    assert names["layers.1.attn.wq.qw"].dtype == torch.int32
    np.testing.assert_array_equal(
        names["layers.1.attn.wq.qw"].numpy().view(np.uint32),
        jq_np["layers"]["attn"]["wq"]["qw"][1])
    back = bridge.to_tree(model)
    for a, b in zip(jax.tree.leaves(jq_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)


def test_bridge_rejects_mismatched_tree(pair):
    _, tcfg, fp_np, _ = pair
    extra = dict(fp_np, stray={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        bridge.to_module(extra, tcfg, device="cpu")
    missing = {k: v for k, v in fp_np.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        bridge.to_module(missing, tcfg, device="cpu")


def test_quantize_params_matches_reference(pair):
    _, tcfg, fp_np, jq = pair
    _assert_trees_match(to_numpy(jq),
                        bridge.to_tree(_port_quantized(tcfg, fp_np)))


def test_model_size_bytes_matches_reference(pair):
    jcfg, tcfg, fp_np, jq = pair
    assert peqa.model_size_bytes(_port_quantized(tcfg, fp_np), tcfg.quant) \
        == jpeqa.model_size_bytes(jq, jcfg.quant)


def test_prefill_and_decode_logits_match_reference(pair):
    jcfg, tcfg, fp_np, jq = pair
    japi = jregistry.build(jcfg)
    api = registry.build(tcfg, device="cpu")
    model = _port_quantized(tcfg, fp_np)
    toks = tokens(2, 10, tcfg.vocab_size)
    with jops.force_impl("interpret"):
        jl, jcache = japi.prefill(jq, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4, rtol=1e-4)

    # decode two steps against a cache with headroom, position 10 then 11
    cap = 16
    jfull = japi.init_cache(2, cap)
    jfull = jax.tree.map(lambda d, s: d.at[:, :, :10].set(s), jfull, jcache)
    tfull = api.init_cache(2, cap)
    for key in tfull:
        tfull[key][:, :, :10] = tcache[key]
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for pos in (10, 11):
        with jops.force_impl("interpret"):
            jl, jfull = japi.decode_step(jq, jfull, jnp.asarray(nxt),
                                         jnp.int32(pos))
        with torch.inference_mode():
            tl, tfull = api.decode_step(model, tfull, torch.from_numpy(nxt),
                                        pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    np.testing.assert_allclose(tfull["v"].numpy(), np.asarray(jfull["v"]),
                               atol=1e-4, rtol=1e-4)


def test_full_precision_prefill_matches_reference():
    """The fp storage mode (tuning 'full') through the same model code."""
    jcfg, tcfg = tiny_llama_pair(mode="full")
    fp, _ = reference_params(jcfg, seed=1)
    toks = tokens(2, 6, tcfg.vocab_size, seed=1)
    jl, _ = jregistry.build(jcfg).prefill(fp, {"tokens": jnp.asarray(toks)})
    model = bridge.to_module(to_numpy(fp), tcfg, device="cpu")
    with torch.inference_mode():
        tl, _ = registry.build(tcfg, device="cpu").prefill(
            model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_policies_masks(pair):
    _, tcfg, fp_np, _ = pair
    model, mask = policies.prepare(bridge.to_module(fp_np, tcfg, device="cpu"),
                                   tcfg, device="cpu")
    trainable = {k for k, v in mask.items() if v}
    assert trainable and all(k.endswith("scale") for k in trainable)
    assert all(p.requires_grad == mask[k]
               for k, p in model.named_parameters())
    full = tcfg.replace(tuning=tcfg.tuning.__class__(mode="full"))
    model, mask = policies.prepare(bridge.to_module(fp_np, full, device="cpu"),
                                   full, device="cpu")
    assert all(mask.values()) and "layers.0.attn.wq.w" in mask
    # every arm is ported; LoRA on bit-plane codes stays refused (the
    # reference's add_lora misreads a plane buffer's input width)
    lora = tcfg.replace(tuning=tcfg.tuning.__class__(mode="lora_optq"),
                        quant=tcfg.quant.__class__(layout="plane"))
    with pytest.raises(NotImplementedError, match="in/4"):
        registry.build(lora, device="cpu")
    with pytest.raises(ValueError, match="unknown tuning mode"):
        policies.prepare(model, tcfg.replace(
            tuning=tcfg.tuning.__class__(mode="bitfit")), device="cpu")


@pytest.mark.parametrize("change", [
    dict(use_rope=False), dict(kv_cache_dtype="fp8"),
    dict(moe=MoEConfig(n_experts=4, top_k=2, expert_sharding="pipeline")),
    dict(remat="offload"), dict(act="relu"),
    dict(family="encdec"), dict(quant_layout="plane", quant_bits=5),
    dict(quant_packed=False),
    dict(quant_bits=8)])
def test_unserved_configs_raise(pair, change):
    _, tcfg, _, _ = pair
    qkw = {k[6:]: v for k, v in change.items() if k.startswith("quant_")}
    kw = {k: v for k, v in change.items() if not k.startswith("quant_")}
    if qkw:
        kw["quant"] = tcfg.quant.__class__(**qkw)
    with pytest.raises(NotImplementedError):
        registry.build(tcfg.replace(**kw), device="cpu")


def test_build_without_device_raises_without_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, _, _ = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peqa.quantize_params(torch.nn.Linear(8, 8), tcfg.quant)
