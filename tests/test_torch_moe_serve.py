"""PyTorch port vs JAX reference: the moe family served, carried across
and built — prefill, decode and ``generate`` (mixtral's 4096-key window
takes the ring cache), drain ``Engine.serve``, the resident and
speculative refusals, the parameter bridge and checkpoints under both
expert keys (``experts``, ``experts_ep``), ScaleBank with expert scale
leaves, PEQA's dequantize and size, the layer-by-layer build, and the
LoRA and QAT arms on MoE.

Configuration and weights: ``test_torch_moe.py``'s (``make_tiny`` of each
config, the reference's weights with seeded norm gains).

Tolerances: float32 logits and caches atol/rtol 1e-4; a decode step
against the teacher-forced forward at ``capacity_factor=16`` (no drops:
capacity is per call, so a single-token step and a full sequence drop
differently otherwise — the reference's own test) atol/rtol 2e-3, as the
reference's; greedy tokens and serving counters equal; bridge,
checkpoint and ScaleBank arrays bit-equal; the streamed build bit-equal
to the whole one; the arms' losses float32 rtol 1e-5, and QAT's RTN
scales rtol 1e-6 (ROADMAP §3's last-bit difference of the shrink grid).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.core import peqa as jpeqa
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, QuantConfig
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core import peqa, policies
from repro_torch.core import scale_bank as sb
from repro_torch.models import linear, registry, transformer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine
from repro_torch.train.state import make_state

from test_torch_configs import tokens
from test_torch_moe import ARCHS, batch_of, flat, fp_tree, policy_tree, \
    tiny_pair
from _torch_threads import _one_torch_thread  # noqa: F401


OCFG = dict(lr=2e-5, warmup_steps=1, schedule="linear", weight_decay=0.01)


def _engines(arch, **kw):
    jcfg, tcfg = tiny_pair(arch, **kw)
    tree = policy_tree(arch, "peqa")
    return (JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(tree, tcfg, device="cpu"), device="cpu"))


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference(arch):
    """Prefill logits and cache, two decode steps' logits, then
    ``Engine.generate``'s greedy tokens equal to the reference's (B 2,
    prompt 24: the experts' C rows take the GEMM route at the prefill's
    48 rows and the GEMV at a step's 2)."""
    jeng, eng = _engines(arch)
    japi, api = jeng.api, eng.api
    toks = tokens(2, 10, api.cfg.vocab_size, seed=1)
    jl, jcache = japi.prefill(jeng.params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(eng.model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)
    jfull = jax.tree.map(lambda d, s: d.at[:, :, :10].set(s),
                         japi.init_cache(2, 16), jcache)
    tfull = api.init_cache(2, 16)
    for key in tfull:
        tfull[key][:, :, :10] = tcache[key]
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for pos in (10, 11):
        jl, jfull = japi.decode_step(jeng.params, jfull, jnp.asarray(nxt),
                                     jnp.int32(pos))
        with torch.inference_mode():
            tl, tfull = api.decode_step(eng.model, tfull,
                                        torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    prompt = tokens(2, 24, api.cfg.vocab_size, seed=3)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_forward_without_drops(arch):
    """The reference's ``test_dense_prefill_decode_matches_forward`` on
    the port's MoE models (capacity_factor 16, no window): prefill of 8
    tokens and 4 decode steps against the teacher-forced forward."""
    _, cfg = tiny_pair(arch, "full", capacity_factor=16.0, swa_window=None)
    api = registry.build(cfg, device="cpu")
    model = bridge.to_module(policy_tree(arch, "full"), cfg, device="cpu")
    toks = torch.from_numpy(tokens(2, 12, cfg.vocab_size, seed=3)).long()
    with torch.no_grad():
        fwd = transformer.forward(model, toks, cfg)
        lg, pcache = api.prefill(model, {"tokens": toks[:, :8]})
        cache = api.init_cache(2, 12)
        for key in cache:
            cache[key][:, :, :8] = pcache[key]
        np.testing.assert_allclose(lg.numpy(), fwd[:, 7].numpy(), rtol=2e-4,
                                   atol=2e-4)
        for t in range(8, 12):
            lg, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
            np.testing.assert_allclose(lg.numpy(), fwd[:, t].numpy(),
                                       rtol=2e-3, atol=2e-3)


def _bank_sets(tree):
    base = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(5)
    return {"t0": base, "t1": {
        k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
        for k, v in base.items()}}


def _requests(cls):
    rs = np.random.default_rng(9)
    shapes = [(6, 5, 0), (9, 3, 0), (4, 7, 1), (12, 4, 2), (5, 6, 2),
              (7, 2, 4), (8, 5, 5), (3, 4, 7)]
    return [cls(tokens=rs.integers(0, 512, s).astype(np.int32), n_new=n,
                task=f"t{i % 2}", arrival_step=a)
            for i, (s, n, a) in enumerate(shapes)]


@pytest.mark.parametrize("arch", ARCHS)
def test_drain_serve_matches_reference(arch):
    """8 requests over 2 tasks through 3 slots under ``drain`` (and
    ``auto``, which takes drain on MoE): tokens and scheduler counters
    equal to the reference's.  A pool step routes every slot's row, idle
    ones included, and an admitted prompt's bucket padding, as the
    reference does."""
    sets = _bank_sets(policy_tree(arch, "peqa"))
    for sched in ("drain", "auto"):
        jeng, eng = _engines(arch)
        jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
        for t, s in sets.items():
            jeng.bank.tasks[t] = s
            eng.bank.tasks[t] = s
        jrep = jeng.serve(_requests(JRequest),
                          JServeConfig(n_slots=3, scheduler=sched))
        trep = eng.serve(_requests(Request),
                         ServeConfig(n_slots=3, scheduler=sched))
        assert trep.scheduler == jrep.scheduler == "drain"
        for key in ("steps", "decoded", "switches", "idle_slot_steps",
                    "task_drain_idle_slot_steps", "prefill_compiles"):
            assert getattr(trep, key) == getattr(jrep, key), (sched, key)
        assert trep.tokens == jrep.tokens, sched
        assert all(len(t) == r.n_new
                   for t, r in zip(trep.tokens, _requests(Request)))


def test_resident_and_speculative_refusals_match_reference():
    """The resident scheduler refuses MoE with ``caps.slotted_reason``, the
    speculative one with ``caps.verify_reason``: the reference's
    messages, word for word."""
    for arch in ARCHS:
        jeng, eng = _engines(arch)
        sets = _bank_sets(policy_tree(arch, "peqa"))
        jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
        for t, s in sets.items():
            jeng.bank.tasks[t] = s
            eng.bank.tasks[t] = s
        for sched in ("resident", "speculative"):
            with pytest.raises(ValueError) as jerr:
                jeng.serve(_requests(JRequest),
                           JServeConfig(n_slots=3, scheduler=sched))
            with pytest.raises(ValueError) as terr:
                eng.serve(_requests(Request),
                          ServeConfig(n_slots=3, scheduler=sched))
            assert str(terr.value) == str(jerr.value), sched
            assert "MoE expert dispatch" in str(terr.value)


# --------------------------------------------------- the bridge, checkpoints

@pytest.mark.parametrize("mode", ["full", "peqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_expert_stacks(arch, mode):
    """The reference's tree into the port and back, every leaf bit-equal:
    the (L, E, …) expert stacks under the config's key, the router, the
    shared MLP; and the optimizer's moments (``full``: every float leaf,
    the expert stacks' and the router's included)."""
    tree = policy_tree(arch, mode)
    jcfg, tcfg = tiny_pair(arch, mode)
    model = bridge.to_module(tree, tcfg, device="cpu")
    back, want = flat(bridge.to_tree(model)), flat(tree)
    assert back.keys() == want.keys()
    key = "experts_ep" if arch == "deepseek-moe-16b" else "experts"
    leaf = "w" if mode == "full" else "qw"
    assert f"layers/moe/{key}/up/{leaf}" in want
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(jp, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10).init(jp, jmask)
    rng = np.random.default_rng(2)
    jopt = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(
        np.float32) if np.ndim(a) else a, jax.tree.map(np.asarray, jopt))
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    ostate = opt.init(dict(model.named_parameters()), mask)
    bridge.opt_from_tree(model, jopt, ostate)
    got = flat(bridge.opt_to_tree(model, ostate)["mv"])
    ref = flat(jopt["mv"])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (mode == "full") == any("router" in k for k in ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_both_ways(tmp_path, arch):
    """A reference checkpoint of a PEQA MoE model restored into the port,
    and the port's restored into the reference: every array equal."""
    jcfg, tcfg = tiny_pair(arch, "peqa")
    tree = policy_tree(arch, "peqa")
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(tree, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(3)}
    JManager(str(tmp_path / "ref")).save(3, jstate)
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    restored, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        bridge.state_to_tree(state))
    bridge.load_state(state, restored)
    got = flat(bridge.state_to_tree(state)["params"])
    for key, want in flat(tree).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    CheckpointManager(str(tmp_path / "port")).save(
        3, bridge.state_to_tree(state))
    back, extra = JManager(str(tmp_path / "port")).restore(jstate)
    assert extra["step"] == 3
    for key, want in flat(tree).items():
        np.testing.assert_array_equal(flat(back["params"])[key], want,
                                      err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_scale_bank_with_expert_leaves(tmp_path, arch):
    """``extract_scales`` gives the reference's dict, expert leaves (L, E,
    N, G) included; a task saved by the reference switches into the port's
    model and back out bit for bit."""
    tree = policy_tree(arch, "peqa")
    _, tcfg = tiny_pair(arch, "peqa")
    model = bridge.to_module(tree, tcfg, device="cpu")
    want = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
    got = sb.extract_scales(model)
    assert got.keys() == want.keys()
    key = "experts_ep" if arch == "deepseek-moe-16b" else "experts"
    e = tcfg.moe.n_experts
    assert got[f"layers/moe/{key}/down/scale"].shape == (2, e, 64, 1)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    other = _bank_sets(tree)["t1"]
    jbank = jsb.ScaleBank(str(tmp_path))
    jbank.add("t1", jsb.apply_scales(jax.tree.map(jnp.asarray, tree), other))
    bank = sb.ScaleBank(str(tmp_path))
    bank.switch(model, "t1")
    for k, v in sb.extract_scales(model).items():
        np.testing.assert_array_equal(v, np.asarray(other[k]), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_dequantize_and_size_match_reference(arch):
    """PEQA's ``dequantize_params`` over expert stacks gives the
    reference's float32 tree, and ``model_size_bytes`` its count."""
    jcfg, tcfg = tiny_pair(arch, "peqa")
    tree = policy_tree(arch, "peqa")
    model = bridge.to_module(tree, tcfg, device="cpu")
    assert peqa.model_size_bytes(model, tcfg.quant) == \
        jpeqa.model_size_bytes(jax.tree.map(jnp.asarray, tree), jcfg.quant)
    want = flat(jpeqa.dequantize_params(jax.tree.map(jnp.asarray, tree),
                                        jcfg.quant))
    got = flat(bridge.to_tree(peqa.dequantize_params(model, tcfg.quant)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ build and the arms

@pytest.mark.parametrize("mode", ["peqa", "peqa_z", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_build_is_bit_equal_to_the_whole_build(arch, mode):
    """``policies.build`` quantizes each block's expert stacks (one expert
    at a time) as the block is drawn; every tensor equals ``api.init`` +
    ``policies.prepare``'s.  The router stays float32 and frozen under
    PEQA, trainable under ``full``."""
    _, cfg = tiny_pair(arch, mode, quant=QuantConfig(n_grid=4))
    api = registry.build(cfg, device="cpu")
    streamed, smask = policies.build(api, 5)
    whole, wmask = policies.prepare(api.init(5), cfg, device="cpu")
    assert smask == wmask
    ta = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tb = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
    assert smask["layers.1.moe.router.w"] == (mode == "full")
    assert ta["layers.1.moe.router.w"].dtype == torch.float32
    experts = [m for m in streamed.modules()
               if isinstance(m, linear.Linear) and m.n_experts]
    assert len(experts) == 3 * cfg.n_layers
    assert all(m.quantized == (mode != "full") for m in experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_quantization_matches_reference(arch):
    """The port's PEQA transform of the reference's float32 weights (each
    expert stack quantized in chunks of whole experts,
    ``peqa.QUANT_CHUNK_ELEMENTS``; here deepseek's 8 tiny experts in one)
    gives the reference's codes bit for bit and its scales and zeros
    within rtol 1e-6 (ROADMAP §3's last-bit difference of the shrink
    grid)."""
    _, tcfg = tiny_pair(arch, "peqa")
    model = policies.transform(bridge.to_module(
        fp_tree(arch), tiny_pair(arch, "full")[1], device="cpu"), tcfg,
        device="cpu")
    got, want = flat(bridge.to_tree(model)), flat(policy_tree(arch, "peqa"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("qw"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["lora", "qat", "peqa_z"])
def test_arms_on_moe_match_reference(mode):
    """The other arms on deepseek's tiny MoE: LoRA (QV4: only wq and wv
    get adapters, the experts none), QAT (every expert stack fake-
    quantized over its expert axis, RTN-initialised one expert at a time)
    and peqa_z: the same leaves as the reference's policy, the same masks
    and counts, and the loss within float32 rtol 1e-5."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg = tiny_pair(arch, mode)
    tree = to_np(jpolicies.transform(jax.tree.map(jnp.asarray, fp_tree(arch)),
                                     jcfg, rng=jax.random.PRNGKey(1))) \
        if mode == "lora" else policy_tree(arch, mode)
    if mode == "lora":        # a non-zero lora_b, so the delta shows
        tree = jax.tree_util.tree_map_with_path(
            lambda p, a: np.full_like(a, 0.02) if str(getattr(
                p[-1], "key", p[-1])) == "lora_b" else a, tree)
    model = bridge.to_module(tree, tcfg, device="cpu")
    jmask = jpolicies.make_mask(tree, jcfg)
    mask = policies.make_mask(model, tcfg)
    assert policies.trainable_count(model, mask) == \
        jpolicies.trainable_count(tree, jmask)
    if mode == "qat":
        # the port's own QAT transform gives the reference's scales
        mine = policies.transform(bridge.to_module(fp_tree(arch), tiny_pair(
            arch, "full")[1], device="cpu"), tcfg, device="cpu")
        got = flat(bridge.to_tree(mine))
        for k, v in flat(tree).items():
            # RTN scales to rtol 1e-6 (ROADMAP §3: the reference's shrink
            # grid differs by one float32 ulp in 2 of 20 entries)
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0,
                                       err_msg=k)
    batch = batch_of(tcfg.vocab_size, seed=2)
    jloss = jregistry.build(jcfg).loss_fn(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss = transformer.loss_fn(
            model, {k: torch.from_numpy(v).long() for k, v in batch.items()},
            tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    lora = {n for n in mask if "lora" in n}
    assert (mode == "lora") == bool(lora)
    assert all(".attn.w" in n for n in lora)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)
