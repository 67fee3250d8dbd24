"""PyTorch port vs JAX reference: the moe family on bit-plane codes — each
expert stack's codes stored as (E, bits, N, K/32) planes, the reference's
per-expert ``pack_codes_planes`` under its map, and run through the plane
forms of the expert-axis K1 and K2 (their plain versions on the CPU).

Configurations: ``make_tiny`` of mixtral-8x7b and deepseek-moe-16b
(``test_torch_moe.py``) with ``QuantConfig(bits=4 or 3, layout="plane")``
in both packages, PEQA; the reference quantizes the same float32 weights
(its norm gains seeded random values).  At 3 bits an expert's planes are
3·N·K/32 words, not the N·K/8 of a nibble expert: a stride taken from the
nibble layout would read the previous expert's planes.

Tolerances, as ``test_torch_moe.py``'s: the MoE block's y and the logits
atol/rtol 1e-4 in float32 and within 2⁻⁵ of their largest magnitude in
bfloat16; the aux loss and the loss float32 rtol 1e-5, bfloat16 rtol 2⁻⁸
— in bfloat16 a token (at most two) whose router's k-th and (k+1)-th
probabilities lie within 2⁻⁶ of each other in some layer may take
either expert (hidden states a bf16 ulp apart), and through the batch's
capacity move another token's assignment past its expert's capacity: the
port's forward with some resolution of those ties must match the
reference in logits, aux and loss together; each scale gradient within
1e-4 of the reference's largest magnitude in its leaf plus rtol 1e-3; the
expert-axis plane plain version within ``quant_matmul.error_bound`` of
the reference's interpret-mode Pallas kernel under ``jax.vmap`` (both sum
the same float32 products in another order); prefill logits atol/rtol
1e-4; greedy tokens, serving counters, bridged, checkpointed and built
tensors exactly; codes bit for bit and RTN scales rtol 1e-6 (ROADMAP §3's
last-bit difference of the shrink grid).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import peqa as jpeqa
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.core.quant import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, QuantConfig
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core import peqa, policies
from repro_torch.core import scale_bank as sb
from repro_torch.core.quant import QuantSpec, pack_codes_planes, rtn_quantize
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import linear, moe, registry, transformer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine
from repro_torch.train.state import make_state

from test_torch_configs import tokens
from test_torch_moe import (ARCHS, _stack_grads, assert_close, batch_of,
                            flat, fp_tree)

BITS = (4, 3)
OCFG = dict(lr=2e-5, warmup_steps=1, schedule="linear", weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny models are op-bound: one intra-op thread a worker keeps
    them from stalling on busy cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plane_pair(arch: str, bits: int, mode: str = "peqa", **kw):
    """``make_tiny(get_config(arch))`` on ``bits``-bit planes in both
    packages: (reference, port)."""
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode), quant=JQuant(bits=bits, layout="plane"),
        **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TTuning(mode=mode), quant=QuantConfig(bits=bits,
                                                     layout="plane"), **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def plane_tree(arch: str, bits: int, n_grid: int = 20):
    """``fp_tree(arch)`` through the reference's PEQA transform onto
    ``bits``-bit planes (numpy)."""
    jcfg, _ = plane_pair(arch, bits)
    jcfg = jcfg.replace(quant=JQuant(bits=bits, layout="plane",
                                     n_grid=n_grid))
    return jax.tree.map(np.asarray, jpolicies.transform(
        jax.tree.map(jnp.asarray, fp_tree(arch)), jcfg))


def expert_key(arch: str) -> str:
    return "experts_ep" if arch == "deepseek-moe-16b" else "experts"


# ------------------------------------------------------ storage and the op

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_plane_expert_stacks(arch, bits):
    """The reference's tree into the port and back, every leaf bit-equal:
    each expert stack's qw (L, E, bits, N, K/32) int32 words, the port's
    layer slice (E, bits, N, K/32)."""
    tree = plane_tree(arch, bits)
    _, tcfg = plane_pair(arch, bits)
    model = bridge.to_module(tree, tcfg, device="cpu")
    e = tcfg.moe.n_experts
    up = moe.expert_mlp(model.layers[1].moe).up
    assert up.qw.shape == (e, bits, 64, 64 // 32)
    assert up.qw.dtype == torch.int32 and up.spec.plane
    back, want = flat(bridge.to_tree(model)), flat(tree)
    assert back.keys() == want.keys()
    assert want[f"layers/moe/{expert_key(arch)}/up/qw"].shape == \
        (2, e, bits, 64, 2)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _expert_plane_operands(e, c, n, k, bits, group, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qs, ss, zs = [], [], []
    for _ in range(e):
        w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)
                             * k ** -0.5)
        q, s, z = rtn_quantize(w, QuantSpec(bits=bits, group_size=group,
                                            layout="plane"), n_grid=4)
        qs.append(pack_codes_planes(q, bits))
        ss.append(s)
        zs.append(z)
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32)
                         ).to(dtype)
    return x, torch.stack(qs), torch.stack(ss), torch.stack(zs)


@pytest.mark.parametrize("c", [1, 40])
@pytest.mark.parametrize("bits", BITS)
def test_expert_plane_op_matches_reference_vmap(bits, c):
    """The plain version of the expert-axis plane kernels, both wrappers on
    CPU tensors and ``ops.quant_matmul_experts`` on either impl against
    the reference's ``quant_matmul`` (its Pallas kernel in interpret mode,
    as its own tests run it) under ``jax.vmap`` over the experts, f32, at
    a GEMV's and a GEMM's C; and each equal to
    ``quant_matmul_planes_plain`` on every expert, bit for bit."""
    e, n, k, group = 3, 24, 128, 32
    x, qw, s, z = _expert_plane_operands(e, c, n, k, bits, group,
                                         torch.float32, seed=bits + c)
    jspec = JSpec(bits=bits, group_size=group, layout="plane")
    want = np.asarray(jax.vmap(
        lambda xe, qe, se, ze: jops.quant_matmul(xe, qe, se, ze, jspec,
                                                 impl="interpret"))(
        jnp.asarray(x.numpy()), jnp.asarray(qw.numpy().view(np.uint32)),
        jnp.asarray(s.numpy()), jnp.asarray(z.numpy())))
    plain = qm.quant_matmul_experts_planes_plain(x, qw, s, z, bits)
    bound = qm.error_bound(x, qw, s, z, plain, planes=(bits, 0)).numpy()
    assert (np.abs(plain.numpy() - want) <= bound).all()
    per = torch.stack([qm.quant_matmul_planes_plain(x[i], qw[i], s[i], z[i],
                                                    bits) for i in range(e)])
    spec = QuantSpec(bits=bits, group_size=group, layout="plane")
    fn = qm.quant_gemv_experts_planes if c <= qm.GEMV_MAX_M \
        else qm.quant_matmul_experts_planes
    got = [plain, fn(x, qw, s, z, bits),
           qm.quant_matmul_experts_planes(x, qw, s, z, bits),
           ops.quant_matmul_experts(x, qw, s, z, spec)]
    with ops.force_impl("torch"):
        got.append(ops.quant_matmul_experts(x, qw, s, z, spec))
    for g in got:
        assert torch.equal(g, per)


def test_expert_plane_checks_and_the_stride():
    """A 3-bit expert stack is not a nibble one: each expert's slice is
    its own planes (expert e's result from expert e's codes alone, with
    the other experts' codes scrambled), the nibble op refuses the plane
    buffer and the plane op the nibble words, and a read of more planes
    than an expert stores is refused."""
    x, qw, s, z = _expert_plane_operands(4, 5, 16, 64, 3, None,
                                         torch.float32, seed=1)
    spec = QuantSpec(bits=3, layout="plane")
    y = ops.quant_matmul_experts(x, qw, s, z, spec)
    for i in range(4):
        other = qw.clone()
        other[torch.arange(4) != i] = torch.randint(
            -2 ** 31, 2 ** 31 - 1, other[torch.arange(4) != i].shape,
            dtype=torch.int32)
        assert torch.equal(ops.quant_matmul_experts(x, other, s, z, spec)[i],
                           y[i])
    with pytest.raises(ValueError, match="expert stack of shape"):
        ops.quant_matmul_experts(x, qw, s, z, QuantSpec(bits=4,
                                                        layout="plane"))
    with pytest.raises(ValueError, match=r"qw \(E, N, K/8\)"):
        qm.quant_matmul_experts(x, qw, s, z)
    with pytest.raises(ValueError, match=r"qw \(E, bits', N, K/32\)"):
        qm.quant_gemv_experts_planes(x, qw[:, 0], s, z, 3)
    with pytest.raises(ValueError, match="cannot read 4 planes"):
        qm.quant_gemv_experts_planes(x, qw, s, z, 4)
    with pytest.raises(ValueError, match="same expert count"):
        qm.quant_matmul_experts_planes(x, qw[:3], s[:3], z[:3], 3)


def test_expert_plane_op_gradients_equal_the_2d_op_per_expert():
    """The expert-axis op's dx, ds and dz on 3-bit planes against the 2-D
    ``ops.quant_matmul`` on each expert's planes, float32 rtol 1e-5."""
    spec = QuantSpec(bits=3, group_size=16, layout="plane")
    x, qw, s, z = _expert_plane_operands(3, 7, 24, 64, 3, 16,
                                         torch.float32, seed=2)
    dy = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 7, 24)).astype(np.float32))
    xs, ss, zs = (t.clone().requires_grad_(True) for t in (x, s, z))
    ops.quant_matmul_experts(xs, qw, ss, zs, spec).backward(dy)
    for e in range(3):
        xe, se, ze = (t[e].clone().requires_grad_(True) for t in (x, s, z))
        ops.quant_matmul(xe, qw[e], se, ze, spec).backward(dy[e])
        for got, want in ((xs.grad[e], xe.grad), (ss.grad[e], se.grad),
                          (zs.grad[e], ze.grad)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the block, loss, gradients

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_on_planes_matches_reference(arch, bits, dtype):
    """Layer 0's MoE block on seeded N(0, 1) rows (capacity factor 1.25,
    so some assignments drop): y and aux."""
    jcfg, tcfg = plane_pair(arch, bits, dtype=dtype)
    tree = plane_tree(arch, bits)
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          tree["layers"]["moe"])
    x = np.random.default_rng(11).normal(size=(2, 24, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jy, jaux = jax.jit(lambda p, x: jmoe.apply(p, x, jcfg))(
        layer0, jnp.asarray(x).astype(jdt))
    model = bridge.to_module(tree, tcfg, device="cpu")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        ty, taux = moe.apply(model.layers[0].moe,
                             torch.from_numpy(x).to(tdt), tcfg)
    assert ty.dtype == tdt
    assert_close(ty.float(), np.asarray(jy.astype(jnp.float32)), dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _flipping(flips):
    """``moe.route`` with the near ties ``flips`` — (call, token) pairs,
    the call counted over a forward's MoE layers — resolved the other way:
    the token takes its (k+1)-th expert in place of its k-th."""
    route = moe.route
    calls = [0]

    def fn(x, w, k):
        gi, gv, probs = route(x, w, k)
        for c, t in flips:
            if c == calls[0]:
                order = torch.sort(probs[t], descending=True, stable=True)[1]
                sel = torch.cat([order[:k - 1], order[k:k + 1]])
                gi, gv = gi.clone(), gv.clone()
                gi[t] = sel
                gv[t] = probs[t, sel] / probs[t, sel].sum()
        calls[0] += 1
        return gi, gv, probs
    return fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_on_planes_match_reference(arch, bits, dtype,
                                                    monkeypatch):
    """Logits, the aux loss summed over layers and the loss with
    ``router_aux_coef`` × aux.  bfloat16 under the moe tests' router-tie
    exemption, made exact: a token (at most two) whose router's k-th and
    (k+1)-th probabilities lie within 2⁻⁶ of each other may take either
    expert, and with capacity per batch its choice can move another
    token's assignment past its expert's capacity; so the port's run is
    repeated with every subset of those ties resolved the other way, and
    one of the runs must match the reference in logits, aux and loss."""
    jcfg, tcfg = plane_pair(arch, bits, dtype=dtype)
    tree = plane_tree(arch, bits)
    batch = batch_of(tcfg.vocab_size)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, jaux = jax.jit(lambda p, t: jtransformer.forward(p, t, jcfg))(
        jp, jnp.asarray(batch["tokens"]))
    jloss = jregistry.build(jcfg).loss_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = bridge.to_module(tree, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    margins = []
    route = moe.route

    def recorded(x, w, k):
        out = route(x, w, k)
        top = torch.sort(out[2], dim=-1, descending=True).values
        margins.append((top[:, k - 1] - top[:, k]) / top[:, k - 1])
        return out
    monkeypatch.setattr(moe, "route", recorded)
    with torch.no_grad():
        transformer.forward_aux(model, tb["tokens"], tcfg)
    near = [(c, t) for c, m in enumerate(margins)
            for t in torch.nonzero(m < 2 ** -6).flatten().tolist()]
    if dtype == "float32":
        near = []
    assert len(near) <= 2
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    failures = []
    for n in range(2 ** len(near)):
        flips = [f for i, f in enumerate(near) if n >> i & 1]
        monkeypatch.setattr(moe, "route", _flipping(flips))
        with torch.no_grad():
            tl, taux = transformer.forward_aux(model, tb["tokens"], tcfg)
        monkeypatch.setattr(moe, "route", _flipping(flips))
        with torch.no_grad():
            tloss = transformer.loss_fn(model, tb, tcfg)
        try:
            assert_close(tl, np.asarray(jl), dtype)
            np.testing.assert_allclose(float(taux), float(jaux), rtol=rtol)
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=rtol)
            break
        except AssertionError as err:
            failures.append((flips, err))
    else:
        raise AssertionError(f"no resolution of the near ties {near} "
                             f"matches the reference: {failures}")


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_scale_gradients_on_planes_match_reference(arch, bits):
    """float32, remat "block": every scale gradient (the router, codes and
    zeros frozen) against ``jax.grad`` of the reference's loss."""
    jcfg, tcfg = plane_pair(arch, bits, remat="block")
    tree = plane_tree(arch, bits)
    batch = batch_of(tcfg.vocab_size, seed=5)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(jp, jcfg)
    # one compiled program (float32): the same values to ~1e-5 of each
    # leaf's largest entry, inside the tolerances, in a fraction of the time
    jgrads = jax.jit(jax.grad(jregistry.build(jcfg).loss_fn,
                              allow_int=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: v for (k, v), m in zip(flat(jgrads).items(),
                                      flat(jmask).values()) if m}
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    transformer.loss_fn(
        model, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        tcfg).backward()
    grads = {n: p.grad for n, p in model.named_parameters() if mask[n]}
    got = flat(bridge._nest(_stack_grads(grads)))
    assert got.keys() == want.keys()
    assert all(k.endswith("scale") for k in got)
    assert f"layers/moe/{expert_key(arch)}/down/scale" in got
    for key in want:
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


# ---------------------------------------------------------------- serving

def _engines(arch, bits):
    jcfg, tcfg = plane_pair(arch, bits)
    tree = plane_tree(arch, bits)
    return (JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(tree, tcfg, device="cpu"), device="cpu"))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_generate_on_planes_match_reference(arch, bits):
    """Prefill logits and cache, then ``Engine.generate``'s greedy tokens
    (B 2, prompt 24: the experts' C rows take the GEMM form at the
    prefill's 48 rows and the GEMV form at a step's 2)."""
    jeng, eng = _engines(arch, bits)
    toks = tokens(2, 10, eng.api.cfg.vocab_size, seed=1)
    jl, jcache = jeng.api.prefill(jeng.params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = eng.api.prefill(eng.model,
                                     {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)
    prompt = tokens(2, 24, eng.api.cfg.vocab_size, seed=3)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(), want)


def _requests(cls):
    rs = np.random.default_rng(9)
    shapes = [(6, 5, 0), (9, 3, 0), (4, 7, 1), (12, 4, 2), (5, 6, 2),
              (7, 2, 4)]
    return [cls(tokens=rs.integers(0, 512, s).astype(np.int32), n_new=n,
                task=f"t{i % 2}", arrival_step=a)
            for i, (s, n, a) in enumerate(shapes)]


def _banks(jeng, eng, tree):
    base = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(5)
    sets = {"t0": base, "t1": {
        k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
        for k, v in base.items()}}
    jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
    for t, s in sets.items():
        jeng.bank.tasks[t] = s
        eng.bank.tasks[t] = s


@pytest.mark.parametrize("arch", ARCHS)
def test_drain_serve_on_planes_matches_reference(arch):
    """6 requests over 2 tasks through 3 slots under ``drain`` on 3-bit
    planes: tokens and scheduler counters equal to the reference's; the
    resident and speculative schedulers refuse with the reference's
    messages, word for word (planes give MoE no verify step)."""
    jeng, eng = _engines(arch, 3)
    _banks(jeng, eng, plane_tree(arch, 3))
    jrep = jeng.serve(_requests(JRequest),
                      JServeConfig(n_slots=3, scheduler="drain"))
    trep = eng.serve(_requests(Request), ServeConfig(n_slots=3,
                                                     scheduler="drain"))
    for key in ("steps", "decoded", "switches", "idle_slot_steps",
                "task_drain_idle_slot_steps", "prefill_compiles"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.tokens == jrep.tokens
    for sched in ("resident", "speculative"):
        with pytest.raises(ValueError) as jerr:
            jeng.serve(_requests(JRequest),
                       JServeConfig(n_slots=3, scheduler=sched))
        with pytest.raises(ValueError) as terr:
            eng.serve(_requests(Request),
                      ServeConfig(n_slots=3, scheduler=sched))
        assert str(terr.value) == str(jerr.value), sched


def test_remaining_refusals_on_plane_moe():
    """What planes leave refused on MoE, word for word: ``lora_optq`` on
    planes (the registry's message), and an expert linear's slotted and
    draft reads (no slotted step, no verify step: the messages name the
    missing step)."""
    _, tcfg = plane_pair("deepseek-moe-16b", 3, mode="lora_optq")
    with pytest.raises(NotImplementedError) as err:
        registry.build(tcfg, device="cpu")
    assert "lora_optq on MoE: the reference's GPTQ replays only a dense " \
        "block" in str(err.value)
    _, tcfg = plane_pair("deepseek-moe-16b", 3)
    registry.build(tcfg, device="cpu")
    model = bridge.to_module(plane_tree("deepseek-moe-16b", 3), tcfg,
                             device="cpu")
    up = moe.expert_mlp(model.layers[1].moe).up
    x = torch.zeros(tcfg.moe.n_experts, 2, 64)
    with pytest.raises(NotImplementedError) as err:
        linear.apply(up, x, draft_bits=2)
    assert str(err.value) == ("an expert linear has no draft read: MoE "
                              "expert dispatch is not supported in the "
                              "verify step")
    with pytest.raises(NotImplementedError) as err:
        linear.apply(up, x, slots=(torch.zeros(2, dtype=torch.int32), {}))
    assert str(err.value) == ("an expert linear has no slotted step: MoE "
                              "expert dispatch cannot thread per-slot "
                              "scales")
    h = torch.zeros(1, 2, 64)
    with pytest.raises(NotImplementedError) as err:
        transformer._ffn(model.layers[1], h, tcfg, draft_bits=2)
    assert str(err.value) == ("MoE expert dispatch is not supported in the "
                              "verify step (no draft read)")


# ------------------------------------------- building, checkpoints, sizes

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_build_on_planes_is_bit_equal_to_the_whole_build(arch,
                                                                  bits):
    """``policies.build`` packs each block's expert stacks into planes as
    the block is drawn (chunks of whole experts); every tensor equals
    ``api.init`` + ``policies.prepare``'s, through the plain RTN (n_grid
    4) and through ``ops.rtn_pack``'s plane route (n_grid 1, K6b's plain
    version here)."""
    for n_grid in (4, 1):
        _, cfg = plane_pair(arch, bits)
        cfg = cfg.replace(quant=QuantConfig(bits=bits, layout="plane",
                                            n_grid=n_grid))
        api = registry.build(cfg, device="cpu")
        streamed, smask = policies.build(api, 5)
        whole, wmask = policies.prepare(api.init(5), cfg, device="cpu")
        assert smask == wmask
        ta = dict(list(streamed.named_parameters())
                  + list(streamed.named_buffers()))
        tb = dict(list(whole.named_parameters())
                  + list(whole.named_buffers()))
        assert ta.keys() == tb.keys()
        for name in ta:
            assert torch.equal(ta[name], tb[name]), name
        experts = [m for m in streamed.modules()
                   if isinstance(m, linear.Linear) and m.n_experts]
        assert len(experts) == 3 * cfg.n_layers
        assert all(m.qw.shape[:2] == (cfg.moe.n_experts, bits)
                   for m in experts)


@pytest.mark.parametrize("n_grid", [20, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_plane_quantization_matches_reference(arch, n_grid):
    """The port's PEQA transform of the reference's float32 weights onto
    3-bit planes (expert stacks in chunks of whole experts, each chunk's
    (bits, k·N, K/32) planes split back into its experts) gives the
    reference's codes bit for bit, its scales and zeros within rtol 1e-6 —
    by the RTN search (n_grid 20) and by ``ops.rtn_pack`` (n_grid 1)."""
    _, tcfg = plane_pair(arch, 3)
    tcfg = tcfg.replace(quant=QuantConfig(bits=3, layout="plane",
                                          n_grid=n_grid))
    _, fcfg = plane_pair(arch, 3, mode="full")
    model = policies.transform(bridge.to_module(fp_tree(arch), fcfg,
                                                device="cpu"), tcfg,
                               device="cpu")
    got, want = flat(bridge.to_tree(model)), flat(plane_tree(arch, 3,
                                                             n_grid))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("qw"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_on_planes_round_trips_both_ways(tmp_path, arch):
    """A reference checkpoint of a 3-bit plane MoE model restored into the
    port, and the port's restored into the reference: every array
    equal."""
    jcfg, tcfg = plane_pair(arch, 3)
    tree = plane_tree(arch, 3)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(tree, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(3)}
    JManager(str(tmp_path / "ref")).save(3, jstate)
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    for p in model.parameters():
        p.data.zero_()
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


@pytest.mark.parametrize("bits", BITS)
def test_dequantize_and_size_on_planes_match_reference(bits):
    """PEQA's ``dequantize_params`` over plane expert stacks gives the
    reference's float32 tree, and ``model_size_bytes`` its count."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg = plane_pair(arch, bits)
    tree = plane_tree(arch, bits)
    model = bridge.to_module(tree, tcfg, device="cpu")
    assert peqa.model_size_bytes(model, tcfg.quant) == \
        jpeqa.model_size_bytes(jax.tree.map(jnp.asarray, tree), jcfg.quant)
    want = flat(jpeqa.dequantize_params(jax.tree.map(jnp.asarray, tree),
                                        jcfg.quant))
    got = flat(bridge.to_tree(peqa.dequantize_params(model, tcfg.quant)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
