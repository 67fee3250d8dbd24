"""PyTorch port vs JAX reference: the moe family (mixtral-8x7b,
deepseek-moe-16b) — the configs, the router, the sort-based capacity
dispatch, the MoE block, and the forward, loss and gradients with the
Switch aux loss.

Configuration: ``make_tiny`` of each config in both packages (2 layers,
d_model 64, 4 heads of 16, vocab 512; mixtral-tiny 4 experts top-2 under
``experts``, no shared expert; deepseek-tiny 8 experts top-2 under
``experts_ep`` and one shared expert of d_ff 64).  The reference makes the
weights (``bridge.to_module`` gives the port the same tree), its unit
norm gains replaced by seeded random values.

Tolerances: routing indices, capacity positions, keep flags, the capacity
and the slot table exactly; the gate values and probabilities float32
rtol 1e-5 (the same float32 logits and softmax, summed and exponentiated
by XLA and by PyTorch: a few ulps apart); the MoE
block's y and the logits atol/rtol 1e-4 in float32, and in bfloat16
within 2⁻⁵ of their largest magnitude — except a token (at most two)
whose router's k-th and (k+1)-th probabilities lie within 2⁻⁶ of each
other in some layer: on hidden states a bf16 ulp apart it may take the
other expert, a discrete change; the aux loss and the loss float32
rtol 1e-5, bfloat16 rtol 2⁻⁸ (a deeper layer routes bf16 hidden states
that differ in their last bits); each gradient leaf within 1e-4 of
the reference's largest magnitude in that leaf plus rtol 1e-3 (float32).
The expert-axis plain versions equal ``quant_matmul_plain`` expert by
expert bit for bit, and the expert-axis op's gradients equal the 2-D
op's expert by expert within float32 rtol 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core.quant import QuantSpec, pack_codes, rtn_quantize
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import moe, registry, transformer

from test_torch_configs import _shared_fields, to_numpy, tokens

ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")


def tiny_pair(arch: str, mode: str = "peqa", capacity_factor=None, **kw):
    """``make_tiny(get_config(arch))`` in both packages: (reference,
    port), with ``capacity_factor`` in place where given."""
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode), **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TTuning(mode=mode), **kw)
    if capacity_factor is not None:
        j = j.replace(moe=dataclasses.replace(
            j.moe, capacity_factor=capacity_factor))
        t = t.replace(moe=dataclasses.replace(
            t.moe, capacity_factor=capacity_factor))
    return j, t


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def fp_tree(arch: str):
    """The reference's float32 weights, every norm gain replaced by seeded
    random values (numpy)."""
    jcfg, _ = tiny_pair(arch)
    fp = to_numpy(jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "g":
            return (1 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, fp)


@functools.lru_cache(maxsize=None)
def policy_tree(arch: str, mode: str):
    """``fp_tree(arch)`` through the reference's policy for ``mode``."""
    jcfg, _ = tiny_pair(arch, mode)
    return to_numpy(jpolicies.transform(
        jax.tree.map(jnp.asarray, fp_tree(arch)), jcfg))


def batch_of(vocab, b=2, s=12, seed=0):
    toks = tokens(b, s + 1, vocab, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max()


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("make", ["full", "tiny"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_reference(arch, make):
    """Every field the port copies, MoEConfig's field for field (its
    defaults included)."""
    if make == "full":
        ref, port = jconfigs.get_config(arch), tconfigs.get_config(arch)
    else:
        ref, port = tiny_pair(arch)
    r, p = _shared_fields(ref, port)
    assert p == r
    assert [f.name for f in dataclasses.fields(port.moe)] == \
        [f.name for f in dataclasses.fields(ref.moe)]
    assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)
    defaults = tconfigs.MoEConfig(n_experts=2, top_k=1)
    assert (defaults.capacity_factor, defaults.router_aux_coef,
            defaults.expert_sharding, defaults.n_shared_experts,
            defaults.d_ff_expert) == (1.25, 0.01, "tensor", 0, None)


def test_moe_build_caps_and_refusals():
    """Both full configs build (no weights are made), with the reference's
    MoE capabilities; the arms and options the port does not run on MoE
    raise with their reasons."""
    for arch in ARCHS:
        api = registry.build(tconfigs.get_config(arch), device="cpu")
        assert api.decode_step_slotted is None and api.prefill_slotted is None
        assert api.decode_verify_slotted is None
        assert api.decode_verify is not None and api.caps.bucketable
        assert api.caps.slotted_reason == (
            "MoE expert dispatch cannot thread per-slot scales (no slotted "
            "decode step)")
        assert api.caps.verify_reason == \
            "MoE expert dispatch is not supported in the verify step"
    _, tcfg = tiny_pair("deepseek-moe-16b")
    for kw, why in ((dict(quant=QuantConfig(layout="plane")),
                     "bit-plane codes on MoE"),
                    (dict(tuning=TTuning(mode="lora_optq")),
                     "replays only a dense block"),
                    (dict(moe=dataclasses.replace(
                        tcfg.moe, expert_sharding="pipeline")),
                     "expert_sharding='pipeline'")):
        with pytest.raises(NotImplementedError, match=why):
            registry.build(tcfg.replace(**kw), device="cpu")
    for mode in ("full", "peqa", "peqa_z", "lora", "qat"):
        registry.build(tcfg.replace(tuning=TTuning(mode=mode)), device="cpu")


# ---------------------------------------------------- router and dispatch

def _route_both(x, w, k):
    jidx, jval, jprobs = jmoe._route(jnp.asarray(x), jnp.asarray(w), k)
    tidx, tval, tprobs = moe.route(torch.from_numpy(x), torch.from_numpy(w),
                                   k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=1e-5)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-5)
    return tidx


@pytest.mark.parametrize("k", [1, 2, 6])
def test_route_matches_reference_with_ties(k):
    """Random routing, then forced ties: duplicated router rows give
    bit-equal probabilities, and top-k must take the lower expert first
    (``jax.lax.top_k``'s order)."""
    rng = np.random.default_rng(k)
    e, d = 8, 16
    x = rng.normal(size=(24, d)).astype(np.float32)
    w = rng.normal(size=(e, d)).astype(np.float32)
    _route_both(x, w, k)
    tied = np.repeat(w[:e // 2], 2, axis=0)          # experts 2i, 2i+1 tie
    idx = _route_both(x, tied, k)
    if k >= 2:
        pairs = idx.numpy()[:, :2]
        assert (pairs[:, 0] % 2 == 0).all() and \
            (pairs[:, 1] == pairs[:, 0] + 1).all()
    flat_w = np.zeros((e, d), np.float32)            # every expert ties
    idx = _route_both(x, flat_w, k)
    assert (idx.numpy() == np.arange(k)).all()


@pytest.mark.parametrize("case", ["random", "overflow", "one_expert"])
def test_sort_dispatch_matches_reference(case):
    """The slot table, positions and keep flags exactly — routing drawn at
    random, routing that overflows half the experts, and every token on
    one expert (all but ``cap`` dropped)."""
    rng = np.random.default_rng(3)
    t, k, e = 40, 2, 8
    if case == "random":
        idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    elif case == "overflow":
        idx = np.stack([rng.choice(e // 2, k, replace=False)
                        for _ in range(t)])
    else:
        idx = np.stack([[0, 1 + i % (e - 1)] for i in range(t)])
    idx = idx.astype(np.int32)
    for cf in (1.0, 1.25, 2.0, 16.0):
        cap = moe.capacity(t, k, e, cf)
        assert cap == max(min(int(t * k / e * cf), t), 1)
        want = jmoe._sort_dispatch(jnp.asarray(idx), e, cap)
        got = moe.sort_dispatch(torch.from_numpy(idx).long(), e, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if case != "random" and cf < 16:
            assert not got[2].all()                  # something dropped


def test_capacity_matches_reference_formula():
    """The reference's float order at the shapes the card runs: 1024
    tokens (C = 320 mixtral, 120 deepseek), a decode of 4 (C = 1)."""
    assert moe.capacity(1024, 2, 8, 1.25) == 320
    assert moe.capacity(1024, 6, 64, 1.25) == 120
    assert moe.capacity(4, 2, 8, 1.25) == 1
    assert moe.capacity(4, 6, 64, 1.25) == 1
    for t in range(1, 50):
        for k, e, cf in ((2, 8, 1.25), (6, 64, 1.25), (2, 4, 16.0)):
            assert moe.capacity(t, k, e, cf) == \
                max(min(int(t * k / e * cf), t), 1)


# ----------------------------------------------------------- the MoE block

@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, mode, dtype, cf):
    """Layer 0's MoE block on seeded N(0, 1) rows: y and aux — with drops
    (capacity_factor 1.25) and without (16)."""
    jcfg, tcfg = tiny_pair(arch, mode, capacity_factor=cf, dtype=dtype)
    tree = policy_tree(arch, mode)
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


def test_moe_block_key_follows_expert_sharding():
    """mixtral's experts under ``experts``, deepseek's under
    ``experts_ep`` (the reference's key), each leaf stacked (E, …), the
    router float32 (E, d) and never quantized."""
    for arch, key in zip(ARCHS, ("experts", "experts_ep")):
        _, tcfg = tiny_pair(arch)
        model = bridge.to_module(policy_tree(arch, "peqa"), tcfg,
                                 device="cpu")
        names = dict(model.named_parameters())
        e = tcfg.moe.n_experts
        assert names["layers.0.moe.router.w"].shape == (e, 64)
        assert f"layers.0.moe.{key}.up.scale" in names
        assert moe.expert_mlp(model.layers[0].moe).up.qw.shape == \
            (e, 64, 64 // 8)
        assert ("layers.0.moe.shared.up.scale" in names) == \
            (arch == "deepseek-moe-16b")


# ------------------------------------------------------ forward and loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, mode, dtype, monkeypatch):
    """Logits, the aux loss summed over layers, and the loss with
    ``router_aux_coef`` × aux; under remat "none" and "block" the port's
    loss is the same."""
    jcfg, tcfg = tiny_pair(arch, mode, dtype=dtype)
    tree = policy_tree(arch, mode)
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
        tl, taux = transformer.forward_aux(model, tb["tokens"], tcfg)
    monkeypatch.setattr(moe, "route", route)
    near_tie = (torch.stack(margins).min(0).values < 2 ** -6).reshape(
        tl.shape[:2]).numpy()
    if dtype == "bfloat16":
        # a token whose router's k-th and (k+1)-th probabilities lie within
        # 2⁻⁶ of each other may take the other expert on hidden states a
        # bf16 ulp apart: its logits are not compared
        assert near_tie.sum() <= 2
        tl = tl.clone()
        tl[torch.from_numpy(near_tie)] = torch.from_numpy(
            np.array(jl))[torch.from_numpy(near_tie)]
    with torch.no_grad():
        tloss = transformer.loss_fn(model, tb, tcfg)
        tloss_none = transformer.loss_fn(model, tb,
                                         tcfg.replace(remat="none"))
        tloss_ce = transformer.loss_fn(model, tb, tcfg.replace(
            moe=dataclasses.replace(tcfg.moe, router_aux_coef=0.0)))
    assert_close(tl, np.asarray(jl), dtype)
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(float(taux), float(jaux), rtol=rtol)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    assert float(tloss) == float(tloss_none)
    assert float(tloss) != float(tloss_ce)


@pytest.mark.parametrize("mode", ["full", "peqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, mode):
    """float32, remat "block": every scale gradient under ``peqa`` (the
    router, codes and zeros frozen), every gradient under ``full`` (the
    router's included), against ``jax.grad`` of the reference's loss."""
    jcfg, tcfg = tiny_pair(arch, mode)
    tree = policy_tree(arch, mode)
    batch = batch_of(tcfg.vocab_size, seed=5)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(jp, jcfg)
    jgrads = jax.grad(jregistry.build(jcfg).loss_fn, allow_int=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: v for (k, v), m in zip(flat(jgrads).items(),
                                      flat(jmask).values()) if m}
    model = bridge.to_module(tree, tcfg, device="cpu")
    from repro_torch.core import policies
    mask = policies.make_mask(model, tcfg)
    loss = transformer.loss_fn(
        model, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        tcfg)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if mask[n]}
    got = flat(bridge._nest({k: v for k, v in _stack_grads(grads).items()}))
    assert got.keys() == want.keys()
    if mode == "peqa":
        assert all(k.endswith("scale") for k in got)
    else:
        assert "layers/moe/router/w" in got
    for key in want:
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


def _stack_grads(grads):
    """{tensor name: grad} → {reference path: stacked numpy grad}."""
    from repro_torch.core.peqa import layer_index, ref_path
    by = {}
    for name, g in grads.items():
        by.setdefault(ref_path(name), {})[layer_index(name)] = \
            g.detach().numpy()
    return {p: (v[None] if None in v else np.stack([v[i] for i in sorted(v)]))
            for p, v in by.items()}


# ---------------------------------------------------- the expert-axis ops

def _expert_operands(e, c, n, k, group, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    qws, ss, zs = [], [], []
    for _ in range(e):
        w = torch.randn(n, k, generator=g) * k ** -0.5
        q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group),
                               n_grid=4)
        qws.append(pack_codes(q))
        ss.append(s)
        zs.append(z)
    x = torch.randn(e, c, k, generator=g).to(dtype)
    return x, torch.stack(qws), torch.stack(ss), torch.stack(zs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 5, 40])
def test_expert_plain_versions_equal_per_expert_plain(c, dtype):
    """Both expert-axis wrappers on CPU tensors, and ``ops.
    quant_matmul_experts`` on either impl, equal ``quant_matmul_plain``
    on each expert in turn, bit for bit; the GEMV refuses C > 32."""
    x, qw, s, z = _expert_operands(3, c, 24, 64, 16, dtype)
    want = torch.stack([qm.quant_matmul_plain(x[e], qw[e], s[e], z[e])
                        for e in range(3)])
    fn = qm.quant_gemv_experts if c <= qm.GEMV_MAX_M \
        else qm.quant_matmul_experts
    for got in (fn(x, qw, s, z), qm.quant_matmul_experts(x, qw, s, z),
                ops.quant_matmul_experts(x, qw, s, z, QuantSpec(
                    group_size=16))):
        assert got.dtype == dtype and torch.equal(got, want)
    with ops.force_impl("torch"):
        assert torch.equal(ops.quant_matmul_experts(
            x, qw, s, z, QuantSpec(group_size=16)), want)
    if c > qm.GEMV_MAX_M:
        with pytest.raises(ValueError, match="M <= 32"):
            qm.quant_gemv_experts(x, qw, s, z)
    with pytest.raises(ValueError, match="same expert count"):
        qm.quant_matmul_experts(x, qw[:2], s[:2], z[:2])
    with pytest.raises(NotImplementedError, match="nibble"):
        ops.quant_matmul_experts(x, qw, s, z, QuantSpec(layout="plane"))


def test_expert_op_gradients_equal_the_2d_op_per_expert():
    """The expert-axis autograd op's dx, ds and dz (peqa_z asks for all
    three) against the 2-D ``ops.quant_matmul`` expert by expert."""
    spec = QuantSpec(group_size=16)
    x, qw, s, z = _expert_operands(3, 7, 24, 64, 16, torch.float32, seed=2)
    dy = torch.randn(3, 7, 24, generator=torch.Generator().manual_seed(4))
    xs, ss, zs = (t.clone().requires_grad_(True) for t in (x, s, z))
    ops.quant_matmul_experts(xs, qw, ss, zs, spec).backward(dy)
    for e in range(3):
        xe, se, ze = (t[e].clone().requires_grad_(True) for t in (x, s, z))
        ops.quant_matmul(xe, qw[e], se, ze, spec).backward(dy[e])
        for got, want in ((xs.grad[e], xe.grad), (ss.grad[e], se.grad),
                          (zs.grad[e], ze.grad)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
