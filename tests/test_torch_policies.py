"""PyTorch port vs JAX reference: the paper's comparison arms.

Every arm of ``core.policies`` — ``full``, ``lora``, ``lora_optq``,
``qat``, ``peqa``, ``peqa_z`` — on ``make_tiny(get_config("llama3.2-1b"))``
with 2 KV heads and on ``make_tiny(get_config("qwen2-7b"))`` (q/k/v
biases, an untied head; its biases and norm gains replaced by seeded
random values, as ``test_torch_dense_archs.py`` does).  The reference
prepares the arm (its RTN codes, QAT's RTN scales, its ``lora_a``) and both
packages get the tree (``bridge.to_module``).  A LoRA arm's ``lora_b`` is
set to seeded non-zero values: at its zero init the delta vanishes and
would hide a transposed product.

Checked: the port's ``policies.prepare`` of the same fp weights gives the
reference's leaves, shapes and mask name for name (its own ``lora_a`` is
N(0, 1/in) from a torch generator, so only its law is checked); the counts;
the loss and every trainable tensor's gradient against ``jax.grad`` in
float32 and bfloat16; ``lora_optq`` through ``Engine.generate`` and
``Engine.serve`` (drain and resident over three tasks' scales, the adapter
shared) against the reference's tokens and scheduler counters; the
adapter's merge into an fp backbone.

Tolerances (as ``test_torch_train.py``).  float32: the loss rtol 1e-5,
each gradient within 1e-4 of the reference's in ℓ2 (float32 sums in other
orders).  bfloat16: the loss rtol 2⁻⁸, each gradient within 5e-2 in ℓ2
(every activation rounds to 8 significant bits at other points of the two
graphs; the gradients agree to 1–4% on these models, QAT's scale gradients
at the top of that), except QAT's zero-point gradient, a small difference
of two rounded bf16 sums, held elementwise (``qat_zero_grad_bound``).
Greedy tokens and serving counters: equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.core import lora, policies
from repro_torch.core import scale_bank as sb
from repro_torch.core.peqa import layer_index, ref_path
from repro_torch.models import registry
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy, tokens
from test_torch_dense_archs import _fp_tree, tiny_pair
from test_torch_train import seeded_adapter
from _torch_threads import _one_torch_thread  # noqa: F401


ARCHS = ("llama3.2-1b", "qwen2-7b")
LORA_B_STD = 0.02


def pair(arch: str, mode: str, dtype: str = "float32"):
    """(reference config, port config) of the tiny ``arch`` under ``mode``."""
    j, t = tiny_llama_pair(mode) if arch == "llama3.2-1b" \
        else tiny_pair(arch, mode)
    return j.replace(dtype=dtype), t.replace(dtype=dtype)


@functools.lru_cache(maxsize=None)
def fp_tree(arch: str):
    """The reference's float32 weights (numpy)."""
    if arch == "llama3.2-1b":
        return to_numpy(reference_params(pair(arch, "full")[0])[0])
    return _fp_tree(arch)


@functools.lru_cache(maxsize=None)
def arm_tree(arch: str, mode: str):
    """``fp_tree(arch)`` through the reference's ``prepare`` for ``mode``,
    a LoRA arm's ``lora_b`` seeded non-zero (numpy)."""
    jcfg, _ = pair(arch, mode)
    params, _ = jpolicies.prepare(jax.tree.map(jnp.asarray, fp_tree(arch)),
                                  jcfg)
    return to_numpy(seeded_adapter(params, LORA_B_STD))


def _flat(tree):
    return {"/" + "/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, seed=0):
    toks = tokens(2, 13, vocab, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------- masks, counts

@pytest.mark.parametrize("mode", policies.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_gives_the_reference_leaves_and_mask(arch, mode):
    """The port's ``prepare`` of the same fp weights: every reference leaf
    has its tensor of that shape (the codes and RTN/QAT scales as the
    reference's), the mask equal name for name (codes frozen), the counts
    equal, and a fresh adapter's ``lora_b`` zero and ``lora_a`` ~ N(0,
    1/in)."""
    jcfg, tcfg = pair(arch, mode)
    jp, jmask = jpolicies.prepare(jax.tree.map(jnp.asarray, fp_tree(arch)),
                                  jcfg)
    model = bridge.to_module(fp_tree(arch), pair(arch, "full")[1],
                             device="cpu")
    model, mask = policies.prepare(
        model, tcfg, device="cpu",
        generator=torch.Generator().manual_seed(3))
    want, want_mask = _flat(to_numpy(jp)), _flat(jmask)
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    got = {ref_path(n): t for n, t in tensors.items()}
    assert {ref_path(n) for n in tensors} == set(want)
    for name, t in tensors.items():
        path = ref_path(name)
        assert mask.get(name, False) == bool(want_mask[path]), name
        assert (name in mask) == t.is_floating_point(), name
        shape = want[path].shape[1:] if layer_index(name) is not None \
            else want[path].shape
        assert tuple(t.shape) == shape, name
    for path, arr in want.items():
        if path.endswith(("/qw", "/scale", "/zero")):
            stacked = stacked_at(tensors, path).detach().numpy()
            if arr.dtype == np.uint32:
                np.testing.assert_array_equal(stacked.view(np.uint32), arr,
                                              err_msg=path)
            else:
                np.testing.assert_allclose(stacked, arr, rtol=1e-6,
                                           atol=1e-7, err_msg=path)
    assert policies.trainable_count(model, mask) == \
        jpolicies.trainable_count(jp, jmask)
    assert policies.frozen_count(model, mask) == \
        jpolicies.frozen_count(jp, jmask)
    assert all(p.requires_grad == mask[n] for n, p in model.named_parameters())
    adapters = lora.targets(model, tcfg.tuning)
    if mode in ("lora", "lora_optq"):
        assert [n.rsplit(".", 1)[-1] for n, _ in adapters[:2]] == ["wq", "wv"]
        assert lora.lora_param_count(model) == jlora.lora_param_count(jp)
        a = torch.cat([m.lora_a.detach().flatten() * m.in_features ** 0.5
                       for _, m in adapters])
        assert all(not m.lora_b.any() for _, m in adapters)
        assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1) < 0.1
    else:
        assert lora.lora_param_count(model) == 0


def stacked_at(tensors, path):
    """The port's tensors at the reference path ``path``, stacked over
    layers as the reference's leaf is."""
    found = sorted(((layer_index(n) or 0, t) for n, t in tensors.items()
                    if ref_path(n) == path), key=lambda e: e[0])
    if path.startswith("/layers/"):
        return torch.stack([t for _, t in found])
    return found[0][1]


@pytest.mark.parametrize("mode", policies.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_arm_keeps_mask_and_counts(arch, mode):
    """The reference's arm tree bridged into the port: its mask name for
    name (the reference's leaf at each tensor's path) and the counts."""
    jcfg, tcfg = pair(arch, mode)
    tree = arm_tree(arch, mode)
    jmask = _flat(jpolicies.make_mask(tree, jcfg))
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    for name, _ in list(model.named_parameters()) + \
            list(model.named_buffers()):
        assert mask.get(name, False) == bool(jmask[ref_path(name)]), name
    assert policies.trainable_count(model, mask) == \
        jpolicies.trainable_count(tree, jpolicies.make_mask(tree, jcfg))
    assert policies.frozen_count(model, mask) == \
        jpolicies.frozen_count(tree, jpolicies.make_mask(tree, jcfg))
    names = {n for n, v in mask.items() if v}
    want = {"full": None, "qat": None, "peqa": ("scale",),
            "peqa_z": ("scale", "zero"), "lora": ("lora_a", "lora_b"),
            "lora_optq": ("lora_a", "lora_b")}[mode]
    if want is None:
        assert names == {n for n, p in model.named_parameters()}
    else:
        assert names and all(n.rsplit(".", 1)[-1] in want for n in names)
    assert bridge.to_tree(model).keys() == tree.keys()
    for key, val in _flat(bridge.to_tree(model)).items():
        np.testing.assert_array_equal(val, _flat(tree)[key], err_msg=key)


# ----------------------------------------------------- loss and gradients

def _reference_grads(jcfg, tree, mask, batch):
    leaves, treedef = jax.tree_util.tree_flatten(
        jax.tree.map(jnp.asarray, tree))
    flags = jax.tree.leaves(mask)
    train = [i for i, f in enumerate(flags) if f]
    api = jregistry.build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(trainable):
        full = list(leaves)
        for i, t in zip(train, trainable):
            full[i] = t
        return api.loss_fn(jax.tree_util.tree_unflatten(treedef, full), jb)

    grad = jax.value_and_grad(loss)
    if jcfg.dtype == "float32":
        # one compiled program: the same values to ~1e-6 of the op-by-op
        # run, far inside the float32 tolerances, in a fraction of its time
        grad = jax.jit(grad)
    val, grads = grad([leaves[i] for i in train])
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return float(val), {"/" + "/".join(str(getattr(k, "key", k))
                                       for k in paths[i]): np.asarray(g)
                        for i, g in zip(train, grads)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", policies.MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, mode, dtype):
    jcfg, tcfg = pair(arch, mode, dtype)
    tree = arm_tree(arch, mode)
    batch = _batch(tcfg.vocab_size, seed=4)
    jloss, jgrads = _reference_grads(jcfg, tree,
                                     jpolicies.make_mask(tree, jcfg), batch)
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    loss = registry.build(tcfg, device="cpu").loss_fn(
        model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(float(loss.detach()), jloss,
                               rtol=2 ** -8 if bf16 else 1e-5)
    grads = {}
    for name, p in model.named_parameters():
        assert (p.grad is not None) == mask[name], name
        if mask[name]:
            grads[name] = p.grad
    assert {ref_path(n) for n in grads} == jgrads.keys()
    tol = 5e-2 if bf16 else 1e-4
    for path, want in jgrads.items():
        g = stacked_at(grads, path).to(torch.float32).numpy()
        assert g.shape == want.shape, path
        assert np.linalg.norm(want) > 0, path
        if bf16 and mode == "qat" and path.endswith("/zero"):
            bound = qat_zero_grad_bound(want, jgrads[path[:-4] + "w"],
                                        _flat(tree)[path[:-4] + "scale"], tol)
            assert (np.abs(g - want) <= bound).all(), path
        else:
            assert np.linalg.norm(g - want) <= tol * np.linalg.norm(want), \
                path


def qat_zero_grad_bound(dz, dw, scale, tol):
    """Elementwise bound on two bf16 computations of QAT's zero-point
    gradient.  z enters the fake-quant twice, s·(clip(ste(w/s) + z) − z):
    each path's cotangent is summed over a group in bf16 (≈ ±s·Σc, c the
    gradient of the fake-quantized weight) and the two cancel but for the
    clipped codes, so dz is a small difference of two rounded sums.  Each
    package rounds each sum within 2⁻⁹ of |s|·Σ_{k∈g}|c| (|c| taken as
    |∂L/∂w|, which is c wherever the code is not clipped), so they differ
    by at most 2·2⁻⁸ of it, plus the ``tol`` share of |dz| every other bf16
    gradient is held to."""
    lead, g = scale.shape[:-1], scale.shape[-1]
    mag = np.abs(scale) * np.abs(dw).reshape(*lead, g, -1).sum(-1)
    return 2 * 2 ** -8 * mag + tol * np.abs(dz)


# ------------------------------------------------- serving with an adapter

def _engines(arch):
    jcfg, tcfg = pair(arch, "lora_optq")
    tree = arm_tree(arch, "lora_optq")
    return (JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(tree, tcfg, device="cpu"),
                   device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_optq_generate_matches_reference(arch):
    """Greedy tokens of the quantized backbone with its adapter (B 2,
    prompt 24: the prefill's quantized linears on the GEMM route, the
    decode's on the GEMV route, the delta added after either)."""
    jeng, eng = _engines(arch)
    prompt = tokens(2, 24, eng.api.cfg.vocab_size, seed=3)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(), want)


@pytest.mark.parametrize("sched", ["drain", "resident"])
def test_lora_optq_serve_matches_reference(sched):
    """qwen2's tiny lora_optq model serving 8 requests of 3 tasks (scale
    sets; the adapter shared) through 3 slots: tokens and scheduler
    counters equal to the reference's."""
    jeng, eng = _engines("qwen2-7b")
    base = jsb.extract_scales(jeng.params)
    rng = np.random.default_rng(5)
    sets = {"t0": base}
    for t in ("t1", "t2"):
        sets[t] = {k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
                   for k, v in base.items()}
    rs = np.random.default_rng(9)
    shapes = [(6, 5, 0), (9, 3, 0), (4, 7, 1), (12, 4, 2), (5, 6, 2),
              (7, 2, 4), (8, 5, 5), (3, 4, 7)]
    reqs = [dict(tokens=rs.integers(0, 512, s).astype(np.int32), n_new=n,
                 task=f"t{i % 3}", arrival_step=a)
            for i, (s, n, a) in enumerate(shapes)]
    jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
    for t, s in sets.items():
        jeng.bank.tasks[t] = s
        eng.bank.tasks[t] = s
    jrep = jeng.serve([JRequest(**r) for r in reqs],
                      JServeConfig(n_slots=3, scheduler=sched))
    trep = eng.serve([Request(**r) for r in reqs],
                     ServeConfig(n_slots=3, scheduler=sched))
    for key in ("scheduler", "steps", "decoded", "switches",
                "idle_slot_steps", "task_drain_idle_slot_steps"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.tokens == jrep.tokens


def test_merge_lora_matches_reference():
    """``merge_lora`` folds the adapter into the fp backbone (w += B·A·α,
    α = 2 here) as the reference's does, and leaves a quantized linear's
    adapter in place."""
    jcfg, tcfg = pair("qwen2-7b", "lora")
    tcfg = tcfg.replace(tuning=tcfg.tuning.__class__(mode="lora",
                                                     lora_alpha=2.0))
    tree = arm_tree("qwen2-7b", "lora")
    want = _flat(to_numpy(jlora.merge_lora(jax.tree.map(jnp.asarray, tree),
                                           jcfg.tuning.__class__(
                                               mode="lora",
                                               lora_alpha=2.0))))
    model = lora.merge_lora(bridge.to_module(tree, tcfg, device="cpu"),
                            tcfg.tuning)
    got = _flat(bridge.to_tree(model))
    assert got.keys() == want.keys()
    assert not any("lora" in k for k in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    q = bridge.to_module(arm_tree("qwen2-7b", "lora_optq"),
                         pair("qwen2-7b", "lora_optq")[1], device="cpu")
    lora.merge_lora(q, tcfg.tuning)
    assert lora.lora_param_count(q) == jlora.lora_param_count(
        arm_tree("qwen2-7b", "lora_optq"))
