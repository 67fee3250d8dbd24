"""PyTorch port vs JAX reference: ``remat="dots"`` — the reference's
``jax.checkpoint(policy=checkpoint_dots)`` around each block of the dense,
moe and vlm families' training forward, the port's non-reentrant
``torch.utils.checkpoint`` with a selective policy
(``transformer.dots_policy``) that keeps every dense product's output and
recomputes the rest, each quantized linear (K2, its plain version here)
included.  whisper, zamba2 and xlstm run "dots" as "none", as the
reference does (it tests ``remat in ("block", "full")`` there).

  * the loss and every trainable gradient under "dots" against the
    reference's "dots": tiny llama3.2-1b (2 KV heads) in peqa and full,
    float32 and bfloat16; tiny deepseek-moe-16b in peqa (the recompute
    routes as the forward did); whisper-medium and zamba2-7b in peqa;
  * the port's "dots" gradients bit-equal to its "none" ones (a
    recompute repeats the forward's arithmetic);
  * 3 train steps against ``repro.train.step.build_train_step``
    (``test_torch_train.py``'s checks and tolerances);
  * what "dots" keeps: the bytes held for the backward after a forward,
    none > dots > block, and K2 run twice a block (once in the forward,
    once in the recompute) while no dense product is run again.

Tolerances, as ``test_torch_policies.py``'s and ``test_torch_moe.py``'s:
float32 loss rtol 1e-5 and each gradient within 1e-4 of the reference's
in ℓ2 (llama) or elementwise within rtol 1e-3 plus 1e-4 of its leaf's
largest magnitude (deepseek, whisper, zamba2); bfloat16 loss rtol 2⁻⁸
and each gradient within 5e-2 in ℓ2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.models import registry as jregistry
from repro.core import policies as jpolicies
from repro_torch import bridge
from repro_torch.core import policies
from repro_torch.core.peqa import ref_path
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import registry, transformer, whisper, zamba2

import test_torch_moe
import test_torch_whisper
import test_torch_xlstm
from test_torch_configs import tokens
from test_torch_policies import _reference_grads, arm_tree, pair, stacked_at
from test_torch_train import _check_train_steps, OCFG


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny models are op-bound: one intra-op thread a worker keeps
    them from stalling on busy cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab, b=2, s=24, seed=4):
    """b × s tokens: with s = 24 a linear's b·s = 48 rows take K2."""
    toks = tokens(b, s + 1, vocab, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _port_grads(tree, cfg, batch):
    """(loss, {name: grad}) of the port's model on ``tree`` under ``cfg``."""
    model = bridge.to_module(tree, cfg, device="cpu")
    mask = policies.make_mask(model, cfg)
    loss = registry.build(cfg, device="cpu").loss_fn(model, _torch(batch))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if mask[n]}


def _assert_same(a, b):
    """Two runs' (loss, grads), bit for bit."""
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


# -------------------------------------------------- loss and gradients

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["peqa", "full"])
def test_llama_loss_and_gradients_under_dots_match_reference(mode, dtype):
    """Tiny llama3.2-1b: the loss and every trainable gradient under
    "dots" against ``jax.value_and_grad`` of the reference's loss under
    "dots"; the port's equal to its own under "none", bit for bit."""
    jcfg, tcfg = (c.replace(remat="dots") for c in pair("llama3.2-1b",
                                                         mode, dtype))
    tree = arm_tree("llama3.2-1b", mode)
    batch = _batch(tcfg.vocab_size)
    jloss, jgrads = _reference_grads(jcfg, tree,
                                     jpolicies.make_mask(tree, jcfg), batch)
    dots = _port_grads(tree, tcfg, batch)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(float(dots[0]), jloss,
                               rtol=2 ** -8 if bf16 else 1e-5)
    assert {ref_path(n) for n in dots[1]} == jgrads.keys()
    tol = 5e-2 if bf16 else 1e-4
    for path, want in jgrads.items():
        g = stacked_at(dots[1], path).to(torch.float32).numpy()
        assert g.shape == want.shape, path
        assert np.linalg.norm(g - want) <= tol * np.linalg.norm(want), path
    _assert_same(dots, _port_grads(tree, tcfg.replace(remat="none"), batch))


def test_deepseek_scale_gradients_under_dots_match_reference():
    """Tiny deepseek-moe-16b, peqa, float32: every scale gradient under
    "dots" against ``jax.grad`` under "dots" — the recompute of each MoE
    block routes as its forward did (the router's product is kept) — and
    bit-equal to the port's under "none"."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg = test_torch_moe.tiny_pair(arch, "peqa", remat="dots")
    tree = test_torch_moe.policy_tree(arch, "peqa")
    batch = test_torch_moe.batch_of(tcfg.vocab_size, seed=5)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(jp, jcfg)
    # one compiled program (float32): the same values to ~1e-5 of each
    # leaf's largest entry, inside the tolerances, in a fraction of the time
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jregistry.build(jcfg).loss_fn, allow_int=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: v for (k, v), m in zip(test_torch_moe.flat(jgrads).items(),
                                      test_torch_moe.flat(jmask).values())
            if m}
    dots = _port_grads(tree, tcfg, batch)
    np.testing.assert_allclose(float(dots[0]), float(jloss), rtol=1e-5)
    got = test_torch_moe.flat(bridge._nest(test_torch_moe._stack_grads(
        dots[1])))
    assert got.keys() == want.keys()
    assert "layers/moe/experts_ep/up/scale" in got
    for key in want:
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    _assert_same(dots, _port_grads(tree, tcfg.replace(remat="none"), batch))


@pytest.mark.parametrize("arch", ["whisper-medium", "zamba2-7b"])
def test_dots_runs_as_none_where_the_reference_does(arch, monkeypatch):
    """whisper-medium and zamba2-7b accept "dots" and run it as "none", as
    the reference does: every scale gradient against ``jax.grad`` under
    "dots", no checkpoint taken, and the gradients bit-equal to "none"'s."""
    if arch == "whisper-medium":
        mod, helpers = whisper, test_torch_whisper
        jcfg, tcfg = helpers.tiny_pair("peqa", remat="dots")
        tree, batch = helpers.policy_tree("peqa"), helpers.batch_of(
            tcfg, seed=5)
        helpers._grads_match(jcfg, tcfg, tree, batch)
        as_torch = helpers.torch_batch
    else:
        mod, helpers = zamba2, test_torch_xlstm
        jcfg, tcfg = helpers.tiny_pair(arch, "peqa", remat="dots")
        tree = helpers.policy_tree(arch, "peqa")
        batch = helpers.batch_of(tcfg, seed=5)
        helpers.grads_match(jcfg, tcfg, tree, batch)
        as_torch = helpers.torch_batch
    calls = []
    monkeypatch.setattr(mod, "checkpoint",
                        lambda *a, **kw: calls.append(1) or
                        pytest.fail("a checkpoint under remat='dots'"))
    runs = []
    for remat in ("dots", "none"):
        cfg = tcfg.replace(remat=remat)
        model = bridge.to_module(tree, cfg, device="cpu")
        mask = policies.make_mask(model, cfg)
        loss = registry.build(cfg, device="cpu").loss_fn(model,
                                                         as_torch(batch))
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters() if mask[n]}))
    assert not calls
    _assert_same(*runs)


# ------------------------------------------------------------ train steps

@pytest.mark.parametrize("mode,dtype,attn", [
    ("peqa", "float32", "dense"), ("full", "float32", "chunked"),
    ("peqa", "bfloat16", "dense")])
def test_train_steps_under_dots_match_reference(mode, dtype, attn):
    """3 train steps of tiny llama3.2-1b under "dots" against the
    reference's under "dots" (``test_torch_train.py``'s checks)."""
    _check_train_steps(mode, dtype, attn, "dots", OCFG)


# ----------------------------------------------------------- what it keeps

def _product_bytes(func, args, kwargs) -> int:
    """Bytes of a dense product's output, from its operands' shapes."""
    a, b = [t for t in args if isinstance(t, torch.Tensor)][-2:]
    dtype = next((x for x in args if isinstance(x, torch.dtype)),
                 kwargs.get("out_dtype", a.dtype))
    return a.shape[:-1].numel() * b.shape[-1] * dtype.itemsize


def _held_bytes(model, cfg, batch, monkeypatch):
    """Bytes held for the backward after one training forward: each
    storage autograd saves outside a checkpoint, once (the parameters and
    buffers excluded), plus the products a "dots" checkpoint keeps (the
    checkpoints' own inputs, one h a block under "block" and "dots", are
    in neither).  Also returns the loss."""
    weights = {t.untyped_storage().data_ptr() for t in
               list(model.parameters()) + list(model.buffers())}
    saved, kept = {}, []

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in weights:
            saved[ptr] = t.untyped_storage().nbytes()
        return t

    policy = transformer.dots_policy

    def counting(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(_product_bytes(func, args, kwargs))
        return out
    monkeypatch.setattr(transformer, "dots_policy", counting)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = transformer.loss_fn(model, batch, cfg)
    monkeypatch.setattr(transformer, "dots_policy", policy)
    return sum(saved.values()) + sum(kept), len(kept), loss


def test_dots_keeps_the_products_and_recomputes_k2(monkeypatch):
    """Tiny llama3.2-1b, peqa, float32, 2 × 24 tokens: the bytes held for
    the backward are ordered none > dots > block; under "dots" each block
    keeps the outputs of its dense products (the attention's two einsums;
    its linears are all quantized) and K2 runs twice a block — 7 linears
    in the forward and 7 again in the backward's recompute, as under
    "block" — where "none" runs it once; the loss is the same under all
    three."""
    _, tcfg = pair("llama3.2-1b", "peqa")
    tree = arm_tree("llama3.2-1b", "peqa")
    batch = _torch(_batch(tcfg.vocab_size))
    k2 = qm.quant_matmul
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return k2(*args, **kw)
    monkeypatch.setattr(qm, "quant_matmul", counted)
    held, runs = {}, {}
    for remat in ("none", "block", "dots"):
        cfg = tcfg.replace(remat=remat)
        model = bridge.to_module(tree, cfg, device="cpu")
        policies.make_mask(model, cfg)
        calls.clear()
        held[remat], n_kept, loss = _held_bytes(model, cfg, batch,
                                                monkeypatch)
        forward = len(calls)
        loss.backward()
        runs[remat] = (forward, len(calls) - forward, float(loss.detach()),
                       n_kept)
    layers = tcfg.n_layers
    assert all(m == 48 for m in calls)
    assert runs["none"][:2] == (7 * layers, 0)
    assert runs["block"][:2] == runs["dots"][:2] == (7 * layers, 7 * layers)
    assert len({r[2] for r in runs.values()}) == 1
    assert (runs["none"][3], runs["block"][3]) == (0, 0)
    assert runs["dots"][3] == 2 * layers
    assert held["none"] > held["dots"] > held["block"], held
