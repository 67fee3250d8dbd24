"""PyTorch port vs JAX reference: Mamba2's chunked scan and block, and the
hybrid family (zamba2-7b) model.

Configuration and weights as ``test_torch_xlstm.py`` (whose helpers this
file shares): ``make_tiny`` — 7 Mamba2 layers in 2 groups of 3 and a tail
layer, the shared attention block after each group, d_model 64, d_state 8,
SSM heads of 16 (8 of them), chunk 8, 4 attention heads of 16.

  * ``mamba2.ssd_chunked`` against the reference's, over 3 chunks from a
    non-zero state, and its gradients; a length that is no multiple of
    the chunk refused with the reference's message;
  * a Mamba2 block's ``apply_train`` (its state and its conv tail, also
    left-padded for a prompt shorter than the window) against the
    reference's, and the reference's own train-vs-decode consistency;
  * zamba2 ``forward`` and ``loss_fn`` in full / peqa × f32 / bf16, the
    scale gradients against ``jax.grad`` under remat none and block,
    ``prefill`` caches leaf by leaf, ``decode_step`` at an int and a (B,)
    position, the reference's own prefill-then-decode consistency,
    ``generate`` under ``attn_impl`` "dense" and "chunked" and in a
    ``swa_window`` ring;
  * the streamed build bit-equal, LoRA (the shared block's wq / wv) and
    QAT against the reference.

Tolerances as ``test_torch_xlstm.py`` (the bf16 logits as the forward
test's docstring says); the scan's outputs and gradients rtol 1e-4 / atol
1e-5 of their largest magnitude; states after decode steps rtol 1e-4 /
atol 1e-4 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunked_attention as jca
from repro.models import mamba2 as jmamba2
from repro.models import registry as jregistry
from repro.models import zamba2 as jzamba2
from repro.train.serve import Engine as JEngine
from repro_torch import bridge
from repro_torch.models import mamba2, registry
from repro_torch.train.serve import Engine

from test_torch_configs import tokens
from test_torch_xlstm import (assert_close, assert_state_close, batch_of,
                              forward_matches, grads_match, lora_qat_match,
                              policy_tree, streamed_build_equal, tiny_pair)
from _torch_threads import _one_torch_thread  # noqa: F401


ARCH = "zamba2-7b"


def _scan_inputs(seed, b=2, s=24, h=3, hd=5, st=4):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, h)))                  # softplus > 0
    return (f(b, s, h, hd), f(b, s, h, st), f(b, s, h, st),
            -dt * rng.uniform(0.5, 2.0, (h,)).astype(np.float32), dt,
            f(b, h, hd, st))


def test_ssd_chunked_matches_reference():
    """24 steps in 3 chunks of 8 from a non-zero state: y and the last
    state, and the gradients of a random projection of both with respect
    to every input, against the reference's scan."""
    args = _scan_inputs(0)
    rng = np.random.default_rng(1)
    wy = rng.normal(size=args[0].shape).astype(np.float32)
    ws = rng.normal(size=args[-1].shape).astype(np.float32)

    def jloss(*a):
        y, s_last = jmamba2.ssd_chunked(*a, chunk=8)
        return (y * wy).sum() + (s_last * ws).sum()
    jy, js = jmamba2.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    ty, ts = mamba2.ssd_chunked(*targs, chunk=8)
    ((ty * torch.from_numpy(wy)).sum()
     + (ts * torch.from_numpy(ws)).sum()).backward()
    for got, want in ((ty, jy), (ts, js)) + tuple(
            (t.grad, g) for t, g in zip(targs, jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_ssd_chunked_refuses_a_ragged_length():
    """A length that is no multiple of min(chunk, S): the reference
    asserts, the port raises ``ValueError`` with the same message (it pads
    nothing); a length under the chunk is one chunk."""
    args = _scan_inputs(2, s=12)
    with pytest.raises(AssertionError) as jerr:
        jmamba2.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError) as terr:
        mamba2.ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    assert str(terr.value) == str(jerr.value) == "seq 12 % chunk 8 != 0"
    short = _scan_inputs(3, s=5)
    y, _ = mamba2.ssd_chunked(*map(torch.from_numpy, short), chunk=8)
    jy, _ = jmamba2.ssd_chunked(*map(jnp.asarray, short), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)


def _block(tree, tcfg, g=0, i=0):
    """Block (g, i) of the port's model and the reference's leaves."""
    model = bridge.to_module(tree, tcfg, device="cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a[g, i]), tree["mamba_groups"])
    return model.mamba_groups[g][i], jp


@pytest.mark.parametrize("s", [2, 16])
def test_mamba2_block_matches_reference(s):
    """``apply_train(return_state=True)`` of one block: the output, the SSM
    state and the conv tail — the last 3 pre-conv ``xproj`` rows, left-
    padded with zeros for a 2-token input."""
    jcfg, tcfg = tiny_pair(ARCH)
    block, jp = _block(policy_tree(ARCH, "peqa"), tcfg, 1, 2)
    u = np.random.default_rng(4).normal(size=(2, s, 64)).astype(np.float32)
    jy, jst = jmamba2.apply_train(jp, jnp.asarray(u), jcfg, return_state=True)
    with torch.no_grad():
        ty, tst = mamba2.apply_train(block, torch.from_numpy(u), tcfg,
                                     return_state=True)
    assert_close(ty, jy, "float32")
    assert tst["conv"].shape == (2, 3, 128)
    for key in ("ssm", "conv"):
        assert_close(tst[key], jst[key], "float32")
    if s == 2:
        assert not tst["conv"][:, 0].any()


def test_mamba2_decode_matches_train():
    """The reference's ``test_mamba2_decode_matches_train`` on the port:
    16 single-token decode steps from the zero state give the training
    output and its final state (rtol / atol 1e-4 and 1e-4 / 1e-5, as
    there)."""
    _, tcfg = tiny_pair(ARCH, "full")
    block, _ = _block(policy_tree(ARCH, "full"), tcfg)
    u = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, 64)).astype(np.float32) * 0.5)
    st = mamba2.init_state(tcfg, 2, 1, "cpu")
    s_l, c_l = st["ssm"][0], st["conv"][0]
    with torch.no_grad():
        y_train, final = mamba2.apply_train(block, u, tcfg, return_state=True)
        ys = []
        for t in range(16):
            yt, s_l, c_l = mamba2.apply_decode(block, u[:, t:t + 1], tcfg,
                                               s_l, c_l)
            ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_train.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final["ssm"].numpy(), s_l.numpy(), rtol=1e-4,
                               atol=1e-5)


# ----------------------------------------------------- zamba2: the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
def test_zamba2_forward_and_loss_match_reference(mode, dtype):
    """In bf16 the reference's own logits lie up to 1.8 from its float32
    ones (of at most 4.4, RMS 0.10–0.18: seven Mamba2 blocks and two
    attention blocks amplify bf16 rounding, from the first position on),
    so there the port's logits are held to the reference's float32 ones:
    an RMS distance at most twice the reference's bf16 logits'; the loss
    to rtol 2⁻⁸ as everywhere."""
    forward_matches(ARCH, mode, dtype, against_f32=True)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_zamba2_scale_gradients_match_reference(remat):
    """float32 PEQA: every scale gradient — the Mamba2 blocks' six linears
    (grouped and tail) and the shared block's seven, summed over its two
    applications — against ``jax.grad`` (remat "block" nests a checkpoint
    of each block inside each group's, as the reference); ``A_log``,
    ``ssm_D``, ``dt_bias``, ``conv``, ``gnorm``, norms, table, codes and
    zeros frozen."""
    jcfg, tcfg = tiny_pair(ARCH, "peqa", remat=remat)
    got = grads_match(jcfg, tcfg, policy_tree(ARCH, "peqa"),
                      batch_of(tcfg, seed=5))
    assert all(k.endswith("/scale") for k in got) and len(got) == 6 + 6 + 7
    assert got["mamba_groups/dtproj/scale"].shape == (2, 3, 8, 1)
    assert got["shared/attn/wq/scale"].shape == (64, 1)


def test_zamba2_prefill_matches_reference():
    """Prefill of 16 tokens: the last logits, both applications' K/V and
    every SSM and conv state, grouped and tail."""
    jcfg, tcfg = tiny_pair(ARCH)
    tree = policy_tree(ARCH, "peqa")
    toks = tokens(2, 16, tcfg.vocab_size, seed=1)
    jl, jcache = jregistry.build(jcfg).prefill(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    with torch.inference_mode():
        tl, tcache = api.prefill(model, {"tokens": torch.from_numpy(toks)
                                         .long()})
    assert_close(tl, jl, "float32")
    assert sorted(tcache) == sorted(jcache) == [
        "attn_k", "attn_v", "conv", "conv_tail", "ssm", "ssm_tail"]
    assert tcache["attn_k"].shape == (2, 2, 16, 4, 16)
    assert tcache["ssm"].shape == (2, 3, 2, 8, 16, 8)
    for key in tcache:
        assert_close(tcache[key], jcache[key], "float32")


@pytest.mark.parametrize("per_row", [False, True])
def test_zamba2_decode_step_matches_reference(per_row):
    """Three decode steps after a prefill of 8 tokens into a 12-row cache,
    at an int position or at a (B,) one (row 1 a position behind row 0),
    against the reference's ``decode_step``: logits and every leaf."""
    jcfg, tcfg = tiny_pair(ARCH)
    tree = policy_tree(ARCH, "peqa")
    jp = jax.tree.map(jnp.asarray, tree)
    s = 8
    toks = tokens(2, s, tcfg.vocab_size, seed=3)
    _, pc = jregistry.build(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)})
    jcache = jzamba2.init_cache(jcfg, 2, 12)
    jcache = {k: v.at[:, :, :s].set(pc[k]) if k.startswith("attn")
              else pc[k] for k, v in jcache.items()}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    step_tok = tokens(2, 3, tcfg.vocab_size, seed=5)
    jstep = jax.jit(lambda p, c, t, pos: jzamba2.decode_step(p, c, t, pos,
                                                             jcfg))
    for i in range(3):
        pos = np.array([s + i, s + i - 1]) if per_row else s + i
        jl, jcache = jstep(jp, jcache, jnp.asarray(step_tok[:, i:i + 1]),
                           jnp.asarray(pos, jnp.int32))
        tpos = torch.from_numpy(pos) if per_row else s + i
        with torch.inference_mode():
            tl, tcache = api.decode_step(
                model, tcache, torch.from_numpy(step_tok[:, i:i + 1]).long(),
                tpos)
        assert_close(tl, jl, "float32")
    for key in tcache:
        assert_state_close(tcache[key], jcache[key])


def test_zamba2_prefill_decode_consistency():
    """The reference's ``test_zamba2_prefill_decode_consistency`` on the
    port: the prefill's last logits are the forward's at the last position
    (rtol / atol 2e-4), and a decode step after it is finite and shaped
    (B, V)."""
    _, tcfg = tiny_pair(ARCH, "full")
    api = registry.build(tcfg, device="cpu")
    model = api.init(0)
    toks = torch.from_numpy(tokens(2, 16, tcfg.vocab_size, seed=4)).long()
    with torch.no_grad():
        logits = api.forward(model, toks)
        lg, cache = api.prefill(model, {"tokens": toks})
        np.testing.assert_allclose(lg.numpy(), logits[:, -1].numpy(),
                                   rtol=2e-4, atol=2e-4)
        full = api.init_cache(2, 17)
        for k, v in cache.items():
            (full[k][:, :, :16] if k.startswith("attn") else full[k]
             ).copy_(v)
        lg2, _ = api.decode_step(model, full, toks[:, :1], 16)
    assert lg2.shape == (2, tcfg.vocab_size) and torch.isfinite(lg2).all()


@pytest.fixture
def jit_safe_chunked(monkeypatch):
    """The reference's ``chunked_attention`` forward without its custom-VJP
    wrapper, so a traced ``offset`` may reach it (forward only): the
    reference's engine cannot run "chunked" under jit otherwise."""
    def forward(q, k, v, causal=True, window=None, scale=None, offset=None,
                block=jca.DEFAULT_BLOCK):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        offset = offset if offset is not None else k.shape[1] - q.shape[1]
        return jca._fwd(q, k, v, causal, window, scale, offset, block)[0]
    monkeypatch.setattr(jca, "chunked_attention", forward)


@pytest.mark.parametrize("kw", [dict(), dict(attn_impl="chunked"),
                                dict(swa_window=4)],
                         ids=["dense", "chunked", "ring4"])
def test_zamba2_generate_matches_reference(kw, request):
    """``Engine.generate`` of a 16-token prompt and 6 new: greedy tokens
    equal to the reference's, under both ``attn_impl`` values and with a
    4-slot ring (the shared block's K/V wrap; the prompt's cache is in
    ring layout)."""
    if kw.get("attn_impl") == "chunked":
        request.getfixturevalue("jit_safe_chunked")
    jcfg, tcfg = tiny_pair(ARCH, **kw)
    tree = policy_tree(ARCH, "peqa")
    prompt = tokens(2, 16, tcfg.vocab_size, seed=6)
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    eng = Engine(registry.build(tcfg, device="cpu"),
                 bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    got = eng.generate(prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    if "swa_window" in kw:
        with torch.inference_mode():
            _, cache = eng.api.prefill(eng.model, {"tokens": got[:, :16]})
        assert cache["attn_k"].shape[2] == 4
    else:
        with pytest.raises(ValueError, match="cannot hold"):
            eng.generate(prompt, 6, cache_len=16 + 4)


# ----------------------------------------------------------------- the build

@pytest.mark.parametrize("mode,layout", [("peqa", "nibble"),
                                         ("peqa", "plane"),
                                         ("peqa_z", "nibble")])
def test_zamba2_streamed_build_is_bit_equal(mode, layout):
    streamed, smask = streamed_build_equal(
        ARCH, mode, layout,
        [f"mamba_groups.{g}.{i}" for g in range(2) for i in range(3)]
        + ["shared", "mamba_tail.0", "lm_head"])
    for leaf in ("A_log", "ssm_D", "dt_bias", "conv.w", "conv.b", "gnorm.g"):
        assert not smask[f"mamba_groups.1.2.{leaf}"], leaf
    assert smask["shared.attn.wq.scale"] and smask["mamba_tail.0.dtproj.scale"]
    assert smask["mamba_groups.0.0.xproj.zero"] == (mode == "peqa_z")
    assert streamed.shared.attn.wq.in_features == 128
    assert sum(m.quantized for m in streamed.modules()
               if hasattr(m, "quantized")) == 7 * 6 + 7


@pytest.mark.parametrize("mode", ["lora", "qat"])
def test_zamba2_lora_and_qat_match_reference(mode):
    got = lora_qat_match(ARCH, mode, n_targets=2)
    if mode == "qat":
        assert {"mamba_groups/A_log", "mamba_groups/conv/w",
                "mamba_tail/dt_bias", "shared/ln1/g",
                "shared/attn/wk/scale"} <= set(got)
    else:
        assert set(got) == {"shared/attn/wq/lora_a", "shared/attn/wq/lora_b",
                            "shared/attn/wv/lora_a", "shared/attn/wv/lora_b"}
