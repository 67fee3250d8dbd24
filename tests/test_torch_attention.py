"""PyTorch port vs JAX reference: the chunked attention path (K4's plain
version on the CPU) and the models that take it.

  * ``ops.attention(impl="chunked")`` against the reference's
    ``flash_attention_pallas(..., interpret=True)`` (layout transposed, KV
    heads repeated for it) at the four cases of the reference's own kernel
    test plus a GQA case, and against the reference's
    ``ops.attention(impl="chunked")`` (its online-softmax scan) with (B,)
    offsets and a window.  Tolerance rtol 1e-5 / atol 1e-5 in float32 (the
    reference's own).  Rows that see no key are compared only inside the
    port: the port returns 0 for them, the reference's kernel and scan the
    mean of V (a finite −1e30 mask) — no model path makes such a row.
  * ``kernels/ref.py::flash_attention_ref`` with ``window`` and ``scale``
    against the reference's ``ref.flash_attention_ref``.
  * The tiny llama with ``attn_impl="chunked"`` and min/max RTN: prefill and
    decode logits within 1e-4 of the reference's, greedy tokens equal.
  * Speculative serving over the resident scheduler on the reference's
    2-layer bit-plane fixture with ``attn_impl="chunked"``: the report
    equal to the reference's — tokens and every counter.

The reference's engine cannot run ``attn_impl="chunked"`` as it stands: its
``chunked_attention`` declares ``offset`` a non-differentiable argument of
a custom VJP, which refuses the traced positions of its own jitted decode
step.  The engine tests therefore run the reference with
``chunked_attention`` replaced by that function's own forward body (the
``_fwd`` scan it wraps, unchanged).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.kernels import chunked_attention as jca
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.core import peqa
from repro_torch.core import scale_bank as sb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import registry
from repro_torch.serve import ServeConfig
from repro_torch.train.serve import Engine

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy, tokens
from test_torch_serve_speculative import (SPEC_COUNTERS, SPEC_PER_REQUEST,
                                          TASKS, _cfgs, _requests)
from _torch_threads import _one_torch_thread  # noqa: F401


def _qkv(b, sq, sk, hq, hkv, d, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), impl="chunked", **kw).numpy()


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,causal,window,offset,bq,bk",
    [(2, 32, 32, 2, 2, 16, True, None, None, 16, 16),
     (1, 8, 24, 4, 4, 8, True, None, 16, 8, 8),        # decode offset
     (2, 32, 32, 2, 2, 16, True, 12, None, 8, 16),     # sliding window
     (1, 16, 48, 2, 2, 8, False, None, None, 16, 12),  # not causal
     (2, 16, 40, 8, 2, 16, True, None, 24, 8, 8)])     # GQA, rep 4
def test_chunked_matches_reference_pallas_kernel(b, sq, sk, hq, hkv, d, causal,
                                                 window, offset, bq, bk):
    q, k, v = _qkv(b, sq, sk, hq, hkv, d)
    rep = hq // hkv
    got = _port(q, k, v, causal=causal, window=window, offset=offset)
    want = flash_attention_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.repeat(jnp.asarray(k.transpose(0, 2, 1, 3)), rep, axis=1),
        jnp.repeat(jnp.asarray(v.transpose(0, 2, 1, 3)), rep, axis=1),
        causal=causal, window=window, offset=offset, block_q=bq, block_k=bk,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("sq", [1, 4])
def test_chunked_matches_reference_scan_with_row_offsets(sq, window):
    """The slot pool's decode (Sq 1) and verify (Sq 4) shapes: every batch
    row at its own depth in a 64-slot cache."""
    q, k, v = _qkv(5, sq, 64, 8, 2, 16, seed=sq)
    off = np.array([0, 9, 30, 41, 60 - sq], np.int32)
    got = _port(q, k, v, causal=True, window=window,
                offset=torch.from_numpy(off))
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window, offset=jnp.asarray(off),
                          impl="chunked")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rows_without_a_visible_key_are_zero():
    """offset −3: queries 0..2 see no key.  The port returns 0 there (its
    plain version's rule, which the card's kernel follows); every other row
    matches the reference's kernel."""
    q, k, v = _qkv(2, 8, 8, 2, 2, 8, seed=4)
    got = _port(q, k, v, causal=True, offset=-3)
    assert np.array_equal(got[:, :3], np.zeros_like(got[:, :3]))
    want = flash_attention_pallas(
        *(jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)),
        causal=True, offset=-3, block_q=8, block_k=8, interpret=True)
    want = np.asarray(want).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-5, atol=1e-5)
    assert not np.allclose(want[:, :3], 0)     # the reference: mean of V


@pytest.mark.parametrize("window,scale", [(5, None), (None, 0.3), (3, 0.7)])
def test_flash_attention_ref_window_and_scale_match_reference(window, scale):
    q, k, v = _qkv(2, 12, 12, 4, 2, 8, seed=9)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  scale=scale).numpy()
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window, scale=scale)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_cpu_decode_attention_keeps_the_plain_path(impl, s, monkeypatch):
    """On CPU tensors the decode attention stays the plain version: under
    "dense" the f32 einsum, a verify's S > 1 queries as one S = 1 call
    each; under "chunked" one call of K4's wrapper, which returns its plain
    version for CPU tensors.  (On the card both take K4: the GPU tests.)"""
    from repro_torch.models import attention
    calls, einsums = [], []
    real_attention, real_ref = ops.attention, ref.flash_attention_ref

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw["impl"]))
        return real_attention(q, k, v, **kw)

    def spy_ref(q, *a, **kw):
        einsums.append(q.shape[1])
        return real_ref(q, *a, **kw)
    monkeypatch.setattr(ops, "attention", spy)
    monkeypatch.setattr(ref, "flash_attention_ref", spy_ref)
    q, k, v = (torch.from_numpy(t) for t in _qkv(3, s, 40, 4, 2, 16))
    pos = torch.tensor([5, 17, 30])
    got = attention._decode_attention(q, k, v, pos, impl)
    if impl == "dense":
        assert calls == [(1, "dense")] * s and einsums == [1] * s
        want = torch.cat([real_ref(q[:, j:j + 1], k, v, causal=True,
                                   offset=pos + j) for j in range(s)], dim=1)
    else:
        assert calls == [(s, "chunked")] and einsums == []
        want = real_ref(q, k, v, causal=True, offset=pos)
    assert torch.equal(got, want)


def test_attention_refuses_unknown_impl():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q[..., :6], k[..., :6], v[..., :6])


@pytest.fixture
def jit_safe_chunked(monkeypatch):
    """The reference's ``chunked_attention`` forward without its custom-VJP
    wrapper, so a traced ``offset`` may reach it (forward only)."""
    def forward(q, k, v, causal=True, window=None, scale=None, offset=None,
                block=jca.DEFAULT_BLOCK):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        offset = offset if offset is not None else k.shape[1] - q.shape[1]
        return jca._fwd(q, k, v, causal, window, scale, offset, block)[0]
    monkeypatch.setattr(jca, "chunked_attention", forward)


@pytest.fixture(scope="module")
def chunked_pair():
    jcfg, tcfg = tiny_llama_pair(n_grid=1)
    jcfg, tcfg = (c.replace(attn_impl="chunked") for c in (jcfg, tcfg))
    fp, jq = reference_params(jcfg, seed=1)
    model = peqa.quantize_params(bridge.to_module(to_numpy(fp), tcfg,
                                                  device="cpu"),
                                 tcfg.quant, device="cpu")
    return jcfg, tcfg, jq, model


def _count_k4(monkeypatch):
    calls = []
    real = fa.flash_attention

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    return calls


def test_chunked_model_logits_match_reference(chunked_pair, monkeypatch):
    jcfg, tcfg, jq, model = chunked_pair
    japi, api = jregistry.build(jcfg), registry.build(tcfg, device="cpu")
    calls = _count_k4(monkeypatch)
    toks = tokens(2, 10, tcfg.vocab_size, seed=6)
    with jops.force_impl("interpret"):
        jl, jcache = japi.prefill(jq, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert calls == [(2, 10, tcfg.n_heads, tcfg.d_head)] * tcfg.n_layers
    cap = 16
    jfull = jax.tree.map(lambda d, s: d.at[:, :, :10].set(s),
                         japi.init_cache(2, cap), jcache)
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
    assert len(calls) == 3 * tcfg.n_layers


def test_chunked_greedy_tokens_equal_reference(chunked_pair,
                                               jit_safe_chunked):
    jcfg, tcfg, jq, model = chunked_pair
    toks = tokens(2, 24, tcfg.vocab_size, seed=3)
    with jops.force_impl("interpret"):
        want = np.asarray(JEngine(jregistry.build(jcfg), jq).generate(
            jnp.asarray(toks), 6))
    got = Engine(registry.build(tcfg, device="cpu"), model,
                 device="cpu").generate(toks, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_speculative_over_resident_report_matches_reference(
        jit_safe_chunked):
    jcfg, tcfg = (c.replace(attn_impl="chunked") for c in _cfgs())
    rng = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(rng), jcfg, rng)
    p = jax.tree.map(np.asarray, p)
    sets = {TASKS[0]: jsb.extract_scales(p)}
    rngs = np.random.default_rng(7)
    for t in TASKS[1:]:
        sets[t] = {k: (v * rngs.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
                   for k, v in sets[TASKS[0]].items()}
    jbank, tbank = jsb.ScaleBank(), sb.ScaleBank()
    for t, s in sets.items():
        jbank.tasks[t] = s
        tbank.tasks[t] = s
    cfg = dict(n_slots=3, scheduler="speculative", spec_k=3)
    jrep = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, p),
                   bank=jbank).serve(_requests(True, cls=JRequest),
                                     JServeConfig(**cfg))
    trep = Engine(registry.build(tcfg, device="cpu"),
                  bridge.to_module(p, tcfg, device="cpu"), bank=tbank,
                  device="cpu").serve(_requests(True), ServeConfig(**cfg))
    assert trep.scheduler == "speculative"
    assert trep.task_drain_idle_slot_steps == 0         # resident underneath
    for key in SPEC_COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    for jm, tm in zip(jrep.requests, trep.requests):
        for key in SPEC_PER_REQUEST:
            assert getattr(tm, key) == getattr(jm, key), (tm.rid, key)
