"""PyTorch port vs JAX reference: the encdec family (whisper-medium), the
model.

An encoder over B × enc_frames precomputed frame embeddings (the log-mel
frontend is a stub in both packages), a decoder with learned positions and
cross-attention, LayerNorm, GELU and the tied head.  Configuration:
``make_tiny`` of the config in both packages (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 12 frames, max_seq 512, vocab 512).  The
reference makes the weights, its unit LayerNorm gains and zero biases
replaced by seeded random values before both packages get the tree
(``bridge.to_module``); frames are seeded N(0, 1).

  * the config field by field; the build, its capabilities and refusals;
  * a bridge round trip;
  * ``encode``, ``forward`` and ``loss_fn`` in full / peqa × f32 / bf16;
  * the scale gradients against ``jax.grad`` under remat none and block;
  * ``prefill``, bucketed (``last_pos``) and not; ``decode_step`` at an
    int and a (B,) position; ``Engine.generate(prefix=frames)`` under
    ``attn_impl`` "dense" and "chunked";
  * ``policies.build`` bit-equal to ``api.init`` + ``prepare`` (nibble and
    plane, peqa and peqa_z); LoRA's and QAT's leaves, loss and gradients.

Tolerances, as ``test_torch_vlm.py``: float32 logits and caches atol/rtol
1e-4, the loss rtol 1e-5; bfloat16 the loss rtol 2⁻⁸ and the logits within
2⁻⁵ of their largest magnitude; greedy tokens equal; gradients rtol 1e-3
with atol 1e-4 of their largest magnitude.

The bf16 cases give both packages bf16 frames: the reference adds
``enc.pos`` cast to the frames' own dtype, so float32 frames promote its
bf16 encoder to float32, where the port casts the frames to the model's
dtype first (ROADMAP §3); ``test_frames_are_cast_to_the_model_dtype`` pins
the port's side.
"""
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
from repro.kernels import chunked_attention as jca
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core import lora, policies
from repro_torch.core.peqa import layer_index, ref_path
from repro_torch.models import linear, registry, whisper
from repro_torch.train.serve import Engine

from test_torch_configs import _shared_fields, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


ARCH = "whisper-medium"


def tiny_pair(mode: str = "peqa", **kw):
    """``make_tiny(get_config(ARCH))`` in both packages: (reference,
    port)."""
    j = jconfigs.make_tiny(jconfigs.get_config(ARCH)).replace(
        tuning=JTuning(mode=mode), **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(ARCH)).replace(
        tuning=TTuning(mode=mode), **kw)
    return j, t


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def fp_tree():
    """The reference's float32 weights, every LayerNorm gain and bias
    replaced by seeded random values (numpy)."""
    jcfg, _ = tiny_pair()
    fp = to_numpy(jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        if key == "g":
            return (1 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if key == "b":
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, fp)


@functools.lru_cache(maxsize=None)
def policy_tree(mode: str, layout: str = "nibble"):
    """``fp_tree()`` through the reference's policy for ``mode``."""
    jcfg, _ = tiny_pair(mode, quant=JQuant(layout=layout))
    return to_numpy(jpolicies.transform(
        jax.tree.map(jnp.asarray, fp_tree()), jcfg))


def frames(n: int, cfg, seed: int = 0) -> np.ndarray:
    """(n, enc_frames, d) seeded N(0, 1) float32 frame embeddings."""
    return np.random.default_rng(seed).normal(
        size=(n, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def batch_of(cfg, b=2, s=10, seed=0):
    toks = tokens(b, s + 1, cfg.vocab_size, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": frames(b, cfg, seed=seed + 1)}


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max()


def torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


# ------------------------------------------------------------------ configs

def test_whisper_config_and_build():
    for ref, port in ((jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)),
                      tiny_pair()):
        r, p = _shared_fields(ref, port)
        assert p == r
    tiny = tiny_pair()[1]
    assert (tiny.n_layers, tiny.enc_layers, tiny.enc_frames,
            tiny.max_seq) == (2, 2, 12, 512)
    full = registry.build(tconfigs.get_config(ARCH), device="cpu")
    caps = full.caps
    assert full.cfg.family == "encdec" and not full.cfg.use_rope
    assert (caps.prefix_key, caps.prefix_required, caps.prefix_positions,
            caps.bucketable, caps.positional) == ("frames", True, False, True,
                                                  True)
    jcaps = jregistry.build(jconfigs.get_config(ARCH)).caps
    assert (caps.slotted_reason, caps.verify_reason) == (
        jcaps.slotted_reason, jcaps.verify_reason)
    assert full.decode_step_slotted is None and full.prefill_slotted is None
    assert full.decode_verify is None and full.decode_verify_slotted is None
    # the whole model's storage: 0.79 B values, 705 M in eligible linears
    model = registry.module_class(full.cfg)(full.cfg, device="meta")
    lins = [m for m in model.modules() if isinstance(m, linear.Linear)]
    assert len(lins) == 24 * 6 + 24 * 10
    assert sum(m.w.numel() for m in lins) == 704_643_072
    assert sum(p.numel() for p in model.parameters()) == 793_198_592


def test_whisper_refusals():
    """What the port does not run on encdec, each with its reason, and
    learned positions still refused on the decoder families."""
    _, tiny = tiny_pair()
    for kw, why in ((dict(tuning=TTuning(mode="lora_optq")),
                     "lora_optq on encdec"),
                    (dict(kv_cache_dtype="int8"), "kv_cache_dtype='int8'"),
                    (dict(swa_window=4), "swa_window=4"),
                    (dict(enc_layers=0), "without an encoder")):
        with pytest.raises(NotImplementedError, match=why):
            registry.build(tiny.replace(**kw), device="cpu")
    for mode in ("full", "peqa", "peqa_z", "lora", "qat"):
        registry.build(tiny.replace(tuning=TTuning(mode=mode)), device="cpu")
    dense = tconfigs.make_tiny(tconfigs.get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="learned positions"):
        registry.build(dense.replace(use_rope=False), device="cpu")


def test_reference_tree_round_trips_through_the_bridge():
    for mode in ("full", "peqa"):
        tree = policy_tree(mode)
        model = bridge.to_module(tree, tiny_pair(mode)[1], device="cpu")
        assert isinstance(model, whisper.Whisper)
        back, want = flat(bridge.to_tree(model)), flat(tree)
        assert back.keys() == want.keys()
        assert ("dec/layers/xattn/wv/qw" in want) == (mode == "peqa")
        for key in want:
            np.testing.assert_array_equal(back[key], want[key], err_msg=key)


# -------------------------------------------------------- forward and loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
def test_encode_forward_and_loss_match_reference(mode, dtype):
    jcfg, tcfg = tiny_pair(mode, dtype=dtype)
    tree = policy_tree(mode)
    batch = batch_of(tcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["frames"] = jb["frames"].astype(jnp.dtype(dtype))
    jenc = jax.jit(lambda p, f: jwhisper.encode(p, f, jcfg))(jp, jb["frames"])
    jl = jax.jit(lambda p, f, t: jwhisper.forward(p, f, t, jcfg))(
        jp, jb["frames"], jb["tokens"])
    jloss = jregistry.build(jcfg).loss_fn(jp, jb)
    model = bridge.to_module(tree, tcfg, device="cpu")
    tb = torch_batch(batch)
    with torch.no_grad():
        tenc = whisper.encode(model, tb["frames"], tcfg)
        tl = whisper.forward(model, tb["frames"], tb["tokens"], tcfg)
        tloss = whisper.loss_fn(model, tb, tcfg)
    assert tenc.dtype == (torch.float32 if dtype == "float32"
                          else torch.bfloat16)
    assert tl.shape == (2, 10, tcfg.vocab_size) and tl.dtype == torch.float32
    assert_close(tenc.float(), np.asarray(jenc.astype(jnp.float32)), dtype)
    assert_close(tl, jl, dtype)
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)


def test_frames_are_cast_to_the_model_dtype():
    """The port's encoder runs in the activation dtype whatever the frames'
    dtype: a bf16 model's output is the same for float32 frames as for the
    same frames rounded to bf16 first, and its logits move with the
    frames."""
    _, tcfg = tiny_pair("peqa", dtype="bfloat16")
    model = bridge.to_module(policy_tree("peqa"), tcfg, device="cpu")
    tb = torch_batch(batch_of(tcfg))
    with torch.no_grad():
        a = whisper.forward(model, tb["frames"], tb["tokens"], tcfg)
        b = whisper.forward(model, tb["frames"].bfloat16(), tb["tokens"],
                            tcfg)
        c = whisper.forward(model, tb["frames"].flip(0), tb["tokens"], tcfg)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def _stacked_grads(model, mask):
    """{reference path: gradient stacked over its stack's layers}."""
    by = {}
    for name, p in model.named_parameters():
        if mask[name]:
            by.setdefault(ref_path(name).strip("/"), {})[layer_index(name)] \
                = p.grad.detach().numpy()
    return {k: v[None] if None in v else np.stack([v[i] for i in sorted(v)])
            for k, v in by.items()}


def _grads_match(jcfg, tcfg, tree, batch, seed_lora_b=False):
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(jp, jcfg)
    grad = jax.grad(jregistry.build(jcfg).loss_fn, allow_int=True)
    if jcfg.dtype == "float32":
        # one compiled program: the same values to ~1e-5 of each leaf's
        # largest entry, inside the tolerances, in a fraction of the time
        grad = jax.jit(grad)
    jgrads = grad(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: v for (k, v), m in zip(flat(jgrads).items(),
                                      flat(jmask).values()) if m}
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    assert {ref_path(n).strip("/") for n, m in mask.items() if m} == \
        set(want)
    whisper.loss_fn(model, torch_batch(batch), tcfg).backward()
    got = _stacked_grads(model, mask)
    for key in want:
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    return got


@pytest.mark.parametrize("remat", ["none", "block"])
def test_scale_gradients_match_reference(remat):
    """float32 PEQA: every scale gradient — of the encoder's, the decoder's
    self- and cross-attention's and the MLPs' linears — against
    ``jax.grad`` of the reference's loss; ``pos``, norms, the table, codes
    and zeros frozen."""
    jcfg, tcfg = tiny_pair("peqa", remat=remat)
    got = _grads_match(jcfg, tcfg, policy_tree("peqa"),
                       batch_of(tcfg, seed=5))
    assert all(k.endswith("/scale") for k in got)
    assert len(got) == 6 + 10
    assert "dec/layers/xattn/wk/scale" in got and "enc/layers/mlp/up/scale" \
        in got


@pytest.mark.parametrize("mode", ["lora", "qat"])
def test_lora_and_qat_arms_match_reference(mode):
    """LoRA adapts wq and wv of the encoder's attention and of the
    decoder's self- and cross-attention alike (``lora_b`` seeded non-zero,
    so a transposed product shows); QAT fake-quantizes every eligible
    linear and trains it with ``pos``, norms and table.  The port's
    transform puts the adapters where the reference's does; gradients
    against ``jax.grad``."""
    jcfg, tcfg = tiny_pair(mode)
    tree = policy_tree(mode)
    if mode == "lora":
        rng = np.random.default_rng(3)
        tree = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.normal(size=v.shape) * 0.02).astype(np.float32)
            if str(getattr(p[-1], "key", p[-1])) == "lora_b" else v, tree)
        model = policies.transform(whisper.init(
            tcfg, torch.Generator().manual_seed(0), "cpu"), tcfg,
            device="cpu")
        targets = [n for n, _ in lora.targets(model, tcfg.tuning)]
        assert len(targets) == 2 * (2 + 2 * 2)
        assert "dec.layers.1.xattn.wv" in targets
        assert {ref_path(f"{n}.lora_a").strip("/") for n in targets} == \
            {k for k in flat(tree) if k.endswith("lora_a")}
    got = _grads_match(jcfg, tcfg, tree, batch_of(tcfg, seed=6))
    if mode == "qat":
        assert {"enc/pos", "dec/pos", "dec/embed/emb",
                "dec/layers/xattn/wq/scale"} <= set(got)
    else:
        assert all("lora" in k for k in got)


# ------------------------------------------------------------ serving parts

@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_matches_reference(bucketed):
    """Prefill of a prompt behind its frames: the last logits, the self K/V
    at the prompt's capacity and the cross K/V over the 12 frames;
    right-padded to 16 rows with ``last_pos`` = S − 1."""
    jcfg, tcfg = tiny_pair("peqa")
    tree = policy_tree("peqa")
    s = 10
    toks = tokens(2, s, tcfg.vocab_size, seed=1)
    fr = frames(2, tcfg, seed=2)
    if bucketed:
        toks = np.pad(toks, ((0, 0), (0, 16 - s)))
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "frames": torch.from_numpy(fr)}
    if bucketed:
        jb["last_pos"] = jnp.int32(s - 1)
        tb["last_pos"] = s - 1
    jl, jcache = jregistry.build(jcfg).prefill(
        jax.tree.map(jnp.asarray, tree), jb)
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    with torch.inference_mode():
        tl, tcache = api.prefill(model, tb)
    assert_close(tl, jl, "float32")
    assert sorted(tcache) == sorted(jcache) == ["k", "v", "xk", "xv"]
    assert tcache["k"].shape == (2, 2, toks.shape[1], 4, 16)
    assert tcache["xk"].shape == (2, 2, tcfg.enc_frames, 4, 16)
    for key in tcache:
        assert_close(tcache[key], jcache[key], "float32")


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_reference(per_row):
    """Three decode steps after a prefill of 8 tokens into a 12-row cache,
    at an int position or at a (B,) one (row 1 a position behind row 0),
    against the reference's ``decode_step`` on the same cache: logits and
    every cache leaf."""
    jcfg, tcfg = tiny_pair("peqa")
    tree = policy_tree("peqa")
    jp = jax.tree.map(jnp.asarray, tree)
    s = 8
    toks = tokens(2, s, tcfg.vocab_size, seed=3)
    fr = frames(2, tcfg, seed=4)
    _, pc = jregistry.build(jcfg).prefill(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    jcache = jwhisper.init_cache(jcfg, 2, 12)
    jcache = {k: v.at[:, :, :pc[k].shape[2]].set(pc[k]) for k, v in
              jcache.items()}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    step_tok = tokens(2, 3, tcfg.vocab_size, seed=5)
    jstep = jax.jit(lambda p, c, t, pos: jwhisper.decode_step(p, c, t, pos,
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
        assert_close(tcache[key], jcache[key], "float32")


def test_decode_position_past_the_table_raises():
    _, tcfg = tiny_pair("peqa")
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(policy_tree("peqa"), tcfg, device="cpu")
    cache = api.init_cache(2, 8)
    tok = torch.zeros(2, 1, dtype=torch.long)
    for pos in (tcfg.max_seq, torch.tensor([3, tcfg.max_seq])):
        with pytest.raises(ValueError, match="max_seq=512"):
            api.decode_step(model, cache, tok, pos)
    api.decode_step(model, cache, tok, torch.tensor([3, tcfg.max_seq - 1]))


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


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_generate_with_frames_matches_reference(impl, request):
    """``Engine.generate(prefix=frames)``: greedy tokens equal to the
    reference's, under both ``attn_impl`` values; frames take no decoder
    position (a cache of prompt + n_new − 1 rows suffices)."""
    if impl == "chunked":
        request.getfixturevalue("jit_safe_chunked")
    jcfg, tcfg = tiny_pair("peqa", attn_impl=impl)
    tree = policy_tree("peqa")
    prompt = tokens(2, 7, tcfg.vocab_size, seed=6)
    fr = frames(2, tcfg, seed=7)
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6,
                                    prefix=jnp.asarray(fr)))
    eng = Engine(registry.build(tcfg, device="cpu"),
                 bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    got = eng.generate(prompt, 6, prefix=fr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        eng.generate(prompt, 6, cache_len=7 + 5, prefix=fr).numpy(), want)
    with pytest.raises(ValueError, match="cannot hold"):
        eng.generate(prompt, 6, cache_len=7 + 4, prefix=fr)


# ----------------------------------------------------------------- the build

@pytest.mark.parametrize("mode,layout", [("peqa", "nibble"),
                                         ("peqa", "plane"),
                                         ("peqa_z", "nibble")])
def test_streamed_build_is_bit_equal_to_the_whole_build(mode, layout):
    """``policies.build`` quantizes each encoder and decoder block as it is
    drawn (``whisper.init``'s transform, names ``enc.layers.i`` and
    ``dec.layers.i``); every tensor equals ``api.init`` + ``prepare``'s,
    the masks agree, and ``pos`` is stored in the activation dtype under a
    frozen mode."""
    _, cfg = tiny_pair(mode, quant=QuantConfig(layout=layout, n_grid=4),
                       dtype="bfloat16")
    api = registry.build(cfg, device="cpu")
    seen = []
    real = whisper.init

    def spy(*a, transform=None, **kw):
        wrapped = None if transform is None else (
            lambda name, mod: (seen.append(name), transform(name, mod)))
        return real(*a, transform=wrapped, **kw)
    whisper.init = spy
    try:
        streamed, smask = policies.build(api, 5)
    finally:
        whisper.init = real
    assert seen == ["enc.layers.0", "enc.layers.1", "dec.layers.0",
                    "dec.layers.1"]
    whole, wmask = policies.prepare(api.init(5), cfg, device="cpu")
    assert smask == wmask
    ta = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tb = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
    assert ta["dec.pos"].dtype == ta["enc.pos"].dtype == torch.bfloat16
    assert ta["dec.pos"].shape == (cfg.max_seq, cfg.d_model)
    assert not smask["dec.pos"] and not smask["enc.layers.0.ln1.g"]
    assert smask["dec.layers.1.xattn.wk.scale"]
    assert smask["enc.layers.0.mlp.up.zero"] == (mode == "peqa_z")
    quantized = [m for m in streamed.modules()
                 if isinstance(m, linear.Linear) and m.quantized]
    assert len(quantized) == 6 * cfg.enc_layers + 10 * cfg.n_layers
