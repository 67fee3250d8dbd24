"""PyTorch port vs JAX reference: the recurrent families' configs, build and
bridge, and the ssm family (xlstm-125m) model.

Configuration: ``make_tiny`` of the config in both packages — xlstm: 4
layers (2 groups of one sLSTM and one mLSTM), d_model 64, 4 heads (mLSTM
hd 32, sLSTM hd 16), chunk 8, vocab 512; zamba2: 7 Mamba2 layers (2 groups
of 3 and a tail layer), the shared block every 3, d_state 8, SSM heads of
16, chunk 8.  The reference makes the weights; its unit and zero leaves
(norm gains, biases, ``sb``, ``ssm_D``, ``dt_bias``) are replaced by seeded
random values before both packages get the tree (``bridge.to_module``).

  * both configs field by field, the builds' capabilities, the refusals;
  * bridge round trips of the nested stacks;
  * xlstm ``forward`` and ``loss_fn`` in full / peqa × f32 / bf16, the
    scale gradients against ``jax.grad`` under remat none and block,
    ``prefill`` caches leaf by leaf, ``decode_step``, the reference's own
    decode-vs-forward consistency, ``generate``;
  * the streamed build bit-equal (peqa, peqa_z; nibble and plane), LoRA and
    QAT against the reference.

Tolerances, as ``test_torch_whisper.py``: float32 logits and caches
atol/rtol 1e-4, the loss rtol 1e-5; bfloat16 the loss rtol 2⁻⁸ and the
logits within 2⁻⁵ of their largest magnitude; greedy tokens equal;
gradients rtol 1e-3 with atol 1e-4 of their largest magnitude.
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
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.models import zamba2 as jzamba2
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core import lora, policies
from repro_torch.core.peqa import layer_index, ref_path, stack_indexed
from repro_torch.models import linear, registry, xlstm, zamba2
from repro_torch.train.serve import Engine

from test_torch_configs import _shared_fields, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


ARCHS = ("xlstm-125m", "zamba2-7b")
MODULES = {"xlstm-125m": xlstm, "zamba2-7b": zamba2}
JMODULES = {"xlstm-125m": jxlstm, "zamba2-7b": jzamba2}


def tiny_pair(arch: str, mode: str = "peqa", **kw):
    """``make_tiny(get_config(arch))`` in both packages: (reference,
    port)."""
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode), **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TTuning(mode=mode), **kw)
    return j, t


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# leaves the reference initialises to zeros or ones, and the random
# value each gets here: (centre, spread)
_PERTURB = {"g": (1.0, 0.1), "b": (0.0, 0.1), "ssm_D": (1.0, 0.3),
            "dt_bias": (-2.0, 0.5)}


@functools.lru_cache(maxsize=None)
def fp_tree(arch: str):
    """The reference's float32 weights, its unit and zero leaves replaced
    by seeded random values (numpy)."""
    jcfg, _ = tiny_pair(arch)
    fp = to_numpy(jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        if key not in _PERTURB:
            return leaf
        centre, spread = _PERTURB[key]
        return (centre + rng.normal(size=leaf.shape) * spread
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(perturb, fp)


@functools.lru_cache(maxsize=None)
def policy_tree(arch: str, mode: str, layout: str = "nibble"):
    """``fp_tree(arch)`` through the reference's policy for ``mode``."""
    jcfg, _ = tiny_pair(arch, mode, quant=JQuant(layout=layout))
    return to_numpy(jpolicies.transform(
        jax.tree.map(jnp.asarray, fp_tree(arch)), jcfg))


def batch_of(cfg, b=2, s=16, seed=0):
    toks = tokens(b, s + 1, cfg.vocab_size, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max()


def assert_state_close(got, want):
    """A float32 recurrent state after several steps: rtol 1e-4 and atol
    1e-4 of the leaf's largest magnitude (the states sum over steps)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def stacked_grads(model, mask):
    """{reference path: gradient stacked over its stack's layers}."""
    by = {}
    for name, p in model.named_parameters():
        if mask[name]:
            by.setdefault(ref_path(name).strip("/"), {})[layer_index(name)] \
                = p.grad.detach().numpy()
    return {k: stack_indexed(v) for k, v in by.items()}


def grads_match(jcfg, tcfg, tree, batch):
    """Every trainable gradient of the port's loss against ``jax.grad`` of
    the reference's; returns the port's, stacked."""
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
    registry.build(tcfg, device="cpu").loss_fn(
        model, torch_batch(batch)).backward()
    got = stacked_grads(model, mask)
    for key in want:
        w = np.asarray(want[key], np.float32)
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    return got


def _ref_logits(arch, jcfg, jp, toks):
    fwd = JMODULES[arch].forward
    return np.asarray(jax.jit(lambda p, t: fwd(p, t, jcfg))(
        jp, jnp.asarray(toks)), np.float32)


def forward_matches(arch, mode, dtype, against_f32=False):
    """``forward`` and ``loss_fn`` of the port against the reference's.
    With ``against_f32`` the bf16 logits are held, instead, to the
    reference's float32 logits: their RMS distance at most twice the
    reference's own bf16 logits'."""
    jcfg, tcfg = tiny_pair(arch, mode, dtype=dtype)
    tree = policy_tree(arch, mode)
    batch = batch_of(tcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jmod = jregistry.build(jcfg)
    jlogits = _ref_logits(arch, jcfg, jp, batch["tokens"])
    jloss = jmod.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    tb = torch_batch(batch)
    with torch.no_grad():
        tl = api.forward(model, tb["tokens"])
        tloss = api.loss_fn(model, tb)
    assert tl.shape == (2, 16, tcfg.vocab_size) and tl.dtype == torch.float32
    if against_f32 and dtype == "bfloat16":
        f32 = _ref_logits(arch, jcfg.replace(dtype="float32"), jp,
                          batch["tokens"])
        rms = lambda t: float(np.sqrt(((t - f32) ** 2).mean()))
        assert rms(tl.numpy()) <= 2 * rms(jlogits)
    else:
        assert_close(tl, jlogits, dtype)
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)


def streamed_build_equal(arch, mode, layout, names):
    """``policies.build`` quantizes each block as it is drawn (the
    family's ``init`` transform, visiting ``names``); every tensor equals
    ``api.init`` + ``prepare``'s and the masks agree."""
    _, cfg = tiny_pair(arch, mode, quant=QuantConfig(layout=layout,
                                                     n_grid=4),
                       dtype="bfloat16")
    api = registry.build(cfg, device="cpu")
    mod = MODULES[arch]
    seen = []
    real = mod.init

    def spy(*a, transform=None, **kw):
        wrapped = None if transform is None else (
            lambda name, m: (seen.append(name), transform(name, m)))
        return real(*a, transform=wrapped, **kw)
    mod.init = spy
    try:
        streamed, smask = policies.build(api, 5)
    finally:
        mod.init = real
    assert seen == names
    whole, wmask = policies.prepare(api.init(5), cfg, device="cpu")
    assert smask == wmask
    ta = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tb = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name
    return streamed, smask


def lora_qat_match(arch, mode, n_targets):
    """LoRA adapts every wq and wv (``lora_b`` seeded non-zero, so a
    transposed product shows); QAT fake-quantizes every eligible linear.
    The port's transform puts the adapters where the reference's does;
    every trainable gradient against ``jax.grad``."""
    jcfg, tcfg = tiny_pair(arch, mode)
    tree = policy_tree(arch, mode)
    if mode == "lora":
        rng = np.random.default_rng(3)
        tree = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.normal(size=v.shape) * 0.02).astype(np.float32)
            if str(getattr(p[-1], "key", p[-1])) == "lora_b" else v, tree)
        model = policies.transform(
            registry.build(tcfg, device="cpu").init(0), tcfg, device="cpu")
        targets = [n for n, _ in lora.targets(model, tcfg.tuning)]
        assert len(targets) == n_targets
        assert {ref_path(f"{n}.lora_a").strip("/") for n in targets} == \
            {k for k in flat(tree) if k.endswith("lora_a")}
    got = grads_match(jcfg, tcfg, tree, batch_of(tcfg, seed=6))
    if mode == "lora":
        assert all("lora" in k for k in got)
    return got


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_config_and_build(arch):
    """The config field by field (full and tiny), its capabilities and
    reasons against the reference's, and the whole model's storage."""
    for ref, port in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                      tiny_pair(arch)):
        r, p = _shared_fields(ref, port)
        assert p == r
        assert port.sub_quadratic == ref.sub_quadratic is True
        assert port.d_head == ref.d_head
    full = registry.build(tconfigs.get_config(arch), device="cpu")
    jfull = jregistry.build(jconfigs.get_config(arch))
    caps, jcaps = full.caps, jfull.caps
    assert (caps.positional, caps.bucketable, caps.prefix_key,
            caps.slotted_reason, caps.verify_reason) == (
        jcaps.positional, jcaps.bucketable, jcaps.prefix_key,
        jcaps.slotted_reason, jcaps.verify_reason)
    assert caps.positional == (arch == "zamba2-7b") and not caps.bucketable
    assert full.decode_step_slotted is None and full.prefill_slotted is None
    assert full.decode_verify is None and full.decode_verify_slotted is None
    model = registry.module_class(full.cfg)(full.cfg, device="meta")
    lins = [m for n, m in model.named_modules()
            if isinstance(m, linear.Linear) and n != "lm_head"]
    total = sum(p.numel() for p in model.parameters())
    jshapes = jax.eval_shape(lambda: jfull.init(jax.random.PRNGKey(0)))
    assert total == sum(int(np.prod(x.shape))
                        for x in jax.tree.leaves(jshapes))
    if arch == "xlstm-125m":
        assert len(lins) == 3 * 2 + 9 * 7 == 69
        assert 0.13e9 < total < 0.15e9
    else:
        assert len(lins) == 81 * 6 + 7 == 493
        assert 6.7e9 < total < 6.9e9


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_refusals(arch):
    """What the port does not run on these families, each with its reason;
    every other tuning arm builds."""
    _, tiny = tiny_pair(arch)
    fam = tiny.family
    refused = [(dict(tuning=TTuning(mode="lora_optq")),
                f"lora_optq on {fam}: the reference's GPTQ reads "
                f"params\\['layers'\\]"),
               (dict(kv_cache_dtype="int8"), f"kv_cache_dtype='int8' on {fam}"),
               (dict(slstm_every=2, attn_every=3) if fam == "hybrid"
                else dict(attn_every=3), "_every=")]
    if fam == "ssm":
        refused += [(dict(swa_window=4), "swa_window=4 on ssm"),
                    (dict(attn_impl="chunked"), "attn_impl='chunked' on ssm"),
                    (dict(qkv_bias=True), "qkv_bias on ssm")]
    else:
        refused += [(dict(ssm=None), "without an SSMConfig"),
                    (dict(norm_type="layernorm"), "gnorm")]
    for kw, why in refused:
        with pytest.raises(NotImplementedError, match=why):
            registry.build(tiny.replace(**kw), device="cpu")
    for mode in ("full", "peqa", "peqa_z", "lora", "qat"):
        registry.build(tiny.replace(tuning=TTuning(mode=mode)), device="cpu")
    dense = tconfigs.make_tiny(tconfigs.get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="an SSMConfig on dense"):
        registry.build(dense.replace(ssm=tiny.ssm), device="cpu")


def test_xlstm_layout_must_divide():
    """The reference asserts that ``slstm_every`` divides ``n_layers``; the
    port raises it at build and in ``_layout``."""
    _, tiny = tiny_pair("xlstm-125m")
    bad = tiny.replace(n_layers=5)
    with pytest.raises(AssertionError, match="must divide by slstm_every"):
        jxlstm._layout(bad)
    for call in (lambda: registry.build(bad, device="cpu"),
                 lambda: xlstm._layout(bad)):
        with pytest.raises(ValueError, match="must divide by slstm_every"):
            call()


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in ("full", "peqa")])
def test_reference_tree_round_trips_through_the_bridge(arch, mode):
    """The nested stacks (xlstm's ``mlstm`` (n_groups, n_m, …), zamba2's
    ``mamba_groups`` (n_groups, every, …)), the single stacks and the
    unstacked ``shared`` block: every leaf back bit-equal."""
    tree = policy_tree(arch, mode)
    model = bridge.to_module(tree, tiny_pair(arch, mode)[1], device="cpu")
    back, want = flat(bridge.to_tree(model)), flat(tree)
    assert back.keys() == want.keys()
    nested = "mlstm/wq" if arch == "xlstm-125m" else "mamba_groups/zproj"
    key = f"{nested}/{'qw' if mode == 'peqa' else 'w'}"
    assert want[key].shape[:2] == ((2, 1) if arch == "xlstm-125m"
                                   else (2, 3))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_peqa_z_gradients_match_reference(arch):
    """float32 peqa_z: the scale and the zero-point gradients of every
    quantized linear against ``jax.grad``."""
    jcfg, tcfg = tiny_pair(arch, "peqa_z")
    got = grads_match(jcfg, tcfg, policy_tree(arch, "peqa_z"),
                      batch_of(tcfg, seed=8))
    assert {k.rsplit("/", 1)[1] for k in got} == {"scale", "zero"}


# ------------------------------------------------------ xlstm: the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
def test_xlstm_forward_and_loss_match_reference(mode, dtype):
    forward_matches("xlstm-125m", mode, dtype)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_xlstm_scale_gradients_match_reference(remat):
    """float32 PEQA: every scale gradient — the sLSTMs' sw and down, the
    mLSTMs' seven linears, through the sLSTM's time loop and the chunked
    scan over 2 chunks — against ``jax.grad``; ``sr``, ``sb``, norms,
    table, codes and zeros frozen."""
    jcfg, tcfg = tiny_pair("xlstm-125m", "peqa", remat=remat)
    got = grads_match(jcfg, tcfg, policy_tree("xlstm-125m", "peqa"),
                      batch_of(tcfg, seed=5))
    assert all(k.endswith("/scale") for k in got) and len(got) == 2 + 7
    assert got["mlstm/gi/scale"].shape == (2, 1, 4, 1)


def test_xlstm_prefill_matches_reference():
    """Prefill of 16 tokens (two 8-token chunks): the last logits and every
    state leaf — the sLSTMs' (c, n, m, h) and the mLSTMs' (B, H, hd + 1,
    hd) — against the reference's."""
    jcfg, tcfg = tiny_pair("xlstm-125m")
    tree = policy_tree("xlstm-125m", "peqa")
    toks = tokens(2, 16, tcfg.vocab_size, seed=1)
    jl, jcache = jregistry.build(jcfg).prefill(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    with torch.inference_mode():
        tl, tcache = api.prefill(model, {"tokens": torch.from_numpy(toks)
                                         .long()})
    assert_close(tl, jl, "float32")
    assert sorted(tcache) == sorted(jcache)
    assert tcache["m_S"].shape == (2, 1, 2, 4, 33, 32)
    for key in tcache:
        assert_close(tcache[key], jcache[key], "float32")


def test_xlstm_decode_step_matches_reference():
    """Three decode steps after a prefill of 8 tokens, against the
    reference's ``decode_step`` on the same state (the position is
    ignored: the port's steps take a different one); logits and every
    state leaf."""
    jcfg, tcfg = tiny_pair("xlstm-125m")
    tree = policy_tree("xlstm-125m", "peqa")
    jp = jax.tree.map(jnp.asarray, tree)
    toks = tokens(2, 8, tcfg.vocab_size, seed=3)
    _, jcache = jregistry.build(jcfg).prefill(jp,
                                              {"tokens": jnp.asarray(toks)})
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    step_tok = tokens(2, 3, tcfg.vocab_size, seed=5)
    jstep = jax.jit(lambda p, c, t: jxlstm.decode_step(p, c, t, 0, jcfg))
    for i in range(3):
        jl, jcache = jstep(jp, jcache, jnp.asarray(step_tok[:, i:i + 1]))
        with torch.inference_mode():
            tl, tcache = api.decode_step(
                model, tcache, torch.from_numpy(step_tok[:, i:i + 1]).long(),
                100 + i)
        assert_close(tl, jl, "float32")
    for key in tcache:
        assert_state_close(tcache[key], jcache[key])


def test_xlstm_decode_matches_forward():
    """The reference's ``test_xlstm_decode_matches_forward`` on the port:
    16 decode steps from the empty state give the training forward's
    logits at every position (rtol / atol 5e-4, as there)."""
    _, tcfg = tiny_pair("xlstm-125m", "full")
    api = registry.build(tcfg, device="cpu")
    model = api.init(0)
    toks = torch.from_numpy(tokens(2, 16, tcfg.vocab_size, seed=2)).long()
    with torch.no_grad():
        logits = api.forward(model, toks)
        cache = api.init_cache(2, 16)
        for t in range(16):
            lg, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
            np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                       rtol=5e-4, atol=5e-4)


def test_xlstm_generate_matches_reference():
    """``Engine.generate``: greedy tokens equal to the reference's; the
    state has no position, so any ``cache_len`` serves."""
    jcfg, tcfg = tiny_pair("xlstm-125m")
    tree = policy_tree("xlstm-125m", "peqa")
    prompt = tokens(2, 16, tcfg.vocab_size, seed=6)
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    eng = Engine(registry.build(tcfg, device="cpu"),
                 bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(), want)
    np.testing.assert_array_equal(
        eng.generate(prompt, 6, cache_len=1).numpy(), want)


# ----------------------------------------------------------------- the build

@pytest.mark.parametrize("mode,layout", [("peqa", "nibble"),
                                         ("peqa", "plane"),
                                         ("peqa_z", "nibble")])
def test_xlstm_streamed_build_is_bit_equal(mode, layout):
    streamed, smask = streamed_build_equal(
        "xlstm-125m", mode, layout,
        ["slstm.0", "slstm.1", "mlstm.0.0", "mlstm.1.0", "lm_head"])
    assert not smask["slstm.0.sr.r"] and not smask["slstm.1.sb.b"]
    assert smask["mlstm.1.0.gf.scale"]
    assert smask["mlstm.0.0.wq.zero"] == (mode == "peqa_z")
    assert not streamed.lm_head.quantized
    assert sum(isinstance(m, linear.Linear) and m.quantized
               for m in streamed.modules()) == 2 * 2 + 2 * 7


@pytest.mark.parametrize("mode", ["lora", "qat"])
def test_xlstm_lora_and_qat_match_reference(mode):
    got = lora_qat_match("xlstm-125m", mode, n_targets=2 * 2)
    if mode == "qat":
        assert {"slstm/sr/r", "slstm/sb/b", "mlstm/gi/scale",
                "embed/emb"} <= set(got)
