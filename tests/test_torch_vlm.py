"""PyTorch port vs JAX reference: the vlm family (llava-next-mistral-7b).

The backbone is the dense decoder; a request carries a prefix of P
precomputed patch embeddings (the vision tower is a stub in both packages)
that takes the decoder's first P positions.  Configuration: ``make_tiny``
of the config in both packages (2 layers, d_model 64, 4 heads of 16, 4 KV
heads, vocab 512, P = 8).  The reference makes the weights, its unit norm
gains replaced by seeded random values before both packages get the tree
(``bridge.to_module``); the prefixes are seeded N(0, 1) float32, as the
reference's serving workload makes them.

  * ``forward`` and ``loss_fn`` with ``image_embeds`` (the loss on the text
    rows only), under ``full`` and ``peqa``, float32 and bfloat16;
  * ``prefill`` with a prefix, unpadded and right-padded to a bucket
    (``last_pos`` counts the prefix rows): last logits and the cache;
  * ``Engine.generate(prefix=)``; drain and resident ``Engine.serve`` of
    prefixed requests over two tasks; speculative serving on a 4-plane
    backbone: tokens equal to the reference's, and serving's to each
    request's own ``generate``;
  * one PEQA train step on a batch with ``image_embeds``;
  * the reference's own vlm tests restated on the port (the prefix takes
    cache capacity; the loss aligns to the text), and a prefix refused on
    a dense model with the reference's message.

Tolerances, as ``test_torch_dense_archs.py``: float32 logits and caches
atol/rtol 1e-4, the loss rtol 1e-5; bfloat16 the loss rtol 2⁻⁸ and the
logits within 2⁻⁵ of their largest magnitude.  Greedy tokens: equal.  The
train step: the loss rtol 1e-5, the gradient norm rtol 1e-4, each scale's
update within 1e-3 of the reference's in ℓ2, everything else bit-equal to
where it started.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.serve import ServeConfig as JServeConfig
from repro.train import step as jstep
from repro.train.serve import Engine as JEngine
from repro.train.serve import Request as JRequest
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import (MoEConfig, OptimConfig, QuantConfig,
                                      TrainConfig)
from repro_torch.configs.base import TuningConfig as TTuning
from repro_torch.core import policies
from repro_torch.core import scale_bank as sb
from repro_torch.models import registry, transformer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve import Request, ServeConfig
from repro_torch.train import step
from repro_torch.train.serve import Engine
from repro_torch.train.state import make_state

from test_torch_configs import _shared_fields, to_numpy, tokens
from _torch_threads import _one_torch_thread  # noqa: F401


ARCH = "llava-next-mistral-7b"
OCFG = dict(lr=2e-5, warmup_steps=1, schedule="linear", weight_decay=0.01)
TASKS = ("t0", "t1")


def tiny_pair(mode: str = "peqa", **kw):
    """``make_tiny(get_config(ARCH))`` in both packages: (reference,
    port)."""
    j = jconfigs.make_tiny(jconfigs.get_config(ARCH)).replace(
        tuning=JTuning(mode=mode), **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(ARCH)).replace(
        tuning=TTuning(mode=mode), **kw)
    return j, t


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _fp_tree():
    """The reference's float32 weights, every norm gain replaced by seeded
    random values (numpy)."""
    jcfg, _ = tiny_pair()
    fp = to_numpy(jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "g":
            return (1 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, fp)


@functools.lru_cache(maxsize=None)
def policy_tree(mode: str, layout: str = "nibble"):
    """``_fp_tree()`` through the reference's policy for ``mode``."""
    jcfg, _ = tiny_pair(mode, quant=JQuant(layout=layout))
    return to_numpy(jpolicies.transform(
        jax.tree.map(jnp.asarray, _fp_tree()), jcfg))


def prefixes(n: int, p: int, d: int, seed: int = 0) -> np.ndarray:
    """(n, p, d) seeded N(0, 1) float32 patch embeddings."""
    return np.random.default_rng(seed).normal(size=(n, p, d)
                                              ).astype(np.float32)


def _batch(cfg, b=2, s=12, seed=0):
    toks = tokens(b, s + 1, cfg.vocab_size, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "image_embeds": prefixes(b, cfg.n_img_tokens, cfg.d_model,
                                     seed=seed + 1)}


# ------------------------------------------------------------------ configs

def test_vlm_config_and_build():
    for ref, port in ((jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)),
                      tiny_pair()):
        r, p = _shared_fields(ref, port)
        assert p == r
    tiny = tiny_pair()[1]
    assert (tiny.n_layers, tiny.n_img_tokens) == (2, 8)
    full = registry.build(tconfigs.get_config(ARCH), device="cpu")
    assert full.cfg.family == "vlm" and full.caps.prefix_key == "image_embeds"
    assert full.caps.prefix_positions and not full.caps.prefix_required
    assert full.caps.bucketable and full.decode_verify_slotted is not None
    dense = registry.build(tconfigs.make_tiny(tconfigs.get_config(
        "llama3.2-1b")), device="cpu")
    assert dense.caps.prefix_key is None and not dense.caps.prefix_positions
    for kw, why in ((dict(kv_cache_dtype="fp8"), "kv_cache_dtype='fp8'"),
                    (dict(family="encdec"), "family 'encdec'"),
                    (dict(family="ssm"), "family 'ssm'"),
                    (dict(family="hybrid"), "family 'hybrid'"),
                    (dict(moe=MoEConfig(n_experts=4, top_k=2),
                          tuning=TTuning(mode="lora_optq")),
                     "lora_optq on MoE"),
                    (dict(act="relu"), "act='relu'"),
                    (dict(use_rope=False), "learned positions"),
                    (dict(remat="offload"), "remat='offload'")):
        with pytest.raises(NotImplementedError, match=why):
            registry.build(tiny.replace(**kw), device="cpu")
    # bit-plane MoE experts and remat="dots" build, as in the reference
    registry.build(tiny.replace(moe=MoEConfig(n_experts=4, top_k=2),
                                quant=QuantConfig(layout="plane")),
                   device="cpu")
    registry.build(tiny.replace(remat="dots"), device="cpu")


def test_reference_tree_round_trips_through_the_bridge():
    """A vlm's tree is the dense tree: no new leaf."""
    for mode in ("full", "peqa"):
        tree = policy_tree(mode)
        model = bridge.to_module(tree, tiny_pair(mode)[1], device="cpu")
        back = _flat(bridge.to_tree(model))
        want = _flat(tree)
        assert back.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(back[key], want[key], err_msg=key)


# -------------------------------------------------------- forward and loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
def test_forward_and_loss_with_a_prefix_match_reference(mode, dtype):
    jcfg, tcfg = tiny_pair(mode, dtype=dtype)
    tree = policy_tree(mode)
    batch = _batch(tcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, _ = jax.jit(lambda p, t, e: jtransformer.forward(
        p, t, jcfg, prefix_embeds=e))(jp, jnp.asarray(batch["tokens"]),
                                      jnp.asarray(batch["image_embeds"]))
    jloss = jregistry.build(jcfg).loss_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = bridge.to_module(tree, tcfg, device="cpu")
    tb = step.to_device(batch, "cpu")
    assert tb["image_embeds"].dtype == torch.float32
    with torch.no_grad():
        tl = transformer.forward(model, tb["tokens"], tcfg,
                                 prefix_embeds=tb["image_embeds"])
        tloss = transformer.loss_fn(model, tb, tcfg)
    jl = np.asarray(jl)
    assert tl.shape == (2, tcfg.n_img_tokens + 12, tcfg.vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        assert np.abs(tl.numpy() - jl).max() <= 2 ** -5 * np.abs(jl).max()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2 ** -8)


def test_vlm_prefix_loss_alignment():
    """The reference's ``test_vlm_prefix_loss_alignment`` on the port: a
    batch of 16 − P text tokens behind P prefix rows gives a finite loss,
    and it is the cross entropy of the text rows' logits alone."""
    _, tcfg = tiny_pair("full")
    model, _ = policies.build(registry.build(tcfg, device="cpu"), 0)
    p = tcfg.n_img_tokens
    batch = step.to_device(_batch(tcfg, s=16 - p, seed=3), "cpu")
    assert batch["tokens"].shape[1] == 16 - p
    with torch.no_grad():
        loss = transformer.loss_fn(model, batch, tcfg)
        logits = transformer.forward(model, batch["tokens"], tcfg,
                                     prefix_embeds=batch["image_embeds"])
    assert np.isfinite(float(loss))
    want = torch.nn.functional.cross_entropy(
        logits[:, p:].reshape(-1, tcfg.vocab_size),
        batch["labels"].reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


# ------------------------------------------------------------------ prefill

@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_with_a_prefix_matches_reference(bucketed):
    """Prefill of a prefixed prompt: its last logits and its cache, whose
    first P rows are the prefix's; right-padded to 16 rows with
    ``last_pos`` = P + S − 1."""
    jcfg, tcfg = tiny_pair("peqa")
    tree = policy_tree("peqa")
    s = 10
    toks = tokens(2, s, tcfg.vocab_size, seed=1)
    emb = prefixes(2, tcfg.n_img_tokens, tcfg.d_model, seed=2)
    if bucketed:
        toks = np.pad(toks, ((0, 0), (0, 16 - s)))
    jb = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(emb)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "image_embeds": torch.from_numpy(emb)}
    if bucketed:
        jb["last_pos"] = jnp.int32(tcfg.n_img_tokens + s - 1)
        tb["last_pos"] = tcfg.n_img_tokens + s - 1
    jl, jcache = jregistry.build(jcfg).prefill(
        jax.tree.map(jnp.asarray, tree), jb)
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(tree, tcfg, device="cpu")
    with torch.inference_mode():
        tl, tcache = api.prefill(model, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        assert tcache[key].shape[2] == tcfg.n_img_tokens + toks.shape[1]
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------------------------------ serving

def _engines(mode="peqa", layout="nibble", bank=False):
    quant = dict(layout=layout, n_grid=20)
    jcfg, tcfg = tiny_pair(mode, quant=JQuant(**quant))
    tcfg = tcfg.replace(quant=QuantConfig(**quant))
    tree = policy_tree(mode, layout)
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    eng = Engine(registry.build(tcfg, device="cpu"),
                 bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    if bank:
        base = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
        rng = np.random.default_rng(5)
        sets = {TASKS[0]: base, TASKS[1]: {
            k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
            for k, v in base.items()}}
        jeng.bank, eng.bank = jsb.ScaleBank(), sb.ScaleBank()
        for t, s in sets.items():
            jeng.bank.tasks[t] = s
            eng.bank.tasks[t] = s
    return jeng, eng


def test_generate_with_a_prefix_matches_reference():
    jeng, eng = _engines()
    cfg = eng.api.cfg
    prompt = tokens(2, 12, cfg.vocab_size, seed=3)
    emb = prefixes(2, cfg.n_img_tokens, cfg.d_model, seed=4)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6,
                                    prefix=jnp.asarray(emb)))
    got = eng.generate(prompt, 6, prefix=emb)
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefix takes decoder positions: the cache must hold P + S + 5
    with pytest.raises(ValueError, match="cannot hold"):
        eng.generate(prompt, 6, cache_len=cfg.n_img_tokens + 12 + 4,
                     prefix=emb)
    eng.generate(prompt, 6, cache_len=cfg.n_img_tokens + 12 + 5, prefix=emb)


def _requests(cfg, cls, tasked=True):
    rs = np.random.default_rng(9)
    shapes = [(6, 5, 0), (9, 3, 0), (4, 7, 1), (12, 4, 2), (5, 6, 2),
              (7, 2, 4)]
    emb = prefixes(len(shapes), cfg.n_img_tokens, cfg.d_model, seed=6)
    return [cls(tokens=rs.integers(0, cfg.vocab_size, s).astype(np.int32),
                n_new=n, task=TASKS[i % 2] if tasked else None,
                arrival_step=a, prefix=emb[i] if i != 3 else None)
            for i, (s, n, a) in enumerate(shapes)]


def test_serve_with_prefixes_matches_reference_and_generate():
    """Six requests (five with a prefix, one without) over two tasks
    through three slots, under ``drain`` and ``resident``: tokens and
    scheduler counters equal to the reference's, resident's tokens equal
    to drain's, and each request's tokens equal to its own ``generate``
    under its task's scales."""
    reports = {}
    for sched in ("drain", "resident"):
        jeng, eng = _engines(bank=True)
        cfg = eng.api.cfg
        jrep = jeng.serve(_requests(cfg, JRequest),
                          JServeConfig(n_slots=3, scheduler=sched))
        trep = eng.serve(_requests(cfg, Request),
                         ServeConfig(n_slots=3, scheduler=sched))
        for key in ("scheduler", "steps", "decoded", "switches",
                    "idle_slot_steps", "task_drain_idle_slot_steps",
                    "prefill_compiles"):
            assert getattr(trep, key) == getattr(jrep, key), (sched, key)
        assert trep.tokens == jrep.tokens, sched
        reports[sched] = trep
    assert reports["resident"].tokens == reports["drain"].tokens
    _, eng = _engines(bank=True)
    for req, got in zip(_requests(eng.api.cfg, Request),
                        reports["drain"].tokens):
        eng.switch_task(req.task)
        pre = None if req.prefix is None else req.prefix[None]
        out = eng.generate(req.tokens[None], req.n_new, prefix=pre)
        assert out[0, req.n_prompt:].tolist() == got


def test_speculative_serving_with_prefixes_matches_reference():
    """The same traffic, untasked, on a 4-bit bit-plane backbone under
    ``speculative`` (spec_k 2, a 3-plane draft): tokens, rounds and draft
    counts equal to the reference's, and tokens equal to the port's own
    greedy (drain) run."""
    jeng, eng = _engines(layout="plane")
    cfg = eng.api.cfg
    spec = dict(n_slots=3, scheduler="speculative", spec_k=2)
    jrep = jeng.serve(_requests(cfg, JRequest, tasked=False),
                      JServeConfig(**spec))
    trep = eng.serve(_requests(cfg, Request, tasked=False),
                     ServeConfig(**spec))
    for key in ("steps", "decoded", "draft_steps"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.tokens == jrep.tokens
    greedy = eng.serve(_requests(cfg, Request, tasked=False),
                       ServeConfig(n_slots=3, scheduler="drain"))
    assert trep.tokens == greedy.tokens


def test_vlm_prefix_occupies_decoder_positions():
    """The reference's test on the port: image-embedding rows consume slot
    cache capacity, so a request whose prefix + prompt + budget overflows
    the pool is refused at admit — and one that fits is admitted at
    position P + S."""
    cfg = tiny_pair("peqa")[1].replace(quant=QuantConfig(n_grid=2))
    eng = Engine(registry.build(cfg, device="cpu"),
                 policies.build(registry.build(cfg, device="cpu"), 0)[0],
                 device="cpu")
    pool = eng.open_pool(2, 16)
    prefix = np.zeros((cfg.n_img_tokens, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="cache slots"):
        eng.admit(pool, Request(tokens=np.arange(6, dtype=np.int32),
                                n_new=4, prefix=prefix))
    slot = eng.admit(pool, Request(tokens=np.arange(6, dtype=np.int32),
                                   n_new=3, prefix=prefix))
    assert pool.pos[slot] == cfg.n_img_tokens + 6
    assert (8, cfg.n_img_tokens, True) in pool._prefill_keys


def test_prefix_refused_on_a_dense_model():
    """The reference's message, from ``generate``, ``admit`` and
    ``serve``."""
    cfg = tconfigs.make_tiny(tconfigs.get_config("llama3.2-1b")).replace(
        tuning=TTuning(mode="peqa"), quant=QuantConfig(n_grid=2))
    api = registry.build(cfg, device="cpu")
    eng = Engine(api, policies.build(api, 0)[0], device="cpu")
    prefix = np.zeros((4, cfg.d_model), np.float32)
    msg = "takes no per-request prefix"
    with pytest.raises(ValueError, match=msg):
        eng.generate(np.zeros((1, 4), np.int64), 2, prefix=prefix[None])
    with pytest.raises(ValueError, match=msg):
        eng.admit(eng.open_pool(2, 32), Request(
            tokens=np.arange(4, dtype=np.int32), n_new=2, prefix=prefix))
    with pytest.raises(ValueError, match=msg):
        eng.serve([Request(tokens=np.arange(4, dtype=np.int32), n_new=2,
                           prefix=prefix)], ServeConfig(n_slots=2))


# ----------------------------------------------------------------- training

def test_peqa_train_step_with_image_embeds_matches_reference():
    jcfg, tcfg = tiny_pair("peqa")
    start = policy_tree("peqa")
    batch = _batch(tcfg, seed=4)
    jp, jmask = jax.tree.map(jnp.asarray, start), jpolicies.make_mask(
        start, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jts = jstep.build_train_step(jregistry.build(jcfg), jcfg,
                                 JTrain(optim=JOptim(**OCFG)), jmask, jopt)
    jstate, jm = jts({"params": jp, "opt": jopt.init(jp, jmask),
                      "step": jnp.int32(0)},
                     {k: jnp.asarray(v) for k, v in batch.items()})
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(start, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, tcfg, TrainConfig(
        optim=OptimConfig(**OCFG)), mask, opt)
    state, tm = ts(state, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert opt.state_bytes(state["opt"]) == jopt.state_bytes(jstate["opt"])
    fs, fw, fg = _flat(start), _flat(jstate["params"]), _flat(
        bridge.to_tree(state["params"]))
    assert fw.keys() == fg.keys() == fs.keys()
    for key in fs:
        if not key.endswith("/scale"):
            np.testing.assert_array_equal(fg[key], fs[key], err_msg=key)
            continue
        upd_ref = fw[key].astype(np.float64) - fs[key]
        upd = fg[key].astype(np.float64) - fs[key]
        assert np.linalg.norm(upd - upd_ref) <= \
            1e-3 * np.linalg.norm(upd_ref), key
