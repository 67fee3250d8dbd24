"""PyTorch port vs JAX reference: PEQA training (the paper's step 2).

  * ``optim``: ``MaskedAdamW`` over 3 updates on the same gradients (weight
    decay and clipping on, a bf16 leaf among them), the three LR schedules,
    ``compress_tree``'s int8 codes and ``state_bytes``;
  * ``data``: ``corpus``, ``split``, ``unigram_entropy``,
    ``PackedLM.batch_at`` and ``eval_batches`` bitwise;
  * the train step on ``make_tiny(get_config("llama3.2-1b"))`` with 2 KV
    heads: 3 steps from bridged parameters under every arm (``full``,
    ``lora``, ``lora_optq``, ``qat``, ``peqa``, ``peqa_z``), dense and
    chunked attention, remat none and block, float32 and bfloat16, against
    ``repro.train.step.build_train_step`` (a LoRA arm's ``lora_b`` starts
    from seeded non-zero values, ``LORA_B_STD``, and once, in float32, from
    the reference's zero); the same cases at the paper's learning rate are
    ``tests/test_torch_train_papers_lr.py``, which shares this file's
    helpers and tolerances;
  * the quickstart flow (``repro_torch.train.quickstart``) at a few steps.

Tolerances.  Optimizer: elementwise float32 arithmetic in the reference's
order, the gradient norm a sum in another order: rtol 1e-6.  Train step,
float32: the loss and the gradients are float32 sums taken in other orders
(different GEMM blockings, RoPE and softmax libraries): loss rtol 1e-5,
grad_norm rtol 1e-4.  The trained values are held through their update
(after − before) in ℓ2: Adam's update lr·m̂/(√v̂ + ε) is a smooth function
of the gradient except where the gradient is near ε, where a relative error
of ~1e-5 in it can move the update by a large share of lr (a rarely seen
token's row of the table), so the two updates agree to 1e-3 of the
reference's norm, not elementwise.  bfloat16: every activation rounds to 8
significant bits (2⁻⁸ relative) at other points of the two graphs, so the
loss holds to rtol 2⁻⁸ and the gradient norm to 5e-2 (the gradients
themselves agree to ~1.2% in ℓ2 on this model); Adam turns each gradient
into about ±lr at the first steps, so a gradient within that noise of 0
flips its update, and a few such elements dominate an ℓ2 distance: the
updates are held in ℓ1, to 10% of the reference's.  A frozen token
table is kept in bf16 by the port (``models.common.table_dtype``): it
equals the reference's rounded to bf16; a trained one (``full``, ``qat``)
is a float32 master, as the reference's, and is held like every other
trained leaf.  Every frozen tensor — a LoRA arm's float32 backbone too —
is bit-equal to where it started.  The integer codes are bit-equal after training, and the optimizer
state has the reference's bytes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import TrainConfig as JTrain
from repro.core import policies as jpolicies
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import registry as jregistry
from repro.optim import compression as jcompression
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.optim.schedules import make_schedule as jmake_schedule
from repro.train import step as jstep
from repro_torch import bridge
from repro_torch.configs.base import OptimConfig, TrainConfig
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.dist import context
from repro_torch.models import registry
from repro_torch.optim import compression
from repro_torch.optim.adamw import make_optimizer
from repro_torch.optim.schedules import make_schedule
from repro_torch.train import quickstart, step
from repro_torch.train.state import make_state

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401

# ---------------------------------------------------------------- optimizer


OPT_PARAMS = {"a": {"w": (8, 8)}, "b": {"scale": (8, 2)}, "c": {"g": (8,)}}


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in v.items()} for k, v in OPT_PARAMS.items()}
    grads = [{k: {n: rng.normal(size=s).astype(np.float32) * 3
                  for n, s in v.items()} for k, v in OPT_PARAMS.items()}
             for _ in range(3)]
    mask = {"a": {"w": False}, "b": {"scale": True}, "c": {"g": True}}
    return params, grads, mask


def _flat(tree):
    return {f"{k}.{n}": v for k, sub in tree.items() for n, v in sub.items()}


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_masked_adamw_matches_reference(schedule):
    params, grads, mask = _opt_case()
    ocfg = dict(lr=0.05, weight_decay=0.1, warmup_steps=2, grad_clip=1.0,
                schedule=schedule)
    jopt = jmake_optimizer(JOptim(**ocfg), 6)
    topt = make_optimizer(OptimConfig(**ocfg), 6)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp, mask)
    tp = {n: torch.from_numpy(v.copy()) for n, v in _flat(params).items()}
    tp["c.g"] = tp["c.g"].to(torch.bfloat16)     # cast back after the update
    jp["c"]["g"] = jp["c"]["g"].astype(jnp.bfloat16)
    tmask = _flat(mask)
    tst = topt.init(tp, tmask)
    assert topt.state_bytes(tst) == jopt.state_bytes(jst) == 2 * 4 * (16 + 8)
    assert set(tst["mv"]) == {"b.scale", "c.g"}
    for g in grads:
        jp, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp, mask)
        tn = topt.update({n: torch.from_numpy(v) for n, v in _flat(g).items()},
                         tst, tp, tmask)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(tst["count"]) == int(jst["count"]) == 3
    for name, want in _flat(jax.tree.map(np.asarray, jp)).items():
        got = tp[name].to(torch.float32).numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tp["a.w"].numpy(), params["a"]["w"])
    for name, (m, v) in tst["mv"].items():
        k, n = name.split(".")
        np.testing.assert_allclose(m.numpy(), np.asarray(jst["mv"][k][n][0]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(v.numpy(), np.asarray(jst["mv"][k][n][1]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_schedules_match_reference(schedule):
    ocfg = dict(lr=3e-4, warmup_steps=4, schedule=schedule)
    jf, tf = jmake_schedule(JOptim(**ocfg), 20), make_schedule(
        OptimConfig(**ocfg), 20)
    for s in range(0, 24):
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="schedule"):
        make_schedule(OptimConfig(schedule="step"), 10)


def test_int8_compression_codes_match_reference():
    rng = np.random.default_rng(1)
    g = {"x.scale": (rng.normal(size=(16, 4)) * 1e-3).astype(np.float32),
         "x.w": rng.normal(size=(4, 4)).astype(np.float32)}
    for name, arr in g.items():
        jq, js = jcompression.compress(jnp.asarray(arr))
        tq, ts = compression.compress(torch.from_numpy(arr))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
    got = compression.compress_tree({n: torch.from_numpy(v)
                                     for n, v in g.items()},
                                    {"x.scale": True, "x.w": False})
    want = jcompression.compress_tree({"x": {"scale": g["x.scale"],
                                             "w": g["x.w"]}},
                                      {"x": {"scale": True, "w": False}})
    np.testing.assert_array_equal(got["x.scale"].numpy(),
                                  np.asarray(want["x"]["scale"]))
    np.testing.assert_array_equal(got["x.w"].numpy(), g["x.w"])


# --------------------------------------------------------------------- data

def test_data_pipeline_bitwise_reference():
    toks = synthetic.corpus(300, 5000, seed=3)
    want = jsynthetic.corpus(300, 5000, seed=3)
    np.testing.assert_array_equal(toks, want)
    assert toks.dtype == np.int32
    assert synthetic.unigram_entropy(toks, 300) == \
        jsynthetic.unigram_entropy(want, 300)
    for a, b in zip(synthetic.split(toks), jsynthetic.split(want)):
        np.testing.assert_array_equal(a, b)
    mine = pipeline.PackedLM(toks, 4, 32, seed=2)
    ref = jpipeline.PackedLM(want, 4, 32, seed=2)
    for s in (0, 1, 38, 39, 117):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(mine.batch_at(s)[key],
                                          ref.batch_at(s)[key])
    for a, b in zip(pipeline.eval_batches(toks, 4, 32),
                    jpipeline.eval_batches(want, 4, 32)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# --------------------------------------------------------------- train step

STEPS, B, S = 3, 2, 16
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)
# the paper's learning rate (OptimConfig's default): its first Adam updates
# (≈ ±lr) are under half a bf16 ulp of the table's entries, so a trained
# table stored in bf16 would not move (at 1e-3 the rounding hides inside
# the 10% ℓ1 tolerance)
PAPER_LR = 2e-5


def _configs(mode, dtype, attn, remat):
    jcfg, tcfg = tiny_llama_pair(mode)
    kw = dict(dtype=dtype, attn_impl=attn, remat=remat)
    return jcfg.replace(**kw), tcfg.replace(**kw)


# the LoRA arms' lora_b at the start of a compared run: seeded N(0, σ²)
# entries (None: the reference's zero init).  From zero, Adam's first step
# moves every lora_b entry by ±lr, an entry whose gradient lies within
# bf16's noise of 0 takes the opposite sign in one package, and lora_a's
# gradient — linear in lora_b — carries that into its update: in bf16 the
# lora_a updates then differ by 16% in ℓ1 although the gradients agree to
# ~1% in ℓ2 as in every other arm (``test_torch_policies.py``)
LORA_B_STD = 0.02


def seeded_adapter(params, std, seed=11):
    """``params`` with every ``lora_b`` leaf replaced by N(0, std²) values
    from ``seed`` (numpy), the rest unchanged."""
    rng = np.random.default_rng(seed)

    def leaf(kp, val):
        if str(getattr(kp[-1], "key", "")) != "lora_b":
            return val
        return jnp.asarray((rng.normal(size=val.shape) * std
                            ).astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _reference_fp():
    """The reference's float32 weights of the tiny config, drawn once: its
    ``init`` reads only the shapes, which every case shares (the mode,
    dtype, attention and remat fields change none of them)."""
    return jregistry.build(tiny_llama_pair()[0]).init(jax.random.PRNGKey(0))


def _reference_run(jcfg, batches, ocfg, lora_b_std=LORA_B_STD):
    fp = _reference_fp()
    api = jregistry.build(jcfg)
    params, mask = jpolicies.prepare(fp, jcfg)
    if lora_b_std is not None:
        params = seeded_adapter(params, lora_b_std)
    start = to_numpy(params)
    opt = jmake_optimizer(JOptim(**ocfg), 10)
    state = {"params": params, "opt": opt.init(params, mask),
             "step": jnp.int32(0)}
    ts = jstep.build_train_step(api, jcfg, JTrain(optim=JOptim(**ocfg)),
                                mask, opt)
    hist = []
    for batch in batches:
        state, m = ts(state, {k: jnp.asarray(v) for k, v in batch.items()})
        hist.append({k: float(v) for k, v in m.items()})
    return start, to_numpy(state["params"]), hist, opt.state_bytes(
        state["opt"])


def _port_run(tcfg, start, batches, ocfg):
    api = registry.build(tcfg, device="cpu")
    model = bridge.to_module(start, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**ocfg), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, tcfg, TrainConfig(
        optim=OptimConfig(**ocfg)), mask, opt)
    hist = []
    for batch in batches:
        state, m = ts(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    return bridge.to_tree(state["params"]), hist, opt.state_bytes(
        state["opt"]), state


TRAIN_CASES = [  # (mode, dtype, attn_impl, remat)
    ("peqa", "float32", "dense", "none"),
    ("peqa", "float32", "chunked", "block"),
    ("peqa_z", "float32", "dense", "block"),
    ("full", "float32", "dense", "block"),
    ("full", "float32", "chunked", "none"),
    ("peqa", "bfloat16", "dense", "block"),
    ("peqa", "bfloat16", "chunked", "none"),
    ("peqa_z", "bfloat16", "chunked", "block"),
    ("full", "bfloat16", "dense", "none"),
    ("lora", "float32", "dense", "none"),
    ("lora", "bfloat16", "chunked", "block"),
    ("lora_optq", "float32", "chunked", "block"),
    ("lora_optq", "bfloat16", "dense", "none"),
    ("qat", "float32", "dense", "block"),
    ("qat", "bfloat16", "dense", "none"),
]


@pytest.mark.parametrize("mode,dtype,attn,remat", TRAIN_CASES)
def test_train_step_matches_reference(mode, dtype, attn, remat):
    _check_train_steps(mode, dtype, attn, remat, OCFG)


def test_lora_train_step_from_the_zero_init():
    """The LoRA arm from the reference's own adapter (lora_b = 0, so step 1
    moves only lora_b), float32."""
    _check_train_steps("lora", "float32", "dense", "block", OCFG,
                       lora_b_std=None)


def _check_train_steps(mode, dtype, attn, remat, ocfg,
                       lora_b_std=LORA_B_STD):
    jcfg, tcfg = _configs(mode, dtype, attn, remat)
    data = pipeline.PackedLM(synthetic.corpus(tcfg.vocab_size, 2000, seed=4),
                             B, S)
    batches = [data.batch_at(i) for i in range(STEPS)]
    start, want, jhist, jbytes = _reference_run(jcfg, batches, ocfg,
                                                lora_b_std)
    got, thist, tbytes, state = _port_run(tcfg, start, batches, ocfg)
    assert tbytes == jbytes
    bf16 = dtype == "bfloat16"
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"],
                                   rtol=2 ** -8 if bf16 else 1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=5e-2 if bf16 else 1e-4)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-7)
    assert state["step"] == STEPS and int(state["opt"]["count"]) == STEPS
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in kp): v
                      for kp, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    fs, fw, fg = flat(start), flat(want), flat(got)
    assert fw.keys() == fg.keys()
    trained = [k for k in fw if not np.array_equal(fs[k], fw[k])]
    expect = {"full": "", "qat": "", "peqa": "scale",
              "peqa_z": ("scale", "zero"), "lora": ("lora_a", "lora_b"),
              "lora_optq": ("lora_a", "lora_b")}[mode]
    assert trained and all(k.endswith(expect) for k in trained), trained
    for key in fw:
        a, b, s0 = (np.asarray(t[key]) for t in (fw, fg, fs))
        if a.dtype == np.uint32 or key not in trained:
            if bf16 and key.endswith("emb"):   # frozen: kept in bf16
                a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(b, a, err_msg=key)   # codes frozen
            continue
        upd_ref = a.astype(np.float64) - s0
        upd = b.astype(np.float64) - s0
        if bf16:
            assert np.abs(upd - upd_ref).sum() <= \
                0.1 * np.abs(upd_ref).sum(), key
        else:
            assert np.linalg.norm(upd - upd_ref) <= \
                1e-3 * np.linalg.norm(upd_ref), key


def test_train_step_refuses_a_mesh_and_remat_dots():
    """On a mesh remat="dots" is refused, for the arms too (the lora arm's
    mesh step builds: ``tests/test_torch_dist_arms_train.py`` trains the
    arms there, ``tests/test_torch_dist_train.py`` the rest); off it
    remat="dots" builds (``test_torch_remat_dots.py`` holds it to the
    reference), and a remat the reference does not know is refused."""
    _, tcfg = tiny_llama_pair()
    api = registry.build(tcfg, device="cpu")
    mesh = context.coords(1, 2)
    with pytest.raises(NotImplementedError,
                       match="not trained on a .*remat='dots' on a mesh"):
        step.build_train_step(api, tcfg.replace(remat="dots"), TrainConfig(),
                              {}, None, mesh=mesh)
    _, lcfg = tiny_llama_pair("lora")
    step.build_train_step(registry.build(lcfg, device="cpu"), lcfg,
                          TrainConfig(), {}, None,
                          mesh=context.coords(1, 2, device="cpu"))
    with pytest.raises(NotImplementedError,
                       match="not trained on a .*remat='dots' on a mesh"):
        step.build_train_step(registry.build(lcfg, device="cpu"),
                              lcfg.replace(remat="dots"), TrainConfig(), {},
                              None, mesh=mesh)
    registry.build(tcfg.replace(remat="dots"), device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        registry.build(tcfg.replace(remat="offload"), device="cpu")


def test_eval_step_makes_no_graph_and_remat_keeps_the_loss():
    _, tcfg = tiny_llama_pair()
    fp, jq = reference_params(tiny_llama_pair()[0])
    batch = pipeline.PackedLM(synthetic.corpus(tcfg.vocab_size, 800, seed=5),
                              2, 16).batch_at(0)
    losses = {}
    for remat in ("none", "block", "full", "dots"):
        cfg = tcfg.replace(remat=remat)
        api = registry.build(cfg, device="cpu")
        model = bridge.to_module(to_numpy(jq), cfg, device="cpu")
        policies.make_mask(model, cfg)
        ev = step.build_eval_step(api, cfg)(model, batch)
        assert ev.grad_fn is None
        loss = api.loss_fn(model, step.to_device(batch, "cpu"))
        assert loss.grad_fn is not None
        losses[remat] = (float(ev), float(loss.detach()))
    assert len(set(losses.values())) == 1, losses


def test_policy_counts_match_reference():
    for mode in policies.MODES:
        jcfg, tcfg = tiny_llama_pair(mode)
        jp, jmask = jpolicies.prepare(_reference_fp(), jcfg)
        model = bridge.to_module(to_numpy(jp), tcfg, device="cpu")
        mask = policies.make_mask(model, tcfg)
        assert policies.trainable_count(model, mask) == \
            jpolicies.trainable_count(jp, jmask), mode
        assert policies.frozen_count(model, mask) == \
            jpolicies.frozen_count(jp, jmask), mode
        assert all(p.requires_grad == mask[n]
                   for n, p in model.named_parameters())


# --------------------------------------------------------------- quickstart

def test_quickstart_shows_the_peqa_claims():
    out = quickstart.run("cpu", fp_steps=30, peqa_steps=20,
                         n_tokens=20_000, log=lambda msg: None)
    assert out["codes_frozen"]
    assert out["trainable"] < 0.05 * out["total"]
    assert out["state_bytes"] == 8 * out["trainable"]
    assert out["state_bytes"] < out["full_state_bytes"] / 20
    assert out["tuned_ppl"] < out["quantized_ppl"]
    assert np.isfinite(out["fp_ppl"])
