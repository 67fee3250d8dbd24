"""PyTorch port vs JAX reference: the dense family's other configurations.

qwen2-7b (q/k/v biases, untied head), starcoder2-7b (LayerNorm, the GELU
MLP, biases) and granite-34b (MQA: one KV head), each as ``make_tiny`` of
the config in both packages (2 layers, d_model 64, 4 heads of 16, vocab
512).  The reference makes the weights; its biases and norm gains and
biases start at 0 and 1, so they are replaced by seeded random values
before both packages get the tree (``bridge.to_module``), or a bias would
be checked only at zero.  The reference runs on its CPU path (XLA; its
quantized linears through the plain dequantize-and-matmul that its Pallas
kernels compute).

Tolerances.  float32: logits and caches atol/rtol 1e-4, the loss rtol
1e-5 (float32 sums in other orders, other transcendental libraries), as
``test_torch_model.py``.  bfloat16: every activation rounds to 8
significant bits at other points of the two graphs, so the loss holds to
rtol 2⁻⁸ (as ``test_torch_train.py``) and the logits to 2⁻⁵ of their
largest magnitude.  Greedy tokens and serving reports: equal.  One PEQA
train step: the loss rtol 1e-5, the gradient norm rtol 1e-4, each trained
scale's update within 1e-3 of the reference's in ℓ2 (as
``test_torch_train.py``), and the biases, norms, table, head and codes
bit-equal to where they started.
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
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import OptimConfig, TrainConfig
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


ARCHS = ("qwen2-7b", "starcoder2-7b", "granite-34b")
OCFG = dict(lr=2e-5, warmup_steps=1, schedule="linear", weight_decay=0.01)


def tiny_pair(arch: str, mode: str = "peqa", **kw):
    """``make_tiny(get_config(arch))`` in both packages: (reference, port)."""
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode=mode), **kw)
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TTuning(mode=mode), **kw)
    return j, t


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _fp_tree(arch: str):
    """The reference's float32 weights for ``arch``, every bias, gain and
    norm bias replaced by seeded random values (numpy)."""
    jcfg, _ = tiny_pair(arch)
    fp = to_numpy(jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        if key == "b":
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if key == "g":
            return (1 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, fp)


@functools.lru_cache(maxsize=None)
def policy_tree(arch: str, mode: str):
    """``_fp_tree(arch)`` through the reference's policy for ``mode``."""
    jcfg, _ = tiny_pair(arch, mode)
    return to_numpy(jpolicies.transform(
        jax.tree.map(jnp.asarray, _fp_tree(arch)), jcfg))


def _batch(vocab, b=2, s=12, seed=0):
    toks = tokens(b, s + 1, vocab, seed=seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_dense_configs_match_reference(arch):
    for ref, port in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                      tiny_pair(arch)):
        r, p = _shared_fields(ref, port)
        assert p == r
        assert port.d_head == ref.d_head
    tiny = tiny_pair(arch)[1]
    assert tiny.n_kv_heads == (1 if arch == "granite-34b" else 4)
    assert registry.build(tiny, device="cpu").cfg is tiny


def test_new_options_build_and_bf16_reduce_is_refused():
    """The options build.  ``bf16_reduce`` is no longer refused: it builds,
    and off a mesh — where the dots already come out in the activation
    dtype — its logits are those without it."""
    _, t = tiny_pair("qwen2-7b")
    for kw in (dict(swa_window=8), dict(kv_cache_dtype="int8"),
               dict(swa_window=8, kv_cache_dtype="int8")):
        registry.build(t.replace(**kw), device="cpu")
    t = t.replace(dtype="bfloat16")
    plain = registry.build(t, device="cpu")
    red = registry.build(t.replace(bf16_reduce=True), device="cpu")
    model = plain.init(0)
    tokens = torch.arange(12).reshape(2, 6)
    with torch.no_grad():
        assert torch.equal(plain.forward(model, tokens),
                           red.forward(model, tokens))


# -------------------------------------------------------- forward and loss

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "peqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, mode, dtype):
    jcfg, tcfg = tiny_pair(arch, mode, dtype=dtype)
    tree = policy_tree(arch, mode)
    batch = _batch(tcfg.vocab_size)
    jp = jax.tree.map(jnp.asarray, tree)
    jl, _ = jax.jit(lambda p, t: jtransformer.forward(p, t, jcfg))(
        jp, jnp.asarray(batch["tokens"]))
    jloss = jregistry.build(jcfg).loss_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = bridge.to_module(tree, tcfg, device="cpu")
    assert (model.embed.emb.dtype == torch.float32) == (
        mode == "full" or dtype == "float32")
    tb = step.to_device(batch, "cpu")
    with torch.no_grad():
        tl = transformer.forward(model, tb["tokens"], tcfg)
        tloss = transformer.loss_fn(model, tb, tcfg)
    jl = np.asarray(jl)
    if dtype == "float32":
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        assert np.abs(tl.numpy() - jl).max() <= 2 ** -5 * np.abs(jl).max()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2 ** -8)


# ------------------------------------------------------------------ serving

def _engines(arch, **kw):
    jcfg, tcfg = tiny_pair(arch, **kw)
    tree = policy_tree(arch, "peqa")
    return (JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree)),
            Engine(registry.build(tcfg, device="cpu"),
                   bridge.to_module(tree, tcfg, device="cpu"), device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference(arch):
    """Prefill logits and cache, two decode steps' logits, then
    ``Engine.generate``'s greedy tokens equal to the reference's (B 2,
    prompt 24: the prefill's linears take the GEMM route, the decode's the
    GEMV)."""
    jeng, eng = _engines(arch)
    japi, api = jeng.api, eng.api
    toks = tokens(2, 10, api.cfg.vocab_size, seed=1)
    jl, jcache = japi.prefill(jeng.params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tcache = api.prefill(eng.model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-4,
                                   rtol=1e-4)
    jfull = jax.tree.map(lambda d, s: d.at[:, :, :10].set(s),
                         japi.init_cache(2, 16), jcache)
    tfull = api.init_cache(2, 16)
    for key in tfull:
        tfull[key][:, :, :10] = tcache[key]
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for pos in (10, 11):
        jl, jfull = japi.decode_step(jeng.params, jfull, jnp.asarray(nxt),
                                     jnp.int32(pos))
        with torch.inference_mode():
            tl, tfull = api.decode_step(eng.model, tfull,
                                        torch.from_numpy(nxt), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    prompt = tokens(2, 24, api.cfg.vocab_size, seed=3)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(eng.generate(prompt, 6).numpy(), want)


def test_serve_drain_and_resident_match_reference():
    """qwen2's tiny model serving 8 requests of 3 tasks through 3 slots
    under ``drain`` and ``resident``: tokens and scheduler counters equal
    to the reference's, and resident's tokens equal to drain's."""
    tree = policy_tree("qwen2-7b", "peqa")
    base = jsb.extract_scales(jax.tree.map(jnp.asarray, tree))
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
    reports = {}
    for sched in ("drain", "resident"):
        jeng, eng = _engines("qwen2-7b")
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
            assert getattr(trep, key) == getattr(jrep, key), (sched, key)
        assert trep.tokens == jrep.tokens, sched
        reports[sched] = trep
    assert reports["resident"].tokens == reports["drain"].tokens
    assert reports["resident"].switches == 0


# ----------------------------------------------------------------- training

@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-7b"])
def test_peqa_train_step_matches_reference(arch):
    jcfg, tcfg = tiny_pair(arch, "peqa")
    start = policy_tree(arch, "peqa")
    batch = _batch(tcfg.vocab_size, seed=4)
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
    assert any(k.endswith("/b") for k in fs)
    for key in fs:
        if not key.endswith("/scale"):
            np.testing.assert_array_equal(fg[key], fs[key], err_msg=key)
            continue
        upd_ref = fw[key].astype(np.float64) - fs[key]
        upd = fg[key].astype(np.float64) - fs[key]
        assert np.linalg.norm(upd - upd_ref) <= \
            1e-3 * np.linalg.norm(upd_ref), key


def test_policy_counts_match_reference():
    for mode in ("full", "peqa"):
        jcfg, tcfg = tiny_pair("starcoder2-7b", mode)
        tree = policy_tree("starcoder2-7b", mode)
        jmask = jpolicies.make_mask(tree, jcfg)
        model = bridge.to_module(tree, tcfg, device="cpu")
        mask = policies.make_mask(model, tcfg)
        assert policies.trainable_count(model, mask) == \
            jpolicies.trainable_count(tree, jmask), mode
        assert policies.frozen_count(model, mask) == \
            jpolicies.frozen_count(tree, jmask), mode
        assert mask["layers.0.attn.wq.b"] == (mode == "full")
        assert mask["layers.0.ln1.b"] == (mode == "full")
        assert mask["lm_head.w"] == (mode == "full")
        assert "lm_head.qw" not in dict(model.named_buffers())


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("mode", ["full", "peqa"])
def test_checkpoint_round_trip_with_new_leaves(tmp_path, mode):
    """A reference checkpoint of starcoder2's tiny model (biases, LayerNorm
    gains and biases, the untied head; a float32 table under ``full``)
    restored into the port, and the port's written back and restored into
    the reference: every array equal."""
    dtype = "bfloat16" if mode == "full" else "float32"
    jcfg, tcfg = tiny_pair("starcoder2-7b", mode, dtype=dtype)
    tree = policy_tree("starcoder2-7b", mode)
    jp = jax.tree.map(jnp.asarray, tree)
    jmask = jpolicies.make_mask(tree, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(3)}
    JManager(str(tmp_path / "ref")).save(3, jstate)
    model = bridge.to_module(tree, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    restored, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        bridge.state_to_tree(state))
    bridge.load_state(state, restored)
    got = _flat(bridge.state_to_tree(state)["params"])
    for key, want in _flat(tree).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert {"layers/attn/wq/b", "layers/ln1/b", "final_norm/b",
            "lm_head/w"} <= got.keys()
    CheckpointManager(str(tmp_path / "port")).save(
        3, bridge.state_to_tree(state))
    back, extra = JManager(str(tmp_path / "port")).restore(jstate)
    assert extra["step"] == 3
    for key, want in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back["params"])[key], want,
                                      err_msg=key)
