"""The rank side of the port's mesh tests (``tests/test_torch_dist_*.py``).

Each function here runs in one spawned rank (``repro_torch.dist.backend
.spawn``, gloo on the CPU, one intra-op thread): it rebuilds the port's
model from the reference tree the test saved (``save_tree``), cuts its
shard, runs the mesh path and saves what the test compares into
``<tmp>/<name><rank>.pt``.  It imports torch and ``repro_torch`` only: the
JAX side runs in the test's own process.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import scale_bank as sb
from repro_torch.dist import sampling, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry
from repro_torch.serve import Request, ServeConfig
from repro_torch.train.serve import Engine, cache_dims


def save_tree(path: str, tree: dict) -> None:
    """A reference param tree (numpy leaves) as one flat npz."""
    np.savez(path, **{k.lstrip("/"): v
                      for k, v in bridge._flatten(tree).items()})


def load_model(path: str, cfg):
    """The port's model of ``cfg`` from a tree saved by ``save_tree``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return bridge.to_module(bridge._nest(flat), cfg, device="cpu")


def _ctx(shape):
    return mesh_mod.make_debug_mesh(*shape, device="cpu")


def _save(tmp, name, rank, out):
    torch.save(out, os.path.join(tmp, f"{name}{rank}.pt"))


def serve_rank(rank, shape, tmp, cfg, cfg_bf16, prompt, n_new):
    """Lockstep serving on the mesh: ``generate`` under tasks A and B, the
    prefill logits (float32, and bf16 under ``bf16_reduce``), a swap's and
    the decode steps' collective records, the slot pool's cache layout."""
    ctx = _ctx(shape)
    model = load_model(os.path.join(tmp, "dense.npz"), cfg)
    api = registry.build(cfg, device="cpu")
    bank = sb.ScaleBank(root=os.path.join(tmp, "bank"))
    local = sharding.shard_model(model, cfg, ctx)
    eng = Engine(api, local, bank=bank, ctx=ctx, logitshard=True)
    host = Engine(api, model, bank=bank, device="cpu")
    out = {"rows": (ctx.local_rows(prompt.shape[0]).start,
                    ctx.local_rows(prompt.shape[0]).stop)}
    for task in ("A", "B"):
        if task == "B":
            rec = sb.swap_collectives(local, bank.tasks["B"], ctx)
            out["swap_record"] = rec
            out["switch_s"] = eng.switch_task("B")
            host.switch_task("B")
        else:
            eng.switch_task("A")
            host.switch_task("A")
        out[f"tokens_{task}"] = eng.generate(prompt, n_new)
        out[f"host_tokens_{task}"] = host.generate(prompt, n_new)
        out[f"logits_{task}"] = eng.prefill_logits(prompt)
        out[f"host_logits_{task}"] = host.prefill_logits(prompt)
    out["local_nbytes"] = bank.local_nbytes("B", ctx)
    out["nbytes"] = bank.nbytes("B")
    base = Engine(api, local, bank=bank, ctx=ctx, logitshard=False)
    for name, e in (("ls", eng), ("base", base)):
        out[f"decode_{name}"] = e.decode_collectives(prompt.shape[0], 32)
        out[f"cont_{name}"] = e.continuous_decode_collectives(4, 24)
        out[f"tokens_{name}"] = e.generate(prompt, n_new)
    # the slot pool's cache: each leaf the rank's block of cache_specs'
    eng.switch_task("A")
    pool = eng.open_pool(4, 24)
    eng.admit(pool, Request(tokens=np.arange(6, dtype=np.int32), n_new=4,
                            task="A"))
    whole = api.init_cache(4, 24, device="meta")
    specs = sharding.cache_specs(
        ctx, whole, 4, ctx.batch_axes(4) is not None,
        n_kv_heads=cfg.n_kv_heads,
        batch_dims=cache_dims(api.init_cache, 2, 8)[0])
    out["pool_shapes"] = {k: tuple(v.shape) for k, v in pool.cache.items()}
    out["spec_shapes"] = {k: sharding.local_shape(whole[k].shape, specs[k],
                                                  ctx.axis_sizes)
                          for k in whole}
    # bf16 with bf16_reduce: the row-parallel sums in bf16
    mb = load_model(os.path.join(tmp, "dense.npz"), cfg_bf16)
    api_b = registry.build(cfg_bf16, device="cpu")
    eb = Engine(api_b, sharding.shard_model(mb, cfg_bf16, ctx), ctx=ctx,
                logitshard=True)
    out["bf16_logits"] = eb.prefill_logits(prompt)
    out["bf16_decode"] = eb.decode_collectives(prompt.shape[0], 32)
    _save(tmp, "serve", rank, out)


def _cont_requests(vocab):
    """The reference's ``_CONT_TEST`` traffic."""
    return [Request(tokens=(np.arange(6, dtype=np.int32) * (i + 1)) % vocab,
                    n_new=[4, 7, 3, 9][i % 4], task=["A", "B"][(i // 4) % 2],
                    arrival_step=i // 2) for i in range(8)]


def _spec_requests(vocab):
    """The reference's ``_SPEC_SHARD_TEST`` traffic."""
    return [Request(tokens=(np.arange(6, dtype=np.int32) * (i + 1)) % vocab,
                    n_new=(16, 24, 32)[i % 3]) for i in range(8)]


def _report(rep):
    return {"tokens": rep.tokens, "steps": rep.steps,
            "scheduler": rep.scheduler, "switches": rep.switches,
            "bubble_slot_steps": rep.bubble_slot_steps,
            "idle_slot_steps": rep.idle_slot_steps, "decoded": rep.decoded,
            "task_drain_idle_slot_steps": rep.task_drain_idle_slot_steps,
            "draft_steps": rep.draft_steps,
            "acceptance_rate": rep.acceptance_rate}


def _sampled(ctx, lg, key, active):
    """Every sampler's sharded form on this rank's block of ``lg`` (B, V),
    gathered back to the whole batch."""
    b, v = lg.shape
    rows = ctx.local_rows(b)
    c0, c1 = ctx.vocab_range(v)
    blk = lg[rows, c0:c1].contiguous()
    split = ctx.batch_axes(b) is not None

    def whole(t):
        return ctx.all_gather(t, "data", dim=0) if split else t
    vals, idx = sampling.shard_topk(ctx, b, 5)(blk)
    return {
        "argmax": whole(sampling.shard_argmax(ctx, b)(blk)),
        "argmax_masked": whole(sampling.shard_argmax_masked(ctx, b, fill=3)(
            blk, active[rows])),
        "topk_values": whole(vals), "topk_indices": whole(idx),
        "sample": whole(sampling.shard_sample(ctx, b, 0.8)(blk, key)),
        "top_p": whole(sampling.shard_top_p(ctx, b, 0.9, 0.8)(blk, key)),
        "top_p_half": whole(sampling.shard_top_p(ctx, b, 0.5, 0.8)(blk, key)),
    }


def cont_rank(rank, shape, tmp, cfg, cfg_plane, logits):
    """Continuous serving on the mesh (resident and drain on the dense
    tree, greedy and speculative on the plane tree) and every sampler's
    sharded form on ``logits`` ({name: (B, V) float32})."""
    ctx = _ctx(shape)
    api = registry.build(cfg, device="cpu")
    model = load_model(os.path.join(tmp, "dense.npz"), cfg)
    bank = sb.ScaleBank(root=os.path.join(tmp, "bank"))
    eng = Engine(api, sharding.shard_model(model, cfg, ctx), bank=bank,
                 ctx=ctx, logitshard=True)
    reqs = _cont_requests(cfg.vocab_size)
    eng.switch_task("A")
    out = {"resident": _report(eng.serve(reqs, ServeConfig(n_slots=4)))}
    out["install_record"] = eng.resident.install_collectives("B")
    out["drain"] = _report(eng.serve(reqs, ServeConfig(n_slots=4,
                                                       scheduler="drain")))
    api_p = registry.build(cfg_plane, device="cpu")
    plane = load_model(os.path.join(tmp, "plane.npz"), cfg_plane)
    local_p = sharding.shard_model(plane, cfg_plane, ctx)
    sreqs = _spec_requests(cfg_plane.vocab_size)
    out["greedy"] = _report(Engine(api_p, local_p, ctx=ctx, logitshard=True
                                   ).serve(sreqs, ServeConfig(n_slots=4)))
    out["speculative"] = _report(Engine(
        api_p, local_p, ctx=ctx, logitshard=True).serve(
            sreqs, ServeConfig(n_slots=4, scheduler="speculative",
                               spec_k=2, draft_bits=3)))
    out["samplers"] = {name: _sampled(ctx, lg, 42, act)
                       for name, (lg, act) in logits.items()}
    _save(tmp, "cont", rank, out)


# ---------------------------------------------------------------------------
# training on the mesh (tests/test_torch_dist_train*.py)
# ---------------------------------------------------------------------------

def _train_state(path, cfg, ocfg):
    """(api, model, mask, optimizer, whole state) of ``cfg`` from the tree
    saved at ``path``, off the mesh."""
    from repro_torch.configs.base import OptimConfig
    from repro_torch.core import policies
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.state import make_state
    model = load_model(path, cfg)
    mask = policies.make_mask(model, cfg)
    opt = make_optimizer(OptimConfig(**ocfg), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    return registry.build(cfg, device="cpu"), model, mask, opt, state


def _held(local, mask):
    """What the test reassembles of a rank's shard: its trained tensors
    and its codes."""
    return {"trained": {n: p.detach().clone()
                        for n, p in local.named_parameters() if mask[n]},
            "codes": {n: b.clone() for n, b in local.named_buffers()}}


def _threaded_backward():
    """``Tensor.backward`` run on a fresh thread, where no ``use_mesh`` is
    installed (as autograd's device thread on the card); returns the
    function to restore."""
    import threading

    from repro_torch.dist import context
    orig = torch.Tensor.backward

    def backward(self, *args, **kw):
        errors = []

        def body():
            try:
                assert context.current() is None
                orig(self, *args, **kw)
            except BaseException as e:          # re-raised in the caller
                errors.append(e)
        t = threading.Thread(target=body)
        t.start()
        t.join()
        if errors:
            raise errors[0]
    torch.Tensor.backward = backward
    return lambda: setattr(torch.Tensor, "backward", orig)


def train_rank(rank, shape, tmp, cases, batches, threaded, grads):
    """Every training case on the mesh: ``cases`` {name: (cfg, ocfg)}, the
    trees at ``<tmp>/<name>.npz``, 3 steps on ``batches`` from the shard
    of the whole state; each step's metrics, step 1's collective record,
    the eval loss after, and the reassembly inputs.  ``threaded``: a case
    run again with every ``backward()`` on another thread.  ``grads``:
    per-rank numpy gradients for ``compressed_psum`` over each axis."""
    from repro_torch.configs.base import TrainConfig, OptimConfig
    from repro_torch.dist import context
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.train import step
    from repro_torch.train.state import shard_state
    ctx = _ctx(shape)
    out = {"coords": (ctx.data_rank, ctx.model_rank)}

    def run(name):
        cfg, ocfg = cases[name]
        api, _, mask, opt, whole = _train_state(
            os.path.join(tmp, f"{name}.npz"), cfg, ocfg)
        local = shard_state(whole, ctx, cfg)
        tcfg = TrainConfig(optim=OptimConfig(**ocfg))
        ts = step.build_train_step(api, cfg, tcfg, mask, opt, mesh=ctx)
        hist, record = [], None
        for i, b in enumerate(batches):
            with ctx.recording() as rec:
                local, m = ts(local, b)
            hist.append({k: float(v) for k, v in m.items()})
            record = rec if i == 0 else record
        ev = float(step.build_eval_step(api, cfg, mesh=ctx)(
            local["params"], batches[0]))
        return {"hist": hist, "record": record, "eval": ev,
                "want": step.mesh_collectives(
                    local["params"], cfg, mask,
                    tcfg.optim.grad_compression == "int8"),
                **_held(local["params"], mask),
                "moments": {n: tuple(t.clone() for t in pair)
                            for n, pair in local["opt"]["mv"].items()}}

    for name in cases:
        out[name] = run(name)
    restore = _threaded_backward()
    try:
        out["threaded"] = run(threaded)
    finally:
        restore()
    out["psum"] = {axis: compressed_psum(torch.from_numpy(grads[rank]), ctx,
                                         axis) for axis in context.AXES}
    _save(tmp, "train", rank, out)


class _Batches:
    """``loop.train``'s data: the i-th of a list of global batches."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return self.batches[step]


def ckpt_rank(rank, shape, tmp, cfg, ocfg, batches, ckpt, steps, extra):
    """``loop.train`` on the mesh from the tree at ``<tmp>/start.npz`` for
    ``steps`` steps with checkpoints in ``ckpt`` (resuming from the newest
    there), then ``extra`` more steps outside the loop; rank 0 saves the
    history, the extra steps' losses and the restored step."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.train import loop, step
    from repro_torch.train.state import shard_state
    ctx = _ctx(shape)
    api, _, mask, opt, whole = _train_state(os.path.join(tmp, "start.npz"),
                                            cfg, ocfg)
    local = shard_state(whole, ctx, cfg)
    tcfg = TrainConfig(steps=steps, log_every=1, ckpt_every=10 ** 6,
                       optim=OptimConfig(**ocfg))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt, mesh=ctx)
    logs = []
    local, hist = loop.train(local, ts, _Batches(batches), tcfg,
                             ckpt_dir=ckpt, log=logs.append, mesh=ctx)
    after = [float(ts(local, batches[steps + i])[1]["loss"])
             for i in range(extra)]
    if rank == 0:
        _save(tmp, f"ckpt{shape[0]}x{shape[1]}_", rank,
              {"hist": hist, "after": after, "logs": logs,
               "step": local["step"]})


def pipeline_rank(rank, n_stages, tmp, ws, x):
    """``pipeline_apply`` of ``tanh(h @ w)`` over a one-axis ("stage")
    mesh of ``n_stages`` ranks: its output and ``backward()``'s gradient
    of the output's sum on this rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.pipeline_par import pipeline_apply
    mesh = DeviceMesh("cpu", torch.arange(n_stages),
                      mesh_dim_names=("stage",))
    ws = ws.clone().requires_grad_(True)
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh)
    y.sum().backward()
    _save(tmp, f"pipe{n_stages}_", rank, {"y": y.detach(), "grad": ws.grad})


# ---------------------------------------------------------------------------
# MoE expert parallelism (tests/test_torch_dist_moe*.py)
# ---------------------------------------------------------------------------

def moe_block_rank(rank, shape, tmp, cases, x, c, aux_weight):
    """Layer 0's MoE block of each case's shard ({name: cfg}, the trees at
    ``<tmp>/<name>.npz``) on this rank's data block of ``x``: its output,
    aux loss and the gradients of ``sum(y · c) + aux_weight · aux`` (the
    aux averaged over the data axis) with respect to x and every float
    leaf of the block, each model-partial leaf summed over the model axis
    and every leaf over the data axis, as the train step sums them."""
    from repro_torch.dist import context
    from repro_torch.models import moe
    from repro_torch.train import step
    ctx = _ctx(shape)
    rows = ctx.local_rows(x.shape[0])
    out = {"coords": (ctx.data_rank, ctx.model_rank), "rows": rows}
    for name, cfg in cases.items():
        model = load_model(os.path.join(tmp, f"{name}.npz"), cfg)
        shard = sharding.shard_model(model, cfg, ctx)
        bank = sb.ScaleBank()
        bank.add("t", model)
        bank.tasks["t"] = {k: v * 1.5 for k, v in bank.tasks["t"].items()}
        swap = {"record": sb.swap_collectives(shard, bank.tasks["t"], ctx),
                "local_nbytes": bank.local_nbytes("t", ctx),
                "nbytes": bank.nbytes("t")}
        bank.switch(model, "t")                 # the whole model, off the mesh
        swap["equal"] = all(torch.equal(a, b) for a, b in zip(
            shard.parameters(),
            sharding.shard_model(model, cfg, ctx).parameters()))
        model = load_model(os.path.join(tmp, f"{name}.npz"), cfg)
        shard = sharding.shard_model(model, cfg, ctx)
        block = shard.layers[0].moe
        params = {n: p for n, p in block.named_parameters()
                  if p.is_floating_point()}
        for p in params.values():
            p.requires_grad_(True)
        xl = x[rows].clone().requires_grad_(True)
        with context.use_mesh(ctx):
            y, aux = moe.apply(block, context.copy_to_model(xl, ctx), cfg)
        loss = (y * c[rows]).sum() + aux_weight * aux / ctx.data_size
        with ctx.recording() as rec:
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        kinds = {n: sharding.leaf_kind(f"/layers/moe/{n.replace('.', '/')}",
                                       p.dim()) for n, p in params.items()}
        step._bucket_sum(grads, [n for n in grads
                                 if kinds[n] == sharding.PARTIAL],
                         ctx, "model")
        step._bucket_sum(grads, list(grads), ctx, "data")
        out[name] = {"y": y.detach(), "aux": aux.detach(), "dx": xl.grad,
                     "swap": swap,
                     "grads": grads, "kinds": kinds,
                     "backward_record": rec,
                     "local": {n: tuple(b.shape)
                               for n, b in block.named_buffers()}}
        with torch.no_grad(), context.use_mesh(ctx), \
                ctx.recording() as fwd:
            y2, _ = moe.apply(block, x[rows], cfg)
        out[name]["forward_record"] = fwd
        out[name]["y_no_grad"] = y2
    _save(tmp, f"moe{shape[0]}x{shape[1]}_", rank, out)


def moe_train_rank(rank, shape, tmp, cases, batch):
    """Each MoE training case ({name: (cfg, ocfg)}, the trees at
    ``<tmp>/<name>.npz``) on one global ``batch``: ``train_cases``."""
    train_cases(rank, shape, tmp, cases, {name: batch for name in cases},
                "moetrain")


def train_cases(rank, shape, tmp, cases, batches, tag="famtrain"):
    """Each training case ({name: (cfg, ocfg)}, the trees at
    ``<tmp>/<name>.npz``, the global batch ``batches[name]``) on the mesh
    from the shard of the whole state: the loss and the trained gradients
    as the train step makes them (the model-partial ones summed over the
    model axis, all over the data axis), then one step (its metrics,
    collective record and the count ``mesh_collectives`` expects), the
    whole-state tree gathered after it (rank 0 saves it) and whether
    ``load_shard`` of that tree gives this rank's shard back; saved as
    ``<tmp>/<tag><D>x<M>_<rank>.pt``."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.train import step
    from repro_torch.train.state import load_shard, shard_state, whole_tree
    ctx = _ctx(shape)
    out = {"coords": (ctx.data_rank, ctx.model_rank)}
    for name, (cfg, ocfg) in cases.items():
        batch = batches[name]
        api, _, mask, opt, whole = _train_state(
            os.path.join(tmp, f"{name}.npz"), cfg, ocfg)
        local = shard_state(whole, ctx, cfg)
        model = local["params"]
        loss = step._loss(step._mesh_api(api, cfg, ctx), model, batch, ctx)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        step._reduce_grads(grads, model, mask, ctx)
        res = {"loss": float(loss),
               "grads": {n: g.clone() for n, g in grads.items()
                         if mask.get(n) and g is not None},
               "kinds": sharding.leaf_kinds(model),
               "kv_share": sharding.shard_kv_share(model)}
        for p in model.parameters():
            p.grad = None
        ts = step.build_train_step(api, cfg, TrainConfig(
            optim=OptimConfig(**ocfg)), mask, opt, mesh=ctx)
        with ctx.recording() as rec:
            local, m = ts(local, batch)
        res.update(metrics={k: float(v) for k, v in m.items()}, record=rec,
                   want=step.mesh_collectives(local["params"], cfg, mask),
                   **_held(local["params"], mask))
        tree = whole_tree(local, ctx)
        fresh = load_shard(shard_state(whole, ctx, cfg), tree, ctx)
        mine = dict((*local["params"].named_parameters(),
                     *local["params"].named_buffers()))
        back = dict((*fresh["params"].named_parameters(),
                     *fresh["params"].named_buffers()))
        res["restored"] = mine.keys() == back.keys() and all(
            torch.equal(mine[n], back[n]) for n in mine) and all(
            torch.equal(a, b) for n, pair in local["opt"]["mv"].items()
            for a, b in zip(pair, fresh["opt"]["mv"][n]))
        if rank == 0:
            res["tree"] = tree
        out[name] = res
    _save(tmp, f"{tag}{shape[0]}x{shape[1]}_", rank, out)


# ---------------------------------------------------------------------------
# the vlm and encdec families and grouped KV heads on a mesh
# (tests/test_torch_dist_families*.py)
# ---------------------------------------------------------------------------

def families_serve_rank(rank, shape, tmp, cases, prompt, prefixes, n_new,
                        reqs):
    """Each serving case ({name: cfg}, the trees at ``<tmp>/<name>.npz``,
    ``prefixes[name]`` the prompt's (B, P, d) prefix or None): the mesh
    engine's ``generate`` with and without logitshard and its decode
    step's collective record, the prefill logits, drain serving of
    ``reqs[name]`` (rank 0 also runs the unsharded engine's ``generate``
    and drain serving), the slot pool's cache shapes beside the rank's
    block of ``cache_specs``, then a swap of rescaled scales: its
    collective record and whether the shard equals the cut of the swapped
    whole model."""
    ctx = _ctx(shape)
    out = {"coords": (ctx.data_rank, ctx.model_rank)}
    b = prompt.shape[0]
    for name, cfg in cases.items():
        model = load_model(os.path.join(tmp, f"{name}.npz"), cfg)
        api = registry.build(cfg, device="cpu")
        local = sharding.shard_model(model, cfg, ctx)
        host = Engine(api, model, device="cpu")
        pre = prefixes[name]
        res = {"kv_share": local.kv_share}
        for ls in (True, False):
            eng = Engine(api, local, ctx=ctx, logitshard=ls)
            res[f"tokens_{ls}"] = eng.generate(prompt, n_new, prefix=pre)
            res[f"decode_{ls}"] = eng.decode_collectives(b, 24)
        res["logits"] = eng.prefill_logits(prompt, prefix=pre)
        scfg = ServeConfig(n_slots=4, scheduler="drain")
        res["drain"] = _report(eng.serve(reqs[name], scfg))
        if rank == 0:
            res["host_tokens"] = host.generate(prompt, n_new, prefix=pre)
            res["host_drain"] = _report(host.serve(reqs[name], scfg))
        pool = eng.open_pool(4, 24)
        whole = api.init_cache(4, 24, device="meta")
        specs = sharding.cache_specs(
            ctx, whole, 4, ctx.batch_axes(4) is not None,
            n_kv_heads=cfg.n_kv_heads,
            batch_dims=cache_dims(api.init_cache, 2, 8)[0],
            kv_share=local.kv_share)
        res["pool_shapes"] = {k: tuple(v.shape) for k, v in pool.cache.items()}
        res["spec_shapes"] = {k: sharding.local_shape(
            whole[k].shape, specs[k], ctx.axis_sizes) for k in whole}
        bank = sb.ScaleBank()
        bank.add("t", model)
        rng = np.random.default_rng(7)
        bank.tasks["t"] = {k: (v * rng.uniform(0.5, 1.5, v.shape)
                               ).astype(v.dtype)
                           for k, v in bank.tasks["t"].items()}
        res["swap_record"] = sb.swap_collectives(local, bank.tasks["t"], ctx)
        res["local_nbytes"] = bank.local_nbytes("t", ctx, local.kv_share)
        res["nbytes"] = bank.nbytes("t")
        bank.switch(model, "t")
        res["swap_equal"] = all(torch.equal(a, c) for a, c in zip(
            local.parameters(),
            sharding.shard_model(model, cfg, ctx).parameters()))
        out[name] = res
    _save(tmp, f"famserve{shape[0]}x{shape[1]}_", rank, out)


# ---------------------------------------------------------------------------
# the ssm and hybrid families on a mesh (tests/test_torch_dist_recurrent*.py)
# ---------------------------------------------------------------------------

def recurrent_serve_rank(rank, shape, tmp, cases, prompt, n_new, reqs):
    """Each recurrent serving case ({name: cfg}, the trees at
    ``<tmp>/<name>.npz``; ``reqs[name]`` requests over tasks "t0" / "t1"):
    the mesh engine's ``generate`` with and without logitshard and its
    decode step's collective record, the prefill logits, the rank's block
    of the state after the prefill (and its rows), drain serving of the
    requests through a two-task bank (rank 0 also runs the unsharded
    engine's ``generate`` and drain serving), the slot pool's cache shapes
    beside the rank's block of ``cache_specs`` under the structural model
    dims, and a swap of rescaled scales: its collective record and
    whether the shard equals the cut of the swapped whole model."""
    from repro_torch.dist import context
    from repro_torch.train.serve import cache_model_dims
    ctx = _ctx(shape)
    out = {"coords": (ctx.data_rank, ctx.model_rank)}
    b = prompt.shape[0]
    for name, cfg in cases.items():
        model = load_model(os.path.join(tmp, f"{name}.npz"), cfg)
        api = registry.build(cfg, device="cpu")
        local = sharding.shard_model(model, cfg, ctx)
        bank = sb.ScaleBank()
        bank.add("t0", model)
        rng = np.random.default_rng(5)
        bank.tasks["t1"] = {k: (v * rng.uniform(0.8, 1.2, v.shape)
                                ).astype(v.dtype)
                            for k, v in bank.tasks["t0"].items()}
        res = {}
        for ls in (True, False):
            eng = Engine(api, local, bank=bank, ctx=ctx, logitshard=ls)
            res[f"tokens_{ls}"] = eng.generate(prompt, n_new)
            res[f"decode_{ls}"] = eng.decode_collectives(b, 24)
        res["logits"] = eng.prefill_logits(prompt)
        rows = ctx.local_rows(b)
        with torch.inference_mode(), context.use_mesh(ctx):
            _, state = eng.api.prefill(local, {"tokens": prompt[rows]})
        res["state"] = {k: v.clone() for k, v in state.items()}
        res["rows"] = (rows.start, rows.stop)
        scfg = ServeConfig(n_slots=4, scheduler="drain")
        res["drain"] = _report(eng.serve(reqs[name], scfg))
        if rank == 0:
            host = Engine(api, model, bank=bank, device="cpu")
            res["host_tokens"] = host.generate(prompt, n_new)
            res["host_drain"] = _report(host.serve(reqs[name], scfg))
            host.switch_task("t0")
        eng.switch_task("t0")
        pool = eng.open_pool(4, 24)
        whole = api.init_cache(4, 24, device="meta")
        mdims = cache_model_dims(api.init_cache, eng.api.init_cache)
        specs = sharding.cache_specs(
            ctx, whole, 4, ctx.batch_axes(4) is not None,
            n_kv_heads=cfg.n_kv_heads,
            batch_dims=cache_dims(api.init_cache, 2, 8)[0],
            model_dims=mdims)
        res["model_dims"] = mdims
        res["specs"] = specs
        res["pool_shapes"] = {k: tuple(v.shape) for k, v in pool.cache.items()}
        res["spec_shapes"] = {k: sharding.local_shape(
            whole[k].shape, specs[k], ctx.axis_sizes) for k in whole}
        res["swap_record"] = sb.swap_collectives(local, bank.tasks["t1"], ctx)
        res["local_nbytes"] = bank.local_nbytes("t1", ctx)
        res["nbytes"] = bank.nbytes("t1")
        bank.switch(model, "t1")
        res["swap_equal"] = all(torch.equal(a, c) for a, c in zip(
            local.parameters(),
            sharding.shard_model(model, cfg, ctx).parameters()))
        out[name] = res
    _save(tmp, f"recserve{shape[0]}x{shape[1]}_", rank, out)


# ---------------------------------------------------------------------------
# the comparison arms on a mesh (tests/test_torch_dist_arms*.py)
# ---------------------------------------------------------------------------

def arms_serve_rank(rank, shape, tmp, cases, prompt, n_new, prefixes=None,
                    tag="armserve"):
    """Each arm's serving case ({name: cfg}, the trees at
    ``<tmp>/<name>.npz``; ``prefixes[name]`` the prompt's (B, P, d) prefix
    or None): the mesh engine's ``generate`` with and without logitshard
    and its decode step's collective record, and the prefill logits; rank
    0 also the unsharded engine's ``generate`` and prefill logits."""
    ctx = _ctx(shape)
    out = {"coords": (ctx.data_rank, ctx.model_rank)}
    b = prompt.shape[0]
    for name, cfg in cases.items():
        model = load_model(os.path.join(tmp, f"{name}.npz"), cfg)
        api = registry.build(cfg, device="cpu")
        local = sharding.shard_model(model, cfg, ctx)
        pre = (prefixes or {}).get(name)
        res = {}
        for ls in (True, False):
            eng = Engine(api, local, ctx=ctx, logitshard=ls)
            res[f"tokens_{ls}"] = eng.generate(prompt, n_new, prefix=pre)
            res[f"decode_{ls}"] = eng.decode_collectives(b, 24)
            res[f"logits_{ls}"] = eng.prefill_logits(prompt, prefix=pre)
        if rank == 0:
            host = Engine(api, model, device="cpu")
            res["host_tokens"] = host.generate(prompt, n_new, prefix=pre)
            res["host_logits"] = host.prefill_logits(prompt, prefix=pre)
        out[name] = res
    _save(tmp, f"{tag}{shape[0]}x{shape[1]}_", rank, out)


# ---------------------------------------------------------------------------
# the dry run's counts against recorded steps (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

def dryrun_record_rank(rank, shape, tmp, cases, b, s):
    """Each case ({name: cfg}, built from seed 0): the collective records
    of a decode step (``Engine.decode_collectives``, with and without
    logitshard), of ``api.prefill`` of a (b, s) prompt under the mesh, and
    of one train step on a (b, s) batch."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.data import pipeline, synthetic
    from repro_torch.dist import context
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state, shard_state
    ctx = _ctx(shape)
    out = {}
    for name, cfg in cases.items():
        api = registry.build(cfg, device="cpu")
        model, mask = policies.build(api, 0)
        local = sharding.shard_model(model, cfg, ctx)
        res = {}
        for ls in (False, True):
            eng = Engine(api, local, ctx=ctx, logitshard=ls)
            res[f"decode_{ls}"] = eng.decode_collectives(b, 24)
        batch = pipeline.with_prefix(pipeline.PackedLM(
            synthetic.corpus(cfg.vocab_size, 4000, seed=5), b, s
        ).batch_at(0), cfg, 6)
        rows = ctx.local_rows(b)
        local_batch = step.to_device({k: np.asarray(v)[rows]
                                      for k, v in batch.items()}, "cpu")
        with torch.inference_mode(), context.use_mesh(ctx), \
                ctx.recording() as rec:
            eng.api.prefill(local, local_batch)
        res["prefill"] = rec
        opt = make_optimizer(OptimConfig(), 10)
        st = shard_state(make_state(model, opt.init(
            dict(model.named_parameters()), mask)), ctx, cfg)
        ts = step.build_train_step(api, cfg, TrainConfig(), mask, opt,
                                   mesh=ctx)
        with ctx.recording() as rec:
            ts(st, batch)
        res["train"] = rec
        out[name] = res
    _save(tmp, "dryrec", rank, out)
