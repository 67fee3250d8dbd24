"""Per-op row comparison of a speculative verify against step-by-step decode.

The self-speculative stream equals greedy's only if row i of every op on
the decode / verify path gives the same bits whatever the number of rows M
of the call: the verify runs the 8 slots' k+1 tokens as M = 8·(k+1) rows,
the decode steps as M = 8.  ``compare_verify`` runs one verify and the k+1
matching decode steps on copies of one cache, records each op's output
through ``record_ops`` and reports, op by op in call order, whether the
verify's rows are bit-equal to the steps' — the first op that is not is
where row invariance breaks (every later op inherits the difference).

Ops recorded: the embedding, each norm (RMSNorm or LayerNorm), each
quantized or dense linear (``linear.apply``) and its bias add
(``linear.bias_add``), the GELU (``common.gelu``), RoPE on q and k, the
decode attention (``attention._decode_attention``, dense or chunked), the
head, and the greedy argmax of the logits.

Every op after the first differing one sees different inputs, so the trace
names one culprit.  ``isolated_ops`` names them all: it feeds each op kind
of one layer the same random rows at M = B·S and as S calls of M = B.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models import attention, common, linear, transformer


@contextlib.contextmanager
def record_ops(model, out: list):
    """Within the scope, append ``(name, output)`` to ``out`` for every op
    call of the decode path (names from ``model.named_modules()`` where the
    op has a module, else the op and its call index)."""
    names = {id(m): n for n, m in model.named_modules()}
    counts: dict = {}

    def wrap(owner, attr, label):
        fn = getattr(owner, attr)

        def recorded(*a, **kw):
            y = fn(*a, **kw)
            key = label(a)
            counts[key] = counts.get(key, 0) + 1
            out.append((f"{key}#{counts[key]}", y))
            return y
        return owner, attr, fn, recorded

    by_module = lambda a: names.get(id(a[0]), type(a[0]).__name__)
    patches = [
        wrap(common, "embed_apply", lambda a: "embed"),
        wrap(common, "norm_apply", by_module),
        wrap(common, "head_apply", lambda a: "head"),
        wrap(linear, "apply", by_module),
        wrap(linear, "bias_add", lambda a: "bias"),
        wrap(common, "gelu", lambda a: "gelu"),
        wrap(attention, "apply_rope", lambda a: "rope"),
        wrap(attention, "apply_rope_slots", lambda a: "rope"),
        wrap(attention, "_decode_attention", lambda a: "attention"),
    ]
    for owner, attr, _, new in patches:
        setattr(owner, attr, new)
    try:
        yield out
    finally:
        for owner, attr, old, _ in patches:
            setattr(owner, attr, old)


def compare_verify(api, model, cache: dict, tokens: torch.Tensor, pos,
                   stack=None, task_ids=None) -> dict:
    """Run ``decode_verify`` on tokens (B, S) at ``pos`` and S
    ``decode_step`` calls on token columns 0..S-1 at pos + j (the slotted
    forms with ``stack`` and ``task_ids``), each from its own copy of
    ``cache``, recording every op.  Returns ``{"ops": [{"op", "equal",
    "max_abs_diff"}, ...], "first_differing": op name or None,
    "logits_equal": bool, "argmax_equal": bool}`` — an op's rows are equal
    when verify row (b, j) is bit-equal to step j's row b for every b, j."""
    rec_v: list = []
    with torch.inference_mode():
        cv = {k: v.clone() for k, v in cache.items()}
        with record_ops(model, rec_v):
            if stack is None:
                lv, _ = api.decode_verify(model, cv, tokens, pos)
            else:
                lv, _ = api.decode_verify_slotted(model, stack, cv, tokens,
                                                  pos, task_ids)
        rec_v.append(("argmax#1", torch.argmax(lv, dim=-1)))
        cs = {k: v.clone() for k, v in cache.items()}
        rec_s = []
        for j in range(tokens.shape[1]):
            rec: list = []
            with record_ops(model, rec):
                t = tokens[:, j:j + 1]
                if stack is None:
                    lg, cs = api.decode_step(model, cs, t, pos + j)
                else:
                    lg, cs = api.decode_step_slotted(model, stack, cs, t,
                                                     pos + j, task_ids)
            rec.append(("argmax#1", torch.argmax(lg, dim=-1)[:, None]))
            rec_s.append(rec)
    rows = []
    for i, (name, yv) in enumerate(rec_v):
        equal, diff = True, 0.0
        for j, rec in enumerate(rec_s):
            sname, ys = rec[i]
            if sname != name:
                raise RuntimeError(f"op order differs: verify {name}, "
                                   f"step {j} {sname}")
            a, b = yv[:, j], ys[:, 0]
            if not torch.equal(a, b):
                equal = False
                if a.is_floating_point():
                    diff = max(diff, (a.float() - b.float()).abs().max()
                               .item())
        rows.append({"op": name, "equal": equal, "max_abs_diff": diff})
    first = next((r["op"] for r in rows if not r["equal"]), None)
    heads = [r for r in rows if r["op"].startswith("head")]
    return {"ops": rows, "first_differing": first,
            "logits_equal": all(r["equal"] for r in heads),
            "argmax_equal": rows[-1]["equal"]}


def _rows_equal(y_all, y_parts) -> tuple:
    """(equal, max |diff|) of y_all (B, S, ...) against S results
    (B, 1, ...), part j against column j."""
    equal, diff = True, 0.0
    for j, yj in enumerate(y_parts):
        a, b = y_all[:, j], yj[:, 0]
        if not torch.equal(a, b):
            equal = False
            diff = max(diff, (a.float() - b.float()).abs().max().item())
    return equal, diff


def isolated_ops(model, cfg, cache: dict, pos, s: int, stack=None,
                 task_ids=None, seed: int = 0) -> dict:
    """Each op kind of the decode path on the same random inputs as one
    call of B·S rows and as S calls of B rows (row (b, j) of the first is
    row b of call j): every quantized linear of layer 0 (under each row's
    task with ``stack``), the norm (RMSNorm or LayerNorm, by the config),
    the bias add and the GELU where the model has
    them, the head, RoPE, the attention under ``"dense"`` and
    ``"chunked"`` against ``cache`` at ``pos`` (query j at pos + j) and the
    argmax.  Returns {op: {"equal", "max_abs_diff"}}."""
    b = cache["k"].shape[1]
    dev = cache["k"].device
    dt = common.model_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    layer = model.layers[0]
    out = {}

    def check(name, fn, x):
        with torch.inference_mode():
            y = fn(x, None)
            parts = [fn(x[:, j:j + 1], j) for j in range(s)]
        eq, diff = _rows_equal(y, parts)
        out[name] = {"equal": eq, "max_abs_diff": diff}

    def slots_for(j, name_path):
        if stack is None:
            return None
        ids = task_ids.repeat_interleave(s) if j is None else task_ids
        sub = transformer._layer_stack(stack["layers"], 0)
        for key in name_path:
            sub = sub[key]
        return ids, sub

    lins = {"wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
            "wo": ("attn", "wo"), "up": ("mlp", "up"),
            "gate": ("mlp", "gate"), "down": ("mlp", "down")}
    for name, path in lins.items():
        lin = getattr(getattr(layer, path[0]), path[1])
        if lin is None:                  # no gate in a GELU MLP
            continue
        check(f"linear.{name}",
              lambda x, j, lin=lin, path=path: linear.apply(
                  lin, x, slots=slots_for(j, path)),
              rand(b, s, lin.in_features))
    check("norm", lambda x, j: common.norm_apply(layer.ln1, x, cfg),
          rand(b, s, cfg.d_model))
    if layer.attn.wq.b is not None:
        check("bias", lambda y, j: linear.bias_add(y, layer.attn.wq.b),
              rand(b, s, layer.attn.wq.out_features))
    if layer.mlp.gate is None:
        check("gelu", lambda x, j: common.gelu(x), rand(b, s, cfg.d_ff))
    check("head", lambda x, j: common.head_apply(model.lm_head, model.embed,
                                                 x, cfg),
          rand(b, s, cfg.d_model))
    positions = torch.as_tensor(pos, device=dev)
    positions = positions if positions.dim() else positions.expand(b)
    check("rope", lambda x, j: common.apply_rope_slots(
        x, common.rope_table(cfg, positions[:, None] + (
            torch.arange(s, device=dev)[None] if j is None else j))),
        rand(b, s, cfg.n_heads, cfg.d_head))
    for impl in ("dense", "chunked"):
        check(f"attention.{impl}",
              lambda q, j, impl=impl: attention._decode_attention(
                  q, cache["k"][0], cache["v"][0],
                  positions if j is None else positions + j, impl),
              rand(b, s, cfg.n_heads, cfg.d_head))
    check("argmax", lambda x, j: torch.argmax(x.float(), dim=-1),
          rand(b, s, cfg.vocab_size))
    return out
