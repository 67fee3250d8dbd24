"""OPTQ (GPTQ, Frantar et al. [28]) — the paper's PTQ baseline for the
LoRA+OPTQ arm of Tables 2/3 (port of ``repro/core/gptq.py``).

Layer-wise second-order weight quantization: given a weight W (n, m) and the
Hessian H = 2 XᵀX of the layer's inputs, quantize columns left→right while
propagating the rounding error through Hinv (Cholesky form).  Scales/zeros
are the same per-channel RTN grid as PEQA's init, so PEQA-vs-OPTQ isolates
exactly what the paper isolates: error feedback from calibration data vs
end-to-end fine-tuning of the scales.

The arithmetic is the reference's numpy float64, in torch float64 on the
weight's device, column by column in the same order (``gptq_columns``), so
fed the same inverse factor, scales and zeros it gives the same codes.

Calibration capture is implemented for the dense-transformer family: the
block is replayed layer by layer and every linear's true input stream is
collected (sequential quantization: later layers see the quantized prefix,
whose replay on the card goes through K2).  On the card the column loop of
each weight shape is captured once in a CUDA graph and replayed for every
matrix of that shape (``graphed_columns``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.quant import pack_codes, rtn_quantize
from repro_torch.kernels import ops
from repro_torch.models import attention, common, linear

# the linears of a dense block, in the order the reference quantizes them
LINEARS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
           "mlp/up", "mlp/gate", "mlp/down")


def inverse_factor(x: torch.Tensor, damp: float = 0.01):
    """(hinv, dead) from calibration inputs x (T, m): the upper Cholesky
    factor of (H + λI)⁻¹, H = 2 XᵀX in float64 with every dead column's
    diagonal (no input ever reaches it) set to 1, λ = damp · mean diag(H)
    (the reference's ``np.linalg.cholesky(np.linalg.inv(h)).T``)."""
    xd = x.to(torch.float64)
    h = 2.0 * (xd.T @ xd)
    dead = torch.diagonal(h) == 0
    idx = dead.nonzero()[:, 0]
    h[idx, idx] = 1.0
    m = h.shape[0]
    h += torch.eye(m, dtype=torch.float64, device=h.device) * damp \
        * torch.diagonal(h).mean()
    return torch.linalg.cholesky(torch.linalg.inv(h)).T, dead


def gptq_columns(w: torch.Tensor, hinv: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, levels: int) -> torch.Tensor:
    """The column loop: w (n, m) float64 (copied), hinv (m, m) upper
    triangular, scale/zero (n, G) float64.  Column j is rounded on its
    group's grid, then its rounding error, divided by hinv[j, j], is taken
    from the columns after it along hinv's row j.  Returns the codes (n, m)
    uint8.  Each step is the reference's float64 arithmetic, one operation
    at a time in the same order."""
    n, m = w.shape
    gsz = m // scale.shape[-1]
    wq = w.to(torch.float64).clone()
    q = torch.zeros((n, m), dtype=torch.uint8, device=w.device)
    for j in range(m):
        s, z = scale[:, j // gsz], zero[:, j // gsz]
        col = wq[:, j]
        qa = torch.clamp(torch.round(col / s + z), 0, levels)
        q[:, j] = qa.to(torch.uint8)
        err = (col - s * (qa - z)) / hinv[j, j]
        if j + 1 < m:
            wq[:, j + 1:] -= err[:, None] * hinv[j, j + 1:][None, :]
    return q


def graphed_columns(graphs: dict, w, hinv, scale, zero, levels: int):
    """``gptq_columns`` on CUDA tensors, replayed from a CUDA graph captured
    at the first call of each shape and kept in ``graphs``: the same kernels
    on the same values, so the same codes, without the host's cost of
    launching a dozen small kernels per column (which is what bounds the
    eager loop on the card).  The graph's inputs are static copies."""
    key = (tuple(w.shape), scale.shape[-1], levels)
    if key not in graphs:
        static = [t.clone() for t in (w, hinv, scale, zero)]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gptq_columns(*static, levels)
        graphs[key] = (graph, static, out)
    graph, static, out = graphs[key]
    for dst, src in zip(static, (w, hinv, scale, zero)):
        dst.copy_(src)
    graph.replay()
    return out.clone()


def gptq_quantize_matrix(w: torch.Tensor, x: torch.Tensor, qcfg: QuantConfig,
                         damp: float = 0.01, graphs: Optional[dict] = None):
    """GPTQ on one matrix. w (n, m), x (T, m) calibration inputs, on w's
    device.  ``graphs``: on CUDA tensors, a dict in which to keep the column
    loop's CUDA graphs across calls (``graphed_columns``); None runs it
    eagerly.

    Returns (q codes uint8 (n, m), scale (n, G), zero (n, G) float32)."""
    spec = qcfg.spec()
    w = w.to(torch.float64).clone()
    hinv, dead = inverse_factor(x.to(w.device), damp)
    w[:, dead] = 0.0
    # fixed per-group RTN scales from the ORIGINAL weights (paper protocol)
    _, scale, zero = rtn_quantize(w.to(torch.float32), spec,
                                  n_grid=qcfg.n_grid)
    scale, zero = scale.to(torch.float64), zero.to(torch.float64)
    if graphs is not None and w.is_cuda:
        q = graphed_columns(graphs, w, hinv, scale, zero, spec.levels)
    else:
        q = gptq_columns(w, hinv, scale, zero, spec.levels)
    return q, scale.to(torch.float32), zero.to(torch.float32)


def _linear(layer: nn.Module, name: str):
    grp, key = name.split("/")
    return getattr(getattr(layer, grp), key, None)


def _block_linear_inputs(layer: nn.Module, h: torch.Tensor,
                         cfg: ModelConfig):
    """Replay one dense-transformer block, returning each linear's input
    stream AND the block output (quantized weights already in the layer are
    honored → sequential GPTQ).  The attention is the reference's default,
    ``"dense"`` (its replay passes no ``attn_impl``); the norms, biases and
    MLP follow the config (RMSNorm or LayerNorm, SwiGLU or GELU)."""
    b, s, _ = h.shape
    captures = {}
    hin = common.norm_apply(layer.ln1, h, cfg)
    for name in ("attn/wq", "attn/wk", "attn/wv"):
        captures[name] = hin
    q, k, v = attention._qkv(layer.attn, hin, cfg)
    rope = common.rope_table(cfg, torch.arange(s, device=h.device))
    q, k = common.apply_rope(q, rope), common.apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True, window=cfg.swa_window,
                      impl="dense")
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    captures["attn/wo"] = o
    h = h + linear.apply(layer.attn.wo, o)
    hin = common.norm_apply(layer.ln2, h, cfg)
    captures["mlp/up"] = captures["mlp/gate"] = hin
    up = linear.apply(layer.mlp.up, hin)
    if layer.mlp.gate is not None:
        act = F.silu(linear.apply(layer.mlp.gate, hin)) * up
    else:
        act = common.gelu(up)
    captures["mlp/down"] = act
    h = h + linear.apply(layer.mlp.down, act)
    return captures, h


@torch.no_grad()
def gptq_quantize_transformer(model: nn.Module, cfg: ModelConfig,
                              calib_tokens: torch.Tensor,
                              damp: float = 0.01,
                              verbose: bool = False) -> nn.Module:
    """Sequential OPTQ over a dense-transformer model, in place: every fp
    linear of every block becomes nibble codes with GPTQ's scales and
    zeros (the table and the head stay fp, as in the reference).
    ``calib_tokens`` (B, S) on the model's device.  Returns the model."""
    spec = cfg.quant.spec()
    spec.check_ported()
    if spec.plane:
        raise NotImplementedError(
            "GPTQ on layout='plane': the reference's gptq_quantize_transformer "
            "writes nibble words whatever the layout (use layout='nibble')")
    h = common.embed_apply(model.embed, calib_tokens, cfg)
    graphs: dict = {}            # the column loop's graphs, one a shape
    for i, layer in enumerate(model.layers):
        captures, _ = _block_linear_inputs(layer, h, cfg)
        for name in LINEARS:
            lin = _linear(layer, name)
            if lin is None or lin.quantized:
                continue
            x = captures[name].to(torch.float32).reshape(-1, lin.in_features)
            qc, sc, zc = gptq_quantize_matrix(lin.w.detach(), x, cfg.quant,
                                              damp, graphs=graphs)
            lin.set_quantized(pack_codes(qc), sc, zc, spec)
        del captures
        # replay with quantized weights → next layer sees quantized stream
        _, h = _block_linear_inputs(layer, h, cfg)
        if verbose:
            print(f"[gptq] layer {i + 1}/{len(model.layers)} done")
    return model
