"""GPipe-style pipeline parallelism over ``torch.distributed`` (port of
``repro/dist/pipeline_par.py``).

``pipeline_apply(layer_fn, stacked_ws, x, mesh)`` runs ``L`` stacked layers
as ``S`` pipeline stages (S = the mesh's size along the pipeline axis, L/S
layers a stage: each rank applies only its own slice of the layer dim).
The batch is split into ``S`` microbatches and streamed through the classic
GPipe schedule: at step ``t`` stage ``s`` processes microbatch ``t − s``,
then hands its activation to stage ``s+1`` with a single ring permute.
Total steps ``T = M + S − 1``; the (S−1)/T bubble is the standard GPipe
cost.

Every rank calls it with the same ``stacked_ws`` and ``x`` (the
reference's replicated operands) and gets the same output.  It is
differentiable: the ring permute is an ``autograd.Function`` whose
backward is the reverse ring, and the output is the last stage's,
broadcast by a sum whose backward passes the gradient through
(``context.reduce_sum``'s rule) — so ``backward()`` leaves each rank the
gradient of its own stage's layers, zero elsewhere, and the ranks' sum is
the sequential gradient.  Every rank builds the same graph (stage 0 takes
``where(first, feed, carry)`` as the reference does), so the backward's
collectives run in one order on every rank.

The permute is built from ``all_gather`` (each rank keeps its
predecessor's tensor): ranks sharing one card run under gloo, which the
port runs on CUDA tensors for ``all_gather``, ``all_reduce`` and
``broadcast``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.dist import context


def _pipeline_axis(mesh) -> str:
    names = tuple(mesh.mesh_dim_names or ())
    if "stage" in names:
        return "stage"
    if len(names) == 1:
        return names[0]
    raise ValueError(
        f"mesh axes {names} have no 'stage' axis; pass "
        "axis_name= explicitly (silently pipelining over a data/tensor "
        "axis would destroy that axis's parallelism)")


class _RingPermute(torch.autograd.Function):
    """Stage s receives stage s−1's tensor (mod S); the backward sends the
    gradient the other way round."""

    @staticmethod
    def forward(fctx, t, group, n, index, shift):
        fctx.ring = (group, n, index, shift)
        return context.group_all_gather(t, group, n)[(index - shift) % n]

    @staticmethod
    def backward(fctx, grad):
        group, n, index, shift = fctx.ring
        return (_RingPermute.apply(grad, group, n, index, -shift),
                None, None, None, None)


class _SumBroadcast(torch.autograd.Function):
    """Sum over the group forward, the identity backward."""

    @staticmethod
    def forward(fctx, t, group):
        return context.group_all_reduce(t, group)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


def pipeline_apply(layer_fn: Callable, stacked_ws, x: torch.Tensor, mesh,
                   axis_name: Optional[str] = None) -> torch.Tensor:
    """Apply ``L`` stacked layers to ``x`` (batch, ...) as a pipeline over
    ``mesh``'s pipeline axis (a ``DeviceMesh``: one axis, or a ``"stage"``
    axis).

    ``layer_fn(w_i, h) -> h`` must preserve ``h``'s shape (residual-stream
    layers).  ``stacked_ws`` is a tensor or a dict of tensors whose leaves
    all have the layer dim leading.
    """
    axis_name = axis_name or _pipeline_axis(mesh)
    names = tuple(mesh.mesh_dim_names)
    n_stages = int(mesh.mesh.shape[names.index(axis_name)])
    leaves = list(stacked_ws.values()) if isinstance(stacked_ws, dict) \
        else [stacked_ws]
    n_layers = leaves[0].shape[0]
    batch = x.shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide {n_stages} stages")
    if batch % n_stages:
        raise ValueError(f"batch {batch} does not divide {n_stages} "
                         "microbatches (one per stage)")
    group = mesh.get_group(axis_name)
    s_idx = mesh.get_local_rank(axis_name)
    n_micro = n_stages
    mub = batch // n_micro
    n_steps = n_micro + n_stages - 1
    per = n_layers // n_stages
    lo = s_idx * per

    def layer_w(i):
        if isinstance(stacked_ws, dict):
            return {k: v[lo + i] for k, v in stacked_ws.items()}
        return stacked_ws[lo + i]

    def apply_local(h):
        for i in range(per):
            h = layer_fn(layer_w(i), h)
        return h

    xm = x.reshape(n_micro, mub, *x.shape[1:])
    first = torch.tensor(s_idx == 0, device=x.device)
    last = torch.tensor(s_idx == n_stages - 1, device=x.device)
    cur = torch.zeros((mub, *x.shape[1:]), dtype=x.dtype, device=x.device)
    outs = []
    for t in range(n_steps):
        # stage 0 injects a fresh microbatch; everyone else continues what
        # arrived over the ring last step
        out = apply_local(torch.where(first, xm[min(t, n_micro - 1)], cur))
        if t >= n_stages - 1:
            # the last stage banks finished microbatch t − (S − 1)
            outs.append(out)
        if t < n_steps - 1:
            cur = _RingPermute.apply(out, group, n_stages, s_idx, 1)
    y = torch.stack(outs).reshape(x.shape)
    # only the last stage holds real outputs; the sum broadcasts them
    y = torch.where(last, y, torch.zeros_like(y))
    return _SumBroadcast.apply(y, group)
