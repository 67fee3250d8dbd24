"""The mesh context and the port's collective layer (port of
``repro/dist/context.py``).

A ``MeshContext`` is one process's view of a 2-D ``(data, model)`` mesh
over ``torch.distributed``: a ``DeviceMesh`` with the axes ``("data",
"model")``, this rank's index on each axis, and the device its tensors
live on.  The model axis carries Megatron-style tensor parallelism (each
rank holds its shard of the model, ``dist/sharding.py``); the data axis
splits the batch, or the slot pool, wherever it divides
(``batch_axes``).

The reference states where each leaf lives and lets XLA insert the
collectives.  The port makes every collective explicit, and this module
is the only place that calls ``torch.distributed`` for them:

  * ``all_reduce(t, axis, op)`` — sum, max or min over ``axis``, in
    place: the caller hands over a tensor it owns;
  * ``all_gather(t, axis, dim)`` — the axis' blocks concatenated along
    ``dim``, in axis order;
  * ``broadcast(t, axis, src)`` — from the rank at index ``src`` of the
    axis.

Inside ``recording()`` every call is tallied, one (kind, axis, dtype,
shape, bytes) entry a call — ``shape`` the result's, ``bytes`` the payload
this rank contributes —, the port's counterpart of the reference's HLO
scans (``launch/hlo_stats.py::collective_stats``,
``allgather_extent_count``).  The two process groups are looked up once,
when the context is made.

Ranks that share one card run under gloo (``dist/backend.py``).
PyTorch's collective table lists gloo as taking CUDA tensors for
``broadcast`` and ``all_reduce`` only, but on the card's machine (torch
2.11.0+cu128) gloo ran every kind this layer calls — ``all_reduce`` sum,
max and min, ``all_gather`` and ``broadcast`` — on CUDA tensors of
float32, bfloat16 and int64 with the right results (phase ``mesh`` of
``chip_smoke.py`` runs them all), so nothing is staged through host
memory: each collective takes the rank's tensor where it lies.

``use_mesh(ctx, logitshard=...)`` installs the context for the current
thread; model code reads it through ``current()`` and ``logitshard()``.
With no context installed every model function runs unsharded.

Training differentiates through the collectives with the Megatron pair
(``torch.autograd.Function``s, each keeping the context its forward was
given — a backward never looks the context up: on the card it runs on
autograd's device thread, where no ``use_mesh`` is installed):

  * ``reduce_sum(t, ctx, axis)`` — an all-reduce sum forward, the identity
    backward (``reduce_from_model`` over the model axis: the row-parallel
    sums and the vocab-sharded lookup; over the data axis: the loss);
  * ``copy_to_model(t, ctx)`` — the identity forward, an all-reduce sum of
    the gradient backward (the input of a column-parallel group, whose
    gradient each rank holds a partial sum of);
  * ``sum_over_model(t, ctx)`` — an all-reduce sum forward and backward:
    a statistic over a dim cut across the model axis whose every rank's
    copy feeds only that rank's block (Mamba2's gated norm over d_inner,
    ``common.sharded_rms_norm``), so each rank holds a partial sum of its
    gradient.

All three reduce into a fresh tensor while a graph is recorded (nothing
autograd saved is overwritten); outside one they are the in-place
``all_reduce`` and the identity.  ``in_mesh(ctx, fn)`` re-installs the
context around a remat checkpoint's function, whose recompute runs in
the backward.

``group_all_gather`` and ``group_all_reduce`` run the same two kinds over
any process group (a pipeline's stage axis, ``dist/pipeline_par.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Tuple

import torch

AXES = ("data", "model")
_OPS = ("sum", "max", "min")

_tls = threading.local()


@dataclasses.dataclass(eq=False)
class MeshContext:
    """One rank's view of the ``(data, model)`` mesh.

    ``data_rank`` / ``model_rank`` are this rank's index on each axis;
    ``device`` where the rank's tensors live (None: the rank's own,
    ``backend.device()``); ``groups`` the ``DeviceMesh``'s process group of
    each axis (None for a context that only names a position: ``coords``,
    which ``shard_model`` and the byte counts accept).
    """
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    device: Optional[torch.device]
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    groups: Optional[dict] = None
    _recs: List[list] = dataclasses.field(default_factory=list)

    @property
    def axis_sizes(self) -> dict:
        return {"data": self.data_size, "model": self.model_size}

    @property
    def world(self) -> int:
        return self.data_size * self.model_size

    # ------------------------------------------------------- layout sugar
    def batch_axes(self, batch: int):
        """The data axes when ``batch`` divides them, else None (the rows
        are then replicated over the data axis)."""
        return self.data_axes if batch % self.data_size == 0 else None

    def local_rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row tensor: its data block where
        the batch divides the data axis, else every row."""
        if self.batch_axes(batch) is None:
            return slice(0, batch)
        n = batch // self.data_size
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def vocab_range(self, vocab: int) -> Tuple[int, int]:
        """[start, stop) of this rank's vocab block."""
        n = vocab // self.model_size
        return self.model_rank * n, (self.model_rank + 1) * n

    # ---------------------------------------------------------- collectives
    def _group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(
                "this MeshContext names a mesh position only (coords); it "
                "has no process groups to run a collective on")
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (have {AXES})")
        return self.groups[axis]

    def _size(self, axis: str) -> int:
        return self.data_size if axis == "data" else self.model_size

    def _tally(self, kind: str, axis: str, t: torch.Tensor, shape) -> None:
        if not self._recs:
            return
        entry = {"kind": kind, "axis": axis,
                 "dtype": str(t.dtype).replace("torch.", ""),
                 "shape": tuple(shape), "bytes": t.numel() * t.element_size()}
        for rec in self._recs:
            rec.append(entry)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` reduced over ``axis`` (sum, max or min), in place where
        ``t`` is contiguous: the caller hands over a tensor it owns, and
        uses the returned one."""
        import torch.distributed as dist
        if op not in _OPS:
            raise ValueError(f"all_reduce op {op!r} (have {_OPS})")
        group = self._group(axis)
        t = t.contiguous()
        self._tally("all_reduce", axis, t, t.shape)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The ``axis`` ranks' ``t`` concatenated along ``dim`` in axis
        order (every rank's ``t`` has the same shape)."""
        import torch.distributed as dist
        group = self._group(axis)
        t = t.contiguous()
        n = self._size(axis)
        shape = list(t.shape)
        shape[dim] *= n
        self._tally("all_gather", axis, t, shape)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """``t`` from the rank at index ``src`` of ``axis``, in place as
        ``all_reduce`` (the others' ``t`` gives only shape and dtype)."""
        import torch.distributed as dist
        group = self._group(axis)
        t = t.contiguous()
        self._tally("broadcast", axis, t, t.shape)
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
        return t

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        import torch.distributed as dist
        dist.barrier()

    @contextlib.contextmanager
    def recording(self):
        """Yield a list that receives the collective entries of the scope."""
        got: List[dict] = []
        self._recs.append(got)
        try:
            yield got
        finally:
            self._recs.remove(got)


def _recording_graph(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ReduceSum(torch.autograd.Function):
    """All-reduce sum over an axis forward, the identity backward."""

    @staticmethod
    def forward(fctx, t, ctx, axis):
        return ctx.all_reduce(t.clone(memory_format=torch.contiguous_format),
                              axis)

    @staticmethod
    def backward(fctx, grad):
        return grad, None, None


class _SumOverModel(torch.autograd.Function):
    """All-reduce sum over the model axis forward AND backward (on the
    context the forward was given)."""

    @staticmethod
    def forward(fctx, t, ctx):
        fctx.mesh = ctx
        return ctx.all_reduce(t.clone(memory_format=torch.contiguous_format),
                              "model")

    @staticmethod
    def backward(fctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        return fctx.mesh.all_reduce(g, "model"), None


class _CopyToModel(torch.autograd.Function):
    """The identity forward, the gradient all-reduced over the model axis
    backward (on the context the forward was given)."""

    @staticmethod
    def forward(fctx, t, ctx):
        fctx.mesh = ctx
        return t.view_as(t)

    @staticmethod
    def backward(fctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        return fctx.mesh.all_reduce(g, "model"), None


def reduce_sum(t: torch.Tensor, ctx: MeshContext, axis: str
               ) -> torch.Tensor:
    """``t`` summed over ``axis``; differentiable (the gradient passes
    through unchanged) while a graph is recorded, else in place as
    ``all_reduce``."""
    if _recording_graph(t):
        return _ReduceSum.apply(t, ctx, axis)
    return ctx.all_reduce(t, axis)


def reduce_from_model(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Megatron's g: the model axis' partial sums of ``t`` added up."""
    return reduce_sum(t, ctx, "model")


def copy_to_model(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Megatron's f: ``t`` itself, whose gradient is summed over the model
    axis in the backward (the identity outside a recorded graph)."""
    if _recording_graph(t):
        return _CopyToModel.apply(t, ctx)
    return t


def sum_over_model(t: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """``t`` summed over the model axis where each rank's copy of the sum
    feeds only that rank's block of a result (a norm's statistic over a
    dim cut across the axis): the gradient of the sum is then the model
    axis' sum of the ranks' gradients, so the backward all-reduces too
    (the identity forward is never right here); outside a recorded graph
    the in-place ``all_reduce``."""
    if _recording_graph(t):
        return _SumOverModel.apply(t, ctx)
    return ctx.all_reduce(t, "model")


def in_mesh(ctx: Optional[MeshContext], fn):
    """``fn`` run under ``use_mesh(ctx)`` (``fn`` itself for None): what a
    remat checkpoint of a shard's block calls, since its recompute runs in
    the backward — on autograd's device thread on the card, where the
    caller's ``use_mesh`` is not installed."""
    if ctx is None:
        return fn

    def run(*args):
        with use_mesh(ctx):
            return fn(*args)
    return run


def group_all_gather(t: torch.Tensor, group, n: int) -> list:
    """The ``n`` ranks of ``group``'s ``t``, in group order."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


def group_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, into a fresh tensor."""
    import torch.distributed as dist
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


def coords(data_size: int, model_size: int, data_rank: int = 0,
           model_rank: int = 0, device=None) -> MeshContext:
    """A context that names a mesh position without process groups: what
    cutting a shard (``sharding.shard_model``) and counting its bytes
    need, in one process (``device`` None: the rank's own)."""
    for name, (i, n) in (("data", (data_rank, data_size)),
                         ("model", (model_rank, model_size))):
        if not 0 <= i < n:
            raise ValueError(f"{name} rank {i} outside an axis of {n}")
    return MeshContext(data_size=data_size, model_size=model_size,
                       data_rank=data_rank, model_rank=model_rank,
                       device=None if device is None
                       else torch.device(device))


def make_ctx(mesh, *, device=None) -> MeshContext:
    """The context over a ``DeviceMesh`` whose axes are ``("data",
    "model")`` (the reference's ``make_ctx``: the non-model axis carries
    the batch).  ``device`` is where this rank's tensors live: by default
    the rank's own (``backend.device()``: where ``backend.init`` placed
    it, else the current card — never the CPU unless it is asked for)."""
    from repro_torch.dist import backend
    names = tuple(mesh.mesh_dim_names or ())
    if names != AXES:
        raise ValueError(f"the port's mesh has the axes {AXES}, got {names}")
    shape = tuple(mesh.mesh.shape)
    return MeshContext(
        data_size=shape[0], model_size=shape[1],
        data_rank=mesh.get_local_rank("data"),
        model_rank=mesh.get_local_rank("model"),
        device=backend.device(device),
        groups={axis: mesh.get_group(axis) for axis in AXES})


@contextlib.contextmanager
def use_mesh(ctx: MeshContext, *, logitshard: bool = False):
    """Install ``ctx`` for the current thread (re-entrant).  Under
    ``logitshard`` the serving functions return each rank's vocab block of
    the logits; otherwise they gather the whole row over the model axis."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append((ctx, bool(logitshard)))
    try:
        yield ctx
    finally:
        stack.pop()


def current() -> Optional[MeshContext]:
    stack = getattr(_tls, "stack", None)
    return stack[-1][0] if stack else None


def logitshard() -> bool:
    stack = getattr(_tls, "stack", None)
    return bool(stack) and stack[-1][1]


def require() -> MeshContext:
    """The installed context, or a clear error for a shard run without one
    (a shard's partial sums would otherwise go unreduced)."""
    ctx = current()
    if ctx is None:
        raise RuntimeError("a sharded model ran outside use_mesh(ctx): its "
                           "row-parallel sums and vocab blocks need the "
                           "mesh context")
    return ctx


def allgather_extent_count(record: List[dict], extent: int) -> int:
    """All-gathers in ``record`` whose result has a dim of ``extent`` (the
    reference's ``hlo_stats.allgather_extent_count``: with the vocab size,
    the logits gathers a decode step makes)."""
    return sum(1 for e in record
               if e["kind"] == "all_gather" and extent in e["shape"])


def collective_stats(record: List[dict]) -> dict:
    """{kind: {"count", "bytes"}} and ``total_bytes`` of a record (the
    reference's ``hlo_stats.collective_stats``)."""
    out: dict = {}
    for e in record:
        s = out.setdefault(e["kind"], {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += e["bytes"]
    out["total_bytes"] = sum(e["bytes"] for e in record)
    return out
