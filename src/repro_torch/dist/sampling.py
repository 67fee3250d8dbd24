"""Samplers over decode logits (port of ``repro/dist/sampling.py``:
``shard_argmax``, ``shard_argmax_masked``, ``shard_sample``,
``shard_top_p``, ``shard_topk`` and ``_topp_keep``), off the mesh and over
vocab-sharded logits.

With ``ctx`` None each is a plain reduction over the whole row.  With a
mesh context (``dist/context.py``) each takes the rank's block of the
logits — (B_local, V/M): its rows where the batch divides the data axis
(``ctx.local_rows(batch)``), its vocab block — and the model-axis ranks
agree on a winner with scalar collectives: O(B) bytes a step instead of
the O(B·V) gather of the whole row.  Every sharded form returns, for the
rank's rows, bit for bit what the off-mesh form returns on the whole
logits:

  * ``shard_argmax`` / ``shard_argmax_masked`` — local argmax, then a
    max-reduce of the values, the losers masked to a sentinel, and a
    min-reduce of the global indices: ties to the lowest global index.
  * ``shard_topk`` — the k largest, ties to the lower index (a stable
    descending sort: ``torch.topk`` promises no tie order); sharded, each
    rank's k candidates are gathered shard-major and sorted again.
  * ``shard_sample`` — temperature sampling by the Gumbel-max trick:
    argmax(logits/T + g) samples softmax(logits/T) exactly.
  * ``shard_top_p`` — nucleus sampling: ``_topp_keep``'s integer keep mask
    (sharded: an integer histogram summed over the model axis and the tie
    counts gathered), then Gumbel-max over the kept tokens.

The Gumbel field ``g`` is a counter-based integer hash of (key, global
row, global vocab index) on int64 tensors, so any block of it is the same
block of the whole field: a sharded sampler draws the off-mesh stream.
``key`` is a Python ``int``.  The reference draws its field from
threefry; the port does not reproduce those draws, only their
distribution.
"""
from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1
# top-p fixed-point resolution: softmax weights are integers in [0, 2^14],
# so every reduction in the nucleus selection is integer arithmetic
_TOPP_SCALE = 1 << 14


def _start(ctx, v: int) -> int:
    """Global vocab index of this rank's first logit column."""
    return ctx.model_rank * v


def _winner(ctx, val: torch.Tensor, idx: torch.Tensor, vocab: int
            ) -> torch.Tensor:
    """The model-axis winner of each row: the largest ``val``, ties to the
    lowest global ``idx`` (the sentinel ``vocab`` marks the losers)."""
    vmax = ctx.all_reduce(val.clone(), "model", "max")
    cand = torch.where(val == vmax, idx, torch.full_like(idx, vocab))
    return ctx.all_reduce(cand, "model", "min")


def _local_argmax(ctx, z: torch.Tensor) -> torch.Tensor:
    v = z.shape[-1]
    li = torch.argmax(z, dim=-1)
    lv = z.gather(-1, li[:, None])[:, 0]
    return _winner(ctx, lv, li + _start(ctx, v), v * ctx.model_size)


def shard_argmax(ctx, batch: int):
    """Greedy sampler → ``fn(logits) -> (B,) int64`` token ids; ties resolve
    to the lowest (global) index, as the reference's.  With a mesh context
    the logits are the rank's (B_local, V/M) block."""
    if ctx is None:
        return lambda lg: torch.argmax(lg, dim=-1)
    return lambda lg: _local_argmax(ctx, lg)


def shard_argmax_masked(ctx, batch: int, fill: int = 0):
    """Active-mask-aware greedy sampler for the slot pool →
    ``fn(logits, active (B,) bool) -> (B,) int64``.  Free slots still flow
    through the decode step (the batch is the fixed pool), but their
    logits are garbage: the mask pins their sample to ``fill`` — after the
    winner reduce, so the collectives are those of ``shard_argmax``."""
    base = shard_argmax(ctx, batch)

    def sample(lg, active):
        return base(lg).masked_fill(~active, fill)
    return sample


def _stable_topk(lg: torch.Tensor, k: int):
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def shard_topk(ctx, batch: int, k: int):
    """Top-k → ``fn(logits) -> ((B, k) values, (B, k) int64 indices)``,
    ties to the lower index (as ``jax.lax.top_k``).  Sharded: each rank's
    k candidates (k ≤ V/M) with their global indices are gathered over the
    model axis in shard order — 2·B·k·M scalars, whatever the vocab — and
    the stable sort of the gathered row keeps the lower index first."""
    if ctx is None:
        return lambda lg: _stable_topk(lg, k)

    def sample(lg):
        v = lg.shape[-1]
        if k > v:
            raise ValueError(f"top-k of {k} over a vocab block of {v}")
        lv, li = _stable_topk(lg, k)
        allv = ctx.all_gather(lv, "model", dim=1)
        alli = ctx.all_gather(li + _start(ctx, v), "model", dim=1)
        vals, pos = _stable_topk(allv, k)
        return vals, alli.gather(1, pos)
    return sample


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64, from 16-bit
    halves, so no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    c_lo, c_hi = c & 0xFFFF, c >> 16
    return (lo * c_lo + (((lo * c_hi + hi * c_lo) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply) on int64 tensors
    holding values in [0, 2^32); the shifts are logical there."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _key_word(key: int) -> int:
    """A Python ``int`` key (any width, any sign) folded to 32 bits."""
    k = int(key) & ((1 << 64) - 1)
    lo = torch.tensor(k & _MASK32, dtype=torch.int64)
    return int(_hash32(_hash32(lo) ^ (k >> 32)))


def _gumbel_field(key: int, rows: torch.Tensor,
                  gidx: torch.Tensor) -> torch.Tensor:
    """(len(rows), len(gidx)) float32 standard Gumbel noise; element
    (b, i) is a pure function of (key, rows[b], gidx[i]) — keyed on GLOBAL
    coordinates, so a shard holding rows [r, r+b) and vocab columns
    [s, s+v) draws exactly that block of the one logical field."""
    h_row = _hash32((rows.to(torch.int64) & _MASK32) ^ _key_word(key))
    h_idx = _hash32((gidx.to(torch.int64) * 0x9E3779B9 + 0x632BE5AB)
                    & _MASK32)
    h = _hash32(_hash32(h_row[:, None] ^ h_idx[None, :]) ^ h_row[:, None])
    # the top 24 bits, centred: u in (0, 1), never 0 or 1
    u = ((h >> 8).to(torch.float64) + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).to(torch.float32)


def _rows(ctx, batch: int, b: int, device) -> torch.Tensor:
    """Global row indices of the ``b`` rows a rank holds of ``batch``."""
    start = 0 if ctx is None else ctx.local_rows(batch).start
    return torch.arange(start, start + b, device=device)


def _field_for(ctx, batch: int, lg: torch.Tensor, key: int) -> torch.Tensor:
    """The block of the Gumbel field under this rank's logits ``lg``."""
    b, v = lg.shape
    start = 0 if ctx is None else _start(ctx, v)
    return _gumbel_field(key, _rows(ctx, batch, b, lg.device),
                         torch.arange(start, start + v, device=lg.device))


def shard_sample(ctx, batch: int, temperature: float):
    """Temperature sampler → ``fn(logits, key: int) -> (B,) int64``.

    Gumbel-max: argmax(logits/T + Gumbel) is an exact softmax(logits/T)
    sample, and on a mesh it inherits ``shard_argmax``'s O(B)-byte winner
    reduce.  The noise is keyed on (key, global row, global vocab index),
    so the stream is the same on any mesh and off it.
    ``temperature <= 0`` degrades to greedy (``shard_argmax``) with the
    same (lg, key) signature, so callers never branch.
    """
    if temperature <= 0:
        base = shard_argmax(ctx, batch)
        return lambda lg, key: base(lg)

    def sample(lg, key):
        z = lg.to(torch.float32) / temperature + _field_for(ctx, batch, lg,
                                                            key)
        if ctx is None:
            return torch.argmax(z, dim=-1)
        return _local_argmax(ctx, z)
    return sample


def _topp_keep(z: torch.Tensor, vocab: int, p: float, *,
               axis=None) -> torch.Tensor:
    """Top-p nucleus selection over the scores ``z`` (B, v) = logits/T →
    the (B, v) bool keep mask of the smallest set of highest-probability
    tokens with mass >= p, in integer arithmetic after one ``exp``:

      1. weights w = round(exp(z − max) · 2^14) per token (the global max:
         a max-reduce of the blocks' maxima is exact);
      2. a 2^14+1-bin weighted histogram per row (``scatter_add_``; summed
         over the model axis, an integer sum in any order) gives the mass
         above any threshold without a sort;
      3. the threshold q* = max{q : mass(w >= q) >= target}; tokens with
         w > q* are all kept, and the remaining deficit is covered by the
         first ``n_tie`` threshold-weight tokens in GLOBAL vocab order —
         each rank learns how many come before its block from the
         gathered tie counts.

    ``axis``: None off the mesh, else the mesh context whose model axis
    ``z``'s vocab is sharded over (``z`` the rank's block, ``vocab`` the
    whole extent).  q* >= 1 always (bin 0 carries no mass, and the target,
    ceil(p·total) clamped to [1, total], is met at q = 1).  p -> 1 keeps
    every token with w >= 1: tokens below the 2^-14 floor are dropped even
    at p = 1.0.
    """
    ctx = axis
    b, v = z.shape
    gmax = torch.amax(z, dim=-1)
    if ctx is not None:
        gmax = ctx.all_reduce(gmax, "model", "max")
    w = torch.round(torch.exp(z - gmax[:, None]) * _TOPP_SCALE
                    ).to(torch.int64)
    total = w.sum(dim=-1)
    hist = torch.zeros(b, _TOPP_SCALE + 1, dtype=torch.int64,
                       device=z.device).scatter_add_(1, w, w)
    if ctx is not None:
        total = ctx.all_reduce(total, "model")
        hist = ctx.all_reduce(hist, "model")
    tgt = torch.ceil(p * total.to(torch.float32)).to(torch.int64)
    tgt = torch.minimum(torch.clamp(tgt, min=1), total)
    # mass(w >= q) for every threshold q: reversed cumulative histogram
    mass = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1), [1])
    qs = torch.arange(_TOPP_SCALE + 1, dtype=torch.int64, device=z.device)
    qstar = torch.where(mass >= tgt[:, None], qs[None],
                        torch.zeros_like(qs)[None]).amax(dim=1)
    # mass(w > q*) = mass(w >= q* + 1); a zero column past q = 2^14
    above = torch.cat([mass, torch.zeros_like(mass[:, :1])], dim=1)
    m_gt = above.gather(1, (qstar + 1)[:, None])[:, 0]
    need = tgt - m_gt                                  # >= 1 by maximality
    n_tie = torch.div(need + qstar - 1, qstar, rounding_mode="floor")
    is_tie = w == qstar[:, None]
    before = torch.zeros(b, dtype=torch.int64, device=z.device)
    if ctx is not None:
        cnt = is_tie.sum(dim=-1, keepdim=True)
        allc = ctx.all_gather(cnt, "model", dim=1)        # (B, M)
        before = allc[:, :ctx.model_rank].sum(dim=1)
    tie_rank = torch.cumsum(is_tie.to(torch.int64), dim=-1) - is_tie.long()
    return (w > qstar[:, None]) | (
        is_tie & (before[:, None] + tie_rank < n_tie[:, None]))


def shard_top_p(ctx, batch: int, p: float, temperature: float = 1.0):
    """Top-p (nucleus) sampler → ``fn(logits, key: int) -> (B,) int64``:
    ``_topp_keep``'s mask, then Gumbel-max over the survivors (on a mesh,
    the winner reduce of ``shard_sample``).  Everything across ranks is
    integer arithmetic or an exact max, so the kept set and the stream
    are the off-mesh ones.

    ``temperature <= 0`` degrades to greedy with the same (lg, key)
    signature, exactly like ``shard_sample``.
    """
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top-p needs 0 < p <= 1, got {p}")
    if temperature <= 0:
        base = shard_argmax(ctx, batch)
        return lambda lg, key: base(lg)

    def sample(lg, key):
        z = lg.to(torch.float32) / temperature
        vocab = z.shape[-1] * (1 if ctx is None else ctx.model_size)
        keep = _topp_keep(z, vocab, float(p), axis=ctx)
        zk = torch.where(keep, z + _field_for(ctx, batch, lg, key),
                         torch.full_like(z, float("-inf")))
        if ctx is None:
            return torch.argmax(zk, dim=-1)
        return _local_argmax(ctx, zk)
    return sample
