"""Samplers over decode logits (port of ``repro/dist/sampling.py``, off the
mesh: ``shard_argmax``, ``shard_argmax_masked``, ``shard_sample``,
``shard_top_p``, ``shard_topk`` and ``_topp_keep``).

The reference builds shard-local samplers over vocab-sharded logits; with
no mesh (``ctx is None``) they are plain reductions over the whole row,
which is all the port has yet.  Passing a mesh context raises.

  * ``shard_argmax`` / ``shard_argmax_masked`` — greedy; ties resolve to
    the lowest index.
  * ``shard_topk`` — the k largest, ties to the lower index (a stable
    descending sort: ``torch.topk`` promises no tie order).
  * ``shard_sample`` — temperature sampling by the Gumbel-max trick:
    argmax(logits/T + g) samples softmax(logits/T) exactly.
  * ``shard_top_p`` — nucleus sampling: ``_topp_keep``'s integer keep mask,
    then Gumbel-max over the kept tokens.

The Gumbel field ``g`` is a counter-based integer hash of (key, global
row, global vocab index) on int64 tensors, so any slice of it is the same
slice of the whole field — what a vocab- or batch-sharded sampler needs to
draw the same stream on any layout.  ``key`` is a Python ``int``.  The
reference draws its field from threefry; the port does not reproduce
those draws, only their distribution.
"""
from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1
# top-p fixed-point resolution: softmax weights are integers in [0, 2^14],
# so every reduction in the nucleus selection is integer arithmetic
_TOPP_SCALE = 1 << 14


def _off_mesh(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "sharded sampling over a device mesh is not ported yet "
            "(pass ctx=None)")


def shard_argmax(ctx, batch: int):
    """Greedy sampler → ``fn(logits (B, V)) -> (B,) int64`` token ids; ties
    resolve to the lowest index, as the reference's."""
    _off_mesh(ctx)
    return lambda lg: torch.argmax(lg, dim=-1)


def shard_argmax_masked(ctx, batch: int, fill: int = 0):
    """Active-mask-aware greedy sampler for the slot pool →
    ``fn(logits (B, V), active (B,) bool) -> (B,) int64``.  Free slots
    still flow through the decode step (the batch is the fixed pool), but
    their logits are garbage: the mask pins their sample to ``fill``."""
    base = shard_argmax(ctx, batch)

    def sample(lg, active):
        return base(lg).masked_fill(~active, fill)
    return sample


def shard_topk(ctx, batch: int, k: int):
    """Top-k → ``fn(logits (B, V)) -> ((B, k) values, (B, k) int64
    indices)``, ties to the lower index (as ``jax.lax.top_k``)."""
    _off_mesh(ctx)

    def dense(lg):
        vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    return dense


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


def _field_for(lg: torch.Tensor, key: int) -> torch.Tensor:
    b, v = lg.shape
    dev = lg.device
    return _gumbel_field(key, torch.arange(b, device=dev),
                         torch.arange(v, device=dev))


def shard_sample(ctx, batch: int, temperature: float):
    """Temperature sampler → ``fn(logits (B, V), key: int) -> (B,) int64``.

    Gumbel-max: argmax(logits/T + Gumbel) is an exact softmax(logits/T)
    sample.  ``temperature <= 0`` degrades to greedy (``shard_argmax``)
    with the same (lg, key) signature, so callers never branch.
    """
    _off_mesh(ctx)
    if temperature <= 0:
        base = shard_argmax(ctx, batch)
        return lambda lg, key: base(lg)

    def dense(lg, key):
        z = lg.to(torch.float32) / temperature + _field_for(lg, key)
        return torch.argmax(z, dim=-1)
    return dense


def _topp_keep(z: torch.Tensor, vocab: int, p: float, *,
               axis=None) -> torch.Tensor:
    """Top-p nucleus selection over the scores ``z`` (B, V) = logits/T →
    the (B, V) bool keep mask of the smallest set of highest-probability
    tokens with mass >= p, in integer arithmetic after one ``exp``:

      1. weights w = round(exp(z − max) · 2^14) per token;
      2. a 2^14+1-bin weighted histogram per row (``scatter_add_``) gives
         the mass above any threshold without a sort;
      3. the threshold q* = max{q : mass(w >= q) >= target}; tokens with
         w > q* are all kept, and the remaining deficit is covered by the
         first ``n_tie`` threshold-weight tokens in vocab order.

    q* >= 1 always (bin 0 carries no mass, and the target, ceil(p·total)
    clamped to [1, total], is met at q = 1).  p -> 1 keeps every token with
    w >= 1: tokens below the 2^-14 floor are dropped even at p = 1.0.
    Off the mesh only (``axis`` must be None).
    """
    if axis is not None:
        _off_mesh(axis)
    b, v = z.shape
    gmax = torch.amax(z, dim=-1)
    w = torch.round(torch.exp(z - gmax[:, None]) * _TOPP_SCALE
                    ).to(torch.int64)
    total = w.sum(dim=-1)
    hist = torch.zeros(b, _TOPP_SCALE + 1, dtype=torch.int64,
                       device=z.device).scatter_add_(1, w, w)
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
    tie_rank = torch.cumsum(is_tie.to(torch.int64), dim=-1) - is_tie.long()
    return (w > qstar[:, None]) | (is_tie & (tie_rank < n_tie[:, None]))


def shard_top_p(ctx, batch: int, p: float, temperature: float = 1.0):
    """Top-p (nucleus) sampler → ``fn(logits (B, V), key: int) -> (B,)
    int64``: ``_topp_keep``'s mask, then Gumbel-max over the survivors.

    ``temperature <= 0`` degrades to greedy with the same (lg, key)
    signature, exactly like ``shard_sample``.
    """
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top-p needs 0 < p <= 1, got {p}")
    _off_mesh(ctx)
    if temperature <= 0:
        base = shard_argmax(ctx, batch)
        return lambda lg, key: base(lg)

    def dense(lg, key):
        z = lg.to(torch.float32) / temperature
        keep = _topp_keep(z, z.shape[-1], float(p))
        zk = torch.where(keep, z + _field_for(lg, key),
                         torch.full_like(z, float("-inf")))
        return torch.argmax(zk, dim=-1)
    return dense
