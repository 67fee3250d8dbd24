"""Deterministic, sharded, RESUMABLE data pipeline (copy of
``repro/data/pipeline.py``: the port imports nothing of the reference).

Batches are a pure function of (corpus, step, host_shard) — no iterator
state to checkpoint beyond the step counter, which is already in the train
state.  That is the exact-resume story: restore step k → the next batch is
bit-identical to what a never-crashed run would have seen (tested in
tests/test_torch_train.py).  Multi-host: each host slices its batch rows by
(host_id, host_count); under pjit the global batch is formed with
make_array_from_process_local_data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PackedLM:
    """Next-token-prediction batches packed from a token stream."""

    tokens: np.ndarray          # (N,) int32
    batch_size: int             # GLOBAL batch
    seq_len: int
    host_id: int = 0
    host_count: int = 1
    seed: int = 0

    @property
    def windows(self) -> int:
        return (len(self.tokens) - 1) // self.seq_len

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.windows)

    def batch_at(self, step: int) -> dict:
        """Global batch for `step`, sliced to this host's rows."""
        per_epoch = max(self.windows // self.batch_size, 1)
        epoch, off = divmod(step, per_epoch)
        perm = self._perm(epoch)
        idx = perm[(off * self.batch_size + np.arange(self.batch_size))
                   % self.windows]
        rows = self.batch_size // self.host_count
        mine = idx[self.host_id * rows:(self.host_id + 1) * rows]
        starts = mine * self.seq_len
        tok = np.stack([self.tokens[s:s + self.seq_len] for s in starts])
        lab = np.stack([self.tokens[s + 1:s + self.seq_len + 1] for s in starts])
        return {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def eval_batches(tokens: np.ndarray, batch_size: int, seq_len: int):
    """Sequential non-overlapping eval batches (perplexity protocol)."""
    windows = (len(tokens) - 1) // seq_len
    for i in range(0, windows - batch_size + 1, batch_size):
        starts = (i + np.arange(batch_size)) * seq_len
        tok = np.stack([tokens[s:s + seq_len] for s in starts])
        lab = np.stack([tokens[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32)}


def family_prefix(cfg, rows: int, seed) -> Optional[tuple]:
    """(batch key, (rows, P, d) float32 N(0, 1) array) of a family's
    per-row prefix state (``registry.prefix_rows``), drawn from ``seed``:
    a vlm's image embeddings, an encdec's encoder frames; None for a
    family that takes none.  Both stubs stand for a frontend neither
    package has (the reference's vision tower and log-mel convolutions)."""
    from repro_torch.models import registry
    got = registry.prefix_rows(cfg)
    if got is None:
        return None
    key, p = got
    return key, np.random.default_rng(seed).normal(
        size=(rows, p, cfg.d_model)).astype(np.float32)


def with_prefix(batch: dict, cfg, seed) -> dict:
    """``batch`` with the family's prefix state for its rows
    (``family_prefix``); a family without one gets the batch as it is."""
    got = family_prefix(cfg, len(batch["tokens"]), seed)
    return batch if got is None else {**batch, got[0]: got[1]}


@dataclasses.dataclass(frozen=True)
class Prefixed:
    """A batch source whose step-``s`` batch carries the family's prefix
    state drawn from (``seed``, 0, s): a pure function of the step, so
    every rank of a mesh draws the same global batch and a resumed run the
    same batch as an unbroken one (eval batch i draws from (``seed``, 1,
    i), ``launch.train``)."""

    data: PackedLM
    cfg: object
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        return with_prefix(self.data.batch_at(step), self.cfg,
                           (self.seed, 0, step))
