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
