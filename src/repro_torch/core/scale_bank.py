"""ScaleBank — one frozen integer backbone, many tasks, each task a set of
scales (port of ``repro/core/scale_bank.py``, off-mesh).

A task set is ``{path: np.ndarray}`` keyed by the reference's key-path
form without a leading slash (``layers/attn/wq/scale``), each leaf stacked
over layers (L, N, G) — (n_groups, n_m, N, G) in a stack two deep
(xlstm, zamba2) — the reference's layout, so npz files and
``tasks[name]`` dicts move between the two packages unchanged.

Three tiers: the device ``ResidentStack`` (the k hottest tasks' scales
stacked (L, T, N, G) for the per-slot-task decode), a bounded host LRU of
deserialized sets, and a lazy index of npz files on disk.  ``switch``
copies one task's scales into the model's live ``Linear.scale``
parameters IN PLACE (the reference returns a new param tree); a resident
row install likewise writes into the stack in place.

On a ``(data, model)`` mesh (``ctx``, ``dist/context.py``) the bank keeps
the whole host sets, and a swap or a row install cuts each rank's block
from them (``dist/sharding.py::local_scales``: column-parallel rows
sliced — a grouped ``wk``/``wv``'s to the KV head the rank shares —,
row-parallel scales whole, an ``experts_ep`` stack's scales narrowed to
the rank's experts; a whisper tree's encoder and decoder leaves alike)
and copies only that into the rank's
shard: no collective.  ``swap_collectives`` and
``ResidentStack.install_collectives`` return the collective record of one
swap or install — the reference's ``swap_hlo`` / ``install_hlo`` scans —,
and it is empty.  ``local_nbytes`` counts a rank's bytes from the shard
shapes.
"""
from __future__ import annotations

import os
import warnings
import zipfile
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core.peqa import layer_index, ref_path, stacked_shape
from repro_torch.dist import sharding

SCALE_KEYS = ("scale", "zero")


def bank_path(name: str) -> str:
    """Module/tensor name → ScaleBank key: ``layers.3.attn.wq.scale`` →
    ``layers/attn/wq/scale`` (``ref_path`` without its leading slash)."""
    return ref_path(name).lstrip("/")


def task_stack_dim(rank: int) -> int:
    """Axis the task dim occupies when stacking a scale leaf of ``rank``:
    just before the trailing (out, G) pair, so (L, N, G) → (L, T, N, G).
    ``stack_scales`` and the row install both route through here."""
    if rank < 2:
        raise ValueError(
            f"scale leaf of rank {rank} cannot carry a task dim: scale "
            f"leaves must end in an (out, G) pair (rank >= 2)")
    return rank - 2


def _scale_params(model: nn.Module, keys: Sequence[str]
                  ) -> Dict[str, List[tuple]]:
    """{bank path: [(layer index or None, parameter), ...] in layer
    order} for every parameter whose leaf name is in ``keys`` (an index is
    a pair in a nested stack, ``core.peqa.layer_index``)."""
    out: Dict[str, List[tuple]] = {}
    for name, p in model.named_parameters():
        path = bank_path(name)
        if path.split("/")[-1] in keys:
            out.setdefault(path, []).append((layer_index(name), p))
    for leaves in out.values():
        leaves.sort(key=lambda e: -1 if e[0] is None else e[0])
    return out


def _tensor(arr) -> torch.Tensor:
    """A host array as a CPU tensor of its own (bank arrays may be
    read-only views)."""
    return torch.from_numpy(np.array(arr, copy=True))


def _stacked_shape(leaves: List[tuple]) -> tuple:
    shape = tuple(leaves[0][1].shape)
    if leaves[0][0] is None:
        return shape
    return (*stacked_shape(i for i, _ in leaves), *shape)


def extract_scales(model: nn.Module, include_zero: bool = False
                   ) -> Dict[str, np.ndarray]:
    """Every quantization scale (the task-specific parameters) as host
    numpy, stacked over layers; zero-points too with ``include_zero``."""
    keys = SCALE_KEYS if include_zero else ("scale",)
    out = {}
    for path, leaves in _scale_params(model, keys).items():
        arrs = [p.detach().cpu().numpy() for _, p in leaves]
        out[path] = arrs[0].copy() if leaves[0][0] is None \
            else np.stack(arrs).reshape(_stacked_shape(leaves))
    return out


@torch.no_grad()
def apply_scales(model: nn.Module, scales: Dict[str, np.ndarray],
                 ctx=None) -> nn.Module:
    """Install a task's scales into the model's live parameters, in place;
    with ``ctx``, the rank's block of them into its shard.  Paths the model
    lacks are ignored; a shape mismatch raises before anything is
    written."""
    if ctx is not None:
        scales = sharding.local_scales(scales, ctx,
                                       sharding.shard_kv_share(model))
    params = _scale_params(model, SCALE_KEYS)
    todo = [(path, arr) for path, arr in scales.items() if path in params]
    for path, arr in todo:
        want = _stacked_shape(params[path])
        if tuple(np.shape(arr)) != want:
            raise ValueError(f"scale shape mismatch at {path}: "
                             f"{tuple(np.shape(arr))} vs {want}")
    for path, arr in todo:
        leaves = params[path]
        src = _tensor(arr).to(leaves[0][1].device)    # one upload per path
        for i, p in leaves:
            p.copy_(src if i is None else src[i])
    return model


def _nest_paths(flat: Dict[str, object]) -> dict:
    """{'a/b/c': arr} → {'a': {'b': {'c': arr}}}."""
    out: dict = {}
    for path, arr in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return out


def _map_nested(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map_nested(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def stack_scales(base: Dict[str, np.ndarray],
                 task_sets: Sequence[Dict[str, np.ndarray]]) -> dict:
    """The task-stacked scale tree the slotted model functions read.

    ``base`` is ``extract_scales(model, include_zero=True)``: the
    backbone's own scale/zero leaves, which fill any path a task set lacks
    (banks store scales only by default, so zero-points ride along
    frozen).  Each leaf gains a task dim just before its (out, G) pair:
    (L, N, G) → (L, T, N, G), so layer i reads the contiguous (T, N, G)
    slice ``leaf[i]``.  Returned nested (the model's module tree pruned to
    scale leaves), host numpy.
    """
    flat = {}
    for path, b in base.items():
        b = np.asarray(b)
        rows = []
        for ts in task_sets:
            a = np.asarray(ts.get(path, b), dtype=b.dtype)
            if a.shape != b.shape:
                raise ValueError(f"scale shape mismatch at {path}: "
                                 f"{a.shape} vs {b.shape}")
            rows.append(a)
        flat[path] = np.stack(rows, axis=task_stack_dim(b.ndim))
    return _nest_paths(flat)


@torch.no_grad()
def _stack_row_install(stack: dict, rows: dict, idx: int) -> None:
    """Write ONE task's scale rows into stack row ``idx``, in place."""
    def upd(dst, src):
        ax = task_stack_dim(src.ndim)   # same axis stack_scales stacked on
        dst.select(ax, idx).copy_(_tensor(src))
    _map_nested(upd, stack, rows)


def swap_collectives(model: nn.Module, scales: Dict[str, np.ndarray], ctx
                     ) -> List[dict]:
    """The collective record of installing ``scales`` into the rank's
    shard ``model`` (the reference's ``swap_hlo``): the swap runs — it
    writes ``scales`` — and its record must be empty."""
    with ctx.recording() as rec:
        apply_scales(model, scales, ctx=ctx)
    return rec


class ResidentStack:
    """Device-resident stacked scale sets for the k hottest serving tasks.

    The drain-free mixed-task decode (``Engine.serve(scheduler=
    "resident")``) reads per-slot scales from ``stack`` — the model's scale
    and zero leaves with a task dim of extent ``capacity`` — instead of the
    live single-task set.  ``names[r]`` maps row r → resident task.  A miss
    evicts the least-recently-used row NOT pinned by an in-flight slot and
    writes the new task's rows in place.  ``ensure`` returns None when every
    row is pinned — the scheduler decodes one step and retries.
    """

    def __init__(self, bank: "ScaleBank", model: nn.Module, capacity: int,
                 warm: Sequence[str] = (), *, device=None, ctx=None):
        if capacity < 1:
            raise ValueError("ResidentStack needs capacity >= 1")
        self.bank = bank
        self.capacity = int(capacity)
        self.device = _device.resolve(device)
        # on a mesh ``model`` is the rank's shard: its leaves, and every row
        # installed, are the rank's blocks of the bank's whole sets
        self.ctx = ctx
        self._kv_share = sharding.shard_kv_share(model)
        # host snapshot NOW: switch_task later overwrites the live scales
        self._base = extract_scales(model, include_zero=True)
        warm = list(warm)
        if len(set(warm)) != len(warm):
            dupes = sorted({w for w in warm if warm.count(w) > 1})
            raise ValueError(
                f"ResidentStack: duplicate warm task(s) {dupes} — a "
                f"duplicated warm name would occupy two rows but only the "
                f"first is ever looked up, leaving a dead row for the "
                f"stack's lifetime")
        unknown = [w for w in warm if w not in bank.tasks]
        if unknown:
            warnings.warn(
                f"ResidentStack: dropping warm task(s) {unknown} not in "
                f"the bank", RuntimeWarning, stacklevel=2)
        warm = [w for w in warm if w in bank.tasks][: self.capacity]
        self.names: List[Optional[str]] = (
            warm + [None] * (self.capacity - len(warm)))
        sets = [self._local(bank.tasks[n]) if n is not None else self._base
                for n in self.names]
        self.stack = _map_nested(lambda a: _tensor(a).to(self.device),
                                 stack_scales(self._base, sets))
        self._lru: List[int] = list(range(self.capacity))  # least-recent first
        self.installs = 0

    def _local(self, scales: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return scales if self.ctx is None \
            else sharding.local_scales(scales, self.ctx, self._kv_share)

    def _rows_for(self, name: str) -> dict:
        task = self._local(self.bank.tasks[name])
        flat = {}
        for path, b in self._base.items():
            a = np.asarray(task.get(path, b), dtype=b.dtype)
            if a.shape != b.shape:
                raise ValueError(f"scale shape mismatch at {path}: "
                                 f"{a.shape} vs {b.shape}")
            flat[path] = a
        return _nest_paths(flat)

    def _touch(self, row: int):
        self._lru.remove(row)
        self._lru.append(row)

    def ensure(self, name: str, pinned: Iterable[str] = ()) -> Optional[int]:
        """Row serving ``name``, installing on a miss (LRU, pin-aware)."""
        if name not in self.bank.tasks:
            raise KeyError(f"no task {name!r}; have {list(self.bank.tasks)}")
        if name in self.names:
            row = self.names.index(name)
            self._touch(row)
            return row
        pinned = set(pinned)
        victim = next((r for r in self._lru if self.names[r] is None), None)
        if victim is None:
            victim = next(
                (r for r in self._lru if self.names[r] not in pinned), None)
        if victim is None:
            return None
        _stack_row_install(self.stack, self._rows_for(name), victim)
        self.names[victim] = name
        self._touch(victim)
        self.installs += 1
        return victim


    def install_collectives(self, name: str) -> List[dict]:
        """The collective record of installing task ``name``'s rows (the
        reference's ``install_hlo``): the install runs into a one-row
        scratch copy of the stack — the stack itself is untouched — and
        its record must be empty."""
        if self.ctx is None:
            raise ValueError("install_collectives needs a mesh context")
        scratch = _map_nested(
            lambda t: t.narrow(task_stack_dim(t.dim() - 1), 0, 1).clone(),
            self.stack)
        with self.ctx.recording() as rec:
            _stack_row_install(scratch, self._rows_for(name), 0)
        return rec


class TaskStoreStats:
    """Cumulative counters for one ``_TaskStore`` (callers snapshot and
    diff).  ``payload_bytes_loaded`` is zero right after ``ScaleBank(root)``
    opens, however many tasks sit on disk."""

    def __init__(self):
        self.host_hits = 0          # __getitem__ served from the host tier
        self.disk_loads = 0         # npz payloads deserialized on demand
        self.host_evictions = 0     # disk-backed sets dropped under pressure
        self.payload_bytes_loaded = 0

    def as_dict(self) -> Dict[str, int]:
        return {"host_hits": self.host_hits, "disk_loads": self.disk_loads,
                "host_evictions": self.host_evictions,
                "payload_bytes_loaded": self.payload_bytes_loaded}


class _TaskStore(MutableMapping):
    """The bank's host LRU over deserialized scale sets, backed by a lazy
    disk index.

    ``in`` / ``len`` / iteration answer from the index (file names scanned
    once at open); ``store[name]`` promotes disk → host, evicting the
    least-recently-used DISK-BACKED set past ``host_capacity``.  Sets
    assigned directly (no backing file) are never evicted.  A file that
    fails to deserialize quarantines THAT task (warning, dropped from the
    index, ``KeyError`` on access); the rest of the bank serves on.
    """

    def __init__(self, root: Optional[str] = None,
                 host_capacity: Optional[int] = None):
        self.root = root
        self.host_capacity = host_capacity
        # host tier, least-recently-used first (move_to_end on touch)
        self._host: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._disk: Dict[str, str] = {}        # name -> npz path
        self.quarantined: Dict[str, str] = {}  # name -> load error
        self.stats = TaskStoreStats()
        if root:
            os.makedirs(root, exist_ok=True)
            for f in sorted(os.listdir(root)):
                if f.endswith(".npz"):
                    self._disk[f[:-4]] = os.path.join(root, f)

    def __contains__(self, name) -> bool:
        return name in self._host or name in self._disk

    def __len__(self) -> int:
        n = len(self._disk)
        return n + sum(1 for k in self._host if k not in self._disk)

    def __iter__(self):
        yield from self._disk
        yield from (k for k in self._host if k not in self._disk)

    def __getitem__(self, name: str) -> Dict[str, np.ndarray]:
        if name in self._host:
            self._host.move_to_end(name)
            self.stats.host_hits += 1
            return self._host[name]
        self.load(name)
        return self._host[name]

    def __setitem__(self, name: str, scales: Dict[str, np.ndarray]):
        self._host[name] = scales
        self._host.move_to_end(name)
        self.quarantined.pop(name, None)
        self._evict()

    def __delitem__(self, name: str):
        found = name in self._host or name in self._disk
        self._host.pop(name, None)
        self._disk.pop(name, None)      # drops the index entry, not the file
        if not found:
            raise KeyError(name)

    def loaded(self, name: str) -> bool:
        """Host-resident (loaded or unbacked) — answers without loading."""
        return name in self._host

    def load(self, name: str) -> None:
        """Promote ``name`` disk → host (no-op when already host-resident).
        A corrupt or unreadable file quarantines the task and raises
        ``KeyError``."""
        if name in self._host:
            return
        if name not in self._disk:
            raise KeyError(name)
        path = self._disk[name]
        try:
            with np.load(path) as z:     # read eagerly, then close the file
                scales = {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            self.quarantined[name] = str(e)
            self._disk.pop(name, None)
            warnings.warn(
                f"ScaleBank: quarantining task {name!r} — corrupt or "
                f"unreadable file {path!r}: {e}", RuntimeWarning,
                stacklevel=2)
            raise KeyError(
                f"task {name!r} quarantined: corrupt or unreadable file "
                f"{path!r}: {e}") from e
        self.stats.disk_loads += 1
        self.stats.payload_bytes_loaded += sum(
            a.nbytes for a in scales.values())
        self._host[name] = scales
        self._host.move_to_end(name)
        self._evict()

    def _evict(self) -> None:
        """Shrink the host tier to ``host_capacity``, LRU-first, skipping
        unbacked sets and the most recent entry."""
        if self.host_capacity is None:
            return
        while len(self._host) > self.host_capacity:
            newest = next(reversed(self._host))
            victim = next((k for k in self._host
                           if k in self._disk and k != newest), None)
            if victim is None:
                return
            del self._host[victim]
            self.stats.host_evictions += 1


class ScaleBank:
    """Tiered per-task scale store: a bounded host cache over a lazy disk
    index (the device tier, ``ResidentStack``, is built on top).

    ``ScaleBank(root)`` scans file names only.  ``bank.tasks`` behaves as a
    dict (``in`` / ``len`` / iteration from the index; ``bank.tasks[name]``
    loads on demand; ``bank.tasks[name] = scales`` injects a set).
    ``host_capacity`` bounds the host tier (``None`` = unbounded).
    """

    def __init__(self, root: Optional[str] = None,
                 host_capacity: Optional[int] = None):
        self.root = root
        self.tasks = _TaskStore(root, host_capacity=host_capacity)

    @property
    def host_capacity(self) -> Optional[int]:
        return self.tasks.host_capacity

    @host_capacity.setter
    def host_capacity(self, cap: Optional[int]):
        self.tasks.host_capacity = cap
        self.tasks._evict()

    @property
    def stats(self) -> TaskStoreStats:
        return self.tasks.stats

    @property
    def quarantined(self) -> Dict[str, str]:
        return self.tasks.quarantined

    def loaded(self, name: str) -> bool:
        """Host-resident already?  Never triggers a load."""
        return self.tasks.loaded(name)

    def prefetch(self, name: str) -> bool:
        """Warm ``name`` disk → host ahead of use.  False (no raise) when it
        is unknown or quarantines on load."""
        try:
            self.tasks.load(name)
        except KeyError:
            return False
        return True

    def warm_all(self) -> int:
        """Load every indexed task (quarantined files are skipped with their
        warning); returns the number of tasks afterwards."""
        for name in list(self.tasks._disk):
            self.prefetch(name)
        return sum(1 for _ in self.tasks)

    def add(self, name: str, model: nn.Module, include_zero: bool = False):
        """Store ``model``'s current scales as task ``name`` (and, with a
        root, write them to ``<root>/<name>.npz`` atomically)."""
        scales = extract_scales(model, include_zero)
        self.tasks[name] = scales
        if self.root:
            path = os.path.join(self.root, f"{name}.npz")
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                # write then rename, so a crash never leaves a torn npz; the
                # open handle keeps savez from appending ".npz" to the name
                with open(tmp, "wb") as f:
                    np.savez(f, **scales)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.tasks._disk[name] = path

    def switch(self, model: nn.Module, name: str, ctx=None) -> nn.Module:
        """Copy task ``name``'s scales into ``model``'s live parameters;
        with ``ctx``, the rank's block of them into its shard."""
        if name not in self.tasks:
            raise KeyError(f"no task {name!r}; have {list(self.tasks)}")
        return apply_scales(model, self.tasks[name], ctx=ctx)

    def nbytes(self, name: str) -> int:
        return sum(a.nbytes for a in self.tasks[name].values())

    def local_nbytes(self, name: str, ctx=None, kv_share: int = 1) -> int:
        """Bytes one rank receives in a swap, from its block's shape: each
        sharded extent over its axes, rounded up (the reference's padded
        shards), a row-parallel scale whole, a KV head that ``kv_share``
        ranks share whole.  With no ctx, ``nbytes``."""
        if ctx is None:
            return self.nbytes(name)
        total = 0
        for path, arr in self.tasks[name].items():
            shape = np.shape(arr)
            spec = sharding.spec_for_path(path, len(shape), kv_share=kv_share)
            total += int(np.prod(sharding.local_shape(
                shape, spec, ctx.axis_sizes))) * np.asarray(arr).itemsize
        return total
