"""Atomic, manifest-based checkpointing with keep-k GC (port of
``repro/ckpt/checkpoint.py``, its on-disk format unchanged).

Fault-tolerance contract (DESIGN.md §4):
  * atomic: write to ``step_XXXX.tmp/`` then os.replace → a crash mid-write
    can never corrupt the latest checkpoint;
  * manifest.json carries step + pytree structure + a payload checksum, and
    is fsync'd; restore picks the newest checkpoint whose checksum verifies
    (a torn checkpoint silently falls back to the previous one);
  * arrays are stored by logical shape under the reference's flattened
    names (``params/layers/attn/wq/scale``, ``opt/mv/…/0``, ``step``), so a
    checkpoint written by either package restores into the other — the port
    turns its train state into that tree with ``bridge.state_to_tree``;
  * keep-k garbage collection;
  * optional async save (a worker thread serializes the host copy so the
    train loop never blocks on disk).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.to(torch.float32) if x.dtype == torch.bfloat16
                else x).numpy()
    return np.asarray(x)


def _host_tree(tree):
    """A copy of ``tree`` (nested dicts, lists and tuples) with every leaf
    a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        if not tree:
            out[prefix + "__empty__"] = np.zeros(0)
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten_into(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(like)]
        return type(like)(vals) if not hasattr(like, "_fields") \
            else type(like)(*vals)
    return flat[prefix.rstrip("/")]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        host_tree = _host_tree(tree)
        if self.async_save:
            if self._thread is not None:
                self._thread.join()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, extra or {}))
            self._thread.start()
        else:
            self._write(step, host_tree, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, extra: dict):
        flat = _flatten(host_tree)
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        payload = os.path.join(tmp, "arrays.npz")
        np.savez(payload, **{k: v for k, v in flat.items()})
        with open(payload, "rb") as f:
            checksum = zlib.crc32(f.read())
        manifest = {"step": step, "checksum": checksum,
                    "keys": sorted(flat.keys()), "extra": extra}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _verify(self, step: int) -> bool:
        base = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(base, "manifest.json")) as f:
                manifest = json.load(f)
            with open(os.path.join(base, "arrays.npz"), "rb") as f:
                return zlib.crc32(f.read()) == manifest["checksum"]
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def latest_valid_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self._verify(s):
                return s
        return None

    def restore(self, like: Any, step: Optional[int] = None):
        """Returns (tree, manifest_extra) or (None, None) if nothing valid."""
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            return None, None
        base = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = dict(np.load(os.path.join(base, "arrays.npz")))
        tree = _unflatten_into(like, arrays)
        return tree, manifest["extra"] | {"step": manifest["step"]}
