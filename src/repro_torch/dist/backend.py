"""The process prologue of a mesh run (port of ``repro/dist/backend.py``).

The reference pins a JAX platform and fakes host devices before its
backend starts.  The port runs one process a mesh rank over
``torch.distributed``, and this module is that prologue:

  * ``choose(device, world)`` — the backend rule, explicit:
      - ``cpu``: gloo, every rank on the CPU;
      - ``cuda`` with a card for every rank: NCCL, rank r on ``cuda:r``;
      - ``cuda`` with fewer cards than ranks: gloo, every rank on
        ``cuda:0`` (NCCL refuses two ranks on one device).  The rank's
        tensors stay on the card; no rank is moved to the CPU.
  * ``init(rank, world, device, port)`` — ``init_process_group`` at
    ``tcp://localhost:<port>`` with the rule's backend, the rank's device
    made current and kept (``device()``).
  * ``device(device=None)`` — the rank's device: ``device`` where given,
    else where ``init`` placed the rank, else the current card; never the
    CPU unless asked.
  * ``spawn(fn, world, device, *args)`` — start ``world`` ranks
    (``torch.multiprocessing``, start method ``spawn``), each running
    ``fn(rank, *args)`` after ``init``; a rank that raises fails the call.
  * ``summary()`` — platform, world, backend and devices of this process.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Dict, Optional, Tuple

import torch

PLATFORMS = ("cpu", "cuda")

# the device ``init`` placed this process's rank on
_rank_device: Optional[torch.device] = None


def choose(device, world: int) -> Tuple[str, Callable[[int], torch.device]]:
    """(backend, rank → device) for ``world`` ranks on ``device``'s type."""
    dev = torch.device(device)
    if dev.type not in PLATFORMS:
        raise ValueError(f"unknown platform {dev.type!r} "
                         f"(know: {', '.join(PLATFORMS)})")
    if world < 1:
        raise ValueError(f"world size {world} must be >= 1")
    if dev.type == "cpu":
        return "gloo", lambda rank: torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device")
    if torch.cuda.device_count() >= world:
        return "nccl", lambda rank: torch.device("cuda", rank)
    return "gloo", lambda rank: torch.device("cuda", 0)


def describe(device, world: int) -> str:
    """One line saying what the rule picks, printed by the launchers."""
    backend, place = choose(device, world)
    devs = sorted({str(place(r)) for r in range(world)})
    shared = " (ranks share the card)" if (backend == "gloo"
                                           and devs != ["cpu"]) else ""
    return f"{world} ranks over {backend} on {', '.join(devs)}{shared}"


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, device, port: int) -> torch.device:
    """Join the process group as ``rank`` of ``world``; returns the rank's
    device (made current on CUDA)."""
    import torch.distributed as dist
    backend, place = choose(device, world)
    dev = place(rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    global _rank_device
    _rank_device = dev
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, **kw)
    return dev


def device(device=None) -> torch.device:
    """``device`` with its card index, or the rank's own: where ``init``
    placed it, else the current card (raising where there is none, as the
    port's entry points do: never the CPU unless it is asked for)."""
    from repro_torch.device import resolve
    if device is None and _rank_device is not None:
        return _rank_device
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _entry(rank: int, fn, world: int, device, port: int, threads, args):
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    init(rank, world, device, port)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device, *args,
          threads: Optional[int] = None) -> None:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks over the rule's
    backend on ``device``'s type, and wait for all of them.  ``fn`` must be
    importable by module name (the ``spawn`` start method pickles it by
    reference).  ``threads`` pins each rank's intra-op threads."""
    import torch.multiprocessing as mp
    choose(device, world)                    # refuse early, in the parent
    mp.start_processes(_entry, args=(fn, world, str(device), free_port(),
                                     threads, args),
                       nprocs=world, join=True, start_method="spawn")


def summary() -> Dict:
    """What this process got: platform, world, rank, backend, its device
    and the cards it can see."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {"platform": "cuda" if cuda else "cpu",
            "world": dist.get_world_size() if up else 1,
            "rank": dist.get_rank() if up else 0,
            "backend": dist.get_backend() if up else None,
            "device": str(_rank_device) if _rank_device is not None
            else f"cuda:{torch.cuda.current_device()}" if cuda else "cpu",
            "visible_cards": torch.cuda.device_count() if cuda else 0,
            "pid": os.getpid()}
