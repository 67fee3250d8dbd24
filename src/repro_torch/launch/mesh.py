"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module constants: importing this module makes no process
group and no mesh.  The reference's production shapes are TPU pods,
(16, 16) and (2, 16, 16) with a leading ``pod`` axis; the port keeps the
shapes as data (``production_shape``) and builds only 2-D ``(data,
model)`` meshes over the ranks ``torch.distributed`` already joined
(``dist/backend.py``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import backend, context


def production_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape, device_type: str):
    """A ``DeviceMesh`` of ``shape`` with the axes ``("data", "model")``
    over the joined ranks (their count must be the shape's product)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"the port's mesh is 2-D (data, model), got shape "
                         f"{shape}")
    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} ranks, "
                         f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=context.AXES)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device=None) -> context.MeshContext:
    """The context of a small (n_data, n_model) mesh over the joined ranks,
    on ``device``: by default the rank's own (``backend.device()``, where
    ``backend.init`` placed it; the CPU only when it is asked for)."""
    dev = backend.device(device)
    return context.make_ctx(make_mesh((n_data, n_model), dev.type),
                            device=dev)
