"""Device meshes (port of ``repro/launch/mesh.py``), over
``torch.distributed.device_mesh``.

Functions, not module constants: importing this module touches no device
and no process group.  The production layouts are ``repro``'s: a single
pod (16, 16) over ("data", "model"), a multi-pod (2, 16, 16) over ("pod",
"data", "model"); DP runs over ("pod", "data"), TP / EP / SP over
"model".  A mesh needs a process group of as many ranks; the caller starts
it (``torch.distributed.init_process_group`` with its own address, world
size and rank), except for ``make_host_mesh``, which starts a one-rank
group in this process (an in-memory store, no network) where none exists.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch.distributed as dist

from ..device import resolve_device

# device type -> (the process group a host mesh was built over, the mesh)
_HOST: Dict[str, Tuple[object, object]] = {}


def _device_type(device) -> str:
    return resolve_device(device).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    running process group (their count must be the product of ``shape``),
    on the card (or ``device``'s type)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device=None):
    """The (n, 1) ("data", "model") mesh of this host's process group (n
    its world size; 1 for one process), on the card, or on the CPU with
    ``device="cpu"``.  Where no process group is running it starts a
    one-rank group (NCCL on the card, gloo on the CPU) over an in-memory
    store.  The mesh is built once a process group and device type."""
    kind = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.group.WORLD
    if kind not in _HOST or _HOST[kind][0] is not world:
        _HOST[kind] = (world, make_mesh((dist.get_world_size(), 1),
                                        ("data", "model"), device=kind))
    return _HOST[kind][1]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 256-rank (16, 16) or 512-rank (2, 16, 16) mesh.  Raises unless
    the running process group has at least that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(f"need {n} ranks for the production mesh, have "
                           f"{have} (start a process group of {n} ranks)")
    return make_mesh(shape, axes, device=device)

