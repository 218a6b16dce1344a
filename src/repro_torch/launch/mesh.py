"""Device meshes: the production 16x16 and 2x16x16 and a debug mesh.

Port of ``repro/launch/mesh.py`` on ``torch.distributed``'s
``DeviceMesh``, with dims ``("data", "model")`` or ``("pod", "data",
"model")``.  A mesh is laid over the ranks of the current process group:
``make_debug_mesh`` starts a one-process group when none exists (NCCL on
``cuda``, gloo on ``cpu``), and ``init_fake_world(n)`` starts a fake
``n``-rank group for dry runs, the counterpart of the reference's
``--xla_force_host_platform_device_count`` (``repro/launch/dryrun.py:1-2``):
every collective on it returns at once and moves nothing.
"""
from __future__ import annotations

import datetime
import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.api import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
DEBUG_TIMEOUT_S = 120    # make_debug_mesh's one-process group


def init_fake_world(n: int, rank: int = 0) -> None:
    """A fake process group of ``n`` ranks, this process being ``rank``:
    meshes and DTensors of any size build on one host, and collectives
    do nothing.  Raises if a process group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; "
                           "destroy_world() it first")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def destroy_world() -> None:
    """Destroy the current process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape: Sequence[int], names: Tuple[str, ...], dev: torch.device):
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    dims = "x".join(map(str, shape))
    if not dist.is_initialized():
        raise RuntimeError(f"a {dims} mesh needs {need} ranks and no process "
                           f"group exists: call init_fake_world({need}) for "
                           f"a dry run")
    have = dist.get_world_size()
    if need > have:
        raise ValueError(f"a {dims} mesh needs {need} ranks; the world has "
                         f"{have}: {need - have} missing")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, *, device: Any = None):
    """The 16x16 ``(data, model)`` mesh, or with ``multi_pod`` the
    2x16x16 ``(pod, data, model)`` one, over the current process group
    (``init_fake_world(256)`` / ``(512)`` on one host)."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(shape, names, resolve_device(device))


def make_debug_mesh(data: int = 1, model: int = 1, *, device: Any = None):
    """A ``data x model`` mesh on ``device`` (``cuda`` unless given),
    starting a one-process group (NCCL on ``cuda``, gloo on ``cpu``) when
    none exists.  The group's timeout is DEBUG_TIMEOUT_S: one process
    waits on no peer, so a collective still running then has hung, and
    raises instead of holding the caller."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=DEBUG_TIMEOUT_S))
    return _mesh((data, model), ("data", "model"), dev)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh dim name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axis names of a mesh (pod is pure DP)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
