"""Production meshes, and the fake world the dry run lowers against.

Port of ``src/repro/launch/mesh.py``. Single-pod: 16×16 = 256 ranks
("data", "model"); multi-pod: 2×16×16 = 512 ranks ("pod", "data",
"model"), the pod axis data-parallel across the inter-pod links.

What changed: a mesh is ``torch.distributed``'s ``DeviceMesh``
(``init_device_mesh``), which needs a process group of as many ranks as
the mesh has. ``init_fake_world(n)`` is the counterpart of the
reference's ``launch/dryrun.force_host_devices`` (512 host devices for
XLA): it starts the ``"fake"`` process group (``FakeStore``) with world
size ``n`` and this process as rank 0, so a 256- or 512-rank mesh exists
in one process, every collective returns at once without moving data,
and the dry run sees rank 0's shards. ``destroy_world`` ends it (or any
other default group). Only entry points (``main()``) and tests call
them, never an import: importing stays free of process-group state, as
the reference's ordering rule asks. The mesh's device type is
``"cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import cuda

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    return "cpu" if cuda.resolve_device(device) == "cpu" else "cuda"


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The 16×16 ("data", "model") mesh, or 2×16×16 ("pod", "data",
    "model") with ``multi_pod``. Needs a world of 256 or 512 ranks
    (``init_fake_world``)."""
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """1×1 ("data", "model") mesh on the local device: a world of one
    rank."""
    return init_device_mesh(_device_type(device), (1, 1),
                            mesh_dim_names=("data", "model"))


def init_fake_world(n: int = 512) -> None:
    """Start the ``"fake"`` process group with world size ``n``, this
    process rank 0. Raises ``RuntimeError`` if a default group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; "
                           "destroy_world() first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def destroy_world() -> None:
    """End the default process group (fake or real), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
