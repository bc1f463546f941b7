"""Meshes, the counterpart of the JAX package's `repro/launch/mesh.py`.

The sharding rules read a mesh's axis names and sizes only, so a
`MeshSpec` (names and sizes, no processes) stands in for a mesh wherever
no collective runs: `make_production_mesh` gives the 16 x 16 and
2 x 16 x 16 production layouts the rules are checked against.
`make_dry_mesh` builds a `DeviceMesh` of any such layout with this
process as one of its ranks over torch's `fake` backend, whose
collectives move nothing (the dry run, `launch/dryrun.py`).
`make_host_mesh` builds the real one, a `DeviceMesh` over the launched
world (`torchrun`, or any launcher that sets RANK, WORLD_SIZE,
LOCAL_RANK and MASTER_ADDR / MASTER_PORT), with the axes `("data",
"model")` and model innermost: rank = data_index * model_parallel +
model_index, as `jax.make_mesh((n // mp, mp))` orders devices. Nothing
here touches a process group at import time.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch


class MeshSpec(NamedTuple):
    """Axis names and sizes: what the sharding rules read of a mesh."""
    axis_names: tuple
    shape: tuple


def axis_names(mesh) -> tuple:
    """A `MeshSpec`'s or a `DeviceMesh`'s axis names."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_dry_mesh(spec: MeshSpec, rank: int = 0):
    """A `DeviceMesh` of `spec`'s axes and sizes with this process as rank
    `rank` of its world, over the `fake` process-group backend (every
    collective returns at once and moves nothing): one rank of a
    production mesh in one process, its collectives called as they would
    be. Ends the process group this process had started, if any."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in spec.shape:
        n *= s
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    return init_device_mesh("cpu", tuple(spec.shape),
                            mesh_dim_names=tuple(spec.axis_names))


def backend_for(device: torch.device, local_world: int) -> str:
    """`nccl` where every rank of the host has a card of its own, `gloo`
    where ranks share a card or run on the CPU. Decided from the layout
    alone, never after a failure."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: on CUDA the card LOCAL_RANK maps to (ranks
    share the cards round-robin); the CPU as given."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_host_mesh(model_parallel: int = 1, device=None):
    """The ("data", "model") `DeviceMesh` over the launched world, model
    innermost; the world's process group is started here if the caller
    has not started one (backend by `backend_for`). Returns None for a
    single process that no launcher started (no mesh: the one-process
    path) where model_parallel is 1; raises where model_parallel does not
    divide the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device or "cuda")
    if device.type == "cuda":
        # this rank's card, taken before the DeviceMesh would take card
        # LOCAL_RANK (which ranks sharing one card do not have)
        torch.cuda.set_device(rank_device(device))
        torch.cuda.init()
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1 and "MASTER_ADDR" not in os.environ:
            if model_parallel != 1:
                raise ValueError(f"--model-parallel {model_parallel} needs "
                                 f"a world of ranks: launch with torchrun")
            return None
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        backend = backend_for(device, local)
        dist.init_process_group(backend, init_method="env://")
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the world of {n} ranks")
    return init_device_mesh(device.type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))

