"""Meshes and stage meshes (counterpart of `repro.launch.mesh`).

`make_mesh` builds the `(data, model)` `DeviceMesh` the spmd driver shards
the train state and step over (`parallel.sharding`), over the default
process group's devices: one rank per card under NCCL, or CPU ranks under
gloo.

The pipeline engine builds one `(data, model)` mesh per stage, as the
reference's engine does (`PipelineEngine._mesh_for`). Under a process group
plan device `d` runs on world rank `d % world` (`stage_ranks`), and
`make_stage_mesh` builds the stage's `DeviceMesh` over those ranks: a
stage's TP degree is then computed by that many ranks. A stage that maps
two plan devices onto one rank degrades to its first rank, as the
reference's engine on fewer devices than its plan. On one card every plan
device maps onto rank 0, so every stage runs on the same one-rank (1, 1)
mesh. Without a process group the engine keeps the device-list form
(`stage_devices`): plan device `d` runs on `devices[d % len(devices)]`,
and a stage runs whole on the first device of its group.
"""
from __future__ import annotations

import torch


def make_mesh(shape, axes=("data", "model")):
    """A `DeviceMesh` of `shape` named `axes` over every rank of the default
    process group (which must be initialised), on its device type: CUDA
    under NCCL, else the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(dist), tuple(shape), mesh_dim_names=tuple(axes))


def _device_type(dist):
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def default_devices():
    """Every visible card (`cuda:0` where none is visible, so that the first
    allocation raises: there is no fallback to the CPU)."""
    return [torch.device("cuda", i) for i in range(max(torch.cuda.device_count(), 1))]


def canonical(device) -> torch.device:
    """`device` with its index (`cuda` is the current card), so that two
    names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def stage_devices(devices):
    """The device group of one pipeline stage from an explicit device list
    (repeats allowed): its unique devices, in order. Without a process
    group the stage runs on the first."""
    return list(dict.fromkeys(canonical(d) for d in devices))


def stage_ranks(plan_devices, world) -> tuple:
    """The world ranks of one pipeline stage: plan device `d` runs on rank
    `d % world`; a stage that maps two plan devices onto one rank degrades
    to its first rank (the reference's `uniq[:1]`)."""
    ranks = [d % world for d in plan_devices]
    uniq = list(dict.fromkeys(ranks))
    return tuple(ranks if len(uniq) == len(ranks) else uniq[:1])


def make_stage_mesh(ranks, dp, tp):
    """The `(data, model)` `DeviceMesh` of shape `(dp, tp)` of one pipeline
    stage over `ranks` of the default process group. Making one is
    collective: every rank of the world makes every stage's mesh, in the
    same order, whether it is a member or not (each mesh dim's groups are
    `new_group`s of the whole world)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = [int(r) for r in ranks]
    if len(ranks) != dp * tp:
        raise ValueError(f"{len(ranks)} ranks for a ({dp}, {tp}) stage mesh")
    return DeviceMesh(_device_type(dist), torch.tensor(ranks).view(dp, tp),
                      mesh_dim_names=("data", "model"))
