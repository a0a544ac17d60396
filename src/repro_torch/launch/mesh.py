"""Meshes and stage device groups (counterpart of `repro.launch.mesh`).

`make_mesh` builds the `(data, model)` `DeviceMesh` the spmd driver shards
the train state and step over (`parallel.sharding`), over the default
process group's devices: one rank per card under NCCL, or CPU ranks under
gloo.

The reference also builds a (data, model) mesh per pipeline stage. The
port's counterpart there is the stage's device group, a list of
`torch.device`: plan device `d` runs on `devices[d % len(devices)]`, and a
group that maps two plan devices onto one card degrades to its unique
devices, as the reference's engine does on fewer devices than its plan
(`PipelineEngine._mesh_for`). On one card every stage runs whole on that
card and TP is emulated; sharding a stage across cards (per-stage meshes
and policies) is not ported yet.
"""
from __future__ import annotations

import torch


def make_mesh(shape, axes=("data", "model")):
    """A `DeviceMesh` of `shape` named `axes` over every rank of the default
    process group (which must be initialised), on its device type: CUDA
    under NCCL, else the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


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


def make_stage_mesh(devices, dp, tp):
    """The device group of one pipeline stage from an explicit device list
    (dp * tp entries, repeats allowed), degraded to its unique devices."""
    devices = [canonical(d) for d in devices]
    if len(devices) != dp * tp:
        raise ValueError(f"{len(devices)} devices for a ({dp}, {tp}) stage mesh")
    return list(dict.fromkeys(devices))
