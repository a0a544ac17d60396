"""Checkpoint subsystem (counterpart of `repro.checkpoint`, the same layout).

``RestartCostModel`` (the torch-free economics side) imports eagerly; the
tensor save/restore API lives in ``repro_torch.checkpoint.checkpoint``, which
imports torch, and is loaded lazily so the cluster simulator can price
restart-from-checkpoint without dragging an accelerator runtime into the
event loop.
"""
from repro_torch.checkpoint.economics import RestartCostModel  # noqa: F401

_LAZY = ("CheckpointManager", "latest_step", "restore_checkpoint",
         "save_checkpoint")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.checkpoint import checkpoint as _ckpt
        return getattr(_ckpt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
