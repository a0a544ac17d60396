"""Packed data (counterpart of `repro.data`, the same exports, loaded lazily:
the port's package `__init__` files import nothing)."""
import importlib

_EXPORTS = {
    "pack_documents": "packing",
    "pack_stats": "packing",
    "quadratic_cost": "packing",
    "SyntheticPackedDataset": "synth",
    "sample_doc_lengths": "synth",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
