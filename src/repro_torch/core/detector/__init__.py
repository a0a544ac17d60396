"""The Detector (counterpart of `repro.core.detector`, the same exports).

The names load lazily, on first access: the port's package `__init__` files
import nothing, which keeps the reference's cold-import cycle
(`engine.schedules` -> `core.scheduler.migration`) out of the port.
"""
import importlib

_EXPORTS = {
    "MicroBatchTimePredictor": "predictor",
    "PipelineDag": "dag_sim",
    "simulate_pipeline": "dag_sim",
    "BOCPD": "changepoint",
    "CusumDetector": "changepoint",
    "SlopeDriftDetector": "changepoint",
    "HeartbeatMonitor": "heartbeat",
    "Detector": "detector",
    "FailureReport": "detector",
    "FailureHistory": "lifecycle",
    "LifecycleConfig": "lifecycle",
    "LifecycleManager": "lifecycle",
    "RejoinDecision": "lifecycle",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
