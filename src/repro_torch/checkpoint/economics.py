"""Checkpoint/restart economics: a deterministic price for the *other*
recovery path.

Live adaptation (replan + TP group rebuild + layer migration) is not always
the cheapest way out of a failure — at fleet scale the baseline trade is
restart-from-checkpoint: tear the job down, relaunch on the surviving (or
re-provisioned) devices, read the last committed checkpoint back, and replay
the lost iterations. :class:`RestartCostModel` prices that path the same way
:class:`~repro_torch.core.scheduler.scheduler.PlanOverheadModel` prices planning —
a small frozen dataclass whose prediction is a pure function of its fields,
so both simulator engines charge identical floats and every sweep cell stays
a pure function of its coordinates.

The model is intentionally torch-free (this module never imports
``repro_torch.checkpoint.checkpoint``, which pulls in torch) so the cluster
simulator can price restarts without dragging an accelerator runtime into
the event loop. :meth:`RestartCostModel.from_manifest` reads a
``repro_torch.checkpoint`` ``MANIFEST.json`` directly and prices the state size
from the recorded per-leaf dtype/shape — the real bytes a restore would
read.

Cost decomposition (seconds)::

    save_cost_s    = state_gb / write_gbps
    restart_cost_s = relaunch_s                      # teardown + scheduler
                   + state_gb / read_gbps            # restore read
                   + lost_work_frac * checkpoint_interval_s   # replayed work

The defaults price a 13B-class state (weights + optimizer moments, ~26 GB)
against aggregate distributed-filesystem bandwidth; with a 20 s checkpoint
cadence they put the restart path at exactly 15 s — above routine
single-failure adaptations (a couple of seconds) but *below* a
mass-repartition that migrates most of the model, which is precisely the
regime where real systems restart instead of adapting.

A copy of `repro.checkpoint.economics`, kept here without importing the
JAX package. It differs in one place: :meth:`RestartCostModel.from_manifest`
prices a ``bfloat16`` leaf at 2 bytes from its own table, since plain numpy
knows that name only once ``ml_dtypes`` is imported.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["RestartCostModel"]

# dtype names plain numpy does not know (the checkpoints write bf16 leaves
# under "bfloat16"), with their bytes per element
_ITEMSIZE = {"bfloat16": 2}


def _itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(dtype) or np.dtype(dtype).itemsize


@dataclass(frozen=True)
class RestartCostModel:
    state_gb: float = 26.0  # total checkpoint payload across all shards
    write_gbps: float = 13.0  # aggregate checkpoint-write bandwidth (GB/s)
    read_gbps: float = 26.0  # aggregate restore-read bandwidth (GB/s)
    relaunch_s: float = 4.0  # teardown + scheduler relaunch + process init
    checkpoint_interval_s: float = 20.0  # commit cadence of the train loop
    lost_work_frac: float = 0.5  # expected replay: half an interval

    def __post_init__(self):
        if self.state_gb < 0:
            raise ValueError("state_gb must be >= 0")
        if self.write_gbps <= 0 or self.read_gbps <= 0:
            raise ValueError("write/read bandwidth must be > 0")
        if self.relaunch_s < 0 or self.checkpoint_interval_s < 0:
            raise ValueError("relaunch_s / checkpoint_interval_s must be >= 0")
        if not (0.0 <= self.lost_work_frac <= 1.0):
            raise ValueError("lost_work_frac must be in [0, 1]")

    # ------------------------------------------------------------- pricing
    def save_cost_s(self) -> float:
        """Seconds one checkpoint commit steals from training."""
        return self.state_gb / self.write_gbps

    def restore_read_s(self) -> float:
        return self.state_gb / self.read_gbps

    def lost_work_s(self) -> float:
        """Expected training progress discarded by rolling back to the last
        committed step (uniform failure time within the commit cadence)."""
        return self.lost_work_frac * self.checkpoint_interval_s

    def restart_cost_s(self) -> float:
        """Total modeled cost of restart-from-checkpoint, in the same units
        ``ResiHPPolicy`` charges live adaptation (seconds of stalled
        session)."""
        return self.relaunch_s + self.restore_read_s() + self.lost_work_s()

    # -------------------------------------------------------- construction
    @classmethod
    def from_manifest(cls, root, *, step: Optional[int] = None,
                      **overrides) -> "RestartCostModel":
        """Price ``state_gb`` from a step directory's ``MANIFEST.json``,
        written by either package's checkpoint (per-leaf dtype × shape —
        the exact bytes a restore reads back). ``step=None`` picks the
        latest *committed* step, same rule as
        ``repro_torch.checkpoint.latest_step`` (COMMIT marker present,
        ``.tmp`` staging dirs ignored)."""
        root = Path(root)
        if step is None:
            steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
                     if (p / "COMMIT").exists() and not p.name.endswith(".tmp")]
            if not steps:
                raise FileNotFoundError(f"no committed checkpoint under {root}")
            step = max(steps)
        manifest = json.loads(
            (root / f"step_{step:09d}" / "MANIFEST.json").read_text())
        n_bytes = sum(_itemsize(leaf["dtype"])
                      * math.prod(leaf["shape"])
                      for leaf in manifest["leaves"])
        return replace(cls(state_gb=n_bytes / 1e9), **overrides)
