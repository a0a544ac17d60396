"""ParallelPlan: the Scheduler's output and the execution engine's input.

A plan is (DP replicas) x (PP stages) with a per-stage device set (the TP
group), per-stage layer assignment, and a standby-device pool. Heterogeneous
TP degrees across stages/replicas are first-class (paper §6.1), as is an
uneven layer partition (paper §6.2).

Plans are pure data: the cluster simulator executes them analytically, and
the JAX engine realizes them as per-stage meshes + pjit'd step functions.

A copy of `repro.core.scheduler.plan`, kept whole here, since the pipeline
engine runs these plans, without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# Efficiency of a TP group running *nonuniform* shard widths relative to an
# equal-width group of the same aggregate speed: ragged all-reduce segments
# and per-rank kernel-shape divergence cost a few percent (NTP paper,
# arxiv 2504.06095). A system property of the collective implementation, so
# it lives with the plan data and both the planner's estimate and the
# simulator's ground truth default to it.
NTP_EFFICIENCY = 0.92


@dataclass(frozen=True)
class StagePlan:
    devices: tuple  # device ids in this TP group (sorted)
    layers: tuple  # global layer indices assigned to this stage (contiguous)
    # nonuniform TP (NTP): per-device shard widths, aligned with ``devices``.
    # None (the default) = uniform 1/tp shards, the classic Megatron layout.
    shard_fractions: Optional[tuple] = None

    def __post_init__(self):
        fr = self.shard_fractions
        if fr is None:
            return
        if len(fr) != len(self.devices):
            raise ValueError(
                f"shard_fractions needs one width per device: "
                f"{len(fr)} widths for {len(self.devices)} devices")
        if any(f <= 0.0 for f in fr):
            raise ValueError(f"shard_fractions must be positive: {fr}")
        if abs(sum(fr) - 1.0) > 1e-6:
            raise ValueError(f"shard_fractions must sum to 1: sum={sum(fr)!r}")

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def n_layers(self) -> int:
        return len(self.layers)


@dataclass(frozen=True)
class ReplicaPlan:
    stages: tuple  # tuple[StagePlan]

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def devices(self) -> tuple:
        return tuple(d for s in self.stages for d in s.devices)

    def stage_of_layer(self, layer: int) -> int:
        for i, s in enumerate(self.stages):
            if layer in s.layers:
                return i
        raise KeyError(layer)


@dataclass(frozen=True)
class ParallelPlan:
    replicas: tuple  # tuple[ReplicaPlan]
    standby: tuple = ()  # healthy devices kept warm for later swaps (§6.1)
    microbatches: int = 8  # per replica per iteration
    schedule: str = "1f1b"
    # replica -> stage -> dead (all devices failed, workloads must evict)
    dead_stages: tuple = ()  # tuple[(replica, stage)]

    @property
    def dp(self) -> int:
        return len(self.replicas)

    @property
    def devices(self) -> tuple:
        return tuple(d for r in self.replicas for d in r.devices) + tuple(self.standby)

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.replicas[0].stages)

    def stage(self, replica: int, stage: int) -> StagePlan:
        return self.replicas[replica].stages[stage]

    def replace(self, **kw) -> "ParallelPlan":
        return dataclasses.replace(self, **kw)

    def with_stage(self, replica: int, stage: int, new_stage: StagePlan) -> "ParallelPlan":
        reps = list(self.replicas)
        stages = list(reps[replica].stages)
        stages[stage] = new_stage
        reps[replica] = ReplicaPlan(tuple(stages))
        return self.replace(replicas=tuple(reps))

    def summary(self) -> str:
        lines = []
        for r, rep in enumerate(self.replicas):
            cells = [
                f"s{i}:tp{s.tp}xL{s.n_layers}"
                + ("w[" + "/".join(f"{f:.2f}" for f in s.shard_fractions) + "]"
                   if s.shard_fractions is not None else "")
                for i, s in enumerate(rep.stages)
            ]
            lines.append(f"dp{r}[" + " ".join(cells) + "]")
        if self.standby:
            lines.append(f"standby={list(self.standby)}")
        return " ".join(lines)


def initial_plan(n_layers: int, dp: int, pp: int, tp: int, *, device_ids=None,
                 microbatches: int = 8, schedule: str = "1f1b") -> ParallelPlan:
    """The fault-free plan: even layer split, uniform TP, rank-ordered devices
    (TP-contiguous so TP groups stay inside a node, like Megatron rank maps)."""
    if device_ids is None:
        device_ids = list(range(dp * pp * tp))
    assert len(device_ids) == dp * pp * tp
    per = [n_layers // pp + (1 if i < n_layers % pp else 0) for i in range(pp)]
    replicas = []
    it = iter(device_ids)
    for _ in range(dp):
        stages, off = [], 0
        for s in range(pp):
            devs = tuple(next(it) for _ in range(tp))
            layers = tuple(range(sum(per[:s]), sum(per[: s + 1])))
            stages.append(StagePlan(devs, layers))
        replicas.append(ReplicaPlan(tuple(stages)))
    return ParallelPlan(tuple(replicas), microbatches=microbatches, schedule=schedule)
