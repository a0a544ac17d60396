"""DAG-based analytical pipeline simulator (paper §5.2, Eq. 2).

Chunks (F/B/W per micro-batch per stage) are DAG vertices; edges carry data
dependencies (with P2P cost) and resource ordering (zero cost, fixed by the
schedule). Earliest-start times follow

    t_start(v) = max_{u in pred(v)} ( t_start(u) + T_cost(u) + T_edge(u, v) )

and the healthy iteration time is the critical-path length. The same engine
powers (a) the Detector's workload-aware filter, (b) the Scheduler's
progress-aware migration what-ifs (Alg. 1, step 3 'simulated first'), and
(c) the cluster-scale throughput benchmarks.

Executors are (replica, stage) pairs — so cross-replica migrations (Fig. 6)
are just chunks whose executor differs from their home replica.

A copy of `repro.core.detector.dag_sim`, kept whole here, since the pipeline
engine's schedules key their chunks on `ChunkId`, without importing the JAX
package.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class ChunkId:
    kind: str  # 'F' | 'B' | 'W'
    mb: int  # micro-batch index
    stage: int
    replica: int = 0

    def __repr__(self):
        return f"{self.kind}{self.mb}@s{self.stage}r{self.replica}"


@dataclass
class Chunk:
    cid: ChunkId
    cost: float  # execution seconds on its executor (already speed-scaled)
    deps: list = field(default_factory=list)  # [(ChunkId, edge_cost)]
    executor: tuple = None  # (replica, stage) it runs on


@dataclass
class PipelineDag:
    chunks: dict  # ChunkId -> Chunk
    exec_order: dict  # executor -> [ChunkId] in schedule order

    def simulate(self):
        """Returns (iteration_time, finish_times dict, per-executor idle)."""
        finish: dict = {}
        start: dict = {}
        n_pending_dep = {}
        dependents: dict = {}
        for cid, ch in self.chunks.items():
            n_pending_dep[cid] = 0
            for dep, _ in ch.deps:
                if dep in self.chunks:
                    n_pending_dep[cid] += 1
                    dependents.setdefault(dep, []).append(cid)
        # per-executor cursor: a chunk is runnable when deps done AND it is
        # the next chunk in its executor's order.
        cursor = {e: 0 for e in self.exec_order}
        exec_free = {e: 0.0 for e in self.exec_order}
        done = set()

        def ready(cid):
            e = self.chunks[cid].executor
            order = self.exec_order[e]
            return n_pending_dep[cid] == 0 and order[cursor[e]] == cid

        heap = []
        seq = 0

        def push_ready():
            nonlocal seq
            for e, order in self.exec_order.items():
                if cursor[e] < len(order):
                    cid = order[cursor[e]]
                    if cid not in done and n_pending_dep[cid] == 0:
                        ch = self.chunks[cid]
                        dep_ready = 0.0
                        for dep, edge in ch.deps:
                            if dep in finish:
                                dep_ready = max(dep_ready, finish[dep] + edge)
                        t0 = max(exec_free[e], dep_ready)
                        heapq.heappush(heap, (t0, seq, cid))
                        seq += 1

        push_ready()
        scheduled = set()
        while heap:
            t0, _, cid = heapq.heappop(heap)
            if cid in done:
                continue
            e = self.chunks[cid].executor
            if not ready(cid) or cid in scheduled:
                continue
            ch = self.chunks[cid]
            dep_ready = 0.0
            for dep, edge in ch.deps:
                dep_ready = max(dep_ready, finish[dep] + edge)
            t0 = max(exec_free[e], dep_ready)
            start[cid] = t0
            finish[cid] = t0 + ch.cost
            exec_free[e] = finish[cid]
            done.add(cid)
            cursor[e] += 1
            for d in dependents.get(cid, []):
                n_pending_dep[d] -= 1
            push_ready()

        if len(done) != len(self.chunks):
            missing = [c for c in self.chunks if c not in done][:8]
            raise RuntimeError(f"pipeline deadlock; unexecuted chunks: {missing}")
        total = max(finish.values()) if finish else 0.0
        busy = {e: sum(self.chunks[c].cost for c in order) for e, order in self.exec_order.items()}
        idle = {e: total - b for e, b in busy.items()}
        return total, finish, idle


def build_pipeline_dag(
    *,
    n_stages: int,
    schedule: dict,  # executor (replica, stage) -> ordered [ChunkId]
    chunk_cost: Callable,  # (ChunkId, executor) -> seconds
    p2p_cost: Callable = lambda u, v: 0.0,  # (src ChunkId, dst ChunkId) -> seconds
    placement: Optional[dict] = None,  # ChunkId -> executor override (migration)
) -> PipelineDag:
    """Standard dependency structure:
    F(m,s) <- F(m,s-1); B(m,s) <- B(m,s+1); B(m,last) <- F(m,last);
    B(m,s) <- F(m,s) (same-stage activation availability); W(m,s) <- B(m,s).
    """
    placement = placement or {}
    chunks = {}
    exec_order = {e: list(order) for e, order in schedule.items()}
    for e, order in exec_order.items():
        for cid in order:
            executor = placement.get(cid, e)
            deps = []
            if cid.kind == "F":
                if cid.stage > 0:
                    deps.append(ChunkId("F", cid.mb, cid.stage - 1, cid.replica))
            elif cid.kind == "B":
                deps.append(ChunkId("F", cid.mb, cid.stage, cid.replica))
                if cid.stage < n_stages - 1:
                    deps.append(ChunkId("B", cid.mb, cid.stage + 1, cid.replica))
            elif cid.kind == "W":
                deps.append(ChunkId("B", cid.mb, cid.stage, cid.replica))
            chunks[cid] = Chunk(cid, chunk_cost(cid, executor), [], executor)
            for d in deps:
                chunks[cid].deps.append((d, 0.0))
    # attach P2P costs (data edges between different stages only)
    for cid, ch in chunks.items():
        ch.deps = [
            (d, p2p_cost(d, cid) if (d in chunks and d.stage != cid.stage) else 0.0)
            for d, _ in ch.deps
            if d in chunks
        ]
    return PipelineDag(chunks, exec_order)


def simulate_pipeline(n_stages, n_microbatches, chunk_cost, *, schedule="1f1b",
                      p2p_cost=0.0, replica=0, with_w=None):
    """Convenience: build a single-replica schedule and simulate it."""
    from repro_torch.engine.schedules import make_schedule

    with_w = schedule.startswith("zb") if with_w is None else with_w
    sched = make_schedule(schedule, n_stages, n_microbatches, replica=replica)
    dag = build_pipeline_dag(
        n_stages=n_stages,
        schedule=sched,
        chunk_cost=chunk_cost,
        p2p_cost=(lambda u, v: p2p_cost) if not callable(p2p_cost) else p2p_cost,
    )
    return dag.simulate()
