"""Progress-aware DP workload migration (paper §6.3, Algorithm 1).

A discrete-event simulator over all DP replicas' pipelines jointly, with an
online migration policy in the loop. Executors are (replica, stage) TP
groups; chunks are F/B/W per micro-batch per stage (the same ChunkId the
Detector's DAG simulator uses). At every completion event the policy runs
Algorithm 1:

  for each stage i:
      P[d][i] = #forward chunks completed by stage i of replica d
      d_min = argmin_d P, d_max = argmax_d P
      if (d_min, i) is fail-stop or P[d_max] - P[d_min] > delta:
          j = NextPending(d_min, i)
          if memory_feasible(j, i, d_max): migrate stage-i of j -> d_max

Migrated chunks keep their data dependencies (with a cross-replica P2P
penalty for the activation/gradient exchange, paper constraint (2)) and run
in the destination executor's *bubbles*: the destination prefers its own
schedule order and picks up migrated work when its next own chunk is not
ready. Memory constraint (3): live activations (F done, B not yet) plus
in-flight migrated forwards must stay under the stage's capacity.

The same engine with different `policy` values implements the baselines:
  'resihp'  — Algorithm 1 (fail-stop eviction + fail-slow balancing);
  'recycle' — ReCycle-style: fail-stop eviction only, round-robin over DP
              peers with no progress awareness (Fig. 6a);
  'none'    — no migration; a dead stage aborts the iteration.

A copy of `repro.core.scheduler.migration`, kept whole here, without
importing the JAX package; `engine_placement` (the port's own) turns a
run's migrations into the placement `engine.pipeline.PipelineEngine`
executes. Its two imports (`ChunkId`, `make_schedule`) reach neither the
scheduler's other modules nor the engine's pipeline, and the port's
package `__init__` files import nothing, so the reference's cold-import
cycle does not carry over.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.engine.schedules import make_schedule

#: Same-timestamp batching window (seconds): events within this epsilon of
#: the batch head are drained and processed as one step before the policy
#: decides — symmetric replicas complete simultaneously, and deciding
#: mid-batch would see phantom progress gaps. Both engines MUST share this
#: constant (the fast engine imports it): a fast engine batching at a
#: different epsilon would split or merge batches differently at timestamp
#: collisions and silently break bit-for-bit parity.
SAME_TIME_EPS = 1e-12


def _budget_error(now: float, heap_size: int, undone: int, total: int,
                  limit: int) -> RuntimeError:
    """Actionable livelock-guard report, shared by both engines: the bare
    'event budget exceeded' left nothing to debug with."""
    return RuntimeError(
        f"migration sim: event budget exceeded (livelock?): "
        f"t={now:.6g}, heap_size={heap_size}, "
        f"undone_chunks={undone}/{total}, budget={limit}")


@dataclass
class MigrationEvent:
    time: float
    chunk: ChunkId
    src: tuple  # (replica, stage)
    dst: tuple
    reason: str  # 'fail-stop' | 'fail-slow'


@dataclass
class SimResult:
    makespan: float
    status: str  # 'ok' | 'aborted'
    finish: dict
    migrations: list
    idle: dict
    per_replica_finish: dict
    detail: str = ""


class ProgressAwareMigrator:
    """One training iteration across DP replicas with online migration."""

    def __init__(
        self,
        *,
        n_stages: int,
        n_replicas: int,
        n_microbatches,  # int or per-replica list
        chunk_cost: Callable,  # (ChunkId, executor) -> seconds (speed-scaled)
        schedule: str = "1f1b",
        dead_executors=(),  # iterable of (replica, stage) that are fail-stop
        policy: str = "resihp",
        delta: int = 0,  # progress-gap threshold (Alg. 1)
        mem_capacity: Optional[int] = None,  # live activations per stage
        p2p_cost: float = 0.0,  # same-replica inter-stage edge seconds
        migrate_edge_cost: float = 0.0,  # extra cross-replica edge seconds
        max_migrations_per_event: int = 4,
        event_budget: Optional[int] = None,  # livelock guard (default 50x chunks)
    ):
        self.n_stages = n_stages
        self.n_replicas = n_replicas
        if isinstance(n_microbatches, int):
            n_microbatches = [n_microbatches] * n_replicas
        self.n_mb = list(n_microbatches)
        self.chunk_cost = chunk_cost
        self.policy = policy
        self.delta = delta
        self.mem_capacity = mem_capacity if mem_capacity is not None else n_stages + 2
        self.p2p_cost = p2p_cost
        self.migrate_edge_cost = migrate_edge_cost
        self.dead = set(dead_executors)
        self.max_migrations_per_event = max_migrations_per_event
        self.event_budget = event_budget

        # build per-replica schedules
        self.own_order: dict = {}
        self.chunks: set = set()
        self.with_w = schedule.lower().startswith("zb")
        for d in range(self.n_replicas):
            sched = make_schedule(schedule, n_stages, self.n_mb[d], replica=d)
            for (rep, st), order in sched.items():
                self.own_order[(rep, st)] = list(order)
                self.chunks.update(order)

        # dynamic state
        self.placement: dict = {}  # ChunkId -> executor (only if migrated)
        self.finish: dict = {}
        self.started: set = set()
        self.done: set = set()
        self.live: dict = {e: 0 for e in self.own_order}  # F done - B done
        self.inflight_migrated_f: dict = {e: 0 for e in self.own_order}
        self.migq: dict = {e: [] for e in self.own_order}
        self.cursor: dict = {e: 0 for e in self.own_order}
        self.busy_until: dict = {e: 0.0 for e in self.own_order}
        self.running: dict = {e: None for e in self.own_order}
        self.migrations: list = []
        self.migrated_away: set = set()
        self._rr = 0  # round-robin pointer for the recycle policy

    # ------------------------------------------------------------- helpers
    def _deps(self, cid: ChunkId):
        deps = []
        if cid.kind == "F":
            if cid.stage > 0:
                deps.append(ChunkId("F", cid.mb, cid.stage - 1, cid.replica))
        elif cid.kind == "B":
            deps.append(ChunkId("F", cid.mb, cid.stage, cid.replica))
            if cid.stage < self.n_stages - 1:
                deps.append(ChunkId("B", cid.mb, cid.stage + 1, cid.replica))
        else:  # W
            deps.append(ChunkId("B", cid.mb, cid.stage, cid.replica))
        return [d for d in deps if d in self.chunks]

    def _executor_of(self, cid: ChunkId):
        return self.placement.get(cid, (cid.replica, cid.stage))

    def _edge_cost(self, dep: ChunkId, cid: ChunkId) -> float:
        e_dep, e_cid = self._executor_of(dep), self._executor_of(cid)
        if e_dep == e_cid:
            return 0.0
        c = self.p2p_cost if dep.stage != cid.stage else 0.0
        if e_dep[0] != e_cid[0]:  # crosses replicas (migration exchange)
            c += self.migrate_edge_cost
        return c

    def _ready_time(self, cid: ChunkId) -> Optional[float]:
        t = 0.0
        for dep in self._deps(cid):
            if dep not in self.finish:
                return None
            t = max(t, self.finish[dep] + self._edge_cost(dep, cid))
        return t

    def _progress(self):
        """P[d][i] = completed F chunks by stage i of replica d (home) plus
        in-flight migrated-away forwards: Alg. 1 'Update P' credits a
        migration to the straggler immediately so the same gap is not
        re-triggered while the chunk is still queued at the destination."""
        P = [[0] * self.n_stages for _ in range(self.n_replicas)]
        for cid in self.done:
            if cid.kind == "F":
                P[cid.replica][cid.stage] += 1
        for cid in self.migrated_away:
            if cid.kind == "F" and cid not in self.done:
                P[cid.replica][cid.stage] += 1
        return P

    def _next_pending(self, d: int, i: int) -> Optional[ChunkId]:
        for cid in self.own_order[(d, i)]:
            if cid.kind != "F":
                continue
            if cid in self.started or cid in self.migrated_away:
                continue
            return cid
        return None

    def _mem_feasible(self, dst) -> bool:
        return (self.live[dst] + self.inflight_migrated_f[dst]) < self.mem_capacity

    def _migrate(self, cid: ChunkId, dst, now: float, reason: str):
        """Move the F chunk and its same-stage B/W companions to `dst`."""
        group = [cid]
        b = ChunkId("B", cid.mb, cid.stage, cid.replica)
        w = ChunkId("W", cid.mb, cid.stage, cid.replica)
        if b in self.chunks:
            group.append(b)
        if w in self.chunks:
            group.append(w)
        src = (cid.replica, cid.stage)
        for g in group:
            if g in self.started:
                return  # too late
        for g in group:
            self.placement[g] = dst
            self.migrated_away.add(g)
            self.migq[dst].append(g)
        self.inflight_migrated_f[dst] += 1
        self.migrations.append(MigrationEvent(now, cid, src, dst, reason))

    # ------------------------------------------------------------- policy
    def _decide(self, now: float):
        if self.policy == "none":
            return
        P = self._progress()
        n_done = 0
        for i in range(self.n_stages):
            if n_done >= self.max_migrations_per_event:
                break
            alive = [d for d in range(self.n_replicas) if (d, i) not in self.dead]
            if not alive:
                continue
            vals = {d: P[d][i] for d in range(self.n_replicas)}
            d_min = min(vals, key=lambda d: (vals[d], d))
            d_max = max(alive, key=lambda d: (vals[d], -d))
            if self.policy == "recycle":
                # fail-stop eviction only, no progress awareness: round-robin
                for d in range(self.n_replicas):
                    if (d, i) in self.dead:
                        j = self._next_pending(d, i)
                        if j is not None and alive:
                            dst = (alive[self._rr % len(alive)], i)
                            self._rr += 1
                            self._migrate(j, dst, now, "fail-stop")
                            n_done += 1
                continue
            # --- resihp (Algorithm 1) ---
            src_dead = (d_min, i) in self.dead
            gap = vals[d_max] - vals[d_min]
            if not src_dead and gap <= self.delta:
                continue
            if d_max == d_min:
                continue
            j = self._next_pending(d_min, i)
            if j is None:
                continue
            dst = (d_max, i)
            if dst in self.dead or not self._mem_feasible(dst):
                continue
            self._migrate(j, dst, now, "fail-stop" if src_dead else "fail-slow")
            n_done += 1

    # --------------------------------------------------------------- sim
    def _dispatch(self, e, now: float, heap, seq):
        if self.running[e] is not None or e in self.dead:
            return seq
        # own schedule order: head = next not-migrated-away chunk
        own = None
        order = self.own_order[e]
        while self.cursor[e] < len(order):
            c = order[self.cursor[e]]
            if c in self.migrated_away or c in self.done:
                self.cursor[e] += 1
                continue
            own = c
            break
        own_ready = self._ready_time(own) if own is not None else None
        # migrated bubble-fill work: first ready chunk whose deps are done
        mig, mig_ready = None, None
        for c in self.migq[e]:
            if c in self.done or c in self.started:
                continue
            r = self._ready_time(c)
            if r is not None and (mig_ready is None or r < mig_ready):
                # W chunks have no urgency; prefer F/B first
                mig, mig_ready = c, r
                if c.kind != "W":
                    break
        cand, ready = None, None
        own_now = own_ready is not None and own_ready <= now
        mig_now = mig_ready is not None and mig_ready <= now
        if own_now and mig_now:
            # both ready: run the older micro-batch first (migrated chunks
            # come from a straggler, so they are behind — Fig. 6b interleaves
            # them into the destination's schedule, not only its bubbles)
            if (mig.mb, 0 if mig.kind == "B" else 1) < (own.mb, 0 if own.kind == "B" else 1):
                cand, ready = mig, mig_ready
            else:
                cand, ready = own, own_ready
        elif own_now:
            cand, ready = own, own_ready
        elif mig_now:
            cand, ready = mig, mig_ready
        elif own_ready is not None or mig_ready is not None:
            # nothing ready *now*: schedule a wake-up at the earliest ready time
            t = min(x for x in (own_ready, mig_ready) if x is not None)
            heapq.heappush(heap, (t, seq, ("wake", e)))
            return seq + 1
        if cand is None:
            return seq
        self.started.add(cand)
        self.running[e] = cand
        dur = self.chunk_cost(cand, e)
        t_end = max(now, ready) + dur
        self.busy_until[e] = t_end
        heapq.heappush(heap, (t_end, seq, ("done", e, cand)))
        return seq + 1

    def run(self) -> SimResult:
        # quick abort check for 'none' policy with dead executors holding work
        if self.policy == "none":
            for e in self.dead:
                if self.own_order.get(e):
                    return SimResult(math.inf, "aborted", {}, [], {}, {},
                                     detail=f"stage {e} is fail-stop and no migration policy")
        heap: list = []
        seq = 0
        self._decide(0.0)
        for e in self.own_order:
            seq = self._dispatch(e, 0.0, heap, seq)
        guard = 0
        limit = (self.event_budget if self.event_budget is not None
                 else 50 * max(1, len(self.chunks)))
        while heap:
            guard += 1
            if guard > limit:
                raise _budget_error(heap[0][0], len(heap),
                                    len(self.chunks) - len(self.done),
                                    len(self.chunks), limit)
            now, _, ev = heapq.heappop(heap)
            # drain all events at (effectively) the same timestamp before
            # deciding: symmetric replicas complete simultaneously, and
            # deciding mid-batch would see phantom progress gaps.
            batch = [ev]
            while heap and heap[0][0] <= now + SAME_TIME_EPS:
                batch.append(heapq.heappop(heap)[2])
            any_done = False
            for ev in batch:
                if ev[0] == "done":
                    _, e, cid = ev
                    self.running[e] = None
                    self.done.add(cid)
                    self.finish[cid] = now
                    if cid.kind == "F":
                        self.live[e] += 1
                        if self.placement.get(cid) is not None:
                            self.inflight_migrated_f[e] -= 1
                    elif cid.kind == "B":
                        self.live[e] -= 1
                    any_done = True
            if any_done:
                self._decide(now)
            for e2 in self.own_order:
                seq = self._dispatch(e2, now, heap, seq)

        if len(self.done) != len(self.chunks):
            missing = [c for c in self.chunks if c not in self.done]
            # dead executors with unmigrated chunks => aborted iteration
            return SimResult(math.inf, "aborted", self.finish, self.migrations,
                             {}, {}, detail=f"{len(missing)} chunks unexecuted, e.g. {missing[:4]}")
        total = max(self.finish.values()) if self.finish else 0.0
        busy = {e: 0.0 for e in self.own_order}
        for cid in self.done:
            e = self._executor_of(cid)
            busy[e] += self.chunk_cost(cid, e)
        idle = {e: total - b for e, b in busy.items()}
        per_replica = {
            d: max(
                (self.finish[c] for c in self.done if c.replica == d),
                default=0.0,
            )
            for d in range(self.n_replicas)
        }
        return SimResult(total, "ok", self.finish, self.migrations, idle, per_replica)


def simulate_iteration(**kw) -> SimResult:
    return ProgressAwareMigrator(**kw).run()


def engine_placement(migrations) -> dict:
    """The placement `PipelineEngine.run_iteration(..., placement=)` executes
    for a run's `migrations` (`SimResult.migrations`): {chunk: executor} for
    each migrated forward chunk and its backward, which `_migrate` moves
    with it. A W companion is left out: the engine folds the weight
    gradient into B."""
    out = {}
    for ev in migrations:
        f = ev.chunk
        out[f] = ev.dst
        out[ChunkId("B", f.mb, f.stage, f.replica)] = ev.dst
    return out
