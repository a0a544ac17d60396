"""Fast execution core for the cluster simulator (the ``engine="fast"`` path).

Semantically exact, asymptotically faster re-implementation of
:class:`repro_torch.core.scheduler.migration.ProgressAwareMigrator` plus a
vectorized chunk-cost table. The reference engine is kept untouched as the
semantic anchor; this module exists purely so that Fig. 14-style sweeps scale
to the 32k/100k-device regime (ROADMAP "Scale" item). Structural wins, none
of which changes observable behaviour:

1. **Targeted dispatch.** The reference engine re-dispatches *every* executor
   after *every* completion batch — O(chunks x executors) work dominated by
   redundant readiness probes (at 256 devices: ~78k dispatch calls per
   iteration for ~1.5k events). Completions can only unblock (a) the executor
   that finished, (b) executors owning a dependent of the finished chunk,
   (c) migration sources/destinations and (d) executors with an explicit
   wake-up — so only those are dispatched. Same starts, same times.
2. **Batched event processing.** Both engines drain every heap entry within
   ``SAME_TIME_EPS`` of the batch head before the policy decides; the
   reference then probes each touched executor through scalar python
   dispatch. Here the dispatch round is *adaptive*: when the touched set is
   large (>= ``VEC_BATCH_MIN`` — symmetric replicas completing in lockstep,
   the t=0 kick-off over every executor, timestamp-collision regimes), the
   whole round flows through array stages over preallocated dense mirrors —
   **build** (the touched set from completers + reverse-dependency owners),
   **ready** (each chunk has at most two dependencies, kept as padded index
   arrays into a dense finish vector where +inf = unfinished, so one masked
   maximum over ``finish[dep] + edge_cost`` computes every candidate's ready
   time at once), **select** (candidate heads advance via a vectorized
   cursor walk; one comparison against ``now`` splits starts from wake-ups;
   durations come from the cost table's batched gather — bit-identical
   divisions) and **commit** (start flags/running slots as scatter-updates).
   Small rounds — the common case under per-device noise, where timestamps
   are almost all distinct — keep the tuned scalar path: python-list state
   with an inlined ready probe. Both paths share *eagerly maintained*
   per-dependency edge costs (placements change only at migration time, so
   the edge-cost terms are refreshed per migration instead of being
   recomputed per readiness probe). Executors holding migrated-in work
   always take the scalar path — the migq scan's W-deferral tie-breaks are
   cheapest to keep exact in python, and migrations are failure-localized.
3. **Incremental Algorithm-1 state.** The reference recomputes the progress
   matrix P from the full ``done`` set on every decide (O(chunks) each, so
   O(chunks^2) per iteration) and scans all stages. Here P is maintained
   incrementally; per-stage min/max are updated in O(1) amortized per F
   completion (counts only ever increment by one, so the stage minimum moves
   by at most one when its last holder leaves), and the decide body runs only
   over stages that can possibly act: the "hot" set (progress gap > delta)
   plus stages with fail-stop executors. Stages outside that set provably
   hit a ``continue`` in the reference loop.
4. **Static-structure cache.** Schedules, the chunk index, dependency and
   reverse-dependency lists (plus their padded-array/CSR forms for the
   batched path) depend only on (schedule, stages, micro-batches, replicas)
   — they are built once and shared across iterations instead of being
   rebuilt from ChunkId dataclasses every ``step()``.

Differences from the reference that are *not* observable through
``TrainingSim``: ``SimResult.idle`` is returned empty (the reference
recomputes every chunk cost at the end of a run just to report idle time;
nothing in the simulator reads it), and the set-iteration order inside the
``detail`` string of an aborted result may differ.

Bit-for-bit parity is enforced by ``tests/test_simulator_golden.py`` (the
fast engine is the default), ``tests/test_engine_parity.py`` (python vs
fast across scenario families and policies, including a ``vec_batch_min=1``
sweep that forces every dispatch round through the array path) and
``tests/test_fastsim_unit.py`` (dispatch fast paths + the
timestamp-collision batching boundary).

A copy of `repro.cluster.fastsim`, kept whole here, without importing the
JAX package; the tests named above are the reference's, and
``tests/test_torch_cluster.py`` holds this copy to it.
"""
from __future__ import annotations

import heapq
import math

import numpy as np

from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.migration import (SAME_TIME_EPS, MigrationEvent,
                                            SimResult, _budget_error)
from repro_torch.core.scheduler.plan import NTP_EFFICIENCY
from repro_torch.engine.schedules import make_schedule

_KIND_F, _KIND_B, _KIND_W = 0, 1, 2
_KIND_INDEX = {"F": _KIND_F, "B": _KIND_B, "W": _KIND_W}

#: Touched-executor-set size at which a dispatch round switches from the
#: scalar python path to the vectorized build/ready/select/commit stages.
#: Array dispatch costs ~a dozen numpy calls per round regardless of size,
#: so it only pays past a handful of executors; under per-device noise most
#: completion batches touch 2-4 executors and stay scalar, while the t=0
#: kick-off (every executor) and synchronized/collision regimes (whole
#: replica rows completing in lockstep) go wide. Tests force the array path
#: everywhere with ``vec_batch_min=1``.
VEC_BATCH_MIN = 12


# ===================================================== static schedule graph
class _Struct:
    """Immutable per-(schedule, stages, n_mb, replicas) execution graph,
    shared across iterations: integer-indexed chunks, per-executor orders
    (list + padded matrix forms), dependency/reverse-dependency lists (plus
    two-slot padded index arrays for the batched path) and F -> B/W
    companion links."""

    __slots__ = (
        "n_stages", "n_replicas", "n_chunks", "executors", "e_replica",
        "e_replica_arr", "orders", "order_mat", "order_len", "cids",
        "kind", "mb", "stage", "replica", "home",
        "kind_arr", "mb_arr", "stage_arr", "replica_arr", "home_arr",
        "deps", "rdeps", "comp_b", "comp_w",
        "dep_a", "dep_b", "dep_a_cross", "dep_b_cross",
        "dcost_by_p2p",
    )

    def __init__(self, schedule: str, n_stages: int, n_mb, n_replicas: int):
        self.n_stages = n_stages
        self.n_replicas = n_replicas
        self.executors = [(d, s) for d in range(n_replicas)
                          for s in range(n_stages)]
        self.e_replica = [d for d, _ in self.executors]
        self.e_replica_arr = np.array(self.e_replica, dtype=np.intp)
        eidx = {e: i for i, e in enumerate(self.executors)}

        cids: list = []
        index: dict = {}
        self.orders = [[] for _ in self.executors]
        for d in range(n_replicas):
            sched = make_schedule(schedule, n_stages, n_mb[d], replica=d)
            for (rep, st), order in sched.items():
                lst = self.orders[eidx[(rep, st)]]
                for cid in order:
                    i = index.get(cid)
                    if i is None:
                        i = index[cid] = len(cids)
                        cids.append(cid)
                    lst.append(i)
        n = self.n_chunks = len(cids)
        self.cids = cids
        self.kind = [_KIND_INDEX[c.kind] for c in cids]
        self.mb = [c.mb for c in cids]
        self.stage = [c.stage for c in cids]
        self.replica = [c.replica for c in cids]
        self.home = [eidx[(c.replica, c.stage)] for c in cids]
        # dense coordinate arrays for the batched cost gathers (built once
        # per cached structure, reused by every migrator instance)
        self.kind_arr = np.array(self.kind, dtype=np.intp)
        self.mb_arr = np.array(self.mb, dtype=np.intp)
        self.stage_arr = np.array(self.stage, dtype=np.intp)
        self.replica_arr = np.array(self.replica, dtype=np.intp)
        self.home_arr = np.array(self.home, dtype=np.intp)

        # per-executor order, padded matrix form for the vectorized cursor
        # walk; pad value = the sentinel chunk n (never done, never migrated)
        max_len = max((len(o) for o in self.orders), default=0)
        self.order_mat = np.full((len(self.executors), max(max_len, 1)), n,
                                 dtype=np.intp)
        self.order_len = np.array([len(o) for o in self.orders],
                                  dtype=np.intp)
        for e, o in enumerate(self.orders):
            if o:
                self.order_mat[e, :len(o)] = o

        # deps mirror ProgressAwareMigrator._deps (filtered to known chunks);
        # the static edge flag records whether the dep crosses stages (p2p)
        self.deps = [[] for _ in cids]
        self.rdeps = [[] for _ in cids]
        self.comp_b = [-1] * n
        self.comp_w = [-1] * n
        for i, c in enumerate(cids):
            if c.kind == "F":
                if c.stage > 0:
                    d = index.get(ChunkId("F", c.mb, c.stage - 1, c.replica))
                    if d is not None:
                        self.deps[i].append((d, True))
                b = index.get(ChunkId("B", c.mb, c.stage, c.replica))
                if b is not None:
                    self.comp_b[i] = b
                w = index.get(ChunkId("W", c.mb, c.stage, c.replica))
                if w is not None:
                    self.comp_w[i] = w
            elif c.kind == "B":
                d = index.get(ChunkId("F", c.mb, c.stage, c.replica))
                if d is not None:
                    self.deps[i].append((d, False))
                if c.stage < n_stages - 1:
                    d = index.get(ChunkId("B", c.mb, c.stage + 1, c.replica))
                    if d is not None:
                        self.deps[i].append((d, True))
            else:  # W
                d = index.get(ChunkId("B", c.mb, c.stage, c.replica))
                if d is not None:
                    self.deps[i].append((d, False))
        for i in range(n):
            for d, _ in self.deps[i]:
                self.rdeps[d].append(i)

        # two-slot padded dep index arrays for the vectorized ready stage
        # (every chunk has at most two deps; empty slots point at the
        # sentinel, whose finish is pinned to 0.0)
        self.dep_a = np.full(n + 1, n, dtype=np.intp)
        self.dep_b = np.full(n + 1, n, dtype=np.intp)
        self.dep_a_cross = np.zeros(n + 1, dtype=bool)
        self.dep_b_cross = np.zeros(n + 1, dtype=bool)
        for i, deps in enumerate(self.deps):
            if deps:
                self.dep_a[i], self.dep_a_cross[i] = deps[0]
                if len(deps) > 1:
                    self.dep_b[i], self.dep_b_cross[i] = deps[1]

        # home-placement (dep, edge cost) lists keyed by p2p charge — the
        # build is O(n) python work identical for every migrator sharing
        # this structure and charge, so instances take a shallow copy
        # (_refresh_edges rebinds outer slots, never mutates the inner
        # lists, making the shared inner lists safe)
        self.dcost_by_p2p: dict = {}


_STRUCT_CACHE: dict = {}
_STRUCT_CACHE_MAX = 64


def _struct_for(schedule: str, n_stages: int, n_mb, n_replicas: int) -> _Struct:
    key = (schedule, n_stages, tuple(n_mb), n_replicas)
    s = _STRUCT_CACHE.get(key)
    if s is None:
        if len(_STRUCT_CACHE) >= _STRUCT_CACHE_MAX:
            _STRUCT_CACHE.clear()
        s = _STRUCT_CACHE[key] = _Struct(schedule, n_stages, n_mb, n_replicas)
    return s


# ============================================================ fast migrator
class FastMigrator:
    """Drop-in replacement for ProgressAwareMigrator (same constructor plus
    ``event_budget``/``vec_batch_min`` knobs, same ``run() -> SimResult``),
    returning identical makespans, migrations, statuses and finish times —
    see the module docstring for what is faster and the two non-observable
    differences."""

    def __init__(
        self,
        *,
        n_stages: int,
        n_replicas: int,
        n_microbatches,
        chunk_cost,
        schedule: str = "1f1b",
        dead_executors=(),
        policy: str = "resihp",
        delta: int = 0,
        mem_capacity=None,
        p2p_cost: float = 0.0,
        migrate_edge_cost: float = 0.0,
        max_migrations_per_event: int = 4,
        event_budget=None,
        vec_batch_min=None,
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
        self._vec_min = VEC_BATCH_MIN if vec_batch_min is None else vec_batch_min

        st = self.st = _struct_for(schedule, n_stages, self.n_mb, n_replicas)
        n = st.n_chunks
        self._dead_e = {d * n_stages + s for (d, s) in self.dead
                        if 0 <= s < n_stages and 0 <= d < n_replicas}
        self._dead_stages = sorted({s for (_, s) in self.dead
                                    if 0 <= s < n_stages})

        # dynamic state — python lists are the primary representation for
        # the scalar path (fastest per-element access); the batched path
        # reads/writes dense numpy mirrors that every scalar mutation keeps
        # in sync (a handful of O(1) stores per event)
        self.placement = [-1] * n  # executor idx, -1 = home
        self.exec_of = list(st.home)
        self.finish = [None] * n
        self.started = [False] * n
        self.done = [False] * n
        self.migrated_away = [False] * n
        self.n_done_chunks = 0
        E = len(st.executors)
        self.live = [0] * E
        self.inflight = [0] * E
        self.migq = [[] for _ in range(E)]
        self.cursor = [0] * E
        self.pend_cursor = [0] * E
        self.running = [None] * E
        self.migrations: list = []
        self._rr = 0
        # numpy mirrors (sentinel slot n where the vectorized gathers index
        # through dep/order pads: never done, never migrated, finished at
        # 0.0 so a missing dep contributes exactly the reference's initial
        # t = 0.0 to the ready maximum)
        self.finish_arr = np.full(n + 1, np.inf)
        self.finish_arr[n] = 0.0
        self.done_np = np.zeros(n + 1, dtype=bool)
        self.migrated_np = np.zeros(n + 1, dtype=bool)
        self.cursor_arr = np.zeros(E, dtype=np.intp)
        self.running_arr = np.full(E, -1, dtype=np.intp)
        self._migq_pending = np.zeros(E, dtype=np.intp)
        # mirror-write journals: the scalar path appends plain python ints
        # here instead of paying a numpy scalar store per event (which costs
        # several times a list append); ``_flush_mirrors`` replays them as
        # bulk fancy-index assignments right before a vectorized round reads
        # the arrays
        self._dirty_done: list = []    # chunk ids newly done ...
        self._dirty_fin: list = []     # ... and their finish times
        self._dirty_mig: list = []     # chunk ids newly migrated away
        self._dirty_cur: list = []     # executors whose cursor moved
        self._dirty_run: list = []     # executors whose running slot changed
        # ready-time memo: once every dependency of a chunk has finished its
        # ready time is immutable (finish times never change, and a finished
        # dep can never migrate, so the edge costs are frozen too) — the one
        # exception is the chunk itself migrating before it starts, which
        # refreshes its edge costs, so _refresh_edges invalidates its slot.
        # This turns the per-dispatch migq rescan from O(pending ready
        # loops) into O(pending memo reads).
        self._ready_memo: list = [None] * n
        # earliest pending wake per executor: a dispatch that cannot start
        # anything skips pushing its wake when an earlier-or-equal one is
        # already in the heap — that wake re-evaluates the executor anyway,
        # and re-arms coverage if it still cannot start (every state change
        # that could move readiness earlier re-dispatches the executor via
        # the touched set, so coverage is never lost)
        self._wake_at: list = [None] * E
        self._alive_e_mask = np.ones(E, dtype=bool)
        for e in self._dead_e:
            self._alive_e_mask[e] = False
        self._all_executors = np.arange(E, dtype=np.intp)
        # eager per-dependency edge costs: placements change only inside
        # _migrate, so the cost term of every dep edge is maintained there
        # (_refresh_edges) instead of being recomputed per readiness probe.
        # At home placement all dep edges are intra-replica, so the cost is
        # the p2p charge iff the edge crosses stages. ``dcost`` is the
        # scalar path's list-of-(dep, cost) form; dep_cost_a/b mirror it per
        # slot for the batched ready gather.
        self.dep_cost_a = np.where(st.dep_a_cross, p2p_cost, 0.0)
        self.dep_cost_b = np.where(st.dep_b_cross, p2p_cost, 0.0)
        dcost0 = st.dcost_by_p2p.get(p2p_cost)
        if dcost0 is None:
            dcost0 = st.dcost_by_p2p[p2p_cost] = [
                [(d, p2p_cost if crosses else 0.0)
                 for d, crosses in st.deps[i]]
                for i in range(n)
            ]
        self.dcost = list(dcost0)
        # home-placement durations, one batched gather per instance: almost
        # every start runs at the chunk's home executor, so the scalar
        # dispatch reads a plain list instead of calling the cost closure
        # per start (the batch gather performs the identical float64
        # divisions, so the values are bit-for-bit the closure's). At home,
        # e_replica(home) == replica and home % S == stage.
        batch = getattr(chunk_cost, "batch", None)
        self._dur_home = None
        if batch is not None:
            self._dur_home = batch(st.kind_arr, st.mb_arr, st.stage_arr,
                                   st.replica_arr, st.replica_arr,
                                   st.stage_arr).tolist()
        # Algorithm-1 progress state: P stored column-major as plain int
        # lists (one list per stage) — at realistic DP widths (tens to a few
        # hundred replicas) C-level list.index()/count() beat numpy column
        # reductions, whose per-call overhead dominates on short columns —
        # plus per-stage min/max maintained incrementally and the hot set
        self._Pcols = [[0] * n_replicas for _ in range(n_stages)]
        self._minval = [0] * n_stages
        self._n_at_min = [n_replicas] * n_stages
        self._hot: set = set()
        self._hot_dirty = True  # invalidates the sorted candidate cache
        self._cand_cache: list = []
        self._max_finish = None
        self._pr_finish = [0.0] * n_replicas
        # static per-stage liveness (self.dead never changes during a run):
        # alive replica list (reference iteration order) and dead-row lists
        # for the masked max
        self._alive_rows = [
            [d for d in range(n_replicas) if (d, s) not in self.dead]
            for s in range(n_stages)
        ]
        self._dead_rows = [
            [d for d in range(n_replicas) if (d, s) in self.dead] or None
            for s in range(n_stages)
        ]
        # incrementally maintained first-occurrence argmax over the *alive*
        # rows of each P column (== the reference's masked-argmax tie-break:
        # dead rows masked below any real count, first index wins). Values
        # only ever increment by one, so every attainment of a new maximum —
        # or of a tie at the current maximum by a lower index — is observed
        # right where it happens, making the maintenance O(1) per update.
        # For stages with no dead rows this equals the plain column argmax.
        self._amax = [rows[0] if rows else 0 for rows in self._alive_rows]
        self._amaxval = [0] * n_stages

    # ------------------------------------------------------------- helpers
    def _executor_of(self, i: int) -> int:
        return self.exec_of[i]

    def _edge_cost(self, d: int, c: int) -> float:
        """Reference ``_edge_cost`` over integer indices: 0 between
        co-located chunks, else the p2p charge iff the dependency crosses
        stages plus the migrate-edge charge iff it crosses replicas."""
        ed, ec = self.exec_of[d], self.exec_of[c]
        if ed == ec:
            return 0.0
        st = self.st
        cost = self.p2p_cost if st.stage[d] != st.stage[c] else 0.0
        if st.e_replica[ed] != st.e_replica[ec]:
            cost += self.migrate_edge_cost
        return cost

    def _refresh_edges(self, group):
        """Recompute the maintained edge costs around chunks whose placement
        just changed: their own dep slots plus every dependent's slot that
        points at them. Called only from ``_migrate`` — edge costs are
        placement functions, and placements change nowhere else.
        ``_edge_cost`` is inlined into the slot loop (migration storms hit
        this path tens of thousands of times per session)."""
        st = self.st
        exec_of, stage, e_replica = self.exec_of, st.stage, st.e_replica
        deps, dcost = st.deps, self.dcost
        dep_cost_a, dep_cost_b = self.dep_cost_a, self.dep_cost_b
        p2p, mig_edge = self.p2p_cost, self.migrate_edge_cost
        seen = set(group)
        for g in group:
            seen.update(st.rdeps[g])
        memo = self._ready_memo
        for i in seen:
            memo[i] = None
            ei = exec_of[i]
            ri, si = e_replica[ei], stage[i]
            dl = []
            for slot, (d, _) in enumerate(deps[i]):
                ed = exec_of[d]
                if ed == ei:
                    c = 0.0
                else:
                    c = p2p if stage[d] != si else 0.0
                    if e_replica[ed] != ri:
                        c += mig_edge
                dl.append((d, c))
                if slot == 0:
                    dep_cost_a[i] = c
                else:
                    dep_cost_b[i] = c
            dcost[i] = dl

    def _ready_time(self, i: int):
        """Max over dependencies of finish + (eagerly maintained) edge cost;
        None while any dependency is unfinished. The batched ready stage
        computes the identical expression for whole candidate arrays."""
        t = 0.0
        finish = self.finish
        for d, c in self.dcost[i]:
            f = finish[d]
            if f is None:
                return None
            f = f + c
            if f > t:
                t = f
        return t

    def _inc_progress(self, d: int, i: int):
        """P[d, i] += 1 with O(1) amortized min/max/hot maintenance (values
        only ever increment, so the minimum can only move up by one when its
        last holder leaves)."""
        col = self._Pcols[i]
        old = col[d]
        new = old + 1
        col[d] = new
        dr = self._dead_rows[i]
        if dr is None or d not in dr:
            if new > self._amaxval[i]:
                self._amaxval[i] = new
                self._amax[i] = d
            elif new == self._amaxval[i] and d < self._amax[i]:
                self._amax[i] = d
        if old == self._minval[i]:
            self._n_at_min[i] -= 1
            if self._n_at_min[i] == 0:
                self._minval[i] = new
                self._n_at_min[i] = col.count(new)
        # hot tracks the *alive* gap: for stages with dead rows the masked
        # maximum is what _decide compares anyway, and those stages sit in
        # the static _dead_stages candidate list regardless of hotness
        hot = self._hot
        if self._amaxval[i] - self._minval[i] > self.delta:
            if i not in hot:
                hot.add(i)
                self._hot_dirty = True
        elif i in hot:
            hot.discard(i)
            self._hot_dirty = True

    def _next_pending(self, d: int, i: int):
        """First F chunk of executor (d, i) neither started nor migrated.
        Entries skipped are permanently ineligible, so the scan cursor is
        monotone (the reference rescans from the start every call)."""
        e = d * self.n_stages + i
        order = self.st.orders[e]
        kind, started, migrated = self.st.kind, self.started, self.migrated_away
        k = self.pend_cursor[e]
        while k < len(order):
            c = order[k]
            if kind[c] == _KIND_F and not started[c] and not migrated[c]:
                self.pend_cursor[e] = k
                return c
            k += 1
        self.pend_cursor[e] = k
        return None

    def _mem_feasible(self, e: int) -> bool:
        return (self.live[e] + self.inflight[e]) < self.mem_capacity

    def _migrate(self, i: int, dst: int, now: float, reason: str, touched):
        st = self.st
        group = [i]
        if st.comp_b[i] >= 0:
            group.append(st.comp_b[i])
        if st.comp_w[i] >= 0:
            group.append(st.comp_w[i])
        for g in group:
            if self.started[g]:
                return
        src_e = st.home[i]
        for g in group:
            self.placement[g] = dst
            self.exec_of[g] = dst
            self.migrated_away[g] = True
            self._dirty_mig.append(g)
            self.migq[dst].append(g)
        self._migq_pending[dst] += len(group)
        self.inflight[dst] += 1
        self.migrations.append(MigrationEvent(
            now, st.cids[i], st.executors[src_e], st.executors[dst], reason))
        self._inc_progress(st.replica[i], st.stage[i])  # Alg. 1 'Update P'
        self._refresh_edges(group)
        touched.add(dst)
        touched.add(src_e)

    # -------------------------------------------------------------- policy
    def _decide(self, now: float, touched):
        if self.policy == "none":
            return
        if self.policy == "recycle":
            cand = self._dead_stages  # recycle only ever evicts fail-stops
            if not cand:
                return
        else:
            # hot-set membership changes orders of magnitude less often than
            # _decide runs (once per completion batch), so the sorted
            # candidate list is cached until _inc_progress flips a stage
            if self._hot_dirty:
                self._cand_cache = sorted(
                    self._hot.union(self._dead_stages)
                    if self._dead_stages else self._hot)
                self._hot_dirty = False
            cand = self._cand_cache
            if not cand:
                return
        S, Pcols = self.n_stages, self._Pcols
        n_done = 0
        for i in cand:
            if n_done >= self.max_migrations_per_event:
                break
            alive = self._alive_rows[i]
            if not alive:
                continue
            if self.policy == "recycle":
                dead_rows = self._dead_rows[i]
                for d in (dead_rows or ()):
                    j = self._next_pending(d, i)
                    if j is not None and alive:
                        dst = alive[self._rr % len(alive)] * S + i
                        self._rr += 1
                        self._migrate(j, dst, now, "fail-stop", touched)
                        n_done += 1
                continue
            # replica-column reductions: list.index() of the incrementally
            # maintained minimum returns the first (= lowest-d) extremum,
            # matching the reference tie-break min(key=(val, d)); the alive
            # argmax (the reference's dead-rows-masked max, first index on
            # ties) is maintained incrementally by _inc_progress
            col = Pcols[i]
            d_min = col.index(self._minval[i])
            d_max = self._amax[i]
            src_dead = (d_min, i) in self.dead
            gap = col[d_max] - col[d_min]
            if not src_dead and gap <= self.delta:
                continue
            if d_max == d_min:
                continue
            j = self._next_pending(d_min, i)
            if j is None:
                continue
            dst = d_max * S + i
            if (d_max, i) in self.dead or not self._mem_feasible(dst):
                continue
            self._migrate(j, dst, now, "fail-stop" if src_dead else "fail-slow",
                          touched)
            n_done += 1

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, e: int, now: float, heap, seq: int) -> int:
        if self.running[e] is not None or e in self._dead_e:
            return seq
        st = self.st
        order = st.orders[e]
        done, migrated, finish = self.done, self.migrated_away, self.finish
        dcost = self.dcost
        cur = self.cursor[e]
        own = None
        n_ord = len(order)
        while cur < n_ord:
            c = order[cur]
            if migrated[c] or done[c]:
                cur += 1
                continue
            own = c
            break
        if cur != self.cursor[e]:
            self.cursor[e] = cur
            self._dirty_cur.append(e)
        # ready times inlined (this is the hottest loop in the engine): max
        # over deps of finish + maintained edge cost, None while unfinished;
        # memoized once complete (see _ready_memo invariant)
        memo = self._ready_memo
        own_ready = None
        if own is not None:
            t = memo[own]
            if t is None:
                t = 0.0
                for d, cst in dcost[own]:
                    f = finish[d]
                    if f is None:
                        t = None
                        break
                    f = f + cst
                    if f > t:
                        t = f
                if t is not None:
                    memo[own] = t
            own_ready = t
        mig, mig_ready = None, None
        started = self.started
        q = self.migq[e]
        if q:
            kind = st.kind
            # scan with in-place compaction: done/started entries can never
            # be selected again, so squeeze them out of the scanned prefix
            # (keeps hot destination executors from rescanning a whole
            # session's worth of retired arrivals every dispatch)
            w = 0
            i = 0
            L = len(q)
            while i < L:
                c = q[i]
                i += 1
                if done[c] or started[c]:
                    continue
                q[w] = c
                w += 1
                r = memo[c]
                if r is None:
                    r = 0.0
                    for d, cst in dcost[c]:
                        f = finish[d]
                        if f is None:
                            r = None
                            break
                        f = f + cst
                        if f > r:
                            r = f
                    if r is not None:
                        memo[c] = r
                if r is not None and (mig_ready is None or r < mig_ready):
                    mig, mig_ready = c, r
                    if kind[c] != _KIND_W:
                        break
            if w != i:
                while i < L:
                    q[w] = q[i]
                    w += 1
                    i += 1
                del q[w:]
        cand, ready, from_mig = None, None, False
        own_now = own_ready is not None and own_ready <= now
        mig_now = mig_ready is not None and mig_ready <= now
        if own_now and mig_now:
            mk = 0 if st.kind[mig] == _KIND_B else 1
            ok = 0 if st.kind[own] == _KIND_B else 1
            if (st.mb[mig], mk) < (st.mb[own], ok):
                cand, ready, from_mig = mig, mig_ready, True
            else:
                cand, ready = own, own_ready
        elif own_now:
            cand, ready = own, own_ready
        elif mig_now:
            cand, ready, from_mig = mig, mig_ready, True
        elif own_ready is not None or mig_ready is not None:
            t = min(x for x in (own_ready, mig_ready) if x is not None)
            wa = self._wake_at
            pending = wa[e]
            if pending is None or t < pending:
                wa[e] = t
                heapq.heappush(heap, (t, seq, 1, e, -1))
                return seq + 1
            return seq
        if cand is None:
            return seq
        started[cand] = True
        self.running[e] = cand
        self._dirty_run.append(e)
        if from_mig:
            self._migq_pending[e] -= 1
        dur_home = self._dur_home
        if dur_home is not None and e == st.home[cand]:
            dur = dur_home[cand]
        else:
            dur = self.chunk_cost(st.cids[cand], st.executors[e])
        t_end = max(now, ready) + dur
        heapq.heappush(heap, (t_end, seq, 0, e, cand))
        return seq + 1

    def _chunk_costs(self, cs: list, es: np.ndarray) -> np.ndarray:
        """Durations for chunk/executor index arrays: the cost table's
        batched gather when available (bit-identical divisions), else one
        scalar call per start (arbitrary user cost callables)."""
        st = self.st
        batch = getattr(self.chunk_cost, "batch", None)
        if batch is not None:
            ci = np.fromiter(cs, dtype=np.intp, count=len(cs))
            return batch(st.kind_arr[ci], st.mb_arr[ci], st.stage_arr[ci],
                         st.replica_arr[ci], st.e_replica_arr[es],
                         es % self.n_stages)
        cost = self.chunk_cost
        return np.array([cost(st.cids[c], st.executors[e])
                         for c, e in zip(cs, es.tolist())])

    def _flush_mirrors(self):
        """Replay the scalar path's journaled mutations into the numpy
        mirrors as bulk fancy-index stores. Called exactly once per
        vectorized round, before any array is read; duplicate indices are
        harmless because every journaled value is re-read from the (always
        current) list state at flush time."""
        dd = self._dirty_done
        if dd:
            idx = np.fromiter(dd, dtype=np.intp, count=len(dd))
            self.done_np[idx] = True
            self.finish_arr[idx] = np.fromiter(self._dirty_fin,
                                               dtype=np.float64,
                                               count=len(dd))
            dd.clear()
            self._dirty_fin.clear()
        dm = self._dirty_mig
        if dm:
            self.migrated_np[np.fromiter(dm, dtype=np.intp,
                                         count=len(dm))] = True
            dm.clear()
        dc = self._dirty_cur
        if dc:
            cur = self.cursor
            self.cursor_arr[np.fromiter(dc, dtype=np.intp, count=len(dc))] = \
                np.fromiter((cur[e] for e in dc), dtype=np.intp,
                            count=len(dc))
            dc.clear()
        dr = self._dirty_run
        if dr:
            running = self.running
            self.running_arr[np.fromiter(dr, dtype=np.intp, count=len(dr))] = \
                np.fromiter((-1 if running[e] is None else running[e]
                             for e in dr), dtype=np.intp, count=len(dr))
            dr.clear()

    def _dispatch_arr(self, es: np.ndarray, now: float, heap, seq: int) -> int:
        """Batched ready/select/commit over an ascending executor index
        array: vectorized cursor walk to each executor's next own chunk, one
        fused ready-time computation for all candidates, then a single
        comparison against ``now`` splits starts (batched durations,
        completion pushes) from wake-ups. Mutations are mirrored back into
        the list state so subsequent scalar rounds see them."""
        st = self.st
        self._flush_mirrors()
        elig = (self.running_arr[es] == -1) & self._alive_e_mask[es]
        es = es[elig]
        if es.size == 0:
            return seq
        mq = self._migq_pending[es] > 0
        if mq.any():
            # migrated-in work: exact scalar semantics (rare, localized)
            for e in es[mq].tolist():
                seq = self._dispatch(e, now, heap, seq)
            es = es[~mq]
            if es.size == 0:
                return seq
        n = st.n_chunks
        # cursor walk: advance past done/migrated heads, all executors at
        # once (iterates max skip-run times; skips are rare and bounded)
        cur0 = self.cursor_arr[es]
        cur = cur0
        lens = st.order_len[es]
        valid = cur < lens
        head = np.where(valid, st.order_mat[es, np.where(valid, cur, 0)], n)
        while True:
            adv = self.done_np[head] | self.migrated_np[head]
            if not adv.any():
                break
            cur = cur + adv
            valid = cur < lens
            head = np.where(valid, st.order_mat[es, np.where(valid, cur, 0)], n)
        moved = cur != cur0
        if moved.any():
            self.cursor_arr[es] = cur
            cl = self.cursor
            for e, k in zip(es[moved].tolist(), cur[moved].tolist()):
                cl[e] = k
        # ready: masked maximum over the two dep slots (sentinel deps
        # contribute the reference's initial 0.0; unfinished deps poison the
        # maximum with +inf = "no ready time yet")
        ready = np.maximum(
            self.finish_arr[st.dep_a[head]] + self.dep_cost_a[head],
            self.finish_arr[st.dep_b[head]] + self.dep_cost_b[head])
        known = (head != n) & (ready != np.inf)
        start_m = known & (ready <= now)
        wake_m = known & ~start_m
        if wake_m.any():
            wa = self._wake_at
            for e, t in zip(es[wake_m].tolist(), ready[wake_m].tolist()):
                pending = wa[e]
                if pending is None or t < pending:
                    wa[e] = t
                    heapq.heappush(heap, (t, seq, 1, e, -1))
                    seq += 1
        if start_m.any():
            ees = es[start_m]
            cs = head[start_m].tolist()
            self.running_arr[ees] = head[start_m]
            t_end = np.maximum(ready[start_m], now) + self._chunk_costs(cs, ees)
            started, running = self.started, self.running
            for e, c, t in zip(ees.tolist(), cs, t_end.tolist()):
                started[c] = True
                running[e] = c
                heapq.heappush(heap, (t, seq, 0, e, c))
                seq += 1
        return seq

    def _dispatch_round(self, touched, now: float, heap, seq: int) -> int:
        """One dispatch round over a touched-executor set (in ascending
        executor order on both paths): vectorized stages past
        ``vec_batch_min``, the tuned scalar path below it."""
        if len(touched) >= self._vec_min:
            if isinstance(touched, np.ndarray):
                arr = touched
            else:
                arr = np.fromiter(touched, dtype=np.intp, count=len(touched))
                arr.sort()
            return self._dispatch_arr(arr, now, heap, seq)
        for e2 in (sorted(touched) if len(touched) > 1 else touched):
            seq = self._dispatch(e2, now, heap, seq)
        return seq

    # --------------------------------------------------------------- sim
    def run(self) -> SimResult:
        st = self.st
        if self.policy == "none":
            for (d, s) in self.dead:
                if 0 <= d < self.n_replicas and 0 <= s < self.n_stages \
                        and st.orders[d * self.n_stages + s]:
                    return SimResult(
                        math.inf, "aborted", {}, [], {}, {},
                        detail=f"stage {(d, s)} is fail-stop and no migration policy")
        heap: list = []
        seq = 0
        touched: set = set()
        self._decide(0.0, touched)
        seq = self._dispatch_round(self._all_executors, 0.0, heap, seq)
        guard = 0
        limit = (self.event_budget if self.event_budget is not None
                 else 50 * max(1, st.n_chunks))
        # hot-loop local bindings: every name below is read per event, and
        # attribute lookups are a measurable fraction of the drain at 10k+
        # devices (all the bound objects are mutated in place, never rebound)
        kind, replica, stage, rdeps = st.kind, st.replica, st.stage, st.rdeps
        heappop, heappush = heapq.heappop, heapq.heappush
        running = self.running
        done, finish = self.done, self.finish
        exec_of, placement = self.exec_of, self.placement
        live, inflight = self.live, self.inflight
        pr_finish = self._pr_finish
        dirty_done, dirty_fin = self._dirty_done, self._dirty_fin
        dirty_run, dirty_cur = self._dirty_run, self._dirty_cur
        wake_at = self._wake_at
        orders, dcost, mb = st.orders, self.dcost, st.mb
        cursor, memo, started = self.cursor, self._ready_memo, self.started
        migq, migq_pending = self.migq, self._migq_pending
        migrated = self.migrated_away
        dur_home, home = self._dur_home, st.home
        cids, executors, chunk_cost = st.cids, st.executors, self.chunk_cost
        dead_e, vec_min = self._dead_e, self._vec_min
        n_done_chunks, max_finish = self.n_done_chunks, self._max_finish
        while heap:
            guard += 1
            if guard > limit:
                self.n_done_chunks = n_done_chunks
                self._max_finish = max_finish
                raise _budget_error(heap[0][0], len(heap),
                                    st.n_chunks - n_done_chunks,
                                    st.n_chunks, limit)
            now, _, typ, e, c = heappop(heap)
            lim = now + SAME_TIME_EPS
            any_done = False
            touched = set()
            # commit the same-time batch event by event as it is popped:
            # commits never push to the heap, so interleaving pop and commit
            # is identical to gather-then-replay, minus the batch list
            while True:
                if typ == 0:  # completion
                    running[e] = None
                    dirty_run.append(e)
                    done[c] = True
                    dirty_done.append(c)
                    dirty_fin.append(now)
                    n_done_chunks += 1
                    finish[c] = now
                    if max_finish is None or now > max_finish:
                        max_finish = now
                    d = replica[c]
                    if now > pr_finish[d]:
                        pr_finish[d] = now
                    k = kind[c]
                    if k == _KIND_F:
                        live[e] += 1
                        if placement[c] >= 0:
                            inflight[e] -= 1
                        else:
                            self._inc_progress(d, stage[c])
                    elif k == _KIND_B:
                        live[e] -= 1
                    any_done = True
                    touched.add(e)
                    # only idle dependents can act on the new finish time —
                    # busy ones would no-op in _dispatch, and if their chunk
                    # completes later in this same batch that completion
                    # re-adds them (the reference dispatches everybody; the
                    # outcome is identical, minus the no-op calls)
                    for r in rdeps[c]:
                        e2 = exec_of[r]
                        if running[e2] is None:
                            touched.add(e2)
                else:  # wake
                    wake_at[e] = None
                    if running[e] is None:
                        touched.add(e)
                if heap and heap[0][0] <= lim:
                    _, _, typ, e, c = heappop(heap)
                else:
                    break
            if any_done:
                self._decide(now, touched)
            if len(touched) >= vec_min:
                arr = np.fromiter(touched, dtype=np.intp, count=len(touched))
                arr.sort()
                seq = self._dispatch_arr(arr, now, heap, seq)
                continue
            # ---- inlined scalar _dispatch over the touched executors ----
            # a line-for-line copy of ``_dispatch`` on the hoisted local
            # bindings: the method call plus its ~15 per-call attribute
            # loads were the largest single cost of the drain at 10k+
            # devices. Keep this block in lockstep with ``_dispatch`` (the
            # canonical form — the array path, the initial round and the
            # unit tests all still go through the method); the parity
            # suites pin both against the reference engine. Singleton
            # rounds (the common case at low event-time collision rates)
            # skip the ordering sort outright.
            for e in (sorted(touched) if len(touched) > 1 else touched):
                if running[e] is not None or e in dead_e:
                    continue
                order = orders[e]
                cur = cursor[e]
                own = None
                n_ord = len(order)
                while cur < n_ord:
                    cc = order[cur]
                    if migrated[cc] or done[cc]:
                        cur += 1
                        continue
                    own = cc
                    break
                if cur != cursor[e]:
                    cursor[e] = cur
                    dirty_cur.append(e)
                own_ready = None
                if own is not None:
                    t = memo[own]
                    if t is None:
                        t = 0.0
                        for d, cst in dcost[own]:
                            f = finish[d]
                            if f is None:
                                t = None
                                break
                            f = f + cst
                            if f > t:
                                t = f
                        if t is not None:
                            memo[own] = t
                    own_ready = t
                mig, mig_ready = None, None
                q = migq[e]
                if q:
                    w = 0
                    i = 0
                    L = len(q)
                    while i < L:
                        cc = q[i]
                        i += 1
                        if done[cc] or started[cc]:
                            continue
                        q[w] = cc
                        w += 1
                        r = memo[cc]
                        if r is None:
                            r = 0.0
                            for d, cst in dcost[cc]:
                                f = finish[d]
                                if f is None:
                                    r = None
                                    break
                                f = f + cst
                                if f > r:
                                    r = f
                            if r is not None:
                                memo[cc] = r
                        if r is not None and (mig_ready is None
                                              or r < mig_ready):
                            mig, mig_ready = cc, r
                            if kind[cc] != _KIND_W:
                                break
                    if w != i:
                        while i < L:
                            q[w] = q[i]
                            w += 1
                            i += 1
                        del q[w:]
                own_now = own_ready is not None and own_ready <= now
                mig_now = mig_ready is not None and mig_ready <= now
                from_mig = False
                if own_now and mig_now:
                    mk = 0 if kind[mig] == _KIND_B else 1
                    ok = 0 if kind[own] == _KIND_B else 1
                    if (mb[mig], mk) < (mb[own], ok):
                        cand, ready, from_mig = mig, mig_ready, True
                    else:
                        cand, ready = own, own_ready
                elif own_now:
                    cand, ready = own, own_ready
                elif mig_now:
                    cand, ready, from_mig = mig, mig_ready, True
                else:
                    if own_ready is not None or mig_ready is not None:
                        if own_ready is None:
                            t = mig_ready
                        elif mig_ready is None or own_ready < mig_ready:
                            t = own_ready
                        else:
                            t = mig_ready
                        pending = wake_at[e]
                        if pending is None or t < pending:
                            wake_at[e] = t
                            heappush(heap, (t, seq, 1, e, -1))
                            seq += 1
                    continue
                started[cand] = True
                running[e] = cand
                dirty_run.append(e)
                if from_mig:
                    migq_pending[e] -= 1
                if dur_home is not None and e == home[cand]:
                    dur = dur_home[cand]
                else:
                    dur = chunk_cost(cids[cand], executors[e])
                t_end = (now if now > ready else ready) + dur
                heappush(heap, (t_end, seq, 0, e, cand))
                seq += 1
        self.n_done_chunks = n_done_chunks
        self._max_finish = max_finish

        finish = {st.cids[i]: self.finish[i]
                  for i in range(st.n_chunks) if self.done[i]}
        if self.n_done_chunks != st.n_chunks:
            missing = [st.cids[i] for i in range(st.n_chunks) if not self.done[i]]
            return SimResult(math.inf, "aborted", finish, self.migrations,
                             {}, {},
                             detail=f"{len(missing)} chunks unexecuted, e.g. {missing[:4]}")
        total = self._max_finish if self._max_finish is not None else 0.0
        per_replica = {d: self._pr_finish[d] for d in range(self.n_replicas)}
        return SimResult(total, "ok", finish, self.migrations, {}, per_replica)


# ====================================================== belief plumbing
class StageSpeedCache:
    """Vectorized true-device-state -> per-(replica, stage) group-speed sync
    for the fast engine (one of the per-device python loops the ROADMAP
    flagged for 10k+-device sweeps).

    The reference loop in ``TrainingSim._true_stage_speeds`` is
    ``(st.tp / tp0) * min(speeds[d] for d in st.devices)`` per stage, re-run
    every iteration even though the plan only changes on reconfiguration and
    the cluster only changes when an event fires. Two cache levels:

    * per-plan: the per-stage device-index arrays and ``tp/tp0`` ratios are
      rebuilt only when the plan object changes;
    * per-(plan, cluster version): the full result dict is memoized against
      ``ClusterState.version``, so quiet iterations (no event fired, no
      reconfig) return the previous dict without touching the arrays at all
      — the fastsim cost-table refresh stops re-gathering speeds per stage
      per iteration.

    Each recompute reduces with ``ndarray.min`` over the registry's cached
    effective-speed array — bit-identical floats, since min over float64 and
    the single multiply are the exact operations of the reference
    expression. NTP stages (``StagePlan.shard_fractions``) reduce with an
    elementwise divide + ``ndarray.max`` instead — again the same IEEE
    operations as the reference ``max(f / v for ...)`` loop, so parity stays
    exact on nonuniform-width plans too.

    Alongside the dict, each recompute publishes ``grid`` — the same values
    as a dense (replica, stage) float array when the plan's stage grid is
    rectangular, else ``None`` — which the batched cost table consumes
    directly (``make_cost_table(true_speed_grid=...)``), skipping the
    per-iteration dict-walk rebuild of its executor-speed matrix.
    """

    def __init__(self):
        self._plan = None
        # ((r, s), tp_ratio, device-index array|None, shard-width array|None)
        self._entries: list = []
        self._version = None
        self._result: dict = {}
        self.grid = None  # dense (R, S) mirror of the last result, if rect.
        self._grid_shape = None

    def _rebuild(self, plan, tp0: int):
        self._entries = []
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                ids = (np.fromiter(st.devices, dtype=np.intp,
                                   count=len(st.devices))
                       if st.devices else None)
                fr = (np.fromiter(st.shard_fractions, dtype=np.float64,
                                  count=len(st.shard_fractions))
                      if st.shard_fractions is not None else None)
                self._entries.append(((r, s), st.tp / tp0, ids, fr))
        n_rep = len(plan.replicas)
        stage_counts = {len(rep.stages) for rep in plan.replicas}
        self._grid_shape = ((n_rep, stage_counts.pop())
                            if len(stage_counts) == 1 else None)
        self._plan = plan
        self._version = None

    def speeds(self, plan, effective, tp0: int, *, version=None) -> dict:
        """``effective``: dense per-device effective-speed vector (device id
        = index); ``version``: the cluster mutation counter (None disables
        result memoization). The returned dict is shared — treat it as
        read-only."""
        if plan is not self._plan:
            self._rebuild(plan, tp0)
        if version is not None and version == self._version:
            return self._result
        vec = np.asarray(effective, dtype=np.float64)
        out = {}
        for key, ratio, ids, fr in self._entries:
            if ids is None:
                out[key] = 0.0
                continue
            g = vec[ids]
            m = g.min()
            if m <= 0:
                out[key] = 0.0
            elif fr is not None:
                worst = float((fr / g).max())
                out[key] = NTP_EFFICIENCY / (tp0 * worst)
            else:
                out[key] = ratio * float(m)
        if self._grid_shape is not None:
            self.grid = np.fromiter(
                out.values(), dtype=np.float64,
                count=len(out)).reshape(self._grid_shape)
        else:
            self.grid = None
        self._version = version
        self._result = out
        return out


class FastHeartbeat:
    """Vectorized drop-in for :class:`~repro_torch.core.detector.heartbeat.
    HeartbeatMonitor` (fast engine only — the reference monitor stays the
    parity anchor on the python engine). This was the last per-device python
    loop on the 10k+-device sweep path: ``TrainingSim._sync_beliefs`` beat
    every alive device individually (``device_beat`` + ``node_beat`` per
    device per iteration) and ``sweep`` walked every ``DeviceHB`` dataclass.

    Here the per-device state is four dense numpy arrays (last-beat time,
    failed flag, node row, registered flag) plus three per-node arrays;
    ``beat_all(alive_mask, now)`` replaces the whole beat loop with masked
    stores and ``sweep`` with a handful of vector comparisons. Semantics are
    kept operation-for-operation (same float divisions, same node-channel
    guard on device beats, same whole-node-failure ordering, ``revive`` /
    ``revive_node`` / ``kill_node`` / ``mark_failed`` identical), so the
    engine-parity suite pins python vs fast byte-for-byte — exactly like
    :class:`StageSpeedCache` for ``_true_stage_speeds``.

    Assumes dense integer device ids and nodes registered in ascending
    device order (what ``TrainingSim`` does), so the ascending ``newly``
    list matches the reference's registration-order walk. Registration is
    init-only: unlike the reference monitor, which can adopt a node
    mid-flight, adding a node after the first beat/sweep would rebuild the
    state arrays and re-report every known death — so it raises instead.
    """

    def __init__(self, interval: float = 1.0, miss_threshold: int = 3):
        self.interval = interval
        self.miss_threshold = miss_threshold
        self.on_failstop = None
        self.failed_devices: set = set()
        self.failed_nodes: set = set()
        self.device_node: dict = {}
        self._node_ids: list = []
        self._node_row: dict = {}
        self._node_devices: dict = {}
        self._arrays = None

    # -------------------------------------------------------- registration
    def register_node(self, node_id: int, device_ids: list):
        if self._arrays is not None:
            raise RuntimeError(
                "FastHeartbeat registration is init-only: adding a node "
                "after beats/sweeps started would wipe heartbeat state and "
                "re-report known deaths (use HeartbeatMonitor for elastic "
                "scale-out)")
        self._node_row[node_id] = len(self._node_ids)
        self._node_ids.append(node_id)
        self._node_devices[node_id] = list(device_ids)
        for d in device_ids:
            self.device_node[d] = node_id

    def _ensure(self):
        if self._arrays is not None:
            return
        n_dev = max(self.device_node, default=-1) + 1
        n_nodes = len(self._node_ids)
        self._dev_last = np.full(n_dev, -1.0)
        self._dev_failed = np.zeros(n_dev, dtype=bool)
        self._dev_row = np.full(n_dev, -1, dtype=np.intp)
        self._registered = np.zeros(n_dev, dtype=bool)
        for d, nid in self.device_node.items():
            self._dev_row[d] = self._node_row[nid]
            self._registered[d] = True
        self._node_last = np.full(n_nodes, -1.0)
        self._node_alive = np.ones(n_nodes, dtype=bool)
        self._node_failed = np.zeros(n_nodes, dtype=bool)
        self._arrays = True

    # -------------------------------------------------------------- ingest
    def beat_all(self, alive, now: float):
        """The whole per-iteration beat loop in two masked stores: every
        alive registered device beats (unless its node channel is down — the
        reference ``device_beat`` guard) and every node hosting an alive
        device refreshes its side-channel keepalive (the reference
        ``node_beat``, which has no such guard)."""
        self._ensure()
        alive = np.asarray(alive, dtype=bool)
        live = alive & self._registered
        rows = self._dev_row[live]
        ok = ~self._node_failed & self._node_alive
        self._dev_last[live & ok[self._dev_row]] = now
        self._node_last[np.unique(rows)] = now

    def device_beat(self, node_id: int, device_id, now: float,
                    progress: int = 0):
        self._ensure()
        if node_id in self.failed_nodes or not self._node_alive[
                self._node_row[node_id]]:
            return
        self._dev_last[device_id] = now

    def node_beat(self, node_id: int, now: float):
        self._ensure()
        self._node_last[self._node_row[node_id]] = now

    def kill_node(self, node_id: int):
        self._ensure()
        self._node_alive[self._node_row[node_id]] = False

    def mark_failed(self, device_id):
        """Out-of-band failure report (validation-as-fail-stop path): the
        next sweep will not re-report the device."""
        self._ensure()
        self._dev_failed[device_id] = True
        self.failed_devices.add(device_id)

    # -------------------------------------------------------------- revive
    def revive(self, device_id, now: float = 0.0):
        self._ensure()
        nid = self.device_node.get(device_id)
        if nid is None:
            return
        row = self._node_row[nid]
        if nid in self.failed_nodes or not self._node_alive[row]:
            self.revive_node(nid, now)
        self._dev_failed[device_id] = False
        self._dev_last[device_id] = now
        self.failed_devices.discard(device_id)

    def revive_node(self, node_id: int, now: float = 0.0):
        self._ensure()
        row = self._node_row[node_id]
        self.failed_nodes.discard(node_id)
        self._node_failed[row] = False
        self._node_alive[row] = True
        self._node_last[row] = now

    # --------------------------------------------------------------- sweep
    def sweep(self, now: float) -> list:
        """Both detection levels vectorized. ``floor(x) >= m`` equals
        ``x >= m`` for integer m and non-negative x, so the reference's
        ``int(...)`` truncation reduces to a float comparison on the very
        same division."""
        self._ensure()
        act = ~self._node_failed
        exp_n = np.where(self._node_last >= 0,
                         (now - self._node_last) / self.interval, np.inf)
        node_dead = act & (~self._node_alive | (exp_n >= self.miss_threshold))
        node_ok = act & ~node_dead
        exp_d = np.where(self._dev_last >= 0,
                         (now - self._dev_last) / self.interval, np.inf)
        rows = self._dev_row
        cand = self._registered & ~self._dev_failed
        newly_mask = cand & (node_dead[rows]
                             | (node_ok[rows] & (exp_d >= self.miss_threshold)))
        ids = np.nonzero(newly_mask)[0]
        self._node_failed |= node_dead
        for r in np.nonzero(node_dead)[0]:
            self.failed_nodes.add(self._node_ids[r])
        self._dev_failed[ids] = True
        newly = [int(d) for d in ids]
        self.failed_devices.update(newly)
        if newly and self.on_failstop is not None:
            self.on_failstop(newly, now)
        return newly

    # --------------------------------------------------------------- stats
    @property
    def n_messages_per_interval(self) -> int:
        return len(self._node_ids)


# ========================================================== cost vectorizer
def make_cost_table(*, alpha, beta, gamma, workload, share, n_layers, mult,
                    jit, true_speed, replica_map=None, true_speed_grid=None):
    """Vectorized chunk-cost function, bit-identical to the scalar closure in
    ``TrainingSim.step`` (``make_cost``).

    The per-(stage, kind, micro-batch) numerators are precomputed once per
    plan/iteration as numpy float64 arrays with the *same association order*
    as the scalar expression — ``((base * K) * jit) / max(speed, 1e-9)`` with
    ``base = (alpha*N + beta*sum_l2) + gamma`` and
    ``K = (share[stage] * n_layers) * mult[kind]`` — so every lookup returns
    the exact float the reference closure computes.  ``replica_map`` mirrors
    the reference: when set, the chunk's replica is remapped and the executor
    speed is looked up under the mapped replica (``_run_independent``).

    Without ``replica_map``, the returned callable also carries a ``batch``
    attribute — the batched-dispatch protocol: given dense chunk coordinate
    arrays (kind, mb, stage, replica) and executor coordinate arrays, it
    returns the duration vector through one padded-table gather and one
    elementwise division (the same IEEE-754 ops as the scalar path, so
    parity stays exact). ``true_speed_grid`` (a dense (replica, stage)
    effective-speed array, e.g. ``StageSpeedCache.grid``) skips the
    executor-speed matrix rebuild from the ``true_speed`` dict.
    """
    mult_arr = np.array([mult["F"], mult["B"], mult["W"]], dtype=np.float64)
    n_stages = max(share) + 1
    share_arr = np.array([share[s] for s in range(n_stages)], dtype=np.float64)
    K = (share_arr * n_layers)[:, None] * mult_arr[None, :]

    tables: dict = {}

    def _table(r: int):
        t = tables.get(r)
        if t is None:
            mbs = workload.per_replica[r]
            n_tok = np.array([w.n_tokens for w in mbs], dtype=np.float64)
            l2 = np.array([w.sum_l2 for w in mbs], dtype=np.float64)
            base = (alpha * n_tok + beta * l2) + gamma
            t = tables[r] = (base[None, None, :] * K[:, :, None]) * jit
        return t

    vmax: dict = {}

    def cost(cid: ChunkId, executor) -> float:
        if replica_map is not None:
            r = replica_map(cid.replica)
            e = (r, executor[1])
        else:
            r = cid.replica
            e = executor
        v = vmax.get(e)
        if v is None:
            v = vmax[e] = max(true_speed.get(e, 1.0), 1e-9)
        t = _table(r)
        return float(t[cid.stage, _KIND_INDEX[cid.kind], cid.mb % t.shape[2]]) / v

    if replica_map is None:
        state: dict = {}

        def batch(kind, mb, stage, replica, e_replica, e_stage):
            T = state.get("T")
            if T is None:
                n_rep = len(workload.per_replica)
                widths = np.array(
                    [len(workload.per_replica[r]) for r in range(n_rep)],
                    dtype=np.intp)
                T = np.zeros((n_rep, n_stages, 3, int(widths.max())))
                for r in range(n_rep):
                    T[r, :, :, :widths[r]] = _table(r)
                if (true_speed_grid is not None
                        and true_speed_grid.shape == (n_rep, n_stages)):
                    vm = np.maximum(true_speed_grid, 1e-9)
                else:
                    vm = np.empty((n_rep, n_stages))
                    for r in range(n_rep):
                        for s in range(n_stages):
                            vm[r, s] = max(true_speed.get((r, s), 1.0), 1e-9)
                state.update(T=T, widths=widths, vm=vm)
            return (state["T"][replica, stage, kind, mb % state["widths"][replica]]
                    / state["vm"][e_replica, e_stage])

        cost.batch = batch

    return cost
