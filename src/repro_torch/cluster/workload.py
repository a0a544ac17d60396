"""Per-iteration workload generation for the cluster simulator.

Samples document lengths from the same long-tailed distribution as the data
pipeline, packs them, and exposes per-micro-batch (N, sum l_i^2) — the
features of the paper's Eq. 1 predictor. Ground-truth chunk times follow the
same functional form (alpha*N + beta*sum_l2 + gamma) with optional jitter,
which is exactly what a calibrated predictor assumes; model mismatch is
covered by the MAPE benchmarks against the *real* engine.

A copy of `repro.cluster.workload`, kept whole here, without importing the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.packing import pack_documents, quadratic_cost
from repro_torch.data.synth import sample_doc_lengths


@dataclass
class MicroBatchWork:
    n_tokens: int
    sum_l2: int


@dataclass
class IterationWorkload:
    """Per replica: list of MicroBatchWork (one per micro-batch)."""

    per_replica: list  # [replica][mb] -> MicroBatchWork
    seq_len: int

    def stats(self, replica: int, mb: int) -> MicroBatchWork:
        reps = self.per_replica
        return reps[replica][mb % len(reps[replica])]

    def totals(self):
        n = sum(w.n_tokens for r in self.per_replica for w in r)
        l2 = sum(w.sum_l2 for r in self.per_replica for w in r)
        return n, l2


@dataclass
class WorkloadGen:
    seq_len: int
    n_replicas: int
    n_microbatches: int
    rows_per_microbatch: int = 1
    seed: int = 0
    mu: float = 6.2
    sigma: float = 1.1
    _it: int = field(default=0)

    def for_iteration(self, iteration: int) -> IterationWorkload:
        rng = np.random.default_rng((self.seed, iteration))
        total_rows = self.n_replicas * self.n_microbatches * self.rows_per_microbatch
        mean_len = np.exp(self.mu + self.sigma**2 / 2)
        n_docs = max(8, int(total_rows * self.seq_len / mean_len))
        rows = pack_documents(
            sample_doc_lengths(rng, n_docs, self.seq_len, mu=self.mu, sigma=self.sigma),
            self.seq_len,
        )
        while len(rows) < total_rows:
            extra = sample_doc_lengths(rng, 16, self.seq_len, mu=self.mu, sigma=self.sigma)
            rows.extend(pack_documents(extra, self.seq_len))
        rows = rows[:total_rows]
        per_replica = []
        idx = 0
        for _ in range(self.n_replicas):
            mbs = []
            for _ in range(self.n_microbatches):
                group = rows[idx: idx + self.rows_per_microbatch]
                idx += self.rows_per_microbatch
                n = sum(sum(r) for r in group)
                l2 = sum(quadratic_cost(r) for r in group)
                mbs.append(MicroBatchWork(n, l2))
            per_replica.append(mbs)
        return IterationWorkload(per_replica, self.seq_len)

    def __next__(self) -> IterationWorkload:
        w = self.for_iteration(self._it)
        self._it += 1
        return w
