"""Deterministic synthetic packed-LM dataset (copy of `repro.data.synth`).

Document lengths follow a clipped lognormal, so the per-micro-batch sum(l^2)
fluctuates. Batches are numpy arrays; given the same seed they are identical
to the reference package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.packing import pack_documents, row_to_arrays


def sample_doc_lengths(rng, n, seq_len, *, mu=6.2, sigma=1.1, min_len=16):
    lens = rng.lognormal(mean=mu, sigma=sigma, size=n)
    return np.clip(lens, min_len, 4 * seq_len).astype(np.int64)


class SyntheticPackedDataset:
    """Resumable, deterministic iterator of packed batches.

    State is (epoch_seed, cursor), so a run resumes with identical data order.
    """

    def __init__(self, cfg, seq_len, global_batch, *, seed=0, mu=6.2, sigma=1.1):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.mu, self.sigma = mu, sigma
        self.cursor = 0

    def state(self):
        return {"seed": self.seed, "cursor": self.cursor}

    def restore(self, state):
        self.seed = state["seed"]
        self.cursor = state["cursor"]

    def batch_at(self, index: int):
        """Batch `index` (stateless)."""
        rng = np.random.default_rng((self.seed, index))
        n_docs = max(8, int(self.global_batch * self.seq_len / np.exp(self.mu + self.sigma**2 / 2) * 0.9))
        lens = sample_doc_lengths(rng, n_docs, self.seq_len, mu=self.mu, sigma=self.sigma)
        rows = pack_documents(lens, self.seq_len)
        # top up with fresh docs until we can fill the batch
        while len(rows) < self.global_batch:
            extra = sample_doc_lengths(rng, 8, self.seq_len, mu=self.mu, sigma=self.sigma)
            rows.extend(pack_documents(extra, self.seq_len))
        rows = rows[: self.global_batch]
        B, S = self.global_batch, self.seq_len
        tokens = np.zeros((B, S), np.int32)
        seg = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        labels = np.full((B, S), -1, np.int32)
        for b, row in enumerate(rows):
            tokens[b], seg[b], pos[b], labels[b] = row_to_arrays(row, S, rng, self.cfg.vocab_size)
        return {
            "tokens": tokens,
            "segment_ids": seg,
            "positions": pos,
            "labels": labels,
        }

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_at(self.cursor)
        self.cursor += 1
        return b
