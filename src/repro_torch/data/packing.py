"""Sequence packing: documents -> fixed-token-budget micro-batch rows.

A copy of `repro.data.packing` (numpy only). With packing, every row has N
tokens but attention cost is proportional to sum(l_i^2) of the packed
documents; `pack_stats` exposes (N, sum l^2), the features of the Eq. 1
micro-batch time predictor.
"""
from __future__ import annotations

import numpy as np


def pack_documents(doc_lengths, seq_len, *, strategy="first_fit"):
    """Greedy first-fit packing of document lengths into rows of <= seq_len.

    Returns a list of rows; each row is a list of document lengths. Documents
    longer than seq_len are split into seq_len chunks first.
    """
    chunks = []
    for l in doc_lengths:
        l = int(l)
        while l > seq_len:
            chunks.append(seq_len)
            l -= seq_len
        if l > 0:
            chunks.append(l)
    if strategy == "first_fit_decreasing":
        chunks = sorted(chunks, reverse=True)
    # Exact first-fit via an implicit max-segment-tree over per-bin free
    # space: descending to the leftmost leaf whose subtree max >= l lands on
    # the bin a left-to-right scan would pick, in O(log bins) per document.
    rows: list[list[int]] = []
    size = 1
    while size < len(chunks):
        size *= 2
    tree = [0] * (2 * size)  # leaf size+b = free space of rows[b]
    for l in chunks:
        if tree[1] >= l:
            i = 1
            while i < size:
                i *= 2
                if tree[i] < l:
                    i += 1
            rows[i - size].append(l)
            tree[i] -= l
        else:
            b = len(rows)
            rows.append([l])
            i = size + b
            tree[i] = seq_len - l
        while i > 1:
            i //= 2
            a, c = tree[2 * i], tree[2 * i + 1]
            tree[i] = a if a >= c else c
    return rows


def row_to_arrays(row, seq_len, rng, vocab):
    """One packed row -> (tokens, segment_ids, positions, labels)."""
    tokens = np.zeros(seq_len, np.int32)
    seg = np.zeros(seq_len, np.int32)
    pos = np.zeros(seq_len, np.int32)
    off = 0
    for i, l in enumerate(row):
        tokens[off : off + l] = rng.integers(1, vocab, size=l)
        seg[off : off + l] = i + 1
        pos[off : off + l] = np.arange(l)
        off += l
    labels = np.where(seg > 0, np.roll(tokens, -1), -1).astype(np.int32)
    # never predict across a document boundary or into padding
    boundary = np.roll(seg, -1) != seg
    labels[boundary] = -1
    return tokens, seg, pos, labels


def pack_stats(segment_ids: np.ndarray):
    """(tokens N, sum(l_i^2)) per row of a (B, S) segment-id array."""
    out = []
    for row in np.asarray(segment_ids):
        lens = np.bincount(row[row > 0])
        lens = lens[lens > 0]
        out.append((int(lens.sum()), int((lens.astype(np.int64) ** 2).sum())))
    return out
