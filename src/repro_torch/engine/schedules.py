"""Pipeline schedules: GPipe, 1F1B [PipeDream, 33], ZB-H1 [zero-bubble, 37].

A schedule is a dict: executor (replica, stage) -> ordered list of ChunkIds.
ZB-H1 splits the backward into B (activation grad, on the critical path) and
W (weight grad, fills bubbles) — the same F/B/W decomposition the paper's
Detector and Scheduler use (§5.2, §6.3).

A copy of `repro.engine.schedules`, kept whole here, since the pipeline
engine interprets these schedules, without importing the JAX package.
"""
from __future__ import annotations

from repro_torch.core.detector.dag_sim import ChunkId


def gpipe(n_stages, n_mb, replica=0):
    out = {}
    for s in range(n_stages):
        order = [ChunkId("F", m, s, replica) for m in range(n_mb)]
        order += [ChunkId("B", m, s, replica) for m in reversed(range(n_mb))]
        out[(replica, s)] = order
    return out


def one_f_one_b(n_stages, n_mb, replica=0):
    """Standard 1F1B: stage s runs (n_stages - s) warm-up forwards, then
    alternates 1B/1F, then drains. B here is the full backward (B+W fused)."""
    out = {}
    for s in range(n_stages):
        warmup = min(n_stages - s, n_mb)
        order = [ChunkId("F", m, s, replica) for m in range(warmup)]
        nf, nb = warmup, 0
        while nb < n_mb:
            order.append(ChunkId("B", nb, s, replica))
            nb += 1
            if nf < n_mb:
                order.append(ChunkId("F", nf, s, replica))
                nf += 1
        out[(replica, s)] = order
    return out


def zb_h1(n_stages, n_mb, replica=0):
    """ZB-H1 (zero-bubble, handcrafted schedule 1): like 1F1B but backward is
    split; W chunks are deferred to fill the drain bubble."""
    out = {}
    for s in range(n_stages):
        warmup = min(n_stages - s, n_mb)
        order = [ChunkId("F", m, s, replica) for m in range(warmup)]
        nf, nb, nw = warmup, 0, 0
        while nb < n_mb:
            order.append(ChunkId("B", nb, s, replica))
            nb += 1
            if nf < n_mb:
                order.append(ChunkId("F", nf, s, replica))
                nf += 1
            else:
                # drain phase: interleave deferred W chunks
                if nw < nb - 1:
                    order.append(ChunkId("W", nw, s, replica))
                    nw += 1
        while nw < n_mb:
            order.append(ChunkId("W", nw, s, replica))
            nw += 1
        out[(replica, s)] = order
    return out


def make_schedule(name, n_stages, n_mb, replica=0):
    if name in ("1f1b", "1F1B"):
        return one_f_one_b(n_stages, n_mb, replica)
    if name.lower() in ("zb", "zbh1", "zb-h1"):
        return zb_h1(n_stages, n_mb, replica)
    if name.lower() == "gpipe":
        return gpipe(n_stages, n_mb, replica)
    raise ValueError(name)


def has_w_chunks(name):
    return name.lower() in ("zb", "zbh1", "zb-h1")
