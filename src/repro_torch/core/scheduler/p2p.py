"""P2P communication between pipeline stages with heterogeneous TP degrees
(paper §7, Fig. 7) — the symmetric mapping rule + a fabric-aware cost model.

Megatron's scatter/gather optimization sends each boundary tensor once over
the slow fabric (split into TP-many chunks, re-gathered over the fast
intra-node fabric) but requires equal sender/receiver TP degrees. After
selective exclusion (§6.1) degrees differ; the symmetric rule generalizes it:

  N = max(tp_send, tp_recv); the boundary tensor is viewed as N equal chunks.
  Chunk c lives on sender rank c*tp_send//N and goes, once, to receiver
  rank c*tp_recv//N, so each receiver rank is sent one distinct slice of
  the tensor and the full tensor is reconstructed receiver-side by an
  all-gather over the fast fabric. Every chunk crosses the slow fabric
  exactly once (vs tp_recv times naively).

On GPUs the slow/fast split maps to the network between nodes against
NVLink within one. The port's pipeline engine applies the rule in
`engine.pipeline.PipelineEngine._hand_off`: point-to-point sends of each
chunk between the stage groups, then an all-gather over the receiving
stage's `model` axis.

A copy of `repro.core.scheduler.p2p`, kept whole here, without importing the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass


def p2p_mapping(tp_send: int, tp_recv: int):
    """The symmetric mapping rule: -> list of (send_rank, recv_rank, chunk).

    The tensor is split into N = max(tp_send, tp_recv) equal chunks. Chunk c
    lives on sender rank  c * tp_send // N  and is needed first by receiver
    rank  c * tp_recv // N ; each chunk crosses the slow fabric exactly once.
    """
    assert tp_send >= 1 and tp_recv >= 1
    n = max(tp_send, tp_recv)
    assert n % tp_send == 0 and n % tp_recv == 0, (
        "power-of-two TP degrees (Eq. 3) guarantee divisibility"
    )
    return [(c * tp_send // n, c * tp_recv // n, c) for c in range(n)]


@dataclass(frozen=True)
class Fabric:
    slow_bw: float = 25e9  # bytes/s across nodes/slices (IB/DCN)
    fast_bw: float = 300e9  # bytes/s within node/slice (NVLink/ICI)
    latency: float = 10e-6


def p2p_cost_bytes(tensor_bytes: int, tp_send: int, tp_recv: int,
                   *, scatter_gather: bool = True):
    """Slow-fabric bytes for one boundary transfer.

    naive            : each receiver rank pulls the full tensor
    scatter/gather   : each chunk crosses once -> tensor_bytes total
    """
    if not scatter_gather:
        return tensor_bytes * tp_recv
    return tensor_bytes


def p2p_time(tensor_bytes: int, tp_send: int, tp_recv: int, fabric: Fabric = Fabric(),
             *, scatter_gather: bool = True) -> float:
    """Seconds for one stage-boundary transfer under the rule."""
    slow = p2p_cost_bytes(tensor_bytes, tp_send, tp_recv, scatter_gather=scatter_gather)
    t_slow = slow / fabric.slow_bw
    if scatter_gather:
        n = max(tp_send, tp_recv)
        # receiver-side all-gather of (n-1)/n of the tensor over the fast fabric
        t_fast = tensor_bytes * (n - 1) / n / fabric.fast_bw
    else:
        t_fast = 0.0
    return fabric.latency + t_slow + t_fast


def boundary_bytes(cfg, microbatch_tokens: int, dtype_bytes: int = 2) -> int:
    """Activation bytes crossing one PP boundary per micro-batch."""
    return microbatch_tokens * cfg.d_model * dtype_bytes


def chunk_slices(total_dim: int, tp_send: int, tp_recv: int):
    """Index slices of the boundary tensor's model dim for each chunk of the
    symmetric mapping — used by the engine's hand-off to cut the chunks it
    sends."""
    n = max(tp_send, tp_recv)
    assert total_dim % n == 0, (total_dim, n)
    w = total_dim // n
    return [slice(c * w, (c + 1) * w) for c in range(n)]
