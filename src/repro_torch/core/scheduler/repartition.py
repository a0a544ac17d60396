"""Layer repartition to alleviate PP imbalance (paper §6.2).

Straggling stages (degraded TP groups after §6.1 reconfiguration) get fewer
layers; the excess is spread over healthy stages. We minimize the pipeline's
steady-state bottleneck  max_s ( work_s / speed_s )  where work_s is the
summed per-layer cost of the stage's layers and speed_s its effective
throughput. Layer assignments stay contiguous (activations flow stage to
stage), so this is optimal contiguous partitioning over heterogeneous stage
speeds — solved exactly by dynamic programming (n_layers <= ~100 and
stages <= 16, so O(S * n^2) is microseconds).

Per-layer costs may differ (hybrid models: a Mamba layer is cheaper than an
attention layer at long context), which is why this takes a cost vector, not
a layer count.

A copy of `repro.core.scheduler.repartition`, kept whole here, since the
Scheduler and the recovery's layer costs use it, without importing the JAX
package.
"""
from __future__ import annotations

import math


def repartition_layers(layer_costs, stage_speeds, *, min_layers=1):
    """-> list of per-stage layer-index tuples (contiguous, covers all layers)
    minimizing the bottleneck stage time. Exact DP.

    layer_costs: per-layer execution cost on a healthy stage.
    stage_speeds: per-stage effective throughput (1.0 = healthy); a stage at
        0.5 finishes the same layers in 2x the time. A dead stage (speed 0)
        is not allowed here — evict it from the plan first.
    """
    costs = [float(c) for c in layer_costs]
    speeds = [float(v) for v in stage_speeds]
    n, S = len(costs), len(speeds)
    assert all(v > 0 for v in speeds), "dead stages must be evicted before repartition"
    assert n >= S * min_layers, (n, S, min_layers)

    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def seg(i, j, s):  # time of layers [i, j) on stage s
        return (prefix[j] - prefix[i]) / speeds[s]

    INF = math.inf
    # dp[s][j]: min bottleneck assigning first j layers to stages [0..s]
    dp = [[INF] * (n + 1) for _ in range(S)]
    cut = [[-1] * (n + 1) for _ in range(S)]
    for j in range(min_layers, n + 1):
        dp[0][j] = seg(0, j, 0)
        cut[0][j] = 0
    for s in range(1, S):
        lo_j = (s + 1) * min_layers
        for j in range(lo_j, n + 1):
            best, arg = INF, -1
            # stage s takes layers [i, j): i ranges so every earlier stage
            # keeps >= min_layers and this one too
            for i in range(s * min_layers, j - min_layers + 1):
                prev = dp[s - 1][i]
                # unreachable prefix (min_layers infeasibility). Value check,
                # not `prev is INF`: float identity silently misses equal
                # infinities produced by arithmetic. An inf *cost* with a
                # valid cut is reachable — extreme speed skew can overflow
                # seg() yet the partition itself is still legal.
                if math.isinf(prev) and cut[s - 1][i] < 0:
                    continue
                v = max(prev, seg(i, j, s))
                if arg < 0 or v < best:
                    best, arg = v, i
            dp[s][j], cut[s][j] = best, arg

    # backtrack
    bounds, j = [], n
    for s in range(S - 1, -1, -1):
        i = cut[s][j]
        assert i >= 0, "infeasible partition"
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [tuple(range(i, j)) for i, j in bounds]


def partition_bottleneck(layer_costs, partition, stage_speeds) -> float:
    """max stage time of a given partition (the pipeline's steady-state rate)."""
    return max(
        sum(layer_costs[i] for i in layers) / max(speed, 1e-9)
        for layers, speed in zip(partition, stage_speeds)
    )


def uniform_costs(n_layers: int, *, embed_extra: float = 0.0, head_extra: float = 0.0):
    """Cost vector for a homogeneous stack; first/last layers optionally carry
    the embedding/LM-head cost."""
    costs = [1.0] * n_layers
    costs[0] += embed_extra
    costs[-1] += head_extra
    return costs


def costs_for_arch(cfg, seq_len: int = 4096) -> list:
    """Per-layer relative FLOPs for an ArchConfig (hybrid-aware)."""
    costs = []
    for spec in cfg.layer_specs():
        d = cfg.d_model
        if spec.mixer == "attn":
            mix = 2 * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * cfg.q_dim * d
            span = min(seq_len, cfg.window) if spec.attn_kind == "swa" else seq_len
            mix += 2 * 2 * cfg.n_heads * cfg.head_dim * span  # qk^T + pv per token
        elif spec.mixer == "mamba":
            di = cfg.mamba_d_inner
            mix = 2 * d * 2 * di + 2 * di * d + 6 * di * cfg.mamba_d_state
        else:  # mlstm / slstm
            mix = 8 * d * d
        if spec.ffn == "dense":
            ffn = 6 * d * cfg.d_ff
        elif spec.ffn == "moe":
            ffn = 6 * d * cfg.moe_d_ff * cfg.moe_top_k + 2 * d * cfg.n_experts
        else:
            ffn = 0
        costs.append(float(mix + ffn))
    m = max(costs)
    return [c / m for c in costs]
