"""Three-term roofline of a counted step (counterpart of `repro.roofline.analysis`).

Hardware model (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at
700 W): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB.
One link figure: NVLink's 450 GB/s each way between two cards of a host
(900 GB/s in all), as if every collective ran at that rate; a mesh that
spans hosts runs its collectives slower (InfiniBand), which this model does
not see. Terms are seconds per step, per rank:

  compute    = counted FLOPs / peak FLOP/s
  memory     = counted bytes / HBM bytes/s
  collective = ring bytes / link bytes/s

`model_flops` is the reference's, copied as it stands: 6*N*D (dense) /
6*N_active*D (MoE) for train, 2*N*D for prefill, 2*N per row for decode,
plus the quadratic attention term.

The reference's `attn_kernel_substitution` and `optimized_roofline` have no
counterpart here. They re-cost the reference's jnp attention as its Pallas
kernel, and its CPU lowering's f32 collectives as the TPU's bf16 ones; the
port's step already runs its attention kernels (as ops with a shape-only
path) and keeps the real dtypes in its collectives, so its counted terms
are already what those functions estimate.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # bf16 FLOP/s per card, dense, on the tensor cores
    hbm_bw: float  # bytes/s per card
    ici_bw: float  # bytes/s per link, each way
    hbm_bytes: float  # capacity per card
    peak_tf32_flops: float  # TF32 FLOP/s on the tensor cores
    peak_fp32_flops: float  # fp32 FLOP/s outside the tensor cores


H100 = Hardware("nvidia-h100-sxm", 989e12, 3.35e12, 450e9, 80e9, 495e12, 67e12)


def model_flops(cfg, shape, *, include_attention=True):
    """Analytic 'useful' FLOPs per step, per device-cluster (whole job)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        base = 6 * n_active * tokens
    elif shape.kind == "prefill":
        base = 2 * n_active * tokens
    else:  # decode: one token per row
        base = 2 * n_active * shape.global_batch
    if include_attention and shape.kind != "decode":
        # quadratic attention term: 12*L_attn*H*dh*S^2 per row (train fwd+bwd)
        attn_layers = sum(1 for s in cfg.layer_specs() if s.mixer == "attn")
        per_row = 2 * 2 * attn_layers * cfg.n_heads * cfg.head_dim * shape.seq_len**2 / 2
        if shape.kind == "train":
            per_row *= 3  # bwd recompute ~2x fwd
        base += per_row * shape.global_batch
    return base


def roofline_terms(cost, n_devices, cfg=None, shape=None, hw: Hardware = H100):
    """cost: a rank's counted work (`counter.OpCounter`). Returns dict of terms
    (seconds) + metadata, under the reference's keys."""
    t_compute = cost.flops / hw.peak_flops
    t_memory = cost.hbm_bytes / hw.hbm_bw
    t_coll = cost.total_collective_bytes / hw.ici_bw
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "bound": max(
            (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
            key=lambda kv: kv[1],
        )[0],
        "flops_per_device": cost.flops,
        "matmul_flops_per_device": cost.matmul_flops,
        "hbm_bytes_per_device": cost.hbm_bytes,
        "collective_bytes_per_device": cost.total_collective_bytes,
        "collective_breakdown": dict(cost.collective_bytes),
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        terms["model_flops_total"] = mf
        terms["model_flops_per_device"] = mf / n_devices
        terms["useful_flops_ratio"] = (mf / n_devices) / max(cost.flops, 1.0)
        # roofline fraction: useful work / (dominant-term time x peak)
        t_star = max(t_compute, t_memory, t_coll)
        terms["roofline_fraction"] = (mf / n_devices / hw.peak_flops) / max(t_star, 1e-12)
    return terms
