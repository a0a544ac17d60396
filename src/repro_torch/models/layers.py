"""Common layers: norms, rotary embeddings (M-RoPE too), the causal depthwise
conv, initializers (`repro.models.layers`)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(generator, shape, in_axis=0, *, dtype=torch.float32, device="cuda"):
    """normal / sqrt(fan_in), drawn in float32 and stored in `dtype`."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(np.prod([shape[a] for a in in_axis]))
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


# parameters of more than one axis that stay float32 whatever dtype the
# model's matrices take: the reference uses them in float32 arithmetic only
# (Mamba's `A = -exp(A_log)`, sLSTM's recurrence `r_g`, cast to float32, and
# its gate bias `b_g` in `gx + gr + b_g`), never cast to the compute dtype;
# one-axis parameters (norms, biases) are float32 always
FP32_PARAMS = frozenset({"A_log", "r_g", "b_g"})


def param_dtype(name, ndim, dtype):
    """The dtype a parameter named `name` of `ndim` axes is stored in when
    the model's matrices take `dtype` (`init_params`, `bridge`)."""
    return dtype if ndim >= 2 and name not in FP32_PARAMS else torch.float32


def rms_norm(x, weight, eps=1e-6):
    """RMS over the last axis in float32, scaled by (1 + weight), cast back."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def head_rms_norm(x, weight, eps=1e-6):
    """qk-norm: RMS over the head_dim of (..., H, dh)."""
    return rms_norm(x, weight, eps)


def rope_angles(positions, head_dim, theta, sections=None):
    """Rotary angles, (..., head_dim//2) float32.

    positions: (...,) integers for standard RoPE, or (..., 3) for M-RoPE with
    `sections` (t, h, w): the first sections[0] frequency slots take the t
    position, the next sections[1] the h position, the last the w position.
    """
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    if sections is None:
        return positions.float()[..., None] * inv_freq
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim // 2 = {half}")
    # each frequency slot's position axis, from a list (a meta tensor, as
    # the dry-run's, holds no repeat counts)
    axis = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                        device=positions.device)
    return positions.float()[..., axis] * inv_freq


def apply_rope(x, angles):
    """Rotate-half RoPE. x: (..., H, dh); angles: (..., dh//2).

    cos and sin are cast to x's dtype before the multiply, as the reference
    does; bf16 results depend on it.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_conv1d(x, w, b, segment_ids=None):
    """Depthwise causal conv over the sequence: x (B,S,C), w (C,K), b (C,).

    K shifted multiply-adds (K <= 4), in x's dtype; where `segment_ids`
    (B,S) is given, a tap that reaches across a packed-document boundary
    reads 0.
    """
    K, S = w.shape[-1], x.shape[1]
    out = x * w[:, -1]
    for j in range(1, K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :S]
        if segment_ids is not None:
            same = F.pad(segment_ids, (j, 0))[:, :S] == segment_ids
            shifted = torch.where(same[..., None], shifted, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))
        out = out + shifted * w[:, -1 - j]
    return out + b


def local_conv1d(policy, x, w, b, segment_ids=None):
    """`causal_conv1d` of x (B,S,C) over an inner width C (`"dinner"`): under
    a mesh on each rank's rows and channels (`ShardingPolicy.run_local`),
    never splitting the sequence."""
    rows = ("batch", None, "dinner")
    return policy.run_local(lambda *a: (causal_conv1d(*a),),
                            (rows, ("dinner", None), ("dinner",), ("batch", None)),
                            ((rows, tuple(x.shape)),), x, w, b, segment_ids)[0]


def doc_keep(segment_ids, like):
    """(B,S) bool, False where a packed document starts (the recurrences'
    state resets there); all True without segment ids (like's rows)."""
    if segment_ids is None:
        return torch.ones(like.shape[:2], dtype=torch.bool, device=like.device)
    S = segment_ids.shape[1]
    return segment_ids == F.pad(segment_ids, (1, 0), value=-1)[:, :S]
