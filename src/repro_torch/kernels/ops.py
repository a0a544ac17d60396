"""Device dispatch for packed attention (counterpart of `repro.kernels.ops`).

A CPU tensor takes the plain PyTorch version, which autograd differentiates.
Any other tensor takes two PyTorch ops, `repro_torch::packed_attn_fwd` (out
and the row log-sum-exp) and `repro_torch::packed_attn_bwd` (dq, dk, dv):
under autograd both through `PackedFlashAttention`; without it (no_grad,
inference_mode) the forward op alone. On a CUDA tensor an op launches the
Hopper kernel (`packed_flash_attention`, `packed_flash_attention_backward`)
or raises; there is no fallback. On a meta or fake tensor it returns the
outputs' shapes and dtypes alone (its fake implementation never reaches
the kernels' checks or their build), so a step traces on the meta device,
under DTensor and under a dispatch mode (`roofline.counter`).

Each op has a FLOP formula in `torch.utils.flop_counter`'s registry
(`attention_flops`): 2 * dh per visible (query, key) pair and head for each
of its matrix products, 2 forward, 5 backward.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.packed_flash_attn import (
    packed_flash_attention,
    packed_flash_attention_backward,
)
from repro_torch.kernels.ref import attention_mask, packed_attention_ref

FORWARD_PRODUCTS, BACKWARD_PRODUCTS = 2, 5  # QK^T, PV; and QK^T, dP, dV, dK, dQ


@torch.library.custom_op("repro_torch::packed_attn_fwd", mutates_args=(), device_types="cuda")
def packed_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg_q: torch.Tensor,
                    seg_k: torch.Tensor, pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                    window: Optional[int], scale: Optional[float],
                    need_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): lse (B,H,Sq) fp32 with `need_lse`, else an empty fp32 tensor."""
    if need_lse:
        return packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal,
                                      window=window, scale=scale, return_lse=True)
    out = packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal,
                                 window=window, scale=scale)
    return out, q.new_empty((0,), dtype=torch.float32)


@packed_attn_fwd.register_fake
def _(q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale, need_lse):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq) if need_lse else (0,),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::packed_attn_bwd", mutates_args=(), device_types="cuda")
def packed_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    lse: torch.Tensor, d_out: torch.Tensor, seg_q: torch.Tensor,
                    seg_k: torch.Tensor, pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                    window: Optional[int],
                    scale: Optional[float]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return packed_flash_attention_backward(q, k, v, out, lse, d_out, seg_q, seg_k, pos_q, pos_k,
                                           causal=causal, window=window, scale=scale)


@packed_attn_bwd.register_fake
def _(q, k, v, out, lse, d_out, seg_q, seg_k, pos_q, pos_k, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


# the ops themselves: a call skips the Python layer of `custom_op`'s wrapper
_FWD = torch.ops.repro_torch.packed_attn_fwd.default
_BWD = torch.ops.repro_torch.packed_attn_bwd.default


def _shape_only(t):
    from torch._subclasses.fake_tensor import FakeTensor

    return t.device.type == "meta" or isinstance(t, FakeTensor)


def visible_pairs(seg_q, seg_k, pos_q, pos_k, *, causal, window):
    """(query, key) pairs an attention call sees, summed over its rows.

    On tensors with data, the pairs these ids make visible (`attention_mask`,
    a row of the batch at a time). On shapes alone (meta or fake ids) the
    count assumes one document a row, at positions 0..S-1 on both sides:
    Sq * Sk pairs a row without causality or window, sum(min(i + 1, Sk))
    causal, and the window's band where there is one."""
    if _shape_only(seg_q) or _shape_only(seg_k):
        B, Sq, Sk = seg_q.shape[0], seg_q.shape[1], seg_k.shape[1]
        i = np.arange(Sq, dtype=np.int64)
        hi = np.minimum(i + 1, Sk) if causal else np.full_like(i, Sk)
        lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros_like(i)
        return int(B * np.maximum(hi - lo, 0).sum())
    return sum(int(attention_mask(seg_q[b:b + 1], seg_k[b:b + 1], pos_q[b:b + 1],
                                  pos_k[b:b + 1], causal=causal, window=window).sum())
               for b in range(seg_q.shape[0]))


def attention_flops(q, seg_q, seg_k, pos_q, pos_k, *, causal, window, products):
    """2 * dh per visible pair and head for each of `products` matrix products."""
    H, dh = q.shape[2], q.shape[3]
    return 2 * products * dh * H * visible_pairs(seg_q, seg_k, pos_q, pos_k, causal=causal,
                                                 window=window)


@register_flop_formula(torch.ops.repro_torch.packed_attn_fwd, get_raw=True)
def _fwd_flops(q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale, need_lse, *,
               out_val=None, **kwargs):
    return attention_flops(q, seg_q, seg_k, pos_q, pos_k, causal=causal, window=window,
                           products=FORWARD_PRODUCTS)


@register_flop_formula(torch.ops.repro_torch.packed_attn_bwd, get_raw=True)
def _bwd_flops(q, k, v, out, lse, d_out, seg_q, seg_k, pos_q, pos_k, causal, window, scale, *,
               out_val=None, **kwargs):
    return attention_flops(q, seg_q, seg_k, pos_q, pos_k, causal=causal, window=window,
                           products=BACKWARD_PRODUCTS)


class PackedFlashAttention(torch.autograd.Function):
    """Packed flash attention through the forward and backward ops."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale):
        out, lse = _FWD(q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k, pos_q, pos_k)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, seg_q, seg_k, pos_q, pos_k = ctx.saved_tensors
        dq, dk, dv = _BWD(q, k, v, out, lse, d_out.contiguous(), seg_q, seg_k, pos_q, pos_k,
                          *ctx.attrs)
        return dq, dk, dv, None, None, None, None, None, None, None


def packed_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, *, causal=True,
                     window=None, scale=None):
    """Segment-aware attention; k/v carry the un-repeated KV heads."""
    if q.device.type == "cpu":
        return packed_attention_ref(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal,
                                    window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return PackedFlashAttention.apply(q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window,
                                          scale)
    return _FWD(q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale, False)[0]
