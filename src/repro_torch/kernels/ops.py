"""Device dispatch for packed attention (counterpart of `repro.kernels.ops`).

A CPU tensor takes the plain PyTorch version, which autograd differentiates.
A CUDA tensor takes the Hopper kernels: under autograd the forward kernel
(with its row log-sum-exp) and the backward kernel through
`PackedFlashAttention`; without it (no_grad, inference_mode) the forward
kernel alone. Either raises on anything it does not take; there is no
fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packed_flash_attn import (
    packed_flash_attention,
    packed_flash_attention_backward,
)
from repro_torch.kernels.ref import packed_attention_ref


class PackedFlashAttention(torch.autograd.Function):
    """Packed flash attention with the hand-written backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, pos_q, pos_k, causal, window, scale):
        out, lse = packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal,
                                          window=window, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k, pos_q, pos_k)
        ctx.attrs = {"causal": causal, "window": window, "scale": scale}
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, seg_q, seg_k, pos_q, pos_k = ctx.saved_tensors
        dq, dk, dv = packed_flash_attention_backward(
            q, k, v, out, lse, d_out.contiguous(), seg_q, seg_k, pos_q, pos_k, **ctx.attrs)
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
    return packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal,
                                  window=window, scale=scale)
