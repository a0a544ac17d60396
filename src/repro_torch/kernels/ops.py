"""Device dispatch for packed attention (counterpart of `repro.kernels.ops`).

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the Hopper
kernel, which raises on anything it does not take. There is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.packed_flash_attn import packed_flash_attention
from repro_torch.kernels.ref import packed_attention_ref


def packed_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, *, causal=True,
                     window=None, scale=None):
    """Segment-aware attention; k/v carry the un-repeated KV heads."""
    fn = packed_attention_ref if q.device.type == "cpu" else packed_flash_attention
    return fn(q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal, window=window, scale=scale)
