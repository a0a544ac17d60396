"""Plain PyTorch version of the packed flash attention kernel.

Dense masked softmax with exactly the kernel's semantics (as
`repro.kernels.ref.packed_attention_ref`):
  * block-diagonal packing mask (same nonzero segment id),
  * causal mask on positions,
  * optional sliding window (pos_q - pos_k < window),
  * GQA (query head h reads kv head h * K // H),
  * rows with no visible key return 0.
It is the kernel's CPU path and its oracle on the card, and autograd
through it (`packed_attention_ref_backward`) is the backward kernel's oracle.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(seg_q, seg_k, pos_q, pos_k, *, causal, window):
    """(B, Sq, Sk) bool: key visible from query."""
    mask = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] != 0)
    if causal:
        mask &= pos_q[:, :, None] >= pos_k[:, None, :]
    if window is not None:
        mask &= (pos_q[:, :, None] - pos_k[:, None, :]) < window
    return mask


def packed_attention_ref(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                         causal=True, window=None, scale=None):
    """q (B,Sq,H,dh); k/v (B,Sk,K,dh); seg/pos (B,S) int32 -> (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    if scale is None:
        scale = dh ** -0.5
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    mask = attention_mask(seg_q, seg_k, pos_q, pos_k, causal=causal, window=window)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l_q = l[..., 0].transpose(1, 2)[..., None]  # (B,Sq,H,1)
    o = torch.where(l_q > 0, o / l_q.clamp_min(1e-30), 0.0)
    return o.to(q.dtype)


def packed_attention_ref_backward(q, k, v, d_out, seg_q, seg_k, pos_q, pos_k, *,
                                  causal=True, window=None, scale=None):
    """(dq, dk, dv) of `packed_attention_ref` for the output gradient d_out,
    by autograd; dk and dv carry the un-repeated KV heads."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = packed_attention_ref(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                   causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, (q, k, v), d_out)
