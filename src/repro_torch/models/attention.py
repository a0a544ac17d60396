"""GQA attention over packed segments with qk-norm and RoPE; KV-cache decode.

Counterpart of `repro.models.attention.attention`. Prefill and the packed
forward go through `kernels.ops.packed_attention` (the Hopper kernel on the
card) with the KV heads un-repeated; decode is dense masked attention over the
cache in plain PyTorch, as the reference computes it in jnp.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import packed_attention
from repro_torch.kernels.ref import NEG_INF, attention_mask
from repro_torch.models.layers import apply_rope, dense_init, head_rms_norm, rope_angles


def init_attention(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(generator, (D, H, dh), **kw),
        "wk": dense_init(generator, (D, K, dh), **kw),
        "wv": dense_init(generator, (D, K, dh), **kw),
        "wo": dense_init(generator, (H, dh, D), in_axis=(0, 1), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros(dh, dtype=torch.float32, device=device)
    return p


def _sdpa_dense(q, k, v, mask, scale):
    """q (B,Sq,H,dh), k/v (B,Sk,K,dh), mask (B,Sq,Sk). Query head h reads kv
    head h // (H // K), the same map as repeating the KV heads."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, dh)
    scores = torch.einsum("bqkrd,btkd->bkrqt", qg, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqt,btkd->bqkrd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dh)


def attention(cfg, spec, p, x, md, cache=None):
    """Full attention layer.

    md: 'positions' (B,S) packed RoPE positions, 'segment_ids' (B,S),
        'abs_positions' (B,S) for the causal test, and for decode 'lengths'
        (B,) current KV fill.
    cache: None for the packed forward and prefill, else {'k': (B,T,K,dh),
        'v': ..., 'pos': (B,T)} (T slots: `model.cache_len`), updated in place (the reference returns a
        new array; in place saves a cache copy per layer and step).
    Returns (out (B,S,D), new_cache).
    """
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = x.shape[:2]
    scale = 1.0 / math.sqrt(dh)
    window = cfg.window if spec.attn_kind == "swa" else None
    causal = md.get("causal", True)

    q = (x @ p["wq"].reshape(D, H * dh).to(x.dtype)).view(B, S, H, dh)
    k = (x @ p["wk"].reshape(D, K * dh).to(x.dtype)).view(B, S, K, dh)
    v = (x @ p["wv"].reshape(D, K * dh).to(x.dtype)).view(B, S, K, dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    if md.get("rope", True):
        ang = rope_angles(md["positions"], dh, cfg.rope_theta)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)

    if cache is None:
        seg, pos = md["segment_ids"], md["abs_positions"]
        out = packed_attention(q, k, v, seg, seg, pos, pos,
                               causal=causal, window=window, scale=scale)
        new_cache = {"k": k, "v": v, "pos": pos} if md.get("collect_state") else None
    else:
        # decode: ring-buffer insert at (position % T). For full-attention
        # layers T == max_len, so slot == position; for sliding-window layers
        # T = min(2 * window, max_len), and a slot is overwritten once its
        # position is out of the window (the mask drops it before that)
        idx = md["lengths"]
        rows = torch.arange(B, device=x.device)
        T = cache["k"].shape[1]
        slot = idx % T
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][rows, slot] = idx.to(torch.int32)
        pos_arr = cache["pos"]
        pos_k = pos_arr.clamp_min(0)
        seg_k = (pos_arr >= 0).to(torch.int32)  # valid cache entries
        pos_q = idx[:, None] + torch.arange(S, device=x.device)[None]
        seg_q = torch.ones((B, S), dtype=torch.int32, device=x.device)
        mask = attention_mask(seg_q, seg_k, pos_q, pos_k, causal=causal, window=window)
        out = _sdpa_dense(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, scale)
        new_cache = cache

    y = out.reshape(B, S, H * dh) @ p["wo"].reshape(H * dh, D).to(x.dtype)
    return y, new_cache
