"""Segment-aware (packed) flash attention: Hopper kernel wrapper and its tile map.

Counterpart of `repro.kernels.packed_flash_attn`. The kernel itself is CUDA C++
for sm_90a (`csrc/packed_flash_attn.cu`), built by nvcc at first use and bound
with ctypes. `block_metadata` gives the (B, nQ, nK) int8 map of tiles that can
hold a visible (query, key) pair; the kernel skips the others, so attention
cost follows sum(l_i^2) of the packed documents rather than N^2.

`packed_flash_attention.launches` counts kernel launches (a plain integer a
caller may reset), so a run can show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SOURCE = "packed_flash_attn.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def block_metadata(seg_q, seg_k, pos_q, pos_k, bq, bk, *, causal, window):
    """(B, nQ, nK) int8: 1 iff the tile can contain a visible (q, k) pair.

    Range tests on per-tile (min, max) of segment ids and positions: a tile is
    skipped when the segment ranges cannot intersect (exact for sorted ids,
    which packing gives), when it lies above the causal diagonal, or left of
    the window. Sequence lengths must be multiples of the tile sizes.
    """
    B, Sq = seg_q.shape
    Sk = seg_k.shape[1]
    nq, nk = Sq // bq, Sk // bk
    sq = seg_q.reshape(B, nq, bq)
    sk = seg_k.reshape(B, nk, bk)
    pq = pos_q.reshape(B, nq, bq)
    pk = pos_k.reshape(B, nk, bk)
    # padding (seg == 0) must not lower a tile's minimum segment id
    big = 1 << 30
    sq_min = torch.where(sq != 0, sq, big).amin(-1)
    sq_max = sq.amax(-1)
    sk_min = torch.where(sk != 0, sk, big).amin(-1)
    sk_max = sk.amax(-1)
    ok = (sq_min[:, :, None] <= sk_max[:, None, :]) & (
        sk_min[:, None, :] <= sq_max[:, :, None]
    ) & (sq_max[:, :, None] != 0) & (sk_max[:, None, :] != 0)
    if causal:
        ok &= pq.amax(-1)[:, :, None] >= pk.amin(-1)[:, None, :]
    if window is not None:
        ok &= (pq.amax(-1)[:, :, None] - pk.amin(-1)[:, None, :]) < window + bq + bk
    return ok.to(torch.int8)


def skipped_block_fraction(seg, pos, bq, bk, *, causal=True, window=None):
    """Fraction of (q, k) tiles skipped for a packed batch: the measured
    counterpart of the paper's sum(l^2)/N^2 ratio."""
    meta = block_metadata(seg, seg, pos, pos, bq, bk, causal=causal, window=window)
    return 1.0 - float(meta.float().mean())


def _pad_to(x, mult):
    pad = (-x.shape[1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def tile_map(seg_q, seg_k, pos_q, pos_k, bq, bk, *, causal, window):
    """`block_metadata` of any sequence lengths: the sequences are padded to
    tile multiples with segment id 0, as the reference wrapper pads them."""
    return block_metadata(_pad_to(seg_q, bq), _pad_to(seg_k, bk), _pad_to(pos_q, bq),
                          _pad_to(pos_k, bk), bq, bk, causal=causal, window=window)


def _library():
    lib = build.load(SOURCE)
    fwd = lib.packed_flash_attn_fwd
    if fwd.argtypes is None:  # first use: declare the C signatures
        fwd.restype = ctypes.c_int
        fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.packed_flash_attn_error_string.restype = ctypes.c_char_p
        lib.packed_flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.packed_flash_attn_block_q.restype = ctypes.c_int
        lib.packed_flash_attn_block_k.restype = ctypes.c_int
    return lib


def tile_sizes():
    """(block_q, block_k) the compiled kernel uses."""
    lib = _library()
    return lib.packed_flash_attn_block_q(), lib.packed_flash_attn_block_k()


def _check(q, k, v, seg_q, seg_k, pos_q, pos_k):
    if q.device.type != "cuda":
        raise ValueError(f"the packed flash attention kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("seg_q", seg_q), ("seg_k", seg_k),
                    ("pos_q", pos_q), ("pos_k", pos_k)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if tuple(k.shape) != (B, Sk, K, dh) or tuple(v.shape) != (B, Sk, K, dh):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {K}")
    if min(B, Sq, Sk) == 0:
        raise ValueError("empty batch or sequence")
    for name, t, S in (("seg_q", seg_q, Sq), ("pos_q", pos_q, Sq),
                       ("seg_k", seg_k, Sk), ("pos_k", pos_k, Sk)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, S):
            raise ValueError(f"{name} must be int32 of shape {(B, S)}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_q", seg_q), ("seg_k", seg_k),
                    ("pos_q", pos_q), ("pos_k", pos_k)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                           causal=True, window=None, scale=None):
    """q (B,Sq,H,dh); k/v (B,Sk,K,dh) un-repeated -> (B,Sq,H,dh), on the card.

    Raises on a tensor the kernel does not take; never falls back.
    """
    _check(q, k, v, seg_q, seg_k, pos_q, pos_k)
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    lib = _library()
    bq, bk = lib.packed_flash_attn_block_q(), lib.packed_flash_attn_block_k()
    blk_ok = tile_map(seg_q, seg_k, pos_q, pos_k, bq, bk, causal=causal, window=window)
    nq, nk = blk_ok.shape[1], blk_ok.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.packed_flash_attn_fwd(
            _DTYPE_CODE[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr(), seg_k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
            blk_ok.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, nq, nk, float(scale),
            int(causal), int(window is not None), int(window or 0), stream)
    if rc != 0:
        msg = lib.packed_flash_attn_error_string(rc).decode()
        raise RuntimeError(f"packed flash attention launch failed: {msg} ({rc})")
    packed_flash_attention.launches += 1
    return out


packed_flash_attention.launches = 0
