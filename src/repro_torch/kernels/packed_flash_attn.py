"""Segment-aware (packed) flash attention: Hopper kernel wrappers and their tile map.

Counterpart of `repro.kernels.packed_flash_attn`. Two CUDA C++ kernels for
sm_90a, built by nvcc at first use and bound with ctypes, one per input type,
both on the tensor cores: bf16 in `csrc/packed_flash_attn_sm90.cu` (wgmma fed
by TMA through an mbarrier ring, 128 x 128 tiles, 128 x 64 at head_dim 256,
64 x 128 at head_dim 64 and below, where a CTA takes one map row and splits
its key walk between its two warpgroups, merging their softmaxes, or, on
large grids, two map rows (`pair_rows`));
fp32 in `csrc/packed_flash_attn.cu` (every product in 3xTF32 by mma.sync, 64
query rows a CTA over 16-key stages copied ahead by cp.async, its tile map at
64 x 16, walked as the fp32 backward's dQ kernel walks the same map; the walk
split over CTAs where the grid would leave SMs idle, `fwd_splits`).
A `Kernel` is chosen by (dtype, head_dim) (`kernel_for`,
`backward_kernel_for`): its tiles may differ with the head width. Every
width in `HEAD_DIMS` is compiled as it is, in both dtypes: bf16 at head_dim
80 (h2o-danube) runs kernels of its own, whose 160-byte rows sit in shared
memory as five 16-column chunks under the 32-byte swizzle.
`block_metadata` gives the (B, nQ, nK) int8 map of tiles that can hold a
visible (query, key) pair; the kernels skip the others, so attention
cost follows sum(l_i^2) of the packed documents rather than N^2. `tile_map`
adds the tiles in which every pair is visible, which the bf16 kernel runs
without a mask.

The forward can also return the row log-sum-exp (`return_lse=True`), which
`packed_flash_attention_backward` takes: it computes dq, dk and dv under the
same tile skip, again one source per input type. bf16 runs on the tensor
cores (`csrc/packed_flash_attn_bwd_sm90.cu`: wgmma fed by TMA, a dK/dV kernel
at 64 x 128 tiles and a dQ kernel at 128 x 128; at head_dim 256 a dK/dV
kernel at 64 x 64 whose two warpgroups split the products, its GQA group
split over CTAs where the grid would leave SMs idle (`kv_splits`), and the
dQ kernel at 128 x 32; both tile maps derived from one map by `coarsen`; at
head_dim 64 and below two launches, not three: a dQ kernel at 64 x 128 that
also computes delta, then a dK/dV kernel on `dkdv_ctas` persistent CTAs that
walks each key tile's compacted list of query tiles); fp32
on the tensor cores too (`csrc/packed_flash_attn_bwd.cu`: every product in
3xTF32 by mma.sync, each fp32 operand split into two TF32 parts, which holds
the fp32 parity tolerance where one TF32 product does not; a dK/dV kernel
at 32 x 64 tiles (16 x 64 at head_dim 256) and a dQ kernel at 64 x 16,
tiles copied ahead by cp.async, each loop split over CTAs where its grid
would leave SMs idle, `tf32_splits`). The sm_90a sources share
`csrc/sm90_common.cuh`; the two fp32 sources also `csrc/tf32_common.cuh`
(fragments, copies and the tile walk).
`kernels.ops` wires forward and backward into autograd.

`packed_flash_attention.launches` and `packed_flash_attention_backward.launches`
count launches per kernel source (dicts a caller may reset), so a run can
show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 80, 128, 256)


@dataclass(frozen=True)
class Kernel:
    """One compiled kernel source at some head widths: its file under `csrc/`,
    the prefix of its C symbols, the tile sizes its `blk_ok` map is built at,
    the names of its CUDA kernels as the profiler shows them, the tiles of a
    backward's dQ kernel where they differ (None: the same), and the rule
    that splits a backward's loops over CTAs where its grid would leave SMs
    idle ("kv": `kv_splits`, "tf32": `tf32_splits`, None: no split)."""

    source: str
    symbol: str
    block_q: int
    block_k: int
    names: tuple[str, ...]
    dq_tiles: tuple[int, int] | None = None
    split_rule: str | None = None

    def splits(self, B, H, K, Sqp, Skp, sms) -> tuple[int, int]:
        """(dK/dV splits, dQ splits) of this backward at batch B, Sqp and Skp
        padded queries and keys, on `sms` SMs, by its split rule."""
        if self.split_rule == "kv":
            return kv_splits(self, B, H, K, Skp, sms), 1
        if self.split_rule == "tf32":
            return tf32_splits(self, B, H, K, Sqp, Skp, sms)
        return 1, 1


SM90 = Kernel("packed_flash_attn_sm90.cu", "packed_flash_attn_sm90", 128, 128,
              ("packed_flash_attn_sm90_kernel",))
SM90_WIDE = Kernel(SM90.source, SM90.symbol, 128, 64, SM90.names)  # head_dim 256
# head_dim <= 64: 64-row map rows, one a CTA whose two warpgroups take its key
# tiles in turn, or two a CTA (`pair_rows`)
SM90_NARROW = Kernel(SM90.source, SM90.symbol, 64, 128, ("packed_flash_attn_sm90_narrow_kernel",))
FWD_TF32 = Kernel("packed_flash_attn.cu", "packed_flash_attn", 64, 16,
                  ("packed_flash_attn_tf32_kernel", "packed_flash_attn_tf32_merge_kernel"))
# (the merge runs only where `fwd_splits` splits the key walk)
BWD_SM90 = Kernel("packed_flash_attn_bwd_sm90.cu", "packed_flash_attn_bwd_sm90", 64, 128,
                  ("bwd_sm90_delta_kernel", "bwd_sm90_dkdv_kernel", "bwd_sm90_dq_kernel"),
                  dq_tiles=(128, 128))
# head_dim 256; the sum runs only with splits
BWD_SM90_WIDE = Kernel(BWD_SM90.source, BWD_SM90.symbol, 64, 64,
                       ("bwd_sm90_delta_kernel", "bwd_sm90_dkdv_split_kernel",
                        "bwd_sm90_dq_kernel", "bwd_sm90_kv_sum_kernel"),
                       dq_tiles=(128, 32), split_rule="kv")
# head_dim <= 64: dQ at 64 rows (two a CTA where `pair_rows` says so) with
# the delta pass folded in, launched first, then dK/dV on `dkdv_ctas`
# persistent CTAs
BWD_SM90_NARROW = Kernel(BWD_SM90.source, BWD_SM90.symbol, 64, 128,
                         ("bwd_sm90_dq_narrow_kernel", "bwd_sm90_dkdv_narrow_kernel"),
                         dq_tiles=(64, 128))
BWD_TF32 = Kernel("packed_flash_attn_bwd.cu", "packed_flash_attn_bwd", 32, 64,
                  ("bwd_tf32_delta_kernel", "bwd_tf32_dkdv_kernel", "bwd_tf32_dq_kernel",
                   "bwd_tf32_sum_kernel"),
                  dq_tiles=(64, 16), split_rule="tf32")  # the sum runs only with splits
BWD_TF32_WIDE = Kernel(BWD_TF32.source, BWD_TF32.symbol, 16, 64, BWD_TF32.names,
                       dq_tiles=(64, 16), split_rule="tf32")  # head_dim 256

def _checked_dims(dtype, head_dim):
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")


def kernel_for(dtype, head_dim) -> Kernel:
    """The forward kernel that takes inputs of `dtype` and `head_dim`."""
    _checked_dims(dtype, head_dim)
    if dtype == torch.float32:
        return FWD_TF32
    return SM90_WIDE if head_dim == 256 else SM90_NARROW if head_dim <= 64 else SM90


def backward_kernel_for(dtype, head_dim) -> Kernel:
    """The backward kernel that takes inputs of `dtype` and `head_dim`."""
    _checked_dims(dtype, head_dim)
    if dtype == torch.float32:
        return BWD_TF32_WIDE if head_dim == 256 else BWD_TF32
    return BWD_SM90_WIDE if head_dim == 256 else BWD_SM90_NARROW if head_dim <= 64 else BWD_SM90


def tile_sizes(dtype, head_dim):
    """(block_q, block_k) of the forward kernel that takes `dtype` and `head_dim`."""
    kern = kernel_for(dtype, head_dim)
    return kern.block_q, kern.block_k


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


def _pad_all(seg_q, seg_k, pos_q, pos_k, bq, bk):
    return _pad_to(seg_q, bq), _pad_to(seg_k, bk), _pad_to(pos_q, bq), _pad_to(pos_k, bk)


def tile_map(seg_q, seg_k, pos_q, pos_k, bq, bk, *, causal, window):
    """(B, nQ, nK) int8 tile codes at any sequence lengths: 0 = no visible
    pair (skip), 1 = some pairs visible (mask per element), 2 = every pair
    visible (no mask needed). The sequences are padded to tile multiples with
    segment id 0, as the reference wrapper pads them.

    Without a window, nonzero exactly where `block_metadata` is 1. With one,
    a tile is skipped only when min(pos_q) - max(pos_k) >= window, which no
    visible pair can cross. `block_metadata`'s window test, max(pos_q) -
    min(pos_k) < window + bq + bk, assumes positions run contiguously through
    a tile and drops visible pairs when a key tile holds a document start or
    padding (position 0); the kernels do not use it."""
    seg_q, seg_k, pos_q, pos_k = _pad_all(seg_q, seg_k, pos_q, pos_k, bq, bk)
    ok = block_metadata(seg_q, seg_k, pos_q, pos_k, bq, bk, causal=causal, window=None)
    B = seg_q.shape[0]
    sq, pq = seg_q.reshape(B, -1, bq), pos_q.reshape(B, -1, bq)
    sk, pk = seg_k.reshape(B, -1, bk), pos_k.reshape(B, -1, bk)
    if window is not None:
        ok &= ((pq.amin(-1)[:, :, None] - pk.amax(-1)[:, None, :]) < window).to(torch.int8)
    # one nonzero segment over both tiles, and every position pair in range
    seg_one = sq.amax(-1)[:, :, None]
    full = ((sq.amin(-1) == sq.amax(-1))[:, :, None] & (sk.amin(-1) == sk.amax(-1))[:, None, :]
            & (seg_one == sk.amax(-1)[:, None, :]) & (seg_one != 0))
    if causal:
        full &= pq.amin(-1)[:, :, None] >= pk.amax(-1)[:, None, :]
    if window is not None:
        full &= (pq.amax(-1)[:, :, None] - pk.amin(-1)[:, None, :]) < window
    return ok + full.to(torch.int8)


def coarsen(codes, fq, fk):
    """Tile codes of tiles fq x fk times larger, from a (B, nQ, nK) map whose
    tile counts they divide: 0 where every part is 0, 2 where every part is
    2, else 1. Applied to a `tile_map`, the result is never 0 on a tile with
    a visible pair, 2 exactly where every pair is visible, and 0 on at least
    the tiles `tile_map` skips at the larger tiles (on more where its range
    tests over a large tile hold though no part has a visible pair)."""
    B, nq, nk = codes.shape
    parts = codes.reshape(B, nq // fq, fq, nk // fk, fk)
    lo, hi = parts.amin(dim=(2, 4)), parts.amax(dim=(2, 4))
    return torch.where(hi == 0, 0, torch.where(lo == 2, 2, 1)).to(torch.int8)


def backward_tile_maps(kern: Kernel, seg_q, seg_k, pos_q, pos_k, *, causal, window):
    """The backward kernel's ids, padded to whole tiles of every kernel it
    launches, and its tile maps: (padded, (blk, blk_dq)). `tile_map` runs
    once, at the smaller of the two kernels' tiles on each side (tiles are
    powers of two, so it divides the larger); each kernel's map is derived
    from it by `coarsen` where its tiles are larger."""
    bq, bk = kern.dq_tiles or (kern.block_q, kern.block_k)
    padded = _pad_all(seg_q, seg_k, pos_q, pos_k, max(bq, kern.block_q), max(bk, kern.block_k))
    fq, fk = min(bq, kern.block_q), min(bk, kern.block_k)
    fine = tile_map(*padded, fq, fk, causal=causal, window=window)

    def at(tq, tk):
        return fine if (tq, tk) == (fq, fk) else coarsen(fine, tq // fq, tk // fk)
    blk = at(kern.block_q, kern.block_k)
    return padded, (blk, blk if kern.dq_tiles is None else at(bq, bk))


def kv_splits(kern: Kernel, B, H, K, Skp, sms) -> int:
    """How many dK/dV CTAs share the query heads of one GQA group (H / K of
    them) at batch B and Skp padded keys: 1, except in the head_dim 256
    backward, whose grid of K x B x Skp / 64 CTAs can leave SMs idle
    (gemma3-1b at 1 x 4096: 64 on 132): there the most that divide the group
    and keep the grid within one wave of `sms` SMs. The CTAs of a split
    store fp32 parts, which a second kernel sums. 1 for a kernel whose rule
    is not "kv"."""
    if kern.split_rule != "kv":
        return 1
    group, ctas = H // K, K * B * (Skp // kern.block_k)
    wave = max(sms, ctas)
    return max(s for s in range(1, group + 1) if group % s == 0 and ctas * s <= wave)


PAIR_WAVES = 2  # waves of 128-row CTAs from which the narrow kernels pair their map rows


def pair_rows(kern: Kernel, B, H, nQ, sms) -> int:
    """1 where the head_dim <= 64 bf16 forward, or the dQ kernel of that
    width's backward, runs two of its 64-row map rows a CTA (pair mode: each
    K/V tile serves 128 rows, as at the wider widths), at batch B, H heads
    and nQ map rows: where its grid of H x B x ceil(nQ / 2) such CTAs fills
    `PAIR_WAVES` waves of `sms` SMs or more (whisper's encoder: 768 CTAs at
    4 x 1500, 512 at 1 x 4096). 0 (split mode: one map row a CTA, its key
    walk split between the two warpgroups) on smaller grids (whisper's
    decoder and cross-attention) and for every other kernel."""
    if kern not in (SM90_NARROW, BWD_SM90_NARROW):
        return 0
    return int(H * B * -(-nQ // 2) >= PAIR_WAVES * sms)


def dkdv_ctas(kern: Kernel, B, K, Skp, sms) -> int:
    """How many persistent CTAs the head_dim <= 64 bf16 backward's dK/dV
    kernel runs at batch B, K KV heads and Skp padded keys, on `sms` SMs:
    one an SM, and no more than its work items (K x B x Skp / block_k key
    tiles, which CTA c starts at item c and then takes from a counter in the
    order of key tiles). 0 for a kernel that runs no persistent CTAs."""
    if kern is not BWD_SM90_NARROW:
        return 0
    return min(sms, K * B * (Skp // kern.block_k))


MIN_SPLIT_PAIRS = 2048  # (query, key) pairs of a split loop's CTA, at the least


def tf32_splits(kern: Kernel, B, H, K, Sqp, Skp, sms) -> tuple[int, int]:
    """(dK/dV splits, dQ splits) of the fp32 backward at batch B, Sqp and Skp
    padded queries and keys, on `sms` SMs. A dK/dV CTA loops over its GQA
    group's (head, query tile) pairs, H / K x Sqp / block_q of them; a dQ
    CTA over Skp / block_k key tiles. Each loop is split over CTAs until its
    grid holds about four waves of `sms` CTAs (the power of two at or below
    4 sms / CTAs), but leaves each CTA at least `MIN_SPLIT_PAIRS` (query,
    key) pairs of its loop, since a CTA's fixed cost of copies in and parts
    out outweighs a smaller share: one 32 x 64 stage of a dK/dV CTA, two
    64 x 16 stages of a dQ CTA. Its CTAs run one an SM at head_dim 80 and
    above, and the key tiles that open a packed document see several times
    the mean work, so a grid of one or two waves waits on its longest CTAs.
    Each split CTA stores fp32 parts, which a second kernel sums in order.
    (1, 1) for a kernel whose rule is not "tf32"."""
    if kern.split_rule != "tf32":
        return 1, 1
    bq, bk = kern.dq_tiles

    def split(ctas, iters, pairs):  # pairs: (query, key) pairs an iteration
        most = min(4 * sms // ctas, iters * pairs // MIN_SPLIT_PAIRS)
        return 1 << (max(1, most).bit_length() - 1)
    return (split(K * B * (Skp // kern.block_k), H // K * (Sqp // kern.block_q),
                  kern.block_q * kern.block_k),
            split(H * B * (Sqp // bq), Skp // bk, bq * bk))


def fwd_splits(kern: Kernel, B, H, Sqp, Skp, sms) -> int:
    """How many CTAs share the key walk of one (batch, head, query tile) of
    the fp32 forward at batch B, Sqp and Skp padded queries and keys, on
    `sms` SMs: until the grid fills one wave of the SMs (the power of two at
    or below sms / CTAs), leaving each CTA at least `MIN_SPLIT_PAIRS`
    (query, key) pairs of its walk. The fp32 parity paths' 2 x 256 batches
    make 32 CTAs of 4 heads, whose longest walk sets the time: 4 splits
    there, the best of 1 to 16 at head_dim 80, 128 and 256 (PERF.md: 8
    cost gemma3's dh 256, one CTA an SM, 50% more). Each part stores its
    unnormalised output and its rows' max and sum, which a second kernel
    merges in order. 1 for another kernel."""
    if kern.source != FWD_TF32.source:
        return 1
    ctas = H * B * (Sqp // kern.block_q)
    most = min(sms // ctas, Skp * kern.block_q // MIN_SPLIT_PAIRS)
    return 1 << (max(1, most).bit_length() - 1)


@functools.cache
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# head_dim, q, k, v, seg_q, seg_k, pos_q, pos_k, blk_ok, out, lse, B, Sq, Sk, H, KH, nQ, nK,
# scale, causal, has_window, window, then (bf16) pair or (fp32) splits, part, then stream
_FWD_HEAD = [_INT] + [_PTR] * 10 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 3
_FWD_ARGTYPES = {SM90.source: _FWD_HEAD + [_INT, _PTR],
                 FWD_TF32.source: _FWD_HEAD + [_INT, _PTR, _PTR]}
_BWD_ARGTYPES = {
    # head_dim, q, k, v, out, d_out, lse, seg_q, seg_k, pos_q, pos_k, blk_kv, blk_dq, stats,
    # dq, dk, dv, B, Sq, Sk, H, KH, Sqp, Skp, scale, causal, has_window, window, kv_splits,
    # kv_part, q_splits, q_part, stream
    BWD_TF32.source: [_INT] + [_PTR] * 16 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 4
    + [_PTR, _INT, _PTR, _PTR],
    # head_dim, q, k, v, out, d_out, lse, seg_q, seg_k, pos_q, pos_k, blk_kv, blk_dq, lse2,
    # delta, dq, dk, dv, B, Sq, Sk, H, KH, Sqp, Skp, scale, causal, has_window, window,
    # kv_splits, kv_part, ctas, counter, pair, stream
    BWD_SM90.source: [_INT] + [_PTR] * 17 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 4
    + [_PTR, _INT, _PTR, _INT, _PTR],
}


_tiles_checked: set = set()


def _entry(kern: Kernel, name: str, argtypes, head_dim):
    """The C function `{symbol}_{name}` of the kernel's library, built and
    declared at first use (tile sizes at `head_dim` checked against `kern`)."""
    lib = build.load(kern.source)
    fn = getattr(lib, f"{kern.symbol}_{name}")
    if fn.argtypes is None:
        fn.restype = _INT
        fn.argtypes = argtypes
        err = getattr(lib, f"{kern.symbol}_error_string")
        err.restype, err.argtypes = ctypes.c_char_p, [_INT]
    if (kern, head_dim) not in _tiles_checked:
        tiles = {"block": (kern.block_q, kern.block_k)}
        if kern.dq_tiles is not None:
            tiles["dq_block"] = kern.dq_tiles
        for prefix, want in tiles.items():
            compiled = []
            for side in "qk":
                size = getattr(lib, f"{kern.symbol}_{prefix}_{side}")
                size.restype, size.argtypes = _INT, [_INT]
                compiled.append(size(head_dim))
            if tuple(compiled) != want:
                raise RuntimeError(f"{kern.source}: compiled {prefix} tiles {tuple(compiled)} "
                                   f"!= {want} at head_dim {head_dim}")
        _tiles_checked.add((kern, head_dim))
    return fn


def _raise_on(rc, kern: Kernel, what):
    if rc != 0:
        msg = getattr(build.load(kern.source), f"{kern.symbol}_error_string")(rc).decode()
        raise RuntimeError(f"packed flash attention {what} failed ({kern.source}): {msg} ({rc})")


def _check(q, k, v, seg_q, seg_k, pos_q, pos_k):
    if q.device.type != "cuda":
        raise ValueError(f"the packed flash attention kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("seg_q", seg_q), ("seg_k", seg_k),
                    ("pos_q", pos_q), ("pos_k", pos_k)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kernel_for(q.dtype, dh)
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
        if t.data_ptr() % 16:  # TMA and bulk copies need 16-byte aligned rows
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_like(name, t, like, shape, dtype):
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)} on {like.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def packed_flash_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                           causal=True, window=None, scale=None, return_lse=False):
    """q (B,Sq,H,dh); k/v (B,Sk,K,dh) un-repeated -> (B,Sq,H,dh), on the card.

    bf16 takes the wgmma kernel, fp32 the 3xTF32 one, each compiled at the
    head width and run at its tiles. With `return_lse`,
    also returns the fp32 (B,H,Sq) row log-sum-exp of the scaled scores
    (+inf on rows with no visible key), which the backward takes. Raises on a tensor the kernels do not take; never falls back. The
    output has no gradient: it raises when autograd would need one, so a
    caller that trains goes through `kernels.ops.packed_attention`.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("packed_flash_attention has no autograd graph; call "
                           "repro_torch.kernels.ops.packed_attention to differentiate it")
    _check(q, k, v, seg_q, seg_k, pos_q, pos_k)
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kern = kernel_for(q.dtype, dh)
    if scale is None:
        scale = dh ** -0.5
    fwd = _entry(kern, "fwd", _FWD_ARGTYPES[kern.source], dh)
    bq, bk = kern.block_q, kern.block_k
    padded = _pad_all(seg_q, seg_k, pos_q, pos_k, bq, bk)  # whole tiles of ids
    blk = tile_map(*padded, bq, bk, causal=causal, window=window)
    nq, nk = blk.shape[1], blk.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    tail, part = (), None  # the bf16 kernel's pair mode, or the fp32 kernel's split walk and parts
    if kern.source == SM90.source:
        tail = (pair_rows(kern, B, H, nq, _sm_count(q.device.index)),)
    if kern.source == FWD_TF32.source:
        splits = fwd_splits(kern, B, H, nq * bq, nk * bk, _sm_count(q.device.index))
        if splits > 1:  # outputs, then each row's max and sum
            part = torch.empty(splits * (q.numel() + 2 * B * H * Sq), dtype=torch.float32,
                               device=q.device)
        tail = (splits, part.data_ptr() if part is not None else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fwd(dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *(t.data_ptr() for t in padded), blk.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, Sq, Sk, H, K, nq, nk, float(scale),
                 int(causal), int(window is not None), int(window or 0), *tail, stream)
    _raise_on(rc, kern, "launch")
    packed_flash_attention.launches[kern.source] += 1
    return (out, lse) if return_lse else out


packed_flash_attention.launches = {kern.source: 0 for kern in (SM90, FWD_TF32)}


def packed_flash_attention_backward(q, k, v, out, lse, d_out, seg_q, seg_k, pos_q, pos_k, *,
                                    causal=True, window=None, scale=None):
    """Gradients of `packed_flash_attention` -> (dq, dk, dv), on the card.

    out and lse are the forward's (`return_lse=True`), d_out the gradient of
    out; dk and dv carry the un-repeated KV heads, summed over each GQA
    group. bf16 takes the bf16 tensor-core backward, fp32 the 3xTF32 one,
    each compiled at the head width; both accumulate in fp32, under the
    same mask and tile skip as the forward (each kernel's tile map at its
    own tiles). Raises on a tensor the kernels do not take; never falls
    back.
    """
    _check(q, k, v, seg_q, seg_k, pos_q, pos_k)
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    _check_like("out", out, q, q.shape, q.dtype)
    _check_like("d_out", d_out, q, q.shape, q.dtype)
    _check_like("lse", lse, q, (B, H, Sq), torch.float32)
    if scale is None:
        scale = dh ** -0.5
    kern = backward_kernel_for(q.dtype, dh)
    bwd = _entry(kern, "launch", _BWD_ARGTYPES[kern.source], dh)
    padded, (blk, blk_dq) = backward_tile_maps(kern, seg_q, seg_k, pos_q, pos_k,
                                               causal=causal, window=window)
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sms = _sm_count(q.device.index)

    scratch = []  # held until the launch: fp32 buffers the kernels write and read

    def fp32(*shape):
        scratch.append(torch.empty(shape, dtype=torch.float32, device=q.device))
        return scratch[-1]

    def part(splits, *shape):  # a split loop's fp32 parts
        return splits, fp32(splits, *shape).data_ptr() if splits > 1 else None
    stats = fp32(2, B, H, Sqp)  # lse and delta, padded to whole tiles
    s_kv, s_q = kern.splits(B, H, K, Sqp, Skp, sms)
    tail = part(s_kv, 2, B, Sk, K, dh)
    if kern.source == BWD_SM90.source:  # lse there in log2 units; its dQ is never split
        bufs = (blk, blk_dq, stats[0], stats[1])
        ctas = dkdv_ctas(kern, B, K, Skp, sms)
        # the persistent dK/dV CTAs' item counter, which the dQ kernel zeroes
        counter = torch.empty(1, dtype=torch.int32, device=q.device) if ctas else None
        scratch.append(counter)
        tail += (ctas, counter.data_ptr() if ctas else None,
                 pair_rows(kern, B, H, Sqp // kern.block_q, sms))
    else:
        bufs = (blk, blk_dq, stats)
        tail += part(s_q, B, Sq, H, dh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = bwd(dh, *(t.data_ptr() for t in (q, k, v, out, d_out, lse, *padded, *bufs,
                                             dq, dk, dv)),
                 B, Sq, Sk, H, K, Sqp, Skp, float(scale),
                 int(causal), int(window is not None), int(window or 0), *tail, stream)
    _raise_on(rc, kern, "backward launch")
    packed_flash_attention_backward.launches[kern.source] += 1
    return dq, dk, dv


packed_flash_attention_backward.launches = {kern.source: 0 for kern in (BWD_SM90, BWD_TF32)}
