"""Port's packed attention against the JAX Pallas kernel (interpret mode) and
its jnp oracle, case for case with tests/test_kernels.py, at its tolerances
(2e-5 float32, 2e-2 bfloat16). On the CPU the port runs the plain version;
tests/test_torch_gpu.py holds the Hopper kernel against it on the card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ht import given, settings, strategies as st

from repro.kernels.ops import packed_attention as j_packed_attention
from repro.kernels.packed_flash_attn import block_metadata as j_block_metadata
from repro.kernels.packed_flash_attn import packed_flash_attention as j_packed_flash_attention
from repro.kernels.ref import packed_attention_ref as j_ref
from repro_torch.kernels import build, ops
from repro_torch.kernels.packed_flash_attn import (
    BWD_SM90,
    BWD_SM90_NARROW,
    BWD_SM90_WIDE,
    BWD_TF32,
    BWD_TF32_WIDE,
    FWD_TF32,
    HEAD_DIMS,
    SM90,
    SM90_NARROW,
    SM90_WIDE,
    _pad_all,
    backward_kernel_for,
    backward_tile_maps,
    block_metadata,
    coarsen,
    dkdv_ctas,
    pair_rows,
    fwd_splits,
    kernel_for,
    kv_splits,
    packed_flash_attention,
    packed_flash_attention_backward,
    skipped_block_fraction,
    tf32_splits,
    tile_map,
    tile_sizes,
)
from repro_torch.kernels.ref import attention_mask

from conftest import make_packed
from torch_helpers import cross_ids, n, t

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

SWEEP = [
    (128, 4, 4, 32, 64, 64),    # MHA
    (128, 4, 2, 32, 64, 64),    # GQA 2:1
    (256, 8, 1, 16, 128, 128),  # MQA
    (192, 4, 4, 64, 64, 64),    # non-power-of-two block count + padding
    (128, 4, 4, 32, 32, 64),    # bq != bk
    (256, 4, 2, 64, 128, 128),  # the bf16 Hopper kernel's tiles
    (384, 4, 4, 32, 128, 64),   # 128-row tiles, bq != bk, odd tile count
    (192, 4, 2, 80, 64, 64),    # h2o-danube's head width, GQA, padding
]


def _inputs(rng, B, S, H, K, dh, dtype, doc_lens=None):
    """numpy q/k/v rounded to `dtype`, and packed seg/pos, for both packages."""
    q = rng.normal(size=(B, S, H, dh))
    k = rng.normal(size=(B, S, K, dh))
    v = rng.normal(size=(B, S, K, dh))
    q, k, v = (np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32)) for a in (q, k, v))
    seg, pos = make_packed(rng, B, S, doc_lens=doc_lens)
    return q, k, v, seg, pos


def _port(q, k, v, seg, pos, dtype, **kw):
    tq, tk, tv = (t(a).to(TDT[dtype]) for a in (q, k, v))
    ts, tp = t(seg), t(pos)
    return n(ops.packed_attention(tq, tk, tv, ts, ts, tp, tp, **kw))


def _jax(fn, q, k, v, seg, pos, dtype, **kw):
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    js, jp = jnp.asarray(seg), jnp.asarray(pos)
    return np.asarray(fn(jq, jk, jv, js, js, jp, jp, **kw), np.float32)


@pytest.mark.parametrize("S,H,K,dh,bq,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_kernel_and_ref(rng, S, H, K, dh, bq, bk, dtype):
    B = 2
    q, k, v, seg, pos = _inputs(rng, B, S, H, K, dh, dtype)
    out = _port(q, k, v, seg, pos, dtype, causal=True)
    kern = _jax(j_packed_attention, q, k, v, seg, pos, dtype, causal=True,
                block_q=bq, block_k=bk, interpret=True)
    ref = _jax(j_ref, q, k, v, seg, pos, dtype, causal=True)
    np.testing.assert_allclose(out, kern, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    sj, pj = jnp.asarray(seg), jnp.asarray(pos)
    ts, tp = t(seg), t(pos)
    np.testing.assert_array_equal(
        block_metadata(ts, ts, tp, tp, bq, bk, causal=True, window=None).numpy(),
        np.asarray(j_block_metadata(sj, sj, pj, pj, bq, bk, causal=True, window=None)))


# (Sq, Sk, H, K, dh, bq, bk): the encoder's self-attention, not causal, and
# the decoder's cross-attention over more keys than queries (ragged, and the
# reverse), at whisper's head width and GQA
CROSS_SWEEP = [
    (128, 128, 4, 4, 64, 64, 64),  # non-causal self-attention
    (96, 200, 4, 4, 64, 32, 64),   # cross: Sq < Sk, ragged Sk
    (150, 70, 4, 2, 32, 64, 32),   # cross: Sq > Sk, both ragged, GQA
]


@pytest.mark.parametrize("Sq,Sk,H,K,dh,bq,bk", CROSS_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_kernel_noncausal_and_cross(rng, Sq, Sk, H, K, dh, bq, bk, dtype):
    """Not causal, with query ids and key ids of their own (a query document
    without keys included): the port against the JAX Pallas kernel in
    interpret mode and its jnp oracle on every row (a row with no visible
    key exactly 0 in all three), and `block_metadata` against the JAX map."""
    B = 1
    if Sq == Sk:
        seg, pos = make_packed(rng, B, Sq, doc_lens=[50, 40])
        ids = (seg, seg, pos, pos)
    else:
        ids = cross_ids(rng, B, Sq, Sk, 3)
    q = rng.normal(size=(B, Sq, H, dh))
    k, v = (rng.normal(size=(B, Sk, K, dh)) for _ in range(2))
    q, k, v = (np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32)) for a in (q, k, v))
    kw = {"causal": False}
    out = n(ops.packed_attention(*(t(a).to(TDT[dtype]) for a in (q, k, v)),
                                 *(t(x) for x in ids), **kw))
    jargs = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)] + [jnp.asarray(x) for x in ids]
    kern = np.asarray(j_packed_attention(*jargs, block_q=bq, block_k=bk, interpret=True, **kw),
                      np.float32)
    ref = np.asarray(j_ref(*jargs, **kw), np.float32)
    np.testing.assert_allclose(out, kern, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    mask = attention_mask(*(t(x) for x in ids), causal=False, window=None).numpy()
    empty = ~mask.any(-1)
    assert empty.any() and np.all(out[empty] == 0) and np.all(kern[empty] == 0)
    padded = _pad_all(*(t(x) for x in ids), bq, bk)
    np.testing.assert_array_equal(
        block_metadata(*padded, bq, bk, causal=False, window=None).numpy(),
        np.asarray(j_block_metadata(*(jnp.asarray(x.numpy()) for x in padded), bq, bk,
                                    causal=False, window=None)))


@pytest.mark.parametrize("window", [16, 64, None])
def test_port_window(rng, window):
    B, S, H, K, dh = 1, 128, 2, 2, 32
    q, k, v, seg, pos = _inputs(rng, B, S, H, K, dh, "float32", doc_lens=[S])
    out = _port(q, k, v, seg, pos, "float32", causal=True, window=window)
    kern = _jax(j_packed_attention, q, k, v, seg, pos, "float32", causal=True,
                window=window, block_q=32, block_k=32, interpret=True)
    ref = _jax(j_ref, q, k, v, seg, pos, "float32", causal=True, window=window)
    np.testing.assert_allclose(out, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    sj, pj = jnp.asarray(seg), jnp.asarray(pos)
    ts, tp = t(seg), t(pos)
    np.testing.assert_array_equal(
        block_metadata(ts, ts, tp, tp, 32, 32, causal=True, window=window).numpy(),
        np.asarray(j_block_metadata(sj, sj, pj, pj, 32, 32, causal=True, window=window)))


def _padded_row_inputs(rng):
    B, S, H, dh = 1, 64, 2, 16
    q, k, v, _, _ = _inputs(rng, B, S, H, H, dh, "float32")
    seg = np.zeros((B, S), np.int32)
    seg[:, :40] = 1
    pos = (np.arange(S, dtype=np.int32)[None] * (seg > 0)).astype(np.int32)
    return q, k, v, seg, pos


def test_port_padding_rows_zero(rng):
    """Rows with segment id 0 (padding) return exactly 0, as the JAX kernel's."""
    q, k, v, seg, pos = _padded_row_inputs(rng)
    out = _port(q, k, v, seg, pos, "float32", causal=True)
    kern = _jax(j_packed_attention, q, k, v, seg, pos, "float32", causal=True,
                block_q=32, block_k=32, interpret=True)
    assert np.all(out[:, 40:] == 0) and np.all(kern[:, 40:] == 0)
    np.testing.assert_allclose(out, kern, atol=2e-5, rtol=2e-5)


@settings(max_examples=4, deadline=None)
@given(
    doc_split=st.lists(st.integers(8, 64), min_size=1, max_size=5),
    hk=st.sampled_from([(4, 4), (4, 2), (8, 1)]),
)
def test_port_property_random_packing(doc_split, hk):
    H, K = hk
    rng = np.random.default_rng(sum(doc_split))
    q, k, v, seg, pos = _inputs(rng, 1, 128, H, K, 16, "float32", doc_lens=doc_split)
    out = _port(q, k, v, seg, pos, "float32", causal=True)
    kern = _jax(j_packed_attention, q, k, v, seg, pos, "float32", causal=True,
                block_q=32, block_k=32, interpret=True)
    ref = _jax(j_ref, q, k, v, seg, pos, "float32", causal=True)
    np.testing.assert_allclose(out, kern, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=3e-5)


def test_block_skipping_reflects_sum_l2(rng):
    """More, shorter documents => more skipped tiles (the sum l_i^2 effect)."""
    S = 512
    seg1, pos1 = make_packed(rng, 1, S, doc_lens=[S])
    seg4, pos4 = make_packed(rng, 1, S, doc_lens=[S // 4] * 4)
    f1 = skipped_block_fraction(t(seg1), t(pos1), 64, 64)
    f4 = skipped_block_fraction(t(seg4), t(pos4), 64, 64)
    assert f4 > f1
    assert f4 - f1 > 0.25


def test_block_metadata_never_skips_needed_tiles(rng):
    """Every (q,k) pair visible under the exact mask lies in a tile with
    blk_ok == 1, and the map equals the JAX one."""
    S, bq, bk = 128, 32, 32
    seg, pos = make_packed(rng, 1, S)
    meta = block_metadata(t(seg), t(seg), t(pos), t(pos), bq, bk,
                          causal=True, window=None).numpy()[0]
    sj, pj = jnp.asarray(seg), jnp.asarray(pos)
    np.testing.assert_array_equal(
        meta, np.asarray(j_block_metadata(sj, sj, pj, pj, bq, bk, causal=True, window=None))[0])
    mask = (seg[0][:, None] == seg[0][None, :]) & (seg[0][:, None] != 0)
    mask &= pos[0][:, None] >= pos[0][None, :]
    for iq in range(S // bq):
        for ik in range(S // bk):
            if mask[iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk].any():
                assert meta[iq, ik] == 1


def test_tile_codes_mark_fully_visible_tiles(rng):
    """`tile_map` codes: nonzero where `block_metadata` (and so the JAX map)
    is 1 when there is no window, never zero on a tile with a visible pair,
    and 2 exactly where every pair of the tile is visible, which is where the
    bf16 kernel runs without a mask."""
    S = 512
    seg, pos = make_packed(rng, 2, S, doc_lens=[200, 56, 256])
    ts, tp = t(seg), t(pos)
    seen = set()
    for bq, bk in ((128, 128), (128, 64), (64, 64)):
        for window in (None, 200):
            codes = tile_map(ts, ts, tp, tp, bq, bk, causal=True, window=window).numpy()
            mask = attention_mask(ts, ts, tp, tp, causal=True, window=window).numpy()
            tiles = mask.reshape(2, S // bq, bq, S // bk, bk)
            assert np.all(codes[tiles.any(axis=(2, 4))] != 0)
            np.testing.assert_array_equal(codes == 2, tiles.all(axis=(2, 4)))
            if window is None:
                meta = block_metadata(ts, ts, tp, tp, bq, bk, causal=True, window=None).numpy()
                np.testing.assert_array_equal(codes != 0, meta == 1)
            seen |= set(np.unique(codes).tolist())
    assert seen == {0, 1, 2}


@pytest.mark.parametrize("Sq,Sk", [(200, 200), (96, 333), (333, 96)])
def test_tile_codes_noncausal_with_distinct_query_and_key_ids(Sq, Sk):
    """`tile_map` at causal=False over query and key ids of two sequences
    (the cross-attention's; Sq == Sk: the encoder's self-attention): never 0
    on a tile with a visible pair, 2 exactly where every pair is visible,
    nonzero exactly where `block_metadata` is 1, at each kernel's tiles."""
    rng = np.random.default_rng(Sq + Sk)
    if Sq == Sk:
        seg, pos = make_packed(rng, 1, Sq, doc_lens=[120, 50])
        ids = tuple(t(x) for x in (seg, seg, pos, pos))
    else:
        ids = tuple(t(x) for x in cross_ids(rng, 1, Sq, Sk, 3))
    seen = set()
    for bq, bk in ((128, 128), (64, 16), (32, 64), (128, 64)):
        padded = _pad_all(*ids, bq, bk)
        codes = tile_map(*ids, bq, bk, causal=False, window=None).numpy()
        mask = attention_mask(*padded, causal=False, window=None).numpy()
        tiles = mask.reshape(1, codes.shape[1], bq, codes.shape[2], bk)
        assert np.all(codes[tiles.any(axis=(2, 4))] != 0)
        np.testing.assert_array_equal(codes == 2, tiles.all(axis=(2, 4)))
        meta = block_metadata(*padded, bq, bk, causal=False, window=None).numpy()
        np.testing.assert_array_equal(codes != 0, meta == 1)
        seen |= set(np.unique(codes).tolist())
    assert {0, 1} <= seen


def test_tile_map_pads_ragged_lengths(rng):
    """At a length that is not a tile multiple the padding (segment id 0,
    position 0) makes its tiles masked: the tile below the diagonal that is
    fully visible at S=256 needs the mask at S=200, and the tile above it is
    kept, as the JAX map keeps it (the padded keys' position 0)."""
    for S, want in ((256, [[1, 0], [2, 1]]), (200, [[1, 1], [1, 1]])):
        seg, pos = make_packed(rng, 1, S, doc_lens=[S])
        codes = tile_map(t(seg), t(seg), t(pos), t(pos), 128, 128, causal=True, window=None)
        np.testing.assert_array_equal(codes[0].numpy(), want)


def _window_reset_ids(S=1000):
    """Row 0: one document and trailing tile padding; row 1: a document
    start at 300 and padding (segment 0, position 0) from 900."""
    seg = np.ones((2, S), np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    return seg, pos


@pytest.mark.parametrize("bq,bk", [(128, 128), (128, 64), (64, 64), (64, 128)])
def test_tile_map_window_keeps_tiles_across_position_resets(bq, bk):
    """A key tile that holds a document start or padding (position 0) next
    to late positions: the JAX map's window test skips a tile whose pairs are
    visible; `tile_map`, which the kernels use, keeps every tile with a
    visible pair and still skips tiles left of the window."""
    S, window = 1000, 256
    seg, pos = _window_reset_ids(S)
    codes = tile_map(t(seg), t(seg), t(pos), t(pos), bq, bk, causal=True, window=window)
    sp, pp = (np.pad(x, ((0, 0), (0, (-S) % bq))) for x in (seg, pos))
    sj, pj = jnp.asarray(sp), jnp.asarray(pp)
    jmeta = np.asarray(j_block_metadata(sj, sj, pj, pj, bq, bk, causal=True, window=window))
    meta = block_metadata(t(sp), t(sp), t(pp), t(pp), bq, bk, causal=True, window=window)
    np.testing.assert_array_equal(meta.numpy(), jmeta)
    mask = attention_mask(t(sp), t(sp), t(pp), t(pp), causal=True, window=window)
    need = mask.reshape(2, -1, bq, mask.shape[2] // bk, bk).any(4).any(2).numpy()
    assert np.any(need & (jmeta == 0))  # the reference's test drops some
    assert not bool((t(need) & (codes == 0)).any())
    assert float((codes == 0).float().mean()) > 0.3  # tiles left of the window go


def test_jax_window_skip_loses_visible_keys(rng):
    """The JAX package's own witness of the window fault above: its Pallas
    kernel (interpret mode, 128 x 128 tiles) differs from its jnp oracle on
    exactly the rows with a visible key in a tile its map skips, and the
    port's plain version agrees with the oracle on every row."""
    S, window, bq = 1000, 256, 128
    seg, pos = _window_reset_ids(S)
    q, k, v, _, _ = _inputs(rng, 2, S, 2, 1, 16, "float32")
    kern = _jax(j_packed_flash_attention, q, k, v, seg, pos, "float32", causal=True,
                window=window, block_q=bq, block_k=bq, interpret=True)
    ref = _jax(j_ref, q, k, v, seg, pos, "float32", causal=True, window=window)
    sp, pp = (np.pad(x, ((0, 0), (0, (-S) % bq))) for x in (seg, pos))
    sj, pj = jnp.asarray(sp), jnp.asarray(pp)
    jmeta = np.asarray(j_block_metadata(sj, sj, pj, pj, bq, bq, causal=True, window=window))
    mask = attention_mask(t(sp), t(sp), t(pp), t(pp), causal=True, window=window).numpy()
    skipped = np.repeat(np.repeat(jmeta == 0, bq, axis=1), bq, axis=2)
    lost = (mask & skipped).any(-1)[:, :S]
    assert lost[0, 896:].all() and lost[1, 896:900].all()  # diagonal tiles with padding
    off = np.abs(kern - ref).max(axis=(2, 3))
    assert np.all(off[lost] > 1e-3)
    np.testing.assert_allclose(kern[~lost], ref[~lost], atol=2e-5, rtol=2e-5)
    port = _port(q, k, v, seg, pos, "float32", causal=True, window=window)
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)


def test_kernel_choice_by_dtype():
    """bf16 takes the tensor-core sources (forward at 128-row tiles, 128 x 64 at
    head_dim 256, 64 x 128 at head_dim 64 and below, whose kernel runs 64-row
    CTAs; backward with a dK/dV kernel at 64 x 128 and a dQ kernel at
    128 x 128, at head_dim 256 64 x 64 and 128 x 32, at head_dim 64 and below
    the dQ kernel at 64 x 128 with the delta pass folded in and a persistent
    dK/dV kernel at 64 x 128), each compiled at every
    head width, head_dim 80 included, with no path that pads the width;
    fp32 the 3xTF32 forward at 64 x 16 (the tiles of the fp32 backward's dQ
    kernel, whose walk it shares) and the 3xTF32 backward, a dK/dV kernel
    at 32 x 64 (16 x 64 at head_dim 256) and a dQ kernel at 64 x 16; any
    other dtype or head width is refused. Needs no card."""
    import repro_torch.kernels.packed_flash_attn as pfa

    for dh in (80, 128):
        assert kernel_for(torch.bfloat16, dh) is SM90
        assert tile_sizes(torch.bfloat16, dh) == (128, 128)
        assert backward_kernel_for(torch.bfloat16, dh) is BWD_SM90
    for dh in (16, 32, 64):  # the narrow kernels: whisper-medium's head width and below
        assert kernel_for(torch.bfloat16, dh) is SM90_NARROW
        assert tile_sizes(torch.bfloat16, dh) == (64, 128)
        assert backward_kernel_for(torch.bfloat16, dh) is BWD_SM90_NARROW
    assert SM90_NARROW.source == SM90.source and SM90_NARROW.symbol == SM90.symbol
    assert SM90_NARROW.names == ("packed_flash_attn_sm90_narrow_kernel",)
    assert BWD_SM90_NARROW.source == BWD_SM90.source and BWD_SM90_NARROW.symbol == BWD_SM90.symbol
    assert (BWD_SM90_NARROW.block_q, BWD_SM90_NARROW.block_k, BWD_SM90_NARROW.dq_tiles) == (
        64, 128, (64, 128))
    assert BWD_SM90_NARROW.names == ("bwd_sm90_dq_narrow_kernel", "bwd_sm90_dkdv_narrow_kernel")
    assert BWD_SM90_NARROW.split_rule is None
    for name in ("PADDED_HEAD_DIMS", "run_head_dim", "_pad_head", "_unpad_head"):
        assert not hasattr(pfa, name), name
    # the C entry dispatches every width to its own instance
    for kern in (SM90, BWD_SM90, FWD_TF32):
        text = (build.CSRC / kern.source).read_text()
        assert tuple(int(w) for w in re.findall(r"^\s*PFA_CASE\((\d+)\)", text, re.M)) == HEAD_DIMS
    assert kernel_for(torch.bfloat16, 256) is SM90_WIDE
    assert tile_sizes(torch.bfloat16, 256) == (128, 64)
    assert SM90.source == SM90_WIDE.source == "packed_flash_attn_sm90.cu"
    for dh in HEAD_DIMS:
        assert kernel_for(torch.float32, dh) is FWD_TF32
        assert tile_sizes(torch.float32, dh) == (64, 16)
        assert backward_kernel_for(torch.float32, dh) is (BWD_TF32_WIDE if dh == 256 else BWD_TF32)
    assert FWD_TF32.source == "packed_flash_attn.cu"
    assert FWD_TF32.names == ("packed_flash_attn_tf32_kernel",
                              "packed_flash_attn_tf32_merge_kernel")
    assert (FWD_TF32.block_q, FWD_TF32.block_k) == BWD_TF32.dq_tiles
    assert not hasattr(pfa, "SIMT")  # the CUDA-core forward is gone, with every path to it
    assert BWD_SM90.source == "packed_flash_attn_bwd_sm90.cu"
    assert (BWD_SM90.block_q, BWD_SM90.block_k, BWD_SM90.dq_tiles) == (64, 128, (128, 128))
    assert BWD_TF32.source == BWD_TF32_WIDE.source == "packed_flash_attn_bwd.cu"
    assert BWD_TF32_WIDE.symbol == BWD_TF32.symbol and BWD_TF32_WIDE.names == BWD_TF32.names
    assert (BWD_TF32.block_q, BWD_TF32.block_k, BWD_TF32.dq_tiles) == (32, 64, (64, 16))
    assert (BWD_TF32_WIDE.block_q, BWD_TF32_WIDE.block_k, BWD_TF32_WIDE.dq_tiles) == (
        16, 64, (64, 16))
    assert BWD_TF32.names == ("bwd_tf32_delta_kernel", "bwd_tf32_dkdv_kernel",
                              "bwd_tf32_dq_kernel", "bwd_tf32_sum_kernel")
    assert backward_kernel_for(torch.bfloat16, 256) is BWD_SM90_WIDE
    assert BWD_SM90_WIDE.source == BWD_SM90.source and BWD_SM90_WIDE.symbol == BWD_SM90.symbol
    assert (BWD_SM90_WIDE.block_q, BWD_SM90_WIDE.block_k, BWD_SM90_WIDE.dq_tiles) == (
        64, 64, (128, 32))
    assert "bwd_sm90_dkdv_split_kernel" in BWD_SM90_WIDE.names
    for dtype in (torch.bfloat16, torch.float32):
        for dh in (8, 96, 192, 512):
            with pytest.raises(ValueError, match="head_dim"):
                kernel_for(dtype, dh)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            kernel_for(dtype, 128)
        with pytest.raises(TypeError):
            backward_kernel_for(dtype, 128)
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    assert packed_flash_attention.launches.keys() == {SM90.source, FWD_TF32.source}
    assert packed_flash_attention_backward.launches.keys() == {BWD_SM90.source, BWD_TF32.source}
    sources = {k.source for k in (SM90, FWD_TF32, BWD_SM90, BWD_TF32)}
    assert sources == {p.name for p in build.CSRC.glob("*.cu")}


def _coarse_relation(fine, coarse_map, mask, fq, fk):
    """`coarsen(fine)` against `tile_map` at the larger tiles on the same
    padded ids: 2 on exactly the same tiles (every pair visible), never 0 on
    a tile with a visible pair, and nonzero only where `tile_map` is."""
    derived = coarsen(fine, fq, fk)
    assert derived.shape == coarse_map.shape
    B, nq, nk = coarse_map.shape
    tiles = mask.reshape(B, nq, mask.shape[1] // nq, nk, mask.shape[2] // nk)
    np.testing.assert_array_equal((derived == 2).numpy(), (coarse_map == 2).numpy())
    np.testing.assert_array_equal((derived == 2).numpy(), tiles.all(4).all(2).numpy())
    assert not bool((tiles.any(4).any(2) & (derived == 0)).any())
    assert not bool(((derived != 0) & (coarse_map == 0)).any())
    return derived


@settings(max_examples=12, deadline=None)
@given(
    doc_split=st.lists(st.integers(1, 300), min_size=1, max_size=8),
    S=st.integers(60, 700),
    window=st.sampled_from([None, 7, 100, 300]),
    pad=st.integers(0, 50),
)
def test_coarsened_tile_map_matches_tile_map(doc_split, S, window, pad):
    """The backward's dQ map, derived from its dK/dV map (64 x 128) by
    `coarsen`, against `tile_map` at 128 x 128 on random packings; and the
    64 x 64 map coarsened to every backward tile."""
    rng = np.random.default_rng(S)
    seg, pos = make_packed(rng, 2, S, doc_lens=doc_split)
    seg[1, S - pad:] = 0
    pos[1, S - pad:] = 0
    ts, tp = t(seg), t(pos)
    kw = {"causal": True, "window": window}
    padded, (blk, blk_dq) = backward_tile_maps(BWD_SM90, ts, ts, tp, tp, **kw)
    assert padded[0].shape[1] % 128 == 0 and padded[0].shape[1] - S < 128
    mask = attention_mask(*padded, **kw)
    np.testing.assert_array_equal(blk.numpy(), tile_map(*padded, 64, 128, **kw).numpy())
    derived = _coarse_relation(blk, tile_map(*padded, 128, 128, **kw), mask, 2, 1)
    np.testing.assert_array_equal(derived.numpy(), blk_dq.numpy())
    fine = tile_map(*padded, 64, 64, **kw)
    for bq, bk in ((64, 128), (128, 64), (128, 128)):
        _coarse_relation(fine, tile_map(*padded, bq, bk, **kw), mask, bq // 64, bk // 64)


def test_coarsened_tile_map_can_skip_more():
    """Where `tile_map`'s range tests over a 128-row tile both hold but no
    64-row half has a visible pair, the derived map skips the tile: queries
    128..191 of document 1 (late positions) and 192..255 of document 2 (early
    ones) against keys 256..383 of document 2 (positions 64..191)."""
    seg, pos = make_packed(np.random.default_rng(0), 1, 384, doc_lens=[192, 192])
    ts, tp = t(seg), t(pos)
    kw = {"causal": True, "window": None}
    _, (blk, blk_dq) = backward_tile_maps(BWD_SM90, ts, ts, tp, tp, **kw)
    coarse = tile_map(ts, ts, tp, tp, 128, 128, **kw)
    assert int(coarse[0, 1, 2]) == 1 and int(blk_dq[0, 1, 2]) == 0
    assert blk[0, 2:4, 2].tolist() == [0, 0]
    _coarse_relation(blk, coarse, attention_mask(ts, ts, tp, tp, **kw), 2, 1)


@pytest.mark.parametrize("window", [512, None])
@pytest.mark.parametrize("doc_lens,pad", [([700, 300, 1100], 150), ([64, 1900], 0),
                                          ([129, 31, 1000, 33], 77)])
def test_wide_backward_tile_maps_keep_visible_pairs(window, doc_lens, pad):
    """The head_dim 256 backward (`BWD_SM90_WIDE`): ids padded to 128 queries
    and 64 keys; its dK/dV map at 64 x 64 and its dQ map at 128 x 32, both
    coarsened from one `tile_map` at 64 x 32, against the dense mask at
    gemma3-1b's window 512 (and without one), over position resets and
    padding rows: never 0 on a tile that holds a visible pair, 2 exactly
    where every pair is visible, and nonzero only where `tile_map` at the
    kernel's own tiles is."""
    S = sum(doc_lens) + pad - 5  # no multiple of any tile
    seg, pos = make_packed(np.random.default_rng(S), 1, S, doc_lens=doc_lens)
    if pad:
        seg[:, S - pad:] = 0
        pos[:, S - pad:] = 0
    ts, tp = t(seg), t(pos)
    kw = {"causal": True, "window": window}
    padded, (blk, blk_dq) = backward_tile_maps(BWD_SM90_WIDE, ts, ts, tp, tp, **kw)
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    assert Sqp % 128 == 0 and Sqp - S < 128 and Skp % 64 == 0 and Skp - S < 64
    assert blk.shape == (1, Sqp // 64, Skp // 64) and blk_dq.shape == (1, Sqp // 128, Skp // 32)
    mask = attention_mask(*padded, **kw)
    fine = tile_map(*padded, 64, 32, **kw)
    for got, (bq, bk) in ((blk, (64, 64)), (blk_dq, (128, 32))):
        derived = _coarse_relation(fine, tile_map(*padded, bq, bk, **kw), mask, bq // 64, bk // 32)
        np.testing.assert_array_equal(got.numpy(), derived.numpy())
        tiles = mask.reshape(1, Sqp // bq, bq, Skp // bk, bk)
        assert not bool((tiles.any(4).any(2) & (got == 0)).any())
    assert bool((blk == 0).any()) and bool((blk == 2).any()) and bool((blk_dq == 2).any())


def _ballot_list(column):
    """The narrow dK/dV kernel's list of a key tile's column of codes, as its
    producer warp builds it: 32 codes a load, each lane's nonzero code
    written at the count of nonzero codes below its lane (a ballot and a
    prefix count), as qt << 2 | code."""
    out, cnt = {}, 0
    for q0 in range(0, len(column), 32):
        codes = [int(column[qt]) if qt < len(column) else 0 for qt in range(q0, q0 + 32)]
        nz = sum(1 << lane for lane, c in enumerate(codes) if c)
        for lane, code in enumerate(codes):
            if code:
                out[cnt + bin(nz & ((1 << lane) - 1)).count("1")] = (q0 + lane) << 2 | code
        cnt += bin(nz).count("1")
    return [out[i] for i in range(cnt)]


def _narrow_regime_ids(regime, rng):
    """(ids, kw) of a regime the narrow backward meets: causal packed rows,
    a window over position resets, non-causal cross-attention with a
    transcript without its clip, ragged encoder rows with padding."""
    if regime == "cross_orphan":
        return cross_ids(rng, 2, 200, 777, 3), {"causal": False, "window": None}
    S = {"causal": 1000, "windowed": 1000, "ragged": 333}[regime]
    seg, pos = make_packed(rng, 2, S, doc_lens=[300, 200, 61, 400] if S == 1000 else None)
    if regime == "ragged":
        seg[1, S - 40:] = 0
        pos[1, S - 40:] = 0
    kw = {"causal": regime != "ragged", "window": 100 if regime == "windowed" else None}
    return (seg, seg, pos, pos), kw


@pytest.mark.parametrize("regime", ["causal", "windowed", "cross_orphan", "ragged"])
def test_narrow_backward_tile_maps_keep_visible_pairs(regime):
    """The head_dim <= 64 backward (`BWD_SM90_NARROW`): ids padded to 64
    queries and 128 keys; one map at 64 x 128 serves its dQ and dK/dV
    kernels. Against the dense mask: never 0 on a tile that holds a visible
    pair, 2 exactly where every pair is visible; each key tile's list as the
    dK/dV kernel's producer warp compacts it holds exactly the column's
    nonzero tiles, in order, with their codes."""
    ids, kw = _narrow_regime_ids(regime, np.random.default_rng(len(regime)))
    ids = tuple(t(x) for x in ids)
    padded, (blk, blk_dq) = backward_tile_maps(BWD_SM90_NARROW, *ids, **kw)
    (B, Sq), Sk = ids[0].shape, ids[1].shape[1]
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    assert Sqp % 64 == 0 and Sqp - Sq < 64 and Skp % 128 == 0 and Skp - Sk < 128
    assert blk.shape == (B, Sqp // 64, Skp // 128)
    np.testing.assert_array_equal(blk.numpy(), blk_dq.numpy())
    np.testing.assert_array_equal(blk.numpy(), tile_map(*padded, 64, 128, **kw).numpy())
    mask = attention_mask(*padded, **kw)
    tiles = mask.reshape(B, Sqp // 64, 64, Skp // 128, 128)
    assert not bool((tiles.any(4).any(2) & (blk == 0)).any())
    np.testing.assert_array_equal((blk == 2).numpy(), tiles.all(4).all(2).numpy())
    assert bool((blk == 0).any()) and bool((blk != 0).any())
    for b in range(B):
        for kt in range(blk.shape[2]):
            column = blk[b, :, kt].tolist()
            assert _ballot_list(column) == [qt << 2 | c for qt, c in enumerate(column) if c]


def _dkdv_items(B, K, Skp):
    """The narrow dK/dV kernel's (key tile, KV head, batch) work items in the
    order it hands them out, as its loop decodes item i: key tile
    i // (K B), KV head i % (K B) // B, batch i % B. CTA c takes item c,
    and each later item goes to the first CTA that asks (an atomic
    counter)."""
    return [(i // (K * B), i % (K * B) // B, i % B) for i in range(K * B * (Skp // 128))]


@pytest.mark.parametrize("B,K,Skp", [(4, 16, 1536), (1, 16, 1024), (1, 16, 4096), (2, 4, 512),
                                     (1, 1, 128)])
def test_narrow_dkdv_items_cover_every_tile_once_heavy_first(B, K, Skp):
    """The persistent dK/dV kernel's work order (`_dkdv_items`, a model of
    its loop): every (key tile, KV head, batch) exactly once, in the order
    of key tiles (early key tiles, which see the most queries under the
    causal mask, first). `dkdv_ctas` gives one CTA an SM, at most one an
    item, and 0 for every other kernel."""
    order = _dkdv_items(B, K, Skp)
    assert len(order) == len(set(order)) == K * B * (Skp // 128)
    assert set(order) == {(kt, kh, b) for kt in range(Skp // 128) for kh in range(K)
                          for b in range(B)}
    assert [it[0] for it in order] == sorted(it[0] for it in order)
    assert dkdv_ctas(BWD_SM90_NARROW, B, K, Skp, 132) == min(132, K * B * (Skp // 128))
    for kern in (BWD_SM90, BWD_SM90_WIDE, BWD_TF32, BWD_TF32_WIDE):
        assert dkdv_ctas(kern, B, K, Skp, 132) == 0


def test_pair_rows_rule():
    """The head_dim <= 64 bf16 forward and its backward's dQ kernel pair
    their 64-row map rows two a CTA where that grid fills two waves of SMs
    (whisper's encoder at 4 x 1500 and 1 x 4096), and run one a CTA, its key
    walk split between the warpgroups, on smaller grids (the decoder at
    1 x 1024, the training and serving cross-attention); no other kernel
    takes the rule."""
    for kern in (SM90_NARROW, BWD_SM90_NARROW):
        assert pair_rows(kern, 4, 16, 24, 132) == 1   # encoder 4 x 1500: 768 CTAs
        assert pair_rows(kern, 1, 16, 64, 132) == 1   # encoder 1 x 4096: 512
        assert pair_rows(kern, 1, 16, 16, 132) == 0   # decoder, cross train: 128
        assert pair_rows(kern, 4, 16, 1, 132) == 0    # cross serve: 64
        assert pair_rows(kern, 1, 16, 33, 132) == 1   # an odd row count: 17 CTAs a head
        assert pair_rows(kern, 1, 16, 31, 132) == 0   # 256 CTAs, under two waves
    for kern in (SM90, SM90_WIDE, FWD_TF32, BWD_SM90, BWD_SM90_WIDE, BWD_TF32, BWD_TF32_WIDE):
        assert pair_rows(kern, 4, 16, 24, 132) == 0


def _narrow_forward_model(q, k, v, seg_q, seg_k, pos_q, pos_k, *, causal):
    """numpy float32 model of the head_dim <= 64 bf16 forward's softmax: per
    64-row tile, the visible 128-key tiles (`tile_map`'s nonzero codes) go
    in turn to two (m, l, O) states (warpgroups 0 and 1), each an online
    softmax in units of log2 with the scale folded into exp2 and P rounded
    to bf16 before P V, as the kernel; then the kernel's merge: m the larger
    max, each state scaled by exp2(m_w - m) (0 for a state that saw no
    key), l and O summed; out O / l, 0 and lse +inf where l is 0."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale_log2 = dh ** -0.5 * np.log2(np.e)
    ids = [t(x) for x in (seg_q, seg_k, pos_q, pos_k)]
    padded = [x.numpy() for x in _pad_all(*ids, 64, 128)]
    codes = tile_map(*ids, 64, 128, causal=causal, window=None).numpy()
    vis = attention_mask(*(t(x) for x in padded), causal=causal, window=None).numpy()
    qp = np.zeros((B, padded[0].shape[1], H, dh), np.float32)
    kp = np.zeros((B, padded[1].shape[1], K, dh), np.float32)
    vp = np.zeros_like(kp)
    qp[:, :Sq], kp[:, :Sk], vp[:, :Sk] = q, k, v
    out = np.zeros_like(qp)
    lse = np.full((B, H, qp.shape[1]), np.inf, np.float32)

    def bf16(x):
        return n(t(x).to(torch.bfloat16))
    for b in range(B):
        for h in range(H):
            kh = h * K // H
            for qt in range(codes.shape[1]):
                rows = slice(64 * qt, 64 * qt + 64)
                state = [[np.full(64, -np.inf, np.float32), np.zeros(64, np.float32),
                          np.zeros((64, dh), np.float32)] for _ in range(2)]
                visible = [kt for kt in range(codes.shape[2]) if codes[b, qt, kt]]
                for i, kt in enumerate(visible):
                    keys = slice(128 * kt, 128 * kt + 128)
                    m, l, o = state[i % 2]
                    s = qp[b, rows, h] @ kp[b, keys, kh].T
                    s = np.where(vis[b, rows, keys], s, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, s.max(1))
                    none = m_new == -np.inf
                    corr = np.where(none, 1, np.exp2((m - m_new) * scale_log2))
                    p = np.exp2(s * scale_log2 - np.where(none, 0, m_new * scale_log2)[:, None])
                    state[i % 2] = [m_new, l * corr + p.sum(1),
                                    o * corr[:, None] + bf16(p) @ vp[b, keys, kh]]
                (m0, l0, o0), (m1, l1, o1) = state
                m = np.maximum(m0, m1)
                c0, c1 = (np.where(mw == -np.inf, 0, np.exp2((mw - m) * scale_log2))
                          for mw in (m0, m1))
                l, o = l0 * c0 + l1 * c1, o0 * c0[:, None] + o1 * c1[:, None]
                out[b, rows, h] = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], 0)
                lse[b, h, rows] = np.where(l > 0, (m * scale_log2 + np.log2(
                    np.where(l > 0, l, 1))) * np.log(2), np.inf)
    return out[:, :Sq], lse[:, :, :Sq]


@pytest.mark.parametrize("case", ["cross_orphan", "causal_packed"])
def test_narrow_forward_merge_model_matches_jax_kernel(case):
    """The head_dim <= 64 forward's split key walk and its (m, l, O) merge,
    modelled in numpy, against the JAX Pallas kernel in interpret mode on
    whisper-like ids: a transcript's queries over its clip's frames with one
    transcript without its clip (odd and even counts of visible key tiles,
    a row with none), and causal packed documents; rows without a visible
    key exactly 0 in both, lse +inf there and the log-sum-exp of the
    scores elsewhere."""
    rng = np.random.default_rng(7)
    H, dh = 2, 64
    if case == "cross_orphan":
        ids, causal = cross_ids(rng, 1, 100, 700, 2), False
    else:
        seg, pos = make_packed(rng, 1, 300, doc_lens=[150, 90, 60])
        ids, causal = (seg, seg, pos, pos), True
    Sq, Sk = ids[0].shape[1], ids[1].shape[1]
    q = rng.normal(size=(1, Sq, H, dh))
    k, v = (rng.normal(size=(1, Sk, H, dh)) for _ in range(2))
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    with np.errstate(invalid="ignore"):  # -inf - -inf where a state saw no key
        out, lse = _narrow_forward_model(q, k, v, *ids, causal=causal)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(x) for x in ids]
    kern = np.asarray(j_packed_attention(*jargs, block_q=64, block_k=128, interpret=True,
                                         causal=causal), np.float32)
    np.testing.assert_allclose(out, kern, atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    mask = attention_mask(*(t(x) for x in ids), causal=causal, window=None).numpy()
    empty = ~mask.any(-1)
    assert empty.any() == (case == "cross_orphan")
    assert np.all(out[empty] == 0) and np.all(kern[empty] == 0)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    s = np.where(mask[:, None], s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    want = np.where(empty[:, None], np.inf, want)
    np.testing.assert_allclose(lse, want, rtol=1e-5, atol=1e-5)
    if case == "cross_orphan":  # both warpgroups walk tiles, and at least one row's count is odd
        codes = tile_map(*(t(x) for x in ids), 64, 128, causal=False, window=None).numpy()
        counts = (codes != 0).sum(-1)
        assert (counts >= 2).any() and (counts % 2 == 1).any()


def test_kv_splits_fill_one_wave():
    """The head_dim 256 backward splits a GQA group's query heads over the
    most dK/dV CTAs that divide the group and keep the grid (KV heads x
    batch x 64-key tiles) in one wave of SMs; every other backward never
    splits."""
    assert kv_splits(BWD_SM90_WIDE, 1, 4, 1, 4096, 132) == 2   # gemma3-1b: 64 -> 128 CTAs
    assert kv_splits(BWD_SM90_WIDE, 1, 8, 4, 4096, 132) == 1   # gemma3-4b: 256 CTAs already
    assert kv_splits(BWD_SM90_WIDE, 2, 4, 1, 512, 132) == 4    # 16 -> 64 CTAs
    assert kv_splits(BWD_SM90_WIDE, 1, 7, 1, 1024, 132) == 7   # 16 -> 112 CTAs
    assert kv_splits(BWD_SM90_WIDE, 1, 7, 1, 1280, 132) == 1   # 140 CTAs would overflow the wave
    assert kv_splits(BWD_SM90_WIDE, 1, 4, 4, 512, 132) == 1    # no GQA group to split
    for kern in (BWD_SM90, BWD_TF32, BWD_TF32_WIDE):
        assert kv_splits(kern, 1, 4, 1, 1024, 132) == 1


def test_tf32_splits_fill_four_waves():
    """The fp32 backward splits its dK/dV loop (GQA heads x query tiles) and
    its dQ loop (16-key tiles) over the power of two of CTAs at or below
    4 x 132 / CTAs that leaves each CTA 2048 (query, key) pairs or more of
    its loop; grids of four waves or more never split, and no other
    backward takes this rule."""
    # the parity path's micro-batch, 1 x 256 at reduced qwen3-8b's 4 / 2 heads:
    # 8 dK/dV CTAs (16 iterations of 32 x 64 pairs) -> 16 splits, 16 dQ CTAs
    # (16 iterations of 64 x 16) -> 8
    assert tf32_splits(BWD_TF32, 1, 4, 2, 256, 256, 132) == (16, 8)
    assert tf32_splits(BWD_TF32, 2, 32, 8, 832, 832, 132) == (2, 1)   # ragged 2 x 777: 208, 832
    assert tf32_splits(BWD_TF32_WIDE, 1, 4, 1, 4096, 4096, 132) == (8, 2)  # gemma3-1b: 64, 256
    assert tf32_splits(BWD_TF32_WIDE, 1, 8, 4, 4096, 4096, 132) == (2, 1)  # gemma3-4b: 256, 512
    assert tf32_splits(BWD_TF32, 1, 28, 4, 4096, 4096, 132) == (2, 1)      # qwen2.5: 256, 1792
    for H, K in ((32, 8), (32, 32)):  # h2o-danube, llama2: 512 and 2048 CTAs
        assert tf32_splits(BWD_TF32, 1, H, K, 4096, 4096, 132) == (1, 1)
    assert tf32_splits(BWD_TF32, 1, 1, 1, 64, 64, 132) == (2, 2)  # capped by the pairs
    assert tf32_splits(BWD_TF32_WIDE, 1, 1, 1, 64, 64, 132) == (2, 2)  # 4 stages of 16 x 64
    for kern in (BWD_SM90, BWD_SM90_WIDE):
        assert tf32_splits(kern, 1, 4, 2, 256, 256, 132) == (1, 1)


def test_fwd_splits_fill_one_wave():
    """The fp32 forward splits its key walk (16-key tiles) over the power of
    two of CTAs at or below 132 / CTAs that leaves each CTA 2048 (query,
    key) pairs or more of its walk; grids of a wave or more never split,
    and no other forward takes this rule."""
    # the parity paths' 2 x 256 batches at 4 heads: 32 CTAs of 16 key tiles
    assert fwd_splits(FWD_TF32, 2, 4, 256, 256, 132) == 4
    assert fwd_splits(FWD_TF32, 1, 4, 256, 256, 132) == 8  # one micro-batch of the train step
    assert fwd_splits(FWD_TF32, 2, 32, 832, 784, 132) == 1   # ragged 2 x 777: 832 CTAs
    for H in (4, 8, 28, 32):  # the family's 1 x 4096: 256 CTAs or more
        assert fwd_splits(FWD_TF32, 1, H, 4096, 4096, 132) == 1
    assert fwd_splits(FWD_TF32, 1, 1, 64, 64, 132) == 2  # capped by the pairs: 4 key tiles
    assert fwd_splits(FWD_TF32, 1, 1, 64, 16, 132) == 1
    for kern in (SM90, SM90_WIDE):
        assert fwd_splits(kern, 2, 4, 256, 256, 132) == 1


@pytest.mark.parametrize("shape", [(1, 4, 1, 4096, 4096), (1, 4, 2, 256, 256),
                                   (2, 32, 8, 832, 832), (2, 4, 1, 512, 512)])
def test_backward_splits_follow_the_record_rule(shape):
    """`Kernel.splits` gives (dK/dV, dQ) splits by the record's own rule:
    `kv_splits` for the head_dim 256 bf16 backward (its dQ never split),
    `tf32_splits` for both fp32 records, none for the other backwards and
    the forwards (the fp32 forward splits its key walk by `fwd_splits`);
    the wrapper and the smoke script read only this."""
    B, H, K, Sqp, Skp = shape
    assert BWD_SM90_WIDE.split_rule == "kv"
    assert BWD_SM90_WIDE.splits(*shape, 132) == (kv_splits(BWD_SM90_WIDE, B, H, K, Skp, 132), 1)
    for kern in (BWD_TF32, BWD_TF32_WIDE):
        assert kern.split_rule == "tf32"
        assert kern.splits(*shape, 132) == tf32_splits(kern, *shape, 132)
    for kern in (BWD_SM90, SM90, SM90_WIDE, FWD_TF32):
        assert kern.split_rule is None and kern.splits(*shape, 132) == (1, 1)


@pytest.mark.parametrize("kern", ["BWD_TF32", "BWD_TF32_WIDE"])
@pytest.mark.parametrize("window", [None, 96, 1024])
@pytest.mark.parametrize("doc_lens,pad", [([100, 80, 40], 36), ([500, 277], 0),
                                          ([129, 31, 1000, 33], 77)])
def test_tf32_backward_tile_maps_match_tile_map(kern, window, doc_lens, pad):
    """The fp32 backward (`BWD_TF32`, `BWD_TF32_WIDE` at head_dim 256): ids
    padded to 64 queries and keys; its dK/dV map at 32 x 64 (16 x 64) and
    its dQ map at 64 x 16, both coarsened from one `tile_map` at 32 x 16
    (16 x 16), against `tile_map` computed directly at each kernel's tiles
    and the dense mask, over position resets and padding rows: 2 exactly
    where every pair is visible, never 0 on a tile that holds a visible
    pair, nonzero only where `tile_map` is."""
    kern = {"BWD_TF32": BWD_TF32, "BWD_TF32_WIDE": BWD_TF32_WIDE}[kern]
    S = sum(doc_lens) + pad - 3  # no multiple of any tile
    seg, pos = make_packed(np.random.default_rng(S), 1, S, doc_lens=doc_lens)
    if pad:
        seg[:, S - pad:] = 0
        pos[:, S - pad:] = 0
    ts, tp = t(seg), t(pos)
    kw = {"causal": True, "window": window}
    padded, (blk, blk_dq) = backward_tile_maps(kern, ts, ts, tp, tp, **kw)
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    kq = kern.block_q
    assert Sqp == Skp and Sqp % 64 == 0 and Sqp - S < 64
    assert blk.shape == (1, Sqp // kq, Skp // 64) and blk_dq.shape == (1, Sqp // 64, Skp // 16)
    mask = attention_mask(*padded, **kw)
    fine = tile_map(*padded, kq, 16, **kw)
    for got, (bq, bk) in ((blk, (kq, 64)), (blk_dq, (64, 16))):
        direct = tile_map(*padded, bq, bk, **kw)
        derived = _coarse_relation(fine, direct, mask, bq // kq, bk // 16)
        np.testing.assert_array_equal(got.numpy(), derived.numpy())
        assert not bool(((got != 0) & (direct == 0)).any())
        tiles = mask.reshape(1, Sqp // bq, bq, Skp // bk, bk)
        assert not bool((tiles.any(4).any(2) & (got == 0)).any())
    assert bool((blk == 0).any()) and bool((blk == 2).any())
    assert bool((blk_dq == 2).any()) == (max(doc_lens) >= 128)  # a whole 64 x 16 tile


def test_backward_tile_maps_shapes():
    """Ids are padded to whole 128-row tiles (segment 0, position 0) for the
    bf16 backward and 64-row tiles for the fp32 one, whose dK/dV map is at
    32 x 64 and its dQ map at 64 x 16."""
    seg, pos = make_packed(np.random.default_rng(1), 2, 200)
    ts, tp = t(seg), t(pos)
    padded, (blk, blk_dq) = backward_tile_maps(BWD_SM90, ts, ts, tp, tp, causal=True, window=None)
    assert [x.shape for x in padded] == [(2, 256)] * 4
    assert bool((padded[0][:, 200:] == 0).all()) and bool((padded[2][:, 200:] == 0).all())
    assert blk.shape == (2, 4, 2) and blk_dq.shape == (2, 2, 2)
    padded, (blk, blk_dq) = backward_tile_maps(BWD_TF32, ts, ts, tp, tp, causal=True, window=None)
    assert [x.shape for x in padded] == [(2, 256)] * 4
    assert blk.shape == (2, 8, 4) and blk_dq.shape == (2, 4, 16)
    seg, pos = make_packed(np.random.default_rng(1), 2, 130)
    ts, tp = t(seg), t(pos)
    padded, (blk, blk_dq) = backward_tile_maps(BWD_SM90_WIDE, ts, ts, tp, tp, causal=True,
                                               window=None)
    assert [x.shape for x in padded] == [(2, 256), (2, 192), (2, 256), (2, 192)]
    assert blk.shape == (2, 4, 3) and blk_dq.shape == (2, 2, 6)


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes (directly or through another
    header) changes the source's library path, so the next load rebuilds;
    editing an unrelated file does not. The real sm_90a sources name the
    shared header."""
    assert [p.name for p in build.sources_of("packed_flash_attn_bwd_sm90.cu")] == [
        "packed_flash_attn_bwd_sm90.cu", "sm90_common.cuh"]
    assert [p.name for p in build.sources_of("packed_flash_attn_sm90.cu")] == [
        "packed_flash_attn_sm90.cu", "sm90_common.cuh"]
    for source in ("packed_flash_attn_bwd.cu", "packed_flash_attn.cu"):  # the fp32 pair
        assert [p.name for p in build.sources_of(source)] == [
            source, "tf32_common.cuh", "sm90_common.cuh"]
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    (tmp_path / "other.cuh").write_text("#define C 1\n")
    first = build.library_path("k.cu")
    assert [p.name for p in build.sources_of("k.cu")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "other.cuh").write_text("#define C 2\n")
    assert build.library_path("k.cu") == first
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    second = build.library_path("k.cu")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A (B + 1)\n')
    assert build.library_path("k.cu") not in (first, second)


def _plain_bf16_p(q, k, v, seg, pos, *, window=None):
    """The port's plain version (`kernels/ref.py`) with one change, the bf16
    kernel's: P is rounded to bf16 before P.V. The row sums stay fp32."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    k, v = (x.repeat_interleave(H // K, dim=2) for x in (k, v))
    mask = attention_mask(seg, seg, pos, pos, causal=True, window=window)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill_(~mask, 0.0)
    l = p.sum(-1, keepdim=True).transpose(1, 2)[..., 0][..., None]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return torch.where(l > 0, o / l.clamp_min(1e-30), 0.0).to(torch.bfloat16)


@pytest.mark.parametrize("S,H,K,dh,window,pad", [
    (256, 8, 2, 128, None, 0),   # qwen3-8b head width and GQA 4:1
    (192, 4, 4, 64, 48, 0),      # sliding window
    (160, 4, 1, 32, None, 40),   # MQA, 40 padding rows
])
def test_bf16_probabilities_stay_within_tolerance(rng, S, H, K, dh, window, pad):
    """The tolerance argument for the bf16 kernel's one numerical change:
    rounding P to bf16 before P.V keeps the output within 2e-2 of the JAX
    reference (which keeps P in fp32) on bf16 inputs."""
    q, k, v, seg, pos = _inputs(rng, 2, S, H, K, dh, "bfloat16", doc_lens=[S // 3, S])
    if pad:
        seg[:, -pad:] = 0
        pos[:, -pad:] = 0
    tq, tk, tv = (t(a).to(torch.bfloat16) for a in (q, k, v))
    out = n(_plain_bf16_p(tq, tk, tv, t(seg), t(pos), window=window))
    ref = _jax(j_ref, q, k, v, seg, pos, "bfloat16", causal=True, window=window)
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)
    plain = _port(q, k, v, seg, pos, "bfloat16", causal=True, window=window)
    assert np.abs(out - plain).max() > 0  # the rounding is really there
    if pad:
        assert np.all(out[:, -pad:] == 0)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """The kernel wrapper never falls back: a CPU tensor is refused."""
    q, k, v, seg, pos = _inputs(rng, 1, 64, 2, 2, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        packed_flash_attention(t(q), t(k), t(v), t(seg), t(seg), t(pos), t(pos))


# ----------------------------------------- the fp32 forward's arithmetic, 3xTF32
# A numpy model of `csrc/packed_flash_attn.cu`: every operand split into TF32
# hi and lo parts (`split_tf32`: hi is x with its low 13 mantissa bits
# cleared, lo = x - hi, of which the tensor cores read the top 10 mantissa
# bits too), each m16n8k8 product's sum truncated toward zero once, the
# products in the kernel's order (k-steps of 8; alo bhi, ahi blo, ahi bhi);
# S over all of dh (at dh 256 over two halves, added in fp32), each in two
# accumulators, the even and the odd k-steps, added in fp32; then 16-key
# stages with the online softmax in fp32, each stage's P V from zero on the
# tensor cores and joined by out = out * corr + part (one rounding, the fma).
# Stages a CTA skips change nothing (their p are 0 and their corr 1), so the
# model runs every stage, and a walk split over CTAs merges parts that the
# 2e-5 tolerance covers (the card's tests hold every split).

def _tf32(x):
    """The TF32 value a tensor-core product reads: x with its low 13 mantissa bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _rz(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _mma3(a, b, d, k_steps=None):
    """d + a @ b in 3xTF32 over k-steps of 8 (`k_steps`: those of them),
    each product's sum truncated toward zero; a (..., M, K), b (..., K, N),
    d float32 (..., M, N)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    for k0 in k_steps or range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = _rz(d.astype(np.float64) + np.matmul(x[..., ks].astype(np.float64),
                                                    y[..., ks, :].astype(np.float64)))
    return d


def _fwd_model(q, k, v, seg_q, seg_k, pos_q, pos_k, *, window=None, in_place=False):
    """(out (B,Sq,H,dh), lse (B,H,Sq)) of the fp32 forward kernel's
    arithmetic on float32 numpy inputs, causal; with `in_place` the output
    accumulates on the tensor cores across stages instead of by parts."""
    B, Sq, H, dh = q.shape
    K, Sk = k.shape[2], k.shape[1]
    pad = (-Sk) % 16  # the kernel's stages: keys past Sk are zeros of segment 0
    k, v = (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))) for x in (k, v))
    seg_k, pos_k = (np.pad(x, ((0, 0), (0, pad))) for x in (seg_k, pos_k))
    Q = q.transpose(0, 2, 1, 3)
    Kr, Vr = (x.repeat(H // K, axis=2).transpose(0, 2, 1, 3) for x in (k, v))
    mask = attention_mask(t(seg_q), t(seg_k), t(pos_q), t(pos_k), causal=True,
                          window=window).numpy()[:, None]
    halves = 2 if dh > 128 else 1  # at dh 256 a warp pair adds its halves of S
    w = dh // halves
    zeros = np.zeros((B, H, Sq, Sk + pad), np.float32)

    def scores(x, y):  # the even and the odd k-steps, then their sum
        even, odd = (_mma3(x, y, zeros, range(first, w, 16)) for first in (0, 8))
        return even + odd
    parts = [scores(Q[..., i * w:(i + 1) * w], Kr[..., i * w:(i + 1) * w].swapaxes(-1, -2))
             for i in range(halves)]
    S = parts[0] if halves == 1 else parts[0] + parts[1]
    scale = np.float32(dh ** -0.5)
    m = np.full((B, H, Sq, 1), -np.inf, np.float32)
    l = np.zeros((B, H, Sq, 1), np.float32)
    acc = np.zeros((B, H, Sq, dh), np.float32)
    for k0 in range(0, Sk + pad, 16):
        ks = slice(k0, k0 + 16)
        s = np.where(mask[..., ks], S[..., ks] * scale, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        m_use = np.where(m_new == -np.inf, np.float32(0), m_new)
        p = np.exp(s - m_use).astype(np.float32)
        corr = np.exp(m - m_use).astype(np.float32)
        l = (l * corr + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        m = m_new
        scaled = (acc.astype(np.float64) * corr).astype(np.float32)
        if in_place:
            acc = _mma3(p, Vr[..., ks, :], scaled)
        else:
            part = _mma3(p, Vr[..., ks, :], np.zeros_like(acc))
            acc = (acc.astype(np.float64) * corr + part).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(l > 0, acc / l, np.float32(0)).astype(np.float32)
        lse = np.where(l > 0, m + np.log(l), np.float32(np.inf))[..., 0]
    return out.transpose(0, 2, 1, 3), lse


@pytest.mark.parametrize("dh", [80, 128, 256])
def test_fp32_forward_model_matches_jax_kernel(rng, dh):
    """The fp32 forward's 3xTF32 arithmetic (the numpy model above) against
    the JAX Pallas kernel in interpret mode and its jnp oracle, on packed
    causal documents with padding rows, GQA and a sliding window that binds
    inside each document, at h2o-danube's, qwen3's and gemma3's head widths:
    within the fp32 tolerance, 2e-5. Documents are shorter than the window
    plus two tiles, so the JAX map's window test keeps every visible pair
    (ROADMAP Queue 3). Padding rows give exactly 0 and lse = +inf; lse is the
    log-sum-exp of the scaled scores."""
    S, window = 256, 48
    q, k, v, seg, pos = _inputs(rng, 2, S, 4, 2, dh, "float32", doc_lens=[100, 90, 40])
    assert (seg == 0).sum() == 2 * 26
    out, lse = _fwd_model(q, k, v, seg, seg, pos, pos, window=window)
    kern = _jax(j_packed_flash_attention, q, k, v, seg, pos, "float32", causal=True,
                window=window, block_q=64, block_k=64, interpret=True)
    ref = _jax(j_ref, q, k, v, seg, pos, "float32", causal=True, window=window)
    np.testing.assert_allclose(kern, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    pad = seg == 0
    assert np.all(out[pad] == 0) and np.all(np.isposinf(lse.transpose(0, 2, 1)[pad]))
    mask = attention_mask(t(seg), t(seg), t(pos), t(pos), causal=True, window=window)[:, None]
    kr = t(k).repeat_interleave(2, dim=2).double()
    scores = torch.einsum("bqhd,bkhd->bhqk", t(q).double(), kr) * dh ** -0.5
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), -1).numpy()
    np.testing.assert_allclose(lse[~np.isinf(want)], want[~np.isinf(want)], atol=1e-5, rtol=1e-6)


def test_fp32_forward_parts_hold_at_4096_keys():
    """Why the kernel adds each stage's P V as a part: at one 4096-key
    document (32 query rows at its end, dh 128), the chosen accumulation
    stays under 1e-4 of max |ref| (the fp32 gate) by far, and under the
    error of accumulating the output in place on the tensor cores, whose
    truncated sums drift over the 256 stages."""
    rng = np.random.default_rng(7)
    S, rows, dh = 4096, 32, 128
    q = rng.standard_normal((1, rows, 1, dh)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, 1, dh)).astype(np.float32) for _ in range(2))
    seg_k, pos_k = np.ones((1, S), np.int32), np.arange(S, dtype=np.int32)[None]
    seg_q, pos_q = seg_k[:, :rows], pos_k[:, S - rows:]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * dh ** -0.5
    s = np.where(pos_q[:, None, :, None] >= pos_k[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v.astype(np.float64))
    top = np.abs(ref).max()
    errs = {mode: np.abs(_fwd_model(q, k, v, seg_q, seg_k, pos_q, pos_k, in_place=mode)[0]
                         - ref).max() / top for mode in (False, True)}
    assert errs[False] < 1e-4 / 4, errs
    assert errs[False] < errs[True], errs


# ------------------------------------------------ the fp32 kernels' tile walk
# A plain counterpart of `Walk::keep` with `summarise` and `Walk::sees`
# (csrc/tf32_common.cuh): a code-2 tile is kept; a code-1 tile only where some
# streamed row of it (nonzero segment) can see a resident row of the CTA's
# summary, per segment the least and greatest position of its resident rows,
# at most NSEG segments (more, or a negative id: no summary, every tile kept).

NSEG = 4


def _summary(seg, pos):
    if (seg < 0).any():
        return None
    ids = sorted(set(seg[seg != 0].tolist()))
    if len(ids) > NSEG:
        return None
    return [(s, int(pos[seg == s].min()), int(pos[seg == s].max())) for s in ids]


def _walk_keeps(code, summary, seg, pos, *, stream_q, causal, window):
    if code != 1 or summary is None:
        return code != 0
    for s, p in zip(seg.tolist(), pos.tolist()):
        for sid, lo, hi in summary:
            if s == 0 or s != sid:
                continue
            # a streamed query at p sees a resident key in [lo, hi], or a streamed key at p
            # a resident query in [lo, hi]
            c_ok = not causal or (lo <= p if stream_q else hi >= p)
            w_ok = window is None or (hi > p - window if stream_q else lo < p + window)
            if c_ok and w_ok:
                return True
    return False


def _walk_drops(seg, pos, window, rows, *, causal=True, keys=None):
    """Tiles of the map that the walk drops, over one packed row, with
    queries resident (the forward and the dQ kernel, 64 x 16 tiles) or keys
    (the dK/dV kernel, 32 x 64); fails where it drops a visible pair or
    keeps a tile the map skips. `keys`: the keys' (seg, pos) where they are
    not the queries' (cross-attention)."""
    bq, bk = (64, 16) if rows == "queries" else (32, 64)
    seg_k, pos_k = keys if keys is not None else (seg, pos)
    padded = _pad_all(t(seg), t(seg_k), t(pos), t(pos_k), 64, 64)
    codes = tile_map(*padded, bq, bk, causal=causal, window=window)[0].numpy()
    mask = attention_mask(*padded, causal=causal, window=window)[0].numpy()
    sq, sk, pq, pk = (x[0].numpy() for x in padded)
    dropped = 0
    for i in range(codes.shape[0]):
        for j in range(codes.shape[1]):
            qs, ks = slice(i * bq, (i + 1) * bq), slice(j * bk, (j + 1) * bk)
            if rows == "queries":
                kept = _walk_keeps(codes[i, j], _summary(sq[qs], pq[qs]), sk[ks], pk[ks],
                                   stream_q=False, causal=causal, window=window)
            else:
                kept = _walk_keeps(codes[i, j], _summary(sk[ks], pk[ks]), sq[qs], pq[qs],
                                   stream_q=True, causal=causal, window=window)
            assert kept or not mask[qs, ks].any(), (i, j)
            assert not kept or codes[i, j] != 0, (i, j)
            dropped += int(codes[i, j] != 0 and not kept)
    return dropped


@settings(max_examples=10, deadline=None)
@given(
    doc_split=st.lists(st.integers(1, 200), min_size=1, max_size=9),
    S=st.integers(40, 600),
    window=st.sampled_from([None, 5, 40, 300]),
    pad=st.integers(0, 70),
    rows=st.sampled_from(["queries", "keys"]),
)
def test_walk_keep_rule_never_drops_a_visible_pair(doc_split, S, window, pad, rows):
    """The tile walk both fp32 kernels share drops a tile of the map only
    where no pair in it is visible, and keeps none the map skips, with
    queries or keys resident, over random packings with padding rows and
    windows."""
    seg, pos = make_packed(np.random.default_rng(S), 1, S, doc_lens=doc_split)
    seg[:, S - pad:] = 0
    pos[:, S - pad:] = 0
    _walk_drops(seg, pos, window, rows)


@pytest.mark.parametrize("rows", ["queries", "keys"])
def test_walk_drops_tiles_at_document_starts(rows):
    """What the walk is for: a key tile that holds a document's end and the
    next one's start passes the map's range tests for every query tile of
    both documents, and the walk drops those that see neither part."""
    seg, pos = make_packed(np.random.default_rng(0), 1, 256, doc_lens=[100, 156])
    assert _walk_drops(seg, pos, None, rows) > 0


@settings(max_examples=10, deadline=None)
@given(
    Sq=st.integers(40, 400),
    Sk=st.integers(40, 700),
    n_docs=st.integers(1, 6),
    orphan=st.booleans(),
    rows=st.sampled_from(["queries", "keys"]),
)
def test_walk_keep_rule_noncausal_cross(Sq, Sk, n_docs, orphan, rows):
    """The same rule at causal=False over query and key ids of two sequences
    (cross-attention: the resident rows' segments come from the other
    sequence than the streamed rows'), a query document without keys
    included: no visible pair dropped, no skipped tile kept."""
    rng = np.random.default_rng(Sq * 1000 + Sk)
    seg_q, seg_k, pos_q, pos_k = cross_ids(rng, 1, Sq, Sk, min(n_docs, Sq // 8, Sk // 8) or 1,
                                           orphan=orphan)
    _walk_drops(seg_q, pos_q, None, rows, causal=False, keys=(seg_k, pos_k))


@pytest.mark.parametrize("rows", ["queries", "keys"])
def test_walk_drops_nothing_without_the_causal_test(rows):
    """At causal=False the map's segment range test is exact for sorted ids
    (a tile pair whose ranges meet shares a segment), so the walk, whose
    drops come from the causal and window tests at document starts, keeps
    every tile the map keeps: the encoder's packed clips, and the
    cross-attention's two sequences."""
    seg, pos = make_packed(np.random.default_rng(1), 1, 256, doc_lens=[100, 120, 36])
    assert _walk_drops(seg, pos, None, rows, causal=False) == 0
    seg_q, seg_k, pos_q, pos_k = cross_ids(np.random.default_rng(2), 1, 200, 500, 4)
    assert _walk_drops(seg_q, pos_q, None, rows, causal=False, keys=(seg_k, pos_k)) == 0
