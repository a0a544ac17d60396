"""Port's packed attention against the JAX Pallas kernel (interpret mode) and
its jnp oracle, case for case with tests/test_kernels.py, at its tolerances
(2e-5 float32, 2e-2 bfloat16). On the CPU the port runs the plain version;
tests/test_torch_gpu.py holds the Hopper kernel against it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ht import given, settings, strategies as st

from repro.kernels.ops import packed_attention as j_packed_attention
from repro.kernels.packed_flash_attn import block_metadata as j_block_metadata
from repro.kernels.ref import packed_attention_ref as j_ref
from repro_torch.kernels import ops
from repro_torch.kernels.packed_flash_attn import (
    block_metadata,
    packed_flash_attention,
    skipped_block_fraction,
)

from conftest import make_packed
from torch_helpers import n, t

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

SWEEP = [
    (128, 4, 4, 32, 64, 64),    # MHA
    (128, 4, 2, 32, 64, 64),    # GQA 2:1
    (256, 8, 1, 16, 128, 128),  # MQA
    (192, 4, 4, 64, 64, 64),    # non-power-of-two block count + padding
    (128, 4, 4, 32, 32, 64),    # bq != bk
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


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """The kernel wrapper never falls back: a CPU tensor is refused."""
    q, k, v, seg, pos = _inputs(rng, 1, 64, 2, 2, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        packed_flash_attention(t(q), t(k), t(v), t(seg), t(seg), t(pos), t(pos))
