"""The port's int8 + error-feedback gradient compressor
(`repro_torch.train.compression`): every case of tests/test_compression.py
on the port, and its codes, scales, dequantized values and residuals held
exactly equal to the JAX `Int8Compressor`'s on the same numpy inputs
(padded tails, all-zero blocks, bf16 inputs and the error-feedback chain
included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ht import given, settings, strategies as st

from repro.train.compression import (
    Int8Compressor as JInt8Compressor,
    compress_tree as j_compress_tree,
    init_feedback as j_init_feedback,
)
from repro_torch.train.compression import Int8Compressor, compress_tree, init_feedback
from repro_torch.train.optimizer import tree_leaves

from torch_helpers import t


# ------------------------------------------------- the reference's cases
def test_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = t(rng.normal(size=(1000,)).astype(np.float32))
    comp = Int8Compressor(block=128)
    q, s, meta = comp.compress(x)
    deq = comp.decompress(q, s, meta)
    # per-block max-scaled int8: error <= scale/2 = max|block|/254
    blocks = x[:1000 // 128 * 128].numpy().reshape(-1, 128)
    bound = np.abs(blocks).max(axis=1) / 254.0 + 1e-7
    err = np.abs(deq.numpy()[:blocks.size].reshape(-1, 128) - blocks)
    assert (err <= bound[:, None] + 1e-6).all()


def test_compression_ratio():
    comp = Int8Compressor(block=256)
    x = torch.zeros((4096, 512), dtype=torch.float32)
    assert comp.ratio(x) > 3.9  # ~4x for f32 payloads


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 2000), block=st.sampled_from([64, 128, 256]))
def test_roundtrip_any_shape(n, block):
    rng = np.random.default_rng(n)
    x = t(rng.normal(size=(n,)).astype(np.float32)) * 10
    comp = Int8Compressor(block=block)
    q, s, meta = comp.compress(x)
    deq = comp.decompress(q, s, meta)
    assert deq.shape == x.shape
    assert float((deq - x).abs().max()) <= float(x.abs().max()) / 100.0


def test_error_feedback_converges():
    """With error feedback, the *accumulated* compressed sum tracks the true
    gradient sum (the residual never grows unboundedly)."""
    rng = np.random.default_rng(1)
    comp = Int8Compressor(block=64)
    true_sum = np.zeros(256, np.float32)
    sent_sum = np.zeros(256, np.float32)
    residual = torch.zeros(256)
    for _ in range(50):
        g = t(rng.normal(size=(256,)).astype(np.float32))
        true_sum += g.numpy()
        deq, residual = comp.roundtrip_with_feedback(g, residual)
        sent_sum += deq.numpy()
    # everything not yet sent lives in the residual
    np.testing.assert_allclose(sent_sum + residual.numpy(), true_sum, rtol=1e-4, atol=1e-3)
    assert float(residual.abs().max()) < 1.0  # bounded


def test_compress_tree():
    params = {"w": torch.ones((64, 32)), "b": torch.full((7,), 0.5)}
    res = init_feedback(params)
    comp = Int8Compressor(block=32)
    deq, new_res = compress_tree(comp, params, res)
    assert set(deq) == set(new_res) == set(params)
    assert all(deq[k].shape == params[k].shape for k in params)
    np.testing.assert_allclose(deq["w"].numpy(), 1.0, rtol=0.02)


def test_pure():
    """The counterpart of the reference's `jax.jit` case: a pure function of
    its inputs (no input changed, the same outputs twice), finite."""
    comp = Int8Compressor(block=64)
    g, r = torch.ones((128,)), torch.zeros((128,))
    deq, res = comp.roundtrip_with_feedback(g, r)
    again = comp.roundtrip_with_feedback(g, r)
    assert bool(torch.isfinite(deq).all())
    assert torch.equal(deq, again[0]) and torch.equal(res, again[1])
    assert torch.equal(g, torch.ones((128,))) and torch.equal(r, torch.zeros((128,)))


# ---------------------------------------------- bit for bit against JAX
def _inputs(rng, shape, kind):
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 1e3], size=shape)).astype(np.float32)
    if kind == "zero-blocks":  # every other 64-block all zero: the 1e-30 guard
        flat = x.reshape(-1)
        for b in range(0, flat.size, 128):
            flat[b:b + 64] = 0.0
    elif kind == "halves":  # codes at exact halves (scale 2**-4): round half to even
        x.reshape(-1)[0] = 127 * 2.0 ** -4
        x.reshape(-1)[1:64] = (np.arange(63) - 31.5).astype(np.float32) * 2.0 ** -4
    return x


CASES = [((1000,), 128, "normal"), ((3, 77, 5), 64, "normal"), ((4096,), 256, "zero-blocks"),
         ((640,), 64, "halves"), ((1,), 256, "normal"), ((257, 3), 256, "zero-blocks")]


@pytest.mark.parametrize("shape,block,kind", CASES)
def test_codes_and_scales_equal_jax(rng, shape, block, kind):
    x = _inputs(rng, shape, kind)
    jq, js, jmeta = JInt8Compressor(block=block).compress(jnp.asarray(x))
    q, s, meta = Int8Compressor(block=block).compress(t(x))
    if kind == "halves":  # ties went to the even code
        assert float(s[0]) == 2.0 ** -4
        assert q[0, 1:64].tolist() == [round(k - 31.5) for k in range(63)]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert meta == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Int8Compressor(block=block).decompress(q, s, meta).numpy(),
                                  np.asarray(JInt8Compressor(block=block).decompress(jq, js,
                                                                                    jmeta)))
    assert Int8Compressor(block=block).compressed_bytes(t(x)) == \
        JInt8Compressor(block=block).compressed_bytes(jnp.asarray(x))
    assert Int8Compressor(block=block).ratio(t(x)) == \
        JInt8Compressor(block=block).ratio(jnp.asarray(x))


def test_bf16_input_equal_jax(rng):
    x = rng.normal(size=(5, 100)).astype(np.float32)
    jq, js, _ = JInt8Compressor(block=64).compress(jnp.asarray(x, jnp.bfloat16))
    q, s, _ = Int8Compressor(block=64).compress(t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert Int8Compressor(block=64).ratio(t(x).to(torch.bfloat16)) == \
        JInt8Compressor(block=64).ratio(jnp.asarray(x, jnp.bfloat16))


def test_feedback_chain_equal_jax(rng):
    """20 error-feedback steps over a tree with a padded tail and an
    all-zero leaf: every dequantized gradient and residual equal."""
    shapes = {"w": (33, 17), "b": (7,), "z": (64,)}
    comp, jcomp = Int8Compressor(block=32), JInt8Compressor(block=32)
    res = init_feedback({k: torch.zeros(v) for k, v in shapes.items()})
    jres = j_init_feedback({k: jnp.zeros(v) for k, v in shapes.items()})
    for _ in range(20):
        g = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
        g["z"][:] = 0.0
        deq, res = compress_tree(comp, {k: t(v) for k, v in g.items()}, res)
        jdeq, jres = j_compress_tree(jcomp, {k: jnp.asarray(v) for k, v in g.items()}, jres)
        for k in shapes:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
    assert float(res["z"].abs().max()) == 0.0
    assert jax.tree.structure(jdeq) == jax.tree.structure({k: 0 for k in shapes})
    assert len(tree_leaves(deq)) == 3
