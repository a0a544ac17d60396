"""Port's attention layer against JAX `attention`: the packed branch against
the Pallas-kernel branch (interpret mode) on all rows, padding included
(float32, 2e-5), and the decode branch over the same cache (1e-5); the
encoder's non-causal self-attention and the decoder's cross-attention over
an encoder output of another length (reduced whisper-medium), the same way,
with a decoder document that has no clip (exactly 0 from both), prefill's
constant cross K/V and decode over them."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch, reduced
from repro.models.attention import attention as j_attention, init_attention
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.attention import attention

from torch_helpers import n, t

B, S = 2, 64


def _setup(seed, arch="qwen3-8b"):
    cfg = reduced(get_arch(arch))
    tcfg = t_reduced(t_get_arch(arch))
    p, _ = split_annotations(init_attention(jax.random.PRNGKey(seed), cfg))
    p = {k: np.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    return cfg, tcfg, cfg.period[0], p, tp


def test_packed_branch_matches_pallas_branch_all_rows(rng):
    cfg, tcfg, spec, p, tp = _setup(0)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, lens in enumerate(([20, 30], [10, 22, 32])):  # row 0 ends in padding
        off = 0
        for i, l in enumerate(lens):
            seg[b, off:off + l] = i + 1
            pos[b, off:off + l] = np.arange(l)
            off += l
    abs_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    md = {"segment_ids": jnp.asarray(seg), "positions": jnp.asarray(pos),
          "abs_positions": jnp.asarray(abs_pos), "causal": True,
          "use_pallas_kernel": True, "kernel_block_q": 32, "kernel_block_k": 32}
    ref, _ = j_attention(cfg, spec, p, jnp.asarray(x), md, NULL_POLICY)
    tmd = {"segment_ids": t(seg), "positions": t(pos), "abs_positions": t(abs_pos),
           "causal": True, "collect_state": True}
    out, cache = attention(tcfg, spec, tp, t(x), tmd)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert cache["k"].shape == (B, S, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_array_equal(cache["pos"].numpy(), abs_pos)


def test_decode_branch_matches(rng):
    cfg, tcfg, spec, p, tp = _setup(1)
    T, K, dh = 16, cfg.n_kv_heads, cfg.head_dim
    lengths = np.array([5, 9], np.int32)
    ck = rng.normal(size=(B, T, K, dh)).astype(np.float32)
    cv = rng.normal(size=(B, T, K, dh)).astype(np.float32)
    cpos = np.full((B, T), -1, np.int32)
    for b, L in enumerate(lengths):
        cpos[b, :L] = np.arange(L)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    md = {"positions": jnp.asarray(lengths[:, None]), "lengths": jnp.asarray(lengths),
          "segment_ids": jnp.ones((B, 1), jnp.int32), "causal": True}
    cache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(cpos)}
    ref, ref_cache = j_attention(cfg, spec, p, jnp.asarray(x), md, NULL_POLICY, cache=cache)
    tmd = {"positions": t(lengths[:, None]), "lengths": t(lengths),
           "segment_ids": t(np.ones((B, 1), np.int32)), "causal": True}
    tcache = {"k": t(ck), "v": t(cv), "pos": t(cpos)}
    out, new_cache = attention(tcfg, spec, tp, t(x), tmd, cache=tcache)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(n(new_cache[name]), np.asarray(ref_cache[name], np.float32),
                                   atol=1e-6, rtol=1e-6)


def _packed_ids(S, docs, B=2):
    """(seg, pos) of B rows holding `docs[b]` documents in turn; the rest padding."""
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, lens in enumerate(docs):
        off = 0
        for i, l in enumerate(lens):
            seg[b, off:off + l] = i + 1
            pos[b, off:off + l] = np.arange(l)
            off += l
    return seg, pos


def test_noncausal_branch_matches_pallas_branch_all_rows(rng):
    """The encoder's self-attention (causal False) with padding frames."""
    cfg, tcfg, spec, p, tp = _setup(2, "whisper-medium")
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    seg, pos = _packed_ids(S, ([30, 20], [64]))
    abs_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    md = {"segment_ids": jnp.asarray(seg), "positions": jnp.asarray(pos),
          "abs_positions": jnp.asarray(abs_pos), "causal": False,
          "use_pallas_kernel": True, "kernel_block_q": 32, "kernel_block_k": 32}
    ref, _ = j_attention(cfg, spec, p, jnp.asarray(x), md, NULL_POLICY)
    tmd = {"segment_ids": t(seg), "positions": t(pos), "abs_positions": t(abs_pos),
           "causal": False}
    out, _ = attention(tcfg, spec, tp, t(x), tmd)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-5, rtol=2e-5)
    # a key after the query changes the query's output: not causal
    causal, _ = attention(tcfg, spec, tp, t(x), {**tmd, "causal": True})
    assert float((causal - out)[0, :29].abs().max()) > 1e-3


def _cross_inputs(rng, cfg):
    """Decoder rows of 24 positions over encoder rows of 40 frames; row 1's
    third decoder document has no clip (its segment id is not in the
    encoder row), and both rows end in padding."""
    S_dec, S_enc = 24, 40
    x = rng.normal(size=(B, S_dec, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, S_enc, cfg.d_model)).astype(np.float32)
    seg, pos = _packed_ids(S_dec, ([10, 9], [6, 8, 5]))
    cseg, _ = _packed_ids(S_enc, ([22, 14], [13, 20]))
    abs_dec = np.tile(np.arange(S_dec, dtype=np.int32), (B, 1))
    abs_enc = np.tile(np.arange(S_enc, dtype=np.int32), (B, 1))
    return x, enc, seg, pos, cseg, abs_dec, abs_enc


def test_cross_branch_matches_pallas_branch_all_rows(rng):
    """Cross-attention (Sq 24 != Sk 40, query and key ids from two
    sequences, never causal) against the Pallas branch on every row: the
    decoder document without a clip and the padding give exactly 0. With
    collect_state it returns the constant K/V of the encoder output."""
    cfg, tcfg, spec, p, tp = _setup(3, "whisper-medium")
    x, enc, seg, pos, cseg, abs_dec, abs_enc = _cross_inputs(rng, cfg)
    md = {"segment_ids": jnp.asarray(seg), "positions": jnp.asarray(pos),
          "abs_positions": jnp.asarray(abs_dec), "causal": True, "cross_x": jnp.asarray(enc),
          "cross_segment_ids": jnp.asarray(cseg), "cross_positions": jnp.asarray(abs_enc),
          "use_pallas_kernel": True, "kernel_block_q": 8, "kernel_block_k": 8,
          "collect_state": True}
    ref, ref_cache = j_attention(cfg, spec, p, jnp.asarray(x), md, NULL_POLICY)
    tmd = {"segment_ids": t(seg), "positions": t(pos), "abs_positions": t(abs_dec),
           "causal": True, "cross_x": t(enc), "cross_segment_ids": t(cseg),
           "cross_positions": t(abs_enc), "collect_state": True}
    out, cache = attention(tcfg, spec, tp, t(x), tmd)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert set(cache) == {"k_const", "v_const"}
    for name in ("k_const", "v_const"):
        assert cache[name].shape == (B, 40, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(n(cache[name]), np.asarray(ref_cache[name]), atol=1e-6,
                                   rtol=1e-6)
    no_key = seg == 0
    no_key[1, 14:19] = True  # row 1's document 3: no encoder clip 3
    # the layer's output projection of a zero attention output is exactly 0
    assert bool((out[t(no_key)] == 0).all()) and bool((out[t(~no_key)] != 0).any(-1).all())


def test_cross_decode_reads_the_constant_cache(rng):
    """Decode over the constant cross K/V: the JAX `k_const` branch's output
    (1e-5), and the cache is returned as it came, unwritten."""
    cfg, tcfg, spec, p, tp = _setup(4, "whisper-medium")
    _, _, _, _, cseg, _, abs_enc = _cross_inputs(rng, cfg)
    K, dh = cfg.n_kv_heads, cfg.head_dim
    ck, cv = (rng.normal(size=(B, 40, K, dh)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([5, 9], np.int32)
    md = {"positions": jnp.asarray(lengths[:, None]), "lengths": jnp.asarray(lengths),
          "segment_ids": jnp.ones((B, 1), jnp.int32), "causal": True,
          "cross_segment_ids": jnp.asarray(cseg), "cross_positions": jnp.asarray(abs_enc)}
    ref, _ = j_attention(cfg, spec, p, jnp.asarray(x), md, NULL_POLICY,
                         cache={"k_const": jnp.asarray(ck), "v_const": jnp.asarray(cv)})
    tcache = {"k_const": t(ck), "v_const": t(cv)}
    tmd = {"positions": t(lengths[:, None]), "lengths": t(lengths),
           "segment_ids": t(np.ones((B, 1), np.int32)), "causal": True,
           "cross_segment_ids": t(cseg), "cross_positions": t(abs_enc)}
    out, new_cache = attention(tcfg, spec, tp, t(x), tmd, cache=tcache)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert new_cache is tcache
    np.testing.assert_array_equal(n(tcache["k_const"]), ck)
    np.testing.assert_array_equal(n(tcache["v_const"]), cv)
