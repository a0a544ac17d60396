"""Port's attention layer against JAX `attention`: the packed branch against
the Pallas-kernel branch (interpret mode) on all rows, padding included
(float32, 2e-5), and the decode branch over the same cache (1e-5)."""
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


def _setup(seed):
    cfg = reduced(get_arch("qwen3-8b"))
    tcfg = t_reduced(t_get_arch("qwen3-8b"))
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
