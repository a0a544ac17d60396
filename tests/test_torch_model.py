"""Port's model against JAX on reduced qwen3-8b, with weights carried by
`bridge.params_from_jax` from one `stacked_init`: packed forward and loss
(float32, 1e-4; bf16 loss 2e-2 relative), prefill and greedy decode (2e-4,
same tokens), and the port's own seeded init law."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models.model import (
    forward_train as j_forward_train,
    init_cache as j_init_cache,
    loss_fn as j_loss_fn,
    prefill_forward as j_prefill_forward,
    serve_forward as j_serve_forward,
    stacked_init,
)
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.model import (
    extend_cache,
    forward_train,
    init_params,
    loss_fn,
    prefill_forward,
)
from repro_torch.train.train_step import build_prefill_step, build_serve_step

from torch_helpers import n, t

B, S = 2, 64


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_arch("qwen3-8b"))
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(1), cfg))
    tree = jax.tree.map(np.asarray, params)
    return cfg, t_reduced(t_get_arch("qwen3-8b")), params, tree


def _batch(cfg, seed=0):
    """Short documents (mean ~30 tokens), so rows hold several and end in padding."""
    return SyntheticPackedDataset(cfg, S, B, seed=seed, mu=3.2, sigma=0.8).batch_at(0)


def _unpadded_batch(cfg):
    """Packed rows with no padding: prefill's last position is a real token."""
    rng = np.random.default_rng(5)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, lens in enumerate(([40, 24], [S])):
        off = 0
        for i, l in enumerate(lens):
            seg[b, off:off + l] = i + 1
            pos[b, off:off + l] = np.arange(l)
            off += l
    tokens = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def test_forward_and_loss_match_fp32(model):
    cfg, tcfg, params, tree = model
    batch = _batch(cfg)
    assert (batch["segment_ids"] == 0).any() and (batch["segment_ids"] != 0).any()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}
    tparams = params_from_jax(tree, dtype=torch.float32, device="cpu")
    ref, _ = j_forward_train(cfg, params, jb, NULL_POLICY, remat=False,
                             compute_dtype=jnp.float32)
    out, _ = forward_train(tcfg, tparams, tb, compute_dtype=torch.float32)
    valid = batch["segment_ids"] != 0  # padding rows differ by design (ROADMAP Queue 3)
    np.testing.assert_allclose(n(out)[valid], np.asarray(ref)[valid], atol=1e-4, rtol=1e-4)
    (jl, jm) = j_loss_fn(cfg, params, jb, NULL_POLICY, remat=False, compute_dtype=jnp.float32)
    (tl, tm) = loss_fn(tcfg, tparams, tb, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(tm["zloss"]), float(jm["zloss"]), atol=1e-4, rtol=1e-4)
    assert float(tm["ntokens"]) == float(jm["ntokens"])


def test_loss_matches_bf16(model):
    cfg, tcfg, params, tree = model
    batch = _batch(cfg, seed=3)
    jl, _ = j_loss_fn(cfg, params, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_POLICY,
                      remat=False)
    tparams = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    tl, _ = loss_fn(tcfg, tparams, {k: t(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= 2e-2 * abs(float(jl))


def test_prefill_then_greedy_decode_match(model):
    cfg, tcfg, params, tree = model
    batch = _unpadded_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}
    tparams = params_from_jax(tree, dtype=torch.float32, device="cpu")

    j_last, j_caches = j_prefill_forward(cfg, params, jb, NULL_POLICY, compute_dtype=jnp.float32)
    t_last, t_caches = build_prefill_step(tcfg, compute_dtype=torch.float32)(tparams, tb)
    np.testing.assert_allclose(n(t_last), np.asarray(j_last), atol=2e-4, rtol=2e-4)
    ported = cache_from_jax(jax.tree.map(np.asarray, j_caches), device="cpu")
    for mine, theirs in zip(t_caches, ported):
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(n(mine["mixer"][name]), n(theirs["mixer"][name]),
                                       atol=2e-4, rtol=2e-4)

    max_len = S + 8
    j_cache = jax.tree.map(lambda c, p: c.at[:, :, :S].set(p),
                           j_init_cache(cfg, B, max_len, cache_dtype=jnp.float32), j_caches)
    t_cache = extend_cache(tcfg, t_caches, max_len)
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    j_tok = jnp.argmax(j_last[:, -1], axis=-1).astype(jnp.int32)
    t_tok = t_last[:, -1].argmax(-1).to(torch.int32)
    for step in range(3):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        lengths = np.full((B,), S + step, np.int32)
        j_logits, j_cache = j_serve_forward(
            cfg, params, j_cache, {"tokens": j_tok[:, None], "lengths": jnp.asarray(lengths)},
            NULL_POLICY, compute_dtype=jnp.float32)
        t_tok, t_logits, t_cache = serve(tparams, t_cache,
                                         {"tokens": t_tok[:, None], "lengths": t(lengths)})
        np.testing.assert_allclose(n(t_logits), np.asarray(j_logits), atol=2e-4, rtol=2e-4)
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


def test_prefill_last_logits_equal_forward_last_position(model):
    cfg, tcfg, params, tree = model
    tb = {k: t(v) for k, v in _unpadded_batch(cfg).items()}
    tparams = params_from_jax(tree, dtype=torch.float32, device="cpu")
    last, _ = prefill_forward(tcfg, tparams, tb, compute_dtype=torch.float32)
    full, _ = forward_train(tcfg, tparams, tb, compute_dtype=torch.float32)
    np.testing.assert_allclose(n(last[:, 0]), n(full[:, -1]), atol=1e-5, rtol=1e-5)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def test_seeded_init_law_matches_reference(model):
    cfg, tcfg, _, tree = model
    ref = _flatten(params_from_jax(tree, dtype=torch.float32, device="cpu"))
    mine = _flatten(init_params(tcfg, seed=0, dtype=torch.float32, device="cpu"))
    assert sorted(mine) == sorted(ref)
    for key, r in ref.items():
        m = mine[key]
        assert m.shape == r.shape, key
        assert m.dtype == r.dtype, key
        rs, ms = float(r.std()), float(m.std())
        if rs == 0:
            assert ms == 0, key
        else:
            assert abs(ms - rs) <= 0.1 * rs, (key, ms, rs)
    again = _flatten(init_params(tcfg, seed=0, dtype=torch.float32, device="cpu"))
    assert all(torch.equal(again[k], mine[k]) for k in mine)
