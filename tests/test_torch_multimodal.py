"""The VLM and encoder-decoder families against the JAX package, on the CPU.

Reduced qwen2-vl-7b (M-RoPE sections (2, 3, 3) at head_dim 16, vision
embeddings in place of each row's first 8 token embeddings) and reduced
whisper-medium (2 encoder and 2 decoder layers, the decoder cross-attending
to the non-causal encoder's output), weights from one JAX `stacked_init`
carried over by `bridge.params_from_jax`, batches from
`data.multimodal` (numpy, seeded):

  * the config copies, field by field, and the parameter counts of `init_params`;
  * the packed forward's logits on rows that see a key, `loss_fn` and every
    gradient against `jax.value_and_grad(loss_fn)` (fp32, 1e-4);
  * prefill, the bridged JAX prefill caches (the cross K/V too) and greedy
    decode against the JAX `serve_forward` step by step (2e-4, the same
    tokens);
  * one `build_train_step` step, 2 micro-batches, AdamW and Adafactor
    (whose statistics of `enc_layers` are one stack, as the reference's
    scan-layout state), against the JAX train step computing in fp32:
    loss and grad norm (1e-4), every parameter (1e-5 relative plus 1e-3 lr;
    the elements whose gradient is within 1e-4 of its leaf's max of 0 but
    not 0 to 2 lr) and every optimizer statistic (1e-5).
Every decoder document of these batches has its clip: the JAX jnp attention
gives a row with no visible key the mean of V where the kernels give 0
(ROADMAP Queue 3), so such rows are held to the kernels elsewhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import (
    forward_train as j_forward_train,
    init_cache as j_init_cache,
    loss_fn as j_loss_fn,
    prefill_forward as j_prefill_forward,
    serve_forward as j_serve_forward,
    stacked_init,
)
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro.train import train_step as j_train_step
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import cache_from_jax, opt_state_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.data.multimodal import enc_dec_batch, mrope_positions, vlm_batch
from repro_torch.launch import train as t_launch
from repro_torch.models.model import (
    extend_cache,
    forward_train,
    init_cache,
    init_params,
    loss_fn,
)
from repro_torch.train.optimizer import make_optimizer, tree_leaves
from repro_torch.train.train_step import build_prefill_step, build_serve_step, build_train_step

from torch_helpers import n, t

ARCHS = ["qwen2-vl-7b", "whisper-medium"]
B, S, VIS, GRID = 2, 64, 8, (2, 4)       # the VLM's rows and vision span
FRAMES, DEC, CLIPS = 96, 24, (20, 40)     # the encoder-decoder's rows and clips
LR = 1e-3


def _models(arch):
    return reduced(get_arch(arch)), t_reduced(t_get_arch(arch))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg, tcfg = _models(request.param)
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(7), cfg))
    return cfg, tcfg, params, jax.tree.map(np.asarray, params)


def _batch(cfg, index=0):
    if cfg.enc_dec:
        return enc_dec_batch(cfg, FRAMES, DEC, B, seed=3, clip_frames=CLIPS, index=index)
    return vlm_batch(cfg, S, B, seed=3, vision_len=VIS, grid=GRID, index=index, mu=3.2,
                     sigma=0.8)


def _seg(cfg, batch):
    return batch["dec_segment_ids" if cfg.enc_dec else "segment_ids"]


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: t(v) for k, v in batch.items()}


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    mine, ref = t_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_count_and_keys(arch):
    """The port's tree holds the reference's keys and `param_count()`
    parameters (which leaves out an encoder-decoder's `norm_cross` of each
    decoder layer and its `enc_norm`): reduced, and whisper-medium at full
    width cut to one layer on each side (its cross block and `enc_layers`
    at 1024 wide)."""
    cfg, tcfg = _models(arch)
    cuts = [tcfg]
    if tcfg.enc_dec:
        cuts.append(dataclasses.replace(t_get_arch(arch), n_layers=1, n_enc_layers=1))
    for c in cuts:
        p = init_params(c, seed=0, dtype=torch.bfloat16, device="cpu")
        uncounted = (c.n_layers + 1) * c.d_model if c.enc_dec else 0
        assert sum(x.numel() for x in tree_leaves(p)) == c.param_count() + uncounted
        assert ("enc_layers" in p) == ("enc_norm" in p) == ("cross" in p["layers"][0]) == c.enc_dec
    jp, _ = split_annotations(jax.eval_shape(lambda k: stacked_init(k, cfg),
                                             jax.random.PRNGKey(0)))
    mine = init_params(tcfg, seed=0, dtype=torch.float32, device="cpu")
    assert sorted(mine) == sorted(jp)
    assert sorted(mine["layers"][0]) == sorted(jp["layers"][0])


def test_mrope_positions_of_the_vision_span():
    pos = mrope_positions(np.arange(10, dtype=np.int32), 6, (2, 3))
    np.testing.assert_array_equal(pos[:6], [[0, 0, 0], [0, 0, 1], [0, 0, 2],
                                            [0, 1, 0], [0, 1, 1], [0, 1, 2]])
    np.testing.assert_array_equal(pos[6:], np.repeat(np.arange(6, 10)[:, None], 3, 1))


def test_batches_hold_what_the_parity_needs():
    """Every VLM row opens with the vision span (labels -1 there) inside its
    first document; every decoder document has the clip of its segment id
    and a transcript of clip // dec_ratio tokens; both end in padding."""
    vcfg, wcfg = (_models(a)[0] for a in ARCHS)
    v = _batch(vcfg)
    assert v["positions"].shape == (B, S, 3) and v["vision_embeds"].shape == (B, VIS, 64)
    assert np.all(v["segment_ids"][:, :VIS] == 1) and np.all(v["labels"][:, :VIS] == -1)
    assert np.any(v["positions"][:, :VIS, 1] != v["positions"][:, :VIS, 2])
    w = _batch(wcfg)
    for b in range(B):
        enc, dec = w["enc_segment_ids"][b], w["dec_segment_ids"][b]
        assert set(dec[dec > 0].tolist()) == set(enc[enc > 0].tolist())
        for s in set(dec[dec > 0].tolist()):
            assert (dec == s).sum() == (enc == s).sum() // wcfg.dec_ratio
    assert (w["dec_segment_ids"] == 0).any() and (v["segment_ids"] == 0).any()


# ------------------------------------------------- forward, loss, gradients
def test_logits_loss_and_every_gradient_match_jax(family):
    cfg, tcfg, jparams, tree = family
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(j_loss_fn, argnums=1, has_aux=True)(
        cfg, jparams, _jax(batch), NULL_POLICY, remat=False, compute_dtype=jnp.float32)
    params = params_from_jax(tree, dtype=torch.float32, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, m = loss_fn(tcfg, params, _torch(batch), compute_dtype=torch.float32)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    assert float(m["ntokens"]) == float(jm["ntokens"])
    got = torch.autograd.grad(total, leaves)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), dtype=torch.float32,
                                       device="cpu"))
    assert len(got) == len(want) == len(leaves)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7
    with torch.no_grad():
        logits, _ = forward_train(tcfg, params, _torch(batch), compute_dtype=torch.float32)
    ref, _ = j_forward_train(cfg, jparams, _jax(batch), NULL_POLICY, remat=False,
                             compute_dtype=jnp.float32)
    valid = _seg(cfg, batch) != 0  # padding rows differ by design (ROADMAP Queue 3)
    np.testing.assert_allclose(n(logits)[valid], np.asarray(ref)[valid], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- prefill, decode
def _prompt(cfg):
    """Unpadded prompts: one document a row (the VLM's opening with its
    vision span), so prefill's last position is a real token."""
    rng = np.random.default_rng(9)
    if cfg.enc_dec:
        batch = enc_dec_batch(cfg, FRAMES, DEC, B, seed=4, clip_frames=(FRAMES, FRAMES))
        batch["dec_segment_ids"][:] = 1
        batch["dec_positions"][:] = np.arange(DEC)
        batch["dec_tokens"] = rng.integers(1, cfg.vocab_size, size=(B, DEC)).astype(np.int32)
        return {k: v for k, v in batch.items() if k != "labels"}
    pos = np.arange(S, dtype=np.int32)
    return {"tokens": rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "segment_ids": np.ones((B, S), np.int32),
            "positions": np.repeat(mrope_positions(pos, VIS, GRID)[None], B, 0),
            "vision_embeds": rng.standard_normal((B, VIS, cfg.d_model), dtype=np.float32)}


def test_prefill_then_greedy_decode_match(family):
    """Prefill's last logits and caches (the cross K/V of every decoder
    layer too, bridged from JAX by `cache_from_jax`), then 3 greedy steps
    (M-RoPE decode at `lengths` on all three axes; cross-attention over the
    constant cache) against the JAX `serve_forward`, fed the same tokens."""
    cfg, tcfg, jparams, tree = family
    prompt = _prompt(cfg)
    P = DEC if cfg.enc_dec else S
    tparams = params_from_jax(tree, dtype=torch.float32, device="cpu")
    j_last, j_caches = j_prefill_forward(cfg, jparams, _jax(prompt), NULL_POLICY,
                                         compute_dtype=jnp.float32)
    t_last, t_caches = build_prefill_step(tcfg, compute_dtype=torch.float32)(tparams,
                                                                             _torch(prompt))
    np.testing.assert_allclose(n(t_last), np.asarray(j_last), atol=2e-4, rtol=2e-4)
    ported = cache_from_jax(jax.tree.map(np.asarray, j_caches), device="cpu")
    assert len(ported) == len(t_caches) == cfg.n_layers
    for mine, theirs in zip(t_caches, ported):
        assert set(mine) == set(theirs) == ({"mixer", "cross"} if cfg.enc_dec else {"mixer"})
        for part in mine:
            for name, x in mine[part].items():
                np.testing.assert_allclose(n(x), n(theirs[part][name]), atol=2e-4, rtol=2e-4)

    max_len = P + 8
    cross_len = FRAMES if cfg.enc_dec else 0
    j_cache = jax.tree.map(lambda c, p: c.at[:, :, :p.shape[2]].set(p),
                           j_init_cache(cfg, B, max_len, cache_dtype=jnp.float32,
                                        cross_len=cross_len), j_caches)
    t_cache = extend_cache(tcfg, t_caches, max_len)
    if cfg.enc_dec:  # carried over, not copied
        assert all(a["cross"] is b["cross"] for a, b in zip(t_cache, t_caches))
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    cross = ({"cross_segment_ids": prompt["enc_segment_ids"],
              "cross_positions": np.tile(np.arange(FRAMES, dtype=np.int32), (B, 1))}
             if cfg.enc_dec else {})
    j_tok = jnp.argmax(j_last[:, -1], axis=-1).astype(jnp.int32)
    t_tok = t_last[:, -1].argmax(-1).to(torch.int32)
    for step in range(3):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        lengths = np.full((B,), P + step, np.int32)
        j_logits, j_cache = j_serve_forward(
            cfg, jparams, j_cache, {"tokens": j_tok[:, None], "lengths": jnp.asarray(lengths),
                                    **_jax(cross)}, NULL_POLICY, compute_dtype=jnp.float32)
        t_tok, t_logits, t_cache = serve(tparams, t_cache, {"tokens": t_tok[:, None],
                                                            "lengths": t(lengths),
                                                            **_torch(cross)})
        np.testing.assert_allclose(n(t_logits), np.asarray(j_logits), atol=2e-4, rtol=2e-4)
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1).astype(jnp.int32)


def test_init_cache_holds_zero_cross_caches():
    _, tcfg = _models("whisper-medium")
    cache = init_cache(tcfg, 3, 16, cache_dtype=torch.float32, device="cpu", cross_len=40)
    assert len(cache) == tcfg.n_layers
    for c in cache:
        assert c["cross"]["k_const"].shape == (3, 40, tcfg.n_kv_heads, tcfg.head_dim)
        assert not bool(c["cross"]["v_const"].any()) and c["mixer"]["k"].shape[1] == 16


# --------------------------------------------------------------- train step
def _sorted_leaves(tree):
    """Leaves in JAX's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _noisy(grads):
    return [(g != 0) & (g.abs() <= 1e-4 * g.abs().max()) for g in grads]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(family, monkeypatch, name):
    """One step of 2 micro-batches against the JAX train step (fp32)."""
    cfg, tcfg, jparams, tree = family

    def fp32_loss(cfg, params, batch, policy, **kw):
        return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)

    monkeypatch.setattr(j_train_step, "loss_fn", fp32_loss)
    jopt = j_make_optimizer(name, lr=LR)
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jopt, microbatches=2))(
        jstate, _jax(_batch(cfg, index=1)))

    topt = make_optimizer(name, lr=LR)
    params = params_from_jax(tree, dtype=torch.float32, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tstate = {"params": params, "opt": topt.init(params, period=len(tcfg.period)),
              "step": torch.zeros((), dtype=torch.int32)}
    if name == "adafactor" and tcfg.enc_dec:  # the encoder's statistics: one stack
        enc = tstate["opt"]["v"]["enc_layers"]
        assert len(enc) == 1 and tuple(enc[0]["norm1"]["vr"].shape) == (tcfg.n_enc_layers,)
    tstate, tm = build_train_step(tcfg, topt, microbatches=2, compute_dtype=torch.float32)(
        tstate, _torch(_batch(cfg, index=1)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["ntokens"]) == float(jm["ntokens"])
    host = jax.tree.map(np.asarray, jstate)
    want = tree_leaves(params_from_jax(host["params"], dtype=torch.float32, device="cpu"))
    noisy = _noisy([p.grad for p in tree_leaves(params)])
    assert sum(int(m.sum()) for m in noisy) <= 3e-3 * sum(m.numel() for m in noisy)
    for mask, a, b in zip(noisy, tree_leaves(tstate["params"]), want, strict=True):
        diff = (a.detach() - b).abs()
        assert bool((diff[~mask] <= 1e-5 * b.abs()[~mask] + 1e-3 * LR).all())
        assert bool((diff[mask] <= 2 * LR).all())
    if name == "adafactor":  # the statistics, stacked on both sides
        theirs = opt_state_from_jax(host["opt"], device="cpu")["v"]
        for key in ("layers", "enc_layers") if tcfg.enc_dec else ("layers",):
            got, ref = _sorted_leaves(tstate["opt"]["v"][key]), _sorted_leaves(theirs[key])
            assert len(got) == len(ref) > 0
            for a, b in zip(got, ref):
                assert a.shape == b.shape
                np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)


def test_driver_refuses_the_families_it_cannot_feed():
    """The driver's synthetic batches are token batches, as the reference's."""
    for arch in ARCHS:
        args = t_launch.parser().parse_args(["--reduced", "--arch", arch, "--steps", "1",
                                             "--seq-len", "64", "--batch", "2",
                                             "--device", "cpu"])
        cfg = t_reduced(t_get_arch(arch))
        with pytest.raises(ValueError, match="build_train_step"):
            t_launch.run_spmd(cfg, args)
        with pytest.raises(ValueError, match="build_train_step"):
            t_launch.run_pipeline(cfg, args)
