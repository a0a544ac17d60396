"""The dense family beyond qwen3-8b against the JAX package, on the CPU.

  * the config copies (gemma3-1b, gemma3-4b, h2o-danube-1.8b, the paper's
    Table 3 models, with PAPER_PARALLELISM and PAPER_MODELS, and the MoE
    family's qwen3-moe-30b-a3b and grok-1-314b), field by field;
  * the plain packed attention at head_dim 80 and 256, with a window and GQA
    groups 1 and 7, against the JAX Pallas kernel in interpret mode (fp32
    2e-5, bf16 2e-2) on the rows where the kernel's windowed tile skip keeps
    every visible pair, and against its jnp oracle on every row;
  * `loss_fn` and every gradient of reduced llama2-7b (MHA), qwen2.5-7b (7
    heads over 1 KV head), gemma3-1b (tied embeddings, period 13) and
    h2o-danube-1.8b, each at its real head width, against the JAX `loss_fn`
    (fp32, 1e-4);
  * greedy decode through sliding-window ring caches that wrap (window 8, 3 x
    window steps) against the JAX `serve_forward` step by step (2e-4), the
    JAX cache carried over by `bridge.cache_from_jax` (2e-4), and the
    port's prefill + `extend_cache` + decode against its own decode from an
    empty cache (1e-4);
  * the pipeline engine with tied embeddings at pp 2: the full gradient it
    hands the optimizer against the single-device `loss_fn` gradient (1e-4
    of each leaf's max), and its gradient sums that refuse mismatched leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.configs import paper_models as j_paper_models
from repro.data.synth import SyntheticPackedDataset
from repro.kernels.packed_flash_attn import block_metadata as j_block_metadata
from repro.kernels.packed_flash_attn import packed_flash_attention as j_packed_flash_attention
from repro.kernels.ref import packed_attention_ref as j_ref
from repro.models.model import (
    init_cache as j_init_cache,
    loss_fn as j_loss_fn,
    serve_forward as j_serve_forward,
    stacked_init,
)
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, paper_models, reduced as t_reduced
from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan, initial_plan
from repro_torch.engine.pipeline import PipelineEngine, zip_leaves
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_mask
from repro_torch.models.model import (
    cache_len,
    extend_cache,
    init_cache,
    init_params,
    loss_fn,
    prefill_forward,
)
from repro_torch.train.optimizer import Optimizer, tree_leaves
from repro_torch.train.train_step import build_serve_step

from conftest import make_packed
from torch_helpers import n, t

ARCHS = ["gemma3-1b", "gemma3-4b", "h2o-danube-1.8b", "llama2-7b", "llama2-13b", "llama2-30b",
         "llama2-70b", "qwen2.5-7b", "qwen2.5-14b", "qwen2.5-32b", "qwen2.5-72b",
         "qwen3-moe-30b-a3b", "grok-1-314b"]
CPU = [torch.device("cpu")]


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    mine, ref = t_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert [s.attn_kind for s in mine.layer_specs()] == [s.attn_kind for s in ref.layer_specs()]


def test_moe_config_copies_keep_the_reference_numbers():
    """Capacity factor 1.25 (the base default), grok-1 without qk-norm, and
    the parameter counts the port's phases size their cuts by."""
    qwen, grok = t_get_arch("qwen3-moe-30b-a3b"), t_get_arch("grok-1-314b")
    assert qwen.capacity_factor == grok.capacity_factor == 1.25
    assert qwen.qk_norm and not grok.qk_norm
    assert (qwen.n_experts, qwen.moe_top_k, grok.n_experts, grok.moe_top_k) == (128, 8, 8, 2)
    assert round(qwen.param_count() / 1e9, 2) == 30.53 and round(grok.param_count() / 1e9, 1) == 316.5


def test_paper_parallelism_and_models_match_reference():
    assert paper_models.PAPER_PARALLELISM == j_paper_models.PAPER_PARALLELISM
    assert paper_models.PAPER_MODELS == j_paper_models.PAPER_MODELS
    assert t_get_arch("qwen2.5-7b").n_heads // t_get_arch("qwen2.5-7b").n_kv_heads == 7
    assert t_get_arch("llama2-7b").n_heads == t_get_arch("llama2-7b").n_kv_heads == 32


# --------------------------------------------------------------- attention
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BQ = 32  # the JAX kernel's tiles here


@pytest.mark.parametrize("dh,H,K,window", [
    (80, 4, 4, None),   # h2o-danube's head width, GQA group 1
    (80, 8, 2, 24),     # with a window
    (256, 7, 1, None),  # gemma3's head width, group 7
    (256, 4, 1, 24),    # gemma3-1b's heads, with a window
    (128, 7, 1, 24),    # qwen2.5-7b's group
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax_kernel_at_new_head_dims(rng, dh, H, K, window, dtype):
    B, S = 2, 96
    q, k, v = (np.asarray(jnp.asarray(rng.normal(size=(B, S, h, dh)), JDT[dtype])
                          .astype(jnp.float32)) for h in (H, K, K))
    seg, pos = make_packed(rng, B, S, doc_lens=[40, 30, 26])  # documents cross tile edges
    jargs = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)] + [jnp.asarray(seg), jnp.asarray(seg),
                                                               jnp.asarray(pos), jnp.asarray(pos)]
    kw = {"causal": True, "window": window}
    kern = np.asarray(j_packed_flash_attention(*jargs, block_q=BQ, block_k=BQ, interpret=True,
                                               **kw), np.float32)
    ref = np.asarray(j_ref(*jargs, **kw), np.float32)
    ts, tp = t(seg), t(pos)
    out = n(ops.packed_attention(*(t(a).to(TDT[dtype]) for a in (q, k, v)), ts, ts, tp, tp, **kw))
    # rows with a visible key in a tile the reference's window skip drops
    # (tests/test_torch_kernels.py: test_jax_window_skip_loses_visible_keys)
    meta = np.asarray(j_block_metadata(*jargs[3:], BQ, BQ, **kw))
    skipped = np.repeat(np.repeat(meta == 0, BQ, axis=1), BQ, axis=2)
    lost = (attention_mask(ts, ts, tp, tp, **kw).numpy() & skipped).any(-1)
    assert window is not None or not lost.any()
    np.testing.assert_allclose(out[~lost], kern[~lost], atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------------- loss and gradients
FAMILY = {  # reduced(...) overrides: the arch's head width and GQA group
    "llama2-7b": {"n_kv_heads": 4},  # MHA (reduced caps KV heads at 2)
    "qwen2.5-7b": {"n_heads": 7, "n_kv_heads": 1, "head_dim": 16},
    "gemma3-1b": {"n_layers": 13, "head_dim": 256},  # one period: 11 local, 2 global, tied
    "h2o-danube-1.8b": {"head_dim": 80},
}


def _models(arch, **extra):
    over = {**FAMILY[arch], **extra}
    return reduced(get_arch(arch), **over), t_reduced(t_get_arch(arch), **over)


def _leaves(tree):
    return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree), dtype=torch.float32,
                                       device="cpu"))


@pytest.mark.parametrize("arch", list(FAMILY))
def test_loss_and_every_gradient_match_jax(arch):
    cfg, tcfg = _models(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(3), cfg))
    batch = SyntheticPackedDataset(cfg, 64, 2, seed=5, mu=3.2, sigma=0.8).batch_at(0)
    (jl, _), jg = jax.value_and_grad(j_loss_fn, argnums=1, has_aux=True)(
        cfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_POLICY, remat=False,
        compute_dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32, device="cpu")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = loss_fn(tcfg, params, {k: t(v) for k, v in batch.items()},
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    got, want = torch.autograd.grad(total, leaves), _leaves(jg)
    assert len(got) == len(want) == len(leaves)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7


# ------------------------------------------------------------ ring decode
WINDOW, B_DEC = 8, 2


def _decode_model():
    """gemma3-1b cut to one period at a window of 8: 11 ring layers, 2 full."""
    return _models("gemma3-1b", window=WINDOW, head_dim=32)


def test_ring_cache_shapes():
    _, tcfg = _decode_model()
    cache = init_cache(tcfg, B_DEC, 32, cache_dtype=torch.float32, device="cpu")
    kinds = [s.attn_kind for s in tcfg.layer_specs()]
    assert [c["mixer"]["k"].shape[1] for c in cache] == [16 if k == "swa" else 32 for k in kinds]
    assert kinds.count("swa") == 11 and cache_len(tcfg, tcfg.layer_spec(5), 12) == 12
    assert all(bool((c["mixer"]["pos"] == -1).all()) for c in cache)


def test_greedy_decode_through_wrapping_rings_matches_jax():
    """3 x window greedy steps from an empty cache (the 16-slot rings wrap at
    step 16): every step's logits against JAX `serve_forward` fed the same
    token, and the port's greedy token is JAX's argmax wherever JAX's top
    two differ by more than 1e-4."""
    cfg, tcfg = _decode_model()
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(4), cfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32,
                              device="cpu")
    max_len, steps = 32, 3 * WINDOW
    j_cache = j_init_cache(cfg, B_DEC, max_len, cache_dtype=jnp.float32)
    t_cache = init_cache(tcfg, B_DEC, max_len, cache_dtype=torch.float32, device="cpu")
    j_step = jax.jit(lambda p, c, b: j_serve_forward(cfg, p, c, b, NULL_POLICY,
                                                     compute_dtype=jnp.float32))
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    tok = t(np.random.default_rng(6).integers(1, cfg.vocab_size, size=B_DEC).astype(np.int32))
    for step in range(steps):
        lengths = np.full((B_DEC,), step, np.int32)
        j_logits, j_cache = j_step(jparams, j_cache, {"tokens": jnp.asarray(n(tok)[:, None]
                                                                            .astype(np.int32)),
                                                      "lengths": jnp.asarray(lengths)})
        tok, t_logits, t_cache = serve(tparams, t_cache, {"tokens": tok[:, None],
                                                          "lengths": t(lengths)})
        jl = np.asarray(j_logits)[:, -1]
        np.testing.assert_allclose(n(t_logits)[:, -1], jl, atol=2e-4, rtol=2e-4)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(n(tok)[clear], jl.argmax(-1)[clear])
    ring = t_cache[0]["mixer"]["pos"]  # a local layer: the last 16 positions
    assert sorted(ring[0].tolist()) == list(range(steps - 16, steps))
    # the JAX cache, rings and full layers, carried over by the bridge
    ported = cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    assert len(ported) == len(t_cache)
    for mine, theirs in zip(t_cache, ported):
        for name in ("k", "v", "pos"):
            assert mine["mixer"][name].shape == theirs["mixer"][name].shape
            np.testing.assert_allclose(n(mine["mixer"][name]), n(theirs["mixer"][name]),
                                       atol=2e-4, rtol=2e-4)


def test_prefill_extend_decode_matches_decode_from_empty():
    """A 20-token prompt (longer than the 16-slot rings) by prefill +
    `extend_cache`, then 8 decode steps, against the same tokens decoded one
    by one from an empty cache."""
    _, tcfg = _decode_model()
    params = init_params(tcfg, seed=2, dtype=torch.float32, device="cpu")
    P, extra, max_len = 20, 8, 32
    tokens = t(np.random.default_rng(8).integers(1, tcfg.vocab_size,
                                                 size=(B_DEC, P + extra)).astype(np.int32))
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)

    def step(cache, i):
        lengths = torch.full((B_DEC,), i, dtype=torch.int32)
        return serve(params, cache, {"tokens": tokens[:, i:i + 1], "lengths": lengths})[1:]

    empty = init_cache(tcfg, B_DEC, max_len, cache_dtype=torch.float32, device="cpu")
    from_empty, after_prompt = [], None
    for i in range(P + extra):
        logits, empty = step(empty, i)
        from_empty.append(logits[:, -1])
        if i == P - 1:  # the cache decode holds after the prompt
            after_prompt = [{"mixer": {k: v.clone() for k, v in c["mixer"].items()}}
                            for c in empty]
    batch = {"tokens": tokens[:, :P], "segment_ids": torch.ones((B_DEC, P), dtype=torch.int32),
             "positions": torch.arange(P, dtype=torch.int32).repeat(B_DEC, 1)}
    last, caches = prefill_forward(tcfg, params, batch, compute_dtype=torch.float32)
    np.testing.assert_allclose(n(last[:, -1]), n(from_empty[P - 1]), atol=1e-4, rtol=1e-4)
    cache = extend_cache(tcfg, caches, max_len)
    for mine, ref in zip(cache, after_prompt, strict=True):
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(n(mine["mixer"][name]), n(ref["mixer"][name]),
                                       atol=1e-5, rtol=1e-5)
    for i in range(P, P + extra):
        logits, cache = step(cache, i)
        np.testing.assert_allclose(n(logits[:, -1]), n(from_empty[i]), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------- pipeline
class _Recorder:
    """An optimizer that records the full gradient tree the engine hands it."""

    def __init__(self):
        self.grads = None
        self.opt = Optimizer("record", lambda params: {}, self._update, 0.0)

    def _update(self, grads, state, params, step):
        self.grads = grads
        return params, state


@pytest.mark.parametrize("dp", [1, 2])
def test_pipeline_tied_embeddings_match_single_device_gradient(dp):
    """gemma3-1b reduced (tied embeddings) at pp 2, 2 micro-batches a
    replica: the last stage reads `embed` for its LM head, and the update
    gets the sum of both stages' embed gradients; every leaf of the full
    gradient equals the gradient of the single-device `loss_fn` NLL mean
    (1e-4 of the leaf's max). The leaves' `.grad` are released after."""
    _, tcfg = _models("gemma3-1b", head_dim=32)
    rec = _Recorder()
    params = init_params(tcfg, seed=1, dtype=torch.float32, device="cpu")
    eng = PipelineEngine(tcfg, initial_plan(tcfg.n_layers, dp=dp, pp=2, tp=1, microbatches=2),
                         optimizer=rec.opt, devices=CPU, params=params,
                         compute_dtype=torch.float32)
    assert "embed" in eng.stage_params(0, 1) and "lm_head" not in eng.params_full
    raw = SyntheticPackedDataset(tcfg, 64, 2 * dp, seed=7, mu=3.2, sigma=0.8).batch_at(0)
    batch = {k: t(v) for k, v in raw.items()}
    loss, _ = eng.run_iteration(batch)
    leaves = tree_leaves(eng.params_full)
    assert all(p.grad is None for p in leaves)
    _, m = loss_fn(tcfg, eng.params_full, batch, compute_dtype=torch.float32)
    np.testing.assert_allclose(loss, float(m["loss"].detach()), rtol=1e-5)
    want = torch.autograd.grad(m["loss"], leaves)
    got = tree_leaves(rec.grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7


def test_gradient_sums_refuse_mismatched_leaves():
    """`zip_leaves` raises on another count or shape of leaves, and so does
    the engine where a sum would pair different leaves: the DP reduce of
    replicas whose stages hold different layers, and the accumulation of a
    micro-batch migrated onto a stage with other layers (with an optimizer
    or without)."""
    a, b = [torch.zeros(2), torch.zeros(3)], [torch.zeros(2)]
    with pytest.raises(ValueError, match="2 leaves against 1"):
        list(zip_leaves(a, b, "test"))
    with pytest.raises(ValueError, match="leaf 1 has shape"):
        list(zip_leaves(a, [torch.zeros(2), torch.zeros(4)], "test"))
    assert len(list(zip_leaves(a, [torch.ones(2), torch.ones(3)], "test"))) == 2

    _, tcfg = _models("llama2-7b", n_layers=4)
    params = init_params(tcfg, seed=0, dtype=torch.float32, device="cpu")
    uneven = ParallelPlan((ReplicaPlan((StagePlan((0,), (0,)), StagePlan((1,), (1, 2, 3)))),
                           ReplicaPlan((StagePlan((2,), (0, 1)), StagePlan((3,), (2, 3))))),
                          microbatches=2)
    batch = {k: t(v) for k, v in
             SyntheticPackedDataset(tcfg, 32, 4, seed=1, mu=3.0, sigma=0.5).batch_at(0).items()}
    eng = PipelineEngine(tcfg, uneven, optimizer=_Recorder().opt, devices=CPU, params=params,
                         compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="DP reduce of stage 0"):
        eng.run_iteration(batch)
    even = initial_plan(4, dp=2, pp=2, tp=1, microbatches=2)
    eng = PipelineEngine(tcfg, dataclasses.replace(even, replicas=(even.replicas[0],
                                                                   uneven.replicas[0])),
                         devices=CPU, params=params, compute_dtype=torch.float32)
    # micro-batch 1 of replica 0, stage 0 (layers 0, 1) run on replica 1's stage 0 (layer 0)
    placement = {ChunkId(kind, 1, 0, 0): (1, 0) for kind in ("F", "B")}
    with pytest.raises(ValueError, match="gradient accumulation"):
        eng.run_iteration(batch, placement=placement)
    eng.optimizer = _Recorder().opt
    eng.opt_state = eng.optimizer.init(eng.params_full)
    with pytest.raises(ValueError, match="gradient accumulation"):
        eng.run_iteration(batch, placement=placement)
    assert all(p.grad is None for p in tree_leaves(eng.params_full))
