"""The port's training slice against the JAX package on the same numpy-seeded
inputs, with the JAX parameters carried over by `bridge.params_from_jax`:
the optimizers against `make_optimizer`, autograd through the plain packed
attention against `jax.grad` of the JAX oracle, the fp32 loss and every
gradient against `jax.value_and_grad(loss_fn)`, three micro-batched train
steps against the JAX train step, remat against no remat, the copied
Detector modules against their originals, and the spmd driver on the CPU.

The JAX train step computes in bf16; here it is made to compute in fp32 by
patching the `loss_fn` its module calls (the JAX package is not edited).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.detector.changepoint import (
    BOCPD as JBOCPD,
    CusumDetector as JCusum,
    SlopeDriftDetector as JSlope,
)
from repro.core.detector.detector import Detector as JDetector
from repro.core.detector.heartbeat import HeartbeatMonitor as JHeartbeat
from repro.data.synth import SyntheticPackedDataset
from repro.kernels.ref import packed_attention_ref as j_ref
from repro.models.model import loss_fn as j_loss_fn, stacked_init, unstack_from_scan
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro.train import train_step as j_train_step
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.detector.changepoint import BOCPD, CusumDetector, SlopeDriftDetector
from repro_torch.core.detector.detector import Detector
from repro_torch.core.detector.heartbeat import HeartbeatMonitor
from repro_torch.kernels.ref import attention_mask, packed_attention_ref
from repro_torch.launch import train as t_launch
from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import make_optimizer, tree_leaves, tree_map
from repro_torch.train.train_step import build_train_step, global_norm

from conftest import make_packed
from torch_helpers import n, t

S = 128
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_arch("qwen3-8b"))
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(2), cfg))
    return cfg, t_reduced(t_get_arch("qwen3-8b")), params


def _batch(cfg, B, index=0):
    """Packed rows of short documents that end in padding."""
    batch = SyntheticPackedDataset(cfg, S, B, seed=11, mu=3.6, sigma=0.8).batch_at(index)
    assert (batch["segment_ids"] == 0).any() and (batch["segment_ids"] != 0).any()
    return batch


def _port_params(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _sorted_leaves(tree):
    """Leaves in JAX's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _leaves_from_jax(tree):
    """A JAX tree in the scan layout -> the port's leaves, in the port's order."""
    return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree), dtype=torch.float32,
                                       device="cpu"))


# ------------------------------------------------------------- optimizers
def _opt_tree(rng, scale=1.0):
    shapes = {"w3": (3, 4, 5), "w2": (6, 7), "b": (5,), "layers": [{"a": (4, 3)}, {"a": (2,)}]}

    def make(shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return make(x)

    return walk(shapes)


def _stacked_tree(arch, n_layers):
    """A reduced arch's `stacked_init` tree (numpy): the reference's spmd layout."""
    cfg = reduced(get_arch(arch), n_layers=n_layers)
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(1), cfg))
    return len(cfg.period), jax.tree.map(np.asarray, params)


def _grads_like(rng, tree, scale):
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def _port_tree(tree, period):
    """A tree of `_opt_tree` (period None) or of `_stacked_tree` in the port's layout."""
    if period is None:
        return tree_map(lambda a: t(a), tree)
    return params_from_jax(tree, dtype=torch.float32, device="cpu")


# (arch, layers): reduced qwen3-moe at 4 layers (period 1: stacks of 4, its
# (E, D, F) experts stacked to 4 axes) and gemma3-1b at 26 (period 13, two
# periods: 13 stacks of 2, 1-axis norms factored as (2, D))
STACKED = {"qwen3-moe": ("qwen3-moe-30b-a3b", 4), "gemma3-1b": ("gemma3-1b", 26)}


@pytest.mark.parametrize("name,momentum,layout", [
    pytest.param("adamw", "float32", None, id="adamw-float32"),
    pytest.param("adafactor", "float32", None, id="adafactor-float32"),
    pytest.param("adafactor", "bfloat16", None, id="adafactor-bfloat16"),
    pytest.param("adamw", "float32", "qwen3-moe", id="adamw-float32-stacked-qwen3-moe"),
    pytest.param("adafactor", "float32", "qwen3-moe", id="adafactor-float32-stacked-qwen3-moe"),
    pytest.param("adafactor", "bfloat16", "qwen3-moe", id="adafactor-bfloat16-stacked-qwen3-moe"),
    pytest.param("adafactor", "bfloat16", "gemma3-1b", id="adafactor-bfloat16-stacked-gemma3-1b"),
])
def test_optimizer_matches_reference(rng, name, momentum, layout):
    """3 steps (stacked: 2) on the same gradients: parameters and every state
    leaf (AdamW m, v; Adafactor m in the momentum type and factored vr, vc
    for leaves of 2+ axes, v for 1-axis leaves) to 1e-6. `layout`: the
    reference's optimizer on a `stacked_init` tree (two or more periods),
    the port's on the same weights one dict per layer with
    `init(params, period)`, the spmd trainer's grouping: its Adafactor
    factors and clips each period position's layers as one stack, so its
    `vr`/`vc` leaves equal the reference's stacked ones and its parameters
    and momenta the reference's, carried over by `bridge` (1e-5)."""
    kw = dict(lr=1e-2, weight_decay=0.1)
    jopt = j_make_optimizer(name, momentum_dtype=getattr(jnp, momentum), **kw)
    topt = make_optimizer(name, momentum_dtype=getattr(torch, momentum), **kw)
    period, p0 = (None, _opt_tree(rng)) if layout is None else _stacked_tree(*STACKED[layout])
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _port_tree(p0, period)
    js, ts = jopt.init(jp), topt.init(tp, period=period)
    steps = 3 if layout is None else 2
    for step in range(steps):
        g = (_opt_tree(rng, scale=0.1 * (step + 1)) if layout is None
             else _grads_like(rng, p0, 0.1 * (step + 1)))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(_port_tree(g, period), ts, tp, torch.tensor(step))
    tol = 1e-6 if layout is None else 1e-5
    if layout is None:
        want_leaves = jax.tree.leaves((jp, js))
    else:  # the reference's state in the port's layout
        host = jax.tree.map(np.asarray, (jp, js))
        want_leaves = _sorted_leaves((params_from_jax(host[0], dtype=torch.float32,
                                                      device="cpu"),
                                      opt_state_from_jax(host[1], device="cpu")))
        if name == "adafactor":  # the stacked statistics, read straight from each side
            stats = _sorted_leaves(ts["v"]["layers"])
            assert len(stats) == len(jax.tree.leaves(js["v"]["layers"])) > 0
            for got, want in zip(stats, jax.tree.leaves(js["v"]["layers"])):
                assert tuple(got.shape) == want.shape
                np.testing.assert_allclose(n(got), np.asarray(want), atol=tol, rtol=tol)
    _assert_state_close(_sorted_leaves((tp, ts)), want_leaves, _sorted_leaves(tp), ts["m"],
                        tol, kw["lr"], 0 if layout is None else steps)


def _assert_state_close(got_leaves, want_leaves, params, momenta, tol, lr, updates):
    """Parameters and state leaves (params first) to `tol`, dtypes equal.
    With `updates` (stacked layouts; 0 holds every leaf to `tol`), a
    bf16 momentum is held to one bf16 step of its leaf's largest value
    (2^-7 of max |m|) per update, and its parameter to lr times that more:
    in the stacked layout the stack's RMS is summed in another order than
    the reference's mean, and that 1e-7 difference in the fp32 update can
    round a momentum element to the neighbouring bf16 value, a step that
    later updates carry on at the old magnitude."""
    assert len(want_leaves) == len(got_leaves)
    slack = [lr * updates * 2 ** -7 * float(m.float().abs().max())
             if m.dtype == torch.bfloat16 and updates else 0.0 for m in _sorted_leaves(momenta)]
    for i, (want, got) in enumerate(zip(want_leaves, got_leaves)):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype).removeprefix("torch.")
        want = n(want) if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
        if got.dtype == torch.bfloat16 and updates:
            np.testing.assert_allclose(n(got), want, rtol=0,
                                       atol=updates * 2 ** -7 * np.abs(want).max())
        else:
            extra = slack[i] if i < len(params) else 0.0
            np.testing.assert_allclose(n(got), want, atol=tol + extra, rtol=tol)


def test_opt_state_from_jax_continues_the_stacked_adafactor(rng):
    """The reference's spmd Adafactor state (bf16 momentum) after one step,
    carried over by `bridge.opt_state_from_jax`, takes the port's second
    step to the reference's (1e-5). The statistics stay stacked; a stack
    whose statistics do not factor its layer count raises, and so does a
    per-layer {"v"} in a stack. The list layout (the reference's pipeline
    engine) converts layer by layer."""
    kw = dict(lr=1e-2, weight_decay=0.1, momentum_dtype=jnp.bfloat16)
    jopt = j_make_optimizer("adafactor", **kw)
    topt = make_optimizer("adafactor", **{**kw, "momentum_dtype": torch.bfloat16})
    period, p0 = _stacked_tree("qwen3-moe-30b-a3b", 4)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    g0, g1 = (_grads_like(rng, p0, s) for s in (0.1, 0.2))
    jp, js = jopt.update(jax.tree.map(jnp.asarray, g0), js, jp, jnp.asarray(0, jnp.int32))
    host = jax.tree.map(np.asarray, js)
    ts = opt_state_from_jax(host, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.float32, device="cpu")
    norm = ts["v"]["layers"][0]["norm1"]
    assert tuple(norm["vr"].shape) == (4,) and tuple(norm["vc"].shape) == (64,)
    assert ts["m"]["layers"][3]["ffn"]["w_up"].dtype == torch.bfloat16
    jp, js = jopt.update(jax.tree.map(jnp.asarray, g1), js, jp, jnp.asarray(1, jnp.int32))
    tp, ts = topt.update(_port_tree(g1, period), ts, tp, torch.tensor(1))
    host = jax.tree.map(np.asarray, (jp, js))
    want = _sorted_leaves((params_from_jax(host[0], dtype=torch.float32, device="cpu"),
                           opt_state_from_jax(host[1], device="cpu")))
    _assert_state_close(_sorted_leaves((tp, ts)), want, _sorted_leaves(tp), ts["m"], 1e-5,
                        kw["lr"], 1)

    bad = jax.tree.map(np.asarray, js)
    bad["v"]["layers"][0]["norm1"]["vr"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stack of 4 layers"):
        opt_state_from_jax(bad, device="cpu")
    bad["v"]["layers"][0]["norm1"] = {"v": np.zeros((4, 64), np.float32)}
    with pytest.raises(ValueError, match="stack of 4 layers"):
        opt_state_from_jax(bad, device="cpu")
    layers = jax.tree.map(np.asarray, jopt.init(_list_layout(jp)))
    per_layer = opt_state_from_jax(layers, device="cpu")
    assert isinstance(per_layer["v"]["layers"], list) and len(per_layer["v"]["layers"]) == 4
    assert set(per_layer["v"]["layers"][2]["norm1"]) == {"v"}


def test_pipeline_engine_adafactor_is_per_layer_as_the_reference_engine(monkeypatch):
    """The pipeline engine keeps per-layer Adafactor (bf16 momentum), as the
    reference's engine, which trains the list layout: reduced qwen3-8b at 4
    layers under dp1/pp2, 3 steps from the same weights, fp32: the losses
    (1e-5), then every parameter and state leaf, a norm's `v` unfactored,
    against the JAX engine's (1e-5; the momentum to one bf16 step of its
    leaf's largest value, and its parameter to lr times that)."""
    from repro.core.scheduler.plan import initial_plan as j_initial_plan
    from repro.engine import pipeline as j_pipeline
    from repro_torch.core.scheduler.plan import initial_plan
    from repro_torch.engine.pipeline import PipelineEngine

    j_embed = j_pipeline.embed_tokens
    monkeypatch.setattr(j_pipeline, "embed_tokens",
                        lambda cfg, p, tokens: j_embed(cfg, p, tokens, jnp.float32))
    cfg = reduced(get_arch("qwen3-8b"), n_layers=4)
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=4)
    kw = dict(lr=5e-3, momentum_dtype=jnp.bfloat16)
    jeng = j_pipeline.PipelineEngine(cfg, j_initial_plan(4, dp=1, pp=2, tp=1, microbatches=2),
                                     optimizer=j_make_optimizer("adafactor", **kw), seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params_full), dtype=torch.float32,
                             device="cpu")
    topt = make_optimizer("adafactor", **{**kw, "momentum_dtype": torch.bfloat16})
    teng = PipelineEngine(tcfg, initial_plan(4, dp=1, pp=2, tp=1, microbatches=2),
                          optimizer=topt, devices=[torch.device("cpu")], params=params,
                          compute_dtype=torch.float32)
    assert set(teng.opt_state["v"]["layers"][0]["norm1"]) == {"v"}
    for i in range(3):
        batch = SyntheticPackedDataset(cfg, 64, 2, seed=3).batch_at(i)
        jl = jeng.run_iteration({k: jnp.asarray(v) for k, v in batch.items()})[0]
        tl = teng.run_iteration({k: t(v) for k, v in batch.items()})[0]
        np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    host = jax.tree.map(np.asarray, (jeng.params_full, jeng.opt_state))
    want = _sorted_leaves((params_from_jax(host[0], dtype=torch.float32, device="cpu"),
                           opt_state_from_jax(host[1], device="cpu")))
    _assert_state_close(_sorted_leaves((teng.params_full, teng.opt_state)), want,
                        _sorted_leaves(teng.params_full), teng.opt_state["m"], 1e-5, kw["lr"], 3)


def _list_layout(stacked):
    """The list layout of a stacked tree (the reference's pipeline engine's)."""
    n_layers = len(stacked["layers"]) * jax.tree.leaves(stacked["layers"][0])[0].shape[0]
    return dict(stacked, layers=unstack_from_scan(stacked["layers"], n_layers))


# ------------------------------------------------- gradient of the oracle
@pytest.mark.parametrize("window", [None, 24])
def test_plain_attention_gradient_matches_jax(rng, window):
    """autograd of the port's plain version against jax.grad of the JAX
    oracle, padding rows included: 1e-5."""
    B, Sq, H, K, dh = 2, 96, 4, 2, 16
    q, k, v = (rng.normal(size=(B, Sq, h, dh)).astype(np.float32) for h in (H, K, K))
    g = rng.normal(size=(B, Sq, H, dh)).astype(np.float32)
    seg, pos = make_packed(rng, B, Sq, doc_lens=[30, 41])  # rows end in 25 padding positions
    assert (seg == 0).any()
    kw = dict(causal=True, window=window)

    def jloss(q, k, v):
        return jnp.sum(j_ref(q, k, v, seg, seg, pos, pos, **kw) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    out = packed_attention_ref(tq, tk, tv, t(seg), t(seg), t(pos), t(pos), **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), t(g))
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert bool((got[0][t(seg) == 0] == 0).all())


def _bf16_backward(q, k, v, out, d_out, seg, pos, *, window, round_bf16=True):
    """FlashAttention-2's backward of the port's plain attention, in fp32 on
    bf16 inputs, with the bf16 backward kernel's one numerical change: P and
    dS rounded to bf16 before the three products that take them (dV = P^T dO,
    dK = scale dS^T Q, dQ = scale dS K). lse, S, dP and delta stay fp32, as
    in the kernel; dk and dv are summed over each GQA group."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    scale = dh ** -0.5
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, d_out))
    kr, vr = (x.repeat_interleave(H // K, dim=2) for x in (kf, vf))
    mask = attention_mask(seg, seg, pos, pos, causal=True, window=window)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1, keepdim=True)
    p = torch.exp(s - lse.clamp_min(-1e30)).masked_fill(~mask, 0.0)
    delta = (of * gf).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vr) - delta)
    if round_bf16:
        p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, S, K, H // K, dh).sum(3) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf).reshape(B, S, K, H // K, dh).sum(3)
    return dq, dk, dv


@pytest.mark.parametrize("S,H,K,dh,window,pad", [
    (256, 8, 2, 128, None, 0),   # qwen3-8b head width and GQA 4:1
    (192, 4, 4, 64, 48, 0),      # sliding window
    (160, 8, 2, 128, 40, 40),    # GQA 4:1, a window and 40 padding rows
])
def test_bf16_backward_rounding_stays_within_tolerance(rng, S, H, K, dh, window, pad):
    """The tolerance argument for the bf16 backward kernel's one numerical
    change: rounding P and dS to bf16 before dV, dK and dQ keeps each of dq,
    dk and dv within 2e-2 of max |ref| of jax.grad through the JAX reference
    on the same bf16 inputs; padding rows and keys stay exactly 0."""
    B = 2
    q, k, v, g = (rng.normal(size=(B, S, h, dh)).astype(np.float32) for h in (H, K, K, H))
    q, k, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v, g))
    seg, pos = make_packed(rng, B, S, doc_lens=[S // 3, S])
    if pad:
        seg[:, -pad:] = 0
        pos[:, -pad:] = 0
    kw = dict(causal=True, window=window)

    def jloss(q, k, v):
        out = j_ref(q, k, v, seg, seg, pos, pos, **kw).astype(jnp.float32)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    tq, tk, tv, tg = (t(a).to(torch.bfloat16) for a in (q, k, v, g))
    ts, tp = t(seg), t(pos)
    out = packed_attention_ref(tq, tk, tv, ts, ts, tp, tp, **kw)
    got = _bf16_backward(tq, tk, tv, out, tg, ts, tp, window=window)
    exact = _bf16_backward(tq, tk, tv, out, tg, ts, tp, window=window, round_bf16=False)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, exact):
        ref = np.asarray(b, np.float32)
        assert np.abs(n(a) - ref).max() <= 2e-2 * np.abs(ref).max(), name
        assert np.abs(n(a) - n(c)).max() > 0, name  # the rounding is really there
        if pad:
            assert np.all(n(a)[:, -pad:] == 0), name


# ----------------------------------------------------- loss and gradients
def test_fp32_loss_and_every_gradient_match(model):
    cfg, tcfg, jparams = model
    batch = _batch(cfg, 2)
    (jl, _), jg = jax.value_and_grad(j_loss_fn, argnums=1, has_aux=True)(
        cfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_POLICY, remat=False,
        compute_dtype=jnp.float32)
    params = _port_params(jparams)
    total, _ = loss_fn(tcfg, params, {k: t(v) for k, v in batch.items()},
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    leaves = tree_leaves(params)
    got = torch.autograd.grad(total, leaves)
    want = _leaves_from_jax(jg)
    assert len(got) == len(want) == len(leaves)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7


def test_remat_matches_no_remat(model):
    cfg, tcfg, jparams = model
    tb = {k: t(v) for k, v in _batch(cfg, 2, index=1).items()}
    out = []
    for remat in (True, False):
        params = _port_params(jparams)
        total, _ = loss_fn(tcfg, params, tb, remat=remat, compute_dtype=torch.float32)
        out.append((total.detach(), torch.autograd.grad(total, tree_leaves(params))))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("clip_norm", [1.0, 0.05])
def test_train_step_matches_reference(model, monkeypatch, clip_norm):
    """3 steps, 2 micro-batches, AdamW; clip_norm=0.05 binds (asserted).

    Loss and grad norm to 1e-4 relative; parameters to 1e-5 relative plus
    1e-3 * lr. Exempt from that: the elements whose gradient at some step is
    within the gradient parity tolerance of 0 but not exactly 0
    (0 < |g| <= 1e-4 max|g| of its leaf; 0.2% of the elements here). Where
    |g| comes near eps, AdamW's update m / (sqrt(v) + eps) follows the
    rounding noise of g, which can move it anywhere in [-1, 1]; so they are
    held to the bound 2 * lr * steps that any two AdamW runs obey, and they
    may be at most 0.3% of the elements."""
    cfg, tcfg, jparams = model

    def fp32_loss(cfg, params, batch, policy, **kw):
        return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)

    monkeypatch.setattr(j_train_step, "loss_fn", fp32_loss)
    jopt = j_make_optimizer("adamw", lr=LR)
    jstep = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jopt, microbatches=2,
                                                  clip_norm=clip_norm))
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    topt = make_optimizer("adamw", lr=LR)
    params = _port_params(jparams)
    tstate = {"params": params, "opt": topt.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    tstep = build_train_step(tcfg, topt, microbatches=2, clip_norm=clip_norm,
                             compute_dtype=torch.float32)
    steps = 3
    noisy = [torch.zeros(p.shape, dtype=torch.bool) for p in tree_leaves(params)]
    for i in range(steps):
        batch = _batch(cfg, 4, index=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["ntokens"]) == float(jm["ntokens"])
        if clip_norm < 1:
            assert float(jm["grad_norm"]) > clip_norm
        for mask, p in zip(noisy, tree_leaves(params)):
            mask |= (p.grad != 0) & (p.grad.abs() <= 1e-4 * p.grad.abs().max())
    assert int(tstate["step"]) == int(jstate["step"]) == steps
    exempt = sum(int(m.sum()) for m in noisy)
    assert exempt <= 3e-3 * sum(m.numel() for m in noisy)
    for mask, a, b in zip(noisy, tree_leaves(tstate["params"]), _leaves_from_jax(jstate["params"])):
        diff = (a.detach() - b).abs()
        assert bool((diff[~mask] <= 1e-5 * b.abs()[~mask] + 1e-3 * LR).all())
        assert bool((diff[mask] <= 2 * LR * steps).all())


def test_global_norm():
    tree = {"a": torch.tensor([3.0, 0.0]), "b": [torch.tensor([[4.0]])]}
    assert float(global_norm(tree)) == 5.0


# ---------------------------------------------------------- detector copies
def _series(seed=3, n_it=160):
    """Iteration times: noisy baseline, a benign workload swing, a fail-slow
    level shift from iteration 100."""
    rng = np.random.default_rng(seed)
    work = 1.0 + 0.3 * (rng.random(n_it) > 0.9)
    times = 0.5 * work + rng.normal(0, 0.01, n_it)
    times[100:] *= 1.6
    return work, times


@pytest.mark.parametrize("kind", ["cusum", "bocpd", "slope"])
def test_changepoint_copies_match(kind):
    _, times = _series()
    make = {"cusum": (CusumDetector, JCusum), "bocpd": (BOCPD, JBOCPD),
            "slope": (SlopeDriftDetector, JSlope)}[kind]
    ours, ref = make[0](), make[1]()
    fired = [(ours.update(float(x)), ref.update(float(x))) for x in times]
    assert [a for a, _ in fired] == [b for _, b in fired]
    assert any(a for a, _ in fired)


@pytest.mark.parametrize("workload_filter", [True, False])
def test_detector_copy_matches(workload_filter):
    work, times = _series(seed=5)

    def make(cls, hb, cusum):
        return cls(healthy_time_fn=lambda w: 0.5 * w,
                   validate_fn=lambda it: [(3, 0.6)] if it >= 100 else [],
                   heartbeat=hb(), workload_filter=workload_filter,
                   changepoint_factory=lambda: cusum(warmup=8))

    ours, ref = make(Detector, HeartbeatMonitor, CusumDetector), make(JDetector, JHeartbeat, JCusum)
    for it, (w, x) in enumerate(zip(work, times)):
        a = ours.observe_iteration(it, float(x), float(w), now=float(it))
        b = ref.observe_iteration(it, float(x), float(w), now=float(it))
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.kind, a.devices, a.iteration) == (b.kind, b.devices, b.iteration)
    assert ours.stats.as_dict() == ref.stats.as_dict()
    assert ours.stats.detections >= 1


def test_heartbeat_copy_matches():
    ours, ref = HeartbeatMonitor(), JHeartbeat()
    for hb in (ours, ref):
        for node in range(3):
            hb.register_node(node, [8 * node + i for i in range(4)])
    found = []
    for now in np.arange(0.0, 30.0, 0.5):
        for hb in (ours, ref):
            for node in range(3):
                if node == 2 and now > 12:
                    continue  # node 2 dies
                for i in range(4):
                    if (node, i) == (0, 1) and now > 20:
                        continue  # one device of node 0 dies
                    hb.device_beat(node, 8 * node + i, float(now))
                hb.node_beat(node, float(now))
        found.append((sorted(ours.sweep(float(now))), sorted(ref.sweep(float(now)))))
    assert [a for a, _ in found] == [b for _, b in found]
    assert sum(len(a) for a, _ in found) == 5
    assert ours.n_messages_per_interval == ref.n_messages_per_interval


# ------------------------------------------------------------------ driver
def test_run_spmd_on_cpu():
    args = t_launch.parser().parse_args(
        ["--reduced", "--steps", "4", "--seq-len", "64", "--batch", "4", "--device", "cpu"])
    cfg = t_reduced(t_get_arch(args.arch))
    result = t_launch.run_spmd(cfg, args)
    assert set(result) == {"losses", "times", "detector"}
    assert len(result["losses"]) == len(result["times"]) == 4
    assert all(np.isfinite(result["losses"])) and all(x > 0 for x in result["times"])
    assert set(result["detector"]) >= {"false_alarms", "detections"}


def test_driver_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What this test refused before is read now: --tp in spmd mode (at world
    size 1 the run is the run without it; under torchrun it shards:
    tests/test_torch_sharding.py), --mode pipeline trains, --ckpt-dir writes
    a committed checkpoint. Still refused: a --tp that does not divide the
    world size, the pipeline-only flags in spmd mode."""
    base = ["--reduced", "--steps", "1", "--seq-len", "64", "--batch", "4", "--device", "cpu"]
    assert t_launch.main(base + ["--tp", "2"])["losses"] == t_launch.main(base)["losses"]
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide the world size 3"):
        t_launch.main(base + ["--tp", "2"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="--mode pipeline"):
        t_launch.main(base + ["--dp", "2"])
    r = t_launch.main(base + ["--mode", "pipeline"])
    assert r["reconfigs"] == [] and r["plan"] == "dp0[s0:tp1xL2 s1:tp1xL2] dp1[s0:tp1xL2 s1:tp1xL2]"
    t_launch.main(base + ["--ckpt-dir", str(tmp_path), "--ckpt-interval", "1"])
    assert latest_step(tmp_path) == 1


# one case per flag the driver once refused; each now shows the flag read
@pytest.mark.parametrize("flag", [["--ckpt-interval", "2"], ["--resume"], ["--dp", "1"],
                                  ["--pp", "1"], ["--tp", "2"], ["--inject-failstop", "3:0"],
                                  ["--inject-failslow", "3:1@0.3"]])
def test_driver_refuses_unported_flags(flag, tmp_path):
    pipe = ["--reduced", "--mode", "pipeline", "--seq-len", "64", "--batch", "4",
            "--device", "cpu"]
    name = flag[0]
    if name == "--ckpt-interval":
        t_launch.main(["--reduced", "--steps", "3", "--seq-len", "64", "--batch", "4",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path), *flag])
        assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_000000002"]
    elif name == "--resume":
        t_launch.main(pipe + ["--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"])
        r = t_launch.main(pipe + ["--steps", "3", "--ckpt-dir", str(tmp_path), *flag])
        assert len(r["losses"]) == 1  # steps 2.. only
    elif name in ("--dp", "--pp", "--tp"):
        r = t_launch.main(pipe + ["--steps", "1", *flag])
        want = {"--dp": "dp0[s0:tp1xL2 s1:tp1xL2]",
                "--pp": "dp0[s0:tp1xL4] dp1[s0:tp1xL4]",
                "--tp": "dp0[s0:tp2xL2 s1:tp2xL2] dp1[s0:tp2xL2 s1:tp2xL2]"}[name]
        assert r["plan"] == want
    else:
        r = t_launch.main(pipe + ["--steps", "4", "--tp", "2", *flag])
        assert r["reconfigs"] == [3] and "dp0[s0:tp1" in r["plan"]
        assert all(np.isfinite(r["losses"]))
