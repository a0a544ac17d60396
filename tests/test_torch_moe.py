"""The MoE family (qwen3-moe-30b-a3b, grok-1-314b) against the JAX package, on
the CPU, every comparison in fp32:

  * `init_moe`'s keys, shapes and law (normal / sqrt(fan_in));
  * `_capacity` against the reference over a grid of (T, k, E, factor);
  * `moe_ffn` and its gradients against the JAX `_moe_math` (1e-5): at the
    default capacity, at capacity factor 0.25 (tokens dropped, asserted),
    and with padding rows (one repeated row that crowds its experts);
  * `router_aux_loss` and its gradients (1e-5);
  * reduced qwen3-moe and grok-1: `loss_fn` (with `moe_aux`) and every
    gradient against the JAX `loss_fn` on `stacked_init` weights carried
    over by `bridge.params_from_jax` (1e-4), a train step's clipped
    gradients against the JAX `build_train_step` (1e-4 of max), and greedy
    decode against the JAX `serve_forward` (2e-4).

`jax.lax.top_k` and `torch.topk` need not break ties alike, so every case
checks that its routers see no near-tie: in each row the k-th and the
(k+1)-th probabilities differ by more than 1e-5 (`_no_near_ties`), far above
the two packages' fp32 difference. The model cases' weight seeds are drawn
so (seed 3 gives a grok-1 row a gap of 5.3e-6 in the loss case; the check
refuses it).

With MoE a padding row is not inert: it takes expert capacity and counts in
moe_aux. The reference's jnp attention gives it the mean of V, its Pallas
kernel and the port give it 0, so the model cases fill each row's padding
with one more document (labels -1), and one case holds the padded rows
against the reference's kernel path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models import moe as j_moe
from repro.models import model as j_model
from repro.models.model import (
    forward_train as j_forward_train,
    init_cache as j_init_cache,
    loss_fn as j_loss_fn,
    serve_forward as j_serve_forward,
    stacked_init,
)
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro.train import train_step as j_train_step
from repro.train.optimizer import Optimizer as JOptimizer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import moe
from repro_torch.models.model import forward_train, init_cache, loss_fn
from repro_torch.train.optimizer import Optimizer, tree_leaves
from repro_torch.train.train_step import build_serve_step, build_train_step

from torch_helpers import n, t

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
GAP = 1e-5  # least gap between a row's k-th and (k+1)-th router probability


def _models(arch, **over):
    return reduced(get_arch(arch), **over), t_reduced(t_get_arch(arch), **over)


def _gap(probs, k):
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


@pytest.fixture
def _no_near_ties(monkeypatch):
    """Records the least top-k gap of every router call of the port; the test
    asserts it after its forward passes."""
    gaps, route = [], moe.route

    def checked(cfg, router, xt):
        probs = torch.softmax(xt.detach().float() @ router.detach().float(), dim=-1)
        gaps.append(_gap(n(probs), cfg.moe_top_k))
        return route(cfg, router, xt)

    monkeypatch.setattr(moe, "route", checked)
    return gaps


# -------------------------------------------------------------- init, capacity
def test_init_moe_keys_shapes_and_law():
    cfg, tcfg = _models("qwen3-moe-30b-a3b", d_model=256, moe_d_ff=128, n_experts=8)
    jp, _ = split_annotations(j_moe.init_moe(jax.random.PRNGKey(0), cfg))
    g = torch.Generator().manual_seed(0)
    tp = moe.init_moe(g, tcfg, dtype=torch.float32, device="cpu")
    assert set(tp) == set(jp) == {"router", "w_gate", "w_up", "w_down"}
    fan_in = {"router": 256, "w_gate": 256, "w_up": 256, "w_down": 128}
    for name, w in tp.items():
        assert tuple(w.shape) == jp[name].shape and w.dtype == torch.float32
        for std in (float(w.std()), float(np.std(jp[name]))):  # 16k to 262k draws each
            assert abs(std * fan_in[name] ** 0.5 - 1) < 0.02, name
        assert abs(float(w.mean())) < 0.01 / fan_in[name] ** 0.5 * 8


@pytest.mark.parametrize("E,k,factor", [(4, 2, 1.25), (128, 8, 1.25), (8, 2, 1.25),
                                        (8, 2, 0.25), (16, 1, 2.0), (64, 6, 1.0)])
def test_capacity_matches_reference(E, k, factor):
    """At least 8, a multiple of 8, at most T; T counts every position."""
    cfg, tcfg = _models("qwen3-moe-30b-a3b", n_experts=E, moe_top_k=k, capacity_factor=factor)
    for T in (1, 3, 4, 7, 8, 9, 64, 100, 128, 1000, 4096, 8192, 8196):
        c = moe._capacity(tcfg, T)
        assert c == j_moe._capacity(cfg, T)
        assert c == T or (c >= 8 and c % 8 == 0 and c < T)


# ------------------------------------------------------------------ the layer
def _layer_inputs(rng, B, S, D, Fd, E, padding):
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    if padding:  # the last 40% of every row one repeated vector, as padding tokens
        x[:, -(2 * S // 5):] = x[0, 0]
    w = {"router": rng.normal(size=(D, E)) / D ** 0.5,
         "w_gate": rng.normal(size=(E, D, Fd)) / D ** 0.5,
         "w_up": rng.normal(size=(E, D, Fd)) / D ** 0.5,
         "w_down": rng.normal(size=(E, Fd, D)) / Fd ** 0.5}
    return x, {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("case", ["default", "drops", "padding"])
def test_moe_ffn_matches_jax(rng, case):
    """moe_ffn and its gradients (x and every weight, through a random
    cotangent) against the JAX `_moe_math`, fp32, 1e-5 (gradients: 1e-5 of
    max). `drops`: capacity factor 0.25, some ranks past C; `padding`: a
    repeated row crowds its experts at the default factor and drops too."""
    B, S, D, Fd, E = 2, 48, 32, 24, 8
    factor = 0.25 if case == "drops" else 1.25
    cfg, tcfg = _models("qwen3-moe-30b-a3b", d_model=D, moe_d_ff=Fd, n_experts=E,
                        capacity_factor=factor)
    k = cfg.moe_top_k
    x, w = _layer_inputs(rng, B, S, D, Fd, E, padding=case == "padding")
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w["router"]), axis=-1)
    assert _gap(probs, k) > GAP  # no near-tie: both packages pick the same experts
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    names = ("router", "w_gate", "w_up", "w_down")

    def jfn(x, *ws):
        return jnp.sum(j_moe._moe_math(cfg, *ws, x) * cot), j_moe._moe_math(cfg, *ws, x)

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=tuple(range(5)), has_aux=True)(
        jnp.asarray(x), *(jnp.asarray(w[name]) for name in names))
    tx = t(x).requires_grad_(True)
    tw = {name: t(w[name]).requires_grad_(True) for name in names}
    moe.moe_ffn.routes = []
    try:
        out = moe.moe_ffn(tcfg, tw, tx)
        routes = moe.moe_ffn.routes
    finally:
        moe.moe_ffn.routes = None
    np.testing.assert_allclose(n(out), np.asarray(jout), atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(out, (tx, *tw.values()), t(cot))
    for a, b in zip(got, jgrads):
        b = np.asarray(b)
        assert np.abs(n(a) - b).max() <= 1e-5 * np.abs(b).max() + 1e-7
    (r,) = routes
    assert r["experts"].shape == r["kept"].shape == (B, S, k)
    dropped = int((~r["kept"]).sum())
    assert (dropped > 0) == (case != "default"), dropped


def test_moe_ffn_ranks_token_major():
    """Ranks count earlier assignments to the same expert in token-major,
    k-minor order: with every token on experts (0, 1) and C = 8, tokens 0-7
    keep both slots and tokens 8 on drop both."""
    cfg = t_reduced(t_get_arch("qwen3-moe-30b-a3b"), d_model=8, moe_d_ff=8, n_experts=4,
                    capacity_factor=0.25)
    T = 32
    assert moe._capacity(cfg, T) == 8
    router = torch.zeros(8, 4)
    router[0] = torch.tensor([3.0, 2.0, 0.0, -1.0])
    x = torch.zeros(1, T, 8)
    x[..., 0] = 1.0
    p = {"router": router, "w_gate": torch.ones(4, 8, 8), "w_up": torch.ones(4, 8, 8),
         "w_down": torch.ones(4, 8, 8)}
    moe.moe_ffn.routes = []
    try:
        y = moe.moe_ffn(cfg, p, x)
        (r,) = moe.moe_ffn.routes
    finally:
        moe.moe_ffn.routes = None
    assert r["experts"][0, :, 0].eq(0).all() and r["experts"][0, :, 1].eq(1).all()
    assert r["kept"][0, :8].all() and not r["kept"][0, 8:].any()
    assert bool((y[0, 8:] == 0).all()) and bool((y[0, :8] != 0).all())


def test_router_aux_loss_matches_jax(rng):
    cfg, tcfg = _models("qwen3-moe-30b-a3b", d_model=32, n_experts=8)
    x = rng.normal(size=(2, 40, 32)).astype(np.float32)
    r = (rng.normal(size=(32, 8)) / 32 ** 0.5).astype(np.float32)
    want, (gx, gr) = jax.value_and_grad(
        lambda x, r: j_moe.router_aux_loss(cfg, {"router": r}, x), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(r))
    tx, tr = t(x).requires_grad_(True), t(r).requires_grad_(True)
    got = moe.router_aux_loss(tcfg, {"router": tr}, tx)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(got, (tx, tr)), (gx, gr)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-7, rtol=1e-5)


# ------------------------------------------------------------ the model
def _model(arch, seed=3):
    cfg, tcfg = _models(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg) and tcfg.n_experts == 4
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(seed), cfg))
    return cfg, tcfg, jparams


def _port(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32,
                             device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _leaves(tree):
    return tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree), dtype=torch.float32,
                                       device="cpu"))


def _filled(batch):
    """`batch` with each row's padding made one more document whose labels
    stay -1: the reference's jnp attention gives a padding row the mean of
    V where its kernel and the port give 0, and with MoE a padding row is
    not inert (it takes expert capacity and counts in moe_aux)."""
    batch = {k: v.copy() for k, v in batch.items()}
    seg, pos = batch["segment_ids"], batch["positions"]
    for b in range(seg.shape[0]):
        pad = seg[b] == 0
        seg[b, pad] = seg[b].max() + 1
        pos[b, pad] = np.arange(int(pad.sum()))
    assert (batch["labels"] == -1).any()
    return batch


def _close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()) + 1e-7


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_jax(arch, _no_near_ties):
    """fp32, 2 x 64 packed rows whose padding is `_filled`: total loss (NLL +
    z-loss + 0.01 moe_aux), moe_aux and every gradient (routers and experts
    included) to 1e-4."""
    cfg, tcfg, jparams = _model(arch, seed=7)
    batch = _filled(SyntheticPackedDataset(cfg, 64, 2, seed=5, mu=3.2, sigma=0.8).batch_at(0))
    (jl, jm), jg = jax.value_and_grad(j_loss_fn, argnums=1, has_aux=True)(
        cfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_POLICY, remat=False,
        compute_dtype=jnp.float32)
    params = _port(jparams)
    assert params["layers"][0]["ffn"]["w_gate"].shape == (4, 64, 64)
    total, m = loss_fn(tcfg, params, {k: t(v) for k, v in batch.items()},
                       compute_dtype=torch.float32)
    assert _no_near_ties and min(_no_near_ties) > GAP
    assert float(jm["moe_aux"]) > 0.5
    np.testing.assert_allclose(float(m["moe_aux"].detach()), float(jm["moe_aux"]), rtol=1e-4)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    leaves = tree_leaves(params)
    got = torch.autograd.grad(total, leaves)
    assert all(bool((g != 0).any()) for g in got)  # the routers' too
    _close(got, _leaves(jg), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_rows_match_the_jax_kernel_path(arch, monkeypatch, _no_near_ties):
    """Rows that end in padding, as packed: the port's logits on every
    position, moe_aux and loss against the JAX `forward_train` with its
    Pallas kernel (interpret mode), which, as the port, gives a padding row
    0 attention output (1e-4). Its jnp attention, which gives such a row the
    mean of V, routes the padding elsewhere: moe_aux moves, asserted."""
    cfg, tcfg, jparams = _model(arch, seed=6)
    batch = SyntheticPackedDataset(cfg, 64, 2, seed=5, mu=3.2, sigma=0.8).batch_at(0)
    assert (batch["segment_ids"] == 0).any()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jnp_aux = j_forward_train(cfg, jparams, jb, NULL_POLICY, remat=False,
                                 compute_dtype=jnp.float32)
    default_md = j_model._default_md
    monkeypatch.setattr(j_model, "_default_md", lambda *a: {
        **default_md(*a), "use_pallas_kernel": True, "kernel_block_q": 32,
        "kernel_block_k": 32})
    (jl, jm) = j_loss_fn(cfg, jparams, jb, NULL_POLICY, remat=False, compute_dtype=jnp.float32)
    jlogits, _ = j_forward_train(cfg, jparams, jb, NULL_POLICY, remat=False,
                                 compute_dtype=jnp.float32)
    params = _port(jparams)
    tb = {k: t(v) for k, v in batch.items()}
    total, m = loss_fn(tcfg, params, tb, compute_dtype=torch.float32)
    logits, _ = forward_train(tcfg, params, tb, compute_dtype=torch.float32)
    assert min(_no_near_ties) > GAP
    np.testing.assert_allclose(n(logits), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(m["moe_aux"].detach()), float(jm["moe_aux"]), rtol=1e-4)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    assert abs(float(jnp_aux["moe_aux"]) - float(jm["moe_aux"])) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_jax(arch, monkeypatch, _no_near_ties):
    """One step of the JAX `build_train_step` (2 micro-batches, remat, clip
    0.05, which binds) and of the port's, each with an optimizer that keeps
    the gradients it is handed: every clipped, micro-batch-averaged
    gradient to 1e-4 of its leaf's max; loss and grad norm to 1e-4."""
    cfg, tcfg, jparams = _model(arch, seed=4)

    def fp32_loss(cfg, params, batch, policy, **kw):
        return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)

    monkeypatch.setattr(j_train_step, "loss_fn", fp32_loss)
    jkeep = JOptimizer("keep", lambda p: {}, lambda g, s, p, step: (g, s), 0.0)
    jstep = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jkeep, microbatches=2,
                                                  clip_norm=0.05))
    batch = _filled(SyntheticPackedDataset(cfg, 64, 4, seed=6, mu=3.2, sigma=0.8).batch_at(0))
    jstate, jm = jstep({"params": jparams, "opt": {}, "step": jnp.zeros((), jnp.int32)},
                       {k: jnp.asarray(v) for k, v in batch.items()})
    kept = {}

    def keep(grads, state, params, step):
        kept["g"] = grads
        return params, state

    tkeep = Optimizer("keep", lambda p, period=None: {}, keep, 0.0)
    params = _port(jparams)
    tstep = build_train_step(tcfg, tkeep, microbatches=2, clip_norm=0.05,
                             compute_dtype=torch.float32)
    _, tm = tstep({"params": params, "opt": {}, "step": torch.zeros((), dtype=torch.int32)},
                  {k: t(v) for k, v in batch.items()})
    assert min(_no_near_ties) > GAP
    assert float(jm["grad_norm"]) > 0.05
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close(tree_leaves(kept["g"]), _leaves(jstate["params"]), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch, _no_near_ties):
    """8 greedy steps from an empty cache (T = B = 2, capacity 2: nothing is
    dropped): every step's logits against JAX `serve_forward` fed the same
    token (2e-4), and the greedy token wherever JAX's top two differ by
    more than 1e-4."""
    cfg, tcfg, jparams = _model(arch, seed=5)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32,
                             device="cpu")
    B, max_len = 2, 16
    j_cache = j_init_cache(cfg, B, max_len, cache_dtype=jnp.float32)
    t_cache = init_cache(tcfg, B, max_len, cache_dtype=torch.float32, device="cpu")
    j_step = jax.jit(lambda p, c, b: j_serve_forward(cfg, p, c, b, NULL_POLICY,
                                                     compute_dtype=jnp.float32))
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    tok = t(np.random.default_rng(6).integers(1, cfg.vocab_size, size=B).astype(np.int32))
    for step in range(8):
        lengths = np.full((B,), step, np.int32)
        j_logits, j_cache = j_step(jparams, j_cache, {
            "tokens": jnp.asarray(n(tok)[:, None].astype(np.int32)),
            "lengths": jnp.asarray(lengths)})
        tok, t_logits, t_cache = serve(params, t_cache, {"tokens": tok[:, None],
                                                         "lengths": t(lengths)})
        jl = np.asarray(j_logits)[:, -1]
        np.testing.assert_allclose(n(t_logits)[:, -1], jl, atol=2e-4, rtol=2e-4)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(n(tok)[clear], jl.argmax(-1)[clear])
    assert min(_no_near_ties) > GAP


def test_spmd_adafactor_train_steps_match_jax(monkeypatch, _no_near_ties):
    """Reduced qwen3-moe at 4 layers (stacks of 4, experts stacked to 4
    axes), 2 steps of the JAX `build_train_step` on its `stacked_init` state
    and of the port's on `init_train_state`'s layout (`init(params,
    period)`), Adafactor: losses to 1e-4, then every parameter (1e-5) and
    every stacked `vr`/`vc` (1e-4 of its leaf's max) against the
    reference's."""
    from repro.train.optimizer import make_optimizer as j_make_optimizer
    from repro_torch.bridge import opt_state_from_jax
    from repro_torch.train.optimizer import make_optimizer

    cfg, tcfg = _models("qwen3-moe-30b-a3b", n_layers=4)
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(8), cfg))

    def fp32_loss(cfg, params, batch, policy, **kw):
        return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)

    monkeypatch.setattr(j_train_step, "loss_fn", fp32_loss)
    jopt, topt = j_make_optimizer("adafactor", lr=1e-3), make_optimizer("adafactor", lr=1e-3)
    jstep = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jopt, microbatches=2))
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    params = _port(jparams)
    tstate = {"params": params, "opt": topt.init(params, period=len(tcfg.period)),
              "step": torch.zeros((), dtype=torch.int32)}
    assert isinstance(tstate["opt"]["v"]["layers"], tuple)
    tstep = build_train_step(tcfg, topt, microbatches=2, compute_dtype=torch.float32)
    for i in range(2):
        batch = _filled(SyntheticPackedDataset(cfg, 64, 4, seed=8, mu=3.2,
                                               sigma=0.8).batch_at(i))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert min(_no_near_ties) > GAP
    for a, b in zip(tree_leaves(tstate["params"]), _leaves(jstate["params"])):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=1e-5)
    stats = opt_state_from_jax(jax.tree.map(np.asarray, jstate["opt"]), device="cpu")["v"]
    assert isinstance(stats["layers"], tuple)
    _close(_sorted_leaves(tstate["opt"]["v"]), _sorted_leaves(stats), 1e-4)


def _sorted_leaves(tree):
    """Leaves with dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _sorted_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]
