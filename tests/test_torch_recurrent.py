"""The recurrent mixers and the two families that use them against the JAX
package, on the CPU.

Mixers at reduced widths (inputs from a numpy seed, weights from the JAX
init carried over by `bridge`, float32 compute), each to 1e-4 of the
reference's largest |value|:
  * `causal_conv1d` with taps cut at document starts;
  * `mamba`, `mlstm` (chunk 16 over 48 positions: 3 chunks, documents that
    start mid-chunk and cross chunk ends, padding at a row's end) and
    `slstm`: outputs, the states `collect_state` gives, one decode step
    from those states, and every gradient of a scalar of the output.
Reduced xlstm-1.3b (16 layers: 14 mLSTM, 2 sLSTM, no FFN) and reduced
jamba-1.5-large-398b (16 layers: Mamba with MoE and dense FFNs, attention at
period position 3), weights from one JAX `stacked_init`:
  * `forward_train` logits, `loss_fn` and every gradient (1e-4);
  * prefill, its caches against the bridged JAX caches, `extend_cache` and
    4 greedy `serve_forward` steps against the JAX step (2e-4, the same
    tokens);
  * one `build_train_step` step of 2 micro-batches against the JAX train
    step: AdamW for xlstm, the full jamba config's Adafactor (bf16
    momentum over stacks) for jamba.
jamba's batches fill each row's padding with a document (the JAX jnp
attention gives a padding row the mean of V where the port gives 0, and
padding takes MoE capacity), and every MoE case asserts its routers see no
near-tie (`test_torch_moe.py`). The witness
`test_jax_mlstm_decode_drops_the_conv_window` holds a reference behaviour
the port keeps: its mLSTM decode step runs the causal conv over the new
token alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models import layers as j_layers
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
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
from repro.train.optimizer import optimizer_for as j_optimizer_for
from repro_torch import configs as t_configs
from repro_torch.bridge import cache_from_jax, opt_state_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import layers, moe, ssm, xlstm
from repro_torch.models.layers import FP32_PARAMS
from repro_torch.models.model import (
    extend_cache,
    forward_train,
    init_cache,
    init_params,
    loss_fn,
)
from repro_torch.train.optimizer import optimizer_for, tree_leaves
from repro_torch.train.train_step import build_prefill_step, build_serve_step, build_train_step

from torch_helpers import n, t

ARCHS = ["xlstm-1.3b", "jamba-1.5-large-398b"]
B, S, CHUNK = 2, 48, 16       # the mixer cases: 3 mLSTM chunks
TOL = 1e-4                     # float32, of the reference's largest |value|
GAP = 1e-5                     # least gap between a router's k-th and (k+1)-th probability
LR = 1e-3


def _close(got, want, tol=TOL):
    got, want = n(got) if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()) + 1e-7


def _segments():
    """(B, S) packed ids: row 0 documents [0,10) [10,35) [35,44) then
    padding; row 1 [0,20) [20,48). Documents start mid-chunk (10, 20, 35)
    and cross chunk ends (16, 32)."""
    seg = np.zeros((B, S), np.int32)
    for b, cuts in enumerate(((0, 10, 35, 44), (0, 20, 48))):
        for i, (a, e) in enumerate(zip(cuts, cuts[1:])):
            seg[b, a:e] = i + 1
    return seg


def _mixer(arch, name):
    cfg = reduced(get_arch(arch))
    spec = next(s for s in cfg.period if s.mixer == name)
    init = {"mamba": j_ssm.init_mamba, "mlstm": j_xlstm.init_mlstm,
            "slstm": j_xlstm.init_slstm}[name]
    jp, _ = split_annotations(init(jax.random.PRNGKey(11), cfg))
    tp = params_from_jax({"layers": [jax.tree.map(np.asarray, jp)]}, dtype=torch.float32,
                         device="cpu")["layers"][0]
    return cfg, t_reduced(t_get_arch(arch)), spec, jp, tp


MIXERS = [("jamba-1.5-large-398b", "mamba"), ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm")]
J_FN = {"mamba": j_ssm.mamba, "mlstm": j_xlstm.mlstm, "slstm": j_xlstm.slstm}
T_FN = {"mamba": ssm.mamba, "mlstm": xlstm.mlstm, "slstm": xlstm.slstm}


def _kw(name):
    return {"chunk": CHUNK} if name == "mlstm" else {}


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    mine, ref = t_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()


def test_every_assigned_arch_is_registered_and_pinned():
    assert t_configs.ASSIGNED_ARCHS == ASSIGNED_ARCHS and len(ASSIGNED_ARCHS) == 10
    for arch in ASSIGNED_ARCHS:
        assert dataclasses.asdict(t_get_arch(arch)) == dataclasses.asdict(get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_count_keys_and_dtypes(arch):
    """`init_params` holds the reference's keys and as many parameters as
    its init: `param_count()` less a `norm2` of d_model for each layer
    without an FFN, which the reference's count adds and its init does not
    build, and plus a Mamba layer's `conv_b` and `dt_bias` (2 d_inner),
    which its count leaves out; in bf16 its leaves take the dtypes `bridge.params_from_jax`
    gives the JAX init's: matrices bf16, one-axis weights and A_log, r_g
    and b_g float32 (`layers.FP32_PARAMS`), which the reference uses in
    float32 arithmetic only."""
    cfg, tcfg = reduced(get_arch(arch)), t_reduced(t_get_arch(arch))
    mine = init_params(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    jp, _ = split_annotations(stacked_init(jax.random.PRNGKey(0), cfg))
    no_ffn = sum(spec.ffn == "none" for spec in tcfg.layer_specs())
    n_mamba = sum(spec.mixer == "mamba" for spec in tcfg.layer_specs())
    assert (no_ffn, n_mamba) == ((16, 0) if arch.startswith("xlstm") else (0, 14))
    assert (sum(x.numel() for x in tree_leaves(mine)) == sum(x.size for x in jax.tree.leaves(jp))
            == tcfg.param_count() - no_ffn * tcfg.d_model + n_mamba * 2 * tcfg.mamba_d_inner)
    bridged = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16, device="cpu")
    assert len(mine["layers"]) == len(bridged["layers"]) == cfg.n_layers

    def walk(a, b, key=None):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                yield from walk(a[k], b[k], k)
        elif isinstance(a, list):
            for x, y in zip(a, b, strict=True):
                yield from walk(x, y, key)
        else:
            yield key, a, b
    seen = set()
    for key, a, b in walk(mine, bridged):
        assert a.shape == b.shape and a.dtype == b.dtype, key
        want = torch.float32 if a.dim() < 2 or key in FP32_PARAMS else torch.bfloat16
        assert a.dtype == want, key
        seen.add(key)
    assert FP32_PARAMS & seen == ({"A_log"} if arch.startswith("jamba") else {"r_g", "b_g"})


def test_bridge_keeps_the_float32_parameters_exact():
    """A_log = log(1..N) and b_g's forget row 3.0 reach the port unrounded:
    in bf16 log(3) would read 1.1015625 against 1.0986123."""
    for arch, name, key in (("jamba-1.5-large-398b", "mamba", "A_log"),
                            ("xlstm-1.3b", "slstm", "b_g"), ("xlstm-1.3b", "slstm", "r_g")):
        cfg, _, _, jp, _ = _mixer(arch, name)
        tp = params_from_jax({"layers": [jax.tree.map(np.asarray, jp)]}, dtype=torch.bfloat16,
                             device="cpu")["layers"][0]
        assert tp[key].dtype == torch.float32
        np.testing.assert_array_equal(n(tp[key]), np.asarray(jp[key], np.float32))
    assert tp["w_g"].dtype == torch.bfloat16


# ------------------------------------------------------------------ mixers
def test_causal_conv1d_matches_jax(rng):
    x = rng.standard_normal((B, S, 24), dtype=np.float32)
    w = rng.standard_normal((24, 4), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    seg = _segments()
    for ids in (seg, None):
        want = j_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      None if ids is None else jnp.asarray(ids))
        got = layers.causal_conv1d(t(x), t(w), t(b), None if ids is None else t(ids))
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    # a document's first position sees no tap of the one before it
    got = layers.causal_conv1d(t(x), t(w), t(np.zeros(24, np.float32)), t(seg))
    np.testing.assert_allclose(n(got)[0, 10], x[0, 10] * w[:, -1], rtol=1e-6)


@pytest.mark.parametrize("arch,name", MIXERS)
def test_mixer_matches_jax(arch, name, rng):
    """Output, the collected state, one decode step from it and every
    gradient of sum(out * R), against the reference's mixer."""
    cfg, tcfg, spec, jp, tp = _mixer(arch, name)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    r = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    seg = _segments()
    jmd = {"segment_ids": jnp.asarray(seg), "collect_state": True}
    want, jstate = J_FN[name](cfg, spec, jp, jnp.asarray(x), jmd, NULL_POLICY, **_kw(name))
    leaves = tree_leaves(tp)
    tx = t(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got, tstate = T_FN[name](tcfg, spec, tp, tx, {"segment_ids": t(seg), "collect_state": True},
                             **_kw(name))
    _close(got, want)
    assert sorted(tstate) == sorted(jstate)
    for key in jstate:
        _close(tstate[key], jstate[key])

    # every gradient of a scalar of the output
    def jscalar(p, x):
        out, _ = J_FN[name](cfg, spec, p, x, {"segment_ids": jnp.asarray(seg)}, NULL_POLICY,
                            **_kw(name))
        return jnp.sum(out * jnp.asarray(r))
    jgp, jgx = jax.grad(jscalar, argnums=(0, 1))(jp, jnp.asarray(x))
    out, _ = T_FN[name](tcfg, spec, tp, tx, {"segment_ids": t(seg)}, **_kw(name))
    grads = torch.autograd.grad((out * t(r)).sum(), [tx] + leaves)
    _close(grads[0], jgx)
    jleaves = tree_leaves(params_from_jax({"layers": [jax.tree.map(np.asarray, jgp)]},
                                          dtype=torch.float32, device="cpu")["layers"][0])
    for g, w in zip(grads[1:], jleaves, strict=True):
        _close(g, n(w))

    # one decode step from the collected state
    tok = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    jout, jnext = J_FN[name](cfg, spec, jp, jnp.asarray(tok), {"segment_ids": jnp.ones((B, 1))},
                             NULL_POLICY, cache=jstate)
    with torch.no_grad():
        tcache = {k: v.detach() for k, v in tstate.items()}
        tout, tnext = T_FN[name](tcfg, spec, tp, t(tok), {"segment_ids": torch.ones((B, 1))},
                                 cache=tcache)
    _close(tout, jout)
    for key in jnext:
        _close(tnext[key], jnext[key])


def test_mamba_scan_blocks_do_not_change_the_numbers(monkeypatch, rng):
    """The hoisted terms go to the loop in blocks of positions; a block of
    5 positions (10 blocks over 48) gives the same bits as one block."""
    _, tcfg, spec, _, tp = _mixer("jamba-1.5-large-398b", "mamba")
    x = t(rng.standard_normal((B, S, tcfg.d_model), dtype=np.float32))
    md = {"segment_ids": t(_segments()), "collect_state": True}
    with torch.no_grad():
        one, state = ssm.mamba(tcfg, spec, tp, x, md)
        monkeypatch.setattr(ssm, "SCAN_BLOCK_ELEMENTS", 5 * B * tcfg.mamba_d_inner
                            * tcfg.mamba_d_state)
        blocked, bstate = ssm.mamba(tcfg, spec, tp, x, md)
    assert torch.equal(one, blocked) and torch.equal(state["ssm"], bstate["ssm"])


def test_mlstm_needs_whole_chunks():
    cfg, tcfg, spec, _, tp = _mixer("xlstm-1.3b", "mlstm")
    with pytest.raises(AssertionError):
        xlstm.mlstm(tcfg, spec, tp, torch.zeros((1, 40, tcfg.d_model)), {}, chunk=16)


# ------------------------------------------------------------- the models
def _gap(probs, k):
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


@pytest.fixture
def gaps(monkeypatch):
    """The least top-k gap of every router call of the port."""
    found, route = [], moe.route

    def checked(cfg, router, xt):
        probs = torch.softmax(xt.detach().float() @ router.detach().float(), dim=-1)
        found.append(_gap(n(probs), cfg.moe_top_k))
        return route(cfg, router, xt)

    monkeypatch.setattr(moe, "route", checked)
    return found


def _no_near_tie(gaps):
    assert not gaps or min(gaps) > GAP


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg, tcfg = reduced(get_arch(request.param)), t_reduced(t_get_arch(request.param))
    assert cfg.n_layers == 16
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(7), cfg))
    return cfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(cfg, Bt=2, index=0):
    """Packed rows of 64 positions; jamba's padding made one more document
    (labels -1)."""
    batch = SyntheticPackedDataset(cfg, 64, Bt, seed=5, mu=3.2, sigma=0.8).batch_at(index)
    if cfg.n_experts:
        seg, pos = batch["segment_ids"], batch["positions"]
        for b in range(Bt):
            pad = seg[b] == 0
            seg[b, pad] = seg[b].max() + 1
            pos[b, pad] = np.arange(int(pad.sum()))
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: t(v) for k, v in batch.items()}


def test_logits_loss_and_every_gradient_match_jax(family, gaps):
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
    np.testing.assert_allclose(float(m["moe_aux"].detach()), float(jm["moe_aux"]), rtol=1e-4,
                               atol=1e-7)
    got = torch.autograd.grad(total, leaves)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), dtype=torch.float32,
                                       device="cpu"))
    assert len(got) == len(want) == len(leaves)
    for a, b in zip(got, want):
        _close(a, n(b))
    with torch.no_grad():
        logits, _ = forward_train(tcfg, params, _torch(batch), compute_dtype=torch.float32)
    ref, _ = j_forward_train(cfg, jparams, _jax(batch), NULL_POLICY, remat=False,
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(n(logits), np.asarray(ref), atol=1e-4, rtol=1e-4)
    _no_near_tie(gaps)


def _prompt(cfg, P=32):
    """One document a row; seed 11 (seed 9 gave a jamba decode step a router
    gap of 4.5e-6, a near-tie)."""
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(1, cfg.vocab_size, size=(B, P)).astype(np.int32),
            "segment_ids": np.ones((B, P), np.int32),
            "positions": np.tile(np.arange(P, dtype=np.int32), (B, 1))}


def _jax_decode_cache(cfg, prefill_caches, max_len):
    """The reference's decode cache from its prefill's: attention K/V moved
    into max_len slots, recurrent states as they are."""
    empty = j_init_cache(cfg, B, max_len, cache_dtype=jnp.float32)
    return tuple(jax.tree.map(lambda c, p: c.at[:, :, :p.shape[2]].set(p), e, pc)
                 if cfg.period[pos].mixer == "attn" else pc
                 for pos, (e, pc) in enumerate(zip(empty, prefill_caches)))


def test_prefill_then_greedy_decode_match(family, gaps):
    """Prefill's last logits and every layer's cache (bridged from JAX by
    `cache_from_jax`), `extend_cache` (recurrent states carried over), then
    4 greedy steps against the JAX `serve_forward`, fed the same tokens."""
    cfg, tcfg, jparams, tree = family
    prompt, P = _prompt(cfg), 32
    tparams = params_from_jax(tree, dtype=torch.float32, device="cpu")
    j_last, j_caches = j_prefill_forward(cfg, jparams, _jax(prompt), NULL_POLICY,
                                         compute_dtype=jnp.float32)
    t_last, t_caches = build_prefill_step(tcfg, compute_dtype=torch.float32)(tparams,
                                                                             _torch(prompt))
    np.testing.assert_allclose(n(t_last), np.asarray(j_last), atol=2e-4, rtol=2e-4)
    ported = cache_from_jax(jax.tree.map(np.asarray, j_caches), device="cpu")
    assert len(ported) == len(t_caches) == cfg.n_layers
    for i, (mine, theirs) in enumerate(zip(t_caches, ported)):
        assert sorted(mine["mixer"]) == sorted(theirs["mixer"]), i
        for name, x in mine["mixer"].items():
            np.testing.assert_allclose(n(x), n(theirs["mixer"][name]), atol=2e-4, rtol=2e-4)

    max_len = P + 8
    j_cache = _jax_decode_cache(cfg, j_caches, max_len)
    t_cache = extend_cache(tcfg, t_caches, max_len)
    for i, (a, b) in enumerate(zip(t_cache, t_caches)):
        if tcfg.layer_spec(i).mixer != "attn":  # carried over, not copied
            assert all(a["mixer"][k] is b["mixer"][k] for k in b["mixer"])
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    j_tok = jnp.argmax(j_last[:, -1], axis=-1).astype(jnp.int32)
    t_tok = t_last[:, -1].argmax(-1).to(torch.int32)
    for step in range(4):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        lengths = np.full((B,), P + step, np.int32)
        j_logits, j_cache = j_serve_forward(
            cfg, jparams, j_cache, {"tokens": j_tok[:, None], "lengths": jnp.asarray(lengths)},
            NULL_POLICY, compute_dtype=jnp.float32)
        t_tok, t_logits, t_cache = serve(tparams, t_cache, {"tokens": t_tok[:, None],
                                                            "lengths": t(lengths)})
        np.testing.assert_allclose(n(t_logits), np.asarray(j_logits), atol=2e-4, rtol=2e-4)
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1).astype(jnp.int32)
    _no_near_tie(gaps)


def test_decode_from_an_empty_cache_matches_jax(family, gaps):
    """init_cache (Mamba's float32 conv window, as the reference's default)
    and 3 steps from it with bf16 weights and compute, as the reference's
    smoke sweep decodes (the float32 window promotes Mamba's small products
    to float32), against the JAX step: the same leaves, logits to the bf16
    decode tolerance of `chip_smoke.py` (5e-2 of the largest)."""
    cfg, tcfg, jparams, tree = family
    j_bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                          jparams)
    tparams = params_from_jax(tree, dtype=torch.bfloat16, device="cpu")
    j_cache = j_init_cache(cfg, B, 16)
    t_cache = init_cache(tcfg, B, 16, device="cpu")
    ported = cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    for mine, theirs in zip(t_cache, ported, strict=True):
        for k, x in mine["mixer"].items():
            assert x.shape == theirs["mixer"][k].shape and x.dtype == theirs["mixer"][k].dtype
    tok = np.array([[3], [5]], np.int32)
    for step in range(3):
        lengths = np.full((B,), step, np.int32)
        jl, j_cache = j_serve_forward(cfg, j_bf16, j_cache, {"tokens": jnp.asarray(tok),
                                                             "lengths": jnp.asarray(lengths)},
                                      NULL_POLICY)
        with torch.no_grad():
            _, tl, t_cache = build_serve_step(tcfg)(tparams, t_cache,
                                                    {"tokens": t(tok), "lengths": t(lengths)})
        _close(tl.float(), np.asarray(jl, np.float32), 5e-2)
    _no_near_tie(gaps)


def _noisy(grads):
    return [(g != 0) & (g.abs() <= 1e-4 * g.abs().max()) for g in grads]


def _sorted_leaves(tree):
    """Leaves with dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _sorted_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _flushed(vr, vc):
    """Whether any vr_i * vc_j of a factored statistic lies below float32's
    smallest normal number, which XLA on the CPU flushes to 0."""
    prod = n(vr).astype(np.float64)[..., :, None] * n(vc).astype(np.float64)[..., None, :]
    return bool((prod < np.finfo(np.float32).tiny).any())


def test_train_step_matches_reference(family, monkeypatch, gaps):
    """One step of 2 micro-batches against the JAX train step (float32
    compute), each with the optimizer `optimizer_for` gives the full
    config: AdamW for xlstm-1.3b, Adafactor with bf16 momentum (the spmd
    stacks) for jamba: loss and grad norm (1e-4), every parameter (1e-5
    relative plus 1e-3 lr, plus lr times one bf16 step of the leaf's
    largest momentum where the momentum is bf16; elements whose gradient is
    within 1e-4 of its leaf's max of 0 but not 0 to 2 lr, at most 0.3% of
    them); with
    Adafactor every stacked statistic (1e-4 of its leaf's max). A stack
    whose factored product vr_i·vc_j underflows float32 takes another
    update in the reference, whose XLA flushes it to 0
    (`test_jax_adafactor_flushes_a_tiny_factored_product`): its parameters
    are held by the statistics alone (in jamba's step: dt_proj and A_log
    of a few Mamba stacks, whose gradients are ~1e-9)."""
    cfg, tcfg, jparams, tree = family

    def fp32_loss(cfg, params, batch, policy, **kw):
        return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)

    monkeypatch.setattr(j_train_step, "loss_fn", fp32_loss)
    jopt = j_optimizer_for(get_arch(cfg.arch_id.removesuffix("-reduced")), lr=LR)
    topt = optimizer_for(t_get_arch(tcfg.arch_id.removesuffix("-reduced")), lr=LR)
    assert topt.name == jopt.name == ("adafactor" if cfg.n_experts else "adamw")
    batch = _batch(cfg, Bt=4, index=1)
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jopt, microbatches=2))(
        jstate, _jax(batch))
    params = params_from_jax(tree, dtype=torch.float32, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tstate = {"params": params, "opt": topt.init(params, period=len(tcfg.period)),
              "step": torch.zeros((), dtype=torch.int32)}
    tstate, tm = build_train_step(tcfg, topt, microbatches=2, compute_dtype=torch.float32)(
        tstate, _torch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    host = jax.tree.map(np.asarray, jstate)
    flushed = set()
    if topt.name == "adafactor":  # the statistics, stacked on both sides
        theirs = opt_state_from_jax(host["opt"], device="cpu")["v"]["layers"]
        for pos, (mine, ref) in enumerate(zip(tstate["opt"]["v"]["layers"], theirs,
                                              strict=True)):
            for part in ("mixer", "ffn"):
                for key, v in ref.get(part, {}).items():
                    if "vr" in v and _flushed(v["vr"], v["vc"]):
                        flushed |= {(i, part, key)
                                    for i in range(pos, cfg.n_layers, len(cfg.period))}
            for a, b in zip(_sorted_leaves(mine), _sorted_leaves(ref), strict=True):
                _close(a, n(b))
        assert len(flushed) <= 16, flushed
    want = params_from_jax(host["params"], dtype=torch.float32, device="cpu")
    for i, part, key in flushed:
        for tree in (tstate["params"], tstate["opt"]["m"], want):
            del tree["layers"][i][part][key]
    noisy = _noisy([p.grad for p in tree_leaves(tstate["params"])])
    assert sum(int(m.sum()) for m in noisy) <= 3e-3 * sum(m.numel() for m in noisy)
    for mask, a, b, m in zip(noisy, tree_leaves(tstate["params"]), tree_leaves(want),
                             tree_leaves(tstate["opt"]["m"]), strict=True):
        # a bf16 momentum may round to the neighbouring value: lr times one
        # bf16 step of the leaf's largest momentum (`test_torch_train.py`)
        step = LR * float(m.float().abs().max()) * 2.0 ** -8 if m.dtype == torch.bfloat16 else 0
        diff = (a.detach() - b).abs()
        assert bool((diff[~mask] <= 1e-5 * b.abs()[~mask] + 1e-3 * LR + step).all())
        assert bool((diff[mask] <= 2 * LR).all())
    _no_near_tie(gaps)


def test_jax_adafactor_flushes_a_tiny_factored_product():
    """XLA on the CPU flushes float32 subnormals to 0, so where a factored
    leaf's gradients are ~1e-9 the reference's vr_i·vc_j (~1e-38) becomes
    0, its vhat 1e-30 and its update the clipped spike of g / 1e-15; the
    port keeps the subnormal, and its update stays within 1e-3 of the one
    the same leaf takes at a normal scale. The same leaf with
    gradients 1e6 times larger takes one update on both sides."""
    from repro.train.optimizer import make_optimizer as j_make_optimizer
    from repro_torch.train.optimizer import make_optimizer

    rng = np.random.default_rng(0)
    # |g| 1e-11 to 1e-9 by column: g^2 far above Adafactor's 1e-30, but the
    # products vr_i * vc_j of the small columns (1e-41 and up) under
    # float32's least normal, 1.2e-38, where a subnormal keeps 3-4 digits
    g = (np.sign(rng.standard_normal((4, 32))) * rng.uniform(1, 2, (4, 32))
         * np.logspace(-11, -9, 32)).astype(np.float32)
    p = np.zeros((4, 32), np.float32)  # the update is the new parameter, no rounding of p + u
    updates = []
    for scale in (1.0, 1e6):
        gs = (g * np.float32(scale)).astype(np.float32)
        jopt, topt = j_make_optimizer("adafactor", lr=LR), make_optimizer("adafactor", lr=LR)
        jp, _ = jopt.update({"w": jnp.asarray(gs)}, jopt.init({"w": jnp.asarray(p)}),
                            {"w": jnp.asarray(p)}, jnp.zeros((), jnp.int32))
        tp = {"w": t(p)}
        topt.update({"w": t(gs)}, topt.init(tp), tp, torch.zeros((), dtype=torch.int32))
        updates.append((np.asarray(jp["w"]), n(tp["w"])))
        if scale == 1.0:
            vr, vc = (gs.astype(np.float64) ** 2).mean(-1), (gs.astype(np.float64) ** 2).mean(-2)
            assert (vr[:, None] * vc[None, :]).min() < np.finfo(np.float32).tiny
    (j_tiny, t_tiny), (j_big, t_big) = updates
    np.testing.assert_allclose(t_tiny, t_big, rtol=1e-3, atol=1e-9)  # the port: the subnormals' digits
    np.testing.assert_allclose(j_big, t_big, rtol=1e-4, atol=1e-9)
    assert np.abs(j_tiny - t_tiny).max() > 10 * np.abs(t_tiny).max() * 1e-2


# ------------------------------------------------- a reference behaviour
def _decode_against_forward(arch, **over):
    """Reduced `arch` in float32 (weights from one JAX init): a 16-token
    prompt's prefill, then 3 greedy steps of the reference and of the port.
    -> (largest |reference decode - reference packed forward at the same
    position| over the steps, largest |port decode - reference decode|)."""
    cfg = reduced(get_arch(arch), **over)
    tcfg = t_reduced(t_get_arch(arch), **over)
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(7), cfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32,
                              device="cpu")
    P, steps = 16, 3
    prompt = _prompt(cfg, P)
    _, j_caches = j_prefill_forward(cfg, jparams, _jax(prompt), NULL_POLICY,
                                    compute_dtype=jnp.float32)
    _, t_caches = build_prefill_step(tcfg, compute_dtype=torch.float32)(tparams, _torch(prompt))
    j_cache = _jax_decode_cache(cfg, j_caches, P + steps)
    t_cache = extend_cache(tcfg, t_caches, P + steps)
    fed = np.random.default_rng(3).integers(1, cfg.vocab_size, size=(B, steps)).astype(np.int32)
    tokens = np.concatenate([prompt["tokens"], fed], 1)
    full = {"tokens": tokens, "segment_ids": np.ones_like(tokens),
            "positions": np.tile(np.arange(P + steps, dtype=np.int32), (B, 1))}
    ref, _ = j_forward_train(cfg, jparams, _jax(full), NULL_POLICY, remat=False,
                             compute_dtype=jnp.float32)
    off_forward = off_reference = 0.0
    serve = build_serve_step(tcfg, compute_dtype=torch.float32)
    for s in range(steps):
        lengths = np.full((B,), P + s, np.int32)
        jl, j_cache = j_serve_forward(cfg, jparams, j_cache, {
            "tokens": jnp.asarray(fed[:, s:s + 1]), "lengths": jnp.asarray(lengths)},
            NULL_POLICY, compute_dtype=jnp.float32)
        _, tl, t_cache = serve(tparams, t_cache, {"tokens": t(fed[:, s:s + 1]),
                                                  "lengths": t(lengths)})
        jl = np.asarray(jl)[:, 0]
        off_forward = max(off_forward, float(np.abs(jl - np.asarray(ref)[:, P + s]).max()))
        off_reference = max(off_reference, float(np.abs(n(tl)[:, 0] - jl).max()))
    return off_forward, off_reference


def test_jax_mlstm_decode_drops_the_conv_window():
    """The reference's mLSTM decode step runs its causal conv over the new
    token alone (`src/repro/models/xlstm.py:79–81`, no conv state in
    `init_mlstm_cache`), so its xlstm decode leaves the packed forward by
    far more than rounding at the default xlstm_conv 4, and agrees with it
    at xlstm_conv 1, where the conv has no window to drop. The port
    matches the reference's decode either way."""
    off, port = _decode_against_forward("xlstm-1.3b")
    assert off > 0.1 and port <= 2e-4
    off, port = _decode_against_forward("xlstm-1.3b", xlstm_conv=1)
    assert off <= 2e-4 and port <= 2e-4
