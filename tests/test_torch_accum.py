"""`build_train_step(accum_dtype=torch.bfloat16)` against the JAX
`build_train_step(accum_dtype=jnp.bfloat16)`, the reference's accumulation
above 5e10 parameters, on the parity model (reduced qwen3-8b) at fp32
compute with 2 and 4 micro-batches, weights through `bridge.params_from_jax`:
one AdamW step's loss, grad norm, gradients (the reference's own order:
each micro-batch's fp32 gradient rounded to bf16 and summed in bf16, the
sum divided in bf16, then fp32) and parameters; the same step's gradients
against fp32 accumulation; the accumulation's hooks and the memory it
holds. The sharded (1, 2) case rides tests/test_torch_sharding.py's spawn.

The JAX train step computes in bf16; here it is made to compute in fp32 by
patching the `loss_fn` its module calls (the JAX package is not edited).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models.model import loss_fn as j_loss_fn, stacked_init
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro.train import train_step as j_train_step
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.train.optimizer import make_optimizer, tree_leaves
from repro_torch.train.train_step import build_train_step

S, LR = 128, 1e-3


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_arch("qwen3-8b"))
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(2), cfg))
    return cfg, t_reduced(t_get_arch("qwen3-8b")), params


@pytest.fixture(scope="module")
def grad_fn(model):
    """The fp32 gradient of one micro-batch's loss, compiled once for every case."""
    cfg = model[0]
    return jax.jit(jax.grad(lambda p, mb: _fp32_loss(cfg, p, mb, NULL_POLICY)[0]))


def _batch(cfg, B):
    return SyntheticPackedDataset(cfg, S, B, seed=11, mu=3.6, sigma=0.8).batch_at(0)


def _fp32_loss(cfg, params, batch, policy, **kw):
    return j_loss_fn(cfg, params, batch, policy, compute_dtype=jnp.float32, **kw)


def _port_state(jparams, opt):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32,
                             device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}


def _port_leaves_of(jtree):
    """A JAX tree in the scan layout -> the port's leaves, in the port's order."""
    return tree_leaves(params_from_jax(jax.tree.map(np.asarray, jtree), dtype=torch.float32,
                                       device="cpu"))


def _reference_grads(grad_fn, jparams, batch, microbatches):
    """The reference step's accumulated gradient, before clipping, by its
    own order (`repro.train.train_step.build_train_step`'s `accum`): fp32
    gradients of each micro-batch's loss (`grad_fn`), each rounded to bf16
    and added into bf16 zeros, the sum divided by the count in bf16, then
    fp32."""
    n = next(iter(batch.values())).shape[0] // microbatches
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16), jparams)
    for i in range(microbatches):
        g = grad_fn(jparams, {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batch.items()})
        acc = jax.tree.map(lambda a, x: a + x.astype(jnp.bfloat16), acc, g)
    return jax.tree.map(lambda a: (a / microbatches).astype(jnp.float32), acc)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_bf16_accumulation_matches_reference(model, grad_fn, monkeypatch, microbatches):
    """One AdamW step, bf16 accumulation, fp32 compute: loss to 1e-4
    relative; grad norm to 1e-2 relative; every clipped gradient within
    1e-2 of its leaf's max abs of the reference's (two bf16 roundings
    apart where the fp32 gradients round to neighbouring bf16 values) and
    of the port's fp32-accumulated step; the parameters as
    tests/test_torch_train.py holds the fp32 step's (1e-5 relative plus
    1e-3 * lr, but for elements whose gradient is within 1e-4 of its
    leaf's max from 0 or whose bf16 sums rounded apart, at most 0.3% in
    all, held to 2 * lr: AdamW's first update is about lr * sign(g))."""
    cfg, tcfg, jparams = model
    monkeypatch.setattr(j_train_step, "loss_fn", _fp32_loss)
    batch = _batch(cfg, 2 * microbatches)
    jopt = j_make_optimizer("adamw", lr=LR)
    jstep = jax.jit(j_train_step.build_train_step(cfg, NULL_POLICY, jopt,
                                                  microbatches=microbatches,
                                                  accum_dtype=jnp.bfloat16))
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        opt = make_optimizer("adamw", lr=LR)
        state = _port_state(jparams, opt)
        step = build_train_step(tcfg, opt, microbatches=microbatches, compute_dtype=torch.float32,
                                accum_dtype=dtype)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got[dtype] = (state, m, [p.grad.clone() for p in tree_leaves(state["params"])])
    state, tm, grads = got[torch.bfloat16]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-2)
    assert float(tm["ntokens"]) == float(jm["ntokens"])
    scale = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    want = [g * scale for g in _port_leaves_of(_reference_grads(grad_fn, jparams, batch,
                                                                microbatches))]
    fp32 = got[torch.float32][2]
    assert len(grads) == len(want) == len(fp32)
    for i, (g, w, f) in enumerate(zip(grads, want, fp32)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max()) + 1e-12, i
        assert float((g - f).abs().max()) <= 1e-2 * float(f.abs().max()) + 1e-12, i
    # exempt as in tests/test_torch_train.py: gradients within 1e-4 of the
    # leaf's max from 0; and where the two bf16 sums rounded apart (beyond
    # the fp32 parity's 1e-4 relative; the reference's may cancel to 0)
    noisy = [((w != 0) & (w.abs() <= 1e-4 * w.abs().max())) | ((g - w).abs() > 1e-4 * w.abs())
             for g, w in zip(grads, want)]
    assert sum(int(m.sum()) for m in noisy) <= 3e-3 * sum(m.numel() for m in noisy)
    for mask, a, b in zip(noisy, tree_leaves(state["params"]),
                          _port_leaves_of(jstate["params"])):
        diff = (a.detach() - b).abs()
        assert bool((diff[~mask] <= 1e-5 * b.abs()[~mask] + 1e-3 * LR).all())
        assert bool((diff[mask] <= 2 * LR).all())


def test_bf16_accumulation_holds_no_fp32_gradient_between_micro_batches(model):
    """During the backward a leaf's fp32 gradient lives only until its
    hook has added it into the bf16 sum: at every hook call no other
    leaf holds a `.grad`; the hooks are gone after the step, which leaves
    fp32 `.grad` on every leaf; a float32 step registers none."""
    cfg, tcfg, jparams = model
    opt = make_optimizer("adamw", lr=LR)
    state = _port_state(jparams, opt)
    leaves = tree_leaves(state["params"])
    seen = []
    probes = [p.register_post_accumulate_grad_hook(
        lambda p: seen.append(sum(q.grad is not None for q in leaves))) for p in leaves]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4).items()}
    try:
        step = build_train_step(tcfg, opt, microbatches=2, compute_dtype=torch.float32,
                                accum_dtype=torch.bfloat16)
        state, _ = step(state, batch)
        assert len(seen) == 2 * len(leaves) and max(seen) == 1
        assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in leaves)
        assert all(not p._post_accumulate_grad_hooks or len(p._post_accumulate_grad_hooks) == 1
                   for p in leaves)
    finally:
        for h in probes:
            h.remove()
