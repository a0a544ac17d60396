"""Optimizers: AdamW and Adafactor(+momentum) (counterpart of `repro.train.optimizer`).

Plain functions on trees of tensors (nested dicts and lists, as the port's
parameters), with the reference's state keys: AdamW keeps `m` and `v`;
Adafactor keeps `m` (in `momentum_dtype`) and, per leaf, `v` or the factored
row and column statistics `vr` and `vc` of leaves with two or more axes.
`update` changes the parameters and the state in place (the reference
returns new trees) and returns both. Not `torch.optim`: its state layout and
its Adafactor differ from the reference's.

Adafactor's factoring and its RMS update clip act on a whole leaf, and the
reference's spmd state stacks the layers of each period position into one
leaf (`stacked_init`), while the port keeps one dict per layer. So
`init(params, period=P)` groups the layers the reference's way: Adafactor's
state `v["layers"]` is then a tuple over the P period positions of stacked
statistics (and an encoder-decoder's `v["enc_layers"]` a tuple of one stack),
as the reference's (a layer's (D,) norm weight factored as
(n, D) into `vr` (n,) and `vc` (D,); an (E, D, F) expert weight as
(n, E, D, F), over its last two axes), and the clip spans each stack. The
single-device trainer (`train_step.init_train_state`, so `launch.train
.run_spmd`) takes that; the pipeline engine calls `init(params)` and gets
per-layer Adafactor, as the reference's engine, which trains the list
layout. `update` reads which from the state. AdamW is elementwise and takes
no grouping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[..., Any]  # (params, period=None) -> state
    update: Callable[[Any, Any, Any, Any], tuple]  # (grads, state, params, step) -> (params, state)
    lr: float


def tree_map(fn, *trees):
    """Apply fn leaf by leaf over trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in a fixed order (dict keys as stored, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def make_optimizer(name="adamw", lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                   weight_decay=0.01, momentum_dtype=torch.float32):
    if name == "adamw":
        def init(params, period=None):  # elementwise: no stacks to group
            return {"m": tree_map(torch.zeros_like, params),
                    "v": tree_map(torch.zeros_like, params)}

        @torch.no_grad()
        def update(grads, state, params, step):
            stepf = step.float().cpu() + 1.0
            bc1 = float(1.0 - _f32(b1) ** stepf)
            bc2 = float(1.0 - _f32(b2) ** stepf)
            for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state["m"],
                                                              state["v"]))):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
                p.sub_(u.add_(p, alpha=weight_decay), alpha=lr)
            return params, state

        return Optimizer("adamw", init, update, lr)

    if name == "adafactor":
        def vstate(shape, like):
            if len(shape) >= 2:
                return {"vr": like.new_zeros(shape[:-1], dtype=torch.float32),
                        "vc": like.new_zeros(shape[:-2] + shape[-1:], dtype=torch.float32)}
            return {"v": like.new_zeros(shape, dtype=torch.float32)}

        def init(params, period=None):
            m = tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype), params)
            if period is None:
                return {"m": m, "v": tree_map(lambda p: vstate(p.shape, p), params)}

            def v_of(key, tree):
                # the encoder's layers are one stack: its period is cfg.period[0] alone
                P = {"layers": period, "enc_layers": 1}.get(key)
                if P is None:
                    return tree_map(lambda p: vstate(p.shape, p), tree)
                return tuple(tree_map(lambda p: vstate((len(tree[pos::P]),) + p.shape, p),
                                      tree[pos]) for pos in range(P))
            return {"m": m, "v": {k: v_of(k, v) for k, v in params.items()}}

        @torch.no_grad()
        def update(grads, state, params, step):
            stepf = step.float().cpu() + 1.0
            decay = float(1.0 - stepf ** -0.8)  # t^-0.8 schedule (Adafactor paper)
            for ps, gs, ms, vhats in _groups(params, grads, state["m"], state["v"], decay):
                us = [g.float() * torch.rsqrt(vhat + 1e-30) for g, vhat in zip(gs, vhats)]
                numel = sum(u.numel() for u in us)
                rms = torch.sqrt(sum(u.square().sum() for u in us) / numel + 1e-30)
                for p, m, u in zip(ps, ms, us):  # update clipping (RMS <= 1) over the group
                    u = u / rms.clamp_min(1.0)
                    m.copy_((b1 * m.float() + (1 - b1) * u).to(m.dtype))
                    p.copy_((p - lr * (m.float() + weight_decay * p)).to(p.dtype))
            return params, state

        return Optimizer("adafactor", init, update, lr)

    raise ValueError(name)


def _is_vstate(tree):
    return isinstance(tree, dict) and set(tree) in ({"v"}, {"vr", "vc"}) and all(
        isinstance(x, torch.Tensor) for x in tree.values())


def _accumulate(v, g2, decay):
    """Adafactor's second-moment statistics v ({"v"} or {"vr", "vc"}) take
    the squared gradient g2, in place; returns v's estimate of it."""
    if "vr" in v:
        v["vr"].mul_(decay).add_(g2.mean(dim=-1), alpha=1 - decay)
        v["vc"].mul_(decay).add_(g2.mean(dim=-2), alpha=1 - decay)
        vr, vc = v["vr"], v["vc"]
        return vr[..., None] * vc[..., None, :] / vr.mean(dim=-1)[..., None, None].clamp_min(1e-30)
    v["v"].mul_(decay).add_(g2, alpha=1 - decay)
    return v["v"]


def _groups(params, grads, m, v, decay):
    """Adafactor's update groups, their statistics updated with this step's
    gradients: (params, grads, momenta, v-hats) of each set of leaves that
    share one clip. A leaf is a group of its own, except where `v` holds a tuple over period
    positions for a list of layers (`init(params, period)`): there the
    layers of one period position form a stack, each of whose leaves is a
    group, as the reference's stacked leaf."""
    if _is_vstate(v):
        vhat = _accumulate(v, grads.float().square().add_(1e-30), decay)
        yield [params], [grads], [m], [vhat]
    elif isinstance(v, tuple) and isinstance(params, list):
        period = len(v)
        for pos, stack in enumerate(v):
            yield from _stacked(params[pos::period], grads[pos::period], m[pos::period], stack,
                                decay)
    elif isinstance(params, dict):
        for k in params:
            yield from _groups(params[k], grads[k], m[k], v[k], decay)
    else:
        for args in zip(params, grads, m, v):
            yield from _groups(*args, decay)


def _stacked(ps, gs, ms, v, decay):
    """_groups over the layers ps of one period position, whose statistics v
    are stacked: one group per leaf, factored by its stacked shape (n,) +
    shape. A leaf of two or more axes is factored over its last two in each
    layer, so layer j takes rows j of vr and vc; a 1-axis leaf (D,) is
    factored as (n, D), its vr (n,) and vc (D,) shared by the stack."""
    if isinstance(ps[0], dict):
        for k in ps[0]:
            yield from _stacked([p[k] for p in ps], [g[k] for g in gs], [m[k] for m in ms], v[k],
                                decay)
        return
    if ps[0].dim() >= 2:
        yield ps, gs, ms, [_accumulate({k: x[j] for k, x in v.items()},
                                       g.float().square().add_(1e-30), decay)
                           for j, g in enumerate(gs)]
        return
    vhat = _accumulate(v, torch.stack([g.float() for g in gs]).square_().add_(1e-30), decay)
    yield ps, gs, ms, list(vhat)


def optimizer_for(cfg, lr=3e-4):
    """Pick the optimizer by model scale (HBM-driven), as the reference does."""
    big = cfg.param_count() > 20_000_000_000
    return make_optimizer(
        "adafactor" if big else "adamw",
        lr=lr,
        momentum_dtype=torch.bfloat16 if big else torch.float32,
    )
