"""Optimizers: AdamW and Adafactor(+momentum) (counterpart of `repro.train.optimizer`).

Plain functions on trees of tensors (nested dicts and lists, as the port's
parameters), with the reference's state keys: AdamW keeps `m` and `v`;
Adafactor keeps `m` (in `momentum_dtype`) and, per leaf, `v` or the factored
row and column statistics `vr` and `vc` of leaves with two or more axes.
`update` changes the parameters and the state in place (the reference
returns new trees) and returns both. Not `torch.optim`: its state layout and
its Adafactor differ from the reference's.

The reference stacks the layers of a period position into one leaf; the port
keeps one leaf per layer. AdamW is elementwise, so the two agree; Adafactor's
factoring and its RMS update clip act on a whole leaf, so for a model the
port's Adafactor works per layer where the reference's works per stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
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
        def init(params):
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
        def init(params):
            def vstate(p):
                if p.dim() >= 2:
                    return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                            "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32)}
                return {"v": torch.zeros_like(p, dtype=torch.float32)}

            return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype), params),
                    "v": tree_map(vstate, params)}

        @torch.no_grad()
        def update(grads, state, params, step):
            stepf = step.float().cpu() + 1.0
            decay = float(1.0 - stepf ** -0.8)  # t^-0.8 schedule (Adafactor paper)
            for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state["m"]), _vleaves(state["v"])):
                g = g.float()
                g2 = g.square().add_(1e-30)
                if "vr" in v:
                    v["vr"].mul_(decay).add_(g2.mean(dim=-1), alpha=1 - decay)
                    v["vc"].mul_(decay).add_(g2.mean(dim=-2), alpha=1 - decay)
                    vr, vc = v["vr"], v["vc"]
                    vhat = (vr[..., None] * vc[..., None, :]
                            / vr.mean(dim=-1)[..., None, None].clamp_min(1e-30))
                else:
                    v["v"].mul_(decay).add_(g2, alpha=1 - decay)
                    vhat = v["v"]
                u = g * torch.rsqrt(vhat + 1e-30)
                rms = torch.sqrt(u.square().mean() + 1e-30)  # update clipping (RMS <= 1)
                u = u / rms.clamp_min(1.0)
                m.copy_((b1 * m.float() + (1 - b1) * u).to(m.dtype))
                p.copy_((p - lr * (m.float() + weight_decay * p)).to(p.dtype))
            return params, state

        return Optimizer("adafactor", init, update, lr)

    raise ValueError(name)


def _vleaves(tree):
    """Adafactor's per-parameter `v` states ({"v"} or {"vr", "vc"}) in leaf order."""
    if isinstance(tree, dict) and ("v" in tree or "vr" in tree) and all(
            isinstance(x, torch.Tensor) for x in tree.values()):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for x in items for leaf in _vleaves(x)]


def optimizer_for(cfg, lr=3e-4):
    """Pick the optimizer by model scale (HBM-driven), as the reference does."""
    big = cfg.param_count() > 20_000_000_000
    return make_optimizer(
        "adafactor" if big else "adamw",
        lr=lr,
        momentum_dtype=torch.bfloat16 if big else torch.float32,
    )
