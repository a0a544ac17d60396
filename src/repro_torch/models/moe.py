"""Top-k MoE FFN with capacity-buffer dispatch (counterpart of `repro.models.moe`).

One device: the reference's `_moe_math` with every expert local. Each of the
T·k assignments (token-major, k-minor) takes its rank among its expert's
assignments, as the reference's exclusive cumsum of a one-hot gives it (here
from a stable sort by expert: a cumsum down the one-hot's T·k rows is a
slow scan on the card); the first C of an expert fill its (C, D) buffer and
the rest are
dropped (they contribute 0), so the expert products are three dense batched
GEMMs over an (E, C, D) buffer. The reference drops an out-of-range scatter
row and clamps the gather; here both moves are `index_copy`s that write each
kept (expert, slot) once, a dropped assignment into a spare row past the
buffers and an empty slot into a spare row past the assignments, and whose
backwards are gathers: no float is summed by atomics, so routing and output
do not depend on launch order, and a recompute (remat) routes every token as
the first pass did. (A gather for the combine gives the same values, but
autograd's backward of it sums by sorted indices and serialises the many
dropped assignments that share the spare row: a quarter of an MoE train
step on the card.)

The reference's `shard_map` TP/EP path has no counterpart yet (ROADMAP
Queue 1 item 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    return {
        "router": dense_init(generator, (D, E), **kw),
        "w_gate": dense_init(generator, (E, D, Fd), in_axis=1, **kw),
        "w_up": dense_init(generator, (E, D, Fd), in_axis=1, **kw),
        "w_down": dense_init(generator, (E, Fd, D), in_axis=1, **kw),
    }


def _capacity(cfg, n_tokens):
    """Slots per expert: top_k · capacity_factor of an even share, at least 8,
    a multiple of 8, at most n_tokens (every position, padding included)."""
    c = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, n_tokens)


def route(cfg, router, xt):
    """Router of tokens xt (T, D): fp32 logits, softmax, top-k of the
    probabilities, gates renormalised over the k. -> (gates, experts), (T, k)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), experts


def moe_ffn(cfg, p, x):
    """MoE layer on x (B, S, D) in its dtype -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    gates, experts = route(cfg, p["router"], xt)

    C = _capacity(cfg, T)
    flat = experts.reshape(-1)  # (T·k,) assignments, token-major, k-minor
    # an assignment's rank: the earlier assignments to its expert, as the
    # reference's exclusive cumsum of a one-hot, from a stable sort by expert
    by_expert, order = torch.sort(flat, stable=True)
    bounds = torch.searchsorted(by_expert, torch.arange(E + 1, device=x.device))
    first, counts = bounds[:-1], bounds[1:] - bounds[:-1]  # no host sync, as bincount has
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(T * k, device=x.device) - first[by_expert]
    keep = rank < C
    slot = torch.where(keep, flat * C + rank, E * C)  # E·C: the spare row of the dropped
    pos = torch.arange(C, device=x.device)
    assign = torch.where(pos < counts[:, None], order[(first[:, None] + pos).clamp_max(T * k - 1)],
                         T * k).view(-1)  # each slot's assignment; T·k: an empty slot's

    src = xt[:, None].expand(T, k, D).reshape(T * k, D)
    buf = x.new_zeros((E * C + 1, D)).index_copy(0, slot, src)[:E * C].view(E, C, D)
    h = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    if torch.is_grad_enabled():
        act = F.silu(h) * u
    else:  # the same values in place: one (E, C, d_ff) buffer fewer at the peak
        act = F.silu(h, inplace=True).mul_(u)
        del u
    out = torch.bmm(act, p["w_down"].to(x.dtype)).view(E * C, D)

    # back to the assignments, each kept one written once; a dropped one stays 0
    y = x.new_zeros((T * k + 1, D)).index_copy(0, assign, out)[:T * k]
    y = y * gates.reshape(-1, 1).to(x.dtype)
    if moe_ffn.routes is not None:
        moe_ffn.routes.append({"experts": experts.view(B, S, k), "kept": keep.view(B, S, k)})
    return y.view(T, k, D).sum(1).view(B, S, D)


# A caller's record of each call's routes: None (the default) records
# nothing; a list gets {"experts", "kept"}, each (B, S, k), per call.
moe_ffn.routes = None


def router_aux_loss(cfg, p, x):
    """Switch-style load-balance loss of the router on x (B, S, D): E times the
    sum over experts of the top-1 fraction routed times the mean probability."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top1 = logits.argmax(-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(dim=(0, 1))
    return cfg.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
