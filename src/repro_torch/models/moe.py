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

Under a sharding policy with a mesh, `_moe_sharded` is the counterpart of
the reference's `shard_map` TP/EP path: it works on each rank's local
shards with explicit collectives (DTensor redistributes at its edges), not
on DTensor propagation through the dispatch. The tokens are split over the
dp axes (over both of a (pod, data) mesh, pod-major, as the reference's
`P(("pod", "data"), None, None)`); the expert FFN width over tp
(per-expert TP), or with `policy.expert_parallel` and E % tp == 0 the
experts (EP); the FSDP'd dmodel axis of the expert weights is gathered
over every dp axis, each rank computes its experts' outputs for its
tokens, and the partial outputs are summed over tp. As in the reference,
each data shard routes, ranks and caps its own tokens (`_moe_math` on the
local batch, capacity from its T): the buffer is (E_l, C_local, D), and at
dp 1 the layer is the single-device one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import NULL_POLICY, mesh_axis_names


def init_moe(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    return {
        "router": dense_init(generator, (D, E), **kw),
        "w_gate": dense_init(generator, (E, D, Fd), in_axis=1, **kw),
        "w_up": dense_init(generator, (E, D, Fd), in_axis=1, **kw),
        "w_down": dense_init(generator, (E, Fd, D), in_axis=1, **kw),
    }


def moe_axes(cfg):
    return {"router": ("dmodel", None), "w_gate": ("expert", "dmodel", "ffn"),
            "w_up": ("expert", "dmodel", "ffn"), "w_down": ("expert", "ffn", "dmodel")}


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


def moe_ffn(cfg, p, x, policy=NULL_POLICY):
    """MoE layer on x (B, S, D) in its dtype -> (B, S, D); under a policy
    with a mesh, the TP/EP path on DTensors (`_moe_sharded`)."""
    if policy.mesh is not None:
        return _moe_sharded(cfg, p, x, policy)
    return _moe_math(cfg, p["router"], p["w_gate"], p["w_up"], p["w_down"], x)


def _moe_math(cfg, router, w_gate, w_up, w_down, x, e0=0):
    """The reference's `_moe_math` on local tokens x (B, S, D): capacity and
    ranks from these tokens alone; the weights are the local experts
    e0 .. e0 + E_l (all of them with e0 0 and E_l = E) or a slice of the
    FFN width, so the output is this shard's part of the layer's."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    E_l = w_gate.shape[0]
    T = B * S
    xt = x.reshape(T, D)
    gates, experts = route(cfg, router, xt)

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
    mine, local_e = keep, flat
    if E_l != E:  # EP: only the assignments to this shard's experts
        mine = keep & (flat >= e0) & (flat < e0 + E_l)
        local_e = flat - e0
        first, counts = first[e0:e0 + E_l], counts[e0:e0 + E_l]
    slot = torch.where(mine, local_e * C + rank, E_l * C)  # E_l·C: the spare row of the rest
    pos = torch.arange(C, device=x.device)
    assign = torch.where(pos < counts[:, None], order[(first[:, None] + pos).clamp_max(T * k - 1)],
                         T * k).view(-1)  # each slot's assignment; T·k: an empty slot's

    src = xt[:, None].expand(T, k, D).reshape(T * k, D)
    buf = x.new_zeros((E_l * C + 1, D)).index_copy(0, slot, src)[:E_l * C].view(E_l, C, D)
    h = torch.bmm(buf, w_gate.to(x.dtype))
    u = torch.bmm(buf, w_up.to(x.dtype))
    if torch.is_grad_enabled():
        act = F.silu(h) * u
    else:  # the same values in place: one (E, C, d_ff) buffer fewer at the peak
        act = F.silu(h, inplace=True).mul_(u)
        del u
    out = torch.bmm(act, w_down.to(x.dtype)).view(E_l * C, D)

    # back to the assignments, each kept one written once; a dropped one stays 0
    y = x.new_zeros((T * k + 1, D)).index_copy(0, assign, out)[:T * k]
    y = y * gates.reshape(-1, 1).to(x.dtype)
    if moe_ffn.routes is not None:
        moe_ffn.routes.append({"experts": experts.view(B, S, k), "kept": keep.view(B, S, k)})
    return y.view(T, k, D).sum(1).view(B, S, D)


def _moe_sharded(cfg, p, x, policy):
    """The TP/EP path (the reference's shard_map) on the local shards of
    the DTensors x and p; see the module's docstring."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, tp = policy.mesh, policy.tp_axis
    names = mesh_axis_names(mesh)
    dp = [a for a in policy.dp_axes if mesh.size(names.index(a)) > 1] if policy.shard_batch else []
    E, tp_n = cfg.n_experts, policy.tp
    ep = bool(policy.expert_parallel and tp and E % tp_n == 0)
    split = ep or bool(tp and cfg.moe_d_ff % tp_n == 0)  # anything split over tp is summed

    def placed(dims, partial=()):
        """Placements: tensor dim dims[a] over mesh axis a (a dim over two
        axes split major mesh axis first), Partial over the axes in
        `partial`, the rest replicated."""
        pl = [Replicate()] * len(names)
        for a, d in dims.items():
            pl[names.index(a)] = Shard(d)
        for a in partial:
            pl[names.index(a)] = Partial()
        return pl

    def local(t, dims, grad_partial):
        grad_dims = {a: d for a, d in dims.items() if a not in grad_partial}
        return t.redistribute(mesh, placed(dims)).to_local(
            grad_placements=placed(grad_dims, grad_partial))

    tp_partial = (tp,) if split and tp_n > 1 else ()
    # the tokens over every dp axis, the major (pod) one first, as the
    # reference's P(("pod", "data"), None, None) splits them
    x_dims = {a: 0 for a in dp}
    xl = local(x, x_dims, tp_partial)
    # every rank's gradient of a gathered weight covers its own tokens: summed over dp
    w_dims = ({tp: 0} if ep else ({tp: 2} if split else {}))
    wd_dims = ({tp: 0} if ep else ({tp: 1} if split else {}))
    router = local(p["router"], {}, tuple(dp) + tp_partial)
    w_gate = local(p["w_gate"], w_dims, tuple(dp))
    w_up = local(p["w_up"], w_dims, tuple(dp))
    w_down = local(p["w_down"], wd_dims, tuple(dp))
    e0 = mesh.get_local_rank(names.index(tp)) * w_gate.shape[0] if ep else 0
    y = _moe_math(cfg, router, w_gate, w_up, w_down, xl, e0)
    y = DTensor.from_local(y, mesh, placed(x_dims, tp_partial), run_check=False)
    return y.redistribute(mesh, placed(x_dims))  # the sum over tp


# A caller's record of each call's routes: None (the default) records
# nothing; a list gets {"experts", "kept"}, each (B, S, k), per call.
moe_ffn.routes = None


def router_aux_loss(cfg, p, x, policy=NULL_POLICY):
    """Switch-style load-balance loss of the router on x (B, S, D): E times the
    sum over experts of the top-1 fraction routed times the mean probability.
    Under a mesh the router is gathered whole, so the argmax reads whole rows."""
    router = p["router"]
    if policy.mesh is not None:
        router = policy.constrain(router, None, None)
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top1 = logits.argmax(-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(dim=(0, 1))
    return cfg.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
