"""xLSTM blocks, as `repro.models.xlstm`: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, recurrent per position, block-diagonal
recurrence per head).

The mLSTM's training and prefill path is the chunkwise form: quadratic work
inside a chunk of L positions, the (B, H, dh, dh) matrix state carried from
chunk to chunk, stabilised in log space, with the state dropped at packed
document starts (`carry_ok`, `suffix_ok`). The reference's `lax.scan` over
chunks is a Python loop over them here, and the sLSTM's scan over positions
a Python loop over positions (both through `roofline.counter.scan`). Decode
is O(1) a token from the (C, n, m) cache of an mLSTM and the (c, n, m, h)
cache of an sLSTM.

Under a `ShardingPolicy` with a mesh the projections are DTensor products
(the weights' FSDP shards gathered) and both scans run on each rank's local
shards (`ShardingPolicy.run_local`): its rows (batch over dp) and its heads
(over tp where they divide; elsewhere every rank runs every head, as the
reference's `spec_for` places them). The sequence is never split inside a
scan. The mLSTM's decode step runs on the DTensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, doc_keep, local_conv1d
from repro_torch.parallel.sharding import NULL_POLICY, placed_as
from repro_torch.roofline.counter import scan

NEG = -1e30


def _di(cfg):
    return 2 * cfg.d_model


def init_mlstm(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, H = cfg.d_model, cfg.n_heads
    di = _di(cfg)
    dh = di // H
    kw = dict(dtype=dtype, device=device)

    def vec(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)
    return {
        "w_m": dense_init(generator, (D, di), **kw),
        "w_z": dense_init(generator, (D, di), **kw),
        "conv_w": dense_init(generator, (di, cfg.xlstm_conv), **kw),
        "conv_b": vec(di, 0.0),
        # block-diagonal per-head q/k/v
        "wq": dense_init(generator, (H, dh, dh), in_axis=1, **kw),
        "wk": dense_init(generator, (H, dh, dh), in_axis=1, **kw),
        "wv": dense_init(generator, (H, dh, dh), in_axis=1, **kw),
        "wi": dense_init(generator, (di, H), **kw),
        "wf": dense_init(generator, (di, H), **kw),
        "bi": vec(H, 0.0),
        "bf": vec(H, 3.0),  # forget ~ sigmoid(3)
        "gn": vec(di, 1.0),
        "w_out": dense_init(generator, (di, D), **kw),
    }


def mlstm_axes(cfg):
    return {"w_m": ("dmodel", "dinner"), "w_z": ("dmodel", "dinner"), "conv_w": ("dinner", None),
            "conv_b": ("dinner",), "wq": ("heads", None, None), "wk": ("heads", None, None),
            "wv": ("heads", None, None), "wi": ("dinner", None), "wf": ("dinner", None),
            "bi": (None,), "bf": (None,), "gn": ("dinner",), "w_out": ("dinner", "dmodel")}


def _by_heads(policy, t, H):
    """t (B,S,di) as (B,S,H,dh). Under a mesh t is first placed as its heads
    are: its inner width stays split over tp where tp divides the heads
    (whole heads a rank), and where it does not, this redistribution is the
    all-gather of the inner width over tp (every rank then holds every
    head), so that the view never cuts a head across ranks."""
    B, S, di = t.shape
    if policy.mesh is not None:
        t = t.redistribute(policy.mesh, policy.placements_for(("batch", None, "heads"), (B, S, H)))
    return t.reshape(B, S, H, di // H)


def _mlstm_inputs(cfg, p, x, segment_ids, policy):
    """q, k (scaled by 1/sqrt(dh)), v (B,S,H,dh) in x's dtype; the input and
    forget gates' logs li, lf (B,S,H) in float32; the output gate's z (B,S,di)."""
    H, di = cfg.n_heads, _di(cfg)
    dh = di // H
    dtype = x.dtype
    xm = x @ policy.gathered(p["w_m"]).to(dtype)
    z = x @ policy.gathered(p["w_z"]).to(dtype)
    xc = F.silu(local_conv1d(policy, xm, p["conv_w"].to(dtype), p["conv_b"].to(dtype),
                             segment_ids))
    xh = _by_heads(policy, xc, H)
    q = torch.einsum("bshk,hkl->bshl", xh, p["wq"].to(dtype))
    k = torch.einsum("bshk,hkl->bshl", xh, p["wk"].to(dtype)) / math.sqrt(dh)
    v = torch.einsum("bshk,hkl->bshl", _by_heads(policy, xm, H), p["wv"].to(dtype))
    li = (xc @ policy.gathered(p["wi"]).to(dtype)).float() + p["bi"]
    lf = (xc @ policy.gathered(p["wf"]).to(dtype)).float() + p["bf"]
    # on local shards: DTensor has no rule for logsigmoid's backward
    gates = ("batch", None, "heads")
    lf = policy.run_local(lambda t: (F.logsigmoid(t),), (gates,), ((gates, tuple(lf.shape)),),
                          lf)[0]
    return q, k, v, li, lf, z


def _mlstm_chunk(C, n, m, qb, kb, vb, lib, lfb, sb, kpb, tri):
    """One chunk of L positions from the carried (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)): qb, kb, vb (B,H,L,dh), lib, lfb (B,H,L) float32; sb (B,L) the
    segment ids, kpb (B,L) 0 where a document starts. -> (h (B,H,L,dh), C, n, m)."""
    kpf = kpb.float()
    # prod(kp[:i]): the positions that may still see the carry from earlier chunks
    carry_ok = torch.cumprod(kpf, dim=-1)[:, None, :]  # (B,1,L)
    # prod(kp[j+1:]): the positions whose contribution survives to the chunk's end
    kp_next = torch.cat([kpf[:, 1:], torch.ones_like(kpf[:, :1])], dim=-1)
    suffix_ok = torch.flip(torch.cumprod(torch.flip(kp_next, (-1,)), dim=-1), (-1,))[:, None, :]

    b = torch.cumsum(lfb, dim=-1)  # (B,H,L) inclusive log-decay
    m_inter = b + m[..., None]
    dmat = b[..., :, None] - b[..., None, :] + lib[..., None, :]  # (B,H,L,L)
    smask = (sb[:, None, :, None] == sb[:, None, None, :]) & tri
    dmat = torch.where(smask, dmat, torch.full((), NEG, device=dmat.device))
    m_new = torch.maximum(m_inter, dmat.amax(dim=-1))  # (B,H,L)
    sc = (qb @ kb.transpose(-1, -2)) * torch.exp(dmat - m_new[..., None])
    inter_w = carry_ok * torch.exp(m_inter - m_new)  # (B,H,L)
    num = sc @ vb + inter_w[..., None] * (qb @ C)
    den = sc.sum(-1) + inter_w * torch.einsum("bhk,bhlk->bhl", n, qb)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]  # (B,H,L,dh)
    # the chunk-end state, without the contributions before the last document start
    total = b[..., -1]  # (B,H)
    dk = total[..., None] - b + lib  # (B,H,L): decay from each position to the chunk's end
    m_c = torch.maximum(total + m, dk.amax(dim=-1))
    scale_old = carry_ok[:, :, -1] * torch.exp(total + m - m_c)  # (B,H)
    w = suffix_ok * torch.exp(dk - m_c[..., None])
    C = scale_old[..., None, None] * C + (kb * w[..., None]).transpose(-1, -2) @ vb
    n = scale_old[..., None] * n + torch.einsum("bhl,bhlk->bhk", w, kb)
    return h, C, n, m_c


def mlstm_scan(q, k, v, li, lf, seg, keep, L):
    """The chunkwise mLSTM over (B,S,H,dh) q, k, v and (B,S,H) li, lf from a
    zero state, chunks of L positions; seg, keep (B,S): segment ids and
    False where a document starts. -> (h (B,S,H·dh) float32, (C, n, m))."""
    B, S, H, dh = q.shape
    nc = S // L

    def chunks(t):  # (B,S,H,dh) -> nc x (B,H,L,dh); (B,S,H) -> nc x (B,H,L)
        t = t.reshape((B, nc, L) + t.shape[2:])
        return (t.permute(1, 0, 3, 2, 4) if t.dim() == 5 else t.permute(1, 0, 3, 2)).unbind(0)

    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)

    def step(carry, qb, kb, vb, lib, lfb, sb, kpb):
        h, *carry = _mlstm_chunk(*carry, qb, kb, vb, lib, lfb, sb, kpb, tri)
        return carry, h
    (C, n, m), hs = scan(step, (C, n, m), (
        *(chunks(t.float()) for t in (q, k, v)), *(chunks(t) for t in (li, lf)),
        seg.reshape(B, nc, L).unbind(1), keep.reshape(B, nc, L).unbind(1)))
    h = torch.stack(hs, 1).permute(0, 1, 3, 2, 4).reshape(B, S, H * dh)  # (B,nc,L,H,dh)
    return h, (C, n, m)


def _mlstm_local(q, k, v, li, lf, seg, L):
    """`mlstm_scan` on one rank's shards (one document a row without
    segment ids) -> (h, C, n, m)."""
    keep = doc_keep(seg, q)
    if seg is None:
        seg = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    h, (C, n, m) = mlstm_scan(q, k, v, li, lf, seg, keep, L)
    return h, C, n, m


def mlstm(cfg, spec, p, x, md, cache=None, chunk=None, policy=NULL_POLICY):
    """Returns (out (B,S,D), new_cache).

    cache: None for the packed forward and prefill, chunkwise over chunks of
    `chunk` positions (`cfg.mlstm_chunk` by default; S must be a multiple of
    it, or shorter; with md['collect_state'] the new cache is the
    {'C', 'n', 'm'} after the last chunk); else that cache and one token.
    Under a `policy` with a mesh, x, the weights and the cache are DTensors
    (the module's docstring).
    """
    chunk = chunk if chunk is not None else cfg.mlstm_chunk
    B, S, D = x.shape
    H, di = cfg.n_heads, _di(cfg)
    dtype = x.dtype
    w_out = policy.gathered(p["w_out"]).to(dtype)

    if cache is not None:  # O(1) recurrent decode step
        # The reference passes no conv state: `_mlstm_inputs(cfg, p, x, None)`
        # over the new token alone (src/repro/models/xlstm.py:81), so the
        # causal conv sees that token only, where the packed forward's sees the
        # xlstm_conv - 1 before it too; kept as the reference computes it.
        q, k, v, li, lf, z = _mlstm_inputs(cfg, p, x, None, policy)
        C, n, m = cache["C"], cache["n"], cache["m"]  # (B,H,dh,dh), (B,H,dh), (B,H)
        li, lf = li[:, 0], lf[:, 0]  # (B,H)
        m_new = torch.maximum(lf + m, li)
        fe = torch.exp(lf + m - m_new)[..., None]
        ie = torch.exp(li - m_new)[..., None]
        kf, vf = k[:, 0].float(), v[:, 0].float()
        C = fe[..., None] * C + ie[..., None] * kf[..., :, None] * vf[..., None, :]
        n = fe * n + ie * kf
        qf = q[:, 0].float()  # (B,H,dh)
        num = torch.einsum("bhkl,bhk->bhl", C, qf)
        den = torch.einsum("bhk,bhk->bh", n, qf).abs()
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        # whole heads before they are flattened: a cache split on head_dim
        # leaves h split there, which DTensor's view cannot flatten
        h = policy.constrain(h, "batch", "heads", None)
        hflat = (h.reshape(B, 1, di) * p["gn"]).to(dtype)
        out = (hflat * F.silu(z)) @ w_out
        return out, placed_as({"C": C, "n": n, "m": m_new}, cache)

    seg = md.get("segment_ids")
    q, k, v, li, lf, z = _mlstm_inputs(cfg, p, x, seg, policy)
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    dh = di // H
    heads, gates = ("batch", None, "heads", None), ("batch", None, "heads")
    h, C, n, m = policy.run_local(
        _mlstm_local, (heads, heads, heads, gates, gates, ("batch", None), None),
        ((gates, (B, S, H)), (("batch", "heads", None, None), (B, H, dh, dh)),
         (("batch", "heads", None), (B, H, dh)), (("batch", "heads"), (B, H))),
        q, k, v, li, lf, seg, L)
    h = policy.constrain((h * p["gn"]).to(dtype), "batch", "seq", "dinner")
    out = (h * F.silu(z)) @ w_out
    new_cache = {"C": C, "n": n, "m": m} if md.get("collect_state") else None
    return out, new_cache


def init_mlstm_cache(cfg, batch, device="cuda"):
    H = cfg.n_heads
    dh = _di(cfg) // H

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"C": zeros(batch, H, dh, dh), "n": zeros(batch, H, dh), "m": zeros(batch, H)}


# --------------------------------------------------------------------- sLSTM
def init_slstm(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    """`r_g` and `b_g` stay float32 (`layers.FP32_PARAMS`): the reference
    computes the recurrence and the gate bias in float32."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    kw = dict(dtype=dtype, device=device)
    b_g = torch.zeros((4, H, dh), dtype=torch.float32, device=device)
    b_g[1] = 3.0  # the forget gate's
    return {
        "w_g": dense_init(generator, (D, 4, H, dh), **kw),
        "r_g": dense_init(generator, (4, H, dh, dh), in_axis=2, device=device) * 0.5,
        "b_g": b_g,
        "w_out": dense_init(generator, (D, D), **kw),
    }


def slstm_axes(cfg):
    return {"w_g": ("dmodel", None, "heads", None), "r_g": (None, "heads", None, None),
            "b_g": (None, "heads", None), "w_out": ("dmodel", "dmodel")}


def slstm_scan(gates_x, keep, r_g, b_g, carry):
    """The sLSTM over positions: gates_x (B,S,4,H,dh) the input's gate
    pre-activations, keep (B,S) float32 0 where the carry is zeroed, r_g
    (4,H,dh,dh) and b_g (4,H,dh) float32, carry the (c, n, m, h) (B,H,dh)
    before the first position. -> (h (B,S,H,dh) float32, carry after the last)."""
    B, S, _, H, dh = gates_x.shape
    # the recurrence as one product a head: h (dh) -> the 4 gates' dh columns
    r = r_g.float().permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)

    def step(carry, gx, kp):
        c, n, m, h = (t * kp for t in carry)
        gr = torch.bmm(h.transpose(0, 1), r).view(H, B, 4, dh).permute(1, 2, 0, 3)
        it, ft, zt, ot = (gx + gr + b_g).unbind(1)  # (B,H,dh) each
        m_new = torch.maximum(ft + m, it)
        i_e = torch.exp(it - m_new)
        f_e = torch.exp(ft + m - m_new)
        c = f_e * c + i_e * torch.tanh(zt)
        n = f_e * n + i_e
        h = torch.sigmoid(ot) * c / n.clamp_min(1.0)
        return (c, n, m_new, h), h
    carry, hs = scan(step, tuple(carry), (gates_x.float().unbind(1),
                                          keep[..., None, None].unbind(1)))
    return torch.stack(hs, 1), carry


def _slstm_local(gates_x, seg, r_g, b_g, *carry):
    """`slstm_scan` on one rank's shards: the carry zeroed at the documents'
    starts by `seg` (none without it), from zeros where `carry` is None ->
    (h, c, n, m, h_last)."""
    B, _, _, H, dh = gates_x.shape
    if carry[0] is None:
        carry = (torch.zeros((B, H, dh), dtype=torch.float32, device=gates_x.device),) * 4
    hs, carry = slstm_scan(gates_x, doc_keep(seg, gates_x).float(), r_g, b_g, carry)
    return hs, *carry


def slstm(cfg, spec, p, x, md, cache=None, policy=NULL_POLICY):
    """sLSTM, one position at a time, with a block-diagonal recurrence per
    head. Gates: i (exp), f (exp, stabilised by m), z (tanh cell input), o
    (sigmoid); the carry is zeroed at a document start (the packed forward
    and prefill), never in decode. Returns (out (B,S,D), new_cache): the
    {'c', 'n', 'm', 'h'} after the last position, with a cache given (decode)
    or md['collect_state'] (prefill). Under a `policy` with a mesh, x, the
    weights and the cache are DTensors (the module's docstring)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    dtype = x.dtype
    w_g = policy.gathered(p["w_g"]).reshape(D, 4 * H * dh)
    gates_x = (x @ w_g.to(dtype)).view(B, S, 4, H, dh)
    seg = md.get("segment_ids") if cache is None else None
    carry = (None,) * 4
    if cache is not None:
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    state = ("batch", "heads", None)
    hs, c, n, m, h = policy.run_local(
        _slstm_local, (("batch", None, None, "heads", None), ("batch", None),
                       (None, "heads", None, None), (None, "heads", None)) + (state,) * 4,
        ((("batch", None, "heads", None), (B, S, H, dh)),) + ((state, (B, H, dh)),) * 4,
        gates_x, seg, p["r_g"], p["b_g"], *carry)
    y = hs.reshape(B, S, D).to(dtype)
    out = y @ policy.gathered(p["w_out"]).to(dtype)
    new_cache = None
    if cache is not None or md.get("collect_state"):
        new_cache = {"c": c, "n": n, "m": m, "h": h}
    if cache is not None:
        new_cache = placed_as(new_cache, cache)
    return out, new_cache


def init_slstm_cache(cfg, batch, device="cuda"):
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "m": z.clone(), "h": z.clone()}
