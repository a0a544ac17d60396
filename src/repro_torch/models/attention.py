"""GQA attention over packed segments with qk-norm, RoPE and M-RoPE;
cross-attention over an encoder output; KV-cache decode.

Counterpart of `repro.models.attention.attention`. Prefill and the packed
forward, causal or not (the encoder), self- or cross-attention, go through
`kernels.ops.packed_attention` (the Hopper kernel on the card) with the KV
heads un-repeated; decode is dense masked attention over the cache in plain
PyTorch, as the reference computes it in jnp. Under a mesh the kernel runs
on each rank's heads (`sharded_packed_attention`), and decode writes and
reads each rank's part of the cache (`sharded_decode`; the cross cache,
read only, `sharded_cross_decode`).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.ops import packed_attention
from repro_torch.kernels.ref import NEG_INF, attention_mask
from repro_torch.models.layers import apply_rope, dense_init, head_rms_norm, rope_angles
from repro_torch.parallel.sharding import NULL_POLICY, mesh_block


def init_attention(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(generator, (D, H, dh), **kw),
        "wk": dense_init(generator, (D, K, dh), **kw),
        "wv": dense_init(generator, (D, K, dh), **kw),
        "wo": dense_init(generator, (H, dh, D), in_axis=(0, 1), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros(dh, dtype=torch.float32, device=device)
    return p


def attention_axes(cfg):
    """The logical axes of `init_attention`'s leaves (the reference's
    `annotate` calls)."""
    ax = {"wq": ("dmodel", "heads", "head_dim"), "wk": ("dmodel", "kv_heads", "head_dim"),
          "wv": ("dmodel", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "dmodel")}
    if cfg.qk_norm:
        ax["q_norm"] = ax["k_norm"] = (None,)
    return ax


def _sdpa_dense(q, k, v, mask, scale):
    """q (B,Sq,H,dh), k/v (B,Sk,K,dh), mask (B,Sq,Sk). Query head h reads kv
    head h // (H // K), the same map as repeating the KV heads."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, dh)
    scores = torch.einsum("bqkrd,btkd->bkrqt", qg, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqt,btkd->bqkrd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dh)


def _decode_attend(q, k, v, seg_k, pos_k, lengths, *, causal, window, scale):
    """Decode attention of the S new queries at positions lengths + 0..S-1
    over cached keys (seg_k 0: not visible), dense in plain PyTorch."""
    B, S = q.shape[:2]
    pos_q = lengths[:, None] + torch.arange(S, device=q.device)[None]
    seg_q = torch.ones((B, S), dtype=torch.int32, device=q.device)
    mask = attention_mask(seg_q, seg_k, pos_q, pos_k, causal=causal, window=window)
    return _sdpa_dense(q, k.to(q.dtype), v.to(q.dtype), mask, scale)


def _decode_merge_attend(q, k, v, mask, scale, reduce):
    """`_sdpa_dense` over a part of the keys whose other parts other ranks
    hold: each row's max, then its sum and output, are summed over the
    holders by `reduce(x, op)` before the output is divided by the sum.
    A row that sees no key here gets 0 from this part."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, dh)
    scores = torch.einsum("bqkrd,btkd->bkrqt", qg, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    m = reduce(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(scores - m).masked_fill(~mask[:, None, None], 0.0)
    lo = torch.cat([p.sum(dim=-1), torch.einsum("bkrqt,btkd->bkrqd", p, v.float()).flatten(3)],
                   dim=-1)
    lo = reduce(lo, "sum")
    out = lo[..., Sq:].unflatten(-1, (Sq, dh)) / lo[..., :Sq, None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def _decode_layout(mesh, cache_placements):
    """The layout a decode step reads from its cache's placements (batch
    over the dp axes; slots, `kv_seq`, or else kv heads over tp; or slots
    over every axis): {tensor dim: the mesh dims that split it} for the
    batch (0), slots (1) and kv heads (2); the placements of q, the new K/V
    and the output (batch and heads split as the cache's) and of `lengths`
    (batch); and `attend(q, k, v, mask, scale)`, the dense attention over
    this rank's keys, whose softmax parts are merged over the mesh dims
    that split the slots by all-reduces (`_decode_merge_attend`)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    dims = {d: [i for i, pl in enumerate(cache_placements) if pl == Shard(d)] for d in (0, 1, 2)}
    qp = [Shard(0) if i in dims[0] else Shard(2) if i in dims[2] else Replicate()
          for i in range(mesh.ndim)]
    lp = [Shard(0) if i in dims[0] else Replicate() for i in range(mesh.ndim)]

    def reduce(x, op):
        for i in dims[1]:
            x = funcol.all_reduce(x, op, (mesh, i))
        return x

    def attend(q, k, v, mask, scale):
        k, v = k.to(q.dtype), v.to(q.dtype)
        if not dims[1]:
            return _sdpa_dense(q, k, v, mask, scale)
        return _decode_merge_attend(q, k, v, mask, scale, reduce)
    return dims, qp, lp, attend


def sharded_decode(policy, q, k_new, v_new, cache, lengths, *, causal, window, scale):
    """One decode step's cache write and attention over DTensors, the cache
    placed by `launch.specs.cache_shardings`, through `local_map`.

    The cache keeps its placement: its batch over the dp axes, and its
    slots (`kv_seq`) or else its kv heads over tp (over every axis for a
    batch too small to split). Each rank writes the new K/V, position by
    position, only into the slots of its own range, and attends its q heads
    (split as the cache's kv heads are) over its own keys. Where the slots
    are split, each rank's partial max, then its partial sum and output,
    are merged over the ranks that hold the slots by all-reduces (the
    exchange GSPMD emits for the reference); DTensor left to itself would
    gather the whole cache. Out: (B, S, H, dh), placed as q's local map."""
    from torch.distributed.tensor.experimental import local_map

    mesh = policy.mesh
    cp = cache["k"].placements
    dims, qp, lp, attend = _decode_layout(mesh, cp)
    T = cache["k"].shape[1]
    n, block = mesh_block(mesh, dims[1])
    lo_slot, Tl = block * (T // n), T // n

    def local(q, k_new, v_new, ck, cv, cpos, lengths):
        B, S = q.shape[:2]
        rows = torch.arange(B, device=q.device)
        for j in range(S):  # each new position into its ring slot, where it is this rank's
            at = lengths + j
            slot = at % T - lo_slot
            mine = (slot >= 0) & (slot < Tl)
            slot = slot.clamp(0, Tl - 1)
            ck[rows, slot] = torch.where(mine[:, None, None], k_new[:, j].to(ck.dtype),
                                         ck[rows, slot])
            cv[rows, slot] = torch.where(mine[:, None, None], v_new[:, j].to(cv.dtype),
                                         cv[rows, slot])
            cpos[rows, slot] = torch.where(mine, at.to(torch.int32), cpos[rows, slot])
        pos_q = lengths[:, None] + torch.arange(S, device=q.device)[None]
        seg_q = torch.ones((B, S), dtype=torch.int32, device=q.device)
        mask = attention_mask(seg_q, (cpos >= 0).to(torch.int32), pos_q, cpos.clamp_min(0),
                              causal=causal, window=window)
        return attend(q, ck, cv, mask, scale)

    return local_map(local, out_placements=qp,
                     in_placements=(qp, qp, qp, cp, cache["v"].placements,
                                    cache["pos"].placements, lp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_new, v_new, cache["k"], cache["v"], cache["pos"], lengths)


def sharded_cross_decode(policy, q, cache, seg_k, pos_k, lengths, *, scale):
    """A decode step's cross-attention over the constant cross cache
    {"k_const", "v_const"} (B, S_enc, K, dh), DTensors placed by
    `launch.specs.cache_shardings`, through `local_map`: the read-only
    counterpart of `sharded_decode`. Each rank attends its q heads (split
    as the cache's kv heads are) over its own encoder positions, whose ids
    (seg_k, pos_k (B, S_enc)) it reads where its slots lie; where the cache's
    `kv_seq` is split, the ranks' softmax parts are merged by all-reduces,
    as DTensor left to itself would gather the whole cache. It writes
    nothing. Out: (B, S, H, dh), placed as q's local map."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = policy.mesh
    cp = cache["k_const"].placements
    dims, qp, lp, attend = _decode_layout(mesh, cp)
    # the ids of the encoder positions: the batch's rows, the cache's slots
    ip = [Shard(0) if i in dims[0] else Shard(1) if i in dims[1] else Replicate()
          for i in range(mesh.ndim)]

    def local(q, ck, cv, seg_k, pos_k, lengths):
        B, S = q.shape[:2]
        pos_q = lengths[:, None] + torch.arange(S, device=q.device)[None]
        seg_q = torch.ones((B, S), dtype=torch.int32, device=q.device)
        mask = attention_mask(seg_q, seg_k, pos_q, pos_k, causal=False, window=None)
        return attend(q, ck, cv, mask, scale)

    return local_map(local, out_placements=qp,
                     in_placements=(qp, cp, cache["v_const"].placements, ip, ip, lp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, cache["k_const"], cache["v_const"], seg_k, pos_k, lengths)


def _kv_for_local_heads(k, v, H, h0, Hl):
    """The kv heads that q heads h0..h0+Hl-1 of H read (head h reads kv head
    h*K//H), so that the kernel's own map over the local heads, h*K'//Hl,
    reads the same ones: a contiguous range where that map holds, else one
    kv head for each q head."""
    K = k.shape[2]
    kv = [h * K // H for h in range(h0, h0 + Hl)]
    n = kv[-1] - kv[0] + 1
    if [h * n // Hl for h in range(Hl)] == [j - kv[0] for j in kv]:
        return k[:, :, kv[0]:kv[0] + n], v[:, :, kv[0]:kv[0] + n]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def sharded_packed_attention(policy, q, k, v, seg_q, seg_k, pos_q, pos_k, **kw):
    """`packed_attention` over DTensors: each rank runs the kernel on its
    local heads through `local_map`. The q heads are split over tp where
    they divide (the head dim never is: a rank needs whole heads), the kv
    heads too where they divide; where they do not, each rank passes the kv
    heads its q heads read (`_kv_for_local_heads`), and their gradients,
    each rank's part of the whole, are summed over tp. Out: placed as q."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    H = q.shape[2]
    # never the sequence (`seq_parallel` splits it between blocks): every
    # rank's kernel reads all of its rows' positions and keys
    qp = policy.placements_for(("batch", None, "heads", None), q.shape)
    kp = policy.placements_for(("batch", None, "kv_heads", None), k.shape)
    ip = policy.placements_for(("batch", None), seg_q.shape)
    ik = policy.placements_for(("batch", None), seg_k.shape)
    h0 = None
    if Shard(2) in qp and Shard(2) not in kp:
        tp_dim = [i for i, pl in enumerate(qp) if pl == Shard(2)]
        n, block = mesh_block(policy.mesh, tp_dim)
        Hl = H // n
        h0 = block * Hl
        grad_kp = [Partial() if i in tp_dim else pl for i, pl in enumerate(kp)]
        k, v = (t.redistribute(policy.mesh, kp).to_local(grad_placements=grad_kp)
                for t in (k, v))
        kp = None  # passed as local tensors

    def local(q, k, v, sq, sk, pq, pk):
        if h0 is not None:
            k, v = _kv_for_local_heads(k, v, H, h0, q.shape[2])
        return packed_attention(q, k, v, sq, sk, pq, pk, **kw)

    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp, ip, ik, ip, ik),
                     device_mesh=policy.mesh, redistribute_inputs=True)(
        q, k, v, seg_q, seg_k, pos_q, pos_k)


def _project(policy, x, w, n, heads_axis):
    """x (B,S,D) @ w (D,n,dh) -> (B,S,n,dh). Under a mesh the product's
    flat n*dh dim is first placed as its heads are (split over tp only where
    n divides, and then in whole heads), so the view never cuts a head
    across ranks as DTensor's own choice of product layout can; the weight
    is gathered after its view to (D, n*dh), so the backward places its
    gradient as the flat weight is placed and the view back holds too."""
    B, S, D = x.shape
    dh = w.shape[-1]
    w = policy.gathered(w.reshape(D, n * dh))
    if policy.mesh is None:
        return (x @ w.to(x.dtype)).view(B, S, n, dh)
    y = (x @ w.to(x.dtype)).redistribute(
        policy.mesh, policy.placements_for(("batch", "seq", heads_axis), (B, S, n)))
    return y.view(B, S, n, dh)


def attention(cfg, spec, p, x, md, cache=None, policy=NULL_POLICY):
    """Full attention layer: self-attention, or cross-attention over the
    encoder output `md["cross_x"]`.

    md: 'positions' (B,S) packed RoPE positions, or (B,S,3) with M-RoPE
        (`cfg.mrope_sections`); 'segment_ids' (B,S), 'abs_positions' (B,S)
        for the causal test; 'causal' (False: the encoder); for decode
        'lengths' (B,) current KV fill. Cross-attention also reads
        'cross_segment_ids' and 'cross_positions' (B,S_enc), the encoder's
        ids, and is never causal, windowed or rotated.
    cache: None for the packed forward and prefill; else for self-attention
        {'k': (B,T,K,dh), 'v': ..., 'pos': (B,T)} (T slots: `model.cache_len`),
        updated in place (the reference returns a new array; in place saves a
        cache copy per layer and step), and for cross-attention the constant
        {'k_const', 'v_const'} (B,S_enc,K,dh), read and never written.
    With md['collect_state'] (prefill) the new cache is {'k', 'v', 'pos'} of
    self-attention or {'k_const', 'v_const'} of cross-attention.
    Under a `policy` with a mesh, x and the weights are DTensors and the
    kernel runs on each rank's heads (`sharded_packed_attention`).
    Returns (out (B,S,D), new_cache).
    """
    attend = packed_attention
    if policy.mesh is not None:
        attend = functools.partial(sharded_packed_attention, policy)
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = x.shape[:2]
    scale = 1.0 / math.sqrt(dh)
    window = cfg.window if spec.attn_kind == "swa" else None
    causal = md.get("causal", True)
    kx = md.get("cross_x")  # the encoder output, for cross-attention

    q = _project(policy, x, p["wq"], H, "heads")
    if cache is not None and "k_const" in cache:
        # decode over the constant cross K/V; the query is not qk-normed here,
        # as in the reference (prefill's is)
        if policy.mesh is not None:
            out = sharded_cross_decode(policy, q, cache, md["cross_segment_ids"],
                                       md["cross_positions"], md["lengths"], scale=scale)
        else:
            out = _decode_attend(q, cache["k_const"], cache["v_const"], md["cross_segment_ids"],
                                 md["cross_positions"], md["lengths"], causal=False,
                                 window=None, scale=scale)
        new_cache = cache
    else:
        src = kx if kx is not None else x
        Sk = src.shape[1]
        k = _project(policy, src, p["wk"], K, "kv_heads")
        v = _project(policy, src, p["wv"], K, "kv_heads")
        if cfg.qk_norm:
            q = head_rms_norm(q, p["q_norm"])
            k = head_rms_norm(k, p["k_norm"])
        if md.get("rope", True) and kx is None:
            ang = rope_angles(md["positions"], dh, cfg.rope_theta, cfg.mrope_sections)
            q = apply_rope(q, ang)
            k = apply_rope(k, ang)

        if cache is None:
            seg, pos = md["segment_ids"], md["abs_positions"]
            collect = md.get("collect_state")
            if kx is not None:
                out = attend(q, k, v, seg, md["cross_segment_ids"], pos, md["cross_positions"],
                             causal=False, window=None, scale=scale)
                new_cache = {"k_const": k, "v_const": v} if collect else None
            else:
                out = attend(q, k, v, seg, seg, pos, pos, causal=causal, window=window,
                             scale=scale)
                new_cache = {"k": k, "v": v, "pos": pos} if collect else None
        else:
            # decode: ring-buffer insert at (position % T). For full-attention
            # layers T == max_len, so slot == position; for sliding-window
            # layers T = min(2 * window, max_len), and a slot is overwritten
            # once its position is out of the window (the mask drops it first)
            idx = md["lengths"]
            if policy.mesh is not None:
                out = sharded_decode(policy, q, k, v, cache, idx, causal=causal, window=window,
                                     scale=scale)
            else:
                rows = torch.arange(B, device=x.device)
                slot = idx % cache["k"].shape[1]
                cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
                cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
                cache["pos"][rows, slot] = idx.to(torch.int32)
                pos_arr = cache["pos"]  # -1: an empty slot
                out = _decode_attend(q, cache["k"], cache["v"], (pos_arr >= 0).to(torch.int32),
                                     pos_arr.clamp_min(0), idx, causal=causal, window=window,
                                     scale=scale)
            new_cache = cache

    out = policy.constrain(out, "batch", "seq", "heads", "head_dim")
    y = out.reshape(B, S, H * dh) @ policy.gathered(p["wo"].reshape(H * dh, D)).to(x.dtype)
    return y, new_cache
