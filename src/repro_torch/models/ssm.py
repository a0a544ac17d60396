"""Mamba-1 selective SSM block (jamba's hybrid layers), as `repro.models.ssm`.

Training and prefill run the projections as batched products over the
whole sequence, then a Python loop over positions carrying h (B, d_inner, N)
in float32, reset at packed-document starts; this loop is the reference's
per-step `lax.scan`. What does not depend on h is computed before the loop,
over every position, in blocks of positions that bound its memory: the decay
exp(dt·A), zeroed at a document start (for keep ∈ {0, 1} the same numbers
as the reference's `h·decay·keep`), and the input (dt·xc)·B; these are the
reference's elementwise float32 operations, so the loop is left one
multiply, one add and one product with C a position (three launches).
Decode keeps a (conv window, ssm state) cache and costs O(1) a token.

Under a `ShardingPolicy` with a mesh the projections are DTensor products
(the weights' FSDP shards gathered), and the causal conv and the scan run
on each rank's local shards (`ShardingPolicy.run_local`): its rows (batch
over dp) and its inner channels (d_inner over tp, where it divides). The
scan is exact so split: each channel's state is its own, and y = h·C sums
over N only; B and C, sums over d_inner, reach it whole over tp. The
sequence is never split inside it. Decode runs on the DTensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, doc_keep, local_conv1d
from repro_torch.parallel.sharding import NULL_POLICY, placed_as
from repro_torch.roofline.counter import scan

# elements of one block of the hoisted (B, positions, d_inner, N) terms: 512 MiB in float32
SCAN_BLOCK_ELEMENTS = 1 << 27


def dt_rank(cfg):
    return math.ceil(cfg.d_model / 16)


def init_mamba(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    """The reference's keys, shapes and law; `A_log` stays float32 (see
    `layers.FP32_PARAMS`), the one-axis weights too."""
    D, di, N, K = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    R = dt_rank(cfg)
    kw = dict(dtype=dtype, device=device)

    def vec(value):
        return torch.full((di,), value, dtype=torch.float32, device=device)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(di, N)
    return {
        "w_x": dense_init(generator, (D, di), **kw),
        "w_z": dense_init(generator, (D, di), **kw),
        "conv_w": dense_init(generator, (di, K), **kw),
        "conv_b": vec(0.0),
        "w_dt": dense_init(generator, (di, R), **kw),
        "dt_proj": dense_init(generator, (R, di), **kw),
        "dt_bias": vec(-4.6),  # softplus ~0.01
        "w_B": dense_init(generator, (di, N), **kw),
        "w_C": dense_init(generator, (di, N), **kw),
        "A_log": torch.log(A).contiguous(),
        "D_skip": vec(1.0),
        "w_out": dense_init(generator, (di, D), **kw),
    }


def mamba_axes(cfg):
    return {"w_x": ("dmodel", "dinner"), "w_z": ("dmodel", "dinner"), "conv_w": ("dinner", None),
            "conv_b": ("dinner",), "w_dt": ("dinner", None), "dt_proj": (None, "dinner"),
            "dt_bias": ("dinner",), "w_B": ("dinner", None), "w_C": ("dinner", None),
            "A_log": ("dinner", None), "D_skip": ("dinner",), "w_out": ("dinner", "dmodel")}


def _ssm_inputs(p, xc, dtype, policy):
    """dt (softplus, float32), B and C (float32) of the conv output xc; the
    weights cast to the compute dtype, then to xc's (float32 in a decode
    step over a float32 conv window, as the reference promotes)."""
    def w(name):
        return policy.gathered(p[name]).to(dtype).to(xc.dtype)
    dt = F.softplus(((xc @ w("w_dt")) @ w("dt_proj")).float() + p["dt_bias"])
    return dt, (xc @ w("w_B")).float(), (xc @ w("w_C")).float()


def _projections(cfg, p, x, segment_ids, policy):
    dtype = x.dtype
    xin = x @ policy.gathered(p["w_x"]).to(dtype)
    z = x @ policy.gathered(p["w_z"]).to(dtype)
    xc = F.silu(local_conv1d(policy, xin, p["conv_w"].to(dtype), p["conv_b"].to(dtype),
                             segment_ids))
    return (xin, z, xc, *_ssm_inputs(p, xc, dtype, policy))


def _mamba_step(h, decay_t, inp_t, c_t):
    h = h * decay_t + inp_t
    return h, torch.bmm(h, c_t)


def selective_scan(A, dt, Bm, Cm, xc, keep):
    """h_t = exp(dt_t·A)·keep_t·h_{t-1} + (dt_t·xc_t)·B_t from h = 0; y_t = h_t·C_t.

    A (di, N); dt, xc (B,S,di) float32; Bm, Cm (B,S,N) float32; keep (B,S)
    float32, 0 where a document starts (folded into the decay as
    exp(dt·A + log keep): exp(-inf) is 0). Returns (y (B,S,di), h_S (B,di,N)).
    A block's terms go to the loop by `unbind`, whose backward stacks the
    positions' gradients once (indexing a position would allocate a
    gradient of the whole block for every position).
    """
    B, S, di = dt.shape
    N = A.shape[-1]
    block = max(1, min(S, SCAN_BLOCK_ELEMENTS // max(B * di * N, 1)))
    log_keep = keep.log()[..., None, None]
    Ccols = Cm[..., None].unbind(1)  # a position's C as a (B,N,1) column for bmm
    h = torch.zeros((B, di, N), dtype=torch.float32, device=dt.device)
    ys = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        decay = torch.exp(dt[:, s0:s1, :, None] * A + log_keep[:, s0:s1])
        inp = (dt[:, s0:s1] * xc[:, s0:s1])[..., None] * Bm[:, s0:s1, None, :]
        h, y = scan(_mamba_step, h, (decay.unbind(1), inp.unbind(1), Ccols[s0:s1]))
        ys += y
    return torch.cat(ys, dim=-1).transpose(1, 2), h


def _local_scan(A, dt, Bm, Cm, xc, seg):
    """`selective_scan` on one rank's shards, its keep from the segment ids."""
    return selective_scan(A, dt, Bm, Cm, xc, doc_keep(seg, dt).float())


def mamba(cfg, spec, p, x, md, cache=None, policy=NULL_POLICY):
    """Returns (out (B,S,D), new_cache).

    cache: None for the packed forward and prefill (with md['collect_state'],
    the new cache is {'conv': the last K-1 positions' conv inputs (B,K-1,di),
    'ssm': the state after the last position (B,di,N)}); else that cache,
    and x is one token (B,1,D): the conv reads the window, tap K-1 the
    current step, in the promoted dtype of window and x, as the reference's.
    Under a `policy` with a mesh, x, the weights and the cache are DTensors
    (the module's docstring).
    """
    B, S, D = x.shape
    K, N = cfg.mamba_d_conv, cfg.mamba_d_state
    dtype = x.dtype
    A = -torch.exp(p["A_log"].float())  # (di, N)
    w_out = policy.gathered(p["w_out"]).to(dtype)

    if cache is not None:
        conv_st, h = cache["conv"], cache["ssm"]  # (B,K-1,di), (B,di,N)
        xin = x @ policy.gathered(p["w_x"]).to(dtype)
        z = x @ policy.gathered(p["w_z"]).to(dtype)
        wdt = torch.promote_types(conv_st.dtype, dtype)
        window = torch.cat([conv_st.to(wdt), xin.to(wdt)], dim=1)  # (B,K,di)
        conv_w = p["conv_w"].to(dtype).to(wdt)  # (di,K)
        xc = torch.einsum("bki,ik->bi", window, conv_w) + p["conv_b"].to(dtype).to(wdt)
        xc = F.silu(xc)[:, None]  # (B,1,di)
        dt, Bm, Cm = (t[:, 0] for t in _ssm_inputs(p, xc, dtype, policy))
        decay = torch.exp(dt[..., None] * A)
        xc0 = xc[:, 0].float()
        h = h * decay + (dt * xc0)[..., None] * Bm[:, None, :]
        y = torch.einsum("bin,bn->bi", h, Cm) + p["D_skip"] * xc0
        y = (y.to(dtype) * F.silu(z[:, 0]))[:, None]
        return y @ w_out, placed_as({"conv": window[:, 1:], "ssm": h}, cache)

    seg = md.get("segment_ids")
    xin, z, xc, dt, Bm, Cm = _projections(cfg, p, x, seg, policy)
    xcf = xc.float()
    di = xcf.shape[-1]
    rows, inner = ("batch", None, "dinner"), ("batch", None, None)
    ys, h_last = policy.run_local(
        _local_scan, (("dinner", None), rows, inner, inner, rows, ("batch", None)),
        ((rows, (B, S, di)), (("batch", "dinner", None), (B, di, N))), A, dt, Bm, Cm, xcf, seg)
    y = ys + p["D_skip"] * xcf
    y = policy.constrain(y.to(dtype) * F.silu(z), "batch", "seq", "dinner")
    out = y @ w_out
    new_cache = {"conv": xin[:, -(K - 1):], "ssm": h_last} if md.get("collect_state") else None
    return out, new_cache


def init_mamba_cache(cfg, batch, dtype=torch.float32, device="cuda"):
    di, N, K = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, N), dtype=torch.float32, device=device)}
