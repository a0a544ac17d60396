"""Dense gated FFN (SwiGLU), as `repro.models.mlp`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import NULL_POLICY


def init_mlp(generator, cfg, *, dtype=torch.bfloat16, device="cuda"):
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(generator, (D, Fd), **kw),
        "w_up": dense_init(generator, (D, Fd), **kw),
        "w_down": dense_init(generator, (Fd, D), **kw),
    }


def mlp_axes(cfg):
    return {"w_gate": ("dmodel", "ffn"), "w_up": ("dmodel", "ffn"), "w_down": ("ffn", "dmodel")}


def mlp(cfg, p, x, policy=NULL_POLICY):
    w_gate, w_up, w_down = (policy.gathered(p[k]) for k in ("w_gate", "w_up", "w_down"))
    h = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = policy.constrain(F.silu(h) * u, "batch", "seq", "ffn")
    return h @ w_down.to(x.dtype)
