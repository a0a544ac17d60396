"""Carry parameters and caches from the reference package's layout to the port's.

Input trees are nested dicts, lists and tuples of numpy arrays, as a caller
gets from the reference's `split_annotations(stacked_init(...))[0]`, its list
layout `split_annotations(init_params(...))[0]` (what its pipeline engine
holds), its optimizer state or its decode cache, by converting every leaf
with `np.asarray`; this module never imports jax. The reference's scan layout
stacks layers per period position (a tuple: `layers[pos][...][j]` is layer
j * P + pos); its list layout, like the port, keeps one dict per layer.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy extension type; torch cannot read it
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leading_dim(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _unstack(stacked, fn):
    """Scan layout (tuple over period positions of stacked trees) -> list."""
    P = len(stacked)
    n = _leading_dim(stacked[0])
    layers = [None] * (n * P)
    for pos in range(P):
        for j in range(n):
            layers[j * P + pos] = _map(lambda a: fn(np.asarray(a)[j]), stacked[pos])
    return layers


def _layers(layers, fn):
    if isinstance(layers, list):  # list layout: one tree per layer
        return [_map(fn, layer) for layer in layers]
    return _unstack(layers, fn)


def params_from_jax(tree, *, dtype=torch.bfloat16, device="cuda"):
    """Reference parameters (scan or list layout) -> port parameters:
    matrices in `dtype`, 1-D weights (norms) in float32."""
    def conv(a):
        return _tensor(a, device, dtype if np.ndim(a) >= 2 else torch.float32)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = _layers(tree["layers"], conv)
    return out


def opt_state_from_jax(state, *, device="cuda"):
    """Reference optimizer state -> the port's, dtypes kept: AdamW's
    {"m", "v"} or Adafactor's {"m", "v"} with, per parameter, {"v"} or the
    factored {"vr", "vc"}; each a tree of the parameters' structure (scan or
    list layout)."""
    def conv(a):
        return _tensor(a, device)

    return {name: {k: (_layers(v, conv) if k == "layers" else _map(conv, v))
                   for k, v in tree.items()}
            for name, tree in state.items()}


def cache_from_jax(tree, *, device="cuda"):
    """Reference decode cache (scan layout) -> per-layer list, dtypes kept."""
    return _unstack(tree, lambda a: _tensor(a, device))
