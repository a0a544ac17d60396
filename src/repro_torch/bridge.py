"""Carry parameters and caches from the reference package's layout to the port's.

Input trees are nested dicts, lists and tuples of numpy arrays, as a caller
gets from the reference's `split_annotations(stacked_init(...))[0]`, its list
layout `split_annotations(init_params(...))[0]` (what its pipeline engine
holds; a tied tree has no `lm_head`), its optimizer state or its decode
cache (a sliding-window layer's cache is its ring), by converting every leaf
with `np.asarray`; this module never imports jax. The reference's scan layout
stacks layers per period position (a tuple: `layers[pos][...][j]` is layer
j * P + pos); its list layout, like the port, keeps one dict per layer. An
encoder-decoder's `enc_layers` are laid out the same way, at a period of one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import param_dtype


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy extension type; torch cannot read it
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _map(fn, tree, key=None):
    """fn(leaf, key of the leaf in its dict) over a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(tree, key)


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
            layers[j * P + pos] = _map(lambda a, key: fn(np.asarray(a)[j], key), stacked[pos])
    return layers


def _layers(layers, fn):
    if isinstance(layers, list):  # list layout: one tree per layer
        return [_map(fn, layer) for layer in layers]
    return _unstack(layers, fn)


LAYER_KEYS = ("layers", "enc_layers")  # the trees of per-layer parameters


def params_from_jax(tree, *, dtype=torch.bfloat16, device="cuda"):
    """Reference parameters (scan or list layout) -> port parameters, each
    in the dtype `init_params` stores it in (`layers.param_dtype`): matrices
    in `dtype`; 1-D weights (norms, biases) and the parameters the reference
    uses in float32 only (`layers.FP32_PARAMS`: A_log, r_g, b_g) in float32."""
    def conv(a, key):
        return _tensor(a, device, param_dtype(key, np.ndim(a), dtype))

    return {k: _layers(v, conv) if k in LAYER_KEYS else conv(v, k) for k, v in tree.items()}


def _is_vstate(tree):
    return isinstance(tree, dict) and set(tree) in ({"v"}, {"vr", "vc"}) and not any(
        isinstance(x, dict) for x in tree.values())


def _stacked_vstates(stacked, fn):
    """Adafactor's statistics of the scan layout, kept stacked (the port's
    `init(params, period)` layout); raises where a stack's statistics do not
    have the factored shapes of one leading layer axis."""
    n = _leading_dim(stacked[0])

    def conv(v):
        if not _is_vstate(v):
            return {k: conv(x) for k, x in v.items()}
        shapes = {k: np.shape(x) for k, x in v.items()}
        if "v" in v or len(shapes["vr"]) < 1 or shapes["vr"][0] != n or (
                len(shapes["vr"]) >= 2 and shapes["vc"][0] != n):
            raise ValueError(f"Adafactor statistics {shapes} do not factor a stack of {n} "
                             "layers; the port's stacked state cannot take them")
        return {k: fn(np.asarray(x)) for k, x in v.items()}

    return tuple(conv(s) for s in stacked)


def opt_state_from_jax(state, *, device="cuda"):
    """Reference optimizer state -> the port's, dtypes kept: AdamW's
    {"m", "v"} or Adafactor's {"m", "v"} with, per parameter, {"v"} or the
    factored {"vr", "vc"}; each a tree of the parameters' structure (scan or
    list layout). `m` and AdamW's `v` go per layer. Adafactor's statistics of
    a stack cannot be split into per-layer statistics (a stacked (n, D) norm
    weight has one `vc` (D,) for all n layers), so in the scan layout they
    stay stacked: the state of the port's spmd Adafactor
    (`optimizer.init(params, period)`). A list-layout state (the reference's
    pipeline engine) converts layer by layer."""
    def conv(a, key=None):
        return _tensor(a, device)

    def layers(name, v):
        if name == "v" and not isinstance(v, list) and _is_factored(v):
            return _stacked_vstates(v, conv)
        return _layers(v, conv)

    return {name: {k: (layers(name, v) if k in LAYER_KEYS else _map(conv, v))
                   for k, v in tree.items()}
            for name, tree in state.items()}


def _is_factored(tree):
    """Whether a state tree holds Adafactor statistics ({"v"} / {"vr", "vc"})."""
    if isinstance(tree, (list, tuple)):
        return any(_is_factored(x) for x in tree)
    return isinstance(tree, dict) and (_is_vstate(tree) or any(_is_factored(x)
                                                                for x in tree.values()))


def cache_from_jax(tree, *, device="cuda"):
    """Reference decode cache (scan layout) -> per-layer list, dtypes kept;
    an encoder-decoder's layers keep their "cross" K/V beside "mixer"."""
    return _unstack(tree, lambda a, key: _tensor(a, device))
