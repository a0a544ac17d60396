"""Meta-device input stand-ins and their placements for every (arch x shape) cell.

Counterpart of `repro.launch.specs`. No allocation: every spec is a tensor
on the meta device with the reference's shape and dtype (its
`ShapeDtypeStruct`). Where the reference returns a `NamedSharding`, the
`*_shardings` functions here return its spec as a tuple (`ShardingPolicy.
spec_for`'s form: per dim None, a mesh axis or a tuple of axes), and
`input_specs` returns DTensor placements, as the port's sharded steps take
them. The port keeps a list of layers where the reference stacks them
(scan layout), so a layer's parameter or cache spec is the reference's
without its leading "layers" entry, which is never sharded.

Used by the dry-run (`launch.dryrun`).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import init_cache, init_params, param_axes
from repro_torch.train.optimizer import tree_map

S32 = torch.int32


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, shape, *, with_labels=True):
    GB, S = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        Sd = max(S // cfg.dec_ratio, 16)
        b = {
            "frame_embeds": _sds((GB, S, cfg.d_model), torch.bfloat16),
            "enc_segment_ids": _sds((GB, S), S32),
            "enc_positions": _sds((GB, S), S32),
            "dec_tokens": _sds((GB, Sd), S32),
            "dec_segment_ids": _sds((GB, Sd), S32),
            "dec_positions": _sds((GB, Sd), S32),
        }
        if with_labels:
            b["labels"] = _sds((GB, Sd), S32)
        return b
    b = {
        "tokens": _sds((GB, S), S32),
        "segment_ids": _sds((GB, S), S32),
        "positions": _sds((GB, S, 3), S32) if cfg.mrope_sections else _sds((GB, S), S32),
    }
    if cfg.vlm:
        b["vision_embeds"] = _sds((GB, S // 4, cfg.d_model), torch.bfloat16)
    if with_labels:
        b["labels"] = _sds((GB, S), S32)
    return b


def decode_batch_specs(cfg, shape):
    GB, S = shape.global_batch, shape.seq_len
    b = {"tokens": _sds((GB, 1), S32), "lengths": _sds((GB,), S32)}
    if cfg.enc_dec:
        b["cross_segment_ids"] = _sds((GB, S), S32)
        b["cross_positions"] = _sds((GB, S), S32)
    return b


def batch_shardings(policy, batch_specs):
    """Shard dim 0 (global batch) over the DP axes."""
    if policy.mesh is None:
        return None
    bspec = policy.batch_spec()
    return {k: bspec + (None,) * (s.dim() - len(bspec)) for k, s in batch_specs.items()}


# ------------------------------------------------------------------ caches
# the reference's `_CACHE_AXES` without its leading "layers" (one dict a layer here)
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "pos": ("batch", "kv_seq"),
    "k_const": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v_const": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "conv": ("batch", None, "dinner"),
    "ssm": ("batch", "dinner", None),
    "C": ("batch", "heads", None, "head_dim"),
    "n": ("batch", "heads", "head_dim"),
    "m": ("batch", "heads"),
    "c": ("batch", "heads", "head_dim"),
    "h": ("batch", "heads", "head_dim"),
}


def cache_specs(cfg, shape, cache_dtype=torch.bfloat16):
    cross = shape.seq_len if cfg.enc_dec else 0
    return init_cache(cfg, shape.global_batch, shape.seq_len, cache_dtype, device="meta",
                      cross_len=cross)


def cache_axes(cache):
    """The logical axes of every leaf of a decode cache (`init_cache`'s tree),
    by its key, cut or padded with None to the leaf's rank."""
    def of(key, leaf):
        axes = _CACHE_AXES.get(key, ())[:leaf.dim()]
        return axes + (None,) * (leaf.dim() - len(axes))
    if isinstance(cache, dict):
        return {k: of(k, v) if isinstance(v, torch.Tensor) else cache_axes(v)
                for k, v in cache.items()}
    return [cache_axes(c) for c in cache]


def cache_shardings(policy, cache_s):
    if policy.mesh is None:
        return None
    return policy.tree_specs(cache_axes(cache_s), cache_s)


def serve_param_specs(cfg, dtype=torch.bfloat16):
    """Inference params (every leaf in `dtype`) on the meta device + logical axes."""
    params = init_params(cfg, dtype=dtype, device="meta")
    return tree_map(lambda t: t.to(dtype), params), param_axes(cfg)


def param_shardings(policy, params_s, axes):
    if policy.mesh is None:
        return None
    return policy.tree_specs(axes, params_s)


def placements(policy, specs):
    """A tree of specs (`*_shardings`) as DTensor placements; None without a mesh."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: placements(policy, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [placements(policy, v) for v in specs]
    return policy.placements_from_spec(specs)


def input_specs(cfg, shape, policy):
    """Everything the dry-run needs for one cell: (args, placements, optimizer)
    for the step function the cell runs (train_step / prefill_step /
    serve_step); the placements are None without a mesh. The train state's
    placements are `sharding_for_state`'s."""
    from repro_torch.train.optimizer import optimizer_for
    from repro_torch.train.train_step import sharding_for_state

    if shape.kind == "train":
        opt = optimizer_for(cfg)
        state_pl, state_s, _ = sharding_for_state(policy, cfg, opt)
        batch_s = train_batch_specs(cfg, shape)
        batch_pl = placements(policy, batch_shardings(policy, batch_s))
        return (state_s, batch_s), (state_pl, batch_pl), opt
    params_s, axes = serve_param_specs(cfg)
    params_pl = placements(policy, param_shardings(policy, params_s, axes))
    if shape.kind == "prefill":
        batch_s = train_batch_specs(cfg, shape, with_labels=False)
        batch_pl = placements(policy, batch_shardings(policy, batch_s))
        return (params_s, batch_s), (params_pl, batch_pl), None
    cache_s = cache_specs(cfg, shape)
    cache_pl = placements(policy, cache_shardings(policy, cache_s))
    batch_s = decode_batch_specs(cfg, shape)
    batch_pl = placements(policy, batch_shardings(policy, batch_s))
    return (params_s, cache_s, batch_s), (params_pl, cache_pl, batch_pl), None


def place_cache(policy, cache):
    """A decode cache (the same on every rank) placed by `cache_shardings`:
    its leaves as DTensors. Without a mesh, `cache` itself."""
    if policy.mesh is None:
        return cache
    return policy.distribute(cache, cache_axes(cache))

