"""Train, serve and prefill step builders (counterpart of `repro.train.train_step`).

train_step: micro-batched gradient accumulation, global-norm clipping,
optimizer update. Mixed precision as the reference: fp32 master parameters,
bf16 compute, fp32 gradients, accumulated over micro-batches in fp32 or, by
the reference's `accum_dtype`, in bf16 (`_Accumulator`). Under a
`ShardingPolicy` with a mesh the train
state is DTensors placed by the reference's rules (`sharding_for_state`),
each micro-batch is split over the dp axes (`batch_spec`), and the forward,
the loss, the clip and the optimizer's in-place update act on DTensors;
every family trains and serves so (the dense, MoE, VLM, encoder-decoder,
recurrent and hybrid ones). The reference's `use_scan` and
`flash_chunk` have no counterpart here (the attention kernel takes every
length).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.model import (
    init_params,
    loss_fn,
    param_axes,
    prefill_forward,
    serve_forward,
)
from repro_torch.parallel.sharding import NULL_POLICY, tree_map_axes
from repro_torch.train.optimizer import tree_leaves, tree_map


def init_train_state(seed, cfg, optimizer, *, device="cuda", policy=NULL_POLICY):
    """{"params": fp32 masters from `seed` (requiring grad), "opt", "step"}.

    The optimizer state groups the layers of each period position as the
    reference's scan-layout train state stacks them (Adafactor's factoring
    and clip act per stack; `train.optimizer`). Under a policy with a mesh
    the parameters and the optimizer state are DTensors placed by
    `sharding_for_state` (every rank builds the whole state from the seed,
    then keeps its shards); the step stays a plain tensor. On
    `device="meta"` the state holds shapes only."""
    params = init_params(cfg, seed, dtype=torch.float32, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": optimizer.init(params, period=len(cfg.period)),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return place_state(policy, cfg, optimizer, state)


def opt_axes(cfg, optimizer, params_axes):
    """The logical axes of `optimizer.init(params, period=P)`'s state. AdamW's
    `m` and `v` and Adafactor's `m` mirror the parameters; Adafactor's
    statistics drop an axis as the reference's (`vr` the last, `vc` the one
    before it), and those of `layers` (and `enc_layers`) are stacked per
    period position, their axes ("layers",) + a layer's: "layers" maps to no
    mesh axis."""
    if optimizer.name == "adamw":
        return {"m": params_axes, "v": params_axes}

    def v_axes(ax):
        if len(ax) >= 2:
            return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        return {"v": ax}

    def of(key, tree):
        P = {"layers": len(cfg.period), "enc_layers": 1}.get(key)
        if P is None:
            return tree_map_axes(v_axes, tree)
        return tuple(tree_map_axes(lambda ax: v_axes(("layers",) + ax), tree[pos])
                     for pos in range(P))
    return {"m": params_axes, "v": {k: of(k, v) for k, v in params_axes.items()}}


def state_axes(cfg, optimizer):
    """(state shapes on the meta device, logical-axes tree of the state);
    the step's axes are ()."""
    state = init_train_state(0, cfg, optimizer, device="meta")
    pax = param_axes(cfg)
    return state, {"params": pax, "opt": opt_axes(cfg, optimizer, pax), "step": ()}


def sharding_for_state(policy, cfg, optimizer):
    """(placements tree of the state (None without a mesh), state shapes on
    the meta device, axes tree): the reference's `sharding_for_state`."""
    shapes, axes = state_axes(cfg, optimizer)

    def place(ax, s):
        return policy.placements_for(ax, tuple(s.shape)) if policy.mesh is not None else None
    return tree_map_axes(place, axes, shapes), shapes, axes


def place_state(policy, cfg, optimizer, state):
    """The whole train state (the same on every rank) placed by
    `sharding_for_state`: its parameters and optimizer state as DTensors,
    the step plain. Without a mesh, `state` itself."""
    if policy.mesh is None:
        return state
    from torch.distributed.tensor import distribute_tensor

    def place(tree, placements):
        if isinstance(tree, torch.Tensor):
            d = distribute_tensor(tree.detach(), policy.mesh, placements)
            return d.requires_grad_(tree.requires_grad)
        if isinstance(tree, dict):
            return {k: place(v, placements[k]) for k, v in tree.items()}
        return type(tree)(place(v, pl) for v, pl in zip(tree, placements, strict=True))
    placements = sharding_for_state(policy, cfg, optimizer)[0]
    return {"params": place(state["params"], placements["params"]),
            "opt": place(state["opt"], placements["opt"]), "step": state["step"]}


def global_norm(tree):
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


class _Accumulator:
    """The reference's accumulation in `accum_dtype` (its `accum` scan):
    each micro-batch's gradient of a leaf, formed in fp32, is rounded to
    `accum_dtype` and added into that leaf's accumulator as soon as
    autograd has formed it (a post-accumulate hook, which then drops the
    fp32 gradient: at most one leaf's exists at a time); `finish` divides
    each sum by the micro-batch count in `accum_dtype` and leaves it in
    `.grad` as fp32, one leaf at a time. Under a mesh each micro-batch's
    gradient is placed as its parameter (its partial sums reduced in fp32)
    before it is rounded."""

    def __init__(self, leaves, dtype, sharded):
        self.leaves, self.dtype, self.sharded = leaves, dtype, sharded
        self.sums = [None] * len(leaves)
        self.hooks = [p.register_post_accumulate_grad_hook(self._add(i))
                      for i, p in enumerate(leaves)]

    def _add(self, i):
        def hook(p):
            g = p.grad
            if self.sharded:
                g = g.redistribute(p.device_mesh, p.placements)
            g = g.to(self.dtype)
            self.sums[i] = g if self.sums[i] is None else self.sums[i].add_(g)
            p.grad = None
        return hook

    def remove(self):
        for handle in self.hooks:
            handle.remove()

    def finish(self, microbatches):
        for i, p in enumerate(self.leaves):
            total, self.sums[i] = self.sums[i], None
            p.grad = (total / microbatches).float()


def build_train_step(cfg, optimizer, *, policy=NULL_POLICY, microbatches=1, remat=True,
                     clip_norm=1.0, compute_dtype=torch.bfloat16, accum_dtype=torch.float32):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    parameters and optimizer state are updated in place. Under a policy
    with a mesh the state is `init_train_state(..., policy=policy)`'s, every
    rank passes the whole global batch, and the metrics come back as full
    (replicated) tensors. `accum_dtype` is the gradients' type across
    micro-batches: float32 accumulates the mean's gradient into fp32
    `.grad` (each micro-batch's loss scaled by 1 / microbatches, equal to
    the reference's sum-then-divide up to rounding); any other type
    follows the reference's order exactly (`_Accumulator`)."""
    sharded = policy.mesh is not None
    if sharded:
        from torch.distributed.tensor import DTensor
    replicating = _replicating(policy)

    def train_step(state, batch):
        params = state["params"]
        B = batch["labels"].shape[0]  # every family's batch has labels
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} micro-batches")
        n = B // microbatches
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss_sum = ntokens = 0.0
        with replicating():
            accum = None if accum_dtype == torch.float32 else _Accumulator(leaves, accum_dtype,
                                                                            sharded)
            try:
                for i in range(microbatches):
                    mb = policy.distribute_batch({k: v[i * n:(i + 1) * n]
                                                  for k, v in batch.items()})
                    total, metrics = loss_fn(cfg, params, mb, remat=remat,
                                             compute_dtype=compute_dtype, policy=policy)
                    if accum is None:
                        (total / microbatches).backward()  # the mean's gradient, into fp32 .grad
                    else:
                        total.backward()  # into the accumulators, by the hooks
                    loss_sum = loss_sum + total.detach()
                    ntokens = ntokens + metrics["ntokens"]
            finally:
                if accum is not None:
                    accum.remove()
            if accum is not None:
                accum.finish(microbatches)
            elif sharded:  # each gradient placed as its parameter (its partial sums reduced)
                for p in leaves:
                    p.grad = p.grad.redistribute(p.device_mesh, p.placements)
            grads = tree_map(lambda p: p.grad, params)
            with torch.no_grad():
                gnorm = global_norm(grads)
                scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                for g in tree_leaves(grads):
                    g.mul_(scale)
            optimizer.update(grads, state["opt"], params, state["step"])
        state["step"] += 1
        metrics = {"loss": loss_sum / microbatches, "grad_norm": gnorm, "ntokens": ntokens}
        if sharded:
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return state, metrics

    return train_step


def _replicating(policy):
    """Under a mesh, the model's own plain tensors (position rows, masks)
    count as replicated."""
    if policy.mesh is None:
        return contextlib.nullcontext
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication


def build_serve_step(cfg, *, sample="greedy", compute_dtype=torch.bfloat16,
                     policy=NULL_POLICY):
    """serve_step(params, cache, batch) -> (next_tokens, logits, cache). The
    cache (`init_cache`/`extend_cache`) may mix the rings of sliding-window
    layers with the full caches of global ones. Under a policy with a mesh
    the parameters are DTensors placed by the sharding rules, the cache is placed by
    `launch.specs.cache_shardings` (`launch.specs.place_cache`), the batch by
    `distribute_batch`, and each rank writes and attends its own part of the
    cache (`models.attention.sharded_decode`; an encoder-decoder's constant
    cross cache, read only, `models.attention.sharded_cross_decode`); a
    recurrent layer's state steps on the DTensors."""
    if sample != "greedy":
        raise ValueError(f"sampling '{sample}' is not supported; only 'greedy'")
    replicating = _replicating(policy)

    def serve_step(params, cache, batch):
        with replicating():
            logits, cache = serve_forward(cfg, params, cache, batch,
                                          compute_dtype=compute_dtype, policy=policy)
            # whole rows of the last logits on every rank of a mesh: argmax reads them
            last = policy.constrain(logits[:, -1], "batch", None)
            next_tokens = last.argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def build_prefill_step(cfg, *, compute_dtype=torch.bfloat16, policy=NULL_POLICY):
    """prefill_step(params, batch) -> (last_logits, caches); under a policy
    with a mesh, through `attention.sharded_packed_attention` and the
    recurrences' local scans as training, the caches DTensors."""
    replicating = _replicating(policy)

    def prefill_step(params, batch):
        with replicating():
            return prefill_forward(cfg, params, batch, compute_dtype=compute_dtype,
                                   policy=policy)

    return prefill_step
