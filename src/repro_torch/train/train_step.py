"""Train, serve and prefill step builders (counterpart of `repro.train.train_step`).

train_step: micro-batched gradient accumulation, global-norm clipping,
optimizer update. Mixed precision as the reference: fp32 master parameters,
bf16 compute, fp32 gradients. One device; the reference's sharding policy,
`use_scan` and `flash_chunk` have no counterpart here (the attention kernel
takes every length).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import init_params, loss_fn, prefill_forward, serve_forward
from repro_torch.train.optimizer import tree_leaves, tree_map


def init_train_state(seed, cfg, optimizer, *, device="cuda"):
    """{"params": fp32 masters from `seed` (requiring grad), "opt", "step"}.

    The optimizer state groups the layers of each period position as the
    reference's scan-layout train state stacks them (Adafactor's factoring
    and clip act per stack; `train.optimizer`)."""
    params = init_params(cfg, seed, dtype=torch.float32, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params, period=len(cfg.period)),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


def build_train_step(cfg, optimizer, *, microbatches=1, remat=True, clip_norm=1.0,
                     compute_dtype=torch.bfloat16):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    parameters and optimizer state are updated in place."""

    def train_step(state, batch):
        params = state["params"]
        B = batch["labels"].shape[0]  # every family's batch has labels
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} micro-batches")
        n = B // microbatches
        for p in tree_leaves(params):
            p.grad = None
        loss_sum = ntokens = 0.0
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            total, metrics = loss_fn(cfg, params, mb, remat=remat, compute_dtype=compute_dtype)
            (total / microbatches).backward()  # accumulates the mean into fp32 .grad
            loss_sum = loss_sum + total.detach()
            ntokens = ntokens + metrics["ntokens"]
        grads = tree_map(lambda p: p.grad, params)
        with torch.no_grad():
            gnorm = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        optimizer.update(grads, state["opt"], params, state["step"])
        state["step"] += 1
        return state, {"loss": loss_sum / microbatches, "grad_norm": gnorm, "ntokens": ntokens}

    return train_step


def build_serve_step(cfg, *, sample="greedy", compute_dtype=torch.bfloat16):
    """serve_step(params, cache, batch) -> (next_tokens, logits, cache). The
    cache (`init_cache`/`extend_cache`) may mix the rings of sliding-window
    layers with the full caches of global ones."""
    if sample != "greedy":
        raise ValueError(f"sampling '{sample}' is not supported; only 'greedy'")

    def serve_step(params, cache, batch):
        logits, cache = serve_forward(cfg, params, cache, batch, compute_dtype=compute_dtype)
        next_tokens = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def build_prefill_step(cfg, *, compute_dtype=torch.bfloat16):
    """prefill_step(params, batch) -> (last_logits, caches)."""

    def prefill_step(params, batch):
        return prefill_forward(cfg, params, batch, compute_dtype=compute_dtype)

    return prefill_step
