"""Serve and prefill step builders (counterpart of `repro.train.train_step`).

The training step comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import prefill_forward, serve_forward


def build_serve_step(cfg, *, sample="greedy", compute_dtype=torch.bfloat16):
    """serve_step(params, cache, batch) -> (next_tokens, logits, cache)."""
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
