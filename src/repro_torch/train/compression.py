"""Gradient compression for the slow (cross-node) reduction path: int8 block
quantization with error feedback (counterpart of `repro.train.compression`).

Quantizing a reduce's payload 4x (f32 -> int8 with one f32 scale per block)
cuts the bytes that cross the slow fabric. Error feedback accumulates the
quantization residual locally and re-injects it next step, which keeps SGD
convergence (Karimireddy et al., "Error Feedback Fixes SignSGD").

The codes are the reference's bit for bit: a block's scale is its max |x| /
127 (guarded at 1e-30 where the block is all zero), codes are x / scale
rounded half to even and clipped to ±127, and a tail short of a block is
zero-padded. Plain PyTorch, as the reference's is jnp (no kernel); no train
step calls it, as none of the reference's does.

    comp = Int8Compressor(block=256)
    q, scales, meta = comp.compress(grad + residual)
    # ... reduce the int8 payload + f32 scales over the slow axis ...
    deq = comp.decompress(q, scales, meta)
    new_residual = (grad + residual) - deq
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.train.optimizer import tree_leaves, tree_map


@dataclass(frozen=True)
class Int8Compressor:
    block: int = 256

    def _pad(self, flat):
        pad = (-flat.shape[0]) % self.block
        if pad:
            flat = F.pad(flat, (0, pad))
        return flat, pad

    def compress(self, x):
        """x: any-shape f32/bf16 -> (int8 codes (n_blocks, block), f32 scales
        (n_blocks,), meta (shape, pad))."""
        shape = tuple(x.shape)
        flat, pad = self._pad(x.float().reshape(-1))
        blocks = flat.view(-1, self.block)
        amax = blocks.abs().amax(dim=1)
        # divided by a tensor: on the card a tensor / Python-number division
        # multiplies by the reciprocal, which can round a scale otherwise
        scale = amax / torch.full_like(amax, 127.0)
        safe = scale.clamp_min(1e-30)
        q = torch.round(blocks / safe[:, None]).clamp_(-127, 127).to(torch.int8)
        return q, scale, (shape, pad)

    def decompress(self, q, scale, meta):
        shape, pad = meta
        flat = (q.float() * scale[:, None]).reshape(-1)
        if pad:
            flat = flat[:-pad]
        return flat.reshape(shape)

    def roundtrip_with_feedback(self, grad, residual):
        """One error-feedback step: returns (dequantized, new_residual)."""
        target = grad.float() + residual
        deq = self.decompress(*self.compress(target))
        return deq, target - deq

    def compressed_bytes(self, x) -> int:
        n_blocks = -(-x.numel() // self.block)
        return n_blocks * self.block + 4 * n_blocks  # int8 codes + f32 scales

    def ratio(self, x) -> float:
        return (x.numel() * x.element_size()) / self.compressed_bytes(x)


def init_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_tree(comp: Int8Compressor, grads, residuals):
    """Error-feedback compression over a gradient tree. Returns (dequantized
    grads, new residuals), trees of the grads' structure: the dequantized
    values are what the slow-fabric reduce would carry (int8 + scales on
    the wire)."""
    out = [comp.roundtrip_with_feedback(g, r)
           for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    it = iter(out)
    pairs = tree_map(lambda g: next(it), grads)  # the leaves in tree_leaves' order
    return (tree_map(lambda g, pr: pr[0].to(g.dtype), grads, pairs),
            tree_map(lambda g, pr: pr[1], grads, pairs))
