"""On the card: the Hopper packed flash attention kernel against its plain
PyTorch version, and the port's reduced model on the card against itself on
the CPU. Every case is marked `gpu` and skips without a CUDA card. This file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.kernels.packed_flash_attn import packed_flash_attention
from repro_torch.kernels.ref import packed_attention_ref
from repro_torch.models.model import forward_train, init_params, loss_fn

from conftest import make_packed
from torch_helpers import cuda, n, t  # noqa: F401

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _args(rng, device, B, S, H, K, dh, dtype, doc_lens=None):
    q, k, v = (t(rng.normal(size=(B, S, h, dh)).astype(np.float32)).to(device, TDT[dtype])
               for h in (H, K, K))
    seg, pos = make_packed(rng, B, S, doc_lens=doc_lens)
    seg, pos = t(seg).to(device), t(pos).to(device)
    return q, k, v, seg, seg, pos, pos


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,K,dh", [
    (128, 4, 4, 32),    # MHA
    (128, 4, 2, 32),    # GQA 2:1
    (256, 8, 1, 16),    # MQA
    (192, 4, 4, 64),    # ragged tile count
    (200, 4, 2, 128),   # ragged edge inside a tile, qwen3 head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernel_matches_plain(cuda, rng, S, H, K, dh, dtype):
    args = _args(rng, cuda, 2, S, H, K, dh, dtype)
    before = packed_flash_attention.launches
    out = packed_flash_attention(*args, causal=True)
    torch.cuda.synchronize()
    assert packed_flash_attention.launches == before + 1
    ref = packed_attention_ref(*args, causal=True)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 64, None])
def test_gpu_kernel_window_and_padding_rows(cuda, rng, window):
    B, S, H, dh = 1, 64, 2, 16
    q, k, v, *_ = _args(rng, cuda, B, S, H, H, dh, "float32")
    seg = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    seg[:, :40] = 1
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None] * (seg > 0)
    args = (q, k, v, seg, seg, pos.to(torch.int32), pos.to(torch.int32))
    out = packed_flash_attention(*args, causal=True, window=window)
    ref = packed_attention_ref(*args, causal=True, window=window)
    assert bool((out[:, 40:] == 0).all())
    np.testing.assert_allclose(n(out), n(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_gpu_kernel_refuses_what_it_does_not_take(cuda, rng):
    q, k, v, *rest = _args(rng, cuda, 1, 64, 2, 2, 16, "float32")
    with pytest.raises(TypeError):
        packed_flash_attention(q.half(), k.half(), v.half(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        packed_flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, *rest)
    with pytest.raises(ValueError, match="head_dim"):
        packed_flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                               v[..., :8].contiguous(), *rest)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
def test_gpu_reduced_model_matches_cpu(cuda):
    """Reduced qwen3-8b in float32: the card (kernel) against the CPU (plain)."""
    cfg = reduced(get_arch("qwen3-8b"))
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = SyntheticPackedDataset(cfg, 64, 2, seed=0, mu=3.2, sigma=0.8).batch_at(0)
    cpu_b = {k: t(v) for k, v in batch.items()}
    gpu_b = {k: v.to(cuda) for k, v in cpu_b.items()}
    gpu_p = _to(params, cuda)
    before = packed_flash_attention.launches
    loss_gpu, _ = loss_fn(cfg, gpu_p, gpu_b, compute_dtype=torch.float32)
    assert packed_flash_attention.launches == before + cfg.n_layers
    loss_cpu, _ = loss_fn(cfg, params, cpu_b, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), atol=1e-4, rtol=1e-4)
    logits_gpu, _ = forward_train(cfg, gpu_p, gpu_b, compute_dtype=torch.float32)
    logits_cpu, _ = forward_train(cfg, params, cpu_b, compute_dtype=torch.float32)
    valid = batch["segment_ids"] != 0
    np.testing.assert_allclose(n(logits_gpu)[valid], n(logits_cpu)[valid], atol=1e-4, rtol=1e-4)
