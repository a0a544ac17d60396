"""On the card: the Hopper packed flash attention kernels (bf16 on the tensor
cores, fp32 in 3xTF32 on them; the forward's row log-sum-exp; the backward
kernels, bf16 and fp32 alike) against their
plain PyTorch versions, the port's reduced model, train step and pipeline
engine on the card against themselves on the CPU, a checkpoint of card
tensors restored onto the card, and the MoE layer against its CPU path and
against itself, and the recurrent mixers (Mamba, mLSTM, sLSTM) against
their CPU path. Every case is
marked `gpu` and skips without a CUDA card. This file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_arch, reduced
from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.data.synth import SyntheticPackedDataset
import repro_torch.kernels.packed_flash_attn as pfa
from repro_torch.kernels import ops
from repro_torch.kernels.packed_flash_attn import (
    BWD_TF32,
    BWD_SM90,
    BWD_SM90_WIDE,
    FWD_TF32,
    SM90,
    backward_kernel_for,
    packed_flash_attention,
    packed_flash_attention_backward,
)
from repro_torch.kernels.ref import (
    attention_mask,
    packed_attention_ref,
    packed_attention_ref_backward,
)
from repro_torch.engine.pipeline import PipelineEngine
from repro_torch.models.model import forward_train, init_params, loss_fn
from repro_torch.train.optimizer import make_optimizer, tree_leaves
from repro_torch.train.train_step import build_train_step

from conftest import make_packed
from torch_helpers import cross_ids, cuda, n, t  # noqa: F401

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _launches():
    return sum(packed_flash_attention.launches.values())


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
    before = _launches()
    out = packed_flash_attention(*args, causal=True)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    ref = packed_attention_ref(*args, causal=True)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 64, None])
@pytest.mark.parametrize("S,dh,valid", [(64, 16, 40), (300, 128, 260)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernel_window_and_padding_rows(cuda, rng, window, S, dh, valid, dtype):
    """Sliding window, and rows of segment 0 exactly 0, on both kernels."""
    B, H = 1, 2
    q, k, v, *_ = _args(rng, cuda, B, S, H, H, dh, dtype)
    seg = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    seg[:, :valid] = 1
    pos = (torch.arange(S, dtype=torch.int32, device=cuda)[None] * (seg > 0)).to(torch.int32)
    args = (q, k, v, seg, seg, pos, pos)
    out = packed_flash_attention(*args, causal=True, window=window)
    ref = packed_attention_ref(*args, causal=True, window=window)
    assert bool((out[:, valid:] == 0).all())
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernel_window_across_position_resets(cuda, rng, dtype):
    """A sliding window over a key tile that holds a document start and
    padding (position 0) next to late positions: no visible pair is lost."""
    S = 1000
    q, k, v, *_ = _args(rng, cuda, 2, S, 4, 2, 64, dtype)
    seg = torch.ones((2, S), dtype=torch.int32, device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(2, 1)
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    args = (q, k, v, seg, seg, pos, pos)
    out = packed_flash_attention(*args, causal=True, window=256)
    ref = packed_attention_ref(*args, causal=True, window=256)
    assert bool((out[1, 900:] == 0).all())
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("doc_lens", [[1024], [100, 300, 24, 600]])
def test_gpu_kernel_qwen3_shape_bf16(cuda, rng, doc_lens):
    """qwen3-8b widths (H=32, K=8, dh=128) at S=1024: one document, several."""
    args = _args(rng, cuda, 2, 1024, 32, 8, 128, "bfloat16", doc_lens=doc_lens)
    out = packed_flash_attention(*args, causal=True)
    ref = packed_attention_ref(*args, causal=True)
    np.testing.assert_allclose(n(out), n(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [200, 333])
@pytest.mark.parametrize("dh", [32, 80, 128])
def test_gpu_kernel_ragged_bf16(cuda, rng, S, dh):
    """Lengths that are no tile multiple: TMA zero-fills the ragged edge of
    the tensor-core kernel's tiles."""
    args = _args(rng, cuda, 2, S, 8, 2, dh, "bfloat16")
    out = packed_flash_attention(*args, causal=True)
    ref = packed_attention_ref(*args, causal=True)
    np.testing.assert_allclose(n(out), n(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_gpu_launch_counts_by_dtype(cuda, rng):
    """A bf16 call launches the wgmma kernel once, an fp32 call the 3xTF32
    kernel once; each raises its own source's count by one."""
    for dtype, kern in (("bfloat16", SM90), ("float32", FWD_TF32)):
        args = _args(rng, cuda, 1, 128, 4, 2, 64, dtype)
        before = dict(packed_flash_attention.launches)
        packed_flash_attention(*args, causal=True)
        torch.cuda.synchronize()
        after = packed_flash_attention.launches
        assert {s: after[s] - before[s] for s in after} == {
            s: int(s == kern.source) for s in after}


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
    before = _launches()
    loss_gpu, _ = loss_fn(cfg, gpu_p, gpu_b, compute_dtype=torch.float32)
    assert _launches() == before + cfg.n_layers
    loss_cpu, _ = loss_fn(cfg, params, cpu_b, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), atol=1e-4, rtol=1e-4)
    logits_gpu, _ = forward_train(cfg, gpu_p, gpu_b, compute_dtype=torch.float32)
    logits_cpu, _ = forward_train(cfg, params, cpu_b, compute_dtype=torch.float32)
    valid = batch["segment_ids"] != 0
    np.testing.assert_allclose(n(logits_gpu)[valid], n(logits_cpu)[valid], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- backward
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of max |ref|, per tensor


def _check_grads(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(b.float().abs().max()), (name, err)


def _backward_inputs(rng, device, args, dtype, window=None):
    """(d_out, out, lse, kw) of a backward case: the forward kernel's out and lse."""
    q = args[0]
    d_out = t(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(device, TDT[dtype])
    kw = {"causal": True, "window": window}
    out, lse = packed_flash_attention(*args, **kw, return_lse=True)
    return d_out, out, lse, kw


def _backward_case(rng, device, args, dtype, window=None):
    d_out, out, lse, kw = _backward_inputs(rng, device, args, dtype, window)
    before = dict(packed_flash_attention_backward.launches)
    got = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    torch.cuda.synchronize()
    after = packed_flash_attention_backward.launches
    source = backward_kernel_for(TDT[dtype], args[0].shape[-1]).source
    assert {s: after[s] - before[s] for s in after} == {s: int(s == source) for s in after}
    ref = packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw)
    _check_grads(got, ref, dtype)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("S", [200, 333])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_matches_plain(cuda, rng, S, dh, group, dtype):
    """Ragged lengths (no multiple of 64 or 128), several documents per row,
    every head width and GQA group: bf16 through the tensor-core backward,
    fp32 through the 3xTF32 one."""
    K = 2
    _backward_case(rng, cuda, _args(rng, cuda, 2, S, K * group, K, dh, dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_is_deterministic(cuda, rng, dtype):
    """Two launches on the same inputs give bitwise-equal dq, dk and dv (no
    atomics: every gradient element is summed by one thread in one order)."""
    args = _args(rng, cuda, 2, 700, 8, 2, 128, dtype, doc_lens=[100, 300, 24, 276])
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, dtype)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_unmasked_tiles_match_masked(cuda, rng, dtype, monkeypatch):
    """A tile whose every pair is visible (code 2) runs without the mask and
    gives the same gradients, bit for bit, as the same tile with its mask
    forced (every visible tile marked code 1)."""
    args = _args(rng, cuda, 1, 512, 4, 2, 64, dtype, doc_lens=[512])
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, dtype)
    kern = backward_kernel_for(TDT[dtype], 64)
    _, (blk, blk_dq) = pfa.backward_tile_maps(kern, *args[3:], **kw)
    assert bool((blk == 2).any()) and bool((blk_dq == 2).any())
    free = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    tile_map = pfa.tile_map
    monkeypatch.setattr(pfa, "tile_map", lambda *a, **k: tile_map(*a, **k).clamp_(max=1))
    masked = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(free, masked):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_backward_launch_counts_by_source(cuda, rng):
    """A bf16 backward launches the bf16 source once and never the fp32 one;
    an fp32 backward the fp32 (3xTF32) source once."""
    assert packed_flash_attention_backward.launches.keys() == {BWD_SM90.source, BWD_TF32.source}
    for dtype, kern in (("bfloat16", BWD_SM90), ("float32", BWD_TF32)):
        args = _args(rng, cuda, 1, 256, 4, 2, 64, dtype)
        d_out, out, lse, kw = _backward_inputs(rng, cuda, args, dtype)
        before = dict(packed_flash_attention_backward.launches)
        packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
        torch.cuda.synchronize()
        after = packed_flash_attention_backward.launches
        assert {s: after[s] - before[s] for s in after} == {
            s: int(s == kern.source) for s in after}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_window_padding_and_position_resets(cuda, rng, dtype):
    """A window over tiles that hold a document start and padding; rows and
    keys with no visible pair get gradients of exactly 0."""
    S = 1000
    q, k, v, *_ = _args(rng, cuda, 2, S, 4, 2, 64, dtype)
    seg = torch.ones((2, S), dtype=torch.int32, device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(2, 1)
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    dq, dk, dv = _backward_case(rng, cuda, (q, k, v, seg, seg, pos, pos), dtype, window=256)
    for g in (dq, dk, dv):
        assert bool((g[1, 900:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_qwen3_shape(cuda, rng, dtype):
    """qwen3-8b widths (H=32, K=8, dh=128) at S=1024, several documents."""
    args = _args(rng, cuda, 1, 1024, 32, 8, 128, dtype, doc_lens=[100, 300, 24, 600])
    _backward_case(rng, cuda, args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 48])
def test_gpu_forward_lse_is_logsumexp_of_scores(cuda, rng, dtype, window):
    B, S, H, K, dh = 2, 300, 4, 2, 64
    q, k, v, seg, _, pos, _ = _args(rng, cuda, B, S, H, K, dh, dtype)
    seg[:, 260:] = 0  # padding rows: no visible key
    args = (q, k, v, seg, seg, pos, pos)
    out, lse = packed_flash_attention(*args, causal=True, window=window, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, causal=True, window=window)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    mask = attention_mask(seg, seg, pos, pos, causal=True, window=window)[:, None]
    kr = k.float().repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * dh ** -0.5
    ref = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    visible = mask.any(-1).expand_as(ref)
    assert bool(torch.isinf(lse[~visible]).all()) and bool((lse[~visible] > 0).all())
    np.testing.assert_allclose(n(lse[visible]), n(ref[visible]), atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_gpu_raw_kernel_refuses_inputs_that_require_grad(cuda, rng):
    """No silent loss of gradients: the raw wrapper has no autograd graph, so
    it raises; `ops.packed_attention` takes the autograd Function."""
    q, k, v, *rest = _args(rng, cuda, 1, 128, 4, 2, 64, "bfloat16")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        packed_flash_attention(q, k, v, *rest)
    with torch.no_grad():
        packed_flash_attention(q, k, v, *rest)  # no graph needed: runs
    out = ops.packed_attention(q, k, v, *rest)
    out.float().square().sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad.float()).all())


@pytest.mark.gpu
def test_gpu_reduced_train_step_matches_cpu(cuda):
    """One fp32 train step of reduced qwen3-8b (real head width, 2 micro-
    batches, remat): loss, every gradient and every updated parameter on the
    card (forward and backward kernels) against the CPU (plain version)."""
    cfg = reduced(get_arch("qwen3-8b"), head_dim=128)
    batch = SyntheticPackedDataset(cfg, 128, 4, seed=0, mu=3.6, sigma=0.8).batch_at(0)
    results = {}
    for device in ("cpu", cuda):
        params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        params = _to(params, device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = make_optimizer("adamw", lr=1e-3)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        step = build_train_step(cfg, opt, microbatches=2, compute_dtype=torch.float32)
        b = {k: t(v).to(device) for k, v in batch.items()}
        bwd_before = dict(packed_flash_attention_backward.launches)
        state, metrics = step(state, b)
        launches = {s: n_ - bwd_before[s] for s, n_ in packed_flash_attention_backward.launches.items()}
        results[str(device)] = (metrics, [n(p.grad) for p in tree_leaves(params)],
                                [n(p) for p in tree_leaves(params)], launches)
    (m_cpu, g_cpu, p_cpu, l_cpu), (m_gpu, g_gpu, p_gpu, l_gpu) = results.values()
    assert l_cpu == {BWD_SM90.source: 0, BWD_TF32.source: 0}
    assert l_gpu == {BWD_SM90.source: 0, BWD_TF32.source: cfg.n_layers * 2}
    np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m_gpu["grad_norm"]), float(m_cpu["grad_norm"]), rtol=1e-4)
    for a, b in zip(g_gpu, g_cpu):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def _pipeline(device, dtype, cfg=None):
    """A dp2/pp2/tp1 engine on `device` (all plan devices there) with the
    same fp32 weights wherever it runs, and its batch."""
    cfg = cfg or reduced(get_arch("qwen3-8b"), n_layers=4, head_dim=128)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    eng = PipelineEngine(cfg, initial_plan(4, dp=2, pp=2, tp=1, microbatches=2),
                         devices=[device], params=params, compute_dtype=dtype)
    batch = SyntheticPackedDataset(cfg, 128, 4, seed=0, mu=3.6, sigma=0.8).batch_at(0)
    return eng, {k: t(v).to(device) for k, v in batch.items()}


@pytest.mark.gpu
def test_gpu_pipeline_iteration_matches_cpu(cuda):
    """One fp32 pipeline iteration of reduced qwen3-8b (real head width): the
    loss and every replica's and stage's accumulated gradient on the card
    (forward and backward kernels) against the CPU (plain version), 1e-4."""
    out = {}
    for device in ("cpu", cuda):
        eng, batch = _pipeline(device, torch.float32)
        loss, grads = eng.run_iteration(batch)
        out[str(device)] = (loss, {k: [n(g) for g in tree_leaves(v)] for k, v in grads.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out.values()
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert g_cpu.keys() == g_gpu.keys() == {(r, s) for r in range(2) for s in range(2)}
    for key in g_cpu:
        for a, b in zip(g_gpu[key], g_cpu[key]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7


@pytest.mark.gpu
def test_gpu_pipeline_migration_identity(cuda):
    """bf16 on the card: F and B of (mb 0, stage 1, replica 0) run on replica
    1's stage give the same loss (replicas share their parameters)."""
    eng, batch = _pipeline(cuda, torch.bfloat16)
    base = eng.run_iteration(batch)[0]
    placement = {ChunkId("F", 0, 1, 0): (1, 1), ChunkId("B", 0, 1, 0): (1, 1)}
    assert abs(eng.run_iteration(batch, placement=placement)[0] - base) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_pipeline_launch_counts(cuda, dtype):
    """Per iteration, every micro-batch of every replica runs each layer's
    forward kernel twice (F, and B's recompute) and its backward kernel once,
    of the source for its type; the plain version never runs."""
    eng, batch = _pipeline(cuda, TDT[dtype])
    plain = ops.packed_attention_ref
    calls = []
    ops.packed_attention_ref = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    fwd, bwd = dict(packed_flash_attention.launches), dict(packed_flash_attention_backward.launches)
    try:
        eng.run_iteration(batch)
        torch.cuda.synchronize()
    finally:
        ops.packed_attention_ref = plain
    L, R, M = 4, 2, 2
    kern, bkern = (SM90, BWD_SM90) if dtype == "bfloat16" else (FWD_TF32, BWD_TF32)
    got = {s: c - fwd[s] for s, c in packed_flash_attention.launches.items()}
    got_bwd = {s: c - bwd[s] for s, c in packed_flash_attention_backward.launches.items()}
    assert got == {SM90.source: 0, FWD_TF32.source: 0, kern.source: 2 * L * R * M}
    assert got_bwd == {BWD_SM90.source: 0, BWD_TF32.source: 0, bkern.source: L * R * M}
    assert not calls


@pytest.mark.gpu
def test_gpu_checkpoint_restores_card_tensors_bitwise(cuda, tmp_path):
    """fp32, bf16 and int32 tensors on the card and a Python int: saved,
    then restored onto the card bit for bit, and onto the CPU by placement."""
    g = torch.Generator(device=cuda).manual_seed(0)
    state = {"params": {"w": torch.randn((64, 32), generator=g, device=cuda),
                        "m": torch.randn((32,), generator=g, device=cuda).to(torch.bfloat16)},
             "ids": torch.arange(7, dtype=torch.int32, device=cuda), "step": 5}
    save_checkpoint(tmp_path, state, 5)
    got, step, _ = restore_checkpoint(tmp_path, target=state, shardings=cuda)
    assert step == 5 and got["step"] == 5
    for key, a, b in ((k, state["params"][k], got["params"][k]) for k in ("w", "m")):
        assert b.device.type == "cuda" and b.dtype == a.dtype, key
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), key
    assert torch.equal(got["ids"], state["ids"])
    host, _, _ = restore_checkpoint(tmp_path, shardings={"params": {"w": "cpu", "m": cuda},
                                                         "ids": None, "step": None})
    assert host["params"]["w"].device.type == "cpu" and host["params"]["m"].device.type == "cuda"


# ------------------------------------------------- the dense family's widths
# (head_dim, H, K, window): gemma3-1b's and gemma3-4b's heads at head_dim 256,
# h2o-danube's at 80 (bf16: kernels of its own width, five 16-column chunks
# in shared memory), llama2-7b's GQA group 1 and qwen2.5-7b's group 7 at 128,
# qwen3-moe-30b-a3b's group 8 and grok-1-314b's group 6 at 128
FAMILY_CASES = [(256, 4, 1, 512), (256, 8, 4, 1024), (80, 32, 8, 4096), (128, 32, 32, None),
                (128, 28, 4, None), (80, 8, 8, 96), (256, 7, 1, 96), (128, 32, 4, None),
                (128, 48, 8, None), (128, 64, 8, None)]  # the last: jamba-1.5-large-398b


@pytest.mark.gpu
@pytest.mark.parametrize("dh,H,K,window", FAMILY_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_family_head_dims_forward_and_backward(cuda, rng, dh, H, K, window, dtype):
    """Forward and backward at each new head width and GQA group, on packed
    documents that cross tile edges, ending in padding, with the window of
    the arch (or a short one that binds at this length): the kernel of the
    (dtype, head_dim) against the plain version; padding rows and their
    gradients exactly 0."""
    S = 1100 if window is None or window >= 512 else 400
    args = _args(rng, cuda, 1, S, H, K, dh, dtype, doc_lens=[S // 3, S // 2, S // 8])
    seg = args[3]
    pad = seg == 0
    assert bool(pad.any())
    before = _launches()
    out = packed_flash_attention(*args, causal=True, window=window)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    ref = packed_attention_ref(*args, causal=True, window=window)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])
    assert bool((out[pad] == 0).all())
    grads = _backward_case(rng, cuda, args, dtype, window=window)
    for g_, side in zip(grads, ("q", "k", "v")):
        assert bool((g_[pad] == 0).all()), side


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_head_dim_256_ragged_and_deterministic(cuda, rng, dh, dtype):
    """head_dim 256, and h2o-danube's 80, at lengths that are no multiple of
    the tiles (64 or 128 keys, 32 or 128 rows): TMA zero-fills the ragged
    edge; forward and backward match the plain version, and two backward
    launches agree bit for bit."""
    args = _args(rng, cuda, 2, 333, 8, 4, dh, dtype)
    out = packed_flash_attention(*args, causal=True)
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, causal=True)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, dtype)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_grads(first, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_head_dim_80_columns_keep_their_chunks(cuda, rng, dtype):
    """At head_dim 80 the bf16 kernels hold a row as five 16-column chunks
    (TMA boxes, wgmma descriptors under the 32-byte swizzle). q and k are
    scaled by another factor on each chunk and v more on each later one,
    columns 64-79 the most, so that a chunk read from or written to another
    chunk's place moves the scores, the output columns or a gradient away
    from the plain version; padding rows stay exactly 0."""
    q, k, v, seg, _, pos, _ = _args(rng, cuda, 2, 333, 8, 2, 80, dtype,
                                    doc_lens=[100, 150, 50])
    chunk = torch.arange(80, device=cuda) // 16
    qk_scale = torch.tensor([0.5, 1.0, 1.5, 0.75, 2.5], device=cuda)[chunk]
    v_scale = torch.tensor([1.0, 2.0, 3.0, 4.0, 8.0], device=cuda)[chunk]
    q, k = ((x.float() * qk_scale).to(x.dtype) for x in (q, k))
    v = (v.float() * v_scale).to(v.dtype)
    args = (q, k, v, seg, seg, pos, pos)
    out = packed_flash_attention(*args, causal=True)
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, causal=True)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    pad = seg == 0
    assert bool(pad.any()) and bool((out[pad] == 0).all())
    grads = _backward_case(rng, cuda, args, dtype)
    for g_, side in zip(grads, ("q", "k", "v")):
        assert bool((g_[pad] == 0).all()), side


def _gemma3_args(rng, device, dtype, S=1000, H=4, K=1):
    """gemma3-1b's heads (4 query heads on one KV head, head_dim 256) over
    packed documents whose positions restart, ending in 90 padding rows."""
    q, k, v, *_ = _args(rng, device, 1, S, H, K, 256, dtype)
    seg = torch.ones((1, S), dtype=torch.int32, device=device)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].clone()
    for start, doc in ((300, 2), (620, 3)):
        seg[:, start:] = doc
        pos[:, start:] = torch.arange(S - start, dtype=torch.int32, device=device)
    seg[:, S - 90:] = 0
    pos[:, S - 90:] = 0
    return q, k, v, seg, seg, pos, pos


@pytest.mark.gpu
@pytest.mark.parametrize("window", [512, 96, None])
def test_gpu_head_dim_256_bf16_backward_on_tensor_cores(cuda, rng, window):
    """bf16 at head_dim 256 (gemma3-1b's heads, its window 512, a short
    window and none) launches the bf16 tensor-core source once and the fp32
    source never, matches the plain version, and gives padding rows and keys
    gradients of exactly 0."""
    assert backward_kernel_for(torch.bfloat16, 256) is BWD_SM90_WIDE
    args = _gemma3_args(rng, cuda, "bfloat16")
    before = dict(packed_flash_attention_backward.launches)
    grads = _backward_case(rng, cuda, args, "bfloat16", window=window)
    after = packed_flash_attention_backward.launches
    assert after[BWD_SM90.source] - before[BWD_SM90.source] == 1
    assert after[BWD_TF32.source] == before[BWD_TF32.source]
    pad = args[3] == 0
    for g_, side in zip(grads, ("q", "k", "v")):
        assert bool((g_[pad] == 0).all()), side


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_head_dim_256_backward_unmasked_tiles_match_masked(cuda, rng, dtype, monkeypatch):
    """At head_dim 256, tiles whose every pair is visible (code 2) run
    without the mask and give the same gradients, bit for bit, as with the
    mask forced on every visible tile (code 1)."""
    args = _args(rng, cuda, 1, 512, 8, 4, 256, dtype, doc_lens=[512])
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, dtype)
    _, (blk, blk_dq) = pfa.backward_tile_maps(backward_kernel_for(TDT[dtype], 256), *args[3:],
                                              **kw)
    assert bool((blk == 2).any()) and bool((blk_dq == 2).any())
    free = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    tile_map = pfa.tile_map
    monkeypatch.setattr(pfa, "tile_map", lambda *a, **k: tile_map(*a, **k).clamp_(max=1))
    masked = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(free, masked):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,window", [(4, 1, 512), (8, 4, 1024)])
def test_gpu_head_dim_256_bf16_backward_is_deterministic(cuda, rng, H, K, window):
    """gemma3-1b's and gemma3-4b's heads at their windows: two bf16 backward
    launches give bitwise-equal dq, dk and dv (no atomics; P^T passes
    between the dK/dV kernel's warpgroups in a fixed order)."""
    args = _gemma3_args(rng, cuda, "bfloat16", S=1500, H=H, K=K)
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, "bfloat16", window)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_gpu_head_dim_256_backward_gqa_splits(cuda, rng, splits, monkeypatch):
    """gemma3-1b's GQA group (4 query heads) over 1, 2 or 4 dK/dV CTAs, whose
    fp32 parts a second kernel sums: each matches the plain version, and two
    launches agree bit for bit."""
    monkeypatch.setattr(pfa, "kv_splits", lambda *a: splits)
    args = _gemma3_args(rng, cuda, "bfloat16")
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, "bfloat16", 512)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_grads(first, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw),
                 "bfloat16")
    pad = args[3] == 0
    assert all(bool((g_[pad] == 0).all()) for g_ in first)


def _fp32_split_values(args, kw):
    """Every split of the fp32 backward's two loops, as (dK/dV, dQ): powers
    of two up to each loop's iterations, and the wrapper's own choice."""
    kern = backward_kernel_for(torch.float32, args[0].shape[-1])
    padded, _ = pfa.backward_tile_maps(kern, *args[3:], **kw)
    B, _, H, _ = args[0].shape
    K = args[1].shape[2]
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    iters = (H // K * Sqp // kern.block_q, Skp // kern.dq_tiles[1])
    chosen = pfa.tf32_splits(kern, B, H, K, Sqp, Skp,
                             torch.cuda.get_device_properties(args[0].device).multi_processor_count)
    pows = [sorted({2 ** i for i in range(n.bit_length()) if 2 ** i <= n} | {c})
            for n, c in zip(iters, chosen)]
    return [(s, chosen[1]) for s in pows[0]] + [(chosen[0], s) for s in pows[1] if s != chosen[1]]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["parity", "ragged", "gemma3"])
def test_gpu_fp32_backward_forced_splits(cuda, rng, shape, monkeypatch):
    """The fp32 backward's dK/dV loop (GQA heads x query tiles) and dQ loop
    (key tiles), each split over every power of two of CTAs up to its
    iterations: every split matches the plain version within 1e-4 of max
    |ref|, two launches agree bit for bit, and padding rows and keys get
    gradients of exactly 0."""
    if shape == "parity":  # the parity path's micro-batch: 2 x 256, 4 / 2 heads
        args = _args(rng, cuda, 2, 256, 4, 2, 128, "float32", doc_lens=[100, 80, 40])
    elif shape == "ragged":
        args = _args(rng, cuda, 2, 333, 8, 2, 80, "float32", doc_lens=[200, 100])
    else:
        args = _gemma3_args(rng, cuda, "float32", S=700)
    d_out, out, lse, kw = _backward_inputs(rng, cuda, args, "float32")
    ref = packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw)
    pad = args[3] == 0
    for splits in _fp32_split_values(args, kw):
        monkeypatch.setattr(pfa, "tf32_splits", lambda *a, s=splits: s)
        first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
        second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
        for a, b in zip(first, second):
            assert torch.equal(a, b), splits
        _check_grads(first, ref, "float32")
        assert all(bool((g_[pad] == 0).all()) for g_ in first), splits


def _decode(cfg, params, device, tokens, max_len):
    """`tokens` decoded one by one from an empty cache (teacher-forced):
    every step's logits."""
    from repro_torch.models.model import init_cache
    from repro_torch.train.train_step import build_serve_step

    cache = init_cache(cfg, tokens.shape[0], max_len, cache_dtype=torch.float32, device=device)
    serve = build_serve_step(cfg, compute_dtype=torch.float32)
    out = []
    for i in range(tokens.shape[1]):
        lengths = torch.full((tokens.shape[0],), i, dtype=torch.int32, device=device)
        _, logits, cache = serve(params, cache, {"tokens": tokens[:, i:i + 1].to(device),
                                                 "lengths": lengths})
        out.append(n(logits[:, -1]))
    return out


@pytest.mark.gpu
def test_gpu_ring_decode_and_prefill_match_cpu(cuda):
    """gemma3-1b reduced to one period at head_dim 256 and a window of 8
    (16-slot rings) in fp32: 24 decode steps from an empty cache on the card
    against the CPU (the rings wrap at step 16), then a 20-token prefill on
    the card (the fp32 kernel at head_dim 256) + `extend_cache` + 4 steps
    against the same decode, 1e-4."""
    from repro_torch.models.model import extend_cache, prefill_forward
    from repro_torch.train.train_step import build_serve_step

    cfg = reduced(get_arch("gemma3-1b"), n_layers=13, head_dim=256, window=8)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = t(np.random.default_rng(3).integers(1, cfg.vocab_size, size=(2, 24))
               .astype(np.int32))
    on_card = _decode(cfg, _to(params, cuda), cuda, tokens, 32)
    on_cpu = _decode(cfg, params, "cpu", tokens, 32)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    P = 20
    batch = {"tokens": tokens[:, :P].to(cuda),
             "segment_ids": torch.ones((2, P), dtype=torch.int32, device=cuda),
             "positions": torch.arange(P, dtype=torch.int32, device=cuda).repeat(2, 1)}
    gp = _to(params, cuda)
    before = _launches()
    last, caches = prefill_forward(cfg, gp, batch, compute_dtype=torch.float32)
    assert _launches() == before + cfg.n_layers
    np.testing.assert_allclose(n(last[:, -1]), on_cpu[P - 1], atol=1e-4, rtol=1e-4)
    cache = extend_cache(cfg, caches, 32)
    serve = build_serve_step(cfg, compute_dtype=torch.float32)
    for i in range(P, 24):
        lengths = torch.full((2,), i, dtype=torch.int32, device=cuda)
        _, logits, cache = serve(gp, cache, {"tokens": tokens[:, i:i + 1].to(cuda),
                                             "lengths": lengths})
        np.testing.assert_allclose(n(logits[:, -1]), on_cpu[i], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_pipeline_tied_embeddings_match_cpu(cuda, dtype):
    """gemma3-1b reduced (tied embeddings, head_dim 256) at dp1/pp2: the
    engine's loss and gradients on the card against the CPU (fp32 1e-4;
    bf16: the loss within 2e-3), the last stage reading the tied embed."""
    cfg = reduced(get_arch("gemma3-1b"), n_layers=13, head_dim=256)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = SyntheticPackedDataset(cfg, 128, 2, seed=0, mu=3.6, sigma=0.8).batch_at(0)
    out = {}
    for device in ("cpu", cuda):
        eng = PipelineEngine(cfg, initial_plan(13, dp=1, pp=2, tp=1, microbatches=2),
                             devices=[device], params=params, compute_dtype=TDT[dtype])
        assert "embed" in eng.stage_params(0, 1)
        loss, grads = eng.run_iteration({k: t(v).to(device) for k, v in batch.items()})
        out[str(device)] = (loss, {k: [n(g) for g in tree_leaves(v)] for k, v in grads.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out.values()
    if dtype == "bfloat16":
        assert abs(l_gpu - l_cpu) <= 2e-3
        return
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    for key in g_cpu:
        for a, b in zip(g_gpu[key], g_cpu[key], strict=True):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7


# ----------------------------------------- the fp32 forward in 3xTF32 on the tensor cores
# (head_dim, H, K, window, arch whose packed documents a case takes)
FP32_LONG_CASES = [(128, 4, 2, None, "qwen3-8b"), (80, 4, 2, 4096, "h2o-danube-1.8b"),
                   (256, 4, 1, 512, "gemma3-1b")]


@pytest.mark.gpu
@pytest.mark.parametrize("dh,H,K,window,arch", FP32_LONG_CASES)
@pytest.mark.parametrize("docs", ["one", "family"])
def test_gpu_fp32_forward_at_4096_keys(cuda, rng, dh, H, K, window, arch, docs):
    """The fp32 forward at 1 x 4096, one document or the arch's packed
    training documents (their own positions), at head_dim 128, 80 and 256:
    within the fp32 tolerance of the plain version, though each output row
    sums up to 4096 keys over 256 stages."""
    S = 4096
    q, k, v, *_ = _args(rng, cuda, 1, S, H, K, dh, "float32")
    if docs == "one":
        seg = torch.ones((1, S), dtype=torch.int32, device=cuda)
        pos = torch.arange(S, dtype=torch.int32, device=cuda)[None]
    else:
        batch = SyntheticPackedDataset(get_arch(arch), S, 1, seed=0).batch_at(0)
        seg, pos = (t(batch[key]).to(cuda) for key in ("segment_ids", "positions"))
        assert int(seg.max()) > 3
    args = (q, k, v, seg, seg, pos, pos)
    before = dict(packed_flash_attention.launches)
    out = packed_flash_attention(*args, causal=True, window=window)
    torch.cuda.synchronize()
    assert packed_flash_attention.launches[FWD_TF32.source] == before[FWD_TF32.source] + 1
    ref = packed_attention_ref(*args, causal=True, window=window)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 256])
def test_gpu_fp32_forward_columns_keep_their_places(cuda, rng, dh):
    """q and k scaled by another factor on each 16 columns and v more on
    each later 16 (from 0.5 to 2, so that the output keeps the unit scale
    its absolute tolerance is stated for), so that a column read from or
    written to another place (a fragment, a warp's half of the width at
    head_dim 256, the P V n-tiles) moves the scores or the output away from
    the plain version."""
    q, k, v, seg, _, pos, _ = _args(rng, cuda, 2, 333, 8, 2, dh, "float32",
                                    doc_lens=[100, 150, 50])
    chunk = torch.arange(dh, device=cuda) // 16
    qk_scale = torch.tensor([0.5, 1.0, 1.5, 0.75, 1.25, 0.6, 1.1, 0.9] * 2, device=cuda)[chunk]
    v_scale = 0.5 + 1.5 * chunk.float() / (dh // 16 - 1)
    q, k, v = q * qk_scale, k * qk_scale, v * v_scale
    args = (q, k, v, seg, seg, pos, pos)
    out = packed_flash_attention(*args, causal=True)
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, causal=True)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    assert bool((out[seg == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 128, 256])
@pytest.mark.parametrize("window", [None, 40])
def test_gpu_fp32_forward_lse_and_empty_rows(cuda, rng, dh, window):
    """lse is the log-sum-exp of the scaled scores (1e-4); a row with no
    visible key, a padding row or a query of a segment that no key carries,
    gives exactly 0 and lse = +inf; a second launch gives the same bits."""
    B, S, H, K = 2, 300, 4, 2
    q, k, v, seg, _, pos, _ = _args(rng, cuda, B, S, H, K, dh, "float32",
                                    doc_lens=[120, 100, 50])
    seg_q = seg.clone()
    seg_q[:, 120:220] = 7  # no key carries segment 7
    args = (q, k, v, seg_q, seg, pos, pos)
    out, lse = packed_flash_attention(*args, causal=True, window=window, return_lse=True)
    again, lse2 = packed_flash_attention(*args, causal=True, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, causal=True, window=window)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    mask = attention_mask(seg_q, seg, pos, pos, causal=True, window=window)[:, None]
    kr = k.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * dh ** -0.5
    ref = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    visible = mask.any(-1).expand_as(ref)
    empty = ~mask.any(-1)[:, 0]  # (B, S) rows
    assert int(empty.sum()) == B * (100 + 30) and bool((out[empty] == 0).all())
    assert bool(torch.isposinf(lse[~visible]).all())
    np.testing.assert_allclose(n(lse[visible]), n(ref[visible]), atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 128, 256])
def test_gpu_fp32_forward_forced_splits(cuda, rng, dh, monkeypatch):
    """The fp32 forward's key walk split over 1 to 16 CTAs (`fwd_splits`
    forced), parts merged by a second kernel: out and lse match the plain
    version at every split, rows with no visible key stay exactly 0 with
    lse = +inf, and each split gives the same bits on a second launch."""
    args = _args(rng, cuda, 2, 333, 4, 2, dh, "float32", doc_lens=[150, 100, 50])
    seg, pos = args[3], args[5]
    ref = packed_attention_ref(*args, causal=True, window=64)
    mask = attention_mask(seg, seg, pos, pos, causal=True, window=64)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", args[0], args[1].repeat_interleave(2, dim=2)) * dh ** -0.5
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    visible = mask.any(-1).expand_as(want)
    for splits in (1, 2, 4, 16):
        monkeypatch.setattr(pfa, "fwd_splits", lambda *a, s=splits: s)
        before = dict(packed_flash_attention.launches)
        out, lse = packed_flash_attention(*args, causal=True, window=64, return_lse=True)
        again, lse2 = packed_flash_attention(*args, causal=True, window=64, return_lse=True)
        torch.cuda.synchronize()
        assert packed_flash_attention.launches[FWD_TF32.source] == before[FWD_TF32.source] + 2
        assert torch.equal(out, again) and torch.equal(lse, lse2), splits
        np.testing.assert_allclose(n(out), n(ref), atol=TOL["float32"], rtol=TOL["float32"])
        assert bool((out[seg == 0] == 0).all()) and bool(torch.isposinf(lse[~visible]).all())
        np.testing.assert_allclose(n(lse[visible]), n(want[visible]), atol=1e-4, rtol=1e-5)


# ------------------------------------------------ fp32 forward at large outputs
@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 128, 256])
def test_gpu_fp32_forward_large_outputs(cuda, rng, dh):
    """v scaled up to 16x on its later 16-column groups, so that outputs
    reach tens: the fp32 forward within 1e-4 of max |ref| of the plain
    version (the fp32 gate of the parity paths and of `BWD_TOL`); the 0.5-2
    scales of `test_gpu_fp32_forward_columns_keep_their_places` stay at the
    elementwise 2e-5."""
    q, k, v, seg, _, pos, _ = _args(rng, cuda, 2, 333, 8, 2, dh, "float32",
                                    doc_lens=[100, 150, 50])
    chunk = torch.arange(dh, device=cuda) // 16
    v = v * (1.0 + 15.0 * chunk.float() / (dh // 16 - 1))
    args = (q, k, v, seg, seg, pos, pos)
    out = packed_flash_attention(*args, causal=True)
    ref = packed_attention_ref(*args, causal=True)
    assert float(ref.abs().max()) > 16
    err = float((out - ref).abs().max())
    assert err <= BWD_TOL["float32"] * float(ref.abs().max()), err
    assert bool((out[seg == 0] == 0).all())


# ------------------------------------------------------------------- MoE
def _moe_layer(rng, *, factor=1.25):
    """An MoE layer (16 experts, top-4, d 256, expert width 128) and its
    input, fp32, from numpy draws; and the least gap between a row's 4th
    and 5th router probability, computed on the CPU."""
    from repro_torch.models.moe import init_moe

    cfg = reduced(get_arch("qwen3-moe-30b-a3b"), d_model=256, moe_d_ff=128, n_experts=16,
                  moe_top_k=4, capacity_factor=factor)
    p = init_moe(torch.Generator().manual_seed(3), cfg, dtype=torch.float32, device="cpu")
    x = t(rng.normal(size=(2, 200, 256)).astype(np.float32))
    probs = torch.softmax(x.reshape(400, 256) @ p["router"], dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    gap = float((top[:, 3] - top[:, 4]).min())
    return cfg, p, x, gap


def _moe_run(cfg, p, x):
    from repro_torch.models.moe import moe_ffn

    moe_ffn.routes = []
    try:
        out = moe_ffn(cfg, p, x)
        return out, moe_ffn.routes[0]
    finally:
        moe_ffn.routes = None


@pytest.mark.gpu
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_gpu_moe_layer_matches_cpu(cuda, rng, factor):
    """The MoE layer on the card against the port's CPU path, fp32, on
    inputs whose every row has a clear top-k margin (asserted: the 4th and
    5th router probabilities apart by more than 1e-5), so that both route
    every token alike: the same experts and the same drops (capacity factor
    0.25 drops, asserted), and outputs within 1e-5."""
    cfg, p, x, gap = _moe_layer(rng, factor=factor)
    assert gap > 1e-5
    want, want_routes = _moe_run(cfg, p, x)
    got, routes = _moe_run(cfg, _to(p, cuda), x.to(cuda))
    for key in ("experts", "kept"):
        assert torch.equal(routes[key].cpu(), want_routes[key]), key
    assert bool((~want_routes["kept"]).any()) == (factor < 1)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_gpu_moe_layer_is_deterministic(cuda):
    """One full-width qwen3-moe-30b-a3b layer (128 experts, top-8) in bf16 on
    2 x 2048 positions, twice on the same input: outputs, routes and every
    gradient (x and the four weights) equal bit for bit, as remat's
    recompute of the layer needs."""
    from repro_torch.models.moe import init_moe

    cfg = get_arch("qwen3-moe-30b-a3b")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = {k: w.requires_grad_(True) for k, w in
         init_moe(g, cfg, dtype=torch.bfloat16, device=cuda).items()}
    x = torch.randn((2, 2048, cfg.d_model), generator=g, device=cuda).to(torch.bfloat16)
    x.requires_grad_(True)
    d_out = torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        out, routes = _moe_run(cfg, p, x)
        runs.append((out, routes, torch.autograd.grad(out, (x, *p.values()), d_out)))
    (a, ra, ga), (b, rb, gb) = runs
    assert torch.equal(a, b)
    assert all(torch.equal(ra[k], rb[k]) for k in ("experts", "kept"))
    assert all(torch.equal(u, w) for u, w in zip(ga, gb))


# ------------------------------------- non-causal and cross-attention cases
# (Sq, Sk, H, K, dh): whisper's heads (16/16, dh 64) in the encoder's
# non-causal self-attention and the decoder's cross-attention over 1500
# frames (no tile multiple) from 200 and 64 queries, and dh 128 with GQA
CROSS_CASES = [(333, 333, 16, 16, 64), (200, 1500, 16, 16, 64), (64, 1500, 16, 16, 64),
               (333, 333, 8, 2, 128), (300, 777, 8, 2, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,dh", CROSS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_noncausal_and_cross_forward_and_backward(cuda, rng, Sq, Sk, H, K, dh, dtype):
    """causal=False with query and key ids of their own: forward and
    backward against the plain version; a row with no visible key (padding,
    or a decoder document without its clip) gives exactly 0 out, lse +inf
    and 0 gradient, and so does a key no query sees; two backward launches
    agree bit for bit."""
    if Sq == Sk:  # the encoder's self-attention: packed clips, padding
        seg, pos = (t(x).to(cuda) for x in make_packed(rng, 2, Sq, doc_lens=[100, 90, 80]))
        ids = (seg, seg, pos, pos)
    else:
        ids = tuple(t(x).to(cuda) for x in cross_ids(rng, 2, Sq, Sk, 3))
    q = t(rng.normal(size=(2, Sq, H, dh)).astype(np.float32)).to(cuda, TDT[dtype])
    k, v = (t(rng.normal(size=(2, Sk, K, dh)).astype(np.float32)).to(cuda, TDT[dtype])
            for _ in range(2))
    args = (q, k, v, *ids)
    kw = {"causal": False, "window": None}
    out, lse = packed_flash_attention(*args, **kw, return_lse=True)
    ref = packed_attention_ref(*args, **kw)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL[dtype], rtol=TOL[dtype])
    mask = attention_mask(*ids, **kw)
    no_key, no_query = ~mask.any(-1), ~mask.any(1)
    assert bool(no_key.any()) and bool(no_query.any())
    if Sq != Sk:  # a document of queries without keys, besides the padding
        assert bool((no_key & (ids[0] != 0)).any())
    assert bool((out[no_key] == 0).all())
    assert bool(torch.isposinf(lse.transpose(1, 2)[no_key]).all())
    d_out = t(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(cuda, TDT[dtype])
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_grads(first, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw), dtype)
    dq, dk, dv = first
    assert bool((dq[no_key] == 0).all())
    assert bool((dk[no_query] == 0).all()) and bool((dv[no_query] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_cross_attention_through_autograd(cuda, rng, dtype):
    """`ops.packed_attention` at causal=False over two sequences under
    autograd: one forward and one backward launch, gradients of q, k and v
    against autograd through the plain version."""
    ids = tuple(t(x).to(cuda) for x in cross_ids(rng, 1, 100, 400, 2))
    q = t(rng.normal(size=(1, 100, 16, 64)).astype(np.float32)).to(cuda, TDT[dtype])
    k, v = (t(rng.normal(size=(1, 400, 16, 64)).astype(np.float32)).to(cuda, TDT[dtype])
            for _ in range(2))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    before = (_launches(), sum(packed_flash_attention_backward.launches.values()))
    out = ops.packed_attention(*leaves, *ids, causal=False)
    got = torch.autograd.grad(out, leaves, torch.ones_like(out))
    torch.cuda.synchronize()
    assert (_launches(), sum(packed_flash_attention_backward.launches.values())) == (
        before[0] + 1, before[1] + 1)
    ref = packed_attention_ref_backward(q.detach(), k.detach(), v.detach(), torch.ones_like(out),
                                        *ids, causal=False)
    _check_grads(got, ref, dtype)


# ---------------------------------------------- narrow heads (head_dim <= 64)
# whisper-medium's five attention regimes (16/16 heads), at a reduced batch:
# (name, B, Sq, Sk or None (self-attention), causal)
WHISPER_REGIMES = [("encoder_serve", 2, 1500, None, False),
                   ("encoder_train", 1, 1024, None, False),
                   ("decoder_self_train", 1, 512, None, True),
                   ("cross_train", 1, 256, 1024, False),
                   ("cross_serve", 2, 64, 1500, False)]


def _whisper_case(rng, device, regime, dh, H=16):
    """(q, k, v, ids, kw) of one of whisper's regimes at head width `dh`: the
    serving encoder one clip a row, the training encoder packed clips, the
    decoder packed transcripts, the training cross-attention transcripts
    over their clips with one transcript without its clip, the serving
    cross-attention a 64-token prompt over its row's 1500 frames."""
    name, B, Sq, Sk, causal = next(r for r in WHISPER_REGIMES if r[0] == regime)
    if name == "cross_train":
        ids = tuple(t(x).to(device) for x in cross_ids(rng, B, Sq, Sk, 3))
    elif name == "cross_serve":
        ones = [np.ones((B, S), np.int32) for S in (Sq, Sk)]
        ids = tuple(t(x).to(device) for x in (
            ones[0], ones[1], np.tile(np.arange(Sq, dtype=np.int32), (B, 1)),
            np.tile(np.arange(Sk, dtype=np.int32), (B, 1))))
    else:
        doc_lens = [Sq] if name == "encoder_serve" else None
        seg, pos = (t(x).to(device) for x in make_packed(rng, B, Sq, doc_lens=doc_lens))
        ids = (seg, seg, pos, pos)
    Sk = Sk or Sq
    q = t(rng.normal(size=(B, Sq, H, dh)).astype(np.float32)).to(device, torch.bfloat16)
    k, v = (t(rng.normal(size=(B, Sk, H, dh)).astype(np.float32)).to(device, torch.bfloat16)
            for _ in range(2))
    return q, k, v, ids, {"causal": causal, "window": None}


@pytest.mark.gpu
@pytest.mark.parametrize("regime", [r[0] for r in WHISPER_REGIMES])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_gpu_narrow_kernels_in_whisper_regimes(cuda, rng, regime, dh):
    """The head_dim <= 64 bf16 kernels (64-row forward CTAs whose warpgroups
    take the key tiles in turn; dQ with the delta pass, then the persistent
    dK/dV) in each of whisper's regimes: forward and backward against the
    plain version, rows without a visible key exactly 0 (lse +inf, dq 0),
    keys no query sees dk and dv 0, two backward launches bit for bit."""
    q, k, v, ids, kw = _whisper_case(rng, cuda, regime, dh)
    assert pfa.kernel_for(torch.bfloat16, dh) is pfa.SM90_NARROW
    assert backward_kernel_for(torch.bfloat16, dh) is pfa.BWD_SM90_NARROW
    args = (q, k, v, *ids)
    out, lse = packed_flash_attention(*args, **kw, return_lse=True)
    ref = packed_attention_ref(*args, **kw)
    np.testing.assert_allclose(n(out), n(ref), atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    mask = attention_mask(*ids, **kw)
    no_key, no_query = ~mask.any(-1), ~mask.any(1)
    if regime == "cross_train":  # the transcript without its clip, besides the padding
        assert bool((no_key & (ids[0] != 0)).any())
    assert bool((out[no_key] == 0).all())
    assert bool(torch.isposinf(lse.transpose(1, 2)[no_key]).all())
    d_out = t(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_grads(first, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw),
                 "bfloat16")
    dq, dk, dv = first
    assert bool((dq[no_key] == 0).all())
    assert bool((dk[no_query] == 0).all()) and bool((dv[no_query] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("regime", [r[0] for r in WHISPER_REGIMES])
@pytest.mark.parametrize("pair", [0, 1])
def test_gpu_narrow_pair_and_split(cuda, rng, regime, pair, monkeypatch):
    """The head_dim <= 64 forward and backward dQ kernels forced into each
    mode in each of whisper's regimes: pair (two 64-row map rows a CTA, one
    a warpgroup; an odd row count leaves a CTA's second warpgroup without a
    row) and split (one row a CTA, the key walk split between the
    warpgroups and merged): forward and backward against the plain version,
    rows without a visible key exactly 0 (lse +inf, dq 0), two backward
    launches bit for bit."""
    q, k, v, ids, kw = _whisper_case(rng, cuda, regime, 64)
    monkeypatch.setattr(pfa, "pair_rows", lambda *a: pair)
    args = (q, k, v, *ids)
    out, lse = packed_flash_attention(*args, **kw, return_lse=True)
    np.testing.assert_allclose(n(out), n(packed_attention_ref(*args, **kw)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    no_key = ~attention_mask(*ids, **kw).any(-1)
    assert bool((out[no_key] == 0).all())
    assert bool(torch.isposinf(lse.transpose(1, 2)[no_key]).all())
    d_out = t(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    second = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _check_grads(first, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw),
                 "bfloat16")
    assert bool((first[0][no_key] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("ctas", [1, 2, 3, 7])
@pytest.mark.parametrize("regime,group", [("decoder_self_train", 1), ("cross_serve", 1),
                                          ("decoder_self_train", 4)])
def test_gpu_narrow_dkdv_forced_ctas(cuda, rng, regime, group, ctas, monkeypatch):
    """The persistent dK/dV kernel forced onto 1, 2, 3 and 7 CTAs, so that
    each walks many work items through both K/V buffers (and, with GQA
    group 4, four query heads an item): gradients bit for bit those of the
    default grid (one CTA an SM), and against the plain version."""
    q, k, v, ids, kw = _whisper_case(rng, cuda, regime, 64)
    if group > 1:
        k, v = k[:, :, ::group].contiguous(), v[:, :, ::group].contiguous()
    args = (q, k, v, *ids)
    out, lse = packed_flash_attention(*args, **kw, return_lse=True)
    d_out = t(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(cuda, torch.bfloat16)
    free = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    monkeypatch.setattr(pfa, "dkdv_ctas", lambda *a: ctas)
    forced = packed_flash_attention_backward(*args[:3], out, lse, d_out, *args[3:], **kw)
    for a, b in zip(free, forced):
        assert torch.equal(a, b)
    _check_grads(forced, packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw),
                 "bfloat16")


# ------------------------------------------------------------ recurrent mixers
RECURRENT_MIXERS = [("jamba-1.5-large-398b", "mamba"), ("xlstm-1.3b", "mlstm"),
                    ("xlstm-1.3b", "slstm")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mixer", RECURRENT_MIXERS)
def test_gpu_recurrent_mixer_matches_cpu(cuda, rng, arch, mixer):
    """A reduced recurrent mixer (d_model 64; the mLSTM at chunk 16, so 4
    chunks) in fp32 on the card against its CPU path on 2 x 64 packed
    documents that start mid-chunk and end in padding: the output, the
    collected state, one decode step from that state, and every gradient
    of sum(out * r), each to 1e-4 of the CPU's largest |value|."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.model import init_layer
    from repro_torch.train.optimizer import tree_leaves

    fn = {"mamba": ssm.mamba, "mlstm": xlstm.mlstm, "slstm": xlstm.slstm}[mixer]
    cfg = reduced(get_arch(arch), mlstm_chunk=16)
    spec = next(sp for sp in cfg.period if sp.mixer == mixer)
    g = torch.Generator()
    g.manual_seed(0)
    p = init_layer(g, cfg, spec, dtype=torch.float32, device="cpu")["mixer"]
    seg = np.zeros((2, 64), np.int32)
    seg[0, :10], seg[0, 10:41], seg[0, 41:58] = 1, 2, 3
    seg[1, :27], seg[1, 27:] = 1, 2
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model), dtype=np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model), dtype=np.float32))
    tok = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32))

    def run(dev):
        params = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xi = x.to(dev).requires_grad_(True)
        md = {"segment_ids": torch.from_numpy(seg).to(dev), "collect_state": True}
        out, state = fn(cfg, spec, params, xi, md)
        grads = torch.autograd.grad((out * r.to(dev)).sum(), [xi] + tree_leaves(params))
        with torch.no_grad():
            step, nxt = fn(cfg, spec, params, tok.to(dev),
                           {"segment_ids": torch.ones((2, 1), dtype=torch.int32, device=dev)},
                           cache={k: v.detach() for k, v in state.items()})
        return [t.detach().cpu() for t in (out, *state.values(), step, *nxt.values(), *grads)]

    want, got = run("cpu"), run(cuda)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL process group in this process and its (1, 1)
    ("data", "model") mesh; the group is destroyed after the test."""
    import datetime
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw", [("qwen3-8b", {}),
                                     ("qwen3-moe-30b-a3b", {"expert_parallel": True}),
                                     ("qwen3-moe-30b-a3b", {})],
                         ids=["qwen3-8b", "qwen3-moe-ep", "qwen3-moe-tp"])
def test_gpu_one_rank_mesh_step_matches_unsharded(nccl_mesh, arch, kw):
    """The sharded train step on the card's (1, 1) NCCL mesh (DTensor state,
    the fp32 kernels through `local_map`, the MoE layer's EP or TP path)
    against the unsharded step: 2 fp32 steps of reduced `arch` at head_dim
    128, losses to 1e-5 relative, parameters to 1e-5 of each leaf's max,
    the same kernel launches, the same routes. The MoE cases run without
    remat, so that each records every call's routes: a recompute stops once
    the tensors its backward needs are back, which may come before a layer
    records them."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import NULL_POLICY, gather, policy_for_mesh
    from repro_torch.train.train_step import init_train_state

    cfg = reduced(get_arch(arch), head_dim=128)
    ds = SyntheticPackedDataset(cfg, 128, 4, seed=0, mu=3.6, sigma=0.8)
    runs = {}
    for name, pol in (("plain", NULL_POLICY), ("sharded", policy_for_mesh(nccl_mesh, **kw))):
        opt = make_optimizer("adamw", lr=1e-3)
        state = init_train_state(0, cfg, opt, device=nccl_mesh.device_type, policy=pol)
        step = build_train_step(cfg, opt, policy=pol, microbatches=2, remat=not cfg.n_experts,
                                compute_dtype=torch.float32)
        before = (dict(packed_flash_attention.launches),
                  dict(packed_flash_attention_backward.launches))
        moe.moe_ffn.routes = []
        try:
            losses = [float(step(state, {k: t(v).cuda() for k, v in ds.batch_at(i).items()})[1]
                            ["loss"]) for i in range(2)]
            routes = moe.moe_ffn.routes
        finally:
            moe.moe_ffn.routes = None
        torch.cuda.synchronize()
        launches = [{k: c[k] - b[k] for k in c} for c, b in
                    zip((packed_flash_attention.launches,
                         packed_flash_attention_backward.launches), before)]
        runs[name] = (losses, [n(p) for p in tree_leaves(gather(state["params"]))], launches,
                      routes)
    (l0, p0, c0, r0), (l1, p1, c1, r1) = runs["plain"], runs["sharded"]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for a, b in zip(p1, p0):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert c1 == c0 and c1[0][FWD_TF32.source] > 0 and c1[1][BWD_TF32.source] > 0
    assert len(r1) == len(r0) == (2 * 2 * cfg.n_layers if cfg.n_experts else 0)
    for a, b in zip(r1, r0):
        assert all(torch.equal(a[k], b[k]) for k in ("experts", "kept"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_gpu_one_rank_mesh_family_step_matches_unsharded(nccl_mesh, arch):
    """The VLM and encoder-decoder families' sharded train step on the
    card's (1, 1) NCCL mesh against the unsharded step: 2 fp32 steps of
    reduced `arch` at its real head width (qwen2-vl's M-RoPE at its real
    sections; whisper's encoder, decoder and cross-attention at head_dim
    64) on `data.multimodal` batches, losses to 1e-5 relative, parameters
    to 1e-5 of each leaf's max, the same kernel launches (the fp32
    kernels through `local_map`)."""
    from repro_torch.data.multimodal import enc_dec_batch, vlm_batch
    from repro_torch.parallel.sharding import NULL_POLICY, gather, policy_for_mesh
    from repro_torch.train.train_step import init_train_state

    full = get_arch(arch)
    cfg = reduced(full, head_dim=full.head_dim, mrope_sections=full.mrope_sections)
    if cfg.enc_dec:
        batches = [enc_dec_batch(cfg, 128, 32, 4, seed=0, clip_frames=(32, 64), index=i)
                   for i in range(2)]
    else:
        batches = [vlm_batch(cfg, 128, 4, seed=0, vision_len=16, grid=(4, 4), index=i, mu=3.6,
                             sigma=0.8) for i in range(2)]
    runs = {}
    for name, pol in (("plain", NULL_POLICY), ("sharded", policy_for_mesh(nccl_mesh))):
        opt = make_optimizer("adamw", lr=1e-3)
        state = init_train_state(0, cfg, opt, device=nccl_mesh.device_type, policy=pol)
        step = build_train_step(cfg, opt, policy=pol, microbatches=2,
                                compute_dtype=torch.float32)
        before = (dict(packed_flash_attention.launches),
                  dict(packed_flash_attention_backward.launches))
        losses = [float(step(state, {k: t(v).cuda() for k, v in b.items()})[1]["loss"])
                  for b in batches]
        torch.cuda.synchronize()
        launches = [{k: c[k] - b[k] for k in c} for c, b in
                    zip((packed_flash_attention.launches,
                         packed_flash_attention_backward.launches), before)]
        runs[name] = (losses, [n(p) for p in tree_leaves(gather(state["params"]))], launches)
    (l0, p0, c0), (l1, p1, c1) = runs["plain"], runs["sharded"]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for a, b in zip(p1, p0):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    calls = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)
    assert c1 == c0 and c1[0][FWD_TF32.source] == 2 * 2 * 2 * calls
    assert c1[1][BWD_TF32.source] == 2 * 2 * calls


@pytest.mark.gpu
def test_gpu_int8_compressor_matches_cpu(cuda):
    """The int8 error-feedback compressor on the card gives the CPU's codes,
    scales, dequantized values and residuals bit for bit (a scale divided
    by a Python number there would be multiplied by its reciprocal)."""
    from repro_torch.train.compression import Int8Compressor

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1 << 22, generator=g) * torch.rand(1 << 22, generator=g) * 3
    r = torch.randn(1 << 22, generator=g) * 1e-3
    x[:256] = 0.0  # an all-zero block: the 1e-30 guard
    comp = Int8Compressor(block=256)
    for a, b in zip(comp.compress(x[:-5])[:2], comp.compress(x[:-5].cuda())[:2]):
        assert torch.equal(a, b.cpu())
    for a, b in zip(comp.roundtrip_with_feedback(x, r),
                    comp.roundtrip_with_feedback(x.cuda(), r.cuda())):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernel_ops_pass_opcheck(cuda, rng, dtype):
    """`torch.library.opcheck` on both kernel ops (schema, autograd
    registration, fake implementation against the kernel, AOT dispatch):
    the forward with and without its log-sum-exp, then the backward."""
    q, k, v, *ids = _args(rng, cuda, 2, 200, 4, 2, 64, dtype, doc_lens=[120, 80])
    for need_lse in (True, False):
        torch.library.opcheck(torch.ops.repro_torch.packed_attn_fwd.default,
                              (q, k, v, *ids, True, 48 if need_lse else None, None, need_lse))
    out, lse = torch.ops.repro_torch.packed_attn_fwd(q, k, v, *ids, True, None, None, True)
    d_out = torch.randn_like(out)
    torch.library.opcheck(torch.ops.repro_torch.packed_attn_bwd.default,
                          (q, k, v, out, lse, d_out, *ids, True, None, None))


@pytest.mark.gpu
def test_gpu_kernel_ops_launch_and_count_visible_pairs(cuda, rng):
    """Through `ops.packed_attention` under autograd each op launches its
    kernel once; the op counter counts each call's visible pairs from the
    ids on the card (2 products forward, 5 backward), and the meta path
    gives the same shapes."""
    from repro_torch.roofline.counter import OpCounter

    q, k, v, *ids = _args(rng, cuda, 2, 256, 4, 2, 64, "bfloat16", doc_lens=[100, 156])
    q.requires_grad_(True)
    before = (_launches(), sum(packed_flash_attention_backward.launches.values()))
    with OpCounter() as c:
        out = ops.packed_attention(q, k, v, *ids, causal=True)
        out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert (_launches(), sum(packed_flash_attention_backward.launches.values())) == \
        (before[0] + 1, before[1] + 1)
    pairs = int(attention_mask(*ids, causal=True, window=None).sum())
    assert c.flops_by_op["repro_torch.packed_attn_fwd"] == 2 * 2 * 64 * 4 * pairs
    assert c.flops_by_op["repro_torch.packed_attn_bwd"] == 5 * 2 * 64 * 4 * pairs
    meta = [x.detach().to("meta") for x in (q, k, v, *ids)]
    m_out, m_lse = torch.ops.repro_torch.packed_attn_fwd(*meta, True, None, None, True)
    assert (m_out.shape, m_out.dtype, m_lse.shape) == (out.shape, out.dtype, (2, 4, 256))
