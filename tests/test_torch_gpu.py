"""On the card: the Hopper packed flash attention kernels (bf16 on the tensor
cores, fp32 on the CUDA cores; the forward's row log-sum-exp; the backward
kernels, bf16 on the tensor cores and fp32 on the CUDA cores) against their
plain PyTorch versions, the port's reduced model, train step and pipeline
engine on the card against themselves on the CPU, and a checkpoint of card
tensors restored onto the card. Every case is
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
    BWD_SIMT,
    BWD_SM90,
    SIMT,
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
from torch_helpers import cuda, n, t  # noqa: F401

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
@pytest.mark.parametrize("dh", [32, 128])
def test_gpu_kernel_ragged_bf16(cuda, rng, S, dh):
    """Lengths that are no tile multiple: TMA zero-fills the ragged edge of
    the tensor-core kernel's tiles."""
    args = _args(rng, cuda, 2, S, 8, 2, dh, "bfloat16")
    out = packed_flash_attention(*args, causal=True)
    ref = packed_attention_ref(*args, causal=True)
    np.testing.assert_allclose(n(out), n(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_gpu_launch_counts_by_dtype(cuda, rng):
    """A bf16 call launches the tensor-core kernel once, an fp32 call the
    CUDA-core kernel once; each raises its own source's count by one."""
    for dtype, kern in (("bfloat16", SM90), ("float32", SIMT)):
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
    source = backward_kernel_for(TDT[dtype]).source
    assert {s: after[s] - before[s] for s in after} == {s: int(s == source) for s in after}
    ref = packed_attention_ref_backward(*args[:3], d_out, *args[3:], **kw)
    _check_grads(got, ref, dtype)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("S", [200, 333])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_backward_matches_plain(cuda, rng, S, dh, group, dtype):
    """Ragged lengths (no multiple of 64 or 128), several documents per row,
    every head width and GQA group: bf16 through the tensor-core backward,
    fp32 through the CUDA-core one."""
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
    kern = backward_kernel_for(TDT[dtype])
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
    """A bf16 backward launches the tensor-core source once and never the
    CUDA-core one; an fp32 backward the CUDA-core source once."""
    assert packed_flash_attention_backward.launches.keys() == {BWD_SM90.source, BWD_SIMT.source}
    for dtype, kern in (("bfloat16", BWD_SM90), ("float32", BWD_SIMT)):
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
    assert l_cpu == {BWD_SM90.source: 0, BWD_SIMT.source: 0}
    assert l_gpu == {BWD_SM90.source: 0, BWD_SIMT.source: cfg.n_layers * 2}
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
    kern, bkern = (SM90, BWD_SM90) if dtype == "bfloat16" else (SIMT, BWD_SIMT)
    got = {s: c - fwd[s] for s, c in packed_flash_attention.launches.items()}
    got_bwd = {s: c - bwd[s] for s, c in packed_flash_attention_backward.launches.items()}
    assert got == {SM90.source: 0, SIMT.source: 0, kern.source: 2 * L * R * M}
    assert got_bwd == {BWD_SM90.source: 0, BWD_SIMT.source: 0, bkern.source: L * R * M}
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
