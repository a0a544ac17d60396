"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Phases, in one process; any failure exits nonzero:
  1. build   every CUDA kernel from src/repro_torch/kernels/csrc with nvcc,
             and check in the SASS that the bf16 kernels, forward and
             backward, run on the tensor cores (HGMMA instructions);
  2. kernel  hold each kernel against its plain PyTorch version on the card
             (bf16 tensor-core forward: serving shape and a packed shape,
             timed also with every visible tile masked, and a windowed
             shape with padding rows; fp32 CUDA-core forward: a ragged
             shape and the parity path's shape; the backward kernels,
             bf16 tensor-core and fp32 CUDA-core, at the same shapes and
             at the shape of each micro-batch the train paths launch them
             on) and time it beside
             its bound, the plain version and one PyTorch library call;
  3. fp32    the fp32 parity path: reduced qwen3-8b in fp32 on the card (the
             CUDA-core forward, one launch per layer, and the backward
             kernel in one train step) against the CPU;
  4. forward full-width, 36-layer qwen3-8b (random bf16 weights from a seed):
             packed forward + loss over synthetic batches, one kernel launch
             per layer, and the Eq. 1 micro-batch predictor fit on the times;
  5. serve   the serving path: packed prefill of 4 x 2048-token prompts
             through the bf16 kernel, then 64 greedy decode steps over a
             2112-slot cache, checked against the packed forward;
  6. train   the training path: full-width qwen3-8b cut to 8 layers (fp32
             masters + AdamW, bf16 compute, remat) trained for 20 steps by
             the port's spmd driver, through the bf16 forward and backward
             kernels, with the Eq. 1 fit and the Detector on the step times;
  7. pipeline the ResiHP runtime: the same model cut to 6 layers under a dp=2, pp=2,
             tp=2 plan (8 plan devices on the one card) trained for 12 steps
             by the port's pipeline driver, with a fail-stop injected at step
             4 and a fail-slow at step 8: detect -> adapt -> recover ->
             resume, each step's loss held to `loss_fn` on the same
             parameters and batch, exact launches per step, and the
             migration identity;
  8. checkpoint the pipeline driver's restart on the fp32 parity model (6
             steps straight against 3 + save + restart + 3) and a Fig. 8b
             recovery from the checkpoint onto the card, bit for bit.
Prints the card's name and power limit first, a `kernels` JSON line before
the last, and as the last line {"ok": true, "device": {...}}. Imports no JAX
and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SERVE_B, PROMPT, NEW_TOKENS = 4, 2048, 64
FORWARD_BATCHES, FIT_BATCHES = 12, 8
# training: 8 layers of full-width qwen3-8b fit one 80 GB card in fp32
# masters + fp32 gradients + AdamW m and v (16 bytes per parameter)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_FIT = 8, 20, 2, 8
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES = 4096, 2, 2
TRAIN_PROFILED_STEP = 1  # after the warm-up step 0; Eq. 1 and the Detector skip it
# the ResiHP runtime: full-width qwen3-8b under a dp x pp x tp plan whose 8
# plan devices all map onto the card; a fail-stop, then a fail-slow. Depth 6,
# not the train phase's 8: at 8 layers the fail-stop's repartition (4/4 ->
# 2/6) gave a stage of 6 layers + the LM head whose recompute did not fit
# beside fp32 masters, AdamW m and v and both replicas' fp32 gradients
# (55.8 GB): out of memory at 74.7 GB allocated on the 80 GB card
PIPE_LAYERS = 6
PIPE_PLAN = {"dp": 2, "pp": 2, "tp": 2}
PIPE_STEPS, PIPE_SEQ, PIPE_BATCH, PIPE_MICROBATCHES = 12, 4096, 4, 2
PIPE_FAILSTOP, PIPE_FAILSLOW = "4:5", "8:1@0.3"
PIPE_RECONFIGS = [4, 8]
PIPE_CHECKED_STEPS = (0, 4, 8, 11)  # engine loss vs loss_fn before the update
PIPE_PROFILED_STEP = 2
TOL_PIPE_LOSS_REL, TOL_MIGRATION = 1e-3, 1e-5
CKPT_STEPS, CKPT_INTERVAL, TOL_RESTART = 6, 3, 1e-5
# the fp32 parity path: reduced qwen3-8b at the real head width
PARITY_SEQ, PARITY_BATCH, PARITY_MICROBATCHES = 256, 2, 2
TOL_BF16, TOL_FP32 = 2e-2, 1e-4
# bf16 end to end, 36 layers: prefill vs the packed forward differ only in
# the LM-head product's shape; the first decode step takes the dense cache
# path (bf16 scores) instead of the kernel (fp32 scores)
TOL_PREFILL_REL, TOL_DECODE_REL = 2e-2, 5e-2


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us_by_kernel(fn, iters):
    """Device time in us of each kernel name over `iters` calls of fn (after
    one warm-up call), from torch.profiler. Host time between launches does
    not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_ms(fn, iters, name=None):
    """Device time per call of fn() in ms: the kernels whose name contains
    `name`, or every kernel the call launches. Unlike `cuda_ms`, host time
    between launches does not count."""
    us = sum(t for key, t in device_us_by_kernel(fn, iters).items() if name is None or name in key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time{f' for {name}' if name else ''}")
    return us / 1e3 / iters


def attention_bound(q, mask, products, moved_bytes):
    """Least time (ms) for packed attention on these inputs, and what bounds it.

    Operations: `products` matrix products of 2 * dh per visible (query,
    key) pair and head, counted from this run's mask (forward: QK^T and PV;
    backward: QK^T again, dP = dO V^T, dV, dK, dQ). Bytes: `moved_bytes`, each
    input read once and each output written once.
    """
    H, dh = q.shape[2], q.shape[3]
    flops = 2.0 * products * dh * H * float(mask.sum())
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, moved_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, moved_bytes


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_case(name, out, ref, tol, seg):
    err = float((out.float() - ref.float()).abs().max())
    bad = ((out.float() - ref.float()).abs() > tol + tol * ref.float().abs()).sum().item()
    if bad or not math.isfinite(err):
        raise AssertionError(f"{name}: {bad} elements outside {tol} (max abs err {err})")
    pad = seg == 0
    if pad.any() and not bool((out[pad] == 0).all()):
        raise AssertionError(f"{name}: padding rows are not exactly 0")
    return err


def all_tiles_masked(fn):
    """fn, run with every visible tile of the wrapper's tile map marked as
    needing the mask (code 1): the bf16 kernel without its unmasked tiles."""
    import repro_torch.kernels.packed_flash_attn as pfa

    def run():
        tile_map = pfa.tile_map
        pfa.tile_map = lambda *a, **kw: tile_map(*a, **kw).clamp_(max=1)
        try:
            return fn()
        finally:
            pfa.tile_map = tile_map
    return run


def kernel_case(name, q, k, v, seg, pos, tol, *, time_it, window=None):
    """Kernel vs plain version on one input; optionally timed. Returns a row."""
    from repro_torch.kernels.packed_flash_attn import (
        SM90, kernel_for, packed_flash_attention, tile_map, tile_sizes)
    from repro_torch.kernels.ref import attention_mask, packed_attention_ref

    args = (q, k, v, seg, seg, pos, pos)
    kw = {"causal": True, "window": window}
    kern = kernel_for(q.dtype)
    out = packed_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = packed_attention_ref(*args, **kw)
    codes = tile_map(seg, seg, pos, pos, *tile_sizes(q.dtype), **kw)
    row = {"case": name, "kernel": kern.source, "shape": list(q.shape),
           "kv_heads": k.shape[2], "dtype": str(q.dtype), "window": window,
           "max_abs_err": check_case(name, out, ref, tol, seg), "tol": tol,
           "padding_rows": int((seg == 0).sum()), "tiles": list(tile_sizes(q.dtype)),
           "skipped_tile_fraction": float((codes == 0).float().mean()),
           "unmasked_tile_fraction": float((codes == 2).float().mean())}
    if time_it:
        mask = attention_mask(seg, seg, pos, pos, **kw)
        # q, k, v and the int32 seg/pos of both sides read, out written
        bound, by, flops, moved = attention_bound(q, mask, 2,
                                                  nbytes(q, k, v, out) + 4 * nbytes(seg))
        # ms: the kernel's own device time; wrapper_*: the whole call (tile
        # map + launch), on the device and on CUDA events (host gaps count)
        call = lambda: packed_flash_attention(*args, **kw)  # noqa: E731
        kname = kern.names[0]
        row.update(ms=device_ms(call, 20, kname), wrapper_device_ms=device_ms(call, 20),
                   wrapper_event_ms=cuda_ms(call, iters=20),
                   plain_ms=device_ms(lambda: packed_attention_ref(*args, **kw), 3),
                   bound_ms=bound, bound_by=by, flops=flops, bytes=moved)
        # yardstick only: one PyTorch call computing the same function
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bmask = mask[:, None]
        row["library_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask, enable_gqa=True), 10)
        row["library_call"] = "torch.nn.functional.scaled_dot_product_attention(bool mask, enable_gqa)"
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
        if kern is SM90:  # what the unmasked tiles (code 2) save, on the same inputs
            masked = all_tiles_masked(call)
            check_case(f"{name} all tiles masked", masked(), ref, tol, seg)
            row["all_masked_ms"] = device_ms(masked, 20, kname)
            row["all_masked_wrapper_event_ms"] = cuda_ms(masked, iters=20)
    log("kernel", json.dumps(row))
    return row


def backward_case(name, q, k, v, seg, pos, tol, *, time_it, window=None):
    """Backward kernel vs autograd through the plain version; optionally
    timed. Returns a row."""
    from repro_torch.kernels.packed_flash_attn import (
        backward_kernel_for, backward_tile_maps, packed_flash_attention,
        packed_flash_attention_backward)
    from repro_torch.kernels.ref import attention_mask, packed_attention_ref_backward

    kw = {"causal": True, "window": window}
    g = torch.Generator(device=q.device)
    g.manual_seed(4321)
    d_out = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    out, lse = packed_flash_attention(q, k, v, seg, seg, pos, pos, **kw, return_lse=True)
    call = lambda: packed_flash_attention_backward(  # noqa: E731
        q, k, v, out, lse, d_out, seg, seg, pos, pos, **kw)
    grads = call()
    torch.cuda.synchronize()
    plain = lambda: packed_attention_ref_backward(  # noqa: E731
        q, k, v, d_out, seg, seg, pos, pos, **kw)
    ref = plain()
    errs = {}
    for gname, a, b in zip(("dq", "dk", "dv"), grads, ref):
        err = float((a.float() - b.float()).abs().max())
        limit = tol * float(b.float().abs().max())
        if not err <= limit:  # also fails on NaN
            raise AssertionError(f"{name}: {gname} max abs err {err} > {limit} "
                                 f"({tol} of max |ref|)")
        errs[gname] = err
    pad = seg == 0
    if pad.any() and not all(bool((x[pad] == 0).all()) for x in grads):
        raise AssertionError(f"{name}: gradients of padding rows or keys are not exactly 0")
    kern = backward_kernel_for(q.dtype)
    _, (codes, codes_dq) = backward_tile_maps(kern, seg, seg, pos, pos, **kw)
    row = {"case": name, "kernel": kern.source, "shape": list(q.shape), "kv_heads": k.shape[2],
           "dtype": str(q.dtype), "window": window, "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tol_of_max_ref": tol,
           "padding_rows": int(pad.sum()), "tiles": [kern.block_q, kern.block_k],
           "skipped_tile_fraction": float((codes == 0).float().mean())}
    if kern.dq_tiles is not None:
        row.update(dq_tiles=list(kern.dq_tiles),
                   dq_skipped_tile_fraction=float((codes_dq == 0).float().mean()),
                   unmasked_tile_fraction=float((codes == 2).float().mean()))
    if time_it:
        mask = attention_mask(seg, seg, pos, pos, **kw)
        # q, k, v, out, d_out, lse and seg/pos read; dq, dk, dv written
        bound, by, flops, moved = attention_bound(
            q, mask, 5, 2 * nbytes(q, k, v) + nbytes(out, d_out, lse) + 4 * nbytes(seg))
        us = device_us_by_kernel(call, 10)
        by_name = {kname: sum(t for key, t in us.items() if kname in key) / 1e3 / 10
                   for kname in kern.names}
        if not all(by_name.values()):  # also when the other source's kernels ran
            raise AssertionError(f"{name}: the profiler saw no device time for {by_name}")
        row.update(ms=sum(by_name.values()), ms_by_kernel=by_name,
                   wrapper_event_ms=cuda_ms(call, iters=10),
                   plain_ms=device_ms(plain, 2), bound_ms=bound, bound_by=by, flops=flops,
                   bytes=moved)
        # yardstick only: SDPA's backward on the same bool mask, out.backward(dO) alone
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
        dot = d_out.transpose(1, 2)
        row["library_ms"] = device_ms(lambda: o.backward(dot, retain_graph=True), 5)
        row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention(bool mask, "
                               "enable_gqa) backward")
        del o, qt, kt, vt
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
    log("backward", json.dumps(row))
    return row


def parity_model(cfg):
    """The fp32 parity path's model and its batch."""
    from repro_torch.configs import reduced
    from repro_torch.data.synth import SyntheticPackedDataset

    small = reduced(cfg, head_dim=cfg.head_dim)
    return small, SyntheticPackedDataset(small, PARITY_SEQ, PARITY_BATCH, seed=0, mu=4.0,
                                         sigma=0.8).batch_at(0)


def microbatch_cases(name, inputs, seg, pos, microbatches, tol):
    """The backward kernel timed at each micro-batch of a packed batch: the
    launches a train step makes."""
    n = seg.shape[0] // microbatches
    return [backward_case(f"{name}{i}", *(x[i * n:(i + 1) * n] for x in (*inputs, seg, pos)),
                          tol, time_it=True) for i in range(microbatches)]


def per_launch(rows):
    """One row for the launches of `rows` (one per micro-batch): the mean
    of each time and bound, the largest error."""
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "wrapper_event_ms")}
    return {**mean, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "shape": rows[0]["shape"], "dtype": rows[0]["dtype"],
            "microbatch_ms": [r["ms"] for r in rows]}


def kernel_phase(cfg, device):
    from repro_torch.data.synth import SyntheticPackedDataset

    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=device)
    g.manual_seed(1234)

    def qkv(B, S, dtype, heads=(H, K, K)):
        return tuple(torch.randn((B, S, h, dh), generator=g, device=device).to(dtype)
                     for h in heads)

    def one_doc(B, S):
        seg = torch.ones((B, S), dtype=torch.int32, device=device)
        return seg, torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)

    rows = {}
    seg, pos = one_doc(SERVE_B, PROMPT)
    inputs = qkv(SERVE_B, PROMPT, torch.bfloat16)
    rows["serving"] = kernel_case("serving", *inputs, seg, pos, TOL_BF16, time_it=True)
    rows["serving_bwd"] = backward_case("serving_bwd", *inputs, seg, pos, TOL_BF16, time_it=True)
    # the packed shape: the forward phase's batch 0
    packed = SyntheticPackedDataset(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    seg = torch.from_numpy(packed.batch_at(0)["segment_ids"]).to(device)
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=device).repeat(TRAIN_BATCH, 1)
    inputs = qkv(TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    rows["packed"] = kernel_case("packed", *inputs, seg, pos, TOL_BF16, time_it=True)
    rows["packed_bwd"] = backward_case("packed_bwd", *inputs, seg, pos, TOL_BF16, time_it=True)
    # the train step's backward launches, one per micro-batch, on the batch of
    # the step the train phase profiles, so that the two times compare
    seg = torch.from_numpy(packed.batch_at(TRAIN_PROFILED_STEP)["segment_ids"]).to(device)
    rows["train_bwd"] = microbatch_cases("train_bwd_microbatch", inputs, seg, pos,
                                         TRAIN_MICROBATCHES, TOL_BF16)
    del inputs
    torch.cuda.empty_cache()
    seg, pos = one_doc(2, 1000)  # ragged, two documents, padding rows, a window
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    inputs = qkv(2, 1000, torch.bfloat16)
    rows["bf16_window_padding"] = kernel_case(
        "bf16_window_padding", *inputs, seg, pos, TOL_BF16, time_it=False, window=256)
    rows["bf16_window_padding_bwd"] = backward_case(
        "bf16_window_padding_bwd", *inputs, seg, pos, TOL_BF16, time_it=False, window=256)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 einsums
    log(f"fp32 check: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    seg, pos = one_doc(2, 777)
    seg[1, 500:] = 2  # a second document and a ragged edge
    pos[1, 500:] -= 500
    inputs = qkv(2, 777, torch.float32)
    rows["fp32_ragged"] = kernel_case("fp32_ragged", *inputs, seg, pos, TOL_FP32, time_it=True)
    rows["fp32_ragged_bwd"] = backward_case("fp32_ragged_bwd", *inputs, seg, pos, TOL_FP32,
                                            time_it=True)
    # the parity path's shapes: its forward's batch, its train step's micro-batches
    small, batch = parity_model(cfg)
    seg = torch.from_numpy(batch["segment_ids"]).to(device)
    pos = torch.arange(PARITY_SEQ, dtype=torch.int32, device=device).repeat(PARITY_BATCH, 1)
    inputs = qkv(PARITY_BATCH, PARITY_SEQ, torch.float32,
                 (small.n_heads, small.n_kv_heads, small.n_kv_heads))
    rows["fp32_parity"] = kernel_case("fp32_parity", *inputs, seg, pos, TOL_FP32, time_it=True)
    rows["fp32_parity_bwd"] = microbatch_cases("fp32_parity_bwd_microbatch", inputs, seg, pos,
                                               PARITY_MICROBATCHES, TOL_FP32)
    return rows


def reset_counts():
    from repro_torch.kernels.packed_flash_attn import (
        packed_flash_attention, packed_flash_attention_backward)

    for counts in (packed_flash_attention.launches, packed_flash_attention_backward.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    """Forward kernel launches by kernel source since the last `reset_counts`."""
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention

    return dict(packed_flash_attention.launches)


def read_backward_counts():
    """Backward kernel launches by kernel source since the last `reset_counts`."""
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention_backward

    return dict(packed_flash_attention_backward.launches)


def fp32_phase(cfg, device):
    """The fp32 parity path: a reduced qwen3-8b (real head width) in fp32 on
    the card, through the CUDA-core kernel, against the same model on the
    CPU: the packed forward's logits, then one train step (2 micro-batches,
    remat, AdamW) through the forward and backward kernels."""
    from repro_torch.kernels.packed_flash_attn import BWD_SIMT, BWD_SM90, SIMT, SM90
    from repro_torch.models.model import forward_train, init_params
    from repro_torch.train.optimizer import make_optimizer, tree_leaves
    from repro_torch.train.train_step import build_train_step

    small, batch = parity_model(cfg)
    params = init_params(small, seed=0, dtype=torch.float32, device="cpu")
    cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
    gpu_b = to_device(batch, device)
    gpu_p = to_tree(params, device)
    with torch.inference_mode():
        reset_counts()
        logits_gpu, _ = forward_train(small, gpu_p, gpu_b, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        counts = read_counts()
        logits_cpu, _ = forward_train(small, params, cpu_b, compute_dtype=torch.float32)
    if counts[SIMT.source] != small.n_layers or counts[SM90.source] != 0:
        raise AssertionError(f"fp32 path launches {counts}, expected {small.n_layers} fp32 only")
    valid = torch.from_numpy(batch["segment_ids"] != 0)
    err = float((logits_gpu.cpu()[valid] - logits_cpu[valid]).abs().max())
    if not err <= TOL_FP32 * (1 + float(logits_cpu[valid].abs().max())):
        raise AssertionError(f"fp32 path: card vs CPU logits differ by {err}")

    stepped, lr = {}, 1e-3
    for dev, p, b in (("cpu", params, cpu_b), ("cuda", gpu_p, gpu_b)):
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        opt = make_optimizer("adamw", lr=lr)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = build_train_step(small, opt, microbatches=PARITY_MICROBATCHES,
                                compute_dtype=torch.float32)
        reset_counts()
        state, metrics = step(state, b)
        if dev == "cuda":
            torch.cuda.synchronize()
            train_counts, bwd_counts = read_counts(), read_backward_counts()
        stepped[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        [x.grad.detach().cpu() for x in tree_leaves(p)],
                        [x.detach().cpu() for x in tree_leaves(p)])
    # per micro-batch and layer: forward + remat recompute, one backward
    want = {SIMT.source: 2 * PARITY_MICROBATCHES * small.n_layers, SM90.source: 0}
    want_bwd = {BWD_SIMT.source: PARITY_MICROBATCHES * small.n_layers, BWD_SM90.source: 0}
    if train_counts != want or bwd_counts != want_bwd:
        raise AssertionError(f"fp32 train step launches {train_counts} {bwd_counts}, "
                             f"expected {want} and {want_bwd}")
    (l_cpu, n_cpu, g_cpu, p_cpu), (l_gpu, n_gpu, g_gpu, p_gpu) = stepped["cpu"], stepped["cuda"]
    step_err = {"loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
                "grad_norm_rel": abs(n_gpu - n_cpu) / abs(n_cpu),
                "grad_max_rel": max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                                    for a, b in zip(g_gpu, g_cpu)),
                "param_max_abs": max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))}
    grads_ok = all(float((a - b).abs().max()) <= TOL_FP32 * float(b.abs().max()) + 1e-7
                   for a, b in zip(g_gpu, g_cpu))
    # AdamW's step m / (sqrt(v) + eps) follows the rounding noise of a
    # gradient within the gradient tolerance of 0 (0 < |g| <= 1e-4 max|g| of
    # its leaf), which can move it anywhere in [-1, 1]: such elements are held
    # to 2 lr and may be at most 0.1% of all (0.051% on the card); every
    # other parameter to 1e-4
    params_ok, exempt = True, 0
    for a, b, g in zip(p_gpu, p_cpu, g_cpu):
        noisy = (g != 0) & (g.abs() <= TOL_FP32 * g.abs().max())
        d = (a - b).abs()
        exempt += int(noisy.sum())
        params_ok = (params_ok and bool((d[noisy] <= 2 * lr).all())
                     and bool((d[~noisy] <= TOL_FP32 + TOL_FP32 * b.abs()[~noisy]).all()))
    step_err["exempt_fraction"] = exempt / sum(x.numel() for x in p_cpu)
    if not (step_err["loss_rel"] <= TOL_FP32 and step_err["grad_norm_rel"] <= TOL_FP32
            and grads_ok and params_ok and step_err["exempt_fraction"] <= 1e-3):
        raise AssertionError(f"fp32 train step: card vs CPU differ: {step_err}")
    res = {"layers": small.n_layers, "head_dim": small.head_dim, "launches": counts,
           "max_abs_err": err, "tol": TOL_FP32, "train_step_launches": train_counts,
           "train_step_backward_launches": bwd_counts, "train_step_err": step_err}
    log("fp32", json.dumps(res))
    return res


def to_tree(tree, device):
    if isinstance(tree, dict):
        return {k: to_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tree(v, device) for v in tree]
    return tree.to(device)


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def forward_phase(cfg, params, device):
    from repro_torch.core.detector.predictor import MicroBatchTimePredictor
    from repro_torch.data.packing import pack_stats
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.packed_flash_attn import SM90
    from repro_torch.models.model import loss_fn

    ds = SyntheticPackedDataset(cfg, seq_len=4096, global_batch=2, seed=0)
    obs = []
    with torch.inference_mode():
        loss_fn(cfg, params, to_device(ds.batch_at(FORWARD_BATCHES), device))  # warm-up
        for i in range(FORWARD_BATCHES):
            raw = ds.batch_at(i)
            batch = to_device(raw, device)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, metrics = loss_fn(cfg, params, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
            launches = counts[SM90.source]
            if launches != cfg.n_layers or sum(counts.values()) != launches:
                raise AssertionError(f"batch {i}: kernel launches {counts}, expected "
                                     f"{cfg.n_layers} of {SM90.source} only")
            if not (math.isfinite(loss) and math.isfinite(float(total))):
                raise AssertionError(f"batch {i}: loss {loss} is not finite")
            stats = pack_stats(raw["segment_ids"])
            n_tok, l2 = sum(s[0] for s in stats), sum(s[1] for s in stats)
            obs.append((n_tok, l2, dt))
            log(f"forward batch {i}: loss={loss:.6f} seconds={dt:.6f} N={n_tok} sum_l2={l2} "
                f"launches={launches}")
    # whole-model chunk times, as every caller of the reference predictor fits
    # them (n_layers=1)
    pred = MicroBatchTimePredictor()
    for n_tok, l2, dt in obs[:FIT_BATCHES]:
        pred.observe(n_tok, l2, dt)
    pred.fit()
    mape = pred.mape([(n_tok, l2, 1, dt) for n_tok, l2, dt in obs[FIT_BATCHES:]])
    fit = {"alpha": pred.alpha, "beta": pred.beta, "gamma": pred.gamma,
           "mape_heldout": mape, "fit_batches": FIT_BATCHES,
           "heldout_batches": len(obs) - FIT_BATCHES}
    log("eq1 fit", json.dumps(fit))
    return {"batches": [{"N": a, "sum_l2": b, "seconds": c} for a, b, c in obs], "eq1": fit}


# kernel names by what they compute, for the shares of a device profile
KERNEL_GROUPS = {"attention_forward": ("packed_flash_attn",), "attention_backward": ("bwd_",),
                 "gemm": ("gemm", "nvjet")}


def device_profile(fn, steps):
    """Device time by kernel over `steps` calls of fn, from torch.profiler,
    and the wall time of the same calls (the profiler's host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = max(sum(e.self_device_time_total for e in kernels), 1e-6)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_seconds_per_call": total_us / 1e6 / steps,
            "profiled_wall_seconds_per_call": wall / steps,
            "top_kernels": [{"name": e.key[:90], "share": e.self_device_time_total / total_us,
                             "count_per_call": e.count / steps} for e in top],
            "group_shares": {g: sum(e.self_device_time_total for e in kernels
                                    if any(w in e.key for w in words)) / total_us
                             for g, words in KERNEL_GROUPS.items()}}


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def serve_phase(cfg, params, device):
    """The main path: prefill through the kernel, then greedy decode."""
    from repro_torch.kernels.packed_flash_attn import SIMT, SM90
    from repro_torch.models.model import extend_cache, forward_train
    from repro_torch.train.train_step import build_prefill_step, build_serve_step

    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(SERVE_B, PROMPT)).astype(np.int32))
    batch = {"tokens": tokens.to(device),
             "segment_ids": torch.ones((SERVE_B, PROMPT), dtype=torch.int32, device=device),
             "positions": torch.arange(PROMPT, dtype=torch.int32, device=device).repeat(SERVE_B, 1)}
    prefill_step, serve_step = build_prefill_step(cfg), build_serve_step(cfg)
    max_len = PROMPT + NEW_TOKENS
    with torch.inference_mode():
        prefill_step(params, batch)  # warm-up (allocator, cuBLAS handles)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        last_logits, caches = prefill_step(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        cache = extend_cache(cfg, caches, max_len)
        del caches
        tok = last_logits[:, -1].argmax(-1).to(torch.int32)
        first_tok, generated, first_logits = tok, [tok], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(NEW_TOKENS):
            lengths = torch.full((SERVE_B,), PROMPT + i, dtype=torch.int32, device=device)
            tok, logits, cache = serve_step(params, cache, {"tokens": tok[:, None], "lengths": lengths})
            if first_logits is None:
                first_logits = logits[:, 0].clone()
            generated.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        by_source = read_counts()
        launches = sum(by_source.values())
        peak = torch.cuda.max_memory_allocated()
        if by_source[SM90.source] != cfg.n_layers or by_source[SIMT.source] != 0:
            raise AssertionError(f"main path launches {by_source}, expected {cfg.n_layers} of "
                                 f"{SM90.source} and none of {SIMT.source}")
        out = torch.stack(generated, 1)
        if out.shape != (SERVE_B, NEW_TOKENS + 1) or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError("decode output has the wrong shape or non-finite logits")

        full, _ = forward_train(cfg, params, batch)
        e_prefill = rel_err(last_logits[:, 0], full[:, -1])
        del full
        ext = {k: torch.cat([v, first_tok[:, None] if k == "tokens" else
                             (v[:, -1:] + 1 if k == "positions" else v[:, -1:])], 1)
               for k, v in batch.items()}
        full, _ = forward_train(cfg, params, ext)
        ref_first = full[:, PROMPT]
        e_decode = rel_err(first_logits, ref_first)
        agree = float((first_logits.argmax(-1) == ref_first.argmax(-1)).float().mean())
        del full
        # where the time goes: device time by kernel; busy share against the
        # unprofiled wall time of the same call
        prof_prefill = device_profile(lambda: prefill_step(params, batch), steps=1)
        step_batch = {"tokens": first_tok[:, None],
                      "lengths": torch.full((SERVE_B,), PROMPT, dtype=torch.int32, device=device)}
        prof_decode = device_profile(lambda: serve_step(params, cache, step_batch), steps=4)
    prof_prefill["busy_share"] = prof_prefill["device_seconds_per_call"] / t_prefill
    prof_decode["busy_share"] = prof_decode["device_seconds_per_call"] / (t_decode / NEW_TOKENS)
    if e_prefill > TOL_PREFILL_REL:
        raise AssertionError(f"prefill logits off the packed forward by {e_prefill} (rel)")
    if e_decode > TOL_DECODE_REL:
        raise AssertionError(f"first decode logits off the packed forward by {e_decode} (rel)")
    res = {"prefill_seconds": t_prefill, "decode_ms_per_token": t_decode / NEW_TOKENS * 1e3,
           "decode_tokens_per_s": SERVE_B * NEW_TOKENS / t_decode,
           "prefill_tokens_per_s": SERVE_B * PROMPT / t_prefill,
           "max_memory_allocated_bytes": peak, "main_path_launches": launches,
           "main_path_launches_by_source": by_source,
           "prefill_rel_err": e_prefill, "prefill_tol": TOL_PREFILL_REL,
           "decode_rel_err": e_decode, "decode_tol": TOL_DECODE_REL,
           "first_decode_argmax_agreement": agree,
           "prefill_profile": prof_prefill, "decode_profile": prof_decode}
    log("serve", json.dumps(res))
    return res


def counting_plain_calls():
    """Count calls of the plain attention version through `kernels.ops`
    (none may happen on a card's main path). Returns (counts, undo)."""
    from repro_torch.kernels import ops

    plain, calls = ops.packed_attention_ref, {"plain_calls": 0}

    def counted(*a, **kw):
        calls["plain_calls"] += 1
        return plain(*a, **kw)

    ops.packed_attention_ref = counted
    return calls, lambda: setattr(ops, "packed_attention_ref", plain)


def train_phase(cfg, device):
    """The training path: full-width qwen3-8b cut to TRAIN_LAYERS layers,
    trained by the port's spmd driver (`launch.train.run_spmd`) through the
    bf16 forward and backward kernels. Checks every step's launches and step
    0's gradients and loss; reports step times, the Eq. 1 fit and the
    Detector's statistics."""
    import dataclasses

    import repro_torch.launch.train as driver
    from repro_torch.core.detector.predictor import MicroBatchTimePredictor
    from repro_torch.data.packing import pack_stats
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.packed_flash_attn import BWD_SIMT, BWD_SM90, SIMT, SM90
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.optimizer import tree_leaves

    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)  # depth only: every width stays
    L, S, B, mb = TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES
    args = driver.parser().parse_args(
        ["--steps", str(TRAIN_STEPS), "--seq-len", str(S), "--batch", str(B), "--microbatches",
         str(mb), "--lr", "1e-3", "--seed", "0", "--device", str(device)])
    ds = SyntheticPackedDataset(tcfg, S, B, seed=args.seed)

    # step 0's loss by loss_fn, on the params the driver draws from the same
    # seed and on the same micro-batches, before the counted run
    params = init_params(tcfg, args.seed, dtype=torch.float32, device=device)
    batch, n = to_device(ds.batch_at(0), device), B // mb
    with torch.no_grad():
        loss0_fn = sum(float(loss_fn(tcfg, params, {k: v[i * n:(i + 1) * n]
                                                    for k, v in batch.items()})[0])
                       for i in range(mb)) / mb
    del params, batch
    torch.cuda.empty_cache()

    def counts():
        return {**read_counts(), **{f"backward[{k}]": v for k, v in read_backward_counts().items()},
                "plain_calls": calls["plain_calls"]}

    per_step, step0 = [], {}
    build = driver.build_train_step

    def checked_build(cfg_, opt, **kw):
        step_fn = build(cfg_, opt, **kw)

        def step(state, batch):
            before = counts()
            if len(per_step) == TRAIN_PROFILED_STEP:
                out = []
                step0["profile"] = device_profile(lambda: out.append(step_fn(state, batch)), 1)
                state, metrics = out[0]
            else:
                state, metrics = step_fn(state, batch)
            per_step.append({k: v - before[k] for k, v in counts().items()})
            if len(per_step) == 1:
                flags = [bool(torch.isfinite(p.grad).all() & (p.grad != 0).any())
                         for p in tree_leaves(state["params"])]
                step0.update(leaves=len(flags), leaves_with_finite_nonzero_grad=sum(flags))
            return state, metrics

        return step

    calls, undo = counting_plain_calls()
    driver.build_train_step = checked_build
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = driver.run_spmd(tcfg, args)
        torch.cuda.synchronize()
        total = counts()
    finally:
        driver.build_train_step = build
        undo()
    peak = torch.cuda.max_memory_allocated()

    # per step: each micro-batch runs every layer's forward kernel twice
    # (forward and remat recompute) and its backward kernel once, all bf16
    want = {SM90.source: 2 * L * mb, SIMT.source: 0, f"backward[{BWD_SM90.source}]": L * mb,
            f"backward[{BWD_SIMT.source}]": 0, "plain_calls": 0}
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"train step {i}: launches {got}, expected {want}")
    if len(per_step) != TRAIN_STEPS or total != {k: v * TRAIN_STEPS for k, v in want.items()}:
        raise AssertionError(f"train run: {len(per_step)} steps, launches {total}")
    if step0["leaves_with_finite_nonzero_grad"] != step0["leaves"]:
        raise AssertionError(f"step 0: only {step0['leaves_with_finite_nonzero_grad']} of "
                             f"{step0['leaves']} parameter leaves have a finite nonzero gradient")
    losses, times = result["losses"], result["times"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite: {losses}")
    loss0_rel = abs(losses[0] - loss0_fn) / abs(loss0_fn)
    if not loss0_rel <= 1e-3:
        raise AssertionError(f"step 0 loss {losses[0]} vs loss_fn {loss0_fn}")

    # Eq. 1 on whole-step times (forward + backward of both micro-batches),
    # after the warm-up steps the driver skips too
    obs = []
    for it in range(TRAIN_WARMUP, TRAIN_STEPS):
        stats = pack_stats(ds.batch_at(it)["segment_ids"])
        obs.append((sum(x[0] for x in stats), sum(x[1] for x in stats), times[it]))
    pred = MicroBatchTimePredictor()
    for n_tok, l2, dt in obs[:TRAIN_FIT]:
        pred.observe(n_tok, l2, dt)
    pred.fit()
    mape = pred.mape([(n_tok, l2, 1, dt) for n_tok, l2, dt in obs[TRAIN_FIT:]])
    steady = times[TRAIN_WARMUP:]
    res = {"layers": L, "steps": TRAIN_STEPS, "seq_len": S, "batch": B, "microbatches": mb,
           "params": tcfg.param_count(), "losses": losses, "step_seconds": times,
           "step_seconds_mean": sum(steady) / len(steady),
           "step_seconds_min": min(steady), "step_seconds_max": max(steady),
           "positions_per_s": B * S * len(steady) / sum(steady),
           "tokens_per_s": sum(o[0] for o in obs) / sum(steady),
           "launches_per_step": want, "launches": total,
           "step0_loss": losses[0], "step0_loss_fn": loss0_fn, "step0_loss_rel": loss0_rel,
           "step0_leaves": step0["leaves"],
           "eq1": {"alpha": pred.alpha, "beta": pred.beta, "gamma": pred.gamma,
                   "mape_heldout": mape, "fit_steps": TRAIN_FIT,
                   "heldout_steps": len(obs) - TRAIN_FIT},
           "detector": result["detector"], "max_memory_allocated_bytes": peak,
           "profiled_step": TRAIN_PROFILED_STEP, "profile": step0["profile"]}
    # device time over the wall time of the same step; the profiler's host
    # cost counts in that wall, so this is a lower bound on the busy share
    prof = res["profile"]
    prof["busy_share"] = prof["device_seconds_per_call"] / prof["profiled_wall_seconds_per_call"]
    log("train", json.dumps(res))
    return res


def counting_lse_calls():
    """Count the forward wrapper's calls through `kernels.ops` by whether
    they ask for the row log-sum-exp (the autograd path) or not. Returns
    (counts, undo)."""
    from repro_torch.kernels import ops

    inner, calls = ops.packed_flash_attention, {"with_lse": 0, "without_lse": 0}

    def counted(*a, return_lse=False, **kw):
        calls["with_lse" if return_lse else "without_lse"] += 1
        return inner(*a, return_lse=return_lse, **kw)

    ops.packed_flash_attention = counted
    return calls, lambda: setattr(ops, "packed_flash_attention", inner)


def pipeline_args(driver, steps, seq, batch, device, *extra):
    return driver.parser().parse_args(
        ["--mode", "pipeline", "--steps", str(steps), "--seq-len", str(seq), "--batch", str(batch),
         "--microbatches", str(PIPE_MICROBATCHES), "--lr", "1e-3", "--seed", "0",
         "--device", str(device), *extra])


def pipeline_phase(cfg, device):
    """The ResiHP runtime on the train phase's model: the port's pipeline
    driver (`launch.train.run_pipeline`) under a dp=2, pp=2, tp=2 plan,
    a fail-stop at step 4 and a fail-slow at step 8. Checks the
    reconfiguration steps and plans, every step's launches, the engine's
    loss against `loss_fn` on the same parameters and batch before the
    update, and then the migration identity; reports step times around each
    reconfiguration, the planning and recovery overheads and peak memory."""
    import dataclasses

    import repro_torch.launch.train as driver
    from repro_torch.core.detector.dag_sim import ChunkId
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.packed_flash_attn import BWD_SIMT, BWD_SM90, SIMT, SM90
    from repro_torch.models.model import loss_fn

    from repro_torch.core.scheduler.plan import initial_plan

    tcfg = dataclasses.replace(cfg, n_layers=PIPE_LAYERS)  # depth only: every width stays
    plan_flags = [x for k, v in PIPE_PLAN.items() for x in (f"--{k}", str(v))]
    args = pipeline_args(driver, PIPE_STEPS, PIPE_SEQ, PIPE_BATCH, device, *plan_flags,
                         "--inject-failstop", PIPE_FAILSTOP, "--inject-failslow", PIPE_FAILSLOW)
    ds = SyntheticPackedDataset(tcfg, PIPE_SEQ, PIPE_BATCH, seed=args.seed)

    def counts():
        return {**read_counts(), **{f"backward[{k}]": v for k, v in read_backward_counts().items()},
                "plain_calls": plain["plain_calls"], **{f"forward_{k}": v for k, v in lse.items()}}

    def diff(after, before):
        return {k: v - before[k] for k, v in after.items()}

    per_step, checks, engines, prof, engine_seconds = [], [], [], {}, []
    check_launches = {}
    Engine = driver.PipelineEngine

    class CheckedEngine(Engine):
        """The driver's engine, with each step's launches counted and, at
        PIPE_CHECKED_STEPS, its loss held to loss_fn before the update."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def run_iteration(self, batch, **kw):
            step = self.step
            ref = None
            if step in PIPE_CHECKED_STEPS:
                before = counts()
                with torch.no_grad():  # token-weighted over rows, as the engine forms it
                    nll = ntok = 0.0
                    for b in range(batch["tokens"].shape[0]):
                        _, m = loss_fn(tcfg, self.params_full, {k: v[b:b + 1]
                                                                for k, v in batch.items()})
                        nll += float(m["loss"]) * float(m["ntokens"])
                        ntok += float(m["ntokens"])
                ref = nll / ntok
                for k, v in diff(counts(), before).items():
                    check_launches[k] = check_launches.get(k, 0) + v
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == PIPE_PROFILED_STEP:
                out = []
                prof.update(device_profile(
                    lambda: out.append(Engine.run_iteration(self, batch, **kw)[0]), 1))
                loss = out[0]
            else:
                loss = Engine.run_iteration(self, batch, **kw)[0]
            torch.cuda.synchronize()
            engine_seconds.append(time.perf_counter() - t0)
            per_step.append(diff(counts(), before))
            if ref is not None:
                checks.append({"step": step, "engine_loss": loss, "loss_fn": ref,
                               "rel": abs(loss - ref) / abs(ref), "plan": self.plan.summary()})
            return loss, None

    plain, undo_plain = counting_plain_calls()
    lse, undo_lse = counting_lse_calls()
    driver.PipelineEngine = CheckedEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = driver.run_pipeline(tcfg, args)
        torch.cuda.synchronize()
        total = counts()
    finally:
        driver.PipelineEngine = Engine
        undo_plain()
        undo_lse()
    peak = torch.cuda.max_memory_allocated()

    # per step, whatever the partition: every micro-batch of every replica
    # runs each layer's forward kernel in F (no row log-sum-exp) and in B's
    # recompute (with it), and each layer's backward kernel once in B
    L, R, M = PIPE_LAYERS, PIPE_PLAN["dp"], PIPE_MICROBATCHES
    want = {SM90.source: 2 * L * R * M, SIMT.source: 0, f"backward[{BWD_SM90.source}]": L * R * M,
            f"backward[{BWD_SIMT.source}]": 0, "plain_calls": 0,
            "forward_with_lse": L * R * M, "forward_without_lse": L * R * M}
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"pipeline step {i}: launches {got}, expected {want}")
    engine_total = diff(total, check_launches)
    if len(per_step) != PIPE_STEPS or engine_total != {k: v * PIPE_STEPS for k, v in want.items()}:
        raise AssertionError(f"pipeline run: {len(per_step)} steps, launches {engine_total} "
                             f"(besides {check_launches} of the loss_fn checks)")
    # the engine's own step times: the driver's also hold the loss_fn checks
    losses, times = result["losses"], engine_seconds[:]  # before the migration check's runs
    if len(losses) != PIPE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pipeline losses not finite: {losses}")
    if result["reconfigs"] != PIPE_RECONFIGS:
        raise AssertionError(f"reconfigurations at {result['reconfigs']}, expected {PIPE_RECONFIGS}")
    initial = initial_plan(PIPE_LAYERS, **PIPE_PLAN).summary()
    plans = [initial] + [a["plan"] for a in result["adaptations"]]
    if len(set(plans)) != len(plans) or [c["plan"] for c in checks] != [
            initial, plans[1], plans[2], plans[2]]:
        raise AssertionError(f"the plans did not change as injected: {plans}, checks {checks}")
    if [c["step"] for c in checks] != list(PIPE_CHECKED_STEPS) or not all(
            c["rel"] <= TOL_PIPE_LOSS_REL for c in checks):
        raise AssertionError(f"engine loss vs loss_fn: {checks}")

    # migration identity: F and B of (mb 0, stage 1, replica 0) on replica 1,
    # optimizer off, on the final plan; the same loss
    engine = engines[0]
    engine.optimizer = None
    batch = to_device(ds.batch_at(PIPE_STEPS), device)
    base = engine.run_iteration(batch)[0]
    placement = {ChunkId("F", 0, 1, 0): (1, 1), ChunkId("B", 0, 1, 0): (1, 1)}
    migrated = engine.run_iteration(batch, placement=placement)[0]
    torch.cuda.synchronize()
    if not abs(base - migrated) <= TOL_MIGRATION:
        raise AssertionError(f"migration identity: {base} vs {migrated}")
    del engine, engines[:]

    def mean(xs):
        return sum(xs) / len(xs)

    a, b = PIPE_RECONFIGS

    def steady(lo, hi):  # step 0 warms up; the profiled step carries the profiler's host cost
        return mean([times[i] for i in range(max(lo, 1), hi) if i != PIPE_PROFILED_STEP])

    res = {"layers": L, "steps": PIPE_STEPS, "seq_len": PIPE_SEQ, "batch": PIPE_BATCH,
           "microbatches": M, "plan": PIPE_PLAN, "failstop": PIPE_FAILSTOP,
           "failslow": PIPE_FAILSLOW, "params": tcfg.param_count(), "losses": losses,
           "step_seconds": times, "driver_step_seconds": result["times"],
           "reconfigs": result["reconfigs"], "plans": plans,
           "step_seconds_mean": {"before": steady(0, a), "after_failstop": steady(a, b),
                                 "after_failslow": steady(b, PIPE_STEPS)},
           "first_step_after": {"failstop": times[a], "failslow": times[b]},
           "adaptations": result["adaptations"],
           "loss_checks": checks, "loss_tol_rel": TOL_PIPE_LOSS_REL,
           "migration": {"base": base, "migrated": migrated, "abs": abs(base - migrated),
                         "tol": TOL_MIGRATION},
           "launches_per_step": want, "launches": engine_total, "check_launches": check_launches,
           "max_memory_allocated_bytes": peak, "profiled_step": PIPE_PROFILED_STEP,
           "profile": prof}
    prof["busy_share"] = prof["device_seconds_per_call"] / prof["profiled_wall_seconds_per_call"]
    for ad in result["adaptations"]:
        log(f"pipeline adaptation at step {ad['step']}: {ad['plan']}; {len(ad['moves'])} layer "
            f"moves, {ad['bytes']} bytes modelled; plan_overhead_s {ad['plan_overhead_s']:.6f}; "
            f"recover + apply_plan {ad['recover_seconds']:.6f} s")
    log(f"pipeline step seconds: {times}")
    log("pipeline", json.dumps(res))
    return res


def checkpoint_phase(cfg, device):
    """Checkpoint and restart on the card, on the fp32 parity model: the
    pipeline driver 6 steps straight against 3 + save + restart + 3 (the
    same final loss), then a Fig. 8b recovery (both replicas of stage 0
    dead) from a checkpoint of a trained engine's state onto the card, bit
    for bit. Reports save and restore seconds and bytes."""
    import tempfile

    import repro_torch.launch.train as driver
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.core.recovery import recover_state
    from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan, initial_plan
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.engine.pipeline import PipelineEngine
    from repro_torch.train.optimizer import make_optimizer

    small, _ = parity_model(cfg)
    B = PIPE_PLAN["dp"] * PIPE_MICROBATCHES
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)

        def run(steps, where, *extra):
            return driver.run_pipeline(small, pipeline_args(
                driver, steps, PARITY_SEQ, B, device, "--ckpt-dir", str(root / where),
                "--ckpt-interval", str(CKPT_INTERVAL), *extra))

        straight = run(CKPT_STEPS, "straight")
        run(CKPT_STEPS // 2, "restart")
        restarted = run(CKPT_STEPS, "restart", "--resume")
        restart_err = abs(restarted["losses"][-1] - straight["losses"][-1])
        if len(restarted["losses"]) != CKPT_STEPS - CKPT_STEPS // 2 or not restart_err <= TOL_RESTART:
            raise AssertionError(f"restart: {restarted['losses']} vs {straight['losses']}")

        # Fig. 8b: stage 0 lost in both replicas; the state comes back from disk
        old = initial_plan(small.n_layers, PIPE_PLAN["dp"], 2, 1, microbatches=PIPE_MICROBATCHES)
        new = ParallelPlan(tuple(ReplicaPlan((StagePlan((), r.stages[0].layers), r.stages[1]))
                                 for r in old.replicas))
        engine = PipelineEngine(small, old, optimizer=make_optimizer("adamw", lr=1e-3),
                                devices=[device])
        engine.run_iteration(to_device(SyntheticPackedDataset(small, PARITY_SEQ, B, seed=0)
                                       .batch_at(0), device))
        state = {"params": engine.params_full, "opt": engine.opt_state, "step": engine.step}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(root / "fig8b", state, engine.step)
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.glob("leaf_*.npy"))
        t0 = time.perf_counter()
        got, tp, step = recover_state(small, state, old_plan=old, new_plan=new, shardings=device,
                                      checkpoint_mgr=CheckpointManager(root / "fig8b"),
                                      dead_stages=[(0, 0), (1, 0)])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want_leaves, got_leaves = ckpt_leaves(state), ckpt_leaves(got)
    exact = len(want_leaves) == len(got_leaves) and all(
        isinstance(g, torch.Tensor) and g.device == w.device and torch.equal(g, w)
        if isinstance(w, torch.Tensor) else g == w for w, g in zip(want_leaves, got_leaves))
    if not (tp.restore_required and step == engine.step and exact):
        raise AssertionError(f"Fig. 8b restore: required {tp.restore_required}, step {step}, "
                             f"bit-exact on the card {exact}")
    res = {"model": {"layers": small.n_layers, "d_model": small.d_model, "head_dim": small.head_dim},
           "seq_len": PARITY_SEQ, "batch": B, "straight_losses": straight["losses"],
           "restarted_losses": restarted["losses"], "restart_abs_err": restart_err,
           "tol": TOL_RESTART, "fig8b": {"moves": len(tp.moves), "restored_step": step,
                                         "leaves": len(want_leaves), "bit_exact": exact},
           "save_seconds": save_s, "restore_seconds": restore_s, "bytes": n_bytes}
    log("checkpoint", json.dumps(res))
    return res


def ckpt_leaves(tree):
    """Leaves of a state tree, dict keys sorted (the checkpoint's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in ckpt_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in ckpt_leaves(v)]
    return [tree]


def sass_count(lib, opcode):
    """Lines of the library's SASS (cuobjdump, beside nvcc) with `opcode`."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_flash_attn import BWD_SIMT, BWD_SM90, SIMT, SM90
    from repro_torch.models.model import init_params

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = {"card": smi[0], "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    build.build_all()
    record["build_seconds"] = time.perf_counter() - t0
    for src, text in build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "wgmma")):
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {record['build_seconds']:.1f} s")
    # the bf16 kernels must run on the tensor cores: HGMMA in their SASS
    record["hgmma_instructions"] = {k.source: sass_count(build.library_path(k.source), "HGMMA")
                                    for k in (SM90, SIMT, BWD_SM90, BWD_SIMT)}
    log(f"sass: HGMMA instructions {record['hgmma_instructions']}")
    for kern in (SM90, BWD_SM90):
        if record["hgmma_instructions"][kern.source] == 0:
            raise AssertionError(f"{kern.source}: no HGMMA instruction in its SASS")

    cfg = get_arch("qwen3-8b")
    record["kernel"] = kernel_phase(cfg, device)
    torch.cuda.empty_cache()
    record["fp32_path"] = fp32_phase(cfg, device)

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for layer in params["layers"] for d in layer.values()
                   for p in (d.values() if isinstance(d, dict) else [d]))
    n_params += sum(v.numel() for k, v in params.items() if k != "layers")
    record["params"] = n_params
    log(f"qwen3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")

    record["forward"] = forward_phase(cfg, params, device)
    record["serve"] = serve_phase(cfg, params, device)
    del params  # the train phase needs the card's memory
    torch.cuda.empty_cache()
    record["train"] = train_phase(cfg, device)
    torch.cuda.empty_cache()
    record["pipeline"] = pipeline_phase(cfg, device)
    torch.cuda.empty_cache()
    record["checkpoint"] = checkpoint_phase(cfg, device)

    def entry(name, kern, row, launches, **extra):
        return {"name": name,
                "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{kern.source}",
                "replaces": "src/repro/kernels/packed_flash_attn.py:39", "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "wrapper_event_ms": row["wrapper_event_ms"],
                "shape": row["shape"], "dtype": row["dtype"], **extra}

    serve_launches = record["serve"]["main_path_launches_by_source"][SM90.source]
    # the backward's device time per launch inside the profiled train step
    prof = record["train"]["profile"]
    train_bwd_ms = (prof["group_shares"]["attention_backward"] * prof["device_seconds_per_call"]
                    * 1e3 / record["train"]["launches_per_step"][f"backward[{BWD_SM90.source}]"])
    kernels = [  # bf16: the main paths (serve; train), at their shapes; fp32: the parity path
        entry("packed_flash_attention", SM90, record["kernel"]["serving"], serve_launches,
              wrapper_device_ms=record["kernel"]["serving"]["wrapper_device_ms"],
              launches_by_path={"serve": serve_launches,
                                "train": record["train"]["launches"][SM90.source],
                                "pipeline": record["pipeline"]["launches"][SM90.source]}),
        entry("packed_flash_attention[float32]", SIMT, record["kernel"]["fp32_parity"],
              record["fp32_path"]["launches"][SIMT.source],
              wrapper_device_ms=record["kernel"]["fp32_parity"]["wrapper_device_ms"]),
        # the backward: per launch, at the train paths' micro-batches
        entry("packed_flash_attention_backward", BWD_SM90,
              per_launch(record["kernel"]["train_bwd"]),
              record["train"]["launches"][f"backward[{BWD_SM90.source}]"],
              train_step_ms_per_launch=train_bwd_ms,
              launches_by_path={
                  path: record[path]["launches"][f"backward[{BWD_SM90.source}]"]
                  for path in ("train", "pipeline")}),
        entry("packed_flash_attention_backward[float32]", BWD_SIMT,
              per_launch(record["kernel"]["fp32_parity_bwd"]),
              record["fp32_path"]["train_step_backward_launches"][BWD_SIMT.source]),
    ]
    record["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
