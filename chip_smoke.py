"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Phases, in one process; any failure exits nonzero:
  1. build   every CUDA kernel from src/repro_torch/kernels/csrc with nvcc,
             and check in the SASS that the bf16 kernel runs on the tensor
             cores (HGMMA instructions);
  2. kernel  hold each kernel against its plain PyTorch version on the card
             (bf16 tensor-core kernel: serving shape and a packed shape,
             timed also with every visible tile masked, and a windowed
             shape with padding rows; fp32 CUDA-core kernel: a ragged shape)
             and time it beside its bound, the plain version and one
             PyTorch library call;
  3. fp32    the fp32 parity path: reduced qwen3-8b in fp32 on the card (the
             CUDA-core kernel, one launch per layer) against the CPU;
  4. forward full-width, 36-layer qwen3-8b (random bf16 weights from a seed):
             packed forward + loss over synthetic batches, one kernel launch
             per layer, and the Eq. 1 micro-batch predictor fit on the times;
  5. serve   the main path: packed prefill of 4 x 2048-token prompts through
             the bf16 kernel, then 64 greedy decode steps over a 2112-slot
             cache, checked against the packed forward.
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


def device_ms(fn, iters, name=None):
    """Device time per call of fn() in ms, from torch.profiler: the kernels
    whose name contains `name`, or every kernel the call launches. Unlike
    `cuda_ms`, host time between launches does not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and (name is None or name in e.key))
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time{f' for {name}' if name else ''}")
    return us / 1e3 / iters


def attention_bound(q, k, mask, out_bytes, extra_bytes):
    """Least time (ms) for packed attention on these inputs, and what bounds it.

    Operations: 4 * dh per visible (query, key) pair and head (QK^T and PV),
    counted from this run's mask. Bytes: q, k, v and the int32 seg/pos read
    once, the output written once.
    """
    H, dh = q.shape[2], q.shape[3]
    flops = 4.0 * dh * H * float(mask.sum())
    nbytes = (q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
              + out_bytes + extra_bytes)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


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
        bound, by, flops, nbytes = attention_bound(
            q, k, mask, out.numel() * out.element_size(), 4 * seg.numel() * 4)
        # ms: the kernel's own device time; wrapper_*: the whole call (tile
        # map + launch), on the device and on CUDA events (host gaps count)
        call = lambda: packed_flash_attention(*args, **kw)  # noqa: E731
        kname = f"{kern.symbol}_kernel"
        row.update(ms=device_ms(call, 20, kname), wrapper_device_ms=device_ms(call, 20),
                   wrapper_event_ms=cuda_ms(call, iters=20),
                   plain_ms=device_ms(lambda: packed_attention_ref(*args, **kw), 3),
                   bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)
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


def kernel_phase(cfg, device):
    from repro_torch.data.synth import SyntheticPackedDataset

    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=device)
    g.manual_seed(1234)

    def qkv(B, S, dtype):
        return tuple(torch.randn((B, S, h, dh), generator=g, device=device).to(dtype)
                     for h in (H, K, K))

    def one_doc(B, S):
        seg = torch.ones((B, S), dtype=torch.int32, device=device)
        return seg, torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)

    rows = {}
    seg, pos = one_doc(SERVE_B, PROMPT)
    rows["serving"] = kernel_case("serving", *qkv(SERVE_B, PROMPT, torch.bfloat16), seg, pos,
                                  TOL_BF16, time_it=True)
    packed = SyntheticPackedDataset(cfg, 4096, 2, seed=0).batch_at(0)
    seg = torch.from_numpy(packed["segment_ids"]).to(device)
    pos = torch.arange(4096, dtype=torch.int32, device=device).repeat(2, 1)  # abs positions
    rows["packed"] = kernel_case("packed", *qkv(2, 4096, torch.bfloat16), seg, pos,
                                 TOL_BF16, time_it=True)
    seg, pos = one_doc(2, 1000)  # ragged, two documents, padding rows, a window
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    rows["bf16_window_padding"] = kernel_case(
        "bf16_window_padding", *qkv(2, 1000, torch.bfloat16), seg, pos, TOL_BF16,
        time_it=False, window=256)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 einsums
    log(f"fp32 check: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    seg, pos = one_doc(2, 777)
    seg[1, 500:] = 2  # a second document and a ragged edge
    pos[1, 500:] -= 500
    rows["fp32_ragged"] = kernel_case("fp32_ragged", *qkv(2, 777, torch.float32), seg, pos,
                                      TOL_FP32, time_it=True)
    return rows


def reset_counts():
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention

    for src in packed_flash_attention.launches:
        packed_flash_attention.launches[src] = 0


def read_counts():
    """Kernel launches by kernel source since the last `reset_counts`."""
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention

    return dict(packed_flash_attention.launches)


def fp32_phase(cfg, device):
    """The fp32 parity path: a reduced qwen3-8b (real head width) in fp32 on
    the card, through the CUDA-core kernel, against the same model on the CPU."""
    from repro_torch.configs import reduced
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.packed_flash_attn import SIMT, SM90
    from repro_torch.models.model import forward_train, init_params

    small = reduced(cfg, head_dim=cfg.head_dim)
    params = init_params(small, seed=0, dtype=torch.float32, device="cpu")
    batch = SyntheticPackedDataset(small, 256, 2, seed=0, mu=4.0, sigma=0.8).batch_at(0)
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
    res = {"layers": small.n_layers, "head_dim": small.head_dim, "launches": counts,
           "max_abs_err": err, "tol": TOL_FP32}
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


def device_profile(fn, steps):
    """Device time by kernel over `steps` calls of fn, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_seconds_per_call": device_s,
            "top_kernels": [{"name": e.key[:90], "share": e.self_device_time_total / 1e6 / steps
                             / max(device_s, 1e-12), "count_per_call": e.count / steps}
                            for e in top]}


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
    from repro_torch.kernels.packed_flash_attn import SIMT, SM90
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
    # the bf16 kernel must run on the tensor cores: HGMMA in its SASS
    record["hgmma_instructions"] = {k.source: sass_count(build.library_path(k.source), "HGMMA")
                                    for k in (SM90, SIMT)}
    log(f"sass: HGMMA instructions {record['hgmma_instructions']}")
    if record["hgmma_instructions"][SM90.source] == 0:
        raise AssertionError(f"{SM90.source}: no HGMMA instruction in its SASS")

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

    def entry(name, kern, row, launches):
        return {"name": name,
                "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{kern.source}",
                "replaces": "src/repro/kernels/packed_flash_attn.py:39", "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "wrapper_device_ms": row["wrapper_device_ms"],
                "wrapper_event_ms": row["wrapper_event_ms"]}

    kernels = [  # bf16: the main path (serve), at the serving shape; fp32: its parity path
        entry("packed_flash_attention", SM90, record["kernel"]["serving"],
              record["serve"]["main_path_launches_by_source"][SM90.source]),
        entry("packed_flash_attention[float32]", SIMT, record["kernel"]["fp32_ragged"],
              record["fp32_path"]["launches"][SIMT.source]),
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
