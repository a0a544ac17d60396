"""Time the attention kernels and a train step of dense archs in several trees, on one card.

    python3 chip_compare.py --trees _archive/parent . . _archive/parent \\
        [--arch h2o-danube-1.8b ...] [--head-dims 64 80 128] [--fp32-forward]
        [--multimodal [bf16] [fp32]] [--multimodal-train ARCH ...] [--skip-train]
        [--out FILE.json]

Each tree is a checkout of this repository (for an older commit, a `git
archive` unpacked into a git-ignored directory). For each tree in the order
given, a fresh process runs that tree's own `chip_smoke.py` functions with
that tree's `src/` on the path: it builds the tree's kernels, runs
`family_kernel_phase` for each `--arch` (chip_smoke's `FAMILY_KERNEL_ARCHS`;
h2o-danube-1.8b by default, none after a bare `--arch`: bf16 and fp32
forward and backward at 1 x 4096, each against its plain version and timed
beside its bound and SDPA) and, unless `--skip-train`, `train_phase` of
each arch at full depth (the arch's family train steps). `--head-dims` adds
the bf16 forward and backward at an arch's heads, documents and window at
each of those head widths, which shows how much of a kernel's time follows
its products. `--fp32-forward` adds the fp32 forward alone at every family
arch's 1 x 4096 case (where `--arch` did not run it), at the ragged 2 x 777
shape (qwen3-8b's heads) and at each fp32 parity path's 2 x 256 batch and
heads (chip_smoke's `PARITY_ARCHS`). `--multimodal [bf16] [fp32]` adds
that tree's `multimodal_kernel_phase`: whisper-medium's five attention
regimes at head_dim 64 (16/16 heads), in the dtypes named (both when none
is), forward and backward, the backward's time split by kernel. The full
record also keeps each tree's ptxas registers and spills. Naming a tree
twice, as parent, change, change, parent, shows the spread beside the
difference. `--multimodal-train whisper-medium` (or qwen2-vl-7b) adds that
arch's train steps as chip_smoke's multimodal phase runs them. Prints one
JSON summary per run and, as the last line, the summaries of all runs;
`--out` also keeps every run's full record. Needs a CUDA card; exits
nonzero without one or if any run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

WORKER = """
import json, sys, time
from inspect import signature
import torch
import chip_smoke as cs
from repro_torch.configs import get_arch
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.kernels import build

opts = json.loads(sys.argv[1])
trace = cs.device_us_by_kernel


def retrying(fn, iters):  # an empty trace is taken again, in every tree's functions
    for _ in range(3):
        us = trace(fn, iters)
        if us:
            return us
    return us


cs.device_us_by_kernel = retrying
device = torch.device("cuda", 0)
torch.cuda.set_device(device)
torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 einsums
t0 = time.perf_counter()
build.build_all()
record = {"build_seconds": time.perf_counter() - t0, "train": {},
          "ptxas": {src: cs.ptxas_by_function(build.build_log(src))
                    for src in sorted(p.name for p in build.CSRC.glob("*.cu"))}}
g = torch.Generator(device=device)
g.manual_seed(99)
rows = record["family_kernel"] = {}
family = cs.FAMILY_KERNEL_ARCHS
for arch in opts["archs"]:
    cs.FAMILY_KERNEL_ARCHS = (arch,)
    rows.update(cs.family_kernel_phase(device))
    torch.cuda.empty_cache()
    cfg = get_arch(arch)
    seg = torch.from_numpy(SyntheticPackedDataset(cfg, cs.FAMILY_SEQ, 1, seed=0).batch_at(0)[
        "segment_ids"]).to(device)
    pos = torch.arange(cs.FAMILY_SEQ, dtype=torch.int32, device=device)[None]
    for dh in opts["head_dims"]:  # the family phase's case at other head widths
        inputs = tuple(torch.randn((1, cs.FAMILY_SEQ, h, dh), generator=g, device=device)
                       .to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        name, kw = f"{arch}_bf16_dh{dh}", {"time_it": True, "window": cs.arch_window(cfg)}
        rows[name] = cs.kernel_case(name, *inputs, seg, pos, cs.TOL_BF16, time_masked=False, **kw)
        rows[name + "_bwd"] = cs.backward_case(name + "_bwd", *inputs, seg, pos, cs.TOL_BF16, **kw)
        del inputs
        torch.cuda.empty_cache()
if opts["fp32_forward"]:  # the family's 1 x 4096 documents, the ragged shape, the parity batches
    for arch in family:
        name = f"{arch}_fp32"
        if name in rows:
            continue
        cfg = get_arch(arch)
        seg = torch.from_numpy(SyntheticPackedDataset(cfg, cs.FAMILY_SEQ, 1, seed=0).batch_at(0)[
            "segment_ids"]).to(device)
        pos = torch.arange(cs.FAMILY_SEQ, dtype=torch.int32, device=device)[None]
        inputs = tuple(torch.randn((1, cs.FAMILY_SEQ, h, cfg.head_dim), generator=g,
                                   device=device)
                       for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        rows[name] = cs.kernel_case(name, *inputs, seg, pos, cs.TOL_FP32, time_it=True,
                                    window=cs.arch_window(cfg))
        del inputs
        torch.cuda.empty_cache()
    cfg = get_arch("qwen3-8b")
    seg = torch.ones((2, 777), dtype=torch.int32, device=device)
    pos = torch.arange(777, dtype=torch.int32, device=device).repeat(2, 1)
    seg[1, 500:] = 2
    pos[1, 500:] -= 500
    inputs = tuple(torch.randn((2, 777, h, cfg.head_dim), generator=g, device=device)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    rows["fp32_ragged"] = cs.kernel_case("fp32_ragged", *inputs, seg, pos, cs.TOL_FP32,
                                         time_it=True)
    for arch in cs.PARITY_ARCHS:
        small, batch = cs.parity_model(get_arch(arch))
        seg = torch.from_numpy(batch["segment_ids"]).to(device)
        pos = torch.arange(cs.PARITY_SEQ, dtype=torch.int32, device=device).repeat(
            cs.PARITY_BATCH, 1)
        inputs = tuple(torch.randn((cs.PARITY_BATCH, cs.PARITY_SEQ, h, small.head_dim),
                                   generator=g, device=device)
                       for h in (small.n_heads, small.n_kv_heads, small.n_kv_heads))
        name = f"{arch}_fp32_parity"
        kw = {"time_splits": True} if "time_splits" in signature(cs.kernel_case).parameters else {}
        rows[name] = cs.kernel_case(name, *inputs, seg, pos, cs.TOL_FP32, time_it=True,
                                    window=cs.arch_window(small), **kw)
if opts["multimodal"]:  # whisper-medium's regimes at head_dim 64
    rows.update(cs.multimodal_kernel_phase(device, tags=opts["multimodal"]))
    torch.cuda.empty_cache()
for arch in opts["archs"] if opts["train"] else ():
    record["train"][arch] = cs.train_phase(get_arch(arch), device, layers=None,
                                           steps=cs.FAMILY_TRAIN_STEPS, fit=cs.FAMILY_TRAIN_FIT)
    torch.cuda.empty_cache()
for arch in opts["multimodal_train"]:  # a VLM's cut to chip_smoke's depth, as its phase runs it
    cfg = get_arch(arch)
    record["train"][arch] = cs.multimodal_train_phase(
        cfg, device, layers=None if cfg.enc_dec else cs.VLM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(record), flush=True)
"""

CASE_KEYS = ("ms", "ms_by_kernel", "share_by_kernel", "splits", "ms_by_splits", "bound_ms",
             "bound_by", "bound_share", "bound_3xtf32_ms", "bound_3xtf32_share", "plain_ms",
             "library_ms", "library_kernels", "max_abs_err", "wrapper_event_ms", "shape",
             "kv_heads", "pair")


def summary(tree, record):
    """The numbers a comparison reads: each case's kernel times and each
    train step's wall and device time."""
    def train(res):
        prof = res["profile"]
        return {"step_seconds_mean": res["step_seconds_mean"],
                "step_seconds_min": res["step_seconds_min"],
                "step_seconds_max": res["step_seconds_max"],
                "device_seconds_per_step": prof["device_seconds_per_call"],
                "profiled_wall_seconds": prof["profiled_wall_seconds_per_call"],
                "busy_share": prof["busy_share"], "group_shares": prof["group_shares"],
                "launches_per_step": res["launches_per_step"],
                "max_memory_allocated_bytes": res["max_memory_allocated_bytes"]}
    return {"tree": tree, "build_seconds": record["build_seconds"],
            "cases": {name: {k: row.get(k) for k in CASE_KEYS}
                      for name, row in record["family_kernel"].items()},
            "train": {arch: train(res) for arch, res in record["train"].items()}}


def run_tree(tree: Path, opts: dict) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    proc = subprocess.run([sys.executable, "-c", WORKER, json.dumps(opts)], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"chip_compare: the run in {tree} failed ({proc.returncode})")
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="source trees, run in this order")
    ap.add_argument("--arch", nargs="*", default=["h2o-danube-1.8b"],
                    help="archs of chip_smoke's FAMILY_KERNEL_ARCHS whose family cases run "
                         "(none: no family phase)")
    ap.add_argument("--head-dims", nargs="*", type=int, default=[],
                    help="also time the bf16 kernels at each arch's shape at these head widths")
    ap.add_argument("--fp32-forward", action="store_true",
                    help="also time the fp32 forward at the ragged and parity shapes")
    ap.add_argument("--multimodal", nargs="*", choices=("bf16", "fp32"),
                    help="also time the kernels in whisper-medium's regimes (head_dim 64), "
                         "in these dtypes (both when none is named)")
    ap.add_argument("--skip-train", action="store_true", help="run no train steps")
    ap.add_argument("--multimodal-train", nargs="*", default=[],
                    choices=("qwen2-vl-7b", "whisper-medium"),
                    help="also run chip_smoke's train phase of these VLM / encoder-decoder "
                         "archs")
    ap.add_argument("--out", help="also write every run's full record to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import FAMILY_KERNEL_ARCHS

    unknown = set(args.arch) - set(FAMILY_KERNEL_ARCHS)
    if unknown:
        ap.error(f"--arch {sorted(unknown)} not in {FAMILY_KERNEL_ARCHS}")
    opts = {"archs": args.arch, "head_dims": args.head_dims, "train": not args.skip_train,
            "fp32_forward": args.fp32_forward, "multimodal_train": args.multimodal_train,
            "multimodal": (args.multimodal or ["bf16", "fp32"]) if args.multimodal is not None
            else []}

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs, summaries = [], []
    for i, tree in enumerate(args.trees):
        path = Path(tree).resolve()
        if not (path / "chip_smoke.py").is_file():
            raise SystemExit(f"chip_compare: {tree} holds no chip_smoke.py")
        record = run_tree(path, opts)
        runs.append({"tree": tree, "record": record})
        summaries.append({"run": i, **summary(tree, record)})
        print(json.dumps(summaries[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "opts": opts, "runs": runs}, indent=1))
    print(json.dumps({"card": card, "opts": opts, "runs": summaries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
