"""Time h2o-danube-1.8b's attention kernels and train step in several trees, on one card.

    python3 chip_compare.py --trees _archive/parent . . _archive/parent \\
        [--head-dims 64 80 128] [--out FILE.json]

Each tree is a checkout of this repository (for an older commit, a `git
archive` unpacked into a git-ignored directory). For each tree in the order
given, a fresh process runs that tree's own `chip_smoke.py` functions with
that tree's `src/` on the path: it builds the tree's kernels, runs
`family_kernel_phase` for h2o-danube-1.8b alone (bf16 and fp32 forward and
backward at 1 x 4096, each against its plain version and timed beside its
bound and SDPA) and `train_phase` at full depth (the arch's family train
steps). `--head-dims` adds the bf16 forward and backward at its heads,
documents and window at each of those head widths, which shows how much of
a kernel's time follows its products. Naming a tree twice, as parent,
change, change, parent, shows the spread beside the difference. Prints one
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
import torch
import chip_smoke as cs
from repro_torch.configs import get_arch
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.kernels import build

arch, head_dims = sys.argv[1], json.loads(sys.argv[2])
device = torch.device("cuda", 0)
torch.cuda.set_device(device)
t0 = time.perf_counter()
build.build_all()
record = {"build_seconds": time.perf_counter() - t0}
cs.FAMILY_KERNEL_ARCHS = (arch,)
rows = record["family_kernel"] = cs.family_kernel_phase(device)
torch.cuda.empty_cache()
cfg = get_arch(arch)
seg = torch.from_numpy(SyntheticPackedDataset(cfg, cs.FAMILY_SEQ, 1, seed=0).batch_at(0)[
    "segment_ids"]).to(device)
pos = torch.arange(cs.FAMILY_SEQ, dtype=torch.int32, device=device)[None]
g = torch.Generator(device=device)
g.manual_seed(99)
for dh in head_dims:  # the family phase's case at other head widths
    inputs = tuple(torch.randn((1, cs.FAMILY_SEQ, h, dh), generator=g, device=device)
                   .to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    name, kw = f"{arch}_bf16_dh{dh}", {"time_it": True, "window": cs.arch_window(cfg)}
    rows[name] = cs.kernel_case(name, *inputs, seg, pos, cs.TOL_BF16, time_masked=False, **kw)
    rows[name + "_bwd"] = cs.backward_case(name + "_bwd", *inputs, seg, pos, cs.TOL_BF16, **kw)
    del inputs
    torch.cuda.empty_cache()
record["train"] = cs.train_phase(get_arch(arch), device, layers=None,
                                 steps=cs.FAMILY_TRAIN_STEPS, fit=cs.FAMILY_TRAIN_FIT)
print("RESULT " + json.dumps(record), flush=True)
"""

ARCH = "h2o-danube-1.8b"  # the arch whose head width (80) has kernels of its own
CASE_KEYS = ("ms", "ms_by_kernel", "bound_ms", "bound_by", "bound_share", "plain_ms",
             "library_ms", "max_abs_err", "wrapper_event_ms")


def summary(tree, record):
    """The numbers a comparison reads: each case's kernel times and the
    train step's wall and device time."""
    train, prof = record["train"], record["train"]["profile"]
    return {"tree": tree, "build_seconds": record["build_seconds"],
            "cases": {name: {k: row.get(k) for k in CASE_KEYS}
                      for name, row in record["family_kernel"].items()},
            "train": {"step_seconds_mean": train["step_seconds_mean"],
                      "step_seconds_min": train["step_seconds_min"],
                      "step_seconds_max": train["step_seconds_max"],
                      "device_seconds_per_step": prof["device_seconds_per_call"],
                      "profiled_wall_seconds": prof["profiled_wall_seconds_per_call"],
                      "busy_share": prof["busy_share"], "group_shares": prof["group_shares"],
                      "launches_per_step": train["launches_per_step"],
                      "max_memory_allocated_bytes": train["max_memory_allocated_bytes"]}}


def run_tree(tree: Path, arch: str, head_dims) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    proc = subprocess.run([sys.executable, "-c", WORKER, arch, json.dumps(head_dims)], cwd=tree,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"chip_compare: the run in {tree} failed ({proc.returncode})")
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="source trees, run in this order")
    ap.add_argument("--head-dims", nargs="*", type=int, default=[],
                    help="also time the bf16 kernels at the arch's shape at these head widths")
    ap.add_argument("--out", help="also write every run's full record to this JSON file")
    args = ap.parse_args(argv)

    import torch

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
        record = run_tree(path, ARCH, args.head_dims)
        runs.append({"tree": tree, "record": record})
        summaries.append({"run": i, **summary(tree, record)})
        print(json.dumps(summaries[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "arch": ARCH, "runs": runs}, indent=1))
    print(json.dumps({"card": card, "arch": ARCH, "runs": summaries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
