"""Training driver (counterpart of `repro.launch.train`), for one device.

The reference has two modes. `spmd` is ported: one device runs the train
step (fp32 masters, bf16 compute, micro-batched, remat), and each
iteration's time and packing statistics stream to the online Eq. 1
micro-batch predictor and the Detector, as in the reference. `pipeline` (the
ResiHP runtime), checkpointing and sharding come with later slices: their
flags are accepted, as the reference's are, and raise when set.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced --steps 40
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.detector.changepoint import CusumDetector
from repro_torch.core.detector.detector import Detector
from repro_torch.core.detector.heartbeat import HeartbeatMonitor
from repro_torch.core.detector.predictor import MicroBatchTimePredictor
from repro_torch.data.packing import pack_stats
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.train.optimizer import optimizer_for
from repro_torch.train.train_step import build_train_step, init_train_state


# flags of the reference that nothing in the port reads yet, by the ROADMAP
# item that brings what reads them
UNPORTED = {"ckpt_dir": "checkpointing (ROADMAP Queue 1 item 3)",
            "ckpt_interval": "checkpointing (ROADMAP Queue 1 item 3)",
            "resume": "checkpointing (ROADMAP Queue 1 item 3)",
            "dp": "the ResiHP runtime, --mode pipeline (ROADMAP Queue 1 item 4)",
            "pp": "the ResiHP runtime, --mode pipeline (ROADMAP Queue 1 item 4)",
            "inject_failstop": "the ResiHP runtime, --mode pipeline (ROADMAP Queue 1 item 4)",
            "inject_failslow": "the ResiHP runtime, --mode pipeline (ROADMAP Queue 1 item 4)",
            "tp": "sharding (ROADMAP Queue 1 item 7)"}


def run_spmd(cfg, args):
    """Train `args.steps` steps on `args.device`; returns {"losses", "times",
    "detector"} as the reference's spmd mode does."""
    for name, what in UNPORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')}: {what} is not ported yet")
    device = torch.device(args.device)
    opt = optimizer_for(cfg, lr=args.lr)
    state = init_train_state(args.seed, cfg, opt, device=device)
    step_fn = build_train_step(cfg, opt, microbatches=args.microbatches, remat=True)

    ds = SyntheticPackedDataset(cfg, args.seq_len, args.batch, seed=args.seed)
    pred = MicroBatchTimePredictor()
    detector = Detector(
        healthy_time_fn=lambda w: pred.predict(*w) if pred.fitted else float("inf"),
        validate_fn=lambda it: [],
        heartbeat=HeartbeatMonitor(),
        changepoint_factory=lambda: CusumDetector(warmup=8),
    )
    losses, times = [], []
    for it in range(args.steps):
        raw = ds.batch_at(it)
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        stats = pack_stats(raw["segment_ids"])
        n, l2 = sum(s[0] for s in stats), sum(s[1] for s in stats)
        if it >= 2:  # skip warm-up (build, allocator), as the reference skips compiles
            pred.observe(n, l2, dt)
            if len(pred._obs) >= 4 and not pred.fitted:
                pred.fit()
            detector.observe_iteration(it, dt, (n, l2))
        losses.append(loss)
        times.append(dt)
        if it % max(args.steps // 10, 1) == 0 or it == args.steps - 1:
            print(f"[train] step {it} loss {loss:.4f} {dt*1e3:.0f} ms", flush=True)
    return {"losses": losses, "times": times, "detector": detector.stats.as_dict()}


def parser():
    ap = argparse.ArgumentParser(description="Train on one device (spmd mode).")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized same-family config")
    ap.add_argument("--mode", choices=("spmd", "pipeline"), default="spmd")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    # the unported flags default to unset (one device); see UNPORTED
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--pp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failstop", default=None, help="step:device[,step:device]")
    ap.add_argument("--inject-failslow", default=None, help="step:device@factor[,...]")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device; the tests pass cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mode == "pipeline":
        raise NotImplementedError("--mode pipeline (the ResiHP runtime) is not ported yet "
                                  "(ROADMAP Queue 1 item 4)")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    print(f"[train] arch={cfg.arch_id} params={cfg.param_count()/1e6:.1f}M "
          f"mode={args.mode} device={args.device}")
    result = run_spmd(cfg, args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, default=float))
    print(f"[train] done; final loss {result['losses'][-1]:.4f}")
    return result


if __name__ == "__main__":
    main()
