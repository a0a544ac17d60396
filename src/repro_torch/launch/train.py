"""End-to-end fault-tolerant training driver (counterpart of `repro.launch.train`).

Two execution modes share the data pipeline, optimizer, checkpointing, and
the ResiHP stack, as in the reference:

  * spmd     — one device runs the train step (fp32 masters, bf16 compute,
               micro-batched, remat). Iteration times + pack stats stream to
               the Eq. 1 predictor and the Detector. Sharding is not ported
               yet: `--tp` raises here.
  * pipeline — the ResiHP runtime: a ParallelPlan (`--dp/--pp/--tp`)
               executed by PipelineEngine with per-stage device groups;
               failure injection (`--inject-failstop`, `--inject-failslow`)
               triggers the full detect -> adapt -> recover -> resume path
               in-process. Every plan device maps onto `--device`.

`--ckpt-dir/--ckpt-interval/--resume` checkpoint and restart either mode.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --mode pipeline \
      --dp 2 --pp 2 --tp 2 --steps 6 --seq-len 64 --inject-failstop 3:5 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.detector.changepoint import CusumDetector
from repro_torch.core.detector.detector import Detector, FailureReport
from repro_torch.core.detector.heartbeat import HeartbeatMonitor
from repro_torch.core.detector.predictor import MicroBatchTimePredictor
from repro_torch.core.recovery import recover_state
from repro_torch.core.resihp import ResiHPController
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.core.scheduler.repartition import costs_for_arch
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.data.packing import pack_stats
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.engine.pipeline import PipelineEngine
from repro_torch.train.optimizer import optimizer_for, tree_leaves, tree_map
from repro_torch.train.train_step import build_train_step, init_train_state

PIPELINE_DEFAULTS = {"dp": 2, "pp": 2, "tp": 1}  # the reference's defaults
PIPELINE_ONLY = ("dp", "pp", "inject_failstop", "inject_failslow")


def _parse_inject(spec):
    """'step:device[,step:device...]' -> [(step, device)]."""
    out = []
    if spec:
        for part in spec.split(","):
            s, d = part.split(":")
            out.append((int(s), int(d)))
    return out


def _parse_slow(spec):
    """'step:device@factor[,...]' -> {step: (device, factor)}."""
    out = {}
    if spec:
        for part in spec.split(","):
            s, rest = part.split(":")
            d, f = rest.split("@")
            out[int(s)] = (int(d), float(f))
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- spmd mode
def run_spmd(cfg, args):
    """Train `args.steps` steps on `args.device`; returns {"losses", "times",
    "detector"} as the reference's spmd mode does."""
    if args.tp is not None:
        raise NotImplementedError("--tp in spmd mode: sharding (ROADMAP Queue 1 item 7) is not "
                                  "ported yet; --mode pipeline reads it")
    for name in PIPELINE_ONLY:
        if getattr(args, name) is not None:
            raise ValueError(f"--{name.replace('_', '-')} is read by --mode pipeline only")
    device = torch.device(args.device)
    opt = optimizer_for(cfg, lr=args.lr)
    state = init_train_state(args.seed, cfg, opt, device=device)
    step_fn = build_train_step(cfg, opt, microbatches=args.microbatches, remat=True)

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.has_checkpoint() and args.resume:
        state, start, _ = ckpt.restore_latest(target=state, shardings=device)
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        print(f"[train] resumed from step {start}", flush=True)

    ds = SyntheticPackedDataset(cfg, args.seq_len, args.batch, seed=args.seed)
    pred = MicroBatchTimePredictor()
    detector = Detector(
        healthy_time_fn=lambda w: pred.predict(*w) if pred.fitted else float("inf"),
        validate_fn=lambda it: [],
        heartbeat=HeartbeatMonitor(),
        changepoint_factory=lambda: CusumDetector(warmup=8),
    )
    losses, times = [], []
    for it in range(start, args.steps):
        raw = ds.batch_at(it)
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        stats = pack_stats(raw["segment_ids"])
        n, l2 = sum(s[0] for s in stats), sum(s[1] for s in stats)
        if it - start >= 2:  # skip warm-up (build, allocator), as the reference skips compiles
            pred.observe(n, l2, dt)
            if len(pred._obs) >= 4 and not pred.fitted:
                pred.fit()
            detector.observe_iteration(it, dt, (n, l2))
        losses.append(loss)
        times.append(dt)
        if ckpt:
            ckpt.maybe_save(state, it + 1, extra={"loss": loss})
        if it % max(args.steps // 10, 1) == 0 or it == args.steps - 1:
            print(f"[train] step {it} loss {loss:.4f} {dt*1e3:.0f} ms", flush=True)
    return {"losses": losses, "times": times, "detector": detector.stats.as_dict()}


# ------------------------------------------------------------ pipeline mode
def _engine_state(engine):
    return {"params": engine.params_full, "opt": engine.opt_state, "step": engine.step}


def _load_state(engine, state, *, step=False):
    engine.params_full = tree_map(lambda v: v.requires_grad_(True), state["params"])
    engine.opt_state = state["opt"]
    if step:
        engine.step = int(state["step"])


def run_pipeline(cfg, args):
    """The ResiHP runtime. Returns {"losses", "reconfigs"} as the reference,
    plus each step's seconds ("times"), each adaptation's plan, notes, layer
    moves and measured recovery seconds ("adaptations") and the final plan
    ("plan")."""
    device = torch.device(args.device)
    dp, pp, tp = (getattr(args, k) if getattr(args, k) is not None else v
                  for k, v in PIPELINE_DEFAULTS.items())
    opt = optimizer_for(cfg, lr=args.lr)
    plan = initial_plan(cfg.n_layers, dp, pp, tp, microbatches=args.microbatches)
    layer_costs = costs_for_arch(cfg, args.seq_len)
    scheduler = Scheduler(layer_costs=layer_costs, k_min=1, delta=1)
    hb = HeartbeatMonitor()
    node_devs = {}
    for d in plan.devices:
        node_devs.setdefault(d // 8, []).append(d)
    for n, devs in node_devs.items():
        hb.register_node(n, devs)
    detector = Detector(healthy_time_fn=lambda w: float("inf"),
                        validate_fn=lambda it: [], heartbeat=hb)
    controller = ResiHPController(
        scheduler=scheduler, detector=detector, plan=plan,
        speeds={d: 1.0 for d in plan.devices})

    engine = PipelineEngine(cfg, plan, optimizer=opt, seed=args.seed, devices=[device])
    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval) if args.ckpt_dir else None
    ds = SyntheticPackedDataset(cfg, args.seq_len, args.batch, seed=args.seed)
    injections = dict(_parse_inject(args.inject_failstop))
    slow_inj = _parse_slow(args.inject_failslow)

    start = 0
    if ckpt and ckpt.has_checkpoint() and args.resume:
        full, start, _ = ckpt.restore_latest(target=_engine_state(engine), shardings=device)
        _load_state(engine, full, step=True)
        print(f"[train] resumed from step {start}", flush=True)

    losses, times, reconfigs, adaptations = [], [], [], []
    for it in range(start, args.steps):
        now = float(it)
        if it in injections:
            dev = injections[it]
            print(f"[inject] fail-stop device {dev} at step {it}", flush=True)
            controller.speeds[dev] = 0.0
            controller.pending.append(FailureReport("fail-stop", (dev,), it, now))
        if it in slow_inj:
            dev, f = slow_inj[it]
            print(f"[inject] fail-slow device {dev} -> {f} at step {it}", flush=True)
            controller.speeds[dev] = f
            controller.pending.append(FailureReport("fail-slow", ((dev, f),), it, now))

        adaptation = controller.adapt(now)
        if adaptation is not None:
            old_plan = engine.plan
            print(f"[adapt] {adaptation.plan.summary()}", flush=True)
            for note in adaptation.notes:
                print(f"        {note}", flush=True)
            t0 = time.perf_counter()
            state, tp_, restored = recover_state(
                cfg, _engine_state(engine), old_plan=old_plan, new_plan=adaptation.plan,
                shardings=device, checkpoint_mgr=ckpt, dead_stages=adaptation.dead_stages)
            _load_state(engine, state)
            engine.apply_plan(adaptation.plan)
            _sync(device)
            recover_s = time.perf_counter() - t0
            print(f"[recover] {len(tp_.moves)} layer moves, "
                  f"{tp_.total_bytes/1e6:.1f} MB, est {tp_.seconds():.2f}s on IB", flush=True)
            if restored is not None:
                print(f"[recover] restored checkpoint step {restored} (Fig. 8b)", flush=True)
            reconfigs.append(it)
            adaptations.append({
                "step": it, "plan": adaptation.plan.summary(), "notes": list(adaptation.notes),
                "dead_stages": [list(x) for x in adaptation.dead_stages],
                "plan_overhead_s": adaptation.plan_overhead_s,
                "moves": [vars(m) for m in tp_.moves], "bytes": tp_.total_bytes,
                "est_seconds": tp_.seconds(), "restored_from": restored,
                "recover_seconds": recover_s})

        batch = {k: torch.from_numpy(v).to(device) for k, v in ds.batch_at(it).items()}
        t0 = time.perf_counter()
        loss = engine.run_iteration(batch)[0]  # drop the gradients before the next step
        _sync(device)  # the update runs after the loss is read
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if ckpt:
            ckpt.maybe_save(_engine_state(engine), it + 1, extra={"loss": loss})
        if it % max(args.steps // 10, 1) == 0 or it == args.steps - 1:
            print(f"[train] step {it} loss {loss:.4f} {dt*1e3:.0f} ms "
                  f"plan={engine.plan.summary()}", flush=True)
    return {"losses": losses, "reconfigs": reconfigs, "times": times,
            "adaptations": adaptations, "plan": engine.plan.summary()}


def parser():
    ap = argparse.ArgumentParser(description="Fault-tolerant training on one device.")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized same-family config")
    ap.add_argument("--mode", choices=("spmd", "pipeline"), default="spmd")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    # pipeline mode; unset means the reference's defaults (dp 2, pp 2, tp 1)
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--pp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failstop", default=None, help="step:device[,step:device]")
    ap.add_argument("--inject-failslow", default=None, help="step:device@factor[,...]")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device; the tests pass cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
        if args.mode == "pipeline":
            pp = args.pp if args.pp is not None else PIPELINE_DEFAULTS["pp"]
            cfg = reduce_cfg(get_arch(args.arch), n_layers=max(pp * len(cfg.period) * 2, 4))
    print(f"[train] arch={cfg.arch_id} params={cfg.param_count()/1e6:.1f}M "
          f"mode={args.mode} device={args.device}", flush=True)
    result = run_spmd(cfg, args) if args.mode == "spmd" else run_pipeline(cfg, args)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, default=float))
    print(f"[train] done; final loss {result['losses'][-1]:.4f}", flush=True)
    return result


if __name__ == "__main__":
    main()
