"""Spawned `gloo` ranks for the port's sharding tests (tests/test_torch_sharding.py
and its siblings) and its pipeline engine on stage meshes
(tests/test_torch_pipeline_mesh.py).

`launch(fn, world, *args)` starts `world` CPU processes, each of which joins
a process group over `tcp://localhost:<free port>` (every collective times
out after `COLLECTIVE_TIMEOUT_S`) and returns `fn(rank, world, *args)`;
`Ranks.results(timeout)` joins them, kills any rank still running at the
timeout and raises with every rank's traceback, so a hang fails its test.

A rank writes its result (or traceback) to a file and sends only its rank
and status through the queue: a message of a few bytes is one atomic write
to the pipe, so a rank that its watchdog ends never leaves the reader
blocked on half a message, and no rank waits for the test to read a large
result before it can exit.

The workers (`mesh_cases` and its cases) import no jax: they get numpy
inputs from the test and send back numpy results.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import shutil
import socket
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 120
RANK_TIMEOUT_S = 600  # a rank still running then prints its stack and exits


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _result_path(result_dir, rank):
    return os.path.join(result_dir, f"rank{rank}.pkl")


def _entry(rank, world, port, out, fn, args, result_dir):
    import faulthandler

    import torch.distributed as dist

    faulthandler.dump_traceback_later(RANK_TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    try:
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        status, value = "ok", fn(rank, world, *args)
    except BaseException:  # noqa: BLE001 - every failure goes back to the test
        status, value = "error", traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = _result_path(result_dir, rank)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(path + ".tmp", path)
    faulthandler.cancel_dump_traceback_later()
    out.put((rank, status))


class Ranks:
    def __init__(self, world, procs, out, result_dir):
        self.world, self.procs, self.out, self.result_dir = world, procs, out, result_dir
        self._results = self._error = None

    def results(self, timeout=300.0):
        """{rank: fn's value}; raises if a rank failed or did not end in time
        (and again on every later call, without waiting)."""
        if self._error is not None:
            raise RuntimeError(self._error)
        if self._results is not None:
            return self._results
        got, errors = {}, []
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        while len(got) + len(errors) < self.world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, status = self.out.get(timeout=max(left, 0.1))
            except queue.Empty:
                break
            with open(_result_path(self.result_dir, rank), "rb") as f:
                value = pickle.load(f)
            (got.__setitem__(rank, value) if status == "ok" else errors.append((rank, value)))
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.result_dir, ignore_errors=True)
        if errors or len(got) < self.world:
            msgs = [f"rank {r}:\n{tb}" for r, tb in sorted(errors)]
            missing = sorted(set(range(self.world)) - set(got) - {r for r, _ in errors})
            if missing:
                msgs.append(f"ranks {missing} did not end within {timeout} s")
            self._error = "\n".join(msgs)
            raise RuntimeError(self._error)
        self._results = got
        return got


def launch(fn, world, *args):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    result_dir = tempfile.mkdtemp(prefix="ranks-")
    procs = [ctx.Process(target=_entry, args=(r, world, port, out, fn, args, result_dir),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(world, procs, out, result_dir)


# ------------------------------------------------------------------ workers
def _tensor_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _numpy(tree_leaves_list):
    return [x.detach().float().numpy().copy() for x in tree_leaves_list]


def _step_case(mesh, case):
    """len(batches) fp32 steps of the sharded train step from the case's
    numpy parameters, gradients accumulated in the case's `accum_dtype`
    (float32 by default) -> losses, grad norms, token counts, each step's
    clipped gradients, the final parameters and optimizer state (whole);
    with the case's "routes", also this rank's MoE routes of every call of
    the first step (run without remat then, whose recompute would record
    some calls twice)."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import gather, policy_for_mesh
    from repro_torch.train.optimizer import make_optimizer, tree_leaves
    from repro_torch.train.train_step import build_train_step, place_state

    cfg = reduced(get_arch(case["arch"]), **case["over"])
    policy = policy_for_mesh(mesh, **case["policy"])
    name, momentum = case["opt"]
    opt = make_optimizer(name, lr=case["lr"], momentum_dtype=getattr(torch, momentum))
    params = params_from_jax(case["params"], dtype=torch.float32, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params, period=len(cfg.period)),
             "step": torch.zeros((), dtype=torch.int32)}
    state = place_state(policy, cfg, opt, state)
    routes = case.get("routes", False)
    step = build_train_step(cfg, opt, policy=policy, microbatches=case["microbatches"],
                            clip_norm=case["clip_norm"], compute_dtype=torch.float32,
                            remat=not routes,
                            accum_dtype=getattr(torch, case.get("accum_dtype", "float32")))
    out = {"loss": [], "grad_norm": [], "ntokens": [], "grads": []}
    for i, batch in enumerate(case["batches"]):
        moe.moe_ffn.routes = [] if routes and i == 0 else None
        try:
            state, m = step(state, _tensor_batch(batch))
            if moe.moe_ffn.routes is not None:
                out["routes"] = [{k: r[k].numpy() for k in ("experts", "kept")}
                                 for r in moe.moe_ffn.routes]
        finally:
            moe.moe_ffn.routes = None
        for k in ("loss", "grad_norm", "ntokens"):
            out[k].append(float(m[k]))
        out["grads"].append(_numpy(gather([p.grad for p in tree_leaves(state["params"])])))
    out["params"] = _numpy(tree_leaves(gather(state["params"])))
    out["opt"] = _numpy(tree_leaves(gather(state["opt"])))
    out["step"] = int(state["step"])
    out["coords"] = mesh.get_coordinate()
    return out


def _moe_layer_case(mesh, case):
    """moe_ffn under the policy on the case's numpy layer, input and output
    gradient -> whole output, input and weight gradients, this rank's routes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import policy_for_mesh

    cfg = reduced(get_arch(case["arch"]), **case["over"])
    policy = policy_for_mesh(mesh, **case["policy"])
    p = policy.distribute({k: torch.from_numpy(v).requires_grad_(True)
                           for k, v in case["p"].items()}, moe.moe_axes(cfg))
    x, dy = (distribute_tensor(torch.from_numpy(a), mesh,
                               policy.placements_for(("batch", "seq", None), a.shape))
             for a in (case["x"], case["dy"]))
    x.requires_grad_(True)
    moe.moe_ffn.routes = []
    try:
        y = moe.moe_ffn(cfg, p, x, policy)
        routes = moe.moe_ffn.routes
    finally:
        moe.moe_ffn.routes = None
    (y * dy).sum().backward()
    return {"y": y.full_tensor().detach().numpy(), "dx": x.grad.full_tensor().numpy(),
            "dp": {k: v.grad.full_tensor().numpy() for k, v in p.items()},
            "routes": {k: routes[0][k].numpy() for k in ("experts", "kept")},
            "coords": mesh.get_coordinate()}


def _placements_case(mesh, case):
    """Each (axes, shape, policy kw) placed by `placements_for`: this rank's
    local shard of arange(numel)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import policy_for_mesh

    out = []
    for axes, shape, kw in case["specs"]:
        policy = policy_for_mesh(mesh, **kw)
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        d = distribute_tensor(full, mesh, policy.placements_for(axes, shape))
        out.append((policy.spec_for(axes, shape), d.to_local().numpy()))
    return {"coords": mesh.get_coordinate(), "locals": out}


def _one_rank_case(mesh, case):
    """At a (1, 1) mesh: the sharded step against the unsharded one from the
    same state, and prefill + a decode step through build_prefill_step /
    build_serve_step with the DTensor parameters."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_arch, reduced
    from repro_torch.parallel.sharding import NULL_POLICY, gather, policy_for_mesh
    from repro_torch.train.optimizer import make_optimizer, tree_leaves
    from repro_torch.train.train_step import build_train_step, place_state

    cfg = reduced(get_arch(case["arch"]), **case["over"])
    policy = policy_for_mesh(mesh)
    opt = make_optimizer("adamw", lr=case["lr"])

    def state_of(p):
        params = params_from_jax(case["params"], dtype=torch.float32, device="cpu")
        for x in tree_leaves(params):
            x.requires_grad_(True)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        return place_state(p, cfg, opt, state)
    plain, sharded = state_of(NULL_POLICY), state_of(policy)
    out = {"plain": [], "sharded": []}
    for pol, st, key in ((NULL_POLICY, plain, "plain"), (policy, sharded, "sharded")):
        step = build_train_step(cfg, opt, policy=pol, microbatches=2, compute_dtype=torch.float32)
        for batch in case["batches"]:
            st, m = step(st, _tensor_batch(batch))
            out[key].append(float(m["loss"]))
    out["params_plain"] = _numpy(tree_leaves(plain["params"]))
    out["params_sharded"] = _numpy(tree_leaves(gather(sharded["params"])))
    prompt = {k: torch.from_numpy(v) for k, v in case["prompt"].items()}
    with torch.no_grad():
        served = {}
        for key, params, pol in (("plain", plain["params"], NULL_POLICY),
                                 ("sharded", sharded["params"], policy)):
            served[key] = _served(cfg, pol, params, prompt, 1)
    out["served"] = {k: (v["prefill"], v["logits"][0], v["tokens"][0])
                     for k, v in served.items()}
    return out


def _served(cfg, policy, params, prompt, steps, max_len=None):
    """Prefill of `prompt` (an encoder-decoder's: frames and decoder
    tokens), then `steps` greedy decode steps over a max_len cache (prompt
    + steps by default), under `policy`: the caches gathered whole after
    prefill, extended, and placed by `specs.cache_shardings` -> whole numpy
    prefill logits, each step's logits and tokens, and the placements of
    the first layer's first cache leaf (its K cache; Mamba's conv window,
    an mLSTM's C) and cross K cache after the last step."""
    from repro_torch.launch.specs import place_cache
    from repro_torch.models.model import extend_cache
    from repro_torch.parallel.sharding import arange_rows_like, gather
    from repro_torch.train.train_step import build_prefill_step, build_serve_step

    B, S = prompt["dec_tokens" if cfg.enc_dec else "tokens"].shape
    extra = {}
    if cfg.enc_dec:  # the ids of the cross caches' encoder positions
        extra = {"cross_segment_ids": prompt["enc_segment_ids"],
                 "cross_positions": arange_rows_like(prompt["enc_segment_ids"])}
    logits, caches = build_prefill_step(cfg, compute_dtype=torch.float32, policy=policy)(
        params, policy.distribute_batch(prompt))
    logits = gather(logits)
    cache = place_cache(policy, extend_cache(cfg, gather(caches), max_len or S + steps))
    step = build_serve_step(cfg, compute_dtype=torch.float32, policy=policy)
    out = {"prefill": logits.numpy(), "logits": [], "tokens": []}
    tokens = logits[:, -1].argmax(-1, keepdim=True).int()
    for i in range(steps):
        batch = {"tokens": tokens, "lengths": torch.full((B,), S + i, dtype=torch.int32),
                 **extra}
        nxt, dec, cache = step(params, cache, policy.distribute_batch(batch))
        tokens = gather(nxt)[:, None]
        out["logits"].append(gather(dec).numpy())
        out["tokens"].append(tokens[:, 0].numpy())
    first = next(iter(cache[0]["mixer"].values()))
    out["cache_placements"] = repr(getattr(first, "placements", None))
    if cfg.enc_dec:
        out["cross_placements"] = repr(getattr(cache[0]["cross"]["k_const"], "placements", None))
    return out


def _serve_case(mesh, case):
    """Prefill + greedy decode of a reduced model from the port's seeded
    fp32 init, under the case's policy on this mesh and unsharded, from
    the same prompt -> both `_served` records."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import init_params, param_axes
    from repro_torch.parallel.sharding import NULL_POLICY, policy_for_mesh

    cfg = reduced(get_arch(case["arch"]), **case["over"])
    policy = policy_for_mesh(mesh, **case["policy"])
    params = init_params(cfg, case["seed"], dtype=torch.float32, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in case["prompt"].items()}
    with torch.no_grad():
        return {key: _served(cfg, pol, p, prompt, case["steps"], case["max_len"])
                for key, pol, p in (("plain", NULL_POLICY, params),
                                    ("sharded", policy,
                                     policy.distribute(params, param_axes(cfg))))}


def _driver_case(mesh, case):
    """`launch.train.run_spmd` (the driver) under this world, as torchrun
    runs it: its argv, then its losses."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train

    args = train.parser().parse_args(case["argv"])
    return train.run_spmd(reduced(get_arch(args.arch)), args)["losses"]


def _local_types_case(mesh, case):
    """One forward and backward of the case's reduced model under its policy,
    each recurrence's scan (`ssm.selective_scan`, `xlstm.mlstm_scan`,
    `xlstm.slstm_scan`) recording the types of its tensor arguments ->
    {scan: sorted type names}."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.model import init_params, loss_fn, param_axes
    from repro_torch.parallel.sharding import policy_for_mesh
    from repro_torch.train.optimizer import tree_leaves

    cfg = reduced(get_arch(case["arch"]), **case["over"])
    policy = policy_for_mesh(mesh, **case["policy"])
    params = policy.distribute(init_params(cfg, 0, dtype=torch.float32, device="cpu"),
                               param_axes(cfg))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    seen, saved = {}, {}

    def recording(mod, name):
        fn = saved[name] = getattr(mod, name)

        def record(*args):
            seen.setdefault(name, set()).update(type(a).__name__ for a in args
                                                if isinstance(a, torch.Tensor))
            return fn(*args)
        setattr(mod, name, record)
    scans = ((ssm, "selective_scan"), (xlstm, "mlstm_scan"), (xlstm, "slstm_scan"))
    for mod, name in scans:
        recording(mod, name)
    try:
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            total, _ = loss_fn(cfg, params, policy.distribute_batch(_tensor_batch(case["batch"])),
                               compute_dtype=torch.float32, policy=policy)
            total.backward()
    finally:
        for mod, name in scans:
            setattr(mod, name, saved[name])
    return {k: sorted(v) for k, v in seen.items()}


CASES = {"step": _step_case, "moe_layer": _moe_layer_case, "placements": _placements_case,
         "one_rank": _one_rank_case, "driver": _driver_case, "serve": _serve_case,
         "local_types": _local_types_case}


def mesh_cases(rank, world, shape, cases, names=("data", "model")):
    """Every case on the mesh of `shape` named `names`, in order:
    {name: rank 0's result} ({name: result} of every rank for the cases
    whose result differs by rank: moe_layer, placements, and a step case
    that records its routes)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=tuple(names))
    out = {}
    for name, case in cases.items():
        result = CASES[case["kind"]](mesh, case)
        if rank == 0 or case["kind"] in ("moe_layer", "placements") or case.get("routes"):
            out[name] = result
    return out


# ------------------------------------------------------- pipeline workers
PIPE_ARCH, PIPE_LAYERS, PIPE_SEQ = "qwen3-8b", 4, 64  # the reference engine tests' model


def _pipe_cfg(**over):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(PIPE_ARCH), **{"n_layers": PIPE_LAYERS, **over})


def _stage_view(engine):
    """{"dp{r},pp{s}": (ranks, this rank's mesh coordinate or None)}."""
    def coord(mesh):
        c = mesh.get_coordinate()
        return None if c is None else list(c)
    return {f"dp{r},pp{s}": (list(engine.ranks[(r, s)]), coord(engine.meshes[(r, s)]))
            for r, s in engine.ranks}


def _failstop_plan(cfg, plan):
    """The Scheduler's plan after the fail-stop of plan device 5."""
    from repro_torch.core.scheduler.repartition import costs_for_arch
    from repro_torch.core.scheduler.scheduler import Scheduler

    speeds = {d: 1.0 for d in plan.devices}
    speeds[5] = 0.0
    return Scheduler(layer_costs=costs_for_arch(cfg, PIPE_SEQ)).adapt(plan, speeds,
                                                                      failed={5}).plan


def _pipe_meshes_case(rank, world, case):
    """dp2/pp2/tp2 (8 plan devices) on this world: each stage's ranks and
    this rank's coordinates, before and after the fail-stop of device 5;
    whether stages r0s0 and r1s0 share one mesh; whether applying each plan
    again made no new mesh."""
    import torch

    from repro_torch.core.scheduler.plan import initial_plan
    from repro_torch.engine.pipeline import PipelineEngine

    cfg = _pipe_cfg()
    plan = initial_plan(PIPE_LAYERS, dp=2, pp=2, tp=2, microbatches=2)
    eng = PipelineEngine(cfg, plan, devices=["cpu"], compute_dtype=torch.float32)
    out = {"before": _stage_view(eng), "shared": eng.meshes[(0, 0)] is eng.meshes[(1, 0)]}
    meshes, made = dict(eng.meshes), len(eng.made_meshes)
    eng.apply_plan(plan)
    reused = all(eng.meshes[k] is m for k, m in meshes.items())
    after = _failstop_plan(cfg, plan)
    eng.apply_plan(after)
    out["after"] = _stage_view(eng)
    meshes, made_after = dict(eng.meshes), len(eng.made_meshes)
    eng.apply_plan(after)
    out["reused"] = reused and all(eng.meshes[k] is m for k, m in meshes.items()) and len(
        eng.made_meshes) == made_after
    out["meshes_made"] = [made, made_after]
    out["plan_after"] = after.summary()
    return out


def _master_digest(engine):
    import hashlib

    h = hashlib.sha256()
    for x in _tree_leaves(engine.params_full):
        h.update(x.detach().numpy().tobytes())
    return h.hexdigest()


def _tree_leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


def _my_stages(engine):
    """[(r, s, tp, local shape of layer 0's wq)] of the stages this rank
    computes."""
    out = []
    for r, s in sorted(engine.meshes):
        if engine.member(r, s):
            wq = engine.stage_params(r, s)["layers"][0]["mixer"]["wq"]
            local = wq.to_local() if hasattr(wq, "to_local") else wq
            out.append((r, s, engine.policies[(r, s)].tp, tuple(local.shape)))
    return out


def _hand_off_log(engine):
    """The last iteration's hand-offs as this rank saw them: [(src, dst,
    tp_src, tp_dst, bytes this rank sent)], in the engine's order."""
    return [(src, dst, len(engine.ranks[src]), len(engine.ranks[dst]), sent)
            for src, dst, sent in engine.hand_offs]


@contextlib.contextmanager
def _route(route):
    """Hand-offs by Fig. 7's rule ("fig7", the engine's), or every pair moved
    whole, each destination rank receiving the tensor from one source rank
    ("whole", the rule's route for degrees it does not cover)."""
    from repro_torch.engine import pipeline

    rule = pipeline.boundary_routes
    if route == "whole":
        pipeline.boundary_routes = lambda *a: None
    try:
        yield
    finally:
        pipeline.boundary_routes = rule


def _pipe_failstop_case(rank, world, case):
    """The case's numpy weights (of the model with the case's `over`), fp32,
    AdamW lr 5e-3, the case's plan (dp2/pp2/tp2 by default): one step per
    batch, the fail-stop of device 5 applied before step `fault_at` (None:
    none), hand-offs by the case's `route` (`_route`); the single-process
    engine where no process group is initialised (`single_process`) ->
    losses, plans, whether it ran on stage meshes, the first stage's
    attention split, this rank's stages before and after, each iteration's
    hand-offs (`_hand_off_log`), a digest of its final master."""
    with _route(case.get("route", "fig7")):
        import torch

        from repro_torch.bridge import params_from_jax
        from repro_torch.core.scheduler.plan import initial_plan
        from repro_torch.engine.pipeline import PipelineEngine
        from repro_torch.train.optimizer import make_optimizer

        cfg = _pipe_cfg(**case.get("over", {}))
        plan = initial_plan(PIPE_LAYERS, **case.get("plan", {"dp": 2, "pp": 2, "tp": 2}),
                            microbatches=2)
        eng = PipelineEngine(cfg, plan, optimizer=make_optimizer("adamw", lr=5e-3),
                             devices=["cpu"], compute_dtype=torch.float32,
                             params=params_from_jax(case["params"], dtype=torch.float32,
                                                    device="cpu"))
        out = {"losses": [], "plans": [plan.summary()], "spmd": eng.spmd,
               "attn_shard": eng.policies[(0, 0)].attn_shard, "hand_offs": []}
        if eng.spmd:
            out["stages_before"] = _my_stages(eng)
        for i, batch in enumerate(case["batches"]):
            if i == case["fault_at"]:
                eng.apply_plan(_failstop_plan(cfg, plan))
                out["plans"].append(eng.plan.summary())
            out["losses"].append(eng.run_iteration(_tensor_batch(batch))[0])
            out["hand_offs"].append(_hand_off_log(eng))
        if eng.spmd:
            out["stages_after"] = _my_stages(eng)
        out["digest"] = _master_digest(eng)
        return out


def _pipe_migration_case(rank, world, case):
    """The reference's migration identity on this world: dp2/pp2/tp2 in
    bf16, no optimizer, the loss of one batch as planned and with F and B
    of (mb 0, stage 1, replica 0) on replica 1 -> both losses."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.core.detector.dag_sim import ChunkId
    from repro_torch.core.scheduler.plan import initial_plan
    from repro_torch.engine.pipeline import PipelineEngine

    import torch

    plan = initial_plan(PIPE_LAYERS, dp=2, pp=2, tp=2, microbatches=2)
    eng = PipelineEngine(_pipe_cfg(), plan, devices=["cpu"],
                         params=params_from_jax(case["params"], dtype=torch.float32,
                                                device="cpu"))
    batch = _tensor_batch(case["batch"])
    base, _ = eng.run_iteration(batch)
    placement = {ChunkId("F", 0, 1, 0): (1, 1), ChunkId("B", 0, 1, 0): (1, 1)}
    migrated, _ = eng.run_iteration(batch, placement=placement)
    return {"base": base, "migrated": migrated}


def migrator_placement(cfg, plan, slow, speed, delta):
    """The port migrator's placement (`engine_placement`) for one iteration
    of `plan` whose executor `slow` runs at `speed` (the others at 1.0),
    from the Scheduler's `migrator_kwargs` (chunk costs F 1, B 2, W 0.5, as
    the reference's tests) with Algorithm 1's `delta` -> {ChunkId: dst}."""
    from repro_torch.core.scheduler.migration import ProgressAwareMigrator, engine_placement
    from repro_torch.core.scheduler.repartition import costs_for_arch
    from repro_torch.core.scheduler.scheduler import AdaptationPlan, Scheduler

    speeds = {(r, s): 1.0 for r, rep in enumerate(plan.replicas) for s in range(rep.pp)}
    speeds[slow] = speed
    adaptation = AdaptationPlan(plan=plan, stage_speeds=speeds, dead_stages=(),
                                restore_required=False, plan_overhead_s=0.0)
    kw = Scheduler(layer_costs=costs_for_arch(cfg, PIPE_SEQ)).migrator_kwargs(
        adaptation, n_mb=plan.microbatches,
        chunk_base_cost=lambda cid: {"F": 1.0, "B": 2.0, "W": 0.5}[cid.kind])
    return engine_placement(ProgressAwareMigrator(**{**kw, "delta": delta}).run().migrations)


def _pipe_placement_case(rank, world, case):
    """dp2/pp2/tp2 in fp32, no optimizer: the loss of one batch as planned
    and under a placement, either the case's `placement` ([(kind, mb,
    stage, replica, dst)]) or the port migrator's (`migrator_placement` at
    the case's `migrator` = (slow executor, speed, delta)) -> both losses,
    the placement as such tuples, both iterations' hand-offs."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.core.detector.dag_sim import ChunkId
    from repro_torch.core.scheduler.plan import initial_plan
    from repro_torch.engine.pipeline import PipelineEngine

    cfg = _pipe_cfg()
    plan = initial_plan(PIPE_LAYERS, dp=2, pp=2, tp=2, microbatches=2)
    eng = PipelineEngine(cfg, plan, devices=["cpu"], compute_dtype=torch.float32,
                         params=params_from_jax(case["params"], dtype=torch.float32,
                                                device="cpu"))
    if "migrator" in case:
        placement = migrator_placement(cfg, plan, *case["migrator"])
    else:
        placement = {ChunkId(k, m, s, r): tuple(dst) for k, m, s, r, dst in case["placement"]}
    batch = _tensor_batch(case["batch"])
    base, _ = eng.run_iteration(batch)
    out = {"base": base, "base_hand_offs": _hand_off_log(eng)}
    out["placed"], _ = eng.run_iteration(batch, placement=placement)
    out["hand_offs"] = _hand_off_log(eng)
    out["placement"] = sorted((c.kind, c.mb, c.stage, c.replica, tuple(dst))
                              for c, dst in placement.items())
    return out


def _pipe_driver_case(rank, world, case):
    """`launch.train.main` in pipeline mode on every rank, once per argv in
    `case["runs"]` -> each run's result."""
    from repro_torch.launch import train

    return [train.main(argv) for argv in case["runs"]]


PIPELINE_CASES = {"meshes": _pipe_meshes_case, "failstop": _pipe_failstop_case,
                  "migration": _pipe_migration_case, "placement": _pipe_placement_case,
                  "driver": _pipe_driver_case}


def single_process(case):
    """`case` in this process, which has no process group, on one thread as
    a rank computes: the single-process engine -> its result."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the single-process engine runs where no process group is initialised")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return PIPELINE_CASES[case["kind"]](0, 1, case)
    finally:
        torch.set_num_threads(threads)


def pipeline_cases(rank, world, cases):
    """Every case of the pipeline engine on stage meshes, in order, on this
    world (no mesh of its own: the engine makes its stages') -> {name:
    result}, every rank's."""
    return {name: PIPELINE_CASES[case["kind"]](rank, world, case) for name, case in cases.items()}
