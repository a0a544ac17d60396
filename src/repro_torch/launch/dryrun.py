"""Production-mesh dry-run: run every (arch x shape x mesh) cell's step on
meta tensors and record its memory and counted roofline terms.

Counterpart of `repro.launch.dryrun`. The reference lowers and compiles each
cell from ShapeDtypeStructs on 256 or 512 host devices. Here the mesh of
`make_production_mesh`'s shape, (16, 16) or (2, 16, 16), is a `cpu`
DeviceMesh over a fake process group of 256 or 512 ranks
(`torch.testing._internal.distributed.fake_pg`, backend "fake"; this
process is rank 0, and every collective returns at once), and every tensor
is on the meta device: the dry-run allocates nothing and touches no card.
The step the cell names (`build_train_step`, `build_prefill_step`,
`build_serve_step`) runs once, eagerly, on DTensors placed as
`launch.specs.input_specs` says, under `roofline.counter.OpCounter`, which
counts rank 0's local work. Its record keeps the reference's keys where
they carry over: `trace_s` stands in for `lower_s` and `compile_s`; the
memory is the arguments' bytes on rank 0 (exact, from its local shard
shapes) and the counter's peak of the bytes the step's ops held
(`temp_bytes`); `hbm_model` fits them against one H100's 80 GB.

`status` is `ok`, `skipped` (the config's `shape_skips`), `not_ported` (a
step that raises NotImplementedError, with its text; no family does) or
`error` (a traceback, from `main`). Every family runs on both meshes: the
dense, the MoE (its tokens over (pod, data) on (2, 16, 16)), the VLM, the
encoder-decoder, and the recurrent and hybrid ones (xlstm, jamba), whose
loops over positions or chunks run on local shards and, on meta tensors,
run a few iterations counted as all (`roofline.counter.scan`).
Training accumulates gradients in bf16 above 5e10 parameters (grok-1,
jamba) and in float32 below, as the reference's dry-run does
(`accum_dtype_for`); each record names the type (`accum_dtype`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES_BY_NAME, get_arch
from repro_torch.launch.specs import input_specs
from repro_torch.parallel.sharding import mesh_sizes, policy_for_mesh
from repro_torch.roofline.analysis import H100, roofline_terms
from repro_torch.roofline.counter import OpCounter
from repro_torch.train.train_step import (
    build_prefill_step,
    build_serve_step,
    build_train_step,
)


def accum_dtype_for(cfg):
    """The train step's gradient accumulation type for a cell: bf16 above
    5e10 parameters, else float32 (the reference's rule)."""
    return torch.bfloat16 if cfg.param_count() > 5e10 else torch.float32


def production_mesh_shape(multi_pod=False):
    """The reference's production grid: (16, 16) (data, model), or two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def fake_mesh(shape, axes):
    """A `cpu` DeviceMesh of `shape` over a new fake process group of as
    many ranks, this process rank 0. The default group is made anew for
    every mesh: two meshes of one shape made over one group, then a mesh of
    another shape, then the first shape again, left DTensor resolving a
    subgroup of a destroyed group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def policy_for_cell(mesh, cfg, shape):
    sizes = mesh_sizes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    policy = policy_for_mesh(mesh, shard_batch=shape.global_batch >= dp)
    tp = policy.tp
    if tp and cfg.n_heads % tp == 0:
        attn = "heads"
    elif tp and cfg.head_dim % tp == 0:
        attn = "head_dim"
    else:
        attn = None
    return policy.replace(attn_shard=attn)


def step_fn_for_cell(cfg, shape, policy, opt, *, microbatches=None, remat=True):
    if shape.kind == "train":
        if microbatches is None:
            microbatches = max(1, shape.global_batch // max(policy.dp, 1))
        return build_train_step(cfg, opt, policy=policy, microbatches=microbatches, remat=remat,
                                accum_dtype=accum_dtype_for(cfg))
    if shape.kind == "prefill":
        return build_prefill_step(cfg, policy=policy)
    return build_serve_step(cfg, policy=policy)


def _place(mesh, tree, placements):
    """Meta specs as DTensors on `mesh` by a placements tree of the same structure."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree.detach(), mesh, placements).requires_grad_(
            tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _place(mesh, v, placements.get(k)) for k, v in tree.items()}
    return type(tree)(_place(mesh, v, p) for v, p in zip(tree, placements, strict=True))


def argument_bytes(tree):
    """Bytes this rank holds of a tree of DTensors (its local shards) and tensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _cell_name(arch_id, shape_name, multi_pod, tag):
    return f"{arch_id}__{shape_name}__{'pod2' if multi_pod else 'pod1'}__{tag}"


def _write(out_dir, name, rec):
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.json").write_text(json.dumps(rec, indent=2, default=str))


def run_cell(arch_id, shape_name, *, multi_pod=False, out_dir=None, policy_overrides=None,
             tag="baseline", cfg_overrides=None, microbatches=None, remat=True):
    """One cell's record (see the module's docstring)."""
    cfg = get_arch(arch_id)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod, "tag": tag,
           "status": "ok", "accum_dtype": str(accum_dtype_for(cfg)).removeprefix("torch.")}
    name = _cell_name(arch_id, shape_name, multi_pod, tag)
    if shape_name in cfg.shape_skips:
        rec["status"] = "skipped"
        rec["reason"] = cfg.shape_skips[shape_name]
        _write(out_dir, name, rec)
        return rec

    t0 = time.time()
    dmesh = fake_mesh(*production_mesh_shape(multi_pod))
    n_dev = dmesh.size()
    rec["n_devices"] = n_dev
    rec["mesh"] = dict(zip(dmesh.mesh_dim_names, dmesh.shape))
    policy = policy_for_cell(dmesh, cfg, shape)
    if policy_overrides:
        policy = policy.replace(**policy_overrides)
    counter = OpCounter()
    try:
        args_s, placements, opt = input_specs(cfg, shape, policy)
        step = step_fn_for_cell(cfg, shape, policy, opt, microbatches=microbatches, remat=remat)
        args = _place(dmesh, args_s, placements)
        arg_bytes = argument_bytes(args)  # the batch's shard, which the step reads
        if shape.kind == "train":
            # the train step splits the whole global batch itself, and its
            # counter stays plain, as `place_state` keeps it (the optimizer
            # reads it on the host)
            args = (dict(args[0], step=torch.zeros((), dtype=torch.int32)), args_s[1])
        with counter:
            step(*args)
    except NotImplementedError as e:
        rec["status"] = "not_ported"
        rec["reason"] = str(e)
        _write(out_dir, name, rec)
        return rec
    terms = roofline_terms(counter, n_dev, cfg, shape)
    rec.update({
        "trace_s": round(time.time() - t0, 2),
        "memory_analysis": {"argument_bytes": arg_bytes, "temp_bytes": counter.peak_bytes},
        "counter": counter.as_dict(),
        "roofline": terms,
    })
    per_dev = arg_bytes + counter.peak_bytes
    rec["hbm_model"] = {"per_device_bytes": per_dev, "capacity_bytes": int(H100.hbm_bytes),
                        "fits": bool(per_dev <= H100.hbm_bytes)}
    _write(out_dir, name, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    counts = {"ok": 0, "skip": 0, "not_ported": 0, "fail": 0}
    for a, s, mp in cells:
        name = _cell_name(a, s, mp, "baseline")
        if args.skip_existing and (Path(args.out) / f"{name}.json").exists():
            print(f"[dryrun] {name}: exists, skipping")
            continue
        t0 = time.time()
        try:
            rec = run_cell(a, s, multi_pod=mp, out_dir=args.out)
        except Exception as e:  # noqa: BLE001 - record failures, keep sweeping
            counts["fail"] += 1
            _write(args.out, name, {"arch": a, "shape": s, "multi_pod": mp, "status": "error",
                                    "error": str(e), "traceback": traceback.format_exc()})
            print(f"[dryrun] {name}: FAIL {e}", flush=True)
            continue
        if rec["status"] == "skipped":
            counts["skip"] += 1
            print(f"[dryrun] {name}: SKIP ({rec['reason']})", flush=True)
        elif rec["status"] == "not_ported":
            counts["not_ported"] += 1
            print(f"[dryrun] {name}: NOT PORTED ({rec['reason']})", flush=True)
        else:
            counts["ok"] += 1
            r = rec["roofline"]
            print(
                f"[dryrun] {name}: OK {time.time()-t0:.0f}s "
                f"bound={r['bound']} compute={r['compute_s']:.4f}s "
                f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                f"frac={r.get('roofline_fraction', 0):.3f} "
                f"gb={rec['hbm_model']['per_device_bytes'] / 1e9:.2f} "
                f"fits={rec['hbm_model']['fits']}", flush=True)
    print(f"[dryrun] done ok={counts['ok']} skip={counts['skip']} "
          f"not_ported={counts['not_ported']} fail={counts['fail']}", flush=True)
    return 1 if counts["fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
