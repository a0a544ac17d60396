"""Fault-tolerant checkpointing: tensor-level save/restore with placement on
load, double-buffered step directories, and an atomic commit marker
(counterpart of `repro.checkpoint.checkpoint`, with its on-disk layout).

Layout:
    <root>/step_000123/
        MANIFEST.json        # structure + per-leaf dtype/shape + extra payload
        leaf_00000.npy ...   # flattened leaves in JAX's pytree order
        COMMIT               # written last; restore ignores dirs without it

A write goes to `step_N.tmp/` and is atomically renamed after COMMIT exists,
so a crash mid-save never corrupts the latest restorable state (Fig. 8b's
"persistent states from the last completed iteration").

Leaves are numbered in JAX's pytree order (dict keys sorted, lists and tuples
in order, None holds no leaf, a Python int is a 0-d leaf), so the two
packages read each other's files. The manifest's `treedef` is the JAX
package's serialized structure, which torch cannot read or write: a file
written here holds `treedef: null` and its own structure under `structure`,
and restores in the JAX package with `target=`; a file written there
restores here with `target=`. bf16 leaves are written as the JAX package
writes them (npy descr `<V2`, manifest dtype `bfloat16`) and read back by
the manifest's dtype. `shardings` is a tree of `torch.device` (or None, the
CPU), or one device for every leaf, that restored leaves are loaded onto.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _flatten(tree):
    """-> (leaves, structure): leaves in JAX's order, structure as JSON."""
    leaves = []

    def walk(x):
        if x is None:
            return {"none": True}
        if isinstance(x, dict):
            keys = sorted(x)
            if not all(isinstance(k, str) for k in keys):
                raise TypeError(f"checkpoint dict keys must be strings, got {keys}")
            return {"dict": keys, "children": [walk(x[k]) for k in keys]}
        if isinstance(x, (list, tuple)):
            return {type(x).__name__: [walk(v) for v in x]}
        kind = {bool: "bool", int: "int", float: "float"}.get(type(x), "tensor")
        leaves.append(x)
        return {"leaf": kind}

    return leaves, walk(tree)


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(node):
        if "none" in node:
            return None
        if "dict" in node:
            return {k: build(c) for k, c in zip(node["dict"], node["children"])}
        if "list" in node:
            return [build(c) for c in node["list"]]
        if "tuple" in node:
            return tuple(build(c) for c in node["tuple"])
        return next(it)

    return build(structure)


def _leaf_kinds(structure):
    kinds = []

    def walk(node):
        if "leaf" in node:
            kinds.append(node["leaf"])
        for key in ("children", "list", "tuple"):
            for c in node.get(key, ()):
                walk(c)

    walk(structure)
    return kinds


def _up_to(structure, tree):
    """`tree`'s subtrees at the leaf positions of `structure` (JAX's
    `flatten_up_to`): one value per leaf."""
    out = []

    def walk(node, x):
        if "none" in node:
            return
        if "leaf" in node:
            out.append(x)
        elif "dict" in node:
            for k, c in zip(node["dict"], node["children"]):
                walk(c, x[k])
        else:
            for c, v in zip(node.get("list", node.get("tuple")), x):
                walk(c, v)

    walk(structure, tree)
    return out


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path, arr, dtype):
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the bytes and header `np.save` writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path, meta, kind, device):
    arr = np.load(path)
    if kind in ("int", "float", "bool"):
        return {"int": int, "float": float, "bool": bool}[kind](arr)
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def save_checkpoint(root, state, step: int, *, extra: Optional[dict] = None,
                    keep: int = 2) -> Path:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:09d}"
    tmp = root / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves, structure = _flatten(state)
    manifest = {
        "step": step,
        "treedef": None,  # the JAX package's proto; restore there with target=
        "structure": structure,
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        _save_leaf(tmp / f"leaf_{i:05d}.npy", arr, dtype)
        manifest["leaves"].append({"dtype": dtype, "shape": list(arr.shape)})
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(root, keep)
    return final


def _gc(root: Path, keep: int):
    steps = sorted(
        (p for p in root.glob("step_*") if (p / "COMMIT").exists()),
        key=lambda p: p.name,
    )
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root) -> Optional[int]:
    root = Path(root)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.glob("step_*")
        if (p / "COMMIT").exists() and not p.name.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore_checkpoint(root, *, step: Optional[int] = None, target=None,
                       shardings=None) -> tuple:
    """-> (state, step, extra). `target` (a tree of the same structure) gives
    the structure, and is needed for a file the JAX package wrote;
    `shardings` (a tree of `torch.device` or None, or one device) places the
    leaves. Leaves keep the dtype they were saved in."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = root / f"step_{step:09d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    if target is not None:
        target_leaves, structure = _flatten(target)
    elif manifest.get("structure") is not None:
        target_leaves, structure = None, manifest["structure"]
    else:
        raise ValueError(f"{d} was written by the JAX package: pass target= for its structure")
    kinds = _leaf_kinds(structure)
    if len(kinds) != manifest["n_leaves"]:
        raise ValueError(f"{d}: {manifest['n_leaves']} leaves, the structure has {len(kinds)}")
    if shardings is None or isinstance(shardings, (torch.device, str)):
        devices = [shardings] * len(kinds)
    else:
        devices = _up_to(structure, shardings)
    leaves = []
    for i, (meta, kind, dev) in enumerate(zip(manifest["leaves"], kinds, devices)):
        want = target_leaves[i] if target_leaves is not None else None
        if isinstance(want, torch.Tensor) and list(want.shape) != meta["shape"]:
            raise ValueError(f"{d}: leaf {i} has shape {meta['shape']}, the target "
                             f"{list(want.shape)}")
        leaves.append(_load_leaf(d / f"leaf_{i:05d}.npy", meta, kind, dev))
    return _unflatten(structure, leaves), step, manifest["extra"]


class CheckpointManager:
    """Every-N-steps checkpointing with restart support for the train loop."""

    def __init__(self, root, *, interval: int = 50, keep: int = 2):
        self.root = Path(root)
        self.interval = interval
        self.keep = keep

    def due(self, step: int) -> bool:
        return step % self.interval == 0 and step > 0

    def maybe_save(self, state, step: int, extra=None) -> Optional[Path]:
        if self.due(step):
            return save_checkpoint(self.root, state, step, extra=extra, keep=self.keep)
        return None

    def restore_latest(self, *, target=None, shardings=None):
        return restore_checkpoint(self.root, target=target, shardings=shardings)

    def has_checkpoint(self) -> bool:
        return latest_step(self.root) is not None
