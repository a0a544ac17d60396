"""Sharding-rules engine (counterpart of `repro.parallel.sharding`).

Parameters and activations carry *logical* axes; a ShardingPolicy maps them
onto mesh axes with the reference's divisibility fallbacks and priority
order, so the same model code runs on one device (NULL_POLICY) and on a
`(data, model)` mesh. A spec is the reference's `PartitionSpec` entries as a
plain tuple: per tensor dim `None`, a mesh-axis name, or a tuple of names.
On a `torch.distributed.device_mesh.DeviceMesh` a spec becomes DTensor
placements (`placements_for`), one per mesh dim; an entry that names two
mesh axes shards its tensor dim over both, major axis first, as JAX does.

The mesh is a DeviceMesh or any object with the reference's `shape`
mapping and `axis_names` (the rules read only the sizes).

Logical axes used across the model zoo:
  batch, seq, dmodel, vocab, heads, kv_heads, head_dim, ffn, expert,
  layers (stack of layers: never sharded), dinner, state, conv, dtrank
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

_PRIORITY = {"vocab": 0, "ffn": 0, "dinner": 0, "heads": 0, "expert": 1, "kv_heads": 1,
             "head_dim": 2, "batch": 0, "kv_seq": 1, "seq": 3, "dmodel": 4}


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of an object with `shape` (a
    mapping) and `axis_names`."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh: shape is a tuple in mesh-dim order
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of None / str."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_map_axes(fn, axes_tree, *trees):
    """fn(axes, *leaves) over an axes tree and trees of its structure; a
    dict comes back in the key order of the first tree (so its leaves keep
    their order)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        keys = trees[0] if trees else axes_tree
        return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees)) for k in keys}
    return type(axes_tree)(tree_map_axes(fn, a, *xs) for a, *xs in zip(axes_tree, *trees))


@dataclass(frozen=True)
class ShardingPolicy:
    """Maps logical axes -> mesh axes. None mesh = single-device no-op."""

    mesh: Optional[Any] = None
    dp_axes: tuple = ()  # batch / FSDP axes, e.g. ('data',)
    tp_axis: Optional[str] = None  # tensor-parallel axis, e.g. 'model'
    fsdp: bool = True  # shard params (and opt state) over dp_axes
    seq_parallel: bool = False  # shard activation seq over tp between blocks
    decode_kv_seq_shard: bool = True  # shard KV caches over tp on the seq dim
    expert_parallel: bool = False  # shard experts over tp (vs per-expert TP)
    shard_batch: bool = True  # off for global_batch < dp
    attn_shard: Optional[str] = "heads"  # joint attention TP: 'heads' | 'head_dim' | None

    # ------------------------------------------------------------- sizes
    def axis_size(self, axes) -> int:
        if self.mesh is None or axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in axes) if axes else 1

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    @property
    def dp(self) -> int:
        return self.axis_size(self.dp_axes)

    # ------------------------------------------------------- logical->mesh
    def _mesh_axis_for(self, logical, dim: int, used: set):
        """The mesh axis (or axes) for one logical axis, or None."""
        tp, dp = self.tp_axis, self.dp_axes
        if logical is None or self.mesh is None:
            return None

        def tp_free():
            return tp is not None and tp not in used

        def dp_free():
            return bool(dp) and not (set(dp) & used)

        if logical in ("vocab", "ffn", "dinner"):
            if tp_free() and dim % self.tp == 0:
                return tp
        elif logical in ("heads", "kv_heads"):
            if self.attn_shard == "heads" and tp_free() and dim % self.tp == 0:
                return tp
        elif logical == "head_dim":
            if self.attn_shard == "head_dim" and tp_free() and dim % self.tp == 0:
                return tp
        elif logical == "expert":
            if self.expert_parallel and tp_free() and dim % self.tp == 0:
                return tp
        elif logical == "dmodel":  # the FSDP axis of parameters
            if self.fsdp and dp_free() and dim % self.dp == 0:
                return tuple(dp) if len(dp) > 1 else dp[0]
        elif logical == "batch":
            if self.shard_batch and dp_free():
                return tuple(dp) if len(dp) > 1 else dp[0]
        elif logical == "seq":
            if self.seq_parallel and tp_free() and dim % self.tp == 0:
                return tp
        elif logical == "kv_seq":
            if not self.decode_kv_seq_shard:
                return None
            if (not self.shard_batch and tp_free() and dp_free()
                    and dim % (self.tp * self.dp) == 0):
                return tuple(dp) + (tp,)  # tiny-batch long-context decode: every axis
            if tp_free() and dim % self.tp == 0:
                return tp
        return None

    def spec_for(self, axes: tuple, shape: tuple) -> tuple:
        """The spec of a tensor with the given logical axes: high-priority TP
        targets first, so ('heads', 'head_dim') puts TP on heads when it can
        and head_dim never double-books it."""
        order = sorted(range(len(axes)), key=lambda i: _PRIORITY.get(axes[i], 9))
        picked, used = {}, set()
        for i in order:
            ax = self._mesh_axis_for(axes[i], shape[i], used)
            if ax is not None:
                picked[i] = ax
                used.update((ax,) if isinstance(ax, str) else ax)
        return tuple(picked.get(i) for i in range(len(axes)))

    def batch_spec(self) -> tuple:
        if self.mesh is None or not self.dp_axes or not self.shard_batch:
            return ()
        return (tuple(self.dp_axes) if len(self.dp_axes) > 1 else self.dp_axes[0],)

    def tree_specs(self, axes_tree, values_tree):
        """Spec tree given separate axes and values trees."""
        return tree_map_axes(lambda ax, v: self.spec_for(ax, tuple(v.shape)), axes_tree,
                             values_tree)

    def replace(self, **kw) -> "ShardingPolicy":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ DTensor
    def placements_from_spec(self, spec: tuple) -> list:
        """DTensor placements, one per mesh dim, of a spec. A mesh axis of
        size 1 splits nothing: it is Replicate (the same layout, and
        DTensor's views then merge that dim freely)."""
        from torch.distributed.tensor import Replicate, Shard

        names, sizes = mesh_axis_names(self.mesh), mesh_sizes(self.mesh)
        placements = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in group]
            if idx != sorted(idx):  # DTensor shards one dim major-first in mesh order
                raise NotImplementedError(f"spec entry {entry} is not in mesh order {names}")
            for i in idx:
                if sizes[names[i]] > 1:
                    placements[i] = Shard(dim)
        return placements

    def placements_for(self, axes: tuple, shape: tuple) -> list:
        """DTensor placements of a tensor with the given logical axes."""
        return self.placements_from_spec(self.spec_for(tuple(axes), tuple(shape)))

    def batch_placements(self, ndim=1) -> list:
        """Placements of a batch tensor: dim 0 over the dp axes."""
        spec = self.batch_spec()
        return self.placements_from_spec(spec + (None,) * (ndim - len(spec)))

    def distribute(self, tree, axes_tree):
        """Place a tree of tensors as DTensors by their logical axes; each rank
        passes the full tensors (the same on every rank). Without a mesh
        the tree comes back as it is."""
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import distribute_tensor

        def place(ax, t):
            d = distribute_tensor(t.detach(), self.mesh, self.placements_for(ax, t.shape))
            return d.requires_grad_(t.requires_grad)
        return tree_map_axes(place, axes_tree, tree)

    def distribute_batch(self, batch):
        """A dict of batch tensors (every one batch-major) as DTensors sharded
        over the dp axes; each rank passes the whole batch."""
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor
        return {k: distribute_tensor(v, self.mesh, self.batch_placements(v.dim()))
                for k, v in batch.items()}

    def gathered(self, w):
        """The DTensor weight w as a step multiplies with it: its FSDP shards
        (over the dp axes) gathered, its split over tp kept. Each rank then
        multiplies its own rows by the whole weight, as the reference's FSDP
        does, and the backward reduce-scatters the weight's gradient onto its
        shards (DTensor left to choose may instead gather the activations
        and all-reduce partial products). w itself without a mesh."""
        if self.mesh is None:
            return w
        from torch.distributed.tensor import Replicate

        names = mesh_axis_names(self.mesh)
        placements = [Replicate() if names[i] in self.dp_axes else pl
                      for i, pl in enumerate(w.placements)]
        return w.redistribute(self.mesh, placements)

    def run_local(self, fn, in_axes, out_axes, *args):
        """fn(*args) on each rank's local shards, through `local_map`: the
        argument i placed by its logical axes `in_axes[i]` (None for an
        argument that is not a tensor, or is None), the outputs (fn returns
        a tuple) placed by `out_axes`, one (axes, shape) each. An argument
        replicated over a mesh dim over which an output is split gets its
        gradient there as a partial sum (each rank's part of the whole): the
        ranks computed different parts. Without a mesh, fn(*args) with each
        tensor that asks for a gradient passed as a view of itself: its
        gradient is then summed inside fn before it joins the argument's
        other uses, as `local_map`'s hand-over sums it, so that a one-rank
        mesh gives the unsharded step's numbers bit for bit."""
        if self.mesh is None:
            return fn(*(a.view_as(a) if isinstance(a, torch.Tensor) and a.requires_grad else a
                        for a in args))
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        ins = tuple(None if ax is None or a is None else self.placements_for(ax, a.shape)
                    for ax, a in zip(in_axes, args, strict=True))
        outs = tuple(self.placements_for(ax, shape) for ax, shape in out_axes)
        split = {i for pl in outs for i, p in enumerate(pl) if isinstance(p, Shard)}
        grads = tuple(None if pl is None else [
            Partial() if i in split and isinstance(p, Replicate) else p for i, p in enumerate(pl)]
            for pl in ins)
        return local_map(fn, out_placements=outs, in_placements=ins, in_grad_placements=grads,
                         device_mesh=self.mesh, redistribute_inputs=True)(*args)

    def constrain(self, x, *axes):
        """Redistribute the DTensor x to its logical axes' placements (the
        reference's `with_sharding_constraint`); x itself without a mesh."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self.placements_for(axes, x.shape))


NULL_POLICY = ShardingPolicy()


def policy_for_mesh(mesh, **kw) -> ShardingPolicy:
    """Infer dp/tp axes from a mesh's axis names."""
    if mesh is None:
        return NULL_POLICY
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in names if a in ("pod", "data", "replica", "fsdp"))
    tp = "model" if "model" in names else None
    return ShardingPolicy(mesh=mesh, dp_axes=dp, tp_axis=tp, **kw)


def stage_policy(mesh, cfg) -> ShardingPolicy:
    """The policy of one pipeline stage's `(data, model)` mesh, the
    reference engine's (`PipelineEngine.apply_plan`): `policy_for_mesh`
    without a batch split, attention split over tp by heads where tp
    divides `n_heads`, else by head_dim where it divides `head_dim`, else
    not split. NULL_POLICY without a mesh."""
    pol = policy_for_mesh(mesh, shard_batch=False)
    if mesh is None:
        return pol
    tp = pol.tp
    rule = "heads" if cfg.n_heads % tp == 0 else "head_dim" if cfg.head_dim % tp == 0 else None
    return pol.replace(attn_shard=rule)


def mesh_block(mesh, dims):
    """(blocks, this rank's block) of a tensor dim split over the DeviceMesh
    dims `dims`, major mesh dim first, as DTensor splits it."""
    n, block = 1, 0
    for i in dims:
        n, block = n * mesh.size(i), block * mesh.size(i) + mesh.get_local_rank(i)
    return n, block


def placed_as(tree, like):
    """Each DTensor of `tree` placed as the same key's of `like` (a decode
    step's new state as its cache was placed, so that the cache keeps its
    layout from step to step); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return {k: v.redistribute(like[k].device_mesh, like[k].placements)
            if isinstance(v, DTensor) else v for k, v in tree.items()}


def gather(tree):
    """A tree of DTensors as full plain tensors (`full_tensor`); other
    leaves as they are."""
    from torch.distributed.tensor import DTensor

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    return full(tree) if isinstance(tree, torch.Tensor) else tree


def arange_rows_like(seg):
    """(B, S) int32 rows 0..S-1 on seg's device; for a DTensor seg (split
    over rows only, as a batch is), a DTensor placed as seg, each rank's
    rows made where they live."""
    from torch.distributed.tensor import DTensor

    def rows(B, S, device):
        return torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)
    if isinstance(seg, DTensor):
        local = seg.to_local()
        return DTensor.from_local(rows(*local.shape, local.device), seg.device_mesh,
                                  seg.placements, run_check=False)
    return rows(*seg.shape, seg.device)
