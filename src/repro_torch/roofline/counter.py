"""Op-level cost counter of an eager step (counterpart of `repro.roofline.hlo`).

The reference walks the compiled XLA HLO text of a step. The port runs its
step eagerly, so `OpCounter`, a `TorchDispatchMode`, counts what one rank
runs, op by op, as it runs (on the meta device for a dry-run, or on the
card):

  * flops: `torch.utils.flop_counter`'s formulas (2*M*N*K a product, and
    the attention kernels' visible pairs: `kernels.ops`), plus 1 a result
    element for each elementwise op and 1 an input element for each
    reduction, as the reference counts; matmul_flops: the products alone,
    attention_flops: the attention kernels alone (their count depends on
    the ids, on meta tensors on an assumption: `kernels.ops.visible_pairs`);
  * hbm_bytes: each op's operand and output bytes, the reference's upper
    bound; views, allocations and collectives move none here;
  * collective_bytes by kind: the `_c10d_functional` ops, at the
    reference's ring factors (`_RING`) and the size of each op's group;
  * peak_bytes: the most bytes held at once by the storages the counted
    ops made (each held until it is freed);
  * the top ops by flops and by bytes, in place of the reference's
    `hbm_by_scope`.

Under DTensor it counts each rank's local work: it returns NotImplemented
for DTensor arguments, so that DTensor unwraps them and runs the local ops
(and the collectives of its redistributions) through the mode, and it
counts no op on fake tensors or under a fake mode (DTensor's sharding
propagation runs the ops on fake tensors of the global shapes). The
reference's loop trip counts, loop-invariant hoisting and dtype-glue
discounts have no counterpart: an eager step unrolls its loops and runs
each op once, and remat's recompute is counted as it runs.
On a `cpu` DeviceMesh DTensor moves a shard from one dim to another by an
all-gather and a chunk (no all-to-all there); NCCL uses an all-to-all.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# ring bytes per rank of one collective, by kind: (output bytes, input bytes, group size)
_RING = {
    "all-gather": lambda out_b, in_b, g: out_b * (g - 1) / g,
    "all-reduce": lambda out_b, in_b, g: 2.0 * out_b * (g - 1) / g,
    "reduce-scatter": lambda out_b, in_b, g: in_b * (g - 1) / g,
    "all-to-all": lambda out_b, in_b, g: out_b * (g - 1) / g,
}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "all_reduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
# ops that move no bytes: allocations, and views the schema does not mark as such
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "_unsafe_view", "lift_fresh", "alias"}
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _nbytes(t):
    return t.numel() * t.element_size()


def _group_size(func, args):
    """The size of a `_c10d_functional` op's group: its group_size argument,
    or that of the process group its name resolves to."""
    for a, arg in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(arg)
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = next(arg for a, arg in zip(func._schema.arguments, args) if a.name == "group_name")
    return _resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Counts the work of the ops run under it; see the module's docstring.
    `as_dict()` is the record; `attention_flops` the kernel ops' share."""

    def __init__(self, top=10):
        super().__init__()
        self.top = top
        self.flops = self.matmul_flops = self.hbm_bytes = 0.0
        self.collective_bytes = defaultdict(float)
        self.flops_by_op, self.bytes_by_op = defaultdict(float), defaultdict(float)
        self.calls = defaultdict(int)
        self.live_bytes = self.peak_bytes = 0
        self._held = {}  # a made storage's address -> (weakref, bytes)

    @property
    def total_collective_bytes(self):
        return sum(self.collective_bytes.values())

    @property
    def attention_flops(self):
        return sum(f for name, f in self.flops_by_op.items() if name.startswith("repro_torch."))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
        out = func(*args, **kwargs)
        if not (fake or any(isinstance(a, FakeTensor) for a in tree_leaves((args, kwargs, out)))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        self.calls[name] += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        out_b = sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
            if kind is not None:
                g = _group_size(func, args)
                if g > 1:
                    self.collective_bytes[kind] += _RING[kind](out_b, sum(map(_nbytes, ins)), g)
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            if func.namespace != "repro_torch":  # the attention kernels count apart
                self.matmul_flops += f
            self.flops_by_op[name] += f
        elif torch.Tag.pointwise in func.tags:
            f = float(sum(t.numel() for t in outs))
            self.flops += f
            self.flops_by_op[name] += f
        elif _REDUCTION is not None and _REDUCTION in func.tags and ins:
            f = float(ins[0].numel())
            self.flops += f
            self.flops_by_op[name] += f
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            b = float(sum(map(_nbytes, ins)) + out_b)
            self.hbm_bytes += b
            self.bytes_by_op[name] += b
        inputs = {t.untyped_storage()._cdata for t in ins}
        for t in outs:  # a view's or an in-place op's storage is not new
            storage = t.untyped_storage()
            if storage._cdata not in inputs:
                self._hold(storage)

    def _hold(self, storage):
        key = storage._cdata
        if key in self._held:
            return
        nbytes = storage.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            if self._held.pop(key, None) is not None:
                self.live_bytes -= nbytes
        self._held[key] = (weakref.ref(storage, freed), nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def as_dict(self):
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:self.top]]
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "attention_flops": self.attention_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "total_collective_bytes": self.total_collective_bytes,
                "peak_bytes": self.peak_bytes, "ops": sum(self.calls.values()),
                "top_by_flops": top(self.flops_by_op), "top_by_bytes": top(self.bytes_by_op)}
