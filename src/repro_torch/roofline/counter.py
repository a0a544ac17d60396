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
    ops made, collectives' outputs included (each held until it is freed);
  * the top ops by flops and by bytes, in place of the reference's
    `hbm_by_scope`.

Under DTensor it counts each rank's local work: it returns NotImplemented
for DTensor arguments, so that DTensor unwraps them and runs the local ops
(and the collectives of its redistributions) through the mode, and it
counts no op on fake tensors or under a fake mode (DTensor's sharding
propagation runs the ops on fake tensors of the global shapes). An eager
step unrolls its loops and runs each op once, and remat's recompute is
counted as it runs; the reference's loop-invariant hoisting and dtype-glue
discounts have no counterpart.

The recurrences' loops over positions or chunks go through `scan`, the
counterpart of the reference's trip counts (`_trip_count`, which scales a
`while` body by its iterations). On tensors with data, or with no counter
active, `scan` is the plain loop. On meta tensors under a counter it runs
SAMPLE of its n iterations and counts them as n: the first and the last
once, the SAMPLE - 2 middle ones (n - 2) / (SAMPLE - 2) times each, in the
forward (while they run) and in the backward (the autograd nodes they made,
found by sequence number, and the gradient sums those nodes feed). The
storages the middle iterations leave alive (the outputs, saved activations,
and in the backward the positions' gradients) are scaled into the live
bytes as n iterations would hold them. The ops outside the loop run once at
their full shapes: the iterations not run hand the sequence's `unbind` a
gradient that is a view of one zero, and its outputs are such views too,
counted by their shapes where the loop's `cat` or `stack` reads them.
On a `cpu` DeviceMesh DTensor moves a shard from one dim to another by an
all-gather and a chunk (no all-to-all there); NCCL uses an all-to-all.
"""
from __future__ import annotations

import bisect
import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
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
# iterations a loop runs under a counter on meta tensors (`scan`): the first,
# SAMPLE - 2 middle ones (a power of two, so that their scale is exact), the last
SAMPLE = 6
_ACTIVE = []  # the OpCounters entered, innermost last


def scan(step, carry, xs):
    """The recurrences' loop (the reference's `lax.scan`): for each t of
    range(n), carry, y_t = step(carry, *(x[t] for x in xs)), where xs are
    sequences of n tensors each (a tensor's `unbind`); -> (carry, [y_0, ..,
    y_{n-1}]). The plain loop on tensors with data or with no OpCounter
    active; under one on meta tensors, SAMPLE iterations counted as n (the
    module's docstring)."""
    n = len(xs[0])
    if _ACTIVE and n > SAMPLE and xs[0][0].device.type == "meta":
        return _ACTIVE[-1]._scaled_scan(step, carry, xs, n)
    ys = []
    for x in zip(*xs):
        carry, y = step(carry, *x)
        ys.append(y)
    return carry, ys


class _Filler(torch.autograd.Function):
    """The outputs of a scaled loop's iterations that did not run, views of
    one zero shaped as `like`; its backward gives each of their inputs that
    asks for one a gradient of the same kind, so that the sequence's
    `unbind` stacks as many gradients as the whole loop's does. Runs with
    its counter paused: it moves no bytes and holds none."""

    @staticmethod
    def forward(ctx, counter, like, m, groups, *inputs):
        """groups: (count, shape, dtype, device) of the inputs, in runs."""
        ctx.counter, ctx.groups = counter, groups
        ctx.set_materialize_grads(False)
        shape, dtype, device = like
        with counter.paused():
            return torch.zeros((), dtype=dtype, device=device).expand((m,) + shape).unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        out = [None] * 4
        with ctx.counter.paused():
            for count, shape, dtype, device in ctx.groups:
                out += [torch.zeros((), dtype=dtype, device=device).expand(shape)] * count
        return tuple(out)


def _nbytes(t):
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of an op's arguments or outputs (nested lists, tuples and
    dicts), in order: `tree_leaves` without its generality, which the
    counter paid for on every op."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


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
        self.scale = 1.0  # the count of each op while a scaled loop's iteration runs
        self.scaled_loops = 0  # the loops run in part and counted whole (`scan`)
        self._paused = 0
        self._window = None  # where made storages are listed for a scaled loop's memory
        # the backward's scaled loops by autograd sequence number, sorted:
        # (lo, hi, scale, memory window {"lo", "until", "factor", "keys"})
        self._ranges, self._range_los = [], []
        self._open = {}  # memory windows whose nodes have begun to run, by id

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Ops run here are neither counted nor held."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

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
        if self._paused:
            return func(*args, **kwargs)
        fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
        out = func(*args, **kwargs)
        if fake:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(isinstance(t, FakeTensor) for t in ins + outs):
            self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs):
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        scale, window = self.scale, self._window
        if self._ranges and scale == 1.0:
            scale, window = self._backward_scale()
        self.calls[name] += scale
        out_b = sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
            if kind is not None:
                g = _group_size(func, args)
                if g > 1:
                    self.collective_bytes[kind] += scale * _RING[kind](
                        out_b, sum(map(_nbytes, ins)), g)
            self._hold_outputs(ins, outs, window)  # a collective's output is memory too
            return
        if packet in flop_registry:
            f = scale * float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            if func.namespace != "repro_torch":  # the attention kernels count apart
                self.matmul_flops += f
            self.flops_by_op[name] += f
        elif torch.Tag.pointwise in func.tags:
            f = scale * float(sum(t.numel() for t in outs))
            self.flops += f
            self.flops_by_op[name] += f
        elif _REDUCTION is not None and _REDUCTION in func.tags and ins:
            f = scale * float(ins[0].numel())
            self.flops += f
            self.flops_by_op[name] += f
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            b = scale * float(sum(map(_nbytes, ins)) + out_b)
            self.hbm_bytes += b
            self.bytes_by_op[name] += b
        self._hold_outputs(ins, outs, window)

    def _hold_outputs(self, ins, outs, window):
        inputs = {t.untyped_storage()._cdata for t in ins}
        for t in outs:  # a view's or an in-place op's storage is not new
            storage = t.untyped_storage()
            if storage._cdata not in inputs:
                self._hold(storage, window)

    def _hold(self, storage, window=None):
        key = storage._cdata
        if key in self._held:
            return
        nbytes = storage.nbytes()

        def freed(_, key=key):
            entry = self._held.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[1]
        ref = weakref.ref(storage, freed)
        self._held[key] = (ref, nbytes)
        if window is not None:
            window.append((key, ref))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _grow(self, window, factor):
        """The storages of `window` still alive held `factor` times (the
        iterations they stand for), as long as they live."""
        for key, ref in window:
            entry = self._held.get(key)
            if entry is not None and entry[0] is ref:
                self._held[key] = (ref, entry[1] * factor)
                self.live_bytes += entry[1] * (factor - 1)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _seq_mark(self):
        """The autograd sequence number of a node made now (under grad mode)."""
        with self.paused():
            leaf = torch.empty((), device="meta", requires_grad=True)
            return (leaf * 1).grad_fn._sequence_nr()

    def _scaled_scan(self, step, carry, xs, n):
        """`scan` of n iterations on meta tensors: SAMPLE run (see the
        module's docstring). Ops of iterations 1..k-2 count f = (n-2)/(k-2)
        times; the storages iterations 1..k-3 leave alive at the loop's end
        (and, in the backward, those made by iterations 2..k-2's nodes and
        alive once iteration 0's begin) are held g = (n-3)/(k-3) times: the
        iteration before the last (the first, in the backward) hands its
        carry on, which is not kept."""
        k = SAMPLE
        f, g = (n - 2) / (k - 2), (n - 3) / (k - 3)
        self.scaled_loops += 1
        grad = torch.is_grad_enabled()
        marks, ys, window = [], [], []
        for t in range(k):
            marks.append(self._seq_mark() if grad else None)
            self.scale = f if 1 <= t <= k - 2 else 1.0
            self._window = window if 1 <= t <= k - 3 else None
            try:
                carry, y = step(carry, *(x[t] for x in xs))
            finally:
                self.scale, self._window = 1.0, None
            ys.append(y)
        self._grow(window, g)
        if grad:  # nodes made in iterations 1..k-2, and 2..k-2 for the memory
            i = bisect.bisect(self._range_los, marks[1])
            self._ranges.insert(i, (marks[1], marks[k - 1], f, {
                "lo": marks[2], "until": marks[1], "factor": g, "keys": []}))
            self._range_los.insert(i, marks[1])
        rest = [x[k:] for x in xs if x[k].requires_grad]  # a sequence's tensors are alike
        groups = [(len(r), r[0].shape, r[0].dtype, r[0].device) for r in rest]
        like = (tuple(ys[-1].shape), ys[-1].dtype, ys[-1].device)
        return carry, ys + list(_Filler.apply(self, like, n - k, groups,
                                              *(t for r in rest for t in r)))

    def _backward_scale(self):
        """(scale, memory window) of an op run by the autograd node now
        executing: f inside a scaled loop's middle iterations, else 1; a
        window whose nodes have all run is grown first."""
        node = torch._C._current_autograd_node()
        if node is None:
            return 1.0, None
        seq = node._sequence_nr()
        for key, w in list(self._open.items()):
            if seq < w["until"]:
                self._grow(w["keys"], w["factor"])
                w["keys"] = []
                del self._open[key]
        i = bisect.bisect(self._range_los, seq) - 1
        if i < 0 or seq >= self._ranges[i][1]:
            return 1.0, None
        _, _, scale, w = self._ranges[i]
        if seq <= w["lo"]:
            return scale, None
        self._open[id(w)] = w
        return scale, w["keys"]

    def as_dict(self):
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:self.top]]
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "attention_flops": self.attention_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "total_collective_bytes": self.total_collective_bytes,
                "peak_bytes": self.peak_bytes, "ops": round(sum(self.calls.values())),
                "scaled_loops": self.scaled_loops,
                "top_by_flops": top(self.flops_by_op), "top_by_bytes": top(self.bytes_by_op)}
