"""Host-orchestrated pipeline-parallel engine (paper §7's runtime), counterpart
of `repro.engine.pipeline`.

The Scheduler emits per-stage instruction streams (Forward / Backward /
SendAct / RecvAct / reduce); a lightweight interpreter executes them against
per-stage meshes. This is the engine that runs ParallelPlans end to end:
kill a device, the Scheduler re-plans, recovery moves the state, training
resumes.

Two forms of one interpreter:
  * under an initialised process group, each stage runs as an SPMD
    program on its own `(data, model)` `DeviceMesh` over the world ranks its
    plan devices map onto (`launch.mesh.stage_ranks`, `make_stage_mesh`),
    with the reference's stage policy (`sharding.stage_policy`): a stage's
    TP degree is computed by that many ranks, and the uneven TP a fail-stop
    leaves runs as planned. Every rank holds the whole fp32 master, as the
    reference's controller does, and takes its block of each stage leaf as
    a DTensor with no communication (on a one-rank mesh the leaf shares the
    master's storage). Every rank walks the same global order of events; a
    rank computes an event only where it is in the executing stage's mesh,
    and a rank in no stage still walks the order and joins the collectives;
  * without one, each stage runs whole on the first device of its group
    (`launch.mesh.stage_devices`) with no policy: the unsharded engine.

Key properties, as the reference's:
  * stage boundaries move activations (at F) and their gradients (at B)
    onto the executing stage of the next event that reads them. Under a
    process group by Fig. 7's scatter/gather (`core.scheduler.p2p`): the
    tensor is cut into N = max(tp_src, tp_dst) chunks along d_model, chunk
    c goes once (`dist.isend` / `dist.recv`) from source rank
    c·tp_src//N to destination rank c·tp_dst//N, and the destination stage
    all-gathers them over its `model` axis into a replicated DTensor; a
    destination rank that is in both stages holds the whole tensor and
    receives nothing, and where every destination rank does, nothing
    moves. `hand_offs` keeps each hand-off's bytes this rank sent in the
    last iteration. Unsharded, `Tensor.to` (a no-op on one card);
  * F runs the stage under `torch.no_grad()` (the forward kernel without its
    row log-sum-exp); B recomputes the stage forward under autograd and runs
    its backward (the forward kernel with the log-sum-exp, then the backward
    kernel) — activation recomputation, as the reference's `jax.vjp`: only
    boundary activations are stored;
  * the last stage's loss reads the labels of its logits through
    `model._label_logits`, on vocab-sharded logits too; the global
    (nll, tokens) is one all-reduce over the world, to which the (0, 0)
    rank of each executing last stage contributes;
  * gradients accumulate per executing stage in `grad_acc`: B points each
    stage leaf's `.grad` at that stage's buffer, so autograd adds each
    leaf's gradient into it as soon as it is formed, and takes the buffers
    back after it; a stage's gradient never exists twice;
  * with tied embeddings the last stage reads `embed` too, and the update
    sums the first and last stages' gradients of it;
  * the DP reduce sums the stages' gradients in replica order, scales by
    1 / total tokens and updates: exact averaging over every token of every
    replica. Under a process group each stage's gradients are first made
    whole on its ranks (`full_tensor`), each rank sums in replica order the
    stages whose (0, 0) rank it is, and one all-reduce over the world of a
    flat buffer gives every rank the same sum; every rank then updates its
    own full master, so the replicas stay equal bit for bit. Every sum of
    two gradient lists checks that they pair the same leaves (count and
    shapes) and raises otherwise, as the reference's `jax.tree.map` does;
    replica 0's layer partition is read for every replica, as the
    reference's `_apply_grads` reads it;
  * micro-batch migration executes a chunk on a peer replica's stage (the
    same math, since replicas are synchronized — Fig. 6b); under a process
    group the chunk's activation and gradient cross to the peer's ranks. A
    chunk placed on a stage with other layers is refused before any event,
    where the reference's accumulation refuses it.

There is no gradient clipping, as in the reference's engine.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.p2p import chunk_slices, p2p_mapping
from repro_torch.core.scheduler.plan import ParallelPlan
from repro_torch.engine.schedules import make_schedule
from repro_torch.launch.mesh import (
    canonical,
    default_devices,
    make_stage_mesh,
    stage_devices,
    stage_ranks,
)
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import (
    _label_logits,
    apply_layer,
    embed_tokens,
    init_params,
    lm_logits,
    param_axes,
)
from repro_torch.parallel.sharding import (
    NULL_POLICY,
    arange_rows_like,
    mesh_block,
    stage_policy,
    tree_map_axes,
)
from repro_torch.train.optimizer import tree_leaves, tree_map


def _mb_loss(policy, logits, labels):
    """-> (nll_sum, n_tokens): summed so the host can form the exact global
    token-weighted mean across micro-batches and replicas. Under a mesh the
    logits' rows are made whole (vocab gathered over tp) before the label
    gather, as `model.loss_fn` makes them."""
    mask = (labels >= 0).float()
    labels_c = labels.clamp_min(0).long()
    logits = policy.constrain(logits.float(), "batch", "seq", None)
    lse = torch.logsumexp(logits, dim=-1)
    nll = (lse - _label_logits(policy, logits, labels_c)) * mask
    return nll.sum(), mask.sum()


def _sorted(tree):
    """`tree` with every dict's keys in sorted order, JAX's order, in which a
    restored checkpoint and a converted JAX optimizer state list their
    leaves: the optimizer zips parameters, gradients and state leaf by leaf."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def _like(tree, leaves):
    """`leaves` (in `tree_leaves` order) in the structure of `tree`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def zip_leaves(a, b, what):
    """zip of two leaf lists that must pair the same leaves: raises unless
    they hold as many leaves, of the same shapes in the same order."""
    if len(a) != len(b):
        raise ValueError(f"{what}: {len(a)} leaves against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape:
            raise ValueError(f"{what}: leaf {i} has shape {tuple(x.shape)} against "
                             f"{tuple(y.shape)}")
    return zip(a, b)


def stage_part(cfg, plan, tree, r, s):
    """The part of `tree` (in the master's structure: the parameters, or
    their logical axes) that stage s of replica r holds: its layers, the
    embedding on the first stage (and on the last with tied embeddings: the
    LM head reads it), the final norm and the LM head on the last."""
    part = {"layers": [tree["layers"][l] for l in plan.replicas[r].stages[s].layers]}
    last = s == plan.replicas[r].pp - 1
    if s == 0 or (last and cfg.tie_embeddings):
        part["embed"] = tree["embed"]
    if last:
        part["final_norm"] = tree["final_norm"]
        if "lm_head" in tree:
            part["lm_head"] = tree["lm_head"]
    return part


def _replicated(mesh, t):
    """t, whole on this rank, as a DTensor replicated over `mesh` (no
    communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def boundary_routes(tp_src, tp_dst, width):
    """[(source index, destination index, slice of the last dim)]: Fig. 7's
    symmetric mapping of a boundary tensor of `width` columns between stage
    groups of tp_src and tp_dst ranks, each chunk once; None for a pair the
    rule does not cover (N = max(tp_src, tp_dst) not a multiple of both
    degrees, or `width` not a multiple of N: degrees outside Eq. 3's powers
    of two), which the hand-off moves whole."""
    n = max(tp_src, tp_dst)
    if n % tp_src or n % tp_dst or width % n:
        return None
    cuts = chunk_slices(width, tp_src, tp_dst)
    return [(a, b, cuts[c]) for a, b, c in p2p_mapping(tp_src, tp_dst)]


def _block(policy, axes, master):
    """This rank's block of the master leaf as a DTensor leaf placed by the
    policy, taken with no communication: a view of the master where the
    block is contiguous (the whole leaf on a one-rank mesh)."""
    from torch.distributed.tensor import DTensor, Shard

    placements = policy.placements_for(axes, tuple(master.shape))
    local = master.detach()
    for dim in range(master.dim()):
        split = [i for i, pl in enumerate(placements) if pl == Shard(dim)]
        if split:
            n, block = mesh_block(policy.mesh, split)
            size = master.shape[dim] // n
            local = local.narrow(dim, block * size, size)
    return DTensor.from_local(local.contiguous(), policy.mesh, placements,
                              run_check=False).requires_grad_(True)


class PipelineEngine:
    """Executes one ParallelPlan with real per-stage computation.

    `params` (optional) are the fp32 master weights to start from, in the
    port's layout (`bridge.params_from_jax` carries the JAX engine's); else
    they are drawn from `seed`. `compute_dtype` is the stages' compute type
    (bf16, as the reference; the parity tests pass float32). Under an
    initialised default process group each stage runs on its own mesh of the
    world's ranks; `devices` is then this rank's device (the current card
    under NCCL, else the CPU, by default), and every rank of the world must
    build the engine and run each iteration on the same batch."""

    def __init__(self, cfg, plan: ParallelPlan, *, optimizer=None, seed=0, devices=None,
                 params=None, compute_dtype=torch.bfloat16):
        import torch.distributed as dist

        self.cfg = cfg
        self.optimizer = optimizer
        self.spmd = dist.is_available() and dist.is_initialized()
        if self.spmd:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            home = (canonical(devices[0]) if devices else canonical("cuda")
                    if dist.get_backend() == "nccl" else torch.device("cpu"))
            self.devices = [home]
        else:
            self.devices = [canonical(d) for d in devices] if devices else default_devices()
            home = self.devices[0]
        self.compute_dtype = compute_dtype
        if params is None:
            params = init_params(cfg, seed, dtype=torch.float32, device=home)
        # full list-layout params (fp32 master), shared by every replica
        self.params_full = _sorted(tree_map(lambda v: v.detach().to(home).requires_grad_(True),
                                            params))
        self.axes_full = param_axes(cfg)
        self.opt_state = optimizer.init(self.params_full) if optimizer else None
        self.step = 0
        self.plan = None
        self.meshes: dict = {}
        self.ranks: dict = {}
        self.policies: dict = {}
        self.made_meshes: dict = {}  # stage meshes by their ranks, kept across plans
        self.hand_offs: list = []  # the last iteration's (src, dst, bytes this rank sent)
        self.apply_plan(plan)

    # ----------------------------------------------------------- plan mgmt
    def apply_plan(self, plan: ParallelPlan):
        """(Re)build the per-stage meshes (device groups without a process
        group) and policies for a plan — the analogue of 'destroy and rebuild
        communication groups'. Under a process group every rank makes every
        stage's mesh in plan order; a stage over the ranks of a mesh made
        before, for this plan or an earlier one, takes that mesh (no new
        group)."""
        self.plan = plan
        self.meshes, self.ranks, self.policies = {}, {}, {}
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                if not st.devices:
                    continue
                if self.spmd:
                    ranks = stage_ranks(st.devices, self.world)
                    if ranks not in self.made_meshes:
                        self.made_meshes[ranks] = make_stage_mesh(ranks, 1, len(ranks))
                    mesh = self.made_meshes[ranks]
                    self.ranks[(r, s)] = ranks
                    self.policies[(r, s)] = stage_policy(mesh, self.cfg)
                else:
                    mesh = stage_devices(self.devices[d % len(self.devices)] for d in st.devices)
                    self.policies[(r, s)] = NULL_POLICY
                self.meshes[(r, s)] = mesh

    def _live(self, r, s):
        if (r, s) not in self.meshes:
            raise RuntimeError(
                f"stage (dp{r},pp{s}) has no devices in plan {self.plan.summary()}: a dead "
                "stage cannot run (recover its state and adapt the plan first)")

    def stage_device(self, r: int, s: int) -> torch.device:
        """The device stage (r, s) computes on here: the first of its group,
        or, under a process group, this rank's."""
        self._live(r, s)
        return self.devices[0] if self.spmd else self.meshes[(r, s)][0]

    def member(self, r: int, s: int) -> bool:
        """Whether this rank computes stage (r, s) (always, without a process
        group)."""
        self._live(r, s)
        return not self.spmd or self.rank in self.ranks[(r, s)]

    def leads(self, r: int, s: int) -> bool:
        """Whether this rank is stage (r, s)'s (0, 0) rank, the one that
        contributes its loss and gradients to the world's sums."""
        return not self.spmd or self.rank == self.ranks[(r, s)][0]

    def stage_params(self, r: int, s: int):
        """Stage layer params + (first/last extras). Without a process group
        the master's tensors placed on the stage's device (the same tensors
        where they already live there); under one, DTensor leaves on the
        stage's mesh placed by its policy (`_block`), or None on a rank
        outside the stage."""
        if not self.member(r, s):
            return None
        part = stage_part(self.cfg, self.plan, self.params_full, r, s)
        if self.spmd:
            axes = stage_part(self.cfg, self.plan, self.axes_full, r, s)
            pol = self.policies[(r, s)]
            return tree_map_axes(lambda ax, v: _block(pol, ax, v), axes, part)
        dev = self.stage_device(r, s)
        return tree_map(lambda v: v if v.device == dev else v.detach().to(dev).requires_grad_(True),
                        part)

    # ----------------------------------------------------- stage functions
    def _inputs(self, key, mb):
        """The micro-batch as stage `key` reads it: (md, tokens, labels),
        replicated DTensors on its mesh under a process group."""
        if self.spmd:
            mb = {k: _replicated(self.meshes[key], v) for k, v in mb.items()}
        seg = mb["segment_ids"]
        md = {"segment_ids": seg, "positions": mb["positions"],
              "abs_positions": arange_rows_like(seg), "causal": True}
        return md, mb["tokens"], mb["labels"]

    def _replicating(self):
        """Under a process group, the model's own plain tensors (position
        rows, masks) count as replicated, as in the sharded train step."""
        if not self.spmd:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def _stage_apply(self, key, p, x, md, tokens, labels):
        cfg, pol = self.cfg, self.policies[key]
        r, s = key
        if s == 0:
            x = embed_tokens(cfg, p, tokens, self.compute_dtype, pol)
        for i, l in enumerate(self.plan.replicas[r].stages[s].layers):
            x, _ = apply_layer(cfg, cfg.layer_spec(l), p["layers"][i], x, md, policy=pol)
        if s == self.plan.replicas[r].pp - 1:
            x = rms_norm(x, p["final_norm"], cfg.norm_eps)
            return _mb_loss(pol, lm_logits(cfg, p, x, pol), labels)
        return x

    def _fwd(self, key, p, x, mb):
        with torch.no_grad(), self._replicating():
            out = self._stage_apply(key, p, x, *self._inputs(key, mb))
        if isinstance(out, tuple) and self.spmd:  # the last stage's (nll_sum, n_tokens)
            out = tuple(o.full_tensor() for o in out)
        return out

    def _bwd(self, key, p, x, mb, g, acc):
        """Recompute the stage under autograd and add its parameter gradients
        into `acc` (a gradient tree of the stage's structure, or None for a
        new one) in place; -> (the gradient tree, grad of the boundary input
        (replicated under a process group) or None for stage 0). `g` is the
        gradient of the stage's output, None on the last stage (its nll sum,
        whose gradient is 1). The leaves' `.grad` are the tree's buffers
        only while the backward runs: unsharded, replicas share the leaves."""
        leaves = tree_leaves(p)
        bufs = ([b for _, b in zip_leaves(leaves, tree_leaves(acc), "gradient accumulation")]
                if acc is not None else [None] * len(leaves))
        for leaf, buf in zip(leaves, bufs):
            leaf.grad = buf
        try:
            with torch.enable_grad(), self._replicating():
                if x is not None:
                    x = x.detach().requires_grad_(True)
                out = self._stage_apply(key, p, x, *self._inputs(key, mb))
                if isinstance(out, tuple):  # last stage: (nll_sum, n_tokens); n_tokens is constant
                    out = out[0]
                torch.autograd.backward(out, grad_tensors=g,
                                        inputs=leaves + ([x] if x is not None else []))
            grads = [leaf.grad for leaf in leaves]
        finally:
            for leaf in leaves:
                leaf.grad = None
        if any(gr is None for gr in grads):
            raise RuntimeError(f"stage (dp{key[0]},pp{key[1]}): a parameter got no gradient")
        x_grad = None if x is None else x.grad
        if x_grad is not None and self.spmd:
            x_grad = _replicated(self.meshes[key], x_grad.full_tensor())
        return _like(p, grads), x_grad

    # ------------------------------------------------------------ transfer
    def _hand_off(self, t, src, dst, like, sends):
        """Move the boundary tensor t from stage src's executor to stage
        dst's -> the tensor there (None on a rank outside dst); every rank
        calls this at the same event. Under a process group by Fig. 7's
        rule (`boundary_routes`): each chunk goes once, from its source
        rank to its destination rank, unless that rank is in src and holds
        the whole tensor already; then, where some destination rank is not
        in src, the destination stage all-gathers its chunks over its
        `model` axis. A pair of degrees the rule does not cover goes whole:
        destination rank j receives the tensor from source rank j % tp_src.
        Which rank sends, receives and gathers follows from the plan alone.
        `like` is (shape, dtype) of the tensor; each send's handle joins
        `sends`, and its bytes this hand-off's entry of `hand_offs`."""
        if not self.spmd:
            return t.to(self.stage_device(*dst))
        import torch.distributed as dist

        self._live(*src)
        self._live(*dst)
        src_ranks, dst_ranks = self.ranks[src], self.ranks[dst]
        shape, dtype = like
        routes = boundary_routes(len(src_ranks), len(dst_ranks), shape[-1])
        if routes is None:  # whole: destination j from source j % tp_src
            routes = [(j % len(src_ranks), j, slice(0, shape[-1])) for j in range(len(dst_ranks))]
        crossing = any(dst_ranks[b] not in src_ranks for _, b, _ in routes)
        sent, local = 0, None
        if self.rank in src_ranks:
            local = t.full_tensor().contiguous()
            if (tuple(local.shape), local.dtype) != like:
                raise RuntimeError(f"stage (dp{src[0]},pp{src[1]}) hands over "
                                   f"{tuple(local.shape)} {local.dtype}, expected {like}")
            me = src_ranks.index(self.rank)
            for a, b, cut in routes:
                if a == me and dst_ranks[b] not in src_ranks:
                    chunk = local[..., cut].contiguous()
                    sends.append((dist.isend(chunk, dst_ranks[b]), chunk))
                    sent += chunk.numel() * chunk.element_size()
        self.hand_offs.append((src, dst, sent))
        if self.rank not in dst_ranks:
            return None
        mesh = self.meshes[dst]
        if not crossing:  # every destination rank holds the whole tensor
            return _replicated(mesh, local)
        j = dst_ranks.index(self.rank)
        mine = [(a, cut) for a, b, cut in routes if b == j]
        if local is not None:
            block = local[..., mine[0][1].start: mine[-1][1].stop]
        else:
            parts = []
            for a, cut in mine:
                part = torch.empty(shape[:-1] + (cut.stop - cut.start,), dtype=dtype,
                                   device=self.devices[0])
                dist.recv(part, src_ranks[a])
                parts.append(part)
            block = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        if block.shape[-1] == shape[-1]:  # the whole tensor: nothing to gather
            return _replicated(mesh, block)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        split = DTensor.from_local(block.contiguous(), mesh, [Replicate(), Shard(len(shape) - 1)],
                                   run_check=False)
        return split.redistribute(mesh, [Replicate()] * mesh.ndim)

    def _take(self, store, key, dst, like, sends):
        """store[key] = (holder stage, tensor), moved onto stage dst's
        executor where it is held elsewhere -> the tensor there."""
        holder, t = store[key]
        if holder != dst:
            t = self._hand_off(t, holder, dst, like, sends)
            store[key] = (dst, t)
        return t

    # -------------------------------------------------------- interpreter
    def run_iteration(self, batch, *, placement: Optional[dict] = None):
        """One training iteration: interpret the schedule's instruction
        streams per (replica, stage). Returns (mean_loss, grad_acc), the
        same loss on every rank.

        placement: optional {ChunkId -> (replica, stage)} micro-batch
        migration overrides from the Scheduler (Fig. 6b). `grad_acc` holds
        each executing stage's accumulated gradient (this rank's stages
        under a process group); with an optimizer, after the update, its
        first replica's entries hold the reduced, scaled gradient (under a
        process group on every rank, and only those).
        """
        plan = self.plan
        placement = placement or {}
        for cid, ex in placement.items():  # a chunk runs only where its own layers are
            own = plan.replicas[cid.replica].stages[cid.stage]
            there = plan.replicas[ex[0]].stages[ex[1]]
            if own.layers != there.layers:
                raise ValueError(
                    f"gradient accumulation: {cid.kind} of mb {cid.mb} of stage "
                    f"(dp{cid.replica},pp{cid.stage}) (layers {own.layers}) placed on stage "
                    f"(dp{ex[0]},pp{ex[1]}) (layers {there.layers})")
        dp, pp, n_mb = plan.dp, plan.replicas[0].pp, plan.microbatches
        B, S = batch["tokens"].shape[:2]
        if B % (dp * n_mb):
            raise ValueError(f"batch {B} does not split into {dp} replicas x {n_mb} micro-batches")
        mb_size = B // (dp * n_mb)
        like = ((mb_size, S, self.cfg.d_model), self.compute_dtype)  # a boundary tensor

        def mb_slice(r, m):
            lo = (r * n_mb + m) * mb_size
            return {k: batch[k][lo: lo + mb_size]
                    for k in ("tokens", "segment_ids", "positions", "labels")}

        params = {}
        for r in range(dp):
            for s in range(pp):
                params[(r, s)] = self.stage_params(r, s)

        acts: dict = {}  # (r, m, s) -> (holder stage, boundary activation into stage s)
        grads_in: dict = {}  # (r, m, s) -> (holder stage, gradient into stage s's output)
        losses = []  # (nll_sum, n_tokens) this rank contributes
        grad_acc: dict = {}
        sends: list = []
        self.hand_offs = []

        schedules = {}
        for r in range(dp):
            schedules.update(make_schedule(plan.schedule, pp, n_mb, replica=r))

        # topological interpretation: round-robin over executors, running the
        # head instruction when its inputs are available (host = orchestrator);
        # under a process group every rank walks this same order
        queues = {e: list(order) for e, order in schedules.items()}
        progress = True
        while any(queues.values()):
            if not progress:
                raise RuntimeError("pipeline interpreter deadlock")
            progress = False
            for q in queues.values():
                if not q:
                    continue
                cid = q[0]
                r, s, m = cid.replica, cid.stage, cid.mb
                ex = placement.get(cid, (r, s))
                if cid.kind == "F":
                    if s > 0 and (r, m, s) not in acts:
                        continue
                    x = self._take(acts, (r, m, s), ex, like, sends) if s > 0 else None
                    out = self._fwd(ex, params[ex], x, mb_slice(r, m)) if self.member(*ex) else None
                    if s == pp - 1:
                        if out is not None and self.leads(*ex):
                            losses.append(out)
                        grads_in[(r, m, s)] = (ex, None)
                    else:  # SendAct -> RecvAct, onto the next stage's executor
                        nxt = placement.get(ChunkId("F", m, s + 1, r), (r, s + 1))
                        acts[(r, m, s + 1)] = (nxt, self._hand_off(out, ex, nxt, like, sends))
                elif cid.kind == "B":
                    if (r, m, s) not in grads_in:
                        continue
                    g = self._take(grads_in, (r, m, s), ex, like, sends) if s < pp - 1 else None
                    x = self._take(acts, (r, m, s), ex, like, sends) if s > 0 else None
                    del grads_in[(r, m, s)]
                    acts.pop((r, m, s), None)
                    x_grad = None
                    if self.member(*ex):
                        grad_acc[ex], x_grad = self._bwd(ex, params[ex], x, mb_slice(r, m), g,
                                                         grad_acc.get(ex))
                    if s > 0:  # onto the executor of the previous stage's B
                        prv = placement.get(ChunkId("B", m, s - 1, r), (r, s - 1))
                        grads_in[(r, m, s - 1)] = (prv, self._hand_off(x_grad, ex, prv, like,
                                                                       sends))
                # W chunks: weight grads were folded into B here
                q.pop(0)
                progress = True

        for work, _ in sends:
            work.wait()
        nll_total = sum(float(l[0]) for l in losses)
        ntok_total = sum(float(l[1]) for l in losses)
        if self.spmd:  # the world's sums; every rank gets the same
            import torch.distributed as dist

            sums = torch.tensor([nll_total, ntok_total], dtype=torch.float64,
                                device=self.devices[0])
            dist.all_reduce(sums)
            nll_total, ntok_total = sums.tolist()
        loss = nll_total / max(ntok_total, 1.0)
        if self.optimizer is not None:
            grad_acc = self._apply_grads(grad_acc, ntok_total)
        return float(loss), grad_acc

    # ------------------------------------------------------------- update
    def _apply_grads(self, grad_acc, total_tokens):
        """DP-reduce per-stage grads (`_local_reduce`, or `_world_reduce`
        under a process group), scale them, scatter them into the full tree
        (a tied embed's gradient is the sum of the first and last stages'),
        update. -> grad_acc with its first replica's entries the reduced,
        scaled gradient."""
        plan = self.plan
        pp = plan.replicas[0].pp
        scale = 1.0 / max(total_tokens, 1.0)
        reduced = self._world_reduce(grad_acc) if self.spmd else self._local_reduce(grad_acc)
        full = {k: None for k in self.params_full}
        full["layers"] = [None] * len(self.params_full["layers"])
        for s in range(pp):
            red = reduced.get(s)
            if red is None:
                continue
            for a in tree_leaves(red):
                a.mul_(scale)
            for i, l in enumerate(plan.replicas[0].stages[s].layers):
                full["layers"][l] = red["layers"][i]
            for k in ("embed", "final_norm", "lm_head"):
                if k in red:
                    full[k] = red[k] if full[k] is None else full[k].add_(red[k])
        self.optimizer.update(_fill(full, self.params_full), self.opt_state, self.params_full,
                              torch.tensor(self.step, dtype=torch.int32))
        self.step += 1
        grad_acc.update({(0, s): red for s, red in reduced.items()})
        return grad_acc

    def _local_reduce(self, grad_acc):
        """{stage: the sum over replicas of its gradients in grad_acc whose
        stage this rank leads (all, without a process group), in replica
        order, in place in the first one's buffers}."""
        plan = self.plan
        reduced = {}
        for s in range(plan.replicas[0].pp):
            for r in range(plan.dp):
                g = grad_acc.get((r, s))
                if g is None or not self.leads(r, s):
                    continue
                if s not in reduced:
                    reduced[s] = g
                    continue
                for a, b in zip_leaves(tree_leaves(reduced[s]), tree_leaves(g),
                                       f"DP reduce of stage {s}"):
                    a.add_(b.to(a.device))
        return reduced

    def _world_reduce(self, grad_acc):
        """{stage: the sum over replicas of its gradients}, the same on every
        rank, emptying grad_acc: each stage's gradients made whole on its
        ranks (collectives inside its mesh, in plan order), this rank's
        `_local_reduce` of them, then one all-reduce over the world of a
        flat buffer in replica 0's layout."""
        import torch.distributed as dist

        plan = self.plan
        pp = plan.replicas[0].pp
        whole = {}
        for key in sorted(grad_acc):
            whole[key] = tree_map(lambda g: g.full_tensor(), grad_acc.pop(key))
        part = self._local_reduce(whole)
        whole.clear()  # the summed-in and other ranks' gradients go before the flat buffer
        layout = {s: stage_part(self.cfg, plan, self.params_full, 0, s) for s in range(pp)}
        flat = torch.zeros(sum(v.numel() for s in layout for v in tree_leaves(layout[s])),
                           dtype=torch.float32, device=self.devices[0])
        reduced, offset = {}, 0
        for s in range(pp):
            ref = tree_leaves(layout[s])
            mine = tree_leaves(part.pop(s)) if s in part else None
            if mine is not None:
                zip_leaves(mine, ref, f"DP reduce of stage {s}")
            views = []
            for i, v in enumerate(ref):
                view = flat[offset: offset + v.numel()].view(v.shape)
                offset += v.numel()
                if mine is not None:
                    view.copy_(mine[i])
                    mine[i] = None  # its buffer goes as soon as it is copied
                views.append(view)
            reduced[s] = _like(layout[s], views)
        dist.all_reduce(flat)
        return reduced


def _fill(grads, params):
    """Gradients in the parameters' structure and on their device, zeros
    where no stage gave one."""
    if isinstance(params, dict):
        return {k: _fill(grads.get(k) if grads is not None else None, v)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_fill(grads[i] if grads is not None else None, v)
                for i, v in enumerate(params)]
    return torch.zeros_like(params) if grads is None else grads.to(params.device)
