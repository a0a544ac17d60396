"""Host-orchestrated pipeline-parallel engine (paper §7's runtime), counterpart
of `repro.engine.pipeline`.

The Scheduler emits per-stage instruction streams (Forward / Backward /
SendAct / RecvAct / reduce); a lightweight interpreter executes them against
per-stage device groups. This is the engine that runs ParallelPlans end to
end: kill a device, the Scheduler re-plans, recovery moves the state,
training resumes.

Key properties, as the reference's:
  * per-stage device groups over explicit device sets (`launch.mesh`); a
    stage runs whole on the first device of its group, so on one card TP is
    emulated, as in the reference on fewer devices than its plan;
  * stage boundaries move activations and their gradients with `Tensor.to`
    (a no-op on one card);
  * F runs the stage under `torch.no_grad()` (the forward kernel without its
    row log-sum-exp); B recomputes the stage forward under autograd and takes
    the gradients of the stage parameters and the boundary input with
    `torch.autograd.grad` (the forward kernel with the log-sum-exp, then the
    backward kernel) — activation recomputation, as the reference's
    `jax.vjp`: only boundary activations are stored;
  * replicas read the same parameter tensors (they are synchronized), and
    gradients accumulate per (replica, stage) in `grad_acc`;
  * the DP reduce sums the replicas' gradients in replica order on the
    device, into the first replica's buffers, scales by 1 / total tokens and
    updates: exact averaging over every token of every replica;
  * micro-batch migration executes a chunk on a peer replica's stage (the
    same math, since replicas are synchronized — Fig. 6b).

There is no gradient clipping, as in the reference's engine.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.plan import ParallelPlan
from repro_torch.engine.schedules import make_schedule
from repro_torch.launch.mesh import canonical, default_devices, make_stage_mesh
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import apply_layer, embed_tokens, init_params, lm_logits
from repro_torch.train.optimizer import tree_leaves, tree_map


def _mb_loss(cfg, logits, labels):
    """-> (nll_sum, n_tokens): summed so the host can form the exact global
    token-weighted mean across micro-batches and replicas."""
    mask = (labels >= 0).float()
    labels_c = labels.clamp_min(0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels_c[..., None])[..., 0]
    nll = (lse - ll) * mask
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


class PipelineEngine:
    """Executes one ParallelPlan with real per-stage computation.

    `params` (optional) are the fp32 master weights to start from, in the
    port's layout (`bridge.params_from_jax` carries the JAX engine's); else
    they are drawn from `seed`. `compute_dtype` is the stages' compute type
    (bf16, as the reference; the parity tests pass float32)."""

    def __init__(self, cfg, plan: ParallelPlan, *, optimizer=None, seed=0, devices=None,
                 params=None, compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.optimizer = optimizer
        self.devices = [canonical(d) for d in devices] if devices else default_devices()
        self.compute_dtype = compute_dtype
        home = self.devices[0]
        if params is None:
            params = init_params(cfg, seed, dtype=torch.float32, device=home)
        # full list-layout params (fp32 master), shared by every replica
        self.params_full = _sorted(tree_map(lambda v: v.detach().to(home).requires_grad_(True),
                                            params))
        self.opt_state = optimizer.init(self.params_full) if optimizer else None
        self.step = 0
        self.plan = None
        self.meshes: dict = {}
        self.apply_plan(plan)

    # ----------------------------------------------------------- plan mgmt
    def _mesh_for(self, stage_plan):
        devs = [self.devices[d % len(self.devices)] for d in stage_plan.devices]
        return make_stage_mesh(devs, 1, len(devs))

    def apply_plan(self, plan: ParallelPlan):
        """(Re)build the per-stage device groups for a plan — the analogue of
        'destroy and rebuild communication groups'."""
        self.plan = plan
        self.meshes = {}
        for r, rep in enumerate(plan.replicas):
            for s, st in enumerate(rep.stages):
                if st.devices:
                    self.meshes[(r, s)] = self._mesh_for(st)

    def stage_device(self, r: int, s: int) -> torch.device:
        if (r, s) not in self.meshes:
            raise RuntimeError(
                f"stage (dp{r},pp{s}) has no devices in plan {self.plan.summary()}: a dead "
                "stage cannot run (recover its state and adapt the plan first)")
        return self.meshes[(r, s)][0]

    def stage_params(self, r: int, s: int):
        """Stage layer params + (first/last extras), placed on the stage's
        device (the same tensors where they already live there)."""
        st = self.plan.replicas[r].stages[s]
        dev = self.stage_device(r, s)

        def place(v):
            return v if v.device == dev else v.detach().to(dev).requires_grad_(True)

        p = {"layers": [tree_map(place, self.params_full["layers"][l]) for l in st.layers]}
        if s == 0:
            p["embed"] = place(self.params_full["embed"])
        if s == self.plan.replicas[r].pp - 1:
            p["final_norm"] = place(self.params_full["final_norm"])
            if "lm_head" in self.params_full:
                p["lm_head"] = place(self.params_full["lm_head"])
        return p

    # ----------------------------------------------------- stage functions
    def _md(self, batch_mb):
        seg = batch_mb["segment_ids"]
        B, S = seg.shape
        return {
            "segment_ids": seg,
            "positions": batch_mb["positions"],
            "abs_positions": torch.arange(S, dtype=torch.int32, device=seg.device).repeat(B, 1),
            "causal": True,
        }

    def _stage_apply(self, r, s, p, x, md, *, tokens=None, labels=None):
        cfg = self.cfg
        st = self.plan.replicas[r].stages[s]
        if s == 0:
            x = embed_tokens(cfg, p, tokens, self.compute_dtype)
        for i, l in enumerate(st.layers):
            x, _ = apply_layer(cfg, cfg.layer_spec(l), p["layers"][i], x, md)
        if s == self.plan.replicas[r].pp - 1:
            x = rms_norm(x, p["final_norm"], cfg.norm_eps)
            return _mb_loss(cfg, lm_logits(cfg, p, x), labels)
        return x

    def _fwd(self, r, s, p, x, md, tokens=None, labels=None):
        with torch.no_grad():
            return self._stage_apply(r, s, p, x, md, tokens=tokens, labels=labels)

    def _bwd(self, r, s, p, x, md, g, tokens=None, labels=None):
        """Recompute the stage under autograd; -> (param grads tree, grad of
        the boundary input or None for stage 0)."""
        leaves = tree_leaves(p)
        with torch.enable_grad():
            if x is not None:
                x = x.detach().requires_grad_(True)
            out = self._stage_apply(r, s, p, x, md, tokens=tokens, labels=labels)
            if isinstance(out, tuple):  # last stage: (nll_sum, n_tokens); n_tokens is constant
                out, g = out[0], g[0]
            grads = torch.autograd.grad(out, leaves + ([x] if x is not None else []),
                                        grad_outputs=g)
        return _like(p, grads[:len(leaves)]), (grads[-1] if x is not None else None)

    # -------------------------------------------------------- interpreter
    def run_iteration(self, batch, *, placement: Optional[dict] = None):
        """One training iteration: interpret the schedule's instruction
        streams per (replica, stage). Returns (mean_loss, grad_acc).

        placement: optional {ChunkId -> (replica, stage)} micro-batch
        migration overrides from the Scheduler (Fig. 6b). With an optimizer,
        the first replica's entries of `grad_acc` hold the reduced, scaled
        gradient after the update.
        """
        plan = self.plan
        placement = placement or {}
        dp, pp, n_mb = plan.dp, plan.replicas[0].pp, plan.microbatches
        B = batch["tokens"].shape[0]
        if B % (dp * n_mb):
            raise ValueError(f"batch {B} does not split into {dp} replicas x {n_mb} micro-batches")
        mb_size = B // (dp * n_mb)

        def mb_slice(r, m):
            lo = (r * n_mb + m) * mb_size
            return {k: v[lo: lo + mb_size] for k, v in batch.items()}

        params = {}
        for r in range(dp):
            for s in range(pp):
                params[(r, s)] = self.stage_params(r, s)

        acts: dict = {}  # (r, m, s) -> boundary activation into stage s
        grads_in: dict = {}  # (r, m, s) -> gradient flowing into stage s's output
        losses = []
        grad_acc: dict = {}

        schedules = {}
        for r in range(dp):
            schedules.update(make_schedule(plan.schedule, pp, n_mb, replica=r))

        # topological interpretation: round-robin over executors, running the
        # head instruction when its inputs are available (host = orchestrator)
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
                exec_rs = placement.get(cid, (r, s))
                mb = mb_slice(r, m)
                md = self._md(mb)
                if cid.kind == "F":
                    if s > 0 and (r, m, s) not in acts:
                        continue
                    out = self._fwd(exec_rs[0], s, params[exec_rs], acts.get((r, m, s)), md,
                                    tokens=mb["tokens"] if s == 0 else None,
                                    labels=mb["labels"] if s == pp - 1 else None)
                    if s == pp - 1:
                        losses.append(out)  # (nll_sum, n_tokens)
                        grads_in[(r, m, s)] = (torch.ones((), device=out[0].device), None)
                    else:  # SendAct -> RecvAct, onto the next stage's executor
                        nxt = placement.get(ChunkId("F", m, s + 1, r), (r, s + 1))
                        acts[(r, m, s + 1)] = out.to(self.stage_device(*nxt))
                elif cid.kind == "B":
                    if (r, m, s) not in grads_in:
                        continue
                    p_grad, x_grad = self._bwd(
                        exec_rs[0], s, params[exec_rs], acts.get((r, m, s)), md,
                        grads_in.pop((r, m, s)),
                        tokens=mb["tokens"] if s == 0 else None,
                        labels=mb["labels"] if s == pp - 1 else None)
                    key = (r, s)
                    if key not in grad_acc:
                        grad_acc[key] = p_grad
                    else:
                        for a, b in zip(tree_leaves(grad_acc[key]), tree_leaves(p_grad)):
                            a.add_(b.to(a.device))
                    if s > 0:
                        grads_in[(r, m, s - 1)] = x_grad.to(self.stage_device(r, s - 1))
                    acts.pop((r, m, s), None)
                # W chunks: weight grads were folded into B here
                q.pop(0)
                progress = True

        nll_total = sum(float(l[0]) for l in losses)
        ntok_total = sum(float(l[1]) for l in losses)
        loss = nll_total / max(ntok_total, 1.0)
        self._apply_grads(grad_acc, ntok_total)
        return float(loss), grad_acc

    # ------------------------------------------------------------- update
    def _apply_grads(self, grad_acc, total_tokens):
        """DP-reduce per-stage grads on the device, scatter into the full
        tree, update."""
        if self.optimizer is None:
            return
        plan = self.plan
        dp, pp = plan.dp, plan.replicas[0].pp
        scale = 1.0 / max(total_tokens, 1.0)
        full = {k: None for k in self.params_full}
        full["layers"] = [None] * len(self.params_full["layers"])
        for s in range(pp):
            st = plan.replicas[0].stages[s]
            reduced = None
            for r in range(dp):
                g = grad_acc.get((r, s))
                if g is None:
                    continue
                if reduced is None:
                    reduced = g
                else:
                    for a, b in zip(tree_leaves(reduced), tree_leaves(g)):
                        a.add_(b.to(a.device))
            if reduced is None:
                continue
            for a in tree_leaves(reduced):
                a.mul_(scale)
            for i, l in enumerate(st.layers):
                full["layers"][l] = reduced["layers"][i]
            for k in ("embed", "final_norm", "lm_head"):
                if k in reduced:
                    full[k] = reduced[k]
        full = _fill(full, self.params_full)
        self.optimizer.update(full, self.opt_state, self.params_full,
                              torch.tensor(self.step, dtype=torch.int32))
        self.step += 1


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
