"""Optimizer-state and parameter recovery during reconfiguration (paper §7,
Fig. 8), counterpart of `repro.core.recovery`.

The planning half (`LayerMove`, `TransferPlan`, `layer_state_bytes`,
`transfer_plan`) is plain Python, copied from the reference. The moving half
places live state onto the new plan's devices with `Tensor.to`: on one card
every stage's device group is that card and the move is a no-op. Under a
process group (the pipeline driver on a world of ranks) every rank holds
the whole fp32 master and optimizer state on its own device, as the
reference's controller does, so the driver places it onto that device (no
leaf moves) and the engine's `apply_plan` onto the new stage meshes is the
live recovery: `transfer_plan`'s moves and bytes stay modelled. Only a
master sharded per stage would make them the point-to-point copies of
Fig. 7. The three Fig. 8 cases:

  (a) a DP replica lost, params DP-replicated -> survivors already hold the
      state; recovery places it onto the surviving devices (peer copy).
  (b) every replica of some stage lost -> no live source; fall back to the
      last committed checkpoint, loaded straight onto the new placement.
  (c) layer repartition / TP-degree change -> layers (params + optimizer
      state) move between stage groups; `transfer_plan` enumerates the
      per-layer source->dest copies and byte volumes (the Fig. 13
      layer-transfer overhead), and `reshard_live` performs the move for the
      in-process engine.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.scheduler.plan import ParallelPlan
from repro_torch.launch.mesh import canonical


@dataclass(frozen=True)
class LayerMove:
    layer: int
    src_replica: int  # surviving replica to copy from (-1 = checkpoint)
    src_stage: int
    dst_stage: int
    tp_from: int
    tp_to: int
    bytes: int


@dataclass
class TransferPlan:
    moves: list
    restore_required: bool = False

    @property
    def total_bytes(self) -> int:
        return sum(m.bytes for m in self.moves)

    def seconds(self, bw: float = 25e9) -> float:
        """Wall time estimate over the slow fabric (scatter/gather optimized:
        each byte crosses once — §7)."""
        return self.total_bytes / bw


def layer_state_bytes(cfg, *, opt_multiplier: float = 3.0, dtype_bytes: int = 4) -> list:
    """Approximate per-layer bytes of params + optimizer state."""
    from repro_torch.core.scheduler.repartition import costs_for_arch

    total_params = cfg.param_count() - 2 * cfg.padded_vocab * cfg.d_model
    rel = costs_for_arch(cfg)
    s = sum(rel)
    return [int(total_params * (r / s) * dtype_bytes * opt_multiplier) for r in rel]


def transfer_plan(cfg, old_plan: ParallelPlan, new_plan: ParallelPlan,
                  *, dead_stages=()) -> TransferPlan:
    """Which layers must move (Fig. 8c), and from where (Fig. 8a/b)."""
    dead = set(dead_stages)
    per_layer_bytes = layer_state_bytes(cfg)
    moves, restore = [], False
    old_owner = {}  # layer -> stage (uniform across replicas)
    for s, st in enumerate(old_plan.replicas[0].stages):
        for l in st.layers:
            old_owner[l] = s
    for s, st in enumerate(new_plan.replicas[0].stages):
        for l in st.layers:
            src_stage = old_owner[l]
            tp_from = old_plan.replicas[0].stages[src_stage].tp
            tp_to = st.tp
            if src_stage == s and tp_from == tp_to:
                continue  # stays put
            # pick a surviving replica that still holds this stage's state
            src_replica = -1
            for r in range(old_plan.dp):
                if (r, src_stage) not in dead:
                    src_replica = r
                    break
            if src_replica < 0:
                restore = True
            moves.append(LayerMove(
                l, src_replica, src_stage, s, tp_from, tp_to,
                per_layer_bytes[l] if l < len(per_layer_bytes) else per_layer_bytes[-1],
            ))
    return TransferPlan(moves, restore_required=restore)


# ------------------------------------------------------------- torch side
def reshard_live(state, shardings):
    """Fig. 8a/c for the in-process engine: place live state onto the new
    plan's devices. `shardings` is a tree of `torch.device` (or None: the
    leaf stays where it is) of the state's structure, or one device for
    every leaf. A leaf already there is kept as it is."""
    def sub(key):
        return shardings[key] if isinstance(shardings, (dict, list, tuple)) else shardings

    if isinstance(state, dict):
        return {k: reshard_live(v, sub(k)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(reshard_live(v, sub(i)) for i, v in enumerate(state))
    if isinstance(state, torch.Tensor) and shardings is not None:
        dev = canonical(shardings)
        if state.device != dev:
            return state.detach().to(dev).requires_grad_(state.requires_grad)
    return state


def recover_state(cfg, state, *, old_plan, new_plan, shardings, checkpoint_mgr=None,
                  dead_stages=()):
    """Full Fig. 8 flow. Returns (state, TransferPlan, restored_from_step).

    Live recovery when any replica survives per stage; otherwise restores the
    last committed checkpoint onto the new placement.
    """
    tp = transfer_plan(cfg, old_plan, new_plan, dead_stages=dead_stages)
    if tp.restore_required:
        if checkpoint_mgr is None or not checkpoint_mgr.has_checkpoint():
            raise RuntimeError(
                "all replicas of a stage failed and no checkpoint exists "
                "(Fig. 8b requires persistent state)"
            )
        state, step, _ = checkpoint_mgr.restore_latest(target=state, shardings=shardings)
        return state, tp, step
    return reshard_live(state, shardings), tp, None
