"""The port's checkpoint and Fig. 8 recovery against the JAX package: the
reference's checkpoint cases on torch state, the planning half of recovery
against its original, checkpoints written by either package restored in the
other (the pipeline state {"params", "opt", "step"}), bf16 leaves, and the
spmd driver's restart determinism on the CPU."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore, save_checkpoint as j_save
from repro.configs import get_arch, reduced
from repro.core.recovery import transfer_plan as j_transfer_plan
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.scheduler import Scheduler as JScheduler
from repro.models.model import init_params as j_init_params
from repro.parallel.sharding import split_annotations
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.recovery import recover_state, reshard_live, transfer_plan
from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan, initial_plan
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.launch import train as t_launch
from repro_torch.train.optimizer import tree_leaves

from torch_helpers import n

CPU = torch.device("cpu")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g), "b": torch.zeros(8)},
        "opt": {"m": torch.ones((8, 8))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _assert_bitwise(a_tree, b_tree):
    a, b = _leaves(a_tree), _leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.uint8) if y.dtype == torch.bfloat16 else y)
        else:
            assert x == y


def test_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, s, 7)
    r, step, extra = restore_checkpoint(tmp_path, target=s)
    assert step == 7 and extra == {}
    _assert_bitwise(s, r)
    r2, _, _ = restore_checkpoint(tmp_path)  # the port's own structure, no target
    _assert_bitwise(s, r2)


def test_atomic_commit_ignored_without_marker(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, s, 5)
    d = tmp_path / "step_000000010"  # a crash mid-save at step 10: no COMMIT
    d.mkdir()
    (d / "MANIFEST.json").write_text(json.dumps({"n_leaves": 0}))
    assert latest_step(tmp_path) == 5
    _, step, _ = restore_checkpoint(tmp_path, target=s)
    assert step == 5


def test_gc_keeps_last_k(tmp_path):
    s = _state()
    for step in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, step, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1].endswith("4")


def test_manager_interval(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=5)
    s = _state()
    assert mgr.maybe_save(s, 3) is None
    assert mgr.maybe_save(s, 5) is not None
    assert mgr.has_checkpoint()


def test_extra_payload(tmp_path):
    save_checkpoint(tmp_path, _state(), 1, extra={"data_cursor": 123})
    _, _, extra = restore_checkpoint(tmp_path, target=_state())
    assert extra["data_cursor"] == 123


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("crash_leaf", [0, 1, 2])
def test_crash_at_any_leaf_write_leaves_no_commit(tmp_path, monkeypatch, crash_leaf):
    s = _state()
    save_checkpoint(tmp_path, s, 5)
    calls = {"n": 0}
    real_save = np.save

    def dying_save(path, arr, *a, **kw):
        if calls["n"] == crash_leaf:
            raise _Boom(f"killed at leaf {crash_leaf}")
        calls["n"] += 1
        return real_save(path, arr, *a, **kw)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(_Boom):
        save_checkpoint(tmp_path, _state(seed=1), 10)
    monkeypatch.undo()
    assert not (tmp_path / "step_000000010").exists()
    assert not (tmp_path / "step_000000010.tmp" / "COMMIT").exists()
    assert latest_step(tmp_path) == 5
    r, step, _ = restore_checkpoint(tmp_path, target=s)
    assert step == 5
    _assert_bitwise(s, r)
    save_checkpoint(tmp_path, _state(seed=2), 10)  # the stale .tmp does not poison it
    assert latest_step(tmp_path) == 10


def test_crash_at_commit_marker_write(tmp_path, monkeypatch):
    s = _state()
    save_checkpoint(tmp_path, s, 5)
    real_write = Path.write_text

    def dying_write(self, text, *a, **kw):
        if self.name == "COMMIT":
            raise _Boom("killed at commit")
        return real_write(self, text, *a, **kw)

    monkeypatch.setattr(Path, "write_text", dying_write)
    with pytest.raises(_Boom):
        save_checkpoint(tmp_path, _state(seed=1), 10)
    monkeypatch.undo()
    assert (tmp_path / "step_000000010.tmp" / "MANIFEST.json").exists()
    assert not (tmp_path / "step_000000010").exists()
    assert latest_step(tmp_path) == 5
    _, step, _ = restore_checkpoint(tmp_path, target=s)
    assert step == 5


def test_gc_never_deletes_latest_committed(tmp_path):
    s = _state()
    for step in (1, 2, 3):
        save_checkpoint(tmp_path, s, step, keep=1)
        torn = tmp_path / f"step_{step + 100:09d}"
        torn.mkdir()
        (torn / "MANIFEST.json").write_text(json.dumps({"n_leaves": 0}))
        (tmp_path / f"step_{step + 200:09d}.tmp").mkdir()
        assert latest_step(tmp_path) == step
        _, got, _ = restore_checkpoint(tmp_path, target=s)
        assert got == step
    committed = [p.name for p in tmp_path.glob("step_*") if (p / "COMMIT").exists()]
    assert committed == ["step_000000003"]


def test_save_plan_a_restore_plan_b_bit_exact(tmp_path):
    """Saved from one placement, restored straight onto another: the
    placement follows the new tree, the bits do not change."""
    plan_a = {"params": {"w": CPU, "b": CPU}, "opt": {"m": None}, "step": None}
    plan_b = {"params": {"w": None, "b": CPU}, "opt": {"m": CPU}, "step": None}
    s = _state()
    save_checkpoint(tmp_path, reshard_live(s, plan_a), 7)
    r, step, _ = restore_checkpoint(tmp_path, target=s, shardings=plan_b)
    assert step == 7
    _assert_bitwise(s, r)
    assert r["opt"]["m"].device == CPU and r["params"]["b"].device == CPU


def test_restore_refuses_a_target_of_another_shape(tmp_path):
    save_checkpoint(tmp_path, _state(), 1)
    wrong = _state()
    wrong["params"]["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, target=wrong)


# -------------------------------------------------------------- Fig. 8
def _moves(tp):
    return [(m.layer, m.src_replica, m.src_stage, m.dst_stage, m.tp_from, m.tp_to, m.bytes)
            for m in tp.moves]


@pytest.mark.parametrize("n_layers,dp,pp,tp,dead", [(8, 2, 4, 2, 0), (8, 2, 4, 2, 5),
                                                    (4, 2, 2, 2, 5), (12, 2, 3, 2, 3)])
def test_transfer_plan_layer_moves(n_layers, dp, pp, tp, dead):
    """Moves, sources and bytes equal the reference's; every move has a
    live source replica."""
    cfg = reduced(get_arch("qwen3-8b"), n_layers=n_layers)
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=n_layers)
    old, jold = initial_plan(n_layers, dp, pp, tp), j_initial_plan(n_layers, dp, pp, tp)
    speeds = {d: 1.0 for d in old.devices}
    speeds[old.replicas[0].stages[1].devices[0]] = 0.0
    speeds[dead] = 0.0
    ad = Scheduler(layer_costs=[1.0] * n_layers).adapt(old, speeds)
    jad = JScheduler(layer_costs=[1.0] * n_layers).adapt(jold, speeds)
    got = transfer_plan(tcfg, old, ad.plan, dead_stages=ad.dead_stages)
    want = j_transfer_plan(cfg, jold, jad.plan, dead_stages=jad.dead_stages)
    assert _moves(got) == _moves(want) and got.restore_required == want.restore_required
    assert not got.restore_required and all(m.src_replica >= 0 for m in got.moves)
    assert got.total_bytes == want.total_bytes > 0 and got.seconds() == want.seconds()


def _stage0_lost(old):
    return ParallelPlan(tuple(
        ReplicaPlan((StagePlan(r.stages[0].devices, (0,)),
                     StagePlan(r.stages[1].devices, (1, 2, 3))))
        for r in old.replicas))


def test_transfer_plan_restore_required_when_no_source():
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=4)
    old = initial_plan(4, dp=2, pp=2, tp=1)
    tp = transfer_plan(tcfg, old, _stage0_lost(old), dead_stages=[(0, 0), (1, 0)])
    assert tp.restore_required and all(m.src_replica == -1 for m in tp.moves)


def test_recover_state_fig8b_checkpoint_fallback(tmp_path):
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=4)
    old = initial_plan(4, dp=2, pp=2, tp=1)
    new = _stage0_lost(old)
    state = _state()
    mgr = CheckpointManager(tmp_path, interval=1)
    with pytest.raises(RuntimeError):  # no checkpoint: training cannot continue
        recover_state(tcfg, state, old_plan=old, new_plan=new, shardings=CPU,
                      checkpoint_mgr=mgr, dead_stages=[(0, 0), (1, 0)])
    mgr.maybe_save(state, 1)
    live = _state(seed=9)  # what the dead stages held is gone: the checkpoint wins
    got, tp, step = recover_state(tcfg, live, old_plan=old, new_plan=new, shardings=CPU,
                                  checkpoint_mgr=mgr, dead_stages=[(0, 0), (1, 0)])
    assert step == 1 and tp.restore_required
    _assert_bitwise(state, got)


def test_recover_state_live_keeps_the_tensors():
    """Fig. 8a/c with a live source on one device: no copy, no checkpoint."""
    tcfg = t_reduced(t_get_arch("qwen3-8b"), n_layers=4)
    old = initial_plan(4, dp=2, pp=2, tp=2)
    speeds = {d: 1.0 for d in old.devices}
    speeds[5] = 0.0
    ad = Scheduler(layer_costs=[1.0] * 4).adapt(old, speeds, failed={5})
    state = _state()
    got, tp, step = recover_state(tcfg, state, old_plan=old, new_plan=ad.plan, shardings=CPU,
                                  dead_stages=ad.dead_stages)
    assert step is None and not tp.restore_required and tp.moves
    assert all(a is b for a, b in zip(_leaves(state), _leaves(got)))


# ------------------------------------------------- across the two packages
CFG = reduced(get_arch("qwen3-8b"), n_layers=4)


def _jax_pipeline_state():
    """The JAX engine's state: list-layout params, AdamW m and v (random, so
    that the comparison means something), and its Python-int step."""
    params, _ = split_annotations(j_init_params(jax.random.PRNGKey(0), CFG))
    opt = j_make_optimizer("adamw").init(params)
    rng = np.random.default_rng(0)
    opt = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), opt)
    return {"params": params, "opt": opt, "step": 3}


def _port_state(jstate):
    host = jax.tree.map(np.asarray, jstate)
    return {"params": params_from_jax(host["params"], dtype=torch.float32, device="cpu"),
            "opt": opt_state_from_jax(host["opt"], device="cpu"), "step": int(jstate["step"])}


def _assert_equal_across(port_tree, jax_tree):
    a, b = _leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert tuple(x.shape) == np.shape(y)
            np.testing.assert_array_equal(n(x), np.asarray(y))
        else:
            assert x == int(y)


def test_jax_writes_port_restores(tmp_path):
    jstate = _jax_pipeline_state()
    j_save(tmp_path, jstate, 3)
    target = _port_state(jax.tree.map(jnp.zeros_like, jstate) | {"step": 0})
    with pytest.raises(ValueError, match="target"):  # the JAX proto needs the target's structure
        restore_checkpoint(tmp_path)
    got, step, _ = restore_checkpoint(tmp_path, target=target, shardings=CPU)
    assert step == 3 and got["step"] == 3 and isinstance(got["step"], int)
    _assert_equal_across(got, jstate)
    _assert_bitwise(_port_state(jstate), got)


def test_port_writes_jax_restores(tmp_path):
    jstate = _jax_pipeline_state()
    save_checkpoint(tmp_path, _port_state(jstate), 3, extra={"loss": 1.5})
    target = jax.tree.map(jnp.zeros_like, jstate) | {"step": 0}
    got, step, extra = j_restore(tmp_path, target=target)
    assert step == 3 and extra == {"loss": 1.5} and int(got["step"]) == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaves_roundtrip_and_match_the_jax_files(tmp_path):
    """bf16 (Adafactor's momentum above 20 B parameters) round-trips bit for
    bit; the port writes the same bytes as the JAX package; a file the JAX
    package writes restores here by its manifest dtype."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    jleaf = jnp.asarray(a, jnp.bfloat16)
    tleaf = torch.from_numpy(a).to(torch.bfloat16)
    save_checkpoint(tmp_path / "port", {"m": tleaf, "step": 1}, 1)
    j_save(tmp_path / "jax", {"m": jleaf, "step": 1}, 1)
    got, _, _ = restore_checkpoint(tmp_path / "port")
    assert got["m"].dtype == torch.bfloat16 and torch.equal(got["m"].view(torch.int16),
                                                            tleaf.view(torch.int16))
    files = [p / "step_000000001" / "leaf_00000.npy" for p in (tmp_path / "port", tmp_path / "jax")]
    assert files[0].read_bytes() == files[1].read_bytes()
    manifests = [json.loads((p.parent / "MANIFEST.json").read_text()) for p in files]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["leaves"][0]["dtype"] == "bfloat16"
    got, _, _ = restore_checkpoint(tmp_path / "jax", target={"m": tleaf, "step": 0})
    np.testing.assert_array_equal(n(got["m"]), np.asarray(jleaf, np.float32))


# ------------------------------------------------------ spmd restart
def test_spmd_restart_determinism(tmp_path):
    """6 steps straight vs 3 steps + restart + 3 steps: the same final loss
    (resumable data, exact state restore), in process."""
    def run(steps, ckpt_dir, resume):
        argv = ["--reduced", "--steps", str(steps), "--seq-len", "64", "--batch", "4",
                "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--ckpt-interval", "3"]
        return t_launch.main(argv + (["--resume"] if resume else []))

    straight = run(6, tmp_path / "a", resume=False)
    run(3, tmp_path / "b", resume=False)
    assert latest_step(tmp_path / "b") == 3
    restarted = run(6, tmp_path / "b", resume=True)
    assert len(restarted["losses"]) == 3
    assert restarted["losses"][-1] == pytest.approx(straight["losses"][-1], abs=1e-5)
    assert latest_step(tmp_path / "b") == 6
    state, _, _ = restore_checkpoint(tmp_path / "b")
    assert int(state["step"]) == 6 and all(p.dtype == torch.float32
                                           for p in tree_leaves(state["params"]))
