"""The port's pipeline engine and driver against the JAX package, on the CPU,
reduced qwen3-8b at 4 layers (the reference's engine tests' config), weights
from the JAX init carried over by `bridge.params_from_jax`: the engine's loss
against JAX `loss_fn`, its gradients against `jax.grad`, the migration
identity, the fail-stop -> reconfigure -> resume run against the JAX engine
driven through the same plans, and the pipeline driver with an injection.

The JAX engine computes in bf16; for the 1e-4 comparison it is made to
compute in fp32 by patching the `embed_tokens` its module calls (the JAX
package is not edited), and the port's engine is given float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.scheduler.plan import initial_plan as j_initial_plan
from repro.core.scheduler.repartition import costs_for_arch as j_costs_for_arch
from repro.core.scheduler.scheduler import Scheduler as JScheduler
from repro.data.synth import SyntheticPackedDataset
from repro.engine import pipeline as j_pipeline
from repro.models.model import init_params as j_init_params, loss_fn as j_loss_fn, stacked_init
from repro.parallel.sharding import NULL_POLICY, split_annotations
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core.detector.dag_sim import ChunkId
from repro_torch.core.scheduler.plan import initial_plan
from repro_torch.core.scheduler.repartition import costs_for_arch
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.engine.pipeline import PipelineEngine
from repro_torch.launch import train as t_launch
from repro_torch.train.optimizer import make_optimizer, tree_leaves

from torch_helpers import t

CFG = reduced(get_arch("qwen3-8b"), n_layers=4)
TCFG = t_reduced(t_get_arch("qwen3-8b"), n_layers=4)
CPU = [torch.device("cpu")]


def _batch(i=0, B=8, S=64):
    return SyntheticPackedDataset(CFG, S, B, seed=3).batch_at(i)


@pytest.fixture(scope="module")
def jparams():
    """The JAX engine's weights: the list layout of `init_params(key 0)`."""
    params, _ = split_annotations(j_init_params(jax.random.PRNGKey(0), CFG))
    return params


def _engine(jparams, plan, dtype, optimizer=None):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float32, device="cpu")
    return PipelineEngine(TCFG, plan, optimizer=optimizer, devices=CPU, params=params,
                          compute_dtype=dtype)


def _jax_loss(batch, dtype):
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(0), CFG))
    _, aux = j_loss_fn(CFG, params, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_POLICY,
                       use_scan=False, remat=False, compute_dtype=dtype)
    return float(aux["loss"])


@pytest.mark.parametrize("dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5),
                                              (torch.bfloat16, jnp.bfloat16, 2e-3)])
def test_engine_loss_matches_jax_loss_fn(jparams, dtype, jdtype, tol):
    """dp2/pp2/tp1, 2 micro-batches: the token-weighted mean over every
    micro-batch and replica is the single-device loss (fp32: relative 1e-5;
    bf16: the reference's absolute 2e-3)."""
    batch = _batch()
    eng = _engine(jparams, initial_plan(4, dp=2, pp=2, tp=1, microbatches=2), dtype)
    loss, grads = eng.run_iteration({k: t(v) for k, v in batch.items()})
    want = _jax_loss(batch, jdtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(loss, want, rtol=tol)
    else:
        assert abs(loss - want) < tol
    assert set(grads) == {(r, s) for r in range(2) for s in range(2)}


def test_engine_gradients_match_jax_grad(jparams):
    """fp32: the replicas' accumulated gradients, summed and divided by the
    tokens, equal jax.grad of the NLL mean for every parameter (1e-4 of
    the leaf's max)."""
    batch = _batch(1)
    eng = _engine(jparams, initial_plan(4, dp=2, pp=2, tp=1, microbatches=2), torch.float32)
    _, grads = eng.run_iteration({k: t(v) for k, v in batch.items()})
    ntok = float((batch["labels"] >= 0).sum())

    def nll(params):
        _, aux = j_loss_fn(CFG, params, {k: jnp.asarray(v) for k, v in batch.items()},
                           NULL_POLICY, use_scan=False, remat=False, compute_dtype=jnp.float32)
        return aux["loss"]

    stacked, _ = split_annotations(stacked_init(jax.random.PRNGKey(0), CFG))
    want = params_from_jax(jax.tree.map(np.asarray, jax.grad(nll)(stacked)),
                           dtype=torch.float32, device="cpu")
    checked = 0
    for s, st in enumerate(eng.plan.replicas[0].stages):
        summed = [(a + b) / ntok for a, b in zip(tree_leaves(grads[(0, s)]),
                                                 tree_leaves(grads[(1, s)]))]
        ref = _stage_leaves(eng.stage_params(0, s), want, st.layers)
        assert len(summed) == len(ref)
        for a, b in zip(summed, ref):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7
            checked += 1
    assert checked == len(tree_leaves(eng.params_full))


def _stage_leaves(stage_params, full, layers):
    """The leaves of `full` (port layout) that a stage holds, in the order of
    the stage's parameters."""
    def walk(p, r):
        if isinstance(p, dict):
            return [x for k in p for x in walk(p[k], r[k])]
        if isinstance(p, list):
            return [x for a, b in zip(p, r) for x in walk(a, b)]
        return [r]

    return walk(stage_params, dict(full, layers=[full["layers"][l] for l in layers]))


def test_migration_placement_identity(jparams):
    """Executing a micro-batch's stage on a peer replica (Fig. 6b) gives the
    same loss: replicas are synchronized."""
    batch = {k: t(v) for k, v in _batch().items()}
    eng = _engine(jparams, initial_plan(4, dp=2, pp=2, tp=1, microbatches=2), torch.bfloat16)
    base, _ = eng.run_iteration(batch)
    placement = {ChunkId("F", 0, 1, 0): (1, 1), ChunkId("B", 0, 1, 0): (1, 1)}
    mig, _ = eng.run_iteration(batch, placement=placement)
    assert abs(base - mig) < 1e-5


@pytest.mark.parametrize("schedule", ["gpipe", "zb-h1"])
def test_engine_runs_every_schedule(jparams, schedule):
    """GPipe and ZB-H1 (whose W chunks are folded into B) give the 1F1B loss."""
    batch = {k: t(v) for k, v in _batch().items()}
    plan = initial_plan(4, dp=2, pp=2, tp=1, microbatches=2)
    base, _ = _engine(jparams, plan, torch.float32).run_iteration(batch)
    other, _ = _engine(jparams, plan.replace(schedule=schedule), torch.float32).run_iteration(batch)
    np.testing.assert_allclose(other, base, rtol=1e-6)


def test_engine_refuses_a_dead_stage(jparams):
    """A plan with a stage that has no devices cannot run; the error names
    the stage (the reference's engine raises a KeyError there)."""
    tplan = initial_plan(4, dp=2, pp=2, tp=1, microbatches=2)
    speeds = {d: 1.0 for d in tplan.devices}
    speeds[2] = 0.0  # replica 1, stage 0, tp 1: no survivor
    ad = Scheduler(layer_costs=costs_for_arch(TCFG, 64)).adapt(tplan, speeds, failed={2})
    assert ad.dead_stages == ((1, 0),)
    eng = _engine(jparams, tplan, torch.float32)
    eng.apply_plan(ad.plan)
    with pytest.raises(RuntimeError, match=r"stage \(dp1,pp0\)"):
        eng.run_iteration({k: t(v) for k, v in _batch().items()})


def test_failstop_reconfigure_resume_matches_jax_engine(jparams, monkeypatch):
    """dp2/pp2/tp2, AdamW lr 5e-3: 4 steps, fail-stop device 5 (replica 1,
    stage 0), the Scheduler re-plans (TP exclusion + repartition), the
    engine takes the plan, 4 more steps. The port's 8 losses equal the JAX
    engine's driven through the same plans (fp32, relative 1e-4), and the
    loss stays continuous across the reconfiguration (Fig. 12)."""
    j_embed = j_pipeline.embed_tokens
    monkeypatch.setattr(j_pipeline, "embed_tokens",
                        lambda cfg, p, tokens: j_embed(cfg, p, tokens, jnp.float32))
    jplan = j_initial_plan(4, dp=2, pp=2, tp=2, microbatches=2)
    tplan = initial_plan(4, dp=2, pp=2, tp=2, microbatches=2)
    jeng = j_pipeline.PipelineEngine(CFG, jplan, optimizer=j_make_optimizer("adamw", lr=5e-3),
                                     seed=0)
    teng = _engine(jparams, tplan, torch.float32, optimizer=make_optimizer("adamw", lr=5e-3))
    jl, tl = [], []

    def steps(rng):
        for i in rng:
            batch = _batch(i)
            jl.append(jeng.run_iteration({k: jnp.asarray(v) for k, v in batch.items()})[0])
            tl.append(teng.run_iteration({k: t(v) for k, v in batch.items()})[0])

    steps(range(4))
    speeds = {d: 1.0 for d in tplan.devices}
    speeds[5] = 0.0
    jad = JScheduler(layer_costs=j_costs_for_arch(CFG, 64)).adapt(jplan, speeds, failed={5})
    tad = Scheduler(layer_costs=costs_for_arch(TCFG, 64)).adapt(tplan, speeds, failed={5})
    assert tad.plan.summary() == jad.plan.summary() and tad.notes == jad.notes
    assert tad.plan.replicas[1].stages[0].tp == 1  # selective exclusion
    assert [st.layers for st in tad.plan.replicas[0].stages] != [(0, 1), (2, 3)]  # repartition
    jeng.apply_plan(jad.plan)
    teng.apply_plan(tad.plan)
    steps(range(4, 8))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert abs(tl[4] - tl[3]) < 0.15
    assert all(np.isfinite(tl)) and teng.step == 8


def test_driver_pipeline_failstop_in_process():
    """The driver on the CPU: dp2/pp2/tp2, fail-stop device 5 at step 3 ->
    one reconfiguration at step 3, every loss finite."""
    r = t_launch.main(["--reduced", "--mode", "pipeline", "--dp", "2", "--pp", "2", "--tp", "2",
                       "--steps", "6", "--seq-len", "64", "--batch", "8",
                       "--inject-failstop", "3:5", "--device", "cpu"])
    assert r["reconfigs"] == [3], r["reconfigs"]
    assert np.isfinite(r["losses"]).all() and len(r["losses"]) == len(r["times"]) == 6
    (ad,) = r["adaptations"]
    assert ad["plan"] == "dp0[s0:tp2xL1 s1:tp2xL3] dp1[s0:tp1xL1 s1:tp2xL3]"
    assert ad["restored_from"] is None and len(ad["moves"]) == 1 and ad["bytes"] > 0


def test_driver_pipeline_restart_determinism(tmp_path):
    """Pipeline mode: 6 steps straight vs 3 + save + restart + 3, the same
    final loss within 1e-5 (the reference's determinism test, in process)."""
    def run(steps, ckpt_dir, resume):
        argv = ["--reduced", "--mode", "pipeline", "--steps", str(steps), "--seq-len", "64",
                "--batch", "4", "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
                "--ckpt-interval", "3"]
        return t_launch.main(argv + (["--resume"] if resume else []))

    straight = run(6, tmp_path / "a", resume=False)
    run(3, tmp_path / "b", resume=False)
    restarted = run(6, tmp_path / "b", resume=True)
    assert len(restarted["losses"]) == 3
    assert restarted["losses"][-1] == pytest.approx(straight["losses"][-1], abs=1e-5)
