"""The port's copies of the Detector's failure lifecycle, the credit model,
the restart economics and the data helpers the simulator needs, against the
JAX package's originals: `LifecycleManager` decision sequences, the fitted
credit config and its file, `RestartCostModel` prices and `from_manifest` on
checkpoints written by either package (bf16 leaves included, and in a
process without `ml_dtypes`), `quadratic_cost`, `synthetic_chunk_time`, and
the package exports, all equal."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import RestartCostModel as JRestartCostModel, save_checkpoint as j_save
from repro.cluster.hazard import (HazardEstimator as JHazardEstimator,
                                  HazardPolicyConfig as JHazardPolicyConfig)
from repro.core.detector import credit as j_credit, lifecycle as j_lifecycle
from repro.core.detector.predictor import synthetic_chunk_time as j_synthetic_chunk_time
from repro.data.packing import quadratic_cost as j_quadratic_cost
from repro_torch.checkpoint import RestartCostModel, save_checkpoint
from repro_torch.cluster.hazard import HazardEstimator, HazardPolicyConfig
from repro_torch.core.detector import credit, lifecycle
from repro_torch.core.detector.predictor import synthetic_chunk_time
from repro_torch.data.packing import quadratic_cost

ROOT = Path(__file__).resolve().parents[1]
N_DEVICES = 16


# ----------------------------------------------------------------- lifecycle
def _manager(lc, cr, hz, variant, probe_fn):
    cfg = (lc.LifecycleConfig(flap_threshold=1, backoff_base_s=10.0, backoff_factor=3.0,
                              admission=False)
           if variant == "eager" else lc.LifecycleConfig())
    mgr = lc.LifecycleManager(cfg=cfg, probe_fn=probe_fn)
    if variant in ("hazard", "credit"):
        mgr.hazard = hz[0](hz[1]())
    if variant == "credit":
        members = {p: tuple(range(4 * p, 4 * p + 4)) for p in range(N_DEVICES // 4)}
        mgr.credit = cr.CreditModel(cr.fitted_credit_config(), N_DEVICES, hazard=mgr.hazard,
                                    domain_members=members)
    return mgr


def _drive(lc, cr, hz, variant, seed):
    """A seeded sequence of failures, rejoins and release polls; every
    decision and view the manager returns, in order."""
    rng = np.random.default_rng([0x11FE, seed])
    speeds = {}
    mgr = _manager(lc, cr, hz, variant, lambda d: speeds.get(d, 1.0))
    out, now = [], 0.0
    for _ in range(300):
        now += float(rng.exponential(6.0))
        d = int(rng.integers(0, N_DEVICES))
        op = int(rng.integers(0, 6))
        speeds[d] = float(rng.choice([0.0, 0.3, 0.9, 1.0]))
        if op == 0 or op == 1:
            mgr.record_failstop(d, now)
        elif op == 2:
            mgr.record_failslow(d, float(rng.uniform(0.2, 0.95)), now)
        elif op == 3:
            out.append(("rejoin", dataclasses.astuple(mgr.on_rejoin(d, now))))
        elif op == 4:
            out.append(("release", [dataclasses.astuple(r) for r in mgr.poll_releases(now)]))
        else:
            out.append(("views", sorted(mgr.quarantined(now)), mgr.is_quarantined(d, now),
                        sorted(mgr.risk_scores(now).items())))
            if mgr.credit is not None:
                out.append(("credit", sorted(mgr.credit.scores(mgr.histories, now).items())))
    out.append(("stats", mgr.stats.as_dict(), sorted(mgr.states().items()),
                [dataclasses.astuple(mgr.histories[k]) for k in sorted(mgr.histories)]))
    if mgr.credit is not None:
        out.append(("credit_stats", mgr.credit.stats.as_dict(), mgr.credit.arr.tolist()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", ["default", "eager", "hazard", "credit"])
def test_lifecycle_decisions_match_reference(variant, seed):
    ours = _drive(lifecycle, credit, (HazardEstimator, HazardPolicyConfig), variant, seed)
    ref = _drive(j_lifecycle, j_credit, (JHazardEstimator, JHazardPolicyConfig), variant, seed)
    assert ours == ref
    # the sequence quarantines and readmits, so every branch is compared
    stats = ours[-2][1] if variant == "credit" else ours[-1][1]
    assert stats["quarantines"] > 0 and stats["readmissions"] > 0


def test_lifecycle_constants_match_reference():
    assert lifecycle.STATES == j_lifecycle.STATES
    assert (dataclasses.asdict(lifecycle.LifecycleConfig())
            == dataclasses.asdict(j_lifecycle.LifecycleConfig()))


# -------------------------------------------------------------------- credit
def test_fitted_credit_config_matches_reference():
    assert (dataclasses.asdict(credit.fitted_credit_config())
            == dataclasses.asdict(j_credit.fitted_credit_config()))
    assert credit.FIT_FIELDS == j_credit.FIT_FIELDS
    assert credit.FITTED_CONFIG_PATH == ROOT / "src/repro_torch/configs/credit_fitted.json"
    assert credit.FITTED_CONFIG_PATH.read_bytes() == j_credit.FITTED_CONFIG_PATH.read_bytes()


def test_fitted_credit_config_reads_either_file(tmp_path):
    p = tmp_path / "fit.json"
    p.write_text(json.dumps({"fitted": {"alpha": 0.2, "probe_band": 0.7, "window_s": 30.0}}))
    assert (dataclasses.asdict(credit.fitted_credit_config(p))
            == dataclasses.asdict(j_credit.fitted_credit_config(p)))
    assert credit.fitted_credit_config(tmp_path / "absent.json") == credit.CreditConfig()
    p.write_text(json.dumps({"fitted": {"flap_window_s": 9.0}}))
    with pytest.raises(ValueError):
        credit.fitted_credit_config(p)


# ------------------------------------------------------------------- economics
PRICES = [dict(), dict(state_gb=3.5, write_gbps=2.0, read_gbps=7.0, relaunch_s=1.5,
                       checkpoint_interval_s=60.0, lost_work_frac=0.25)]


@pytest.mark.parametrize("kw", PRICES)
def test_restart_cost_model_prices_match_reference(kw):
    ours, ref = RestartCostModel(**kw), JRestartCostModel(**kw)
    for fn in ("save_cost_s", "restore_read_s", "lost_work_s", "restart_cost_s"):
        assert getattr(ours, fn)() == getattr(ref, fn)(), fn


def test_from_manifest_prices_checkpoints_of_both_packages(tmp_path):
    """A checkpoint written by each package, one bf16 leaf in each: both
    models price both the same, bf16 at 2 bytes an element."""
    n_bytes = 6 * 4 * 4 + 5 * 7 * 2 + 3 * 4 + 4
    j_save(tmp_path / "jax", {"w": jnp.ones((6, 4), jnp.float32),
                              "h": jnp.ones((5, 7), jnp.bfloat16),
                              "i": jnp.arange(3, dtype=jnp.int32), "s": jnp.int32(4)}, 3)
    save_checkpoint(tmp_path / "torch", {"w": torch.ones(6, 4),
                                         "h": torch.ones(5, 7, dtype=torch.bfloat16),
                                         "i": torch.arange(3, dtype=torch.int32),
                                         "s": torch.tensor(4, dtype=torch.int32)}, 3)
    for d in ("jax", "torch"):
        m = json.loads((tmp_path / d / "step_000000003" / "MANIFEST.json").read_text())
        assert "bfloat16" in [leaf["dtype"] for leaf in m["leaves"]]
        ours = RestartCostModel.from_manifest(tmp_path / d)
        ref = JRestartCostModel.from_manifest(tmp_path / d)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
        assert ours.state_gb * 1e9 == pytest.approx(n_bytes, rel=1e-12)


FROM_MANIFEST_WITHOUT_ML_DTYPES = r"""
import json, sys
from pathlib import Path
import numpy as np
from repro_torch.checkpoint.economics import RestartCostModel
step = Path(sys.argv[1]) / "step_000000001"
step.mkdir(parents=True)
leaves = [{"dtype": "bfloat16", "shape": [10, 3]}, {"dtype": "float32", "shape": [5]}]
(step / "MANIFEST.json").write_text(json.dumps({"n_leaves": 2, "leaves": leaves}))
(step / "COMMIT").write_text("ok")
gb = RestartCostModel.from_manifest(step.parent).state_gb
try:
    np.dtype("bfloat16")   # the reference's pricing, which needs ml_dtypes
    plain = "ok"
except TypeError:
    plain = "TypeError"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("ml_dtypes", "torch", "jax", "repro"))
print(json.dumps({"bytes": round(gb * 1e9), "plain": plain, "bad": bad}))
"""


def test_from_manifest_prices_bf16_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", FROM_MANIFEST_WITHOUT_ML_DTYPES, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"bytes": 10 * 3 * 2 + 5 * 4, "plain": "TypeError", "bad": []}


# ----------------------------------------------------------------- data helpers
def test_quadratic_cost_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        row = rng.integers(1, 4096, size=int(rng.integers(0, 12))).tolist()
        assert quadratic_cost(row) == j_quadratic_cost(row)
        assert quadratic_cost(np.asarray(row, np.int32)) == j_quadratic_cost(row)


@pytest.mark.parametrize("kind", ["F", "B", "W"])
def test_synthetic_chunk_time_matches_reference(kind):
    args = (2.1e-6, 3.3e-10, 0.004, 8192, 1.4e7)
    for kw in (dict(), dict(n_layers=5, speed=0.4, b_ratio=2.5, w_ratio=0.7)):
        assert (synthetic_chunk_time(*args, kind=kind, **kw)
                == j_synthetic_chunk_time(*args, kind=kind, **kw))
        noisy = [f(*args, kind=kind, noise=0.05, rng=np.random.default_rng(9), **kw)
                 for f in (synthetic_chunk_time, j_synthetic_chunk_time)]
        assert noisy[0] == noisy[1]


# ------------------------------------------------------------------- exports
@pytest.mark.parametrize("package", ["core.detector", "data", "checkpoint", "cluster"])
def test_package_exports_match_reference(package):
    """The port's package exports the reference's names; those of
    `core.detector` and `data` load on first access."""
    import importlib
    ref = importlib.import_module(f"repro.{package}")
    ours = importlib.import_module(f"repro_torch.{package}")
    names = {k for k in dir(ref) if not k.startswith("_")
             and getattr(getattr(ref, k), "__module__", "").startswith("repro.")}
    assert names, package
    for name in sorted(names):
        obj = getattr(ours, name)
        assert obj.__module__ == getattr(ref, name).__module__.replace("repro.", "repro_torch.", 1)
        assert obj.__name__ == getattr(ref, name).__name__
