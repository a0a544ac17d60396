"""The port stands alone: importing every module of `repro_torch` loads neither
jax nor any module of the JAX package, `chip_smoke.py` and `chip_compare.py`
import neither, and without a card each script exits nonzero and prints no
result."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert "repro_torch.kernels.packed_flash_attn" in names and "repro_torch.bridge" in names
assert {"repro_torch.launch.train", "repro_torch.train.optimizer",
        "repro_torch.core.detector.changepoint", "repro_torch.core.detector.detector",
        "repro_torch.core.detector.heartbeat"} <= set(names)
assert {"repro_torch.core.detector.dag_sim", "repro_torch.engine.schedules",
        "repro_torch.engine.pipeline", "repro_torch.core.scheduler.plan",
        "repro_torch.core.scheduler.repartition", "repro_torch.core.scheduler.tp_reconfig",
        "repro_torch.core.scheduler.scheduler", "repro_torch.core.resihp",
        "repro_torch.core.recovery", "repro_torch.checkpoint.checkpoint",
        "repro_torch.launch.mesh", "repro_torch.core.scheduler.p2p",
        "repro_torch.core.scheduler.migration"} <= set(names)
assert {"repro_torch.configs.paper_models", "repro_torch.configs.gemma3_1b",
        "repro_torch.configs.gemma3_4b", "repro_torch.configs.h2o_danube_1_8b"} <= set(names)
assert {"repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
        "repro_torch.configs.grok_1_314b"} <= set(names)
assert {"repro_torch.models.ssm", "repro_torch.models.xlstm", "repro_torch.configs.xlstm_1_3b",
        "repro_torch.configs.jamba_1_5_large_398b"} <= set(names)
assert {"repro_torch.parallel.sharding", "repro_torch.train.compression"} <= set(names)
assert {"repro_torch.launch.specs", "repro_torch.launch.dryrun", "repro_torch.roofline.analysis",
        "repro_torch.roofline.counter"} <= set(names)
assert {"repro_torch.cluster", "repro_torch.cluster.baselines", "repro_torch.cluster.events",
        "repro_torch.cluster.fastsim", "repro_torch.cluster.hazard", "repro_torch.cluster.mining",
        "repro_torch.cluster.registry", "repro_torch.cluster.scenarios",
        "repro_torch.cluster.simulator", "repro_torch.cluster.workload",
        "repro_torch.core.detector.lifecycle", "repro_torch.core.detector.credit",
        "repro_torch.checkpoint.economics"} <= set(names)
"""

# the simulator's process: no torch, no jax, no reference package
SIMULATE = r"""
import sys
from repro_torch.cluster import scenarios
from repro_torch.cluster.simulator import SimConfig, TrainingSim
sim = TrainingSim("resihp", SimConfig(dp=2, pp=2, tp=2, n_layers=8, n_microbatches=4,
                                      seq_len=2048, noise=0.01, seed=0),
                  policy_kwargs=dict(plan_overhead_fixed=0.25, domains=True, credit=True))
sim.apply_scenario(scenarios.get("fig10_mixed", span=0.2))
sim.run(5, stop_on_abort=False)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))
print(len(sim.trace), len(sim.event_log), bad)
assert len(sim.trace) == 5 and not bad, bad
"""

# the reference's files with a counterpart of another name in the port
RENAMED = {"roofline/hlo.py": "roofline/counter.py"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_reference():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    count = int(r.stdout.split()[0])
    assert count >= 79  # every module of the slices so far was imported


def test_simulator_runs_without_torch_jax_or_reference():
    """Importing `repro_torch.cluster.simulator` and running a simulation
    (the domain and credit switches on, so the restart model and the fitted
    credit file load too) loads neither torch, jax nor the JAX package."""
    r = subprocess.run([sys.executable, "-c", SIMULATE], env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_reference_module_has_a_counterpart():
    """Every `.py` and `.json` file of the JAX package has one at the same
    relative path in the port (`RENAMED` lists the one that does not)."""
    ref, port = SRC / "repro", SRC / "repro_torch"
    files = sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*")
                   if p.suffix in (".py", ".json") and "__pycache__" not in p.parts)
    assert len(files) > 60
    missing = [f for f in files if not (port / RENAMED.get(f, f)).is_file()]
    assert not missing, missing
    assert all(not (port / f).exists() for f in RENAMED)


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_chip_smoke_imports_neither_jax_nor_reference():
    mods = _imported_modules(ROOT / "chip_smoke.py")
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods
    assert any(m.startswith("repro_torch") for m in mods)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_compare_imports_neither_jax_nor_reference_and_needs_a_card(tmp_path):
    """`chip_compare.py` (one arch's kernels and train step in several trees,
    in turn) imports no JAX, and without a card exits nonzero, running none
    of its trees."""
    script = ROOT / "chip_compare.py"
    mods = _imported_modules(script)
    worker = ast.parse(next(n.value.value for n in ast.parse(script.read_text()).body
                            if isinstance(n, ast.Assign) and n.targets[0].id == "WORKER"))
    mods |= {a.name for n in ast.walk(worker) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(worker) if isinstance(n, ast.ImportFrom)}
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods
    assert "chip_smoke" in mods
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script), "--trees", str(ROOT)], env=env,
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"runs"' not in r.stdout

