"""The port stands alone: importing every module of `repro_torch` loads neither
jax nor any module of the JAX package, `chip_smoke.py` imports neither, and
without a card the smoke script exits nonzero and prints no result."""
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
        "repro_torch.launch.mesh"} <= set(names)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_reference():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    count = int(r.stdout.split()[0])
    assert count >= 33  # every module of the slices so far was imported


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
