"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by a
hash of the source and of every header it includes from `csrc/` (quoted
includes, followed recursively), so that an edit of either triggers a
rebuild. Libraries go to `kernels/_build/`, which git ignores, each beside
the log of its build. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source name -> nvcc/ptxas output of the last build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(source: str) -> list[Path]:
    """`source` and the headers it includes from `csrc/`, recursively, each
    once, in the order first met."""
    seen: list[Path] = []
    todo = [CSRC / source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(source: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources_of(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


@dataclass
class Build:
    """One running nvcc: it writes `tmp`, renamed to `out` when it succeeds."""

    source: str
    proc: subprocess.Popen
    tmp: str
    out: Path


def compile_source(source: str) -> Build | None:
    """Start nvcc for `source` unless its library exists."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return Build(source, proc, tmp, out)


def finish(build: Build | None) -> None:
    """Wait for a build started by `compile_source`; raise if nvcc failed."""
    if build is None:
        return
    log, _ = build.proc.communicate()
    build_logs[build.source] = log
    if build.proc.returncode != 0:
        Path(build.tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {build.source}:\n{log}")
    build.out.with_suffix(".log").write_text(log)
    os.replace(build.tmp, build.out)  # atomic: concurrent builders agree


def build_log(source: str) -> str:
    """The nvcc/ptxas output (registers, spills per kernel) of the build of
    `source`'s current library, whichever process built it; "" if none."""
    if source in build_logs:
        return build_logs[source]
    path = library_path(source).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def build_all(sources=None) -> None:
    """Compile every source at once, one nvcc each, and wait for all."""
    sources = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    builds = [compile_source(s) for s in sources]
    for b in builds:
        finish(b)


def load(source: str) -> ctypes.CDLL:
    """The ctypes library for `source`, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        finish(compile_source(source))
        lib = ctypes.CDLL(str(library_path(source)))
        _libs[source] = lib
    return lib
