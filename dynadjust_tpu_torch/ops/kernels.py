"""Build and load the package's CUDA kernels.

Each CUDA source (``csrc/*.cu``) is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes`` — seconds per source, where a build against PyTorch's
headers takes minutes.  Libraries go to ``_build/`` beside the package
(listed in ``.gitignore``) on first use; a library older than its source
is rebuilt.  Nothing is built when a module is imported: the CPU paths
and the tests never touch ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("chol_inv",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD / f"libdta_{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources, one nvcc process each, all started
    together.  Returns {name: ptxas report} for the ones built; raises
    with the compiler's output if any fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD / f".libdta_{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            failed.append(f"nvcc {name}.cu failed ({p.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def timed_build(names=SOURCES) -> tuple:
    """(seconds, reports) of a forced build of every source."""
    t0 = time.perf_counter()
    reports = build(names, force=True)
    return time.perf_counter() - t0, reports
