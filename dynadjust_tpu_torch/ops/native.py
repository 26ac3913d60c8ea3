"""The host kernels of csrc/host_kernels.cpp, bound with ctypes.

Port of the JAX package's ``ops/native.py``: plain C++ on the host (no
device code) for a blocked float64 matvec, GNSS baseline residuals and
the rhs scatter.  In the JAX package the matvec is the host refinement
loop's block products and the other two serve the GNSS-only assembly
(M5; the port's parallel/assembly.py calls the baseline residuals).
The port's host loop (``parallel/schur.py::
_block_matvec``) keeps numpy's block products, ``block_matvec_plain``:
the library's matvec is no faster on the card's host and slower right
after a BLAS call (PERF.md, native cell).  The library is built by
``g++ -O3 -march=native -fPIC -std=c++17 -pthread -shared`` into
``_build/libdta_host_kernels.so`` beside the package at first use (a
temporary output, then ``os.replace``, so that processes building at
once do not race), and rebuilt when it is older than its source.
Nothing is built when the module is imported.

The JAX package falls back to numpy in silence when its library is
missing; here a failed build raises with the compiler's output.  The
numpy versions (``*_plain``) stay beside the kernels as the tests'
reference.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host_kernels.cpp"
LIBRARY = _PKG / "_build" / "libdta_host_kernels.so"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")

_lib = None


def build(force: bool = False) -> Path:
    """Compile csrc/host_kernels.cpp unless the library is newer than it;
    raises RuntimeError with g++'s output when the compile fails."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}")
    r = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE)], capture_output=True,
                       text=True)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {SOURCE.name} failed ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded host-kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i = ctypes.POINTER(ctypes.c_int64)
        lib.scatter_rhs.argtypes = [c_i, c_d, c_d, ctypes.c_double,
                                    ctypes.c_int64, c_d]
        lib.baseline_residuals.argtypes = [c_i, c_d, c_d, ctypes.c_int64,
                                           c_d]
        lib.block_matvec.argtypes = [c_d, c_d, c_d, c_d, c_d,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, c_d, c_d]
        for fn in (lib.scatter_rhs, lib.baseline_residuals,
                   lib.block_matvec):
            fn.restype = None
        _lib = lib
    return _lib


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def baseline_residuals(pairs, obs, x) -> np.ndarray:
    """mmc[m] = obs[m] - (x[j] - x[i]) for pairs[m] = (i, j); obs (M, 3),
    x (S, 3)."""
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    obs, x = _f64(obs), _f64(x)
    if pairs.shape != (len(obs), 2) or obs.shape[1:] != (3,) or \
            x.shape[1:] != (3,):
        raise ValueError(f"shapes pairs {pairs.shape}, obs {obs.shape}, "
                         f"x {x.shape}")
    if len(pairs) and (pairs.min() < 0 or pairs.max() >= len(x)):
        raise ValueError("station index out of range")
    out = np.empty_like(obs)
    library().baseline_residuals(_ptr_i(pairs), _ptr_d(obs), _ptr_d(x),
                                 len(pairs), _ptr_d(out))
    return out


def baseline_residuals_plain(pairs, obs, x) -> np.ndarray:
    return obs - (x[pairs[:, 1]] - x[pairs[:, 0]])


def scatter_rhs(idx, w, mmc, sign: float, out) -> np.ndarray:
    """out[idx[m, k]] += sign * w[m] * mmc[m, k] where idx[m, k] >= 0, in
    place on the float64 array `out`; idx and mmc (M, 3), w (M,)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    w, mmc = _f64(w), _f64(mmc)
    if idx.shape != mmc.shape or idx.shape != (len(w), 3):
        raise ValueError(f"shapes idx {idx.shape}, w {w.shape}, "
                         f"mmc {mmc.shape}")
    if not (out.dtype == np.float64 and out.flags.c_contiguous):
        raise ValueError("out must be a contiguous float64 array")
    if idx.size and idx.max() >= out.size:
        raise ValueError("rhs index out of range")
    library().scatter_rhs(_ptr_i(idx), _ptr_d(w), _ptr_d(mmc), float(sign),
                          len(w), _ptr_d(out))
    return out


def scatter_rhs_plain(idx, w, mmc, sign: float, out) -> np.ndarray:
    keep = idx >= 0
    np.add.at(out, idx[keep], (sign * w[:, None] * mmc)[keep])
    return out


def block_matvec(Nii, Nij, Njj, xi, xj_b):
    """(yi, yj_b) of the blocked symmetric matvec in float64:
    yi = Nii xi + Nij xj_b and yj_b = Nijᵀ xi + Njj xj_b per block;
    Nii (B, ni, ni), Nij (B, ni, nj), Njj (B, nj, nj)."""
    Nii, Nij, Njj, xi, xj_b = map(_f64, (Nii, Nij, Njj, xi, xj_b))
    B, ni, nj = Nij.shape
    if (Nii.shape != (B, ni, ni) or Njj.shape != (B, nj, nj)
            or xi.shape != (B, ni) or xj_b.shape != (B, nj)):
        raise ValueError(f"shapes Nii {Nii.shape}, Nij {Nij.shape}, Njj "
                         f"{Njj.shape}, xi {xi.shape}, xj_b {xj_b.shape}")
    yi = np.empty((B, ni))
    yj = np.empty((B, nj))
    library().block_matvec(_ptr_d(Nii), _ptr_d(Nij), _ptr_d(Njj),
                           _ptr_d(xi), _ptr_d(xj_b), B, ni, nj, _ptr_d(yi),
                           _ptr_d(yj))
    return yi, yj


def block_matvec_plain(Nii, Nij, Njj, xi, xj_b):
    yi = (np.matmul(Nii, xi[:, :, None])[:, :, 0]
          + np.matmul(Nij, xj_b[:, :, None])[:, :, 0])
    yj = (np.matmul(xi[:, None, :], Nij)[:, 0, :]
          + np.matmul(Njj, xj_b[:, :, None])[:, :, 0])
    return yi, yj
