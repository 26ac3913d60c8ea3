"""The port's host kernel library (csrc/host_kernels.cpp through
ops/native.py) against its numpy versions and the JAX package's library.

block_matvec, baseline_residuals and scatter_rhs of the library, built
by g++ at first use, agree with their plain numpy versions to 1e-12
relative on random float64 inputs from a numpy seed, at shapes that use
one worker thread and several; malformed shapes and indices are refused
before a pointer reaches the library.  The same inputs go through the
JAX package's C functions (native/assembly_kernels.cpp, built here by
g++ with the flags of native/Makefile and called through ctypes, as
dynadjust_tpu.ops.native calls them) and through
dynadjust_tpu.ops.native.baseline_residuals, to the same 1e-12.  At the
inputs the GNSS-only assembly gives them (the 16 x 16 network of
tests/test_schur.py and the port's scatter plan of it), the port's
baseline_residuals and scatter_rhs equal the JAX package's tracked
native/libdta_native.so (dynadjust_tpu.ops.native._load) bit for bit.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.ops import native as jax_native
from dynadjust_tpu_torch.ops import native

JAX_SOURCE = Path(__file__).resolve().parents[1] / "native" / \
    "assembly_kernels.cpp"


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("B,ni,nj", [(1, 7, 3), (9, 60, 24), (5, 33, 0)])
def test_block_matvec(B, ni, nj):
    rng = np.random.default_rng(B)
    args = [rng.normal(size=s) for s in ((B, ni, ni), (B, ni, nj),
                                         (B, nj, nj), (B, ni), (B, nj))]
    got = native.block_matvec(*args)
    want = native.block_matvec_plain(*args)
    assert got[0].shape == (B, ni) and got[1].shape == (B, nj)
    assert _rel(got[0], want[0]) < 1e-12
    if nj:
        assert _rel(got[1], want[1]) < 1e-12


@pytest.mark.parametrize("M", [50, 40000])
def test_baseline_residuals(M):
    rng = np.random.default_rng(M)
    S = 300
    pairs = rng.integers(0, S, size=(M, 2))
    obs, x = rng.normal(size=(M, 3)), rng.normal(size=(S, 3))
    got = native.baseline_residuals(pairs, obs, x)
    assert _rel(got, native.baseline_residuals_plain(pairs, obs, x)) < 1e-12


def test_scatter_rhs():
    rng = np.random.default_rng(7)
    M, n = 500, 200
    idx = rng.integers(-1, n, size=(M, 3))
    w, mmc = rng.random(M), rng.normal(size=(M, 3))
    got = native.scatter_rhs(idx, w, mmc, -1.0, np.zeros(n))
    want = native.scatter_rhs_plain(idx, w, mmc, -1.0, np.zeros(n))
    assert _rel(got, want) < 1e-12


def test_malformed_inputs_are_refused():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        native.baseline_residuals(np.array([[0, 5]]), rng.normal(size=(1, 3)),
                                  rng.normal(size=(5, 3)))
    with pytest.raises(ValueError):
        native.scatter_rhs(np.array([[0, 1, 9]]), np.ones(1),
                           np.ones((1, 3)), 1.0, np.zeros(9))
    with pytest.raises(ValueError):
        native.block_matvec(*(rng.normal(size=s) for s in (
            (2, 4, 4), (2, 4, 3), (2, 3, 3), (2, 5), (2, 3))))


def test_library_is_built_into_the_package():
    lib = native.build()
    assert lib == native.LIBRARY and lib.exists()
    assert lib.parent.name == "_build"
    assert lib.stat().st_mtime >= native.SOURCE.stat().st_mtime


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No silent numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void block_matvec( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "_build" / "lib.so")
    with pytest.raises(RuntimeError, match=r"g\+\+ bad.cpp failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not (tmp_path / "_build" / "lib.so").exists()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's C library, built from its source with the flags
    of native/Makefile and bound as dynadjust_tpu.ops.native binds it."""
    so = tmp_path_factory.mktemp("jax_native") / "libdta_native.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
                    "-pthread", "-shared", "-o", str(so), str(JAX_SOURCE)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i = ctypes.POINTER(ctypes.c_int64)
    lib.scatter_rhs.argtypes = [c_i, c_d, c_d, ctypes.c_double,
                                ctypes.c_int64, c_d]
    lib.baseline_residuals.argtypes = [c_i, c_d, c_d, ctypes.c_int64, c_d]
    lib.block_matvec.argtypes = [c_d, c_d, c_d, c_d, c_d, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64, c_d, c_d]
    return lib


def _pd(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _pi(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


@pytest.mark.parametrize("M", [50, 40000])
def test_baseline_residuals_matches_jax(jax_lib, M):
    rng = np.random.default_rng(M + 1)
    S = 300
    pairs = rng.integers(0, S, size=(M, 2))
    obs, x = rng.normal(size=(M, 3)), rng.normal(size=(S, 3))
    got = native.baseline_residuals(pairs, obs, x)
    want = np.empty((M, 3))
    jax_lib.baseline_residuals(_pi(pairs), _pd(obs), _pd(x), M, _pd(want))
    assert _rel(got, want) < 1e-12
    assert _rel(got, jax_native.baseline_residuals(pairs, obs, x)) < 1e-12


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scatter_rhs_matches_jax(jax_lib, sign):
    rng = np.random.default_rng(11)
    M, n = 2000, 300
    idx = rng.integers(-1, n, size=(M, 3))
    w, mmc = rng.random(M), rng.normal(size=(M, 3))
    got = native.scatter_rhs(idx, w, mmc, sign, np.zeros(n))
    want = np.zeros(n)
    jax_lib.scatter_rhs(_pi(idx), _pd(w), _pd(mmc), sign, M, _pd(want))
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("B,ni,nj", [(1, 7, 3), (9, 60, 24)])
def test_block_matvec_matches_jax(jax_lib, B, ni, nj):
    rng = np.random.default_rng(B + 2)
    args = [rng.normal(size=s) for s in ((B, ni, ni), (B, ni, nj),
                                         (B, nj, nj), (B, ni), (B, nj))]
    got = native.block_matvec(*args)
    yi, yj = np.empty((B, ni)), np.empty((B, nj))
    jax_lib.block_matvec(*map(_pd, args), B, ni, nj, _pd(yi), _pd(yj))
    assert _rel(got[0], yi) < 1e-12 and _rel(got[1], yj) < 1e-12


@pytest.fixture(scope="module")
def gnss_plan():
    """The 16 x 16 GNSS network of tests/test_schur.py (seed 3, blocks of
    4) and the port's scatter plan of it (parallel/assembly.build_plan):
    the inputs the GNSS-only assembly gives both functions."""
    from dynadjust_tpu_torch.parallel.assembly import build_plan
    from dynadjust_tpu_torch.parallel.blocked_adjust import BlockedNetwork
    from dynadjust_tpu_torch.utils.synthetic import (grid_segmentation,
                                                     synthetic_grid_network)
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(16, 16, seed=3)
    blocks, junction = grid_segmentation(16, 16, 4, 4)
    bn = BlockedNetwork(nstations=256, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    return build_plan(bn, 0.01), x0


def test_baseline_residuals_on_gnss_inputs_match_jax(gnss_plan):
    """The port's library against dynadjust_tpu.ops.baseline_residuals
    (the JAX package's tracked native/libdta_native.so) at the GNSS
    network's pairs, observations and coordinates."""
    from dynadjust_tpu.ops import baseline_residuals as jax_baseline
    plan, x0 = gnss_plan
    bn = plan.bn
    assert jax_native._load()
    for x in (x0, x0 + 1e-4):
        got = native.baseline_residuals(bn.pairs, bn.obs, x)
        want = jax_baseline(bn.pairs, bn.obs, x)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("which", ["bi_idx_1", "bi_idx_2", "bj_idx_1",
                                   "bj_idx_2"])
def test_scatter_rhs_on_gnss_plan_matches_jax(gnss_plan, which):
    """The port's scatter_rhs against the JAX package's C function from
    its tracked native/libdta_native.so (dynadjust_tpu.ops.native._load),
    with each of the GNSS plan's four rhs index arrays (-1 where the
    endpoint lies in the other pool) and both signs."""
    plan, x0 = gnss_plan
    bn = plan.bn
    lib = jax_native._load()
    idx = np.ascontiguousarray(getattr(plan, which), dtype=np.int64)
    n = int(idx.max()) + 1
    w = np.ascontiguousarray(bn.weight, dtype=np.float64)
    mmc = native.baseline_residuals_plain(bn.pairs, bn.obs, x0)
    for sign in (1.0, -1.0):
        got = native.scatter_rhs(idx, w, mmc, sign, np.zeros(n))
        want = np.zeros(n)
        lib.scatter_rhs(_pi(idx), _pd(w), _pd(mmc), sign, len(w), _pd(want))
        assert np.array_equal(got, want)
        assert _rel(got, native.scatter_rhs_plain(idx, w, mmc, sign,
                                                  np.zeros(n))) < 1e-12
