"""The port's nested three-level Schur factors (parallel/schur.py:
NestedPartition .. NestedSchurFactors, nested_junction_cov and the
covariance refinement) against the JAX package's, on the blocked normals
of a 16 x 16 grid network in 4 x 4 tiles grouped 2 x 2 into super-blocks
(the system of tests/test_schur.py's nested tests, built by the JAX
package and carried to the port as numpy)."""

import dataclasses

import numpy as np
import pytest
import torch

from dynadjust_tpu.parallel import schur as JS
from dynadjust_tpu.parallel.blocked_adjust import (BlockedNetwork,
                                                   build_normals)
from dynadjust_tpu.utils.synthetic import (grid_segmentation,
                                           grid_super_assignment,
                                           synthetic_grid_network)
from dynadjust_tpu_torch.parallel import schur as PS

torch.set_num_threads(2)

FACTOR_NAMES = ("Ainv", "Y", "A2inv", "Y2", "Sinv", "di", "dj", "djg")
ROUTES = {"fused": "1e12", "chunked": "0"}     # DTA_NESTED_FUSE_BYTES


@pytest.fixture(scope="module")
def grid_system():
    rows, cols, blk = 16, 16, 4
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=3)
    blocks, junction = grid_segmentation(rows, cols, blk, blk)
    bn = BlockedNetwork(nstations=rows * cols, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    bs = build_normals(bn, x0, 0.01)
    sup = grid_super_assignment(rows, cols, blk, blk, 2, 2)
    pbs = PS.BlockSystem(**{f.name: getattr(bs, f.name)
                            for f in dataclasses.fields(PS.BlockSystem)
                            if not f.name.startswith("_")})
    return bs, pbs, sup, bn


@pytest.fixture(scope="module")
def partitions(grid_system):
    bs, pbs, sup, _ = grid_system
    return (PS.build_nested_partition(pbs, sup),
            JS.build_nested_partition(bs, sup))


def _rel(got, want):
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize(
    "field", [f.name for f in dataclasses.fields(PS.NestedPartition)])
def test_partition_matches_jax(partitions, field):
    ours, ref = partitions
    assert ours.nsj_global < len(ours.xj_kind)   # eliminates something
    a, b = getattr(ours, field), getattr(ref, field)
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _factors(monkeypatch, route, bs, part, dtype, package):
    monkeypatch.setenv("DTA_NESTED_FUSE_BYTES", ROUTES[route])
    if package == "jax":
        f = JS.NestedSchurFactors(bs, part, dtype=dtype)
    else:
        f = PS.NestedSchurFactors(bs, part, dtype=dtype, device="cpu")
    assert f._small == (route == "fused")
    return f


@pytest.mark.parametrize("against", ["jax", "flat"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_f64_solve_matches(monkeypatch, grid_system, partitions, route,
                           against):
    """float64 nested factors: one apply equals the JAX package's nested
    apply and its flat (two-level) solve, within 1e-9 relative."""
    bs, pbs, _, _ = grid_system
    ours_part, ref_part = partitions
    f = _factors(monkeypatch, route, pbs, ours_part, np.float64, "torch")
    xi, xj = f.solve(bs.bi, bs.bj)
    if against == "jax":
        ref = _factors(monkeypatch, route, bs, ref_part, np.float64, "jax")
        xi_r, xj_r = ref.solve(bs.bi, bs.bj)
    else:
        xi_r, xj_r = JS.schur_solve(bs)
    sc = max(np.abs(xi_r).max(), np.abs(xj_r).max())
    assert xi.shape == xi_r.shape and xj.shape == xj_r.shape
    assert np.abs(xi - xi_r).max() / sc < 1e-9
    assert np.abs(xj - xj_r).max() / sc < 1e-9


@pytest.fixture(scope="module", params=list(ROUTES))
def f32_pair(request, grid_system, partitions):
    bs, pbs, _, _ = grid_system
    mp = pytest.MonkeyPatch()
    try:
        ours = _factors(mp, request.param, pbs, partitions[0], np.float32,
                        "torch")
        ref = _factors(mp, request.param, bs, partitions[1], np.float32,
                       "jax")
    finally:
        mp.undo()
    return ours, ref


@pytest.mark.parametrize("k", range(len(FACTOR_NAMES)), ids=FACTOR_NAMES)
def test_f32_factors_match_jax(f32_pair, k):
    """float32 factors (the kernel's plain version on the CPU) against
    the JAX package's default level-1 backend: 1e-4 relative."""
    ours, ref = f32_pair
    a, b = ours.factors[k], np.asarray(ref.factors[k])
    assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
    assert _rel(a, b) < 1e-4


def test_f32_apply_matches_jax(f32_pair, grid_system):
    bs = grid_system[0]
    ours, ref = f32_pair
    xi, xj = ours.solve(bs.bi, bs.bj)
    xi_r, xj_r = ref.solve(bs.bi, bs.bj)
    sc = max(np.abs(xi_r).max(), np.abs(xj_r).max())
    assert np.abs(xi - xi_r).max() / sc < 1e-4
    assert np.abs(xj - xj_r).max() / sc < 1e-4


def _dense_inverse(bn):
    S = bn.nstations
    N = np.zeros((3 * S, 3 * S))
    for m, (i, j) in enumerate(bn.pairs):
        w = bn.weight[m]
        for k in range(3):
            N[3 * i + k, 3 * i + k] += w
            N[3 * j + k, 3 * j + k] += w
            N[3 * i + k, 3 * j + k] -= w
            N[3 * j + k, 3 * i + k] -= w
    wdiag = np.full(3 * S, 0.01)
    for s in bn.constrained:
        wdiag[3 * s:3 * s + 3] = 1e6
    return np.linalg.inv(N + np.diag(wdiag))


@pytest.fixture(scope="module")
def junction_cov_setup(grid_system, partitions):
    bs, pbs, _, bn = grid_system
    ours = PS.NestedSchurFactors(pbs, partitions[0], dtype=np.float64,
                                 device="cpu")
    ref = JS.NestedSchurFactors(bs, partitions[1], dtype=np.float64)
    jstn = np.asarray(bn.junction_stations)
    gparam = np.concatenate([[3 * s, 3 * s + 1, 3 * s + 2] for s in jstn])
    return ours, ref, _dense_inverse(bn), gparam


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_nested_junction_cov(junction_cov_setup, grid_system, which):
    """Level-2/3 block-inverse identities: the JAX package's
    nested_junction_cov (1e-12 relative) and the dense N^-1 junction
    sub-blocks (the bounds of tests/test_schur.py)."""
    bs = grid_system[0]
    ours, ref, Ninv, gparam = junction_cov_setup
    B = len(bs.Nii)
    b = {"first": 0, "middle": B // 2, "last": B - 1}[which]
    jm = bs.jmap[b][bs.jmask[b] > 0]
    C = ours.junction_cov(jm)
    assert _rel(C, ref.junction_cov(jm)) < 1e-12
    djg = ours.djg_np
    np.testing.assert_allclose(C * np.outer(djg[jm], djg[jm]),
                               Ninv[np.ix_(gparam[jm], gparam[jm])],
                               rtol=1e-6, atol=1e-12)


def test_newton_refined_cov_matches_f64(grid_system, partitions):
    """float32 factors Newton-refined in float64 (newton_refine_cov)
    give the float64 factors' level-1 inverses and junction covariances
    (unscaled: the scale vectors are float32 on one side) within 1e-9
    relative, and record their evidence."""
    bs, pbs, _, _ = grid_system
    f32 = PS.NestedSchurFactors(pbs, partitions[0], dtype=np.float32,
                                device="cpu")
    f32.newton_refine_cov()
    f64 = PS.NestedSchurFactors(pbs, partitions[0], dtype=np.float64,
                                device="cpu")
    ev = f32.cov_refine_evidence
    assert set(ev) == {"l1_err", "l1_rounds", "l2_err", "l3_err", "tol",
                       "max_rounds", "tier"}
    assert max(ev["l1_err"], ev["l2_err"], ev["l3_err"]) < 1e-8
    assert ev["l1_rounds"] >= 1
    def unscaled(f, b, jm):
        A, _, di = f.level1_block(b)
        djg = f.djg_np[jm]
        return (A * np.outer(di, di),
                f.junction_cov(jm) * np.outer(djg, djg))

    for b in (0, len(bs.Nii) - 1):
        jm = bs.jmap[b][bs.jmask[b] > 0]
        for got, want in zip(unscaled(f32, b, jm), unscaled(f64, b, jm)):
            assert _rel(got, want) < 1e-9
