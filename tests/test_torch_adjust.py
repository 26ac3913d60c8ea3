"""The port's whole blocked adjustment (adjust_tpu_blocked, two-level
and nested) against the JAX package's on one network, on the device
route and on the host routes (host assembly, the host refinement loop),
its route rule, and the port's synthetic network generator against the
JAX one."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dynadjust_tpu.adjust as JA
from dynadjust_tpu.adjust.tpu_blocked import \
    adjust_tpu_blocked as jax_adjust
from dynadjust_tpu.utils.synthetic_mixed import \
    synthetic_mixed_network as jsynth
from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.device_solve import (pool_bytes,
                                                     want_device_solve)
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.utils.synthetic_mixed import \
    synthetic_mixed_network

torch.set_num_threads(2)

NET = dict(rows=12, cols=12, block_rows=6, block_cols=6)


def _pair(device_stats: bool, super_blocks: int = 0):
    mp = pytest.MonkeyPatch()
    try:
        if device_stats:
            mp.setenv("DTA_DENSE_COV_MAX_STN", "1")
        else:
            mp.delenv("DTA_DENSE_COV_MAX_STN", raising=False)
        net, seg = jsynth(**NET)
        ours_net, ours_seg = from_reference(net, seg)
        ours = adjust_tpu_blocked(ours_net, AdjustmentOptions(),
                                  seg=ours_seg, super_blocks=super_blocks,
                                  device="cpu")
        ref = jax_adjust(net, JA.AdjustmentOptions(), seg=seg,
                         super_blocks=super_blocks)
    finally:
        mp.undo()
    return ours, ref


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(device_stats=False)


@pytest.fixture(scope="module")
def stats_pair():
    return _pair(device_stats=True)


@pytest.fixture(scope="module")
def nested_pairs():
    """super_blocks=2: host statistics (dense covariance) and, past
    DTA_DENSE_COV_MAX_STN, the nested device statistics."""
    return {"dense": _pair(False, super_blocks=2),
            "device_stats": _pair(True, super_blocks=2)}


def _pair_of(which, dense_pair, stats_pair, nested_pairs):
    if which.startswith("nested-"):
        return nested_pairs[which[len("nested-"):]]
    return dense_pair if which == "dense" else stats_pair


# two-level, then nested (super_blocks=2)
PAIRS = ["dense", "device_stats", "nested-dense", "nested-device_stats"]


@pytest.mark.parametrize("which", PAIRS)
def test_adjustment_matches_jax(dense_pair, stats_pair, nested_pairs,
                                which):
    """The bounds of tests/test_device_assembly.py's
    test_end_to_end_device_vs_host: xyz 1e-7 m, sigma0 1e-9, station
    covariances 1e-9 relative (float64-refined solves and covariances)."""
    ours, ref = _pair_of(which, dense_pair, stats_pair, nested_pairs)
    assert ours.status == ref.status == "Converged"
    assert ours.iterations == ref.iterations
    assert np.abs(ours.xyz - ref.xyz).max() < 1e-7
    assert abs(ours.sigma_zero - ref.sigma_zero) < 1e-9
    sc = np.abs(ref.cov_stn).max()
    assert np.abs(ours.cov_stn - ref.cov_stn).max() / sc < 1e-9
    assert (ours.degrees_of_freedom, ours.measurement_count,
            ours.unknown_count) == (ref.degrees_of_freedom,
                                    ref.measurement_count,
                                    ref.unknown_count)


@pytest.mark.parametrize("which", PAIRS)
def test_measurement_stats_match_jax(dense_pair, stats_pair, nested_pairs,
                                     which):
    """Adjusted-measurement precisions and GNSS VCVs: 1e-9 relative (the
    bounds of test_device_stats_match_host)."""
    ours, ref = _pair_of(which, dense_pair, stats_pair, nested_pairs)
    assert len(ours.msr_stats) == len(ref.msr_stats)
    for a, b in zip(ours.msr_stats, ref.msr_stats):
        assert (a.rec_idx, a.mtype, a.cardinal) == \
            (b.rec_idx, b.mtype, b.cardinal)
        assert abs(a.adj_prec - b.adj_prec) <= \
            1e-9 * abs(b.adj_prec) + 1e-18
        assert abs(a.nstat - b.nstat) <= 1e-6 * abs(b.nstat) + 1e-9
        if b.adj_vcv3 is not None:
            assert np.abs(a.adj_vcv3 - b.adj_vcv3).max() <= \
                1e-9 * np.abs(b.adj_vcv3).max() + 1e-18


def test_dense_covariance_matches_jax(dense_pair):
    ours, ref = dense_pair
    assert ours.cov_xyz is not None and ours.block_cov is None
    sc = np.abs(ref.cov_xyz).max()
    assert np.abs(ours.cov_xyz - ref.cov_xyz).max() / sc < 1e-9


def test_block_covariance_provider(dense_pair, stats_pair):
    """Past the dense cap the within-block covariances come from the
    retained factors and equal the dense route's."""
    dense, _ = dense_pair
    blocked, _ = stats_pair
    assert blocked.cov_xyz is None and blocked.block_cov is not None
    bc = blocked.block_cov
    sc = np.abs(dense.cov_xyz).max()
    checked = 0
    for i in (0, 7, 33, 60):
        for j in bc.partners(i):
            j = int(j)
            if j <= i:
                continue
            C = bc.pair_cov(i, j)
            Cd = dense.cov_xyz[3 * i:3 * i + 3, 3 * j:3 * j + 3]
            assert np.abs(C - Cd).max() <= 1e-9 * sc
            checked += 1
    assert checked > 10


def test_solve_and_refinement_evidence_recorded(dense_pair):
    """Per-iteration solve_rel/solve_rounds in the iteration log and the
    covariance refinement's measured residuals on the result."""
    ours, ref = dense_pair
    for it in ours.iteration_log:
        assert it["solve_rel"] < 1e-9          # rtol 1e-10 + stall slack
        assert 0 <= it["solve_rounds"] <= 12
    ev = ours.refine_evidence
    assert ev["l1_err"] < 1e-8 and ev["l1_rounds"] >= 1
    assert ev["junction_err"] < 1e-8


@pytest.mark.parametrize("stats", ["dense", "device_stats"])
def test_nested_refinement_evidence_recorded(nested_pairs, stats):
    """The bounds of tests/test_device_assembly.py's
    test_solve_and_refinement_evidence_recorded on the nested path."""
    ours, ref = nested_pairs[stats]
    assert ours.status == "Converged"
    for it in ours.iteration_log:
        assert it["solve_rel"] < 1e-9          # rtol 1e-10 + stall slack
        assert 0 <= it["solve_rounds"] <= 12
    ev = ours.refine_evidence
    assert set(ev) == set(ref.refine_evidence)
    assert ev["l1_err"] < 1e-8 and ev["l1_rounds"] >= 1
    assert ev["l2_err"] < 1e-8 and ev["l3_err"] < 1e-8


def test_nested_block_covariance_provider(nested_pairs):
    """Past the dense cap the nested within-block covariances equal the
    nested dense route's."""
    dense, _ = nested_pairs["dense"]
    blocked, _ = nested_pairs["device_stats"]
    assert blocked.cov_xyz is None and blocked.block_cov is not None
    bc = blocked.block_cov
    sc = np.abs(dense.cov_xyz).max()
    for i in (0, 7, 33, 60):
        for j in bc.partners(i):
            j = int(j)
            Cd = dense.cov_xyz[3 * i:3 * i + 3, 3 * j:3 * j + 3]
            assert np.abs(bc.pair_cov(i, j) - Cd).max() <= 1e-9 * sc


@pytest.mark.parametrize("case", ["without_nested", "wrong_length"])
def test_block_super_validation(case):
    """As tests/test_device_assembly.py's test_block_super_validation: an
    explicit block_super is length-checked, and passing it without the
    nested path fails loudly."""
    net, seg = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4)
    sb, n = (0, seg.block_count) if case == "without_nested" else \
        (2, seg.block_count - 1)
    with pytest.raises(ValueError, match="block_super"):
        adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                           super_blocks=sb,
                           block_super=np.zeros(n, dtype=np.int64),
                           device="cpu")


@pytest.mark.parametrize("env", [("DTA_HOST_ASSEMBLY", "1"),
                                 ("DTA_DEVICE_SOLVE", "0"),
                                 ("DTA_DEVICE_SOLVE_BYTES", "1")],
                         ids=lambda e: e[0])
def test_host_routes_match_jax(monkeypatch, env):
    """Where the JAX package leaves the device route for host assembly
    or its host refinement loop, the port takes the same route and
    matches it at test_adjustment_matches_jax's bounds (xyz 1e-7 m,
    sigma zero 1e-9, station covariances 1e-9 relative, the same
    iterations) and its measurement statistics at
    test_measurement_stats_match_jax's."""
    monkeypatch.setenv(*env)
    monkeypatch.setenv("DTA_PROFILE", "1")
    net, seg = jsynth(**NET)
    ours_net, ours_seg = from_reference(net, seg)
    ours = adjust_tpu_blocked(ours_net, AdjustmentOptions(), seg=ours_seg,
                              device="cpu")
    ref = jax_adjust(net, JA.AdjustmentOptions(), seg=seg)
    route = ours.profile["route"]
    assert route["solve"] == "host loop"
    assert route["assembly"] == ("host" if env[0] == "DTA_HOST_ASSEMBLY"
                                 else "device")
    assert all("solve_rel" not in it for it in ours.iteration_log)
    assert ours.status == ref.status == "Converged"
    assert ours.iterations == ref.iterations
    assert np.abs(ours.xyz - ref.xyz).max() < 1e-7
    assert abs(ours.sigma_zero - ref.sigma_zero) < 1e-9
    sc = np.abs(ref.cov_stn).max()
    assert np.abs(ours.cov_stn - ref.cov_stn).max() / sc < 1e-9
    assert len(ours.msr_stats) == len(ref.msr_stats)
    for a, b in zip(ours.msr_stats, ref.msr_stats):
        assert abs(a.adj_prec - b.adj_prec) <= \
            1e-9 * abs(b.adj_prec) + 1e-18
        assert abs(a.nstat - b.nstat) <= 1e-6 * abs(b.nstat) + 1e-9


def test_device_solve_budget(monkeypatch):
    """The route rule of the JAX package's want_device_solve: the 10k
    network's design pool (9 blocks, 9,413 rows, 3,876 columns) is under
    the 8e9-byte default and goes to the device, 90 such blocks go to the
    host loop, and DTA_DEVICE_SOLVE=1 and 0 force each route."""
    ten_k = SimpleNamespace(Bp=9, M=9413, Pp=3876)
    assert pool_bytes(ten_k) == 9 * 9413 * 3876 * 8.0
    big = SimpleNamespace(Bp=90, M=9413, Pp=3876)
    assert want_device_solve(ten_k) and not want_device_solve(big)
    monkeypatch.setenv("DTA_DEVICE_SOLVE", "1")
    assert want_device_solve(big)
    monkeypatch.setenv("DTA_DEVICE_SOLVE", "0")
    assert not want_device_solve(ten_k)


def test_profile_phases(monkeypatch):
    monkeypatch.setenv("DTA_PROFILE", "1")
    net, seg = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4)
    res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                             device="cpu")
    keys = {"setup", "fill", "normals", "rhs", "build", "factor", "solve",
            "update", "stats"}
    assert keys <= set(res.profile)
    assert set(res.profile["stats_sub"]) == {
        "stats.f64build", "stats.newton", "stats.device", "stats.host"}
    for it in res.iteration_log:
        assert keys <= set(it["phases"])


def _records_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "obs":
            assert len(x) == len(y)
            for o1, o2 in zip(x, y):
                _records_equal(o1, o2)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("size", [(12, 12, 6, 6, 0), (20, 17, 7, 5, 4)])
def test_synthetic_network_equals_jax(size):
    rows, cols, br, bc, seed = size
    net, seg, X = synthetic_mixed_network(rows, cols, block_rows=br,
                                          block_cols=bc, seed=seed,
                                          return_truth=True)
    jnet, jseg, jX = jsynth(rows, cols, block_rows=br, block_cols=bc,
                            seed=seed, return_truth=True)
    assert np.array_equal(X, jX)
    for k in ("lat", "lon", "height", "initial_height", "height_ref"):
        assert np.array_equal(getattr(net, k), getattr(jnet, k)), k
    assert net.names == jnet.names
    assert net.constraints == jnet.constraints
    assert (net.datum.frame, net.datum.epoch) == \
        (jnet.datum.frame, jnet.datum.epoch)
    assert len(net.measurements) == len(jnet.measurements)
    for a, b in zip(net.measurements, jnet.measurements):
        _records_equal(a, b)
    for k in ("inner_stations", "junction_stations", "measurements",
              "networks"):
        assert getattr(seg, k) == getattr(jseg, k), k


def test_from_reference_rebuilds_records():
    jnet, jseg = jsynth(**NET)
    net, seg = from_reference(jnet, jseg)
    ref_net, ref_seg = synthetic_mixed_network(**NET)
    for a, b in zip(net.measurements, ref_net.measurements):
        assert type(a) is type(b)
        _records_equal(a, b)
    assert seg == ref_seg
