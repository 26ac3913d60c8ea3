"""The port's host routes against the JAX package's, on the CPU:

  * the host-streamed nested factors (parallel/streamed.py), both
    refine_inline routes, on the blocked normals of tests/test_schur.py's
    16 x 16 grid network (4 x 4 tiles grouped 2 x 2), built by the JAX
    package and carried to the port as numpy — the bounds of
    tests/test_schur.py's test_nested_schur_streamed (:278),
    test_streamed_refined_factors_residual (:352) and
    test_streamed_inline_refine_matches_two_phase (:454);
  * the host residual operator and the host refinement loops
    (schur_solve_device_refined, schur_solve_nested_factored);
  * adjust_tpu_blocked with staged=True (super_blocks 0 and 2, both
    DTA_STREAMED_F64 settings) on the 12 x 12 mixed network, at the
    bounds of tests/test_device_assembly.py:108-127;
  * adjust_phased (plain, block1, .mtx-staged) field by field.

The JAX package's staged nested covariances differ from its resident
ones by about 1e-7 relative (ROADMAP.md F4: they unscale with other
scale vectors than their pools were refined against); the port's staged
covariances are held to the JAX package's resident nested run at 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dynadjust_tpu.adjust as JA
from dynadjust_tpu.adjust.phased import adjust_phased as jax_phased
from dynadjust_tpu.adjust.tpu_blocked import \
    adjust_tpu_blocked as jax_adjust
from dynadjust_tpu.parallel import schur as JS
from dynadjust_tpu.parallel.blocked_adjust import (BlockedNetwork,
                                                   build_normals)
from dynadjust_tpu.segment import segment_network as jax_segment
from dynadjust_tpu.utils.synthetic import (grid_segmentation,
                                           grid_super_assignment,
                                           synthetic_grid_network)
from dynadjust_tpu.utils.synthetic_mixed import \
    synthetic_mixed_network as jsynth
from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.phased import adjust_phased
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.parallel import schur as PS
from dynadjust_tpu_torch.parallel.streamed import \
    StreamedNestedSchurFactors
from dynadjust_tpu_torch.segment import segment_network

torch.set_num_threads(2)

INLINE = {"two_phase": False, "inline": True}


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
    pbs = PS.BlockSystem(**{f.name: getattr(bs, f.name)
                            for f in dataclasses.fields(PS.BlockSystem)
                            if not f.name.startswith("_")})
    sup = grid_super_assignment(rows, cols, blk, blk, 2, 2)
    xi, xj = JS.schur_solve(bs)
    return (bs, JS.build_nested_partition(bs, sup), pbs,
            PS.build_nested_partition(pbs, sup),
            (np.asarray(xi, np.float64), np.asarray(xj, np.float64)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _streamed_pair(grid_system, route, chunk=3):
    """(port, JAX) streamed factors, float64-refined on both routes."""
    bs, jpart, pbs, ppart, _ = grid_system
    inline = INLINE[route]
    ours = StreamedNestedSchurFactors(pbs, ppart, chunk=chunk,
                                      refine_inline=inline, device="cpu")
    ref = JS.StreamedNestedSchurFactors(bs, jpart, chunk=chunk,
                                        refine_inline=inline)
    return ours, ref


def _residual(pbs, xi, xj):
    yi, yj = PS._block_matvec(pbs, xi, xj)
    ri = np.abs(pbs.bi * pbs.imask - yi).max()
    rj = np.abs(PS._gather_rhs_junction(pbs) - yj).max()
    return max(ri, rj) / max(np.abs(pbs.bi).max(), 1.0)


@pytest.mark.parametrize("route", list(INLINE))
def test_streamed_pools_match_jax(grid_system, route):
    """The host pools: the two-phase float32 factors (Ainv_h, Y_h) within
    1e-4, the float64-refined level-1 pools (_cov_l1_h) and level-2/3
    pools (_l2_host) within 1e-9, the evidence with the JAX package's
    fields."""
    ours, ref = _streamed_pair(grid_system, route)
    assert ours.C == ref.C < len(grid_system[2].Nii)   # really chunked
    if route == "two_phase":
        assert _rel(ours.Ainv_h.numpy(), ref.Ainv_h) < 1e-4
        assert _rel(ours.Y_h.numpy(), ref.Y_h) < 1e-4
        ours.newton_refine_cov()
        ref.newton_refine_cov()
    for a, b in zip(ours._cov_l1_h, ref._cov_l1_h):
        assert a.dtype == np.float64 and _rel(a, b) < 1e-9
    for a, b in zip(ours._l2_host, ref._l2_host):
        assert _rel(a, b) < 1e-9
    ev = ours.cov_refine_evidence
    assert set(ev) == set(ref.cov_refine_evidence)
    assert ev["l1_err"] < 1e-10 and ev["l3_err"] < 1e-10


@pytest.mark.parametrize("route", list(INLINE))
def test_streamed_solve_matches_flat(grid_system, route):
    """test_nested_schur_streamed's bound (1e-7 against the flat
    solve) on the float32 factors, then the refined factors' solve with
    one refinement round: relative residual under 1e-11."""
    *_, pbs, ppart, (xi, xj) = grid_system
    f = StreamedNestedSchurFactors(pbs, ppart, chunk=3,
                                   refine_inline=INLINE[route],
                                   device="cpu")
    xs, xjs, _ = PS.schur_solve_nested_factored(pbs, ppart, refine=2,
                                                factors=f)
    np.testing.assert_allclose(xs, xi, atol=1e-7)
    np.testing.assert_allclose(xjs, xj, atol=1e-7)
    f.newton_refine_cov()
    xs, xjs, _ = PS.schur_solve_nested_factored(pbs, ppart, refine=1,
                                                factors=f)
    assert _residual(pbs, xs, xjs) < 1e-11


@pytest.mark.parametrize("route", list(INLINE))
def test_streamed_chunked_equals_unchunked(grid_system, route):
    """C < B and C = B stream different chunkings of the same math."""
    *_, pbs, ppart, _ = grid_system
    out = []
    for chunk in (3, len(pbs.Nii)):
        f = StreamedNestedSchurFactors(pbs, ppart, chunk=chunk,
                                       refine_inline=INLINE[route],
                                       device="cpu")
        f.newton_refine_cov()
        out.append((f.C, f._cov_l1_h[0], f.solve(pbs.bi, pbs.bj)))
    (c0, A0, (x0, j0)), (c1, A1, (x1, j1)) = out
    assert c0 < c1 == len(pbs.Nii)
    assert _rel(A0, A1) < 1e-12
    assert _rel(x0, x1) < 1e-12 and _rel(j0, j1) < 1e-12


@pytest.mark.parametrize("route", list(INLINE))
def test_streamed_device_apply_matches_host_apply(grid_system, route,
                                                  monkeypatch):
    """DTA_STREAM_APPLY=device streams the refined pools through the
    device; the apply equals the host float64 apply."""
    *_, pbs, ppart, _ = grid_system
    f = StreamedNestedSchurFactors(pbs, ppart, chunk=3,
                                   refine_inline=INLINE[route],
                                   device="cpu")
    f.newton_refine_cov()
    xh, jh = f.solve(pbs.bi, pbs.bj)
    monkeypatch.setenv("DTA_STREAM_APPLY", "device")
    xd, jd = f.solve(pbs.bi, pbs.bj)
    assert _rel(xd, xh) < 1e-12 and _rel(jd, jh) < 1e-12


def test_block_matvec_matches_jax(grid_system):
    bs, _, pbs, _, _ = grid_system
    rng = np.random.default_rng(5)
    xi = rng.standard_normal(pbs.bi.shape)
    xj = rng.standard_normal(pbs.nj_global)
    for a, b in zip(PS._block_matvec(pbs, xi, xj),
                    JS._block_matvec(bs, xi, xj)):
        assert _rel(a, b) < 1e-13


def test_gather_rhs_junction_matches_jax(grid_system):
    bs, _, pbs, _, _ = grid_system
    assert _rel(PS._gather_rhs_junction(pbs),
                JS._gather_rhs_junction(bs)) < 1e-13


def test_device_refined_matches_jax(grid_system):
    """The flat host loop over float32 factors of host normals reaches
    the float64 solve, as the JAX package's does."""
    bs, _, pbs, _, (xi, xj) = grid_system
    f = PS.DeviceSchurFactors(pbs, device="cpu")
    ours = PS.schur_solve_device_refined(pbs, f)
    jf = JS.DeviceSchurFactors(bs, method="inv", device_f64=False)
    ref = JS.schur_solve_device_refined(bs, jf)
    for a, b, want in zip(ours, ref, (xi, xj)):
        assert np.abs(a - b).max() < 1e-9
        assert np.abs(a - want).max() < 1e-9


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_nested_factored_matches_jax(grid_system, streamed):
    bs, jpart, pbs, ppart, (xi, xj) = grid_system
    xs, xjs, f = PS.schur_solve_nested_factored(
        pbs, ppart, streamed=streamed, device="cpu")
    rs, rjs, _ = JS.schur_solve_nested_factored(bs, jpart,
                                                streamed=streamed)
    assert isinstance(f, StreamedNestedSchurFactors) == streamed
    assert np.abs(xs - rs).max() < 1e-9 and np.abs(xjs - rjs).max() < 1e-9
    assert np.abs(xs - xi).max() < 1e-9 and np.abs(xjs - xj).max() < 1e-9


# ---- adjustments on the 12 x 12 mixed network ------------------------------

NET = dict(rows=12, cols=12, block_rows=6, block_cols=6)
STAGED = {"sb0": (0, "1"), "sb2-inline": (2, "1"),
          "sb2-two_phase": (2, "0")}      # super_blocks, DTA_STREAMED_F64


@pytest.fixture(scope="module")
def staged_runs():
    """case -> (port staged, JAX staged, JAX resident) results."""
    cache = {}

    def run(case):
        if case in cache:
            return cache[case]
        sb, f64 = STAGED[case]
        mp = pytest.MonkeyPatch()
        try:
            mp.setenv("DTA_STREAMED_F64", f64)
            net, seg = jsynth(**NET)
            ours_net, ours_seg = from_reference(net, seg)
            ours = adjust_tpu_blocked(ours_net, AdjustmentOptions(),
                                      seg=ours_seg, super_blocks=sb,
                                      staged=True, device="cpu")
            ref = jax_adjust(net, JA.AdjustmentOptions(), seg=seg,
                             super_blocks=sb, staged=True)
            net, seg = jsynth(**NET)
            resident = jax_adjust(net, JA.AdjustmentOptions(), seg=seg,
                                  super_blocks=sb)
        finally:
            mp.undo()
        cache[case] = (ours, ref, resident)
        return cache[case]
    return run


@pytest.mark.parametrize("case", list(STAGED))
def test_staged_adjustment_matches_jax(staged_runs, case):
    """Iterations, xyz 1e-7 m and sigma zero 1e-9 against the JAX
    package's staged run; station covariances 1e-9 relative against its
    resident run (its staged nested covariances are 1e-7 off, F4)."""
    ours, ref, resident = staged_runs(case)
    assert ours.status == ref.status == "Converged"
    assert ours.iterations == ref.iterations == resident.iterations
    assert np.abs(ours.xyz - ref.xyz).max() < 1e-7
    assert abs(ours.sigma_zero - ref.sigma_zero) < 1e-9
    sc = np.abs(resident.cov_stn).max()
    assert np.abs(ours.cov_stn - resident.cov_stn).max() / sc < 1e-9
    if case == "sb0":
        assert np.abs(ours.cov_stn - ref.cov_stn).max() / sc < 1e-9
    assert (ours.degrees_of_freedom, ours.measurement_count,
            ours.unknown_count) == (ref.degrees_of_freedom,
                                    ref.measurement_count,
                                    ref.unknown_count)
    assert all("solve_rel" not in it for it in ours.iteration_log)


@pytest.mark.parametrize("case", list(STAGED))
def test_staged_measurement_stats_match_jax(staged_runs, case):
    """Adjusted-measurement precisions 1e-9 relative against the JAX
    package's resident run (tests/test_torch_adjust.py's bounds)."""
    ours, _, resident = staged_runs(case)
    assert len(ours.msr_stats) == len(resident.msr_stats)
    for a, b in zip(ours.msr_stats, resident.msr_stats):
        assert (a.rec_idx, a.mtype, a.cardinal) == \
            (b.rec_idx, b.mtype, b.cardinal)
        assert abs(a.adj_prec - b.adj_prec) <= \
            1e-9 * abs(b.adj_prec) + 1e-18
        assert abs(a.nstat - b.nstat) <= 1e-6 * abs(b.nstat) + 1e-9


@pytest.mark.parametrize("case", ["sb2-inline", "sb2-two_phase"])
def test_staged_refinement_evidence(staged_runs, case):
    ours, ref, _ = staged_runs(case)
    ev = ours.refine_evidence
    assert set(ev) == set(ref.refine_evidence)
    assert ev["l1_err"] < 1e-8 and ev["l3_err"] < 1e-8


# ---- the host sequential phased adjustment ---------------------------------

PHASED = {"plain": {}, "block1": {"block1": True}, "staged": {}}


def _fields_equal(ours, ref, exact):
    """Every field of the two results: exact where the arithmetic is the
    same numpy on the same inputs, else to 1e-9 relative."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name in ("elapsed", "profile", "block_cov",
                      "refine_evidence"):
            continue
        if f.name == "iteration_log":
            assert [{k: v for k, v in e.items() if k != "elapsed"}
                    for e in a] == \
                [{k: v for k, v in e.items() if k != "elapsed"}
                 for e in b]
        elif f.name == "msr_stats":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                for g in dataclasses.fields(y):
                    u, v = getattr(x, g.name), getattr(y, g.name)
                    if isinstance(v, np.ndarray):
                        assert np.array_equal(u, v), g.name
                    else:
                        assert u == v, g.name
        elif isinstance(b, np.ndarray):
            assert a.shape == b.shape, f.name
            if exact:
                assert np.array_equal(a, b), f.name
            else:
                assert _rel(a, b) < 1e-9, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", list(PHASED))
def test_adjust_phased_matches_jax(case, tmp_path):
    """adjust_phased field by field (host numpy on both sides); staged
    offloads each block's normals to .mtx files under stage_dir."""
    kw = dict(PHASED[case])
    if case == "staged":
        kw.update(stage_dir=str(tmp_path / "ours"), stage_name="n")
    # the sequential sweeps carry junctions from block to block: the
    # segmenter's chain of blocks, not the synthetic grid tiles
    net, _ = jsynth(**NET)
    seg = jax_segment(net, min_inner_stns=30, max_block_stns=60)
    ours_net, ours_seg = from_reference(net, seg)
    assert ours_seg == segment_network(ours_net, min_inner_stns=30,
                                       max_block_stns=60)
    assert seg.block_count > 2
    ours = adjust_phased(ours_net, AdjustmentOptions(), seg=ours_seg, **kw)
    if case == "staged":
        kw["stage_dir"] = str(tmp_path / "ref")
        assert len(list((tmp_path / "ours" / "n.mtx").iterdir())) == \
            2 * seg.block_count
    ref = jax_phased(net, JA.AdjustmentOptions(), seg=seg, **kw)
    if case == "block1":
        assert ours.status.startswith("Estimates solved for Block 1")
    else:
        assert ours.status == "Converged"
    _fields_equal(ours, ref, exact=True)
