"""Simultaneous (whole-of-network) least-squares adjustment.

Gauss-Newton iteration over the dense normal equations with rigorous
variance propagation and statistics, mirroring the reference's
AdjustSimultaneous flow.  The normals are formed and the measurement
update runs on the host in numpy; the scaled inverse and the solve run
on host LAPACK in float64 by default, or (``use_tpu``, the CLI's
``adjust --tpu``) on the device through parallel/dense_device.py: the
Cholesky-inverse kernel in float32 and two float64 Newton steps.  This
module also holds the result records and the per-row measurement
statistics that the blocked path (adjust/tpu_blocked.py) shares.

Parity reference: dnaadjust.cpp AdjustSimultaneous :2413, Solve :6586
(diagonal unity scaling :6614-6645), UpdateAdjustment :473,
ComputeStatistics :7116, ComputePrecisionAdjMsrs :7784,
UpdateMsrRecords :8083, ComputeGlobalPelzer :8302.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..geodesy.conversions import cart_to_geo, geo_to_cart
from ..network.data import NetworkData
from .assembler import Assembler, GpsItem, ScalarItem, DirnSetItem
from .options import AdjustmentOptions

UNRELIABLE = 999.99
STABLE_LIMIT = 700.0


@dataclass
class MsrStatRow:
    """Per-scalar-row adjusted measurement statistics (measurement record
    update analogue)."""
    rec_idx: int = 0            # original record order (file order)
    mtype: str = ""
    cardinal: str = " "
    s1: int = -1
    s2: int = -1
    s3: int = -1
    pre_adj_meas: float = 0.0
    measured: float = 0.0       # term1 (reduced measurement)
    adjusted: float = 0.0
    correction: float = 0.0
    meas_var: float = 0.0       # apriori variance (scaled)
    adj_prec: float = 0.0       # variance of adjusted measurement
    resid_prec: float = 0.0
    nstat: float = 0.0
    tstat: float = 0.0
    pelzer: float = 0.0
    pre_adj_corr: float = 0.0
    outlier: bool = False
    ignore: bool = False
    vcv3: object = None         # (3,3) apriori VCV (GPS X-row only)
    adj_vcv3: object = None     # (3,3) adjusted VCV (GPS X-row only)


@dataclass
class AdjustmentResult:
    status: str
    iterations: int
    max_corr: float
    chi_squared: float
    sigma_zero: float
    degrees_of_freedom: int
    measurement_count: int
    unknown_count: int
    chi_upper: float
    chi_lower: float
    pass_fail: str
    global_pelzer: float
    potential_outliers: int
    critical_value: float
    xyz: np.ndarray                 # (S, 3) adjusted cartesian
    lat: np.ndarray
    lon: np.ndarray
    height: np.ndarray              # ellipsoidal
    cov_xyz: np.ndarray             # (3S, 3S) a-posteriori covariance, or
                                    # None at national scale (see cov_stn)
    msr_stats: list = field(default_factory=list)
    # (S, 3, 3) per-station covariance blocks — the O(S) storage the
    # blocked paths always populate; the dense cov_xyz is only
    # materialised for small networks (the reference likewise extracts
    # per-block variances in phased mode, dnaadjust.cpp:6770)
    cov_stn: np.ndarray = None
    iteration_log: list = field(default_factory=list)
    # phased mode: [(block_no, inner_names, junction_names, msr_count)]
    block_info: list = None
    # a-priori cartesian coordinates captured before the adjustment
    # (corrections = adjusted - initial; initialLatitude parity)
    initial_xyz: np.ndarray = None
    oscillation: list = field(default_factory=list)
    elapsed: float = 0.0
    # per-phase wall-clock seconds: always on the dense route
    # (adjust_simultaneous), when DTA_PROFILE is set on the blocked one
    profile: dict = None
    # measured covariance-refinement residual evidence
    # (max|I - N*Ainv| per level, rounds used — parallel/schur.py
    # _newton_loop); the accuracy the formal SDs/.apu carry is recorded,
    # not assumed
    refine_evidence: dict = None
    # lazy block-scoped covariance access past the dense cap
    # (adjust/block_cov.BlockCovProvider) — the reference's phased-mode
    # per-block variance semantics (dnaadjust_printer.cpp:4330-4390)
    block_cov: object = None

    def station_cov(self, i: int) -> np.ndarray:
        """(3,3) cartesian covariance of station i."""
        if self.cov_stn is not None:
            return self.cov_stn[i]
        return self.cov_xyz[3 * i:3 * i + 3, 3 * i:3 * i + 3]

    def add_station_cov(self, i: int, V: np.ndarray) -> None:
        """Add a (3,3) block to station i's covariance (Type B)."""
        if self.cov_stn is not None:
            self.cov_stn[i] += V
        if self.cov_xyz is not None:
            self.cov_xyz[3 * i:3 * i + 3, 3 * i:3 * i + 3] += V


def _chi2_limits(dof: float, confidence: float):
    from scipy.stats import chi2
    conf = (100.0 - confidence) * 0.01 * 0.5
    upper = chi2.isf(conf, dof) / dof
    lower = chi2.ppf(conf, dof) / dof
    return lower, upper


def _critical_value(confidence: float):
    from scipy.stats import norm
    conf = confidence * 0.01
    conf += (1.0 - conf) / 2.0
    return norm.ppf(conf)


def _solve_normals(N, AtVinv_m, scale_to_unity: bool,
                   use_tpu: bool = False, device="cuda", record=None):
    """Invert the (constrained) normals and solve for corrections.

    Diagonal unity scaling combats the 12-orders-of-magnitude dynamic range
    that station constraints create (reference: Solve, :6604-6645).

    Default path: host LAPACK in f64.  use_tpu (--tpu): the float32
    Cholesky-inverse kernel with a Newton-refined f64 inverse on `device`
    (parallel/dense_device.py) — same f64-quality results; record gets
    its Newton rounds and residual appended.  The scalable blocked path
    is adjust/tpu_blocked.py.
    """
    if use_tpu:
        from ..parallel.dense_device import dense_solve_device
        return dense_solve_device(N, AtVinv_m, scale_to_unity,
                                  device=device, record=record)
    import scipy.linalg as sla
    n = N.shape[0]
    if scale_to_unity:
        s = 1.0 / np.sqrt(np.diag(N))
        Ns = N * s[:, None] * s[None, :]
    else:
        s = None
        Ns = N
    c, low = sla.cho_factor(Ns, lower=True)
    Ninv = sla.cho_solve((c, low), np.eye(n))
    if s is not None:
        Ninv = Ninv * s[:, None] * s[None, :]
    dx = Ninv @ AtVinv_m
    return Ninv, dx


def _form_normals(asm, Wc):
    """N = AᵀV⁻¹A + per-station 3x3 constraint blocks; AtVinv = AᵀV⁻¹
    (batched weight application — Assembler.atvinv)."""
    AtVinv = asm.atvinv()
    N = AtVinv @ asm.A
    for i in range(Wc.shape[0]):
        N[3 * i:3 * i + 3, 3 * i:3 * i + 3] += Wc[i]
    return N, AtVinv


def adjust_simultaneous(net: NetworkData,
                        options: AdjustmentOptions | None = None,
                        device="cuda") -> AdjustmentResult:
    """device: where the dense solve runs when options.use_tpu is set —
    "cuda" (the Cholesky-inverse kernel) or "cpu" (its plain PyTorch
    version); without use_tpu the solve is host LAPACK and device is not
    used."""
    opts = options or AdjustmentOptions()
    t0 = time.time()

    asm = Assembler(net, opts)
    S = net.nstations

    # estimated station vector from current geographic coordinates
    x, y, z = geo_to_cart(net.lat, net.lon, net.height, net.datum.ellipsoid)
    est = np.stack([x, y, z], axis=-1).reshape(-1)

    # checkpoint/resume: a long adjustment interrupted mid-run restarts
    # from the last completed iteration's estimates
    resume_iteration = 0
    if opts.checkpoint_file and os.path.exists(opts.checkpoint_file):
        ck = np.load(opts.checkpoint_file)
        if ck["est"].shape == est.shape:
            est = ck["est"]
            resume_iteration = int(ck["iteration"])

    # initial fill with one-time reductions
    initial_xyz = est.reshape(-1, 3).copy()
    asm.fill(est, apply_reductions=True)
    Wc = asm.constraint_weights()
    N, AtVinv = _form_normals(asm, Wc)
    t_setup = time.time() - t0

    unknown_count = asm.unknown_params()
    m_count = asm.measurement_count()

    from .diagnostics import OscillationTracker
    osc = OscillationTracker()
    prof = {"update_normals_ns": 0, "solve_ns": 0}
    newton = []         # the device solves' Newton rounds (use_tpu)
    import time as _time
    Ninv = None
    max_corr = np.inf
    status = "Converged"
    it_log = []
    iteration = 0

    for i in range(opts.max_iterations):
        iteration += 1
        _t_iter = _time.perf_counter()
        compute_inverse = (iteration < 2) or asm.has_non_gps
        rhs = AtVinv @ asm.mmc
        _t0 = _time.perf_counter_ns()
        if compute_inverse:
            Ninv, dx = _solve_normals(N, rhs, opts.scale_normals_to_unity,
                                      opts.use_tpu, device, newton)
        else:
            dx = Ninv @ rhs
        prof["solve_ns"] += _time.perf_counter_ns() - _t0
        if opts.verbose_level >= 3 and opts.debug_file:
            # matrix dumps (Solve, dnaadjust.cpp:6649-6716)
            with open(opts.debug_file, "a") as _dbg:
                _dbg.write(f"ITERATION {iteration}\n")
                _dbg.write(f"N ({N.shape[0]}x{N.shape[1]})\n")
                np.savetxt(_dbg, N, fmt="%.6e")
                _dbg.write("rhs\n")
                np.savetxt(_dbg, rhs[None], fmt="%.6e")
                _dbg.write("dx\n")
                np.savetxt(_dbg, dx[None], fmt="%.6e")
        est = est + dx
        imax = int(np.argmax(np.abs(dx)))
        max_corr = dx[imax]
        # e,n,up of the largest correction (the reference rotates the
        # max-correction station's dXYZ to local, dnaadjust.cpp:7404-7429)
        from ..geodesy.local_frame import rotate_cart_local
        _si = imax // 3
        _enu = rotate_cart_local(dx[3 * _si:3 * _si + 3],
                                 net.lat[_si], net.lon[_si])
        entry = {"iteration": iteration, "max_corr": float(max_corr),
                 "station": net.names[_si],
                 "enu": [float(v) for v in np.ravel(_enu)],
                 "elapsed": _time.perf_counter() - _t_iter}
        if opts.output_iter_stations:
            entry["est"] = est.copy()
        if opts.output_iter_adj_stat:
            # per-iteration chi-squared from the current residuals
            # (--output-iter-adj-stat; the reference prints the statistics
            # block each iteration)
            v = asm.mmc - asm.A @ dx
            chi_i = 0.0
            for r0, W3 in asm.weight_blocks():
                k = W3.shape[0]
                chi_i += float(v[r0:r0 + k] @ W3 @ v[r0:r0 + k])
            dof_i = max(m_count - unknown_count, 1)
            entry["stat"] = {"chi_sq": chi_i, "dof": dof_i,
                             "sigma0": chi_i / dof_i}
        if ((opts.output_iter_adj_msr or opts.output_iter_cmp_msr)
                and Ninv is not None):
            _update_geographic(net, est)
            asm.fill(est)
            rows_i, _, _, _, _ = _measurement_stats(
                asm, net, Ninv, est, _critical_value(
                    opts.confidence_interval))
            entry["msr_rows"] = rows_i
            entry["cmp_only"] = (opts.output_iter_cmp_msr and
                                 not opts.output_iter_adj_msr)
        it_log.append(entry)
        if opts.checkpoint_file:
            tmp = opts.checkpoint_file + ".tmp.npz"
            with open(tmp, "wb") as fh:
                np.savez(fh, est=est,
                         iteration=iteration + resume_iteration)
            os.replace(tmp, opts.checkpoint_file)
        osc.update(iteration, np.arange(S), dx, net.lat, net.lon)

        if abs(max_corr) <= opts.iteration_threshold:
            break

        # re-linearise for the next iteration
        _t0 = _time.perf_counter_ns()
        if asm.has_non_gps:
            _update_geographic(net, est)
            asm.fill(est)
            N, AtVinv = _form_normals(asm, Wc)
        else:
            asm.fill(est)
        prof["update_normals_ns"] += _time.perf_counter_ns() - _t0
    else:
        status = "Failed to converge"

    if abs(max_corr) > opts.iteration_threshold:
        status = "Failed to converge"

    if opts.profile:
        # PrintPerformanceProfile parity (dnaadjust.cpp:2562-2577)
        import sys as _sys
        print("dynadjust_tpu_torch profile timings: "
              f"update_normals={prof['update_normals_ns'] / 1e6:.3f}ms "
              f"solve={prof['solve_ns'] / 1e6:.3f}ms", file=_sys.stderr)

    # Final state refresh (UpdateAdjustment(false)): update geographic
    # coordinates, recompute design + meas-minus-comp, keep inverted normals
    _t_stats = _time.perf_counter()
    _update_geographic(net, est)
    asm.fill(est)

    # ----- statistics -----------------------------------------------------
    crit = _critical_value(opts.confidence_interval)
    stats_rows, chi_sq, potential_outliers, pelzer_sum, pelzer_n = \
        _measurement_stats(asm, net, Ninv, est, crit)
    # wall-clock seconds per phase: setup (assembler, first fill and
    # normals), update_normals (re-linearisation: fill + normals), solve,
    # stats (final fill + measurement statistics); with use_tpu, each
    # device solve's Newton record and the number on the float64 fallback
    phases = {"setup": t_setup,
              "update_normals": prof["update_normals_ns"] / 1e9,
              "solve": prof["solve_ns"] / 1e9,
              "stats": _time.perf_counter() - _t_stats}
    if opts.use_tpu:
        phases["newton"] = newton
        phases["f64_fallbacks"] = sum(r["route"] == "f64" for r in newton)

    dof = m_count - unknown_count
    sigma0 = chi_sq / dof if dof else 0.0
    for r in stats_rows:
        r.tstat = r.nstat / np.sqrt(sigma0) if sigma0 > 1e-20 else 0.0
    chi_lower, chi_upper = (_chi2_limits(dof, opts.confidence_interval)
                            if dof > 0 else (0.0, 0.0))
    if sigma0 < chi_lower:
        pass_fail = "WARNING"
    elif sigma0 > chi_upper:
        pass_fail = "FAILED"
    else:
        pass_fail = "PASSED"
    global_pelzer = (np.sqrt(pelzer_sum / pelzer_n) if pelzer_n
                     else UNRELIABLE)

    return AdjustmentResult(
        status=status, iterations=iteration, max_corr=float(max_corr),
        chi_squared=float(chi_sq), sigma_zero=float(sigma0),
        degrees_of_freedom=dof, measurement_count=m_count,
        unknown_count=unknown_count, chi_upper=chi_upper,
        chi_lower=chi_lower, pass_fail=pass_fail,
        global_pelzer=float(global_pelzer),
        potential_outliers=potential_outliers, critical_value=float(crit),
        xyz=est.reshape(-1, 3), lat=net.lat.copy(), lon=net.lon.copy(),
        height=net.height.copy(), cov_xyz=Ninv, msr_stats=stats_rows,
        initial_xyz=initial_xyz,
        iteration_log=it_log, oscillation=osc.summary(net.names),
        elapsed=time.time() - t0, profile=phases)


def _update_geographic(net: NetworkData, est: np.ndarray):
    xyz = est.reshape(-1, 3)
    la, lo, h = cart_to_geo(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                            net.datum.ellipsoid)
    net.lat, net.lon, net.height = la, lo, h


def _measurement_stats(asm: Assembler, net: NetworkData, Ninv: np.ndarray,
                       est: np.ndarray, crit: float,
                       adj_prec: np.ndarray = None, adj_vcv3: dict = None):
    """Adjusted measurement corrections, precisions, N-stats, chi-square.

    adj_prec/adj_vcv3: precomputed per-row adjusted variances and per-GNSS
    3×3 adjusted VCVs (device_stats.device_block_stats) — when given, the
    O(m·n²) host products are skipped and Ninv may be None.

    Parity: ComputePrecisionAdjMsrs + UpdateMsrRecords + ComputeChiSquare."""
    if getattr(asm, "_vector_plan", None) is not None:
        # reductions live in the vectorised bucket arrays; write them back
        # to the work items the reporting path reads
        asm._vector_plan.sync_items()
    A, mmc = asm.A, asm.mmc
    ANi = None
    if adj_prec is None:
        # diag(A Ninv Aᵀ) gives the adjusted-measurement variance per row
        ANi = A @ Ninv
        adj_prec = np.einsum("ij,ij->i", ANi, A)

    rows: list[MsrStatRow] = []
    chi_sq = 0.0
    outliers = 0
    pelzer_sum, pelzer_n = 0.0, 0

    def finish(r: MsrStatRow, row_idx: int):
        nonlocal outliers, pelzer_sum, pelzer_n
        r.correction = -mmc[row_idx]
        r.adjusted = r.measured + r.correction
        r.adj_prec = adj_prec[row_idx]
        r.resid_prec = abs(r.meas_var - r.adj_prec)
        r.pelzer = (np.sqrt(r.meas_var / r.resid_prec)
                    if r.resid_prec > 0 else UNRELIABLE)
        if r.pelzer < 0.0 or r.pelzer > STABLE_LIMIT:
            r.pelzer = UNRELIABLE
        else:
            pelzer_sum += r.pelzer * r.pelzer - 1.0
            pelzer_n += 1
        r.nstat = (r.correction / np.sqrt(r.resid_prec)
                   if r.resid_prec > 0 else 0.0)
        if abs(r.nstat) > crit:
            r.outlier = True
            outliers += 1
        rows.append(r)

    for item, rec_i in zip(asm.item_order, asm.item_record_idx):
        _row_start = len(rows)
        if isinstance(item, ScalarItem):
            r = MsrStatRow(mtype=item.mtype, s1=item.s1, s2=item.s2,
                           s3=item.s3, pre_adj_meas=item.pre_adj_meas,
                           measured=item.term1, meas_var=item.var,
                           pre_adj_corr=item.pre_adj_corr)
            finish(r, item.row)
            r.adjusted = _readjust_scalar(asm, net, item, r, est)
            chi_sq += mmc[item.row] ** 2 / item.var
        elif isinstance(item, DirnSetItem):
            for ang in item.angles:
                r = MsrStatRow(mtype="D", s1=ang.s1, s2=ang.s2, s3=ang.s3,
                               pre_adj_meas=ang.pre_adj_meas,
                               measured=ang.term1, meas_var=ang.var,
                               pre_adj_corr=ang.pre_adj_corr)
                finish(r, ang.row)
                # adjusted derived angle + deflection correction re-applied
                if r.adjusted > 2.0 * np.pi:
                    r.adjusted -= 2.0 * np.pi
                r.adjusted += ang.pre_adj_corr
                chi_sq += mmc[ang.row] ** 2 / ang.var
        elif isinstance(item, GpsItem):
            n = len(item.stations1)
            v = mmc[item.row0:item.row0 + 3 * n]
            chi_sq += float(v @ item.vinv @ v)
            for i in range(n):
                sl = slice(item.row0 + 3 * i, item.row0 + 3 * i + 3)
                if ANi is not None:
                    av3 = ANi[sl] @ A[sl].T
                else:
                    av3 = adj_vcv3[item.row0 + 3 * i]
                vcv3 = item.vcv[3 * i:3 * i + 3, 3 * i:3 * i + 3]
                for k, card in enumerate("XYZ"):
                    ri = item.row0 + 3 * i + k
                    r = MsrStatRow(
                        mtype=item.mtype, cardinal=card,
                        s1=item.stations1[i],
                        s2=item.stations2[i] if item.stations2 else -1,
                        pre_adj_meas=item.pre_adj_meas[3 * i + k],
                        measured=item.obs[3 * i + k],
                        meas_var=item.vcv[3 * i + k, 3 * i + k],
                        pre_adj_corr=0.0)
                    if k == 0:
                        r.vcv3 = np.asarray(vcv3)
                        r.adj_vcv3 = np.asarray(av3)
                    finish(r, ri)
        for r in rows[_row_start:]:
            r.rec_idx = rec_i
    return rows, chi_sq, outliers, pelzer_sum, pelzer_n


def _readjust_scalar(asm: Assembler, net: NetworkData, item: ScalarItem,
                     r: MsrStatRow, est):
    """Type-specific re-reduction of the adjusted measurement for
    reporting (UpdateMsrRecord, dnaadjust.cpp:8187-8268)."""
    from ..geodesy import measurements as gm
    adj = r.adjusted
    t = item.mtype
    ell = asm.ell
    if t == "E":
        s1, s2 = item.s1, item.s2
        l1, l2 = asm.loc3(s1), asm.loc3(s2)
        p1 = est[l1:l1 + 3]
        p2 = est[l2:l2 + 3]
        adj = gm.ellipsoid_chord_to_arc(adj, *p1, *p2, asm.cur_lat[s1],
                                        asm.cur_lon[s1], asm.cur_lat[s2],
                                        ell)
    elif t == "M":
        s1, s2 = item.s1, item.s2
        adj = gm.ellipsoid_chord_to_msl_arc(
            adj, asm.cur_lat[s1], asm.cur_lat[s2],
            net.geoid_sep[s1], net.geoid_sep[s2], ell)
    elif t in ("H", "L", "V"):
        adj -= item.pre_adj_corr
    elif t in ("A", "I", "J", "K", "Z"):
        adj += item.pre_adj_corr
    r.adjusted = adj
    return adj
