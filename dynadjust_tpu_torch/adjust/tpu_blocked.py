"""Blocked Schur adjustment (two-level, or nested three-level) of real
(all-measurement-type) networks on one device.

The replacement for the reference's phased adjustment
(`adjust --phased`): instead of the strictly sequential
forward/reverse/combine sweeps with junction pseudo-measurement carries
(AdjustPhased, dnaadjust.cpp:2579), the segmented blocks are eliminated
simultaneously by the batched two-level Schur solver (parallel/schur.py):

  * every block's inner stations eliminated in one batched
    factorization (the Cholesky-inverse kernel, ops/chol_inv.py);
  * the global junction system assembled by scatter and solved once;
  * per-block covariances recovered from the explicit factors
    (N^-1_ii = Aii^-1 + Y S^-1 Y^T etc.), giving the same rigorous
    per-block variances the reference's combine pass produces.

The result is algebraically the simultaneous solution — which is exactly
what the reference's phased mode converges to and cross-checks against.

Port of the JAX package's ``adjust/tpu_blocked.py::adjust_tpu_blocked``
on one device, two-level (``super_blocks=0``) and nested
(``super_blocks>0``), with its routes: device assembly (default) or host
assembly (DTA_HOST_ASSEMBLY=1, and always when staged); the device
refined solve while the float64 design pool fits DTA_DEVICE_SOLVE_BYTES
(adjust/device_solve.py::want_device_solve), else the host refinement
loop of parallel/schur.py; resident or host-streamed (staged) nested
factors.  The JAX package's mesh (multi-device) route is not part of
this package.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..network.data import NetworkData
from ..segment import Segmentation, segment_network
from ..geodesy.conversions import geo_to_cart, cart_to_geo
from ..geodesy.local_frame import rotate_cart_local
from .options import AdjustmentOptions
from .simultaneous import (AdjustmentResult, _measurement_stats,
                           _critical_value, _chi2_limits, UNRELIABLE)
from .phased import Block, _add_constraints, _block_normals, \
    _first_appearances


def _host(x):
    """float64 numpy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _block_cov_from_factors(factors, b, ki, kj, inner_idx, junc_idx,
                            jmap_b, jmask_b):
    """Full (3k, 3k) covariance of block b's parameters from the explicit
    Schur factors (f32, unity-scaled): N^-1_ii = Ainv + Y Ssel Y^T,
    N^-1_ij = -Y Ssel, N^-1_jj = Ssel; unscaled by di/djg."""
    Ainv, Y, Sinv, di, dj, djg, _ = factors
    jm = np.asarray(jmap_b)[:kj]
    return _block_cov(_host(Ainv[b]), _host(Y[b]), _host(di[b]),
                      _host(Sinv)[np.ix_(jm, jm)], _host(djg)[jm], ki, kj,
                      inner_idx, junc_idx)


def _block_cov_from_nested(factors, b, ki, kj, inner_idx, junc_idx,
                           jmap_b):
    """Same block-inverse identities as _block_cov_from_factors, with
    the junction covariance recovered through the nested level-2/3
    factors (nested_junction_cov) instead of a global Sinv."""
    Ainv_b, Y_b, di_b = factors.level1_block(b)
    jm = np.asarray(jmap_b)[:kj]
    return _block_cov(Ainv_b, Y_b, di_b, factors.junction_cov(jm),
                      factors.djg_np[jm], ki, kj, inner_idx, junc_idx)


def _block_cov(Ainv_b, Y_b, di_b, Csel, djg_b, ki, kj, inner_idx,
               junc_idx):
    """N^-1_ii = Ainv + Y C Y^T, N^-1_ij = -Y C, N^-1_jj = C for the
    junction covariance C (scaled), unscaled by di/djg and permuted back
    to the block's parameter layout."""
    Ainv_b = Ainv_b[:ki, :ki]
    Y_b = Y_b[:ki, :kj]
    di_b = di_b[:ki]
    YS = Y_b @ Csel
    cov_ii = (Ainv_b + YS @ Y_b.T) * np.outer(di_b, di_b)
    cov_ij = -YS * np.outer(di_b, djg_b)
    cov_jj = Csel * np.outer(djg_b, djg_b)

    k = ki + kj
    cov = np.zeros((k, k))
    cov[np.ix_(range(ki), range(ki))] = cov_ii
    cov[np.ix_(range(ki), range(ki, k))] = cov_ij
    cov[np.ix_(range(ki, k), range(ki))] = cov_ij.T
    cov[np.ix_(range(ki, k), range(ki, k))] = cov_jj

    # permute back to the block's parameter layout
    perm = np.concatenate([inner_idx, junc_idx])
    out = np.zeros_like(cov)
    out[np.ix_(perm, perm)] = cov
    return out


def _build_partition(nstations: int, blocks):
    """Vectorised junction detection + per-block [inner|junction] param
    partition.  Returns (jpi_arr, part): jpi_arr[g] = global junction
    index of station g (or -1); part[b] = (inner_p, junc_p, junc_g)
    param-index arrays in the block's local layout.

    Replaces the reference's per-station bookkeeping of the segmentation
    loader (dnaadjust.cpp ResizeMatrixVectors / PrepareAdjustmentBlock)
    with numpy over the concatenated station lists."""
    counts = np.zeros(nstations, dtype=np.int64)
    st_arrs = [np.asarray(blk.stations, dtype=np.int64) for blk in blocks]
    for st in st_arrs:
        counts[st] += 1
    junction_global = np.nonzero(counts > 1)[0]
    jpi_arr = np.full(nstations, -1, dtype=np.int64)
    jpi_arr[junction_global] = np.arange(len(junction_global))

    off3 = np.arange(3, dtype=np.int64)
    part = []
    for st in st_arrs:
        loc3 = 3 * np.arange(len(st), dtype=np.int64)
        jp = jpi_arr[st]
        isj = jp >= 0
        inner_p = (loc3[~isj][:, None] + off3).reshape(-1)
        junc_p = (loc3[isj][:, None] + off3).reshape(-1)
        junc_g = (3 * jp[isj][:, None] + off3).reshape(-1)
        part.append((inner_p, junc_p, junc_g))
    return jpi_arr, part


def _block_super(B, super_blocks, block_super):
    """Block→super-block assignment: the given one (length-checked), or
    contiguous grouping into super_blocks groups."""
    if block_super is None:
        return (np.arange(B, dtype=np.int64) * min(super_blocks, B)) // B
    block_super = np.asarray(block_super, dtype=np.int64)
    if len(block_super) != B:
        raise ValueError(f"block_super has {len(block_super)} entries "
                         f"for {B} blocks")
    return block_super


def adjust_tpu_blocked(net: NetworkData,
                       options: AdjustmentOptions | None = None,
                       seg_file: str | None = None,
                       seg: Segmentation | None = None,
                       super_blocks: int = 0,
                       staged: bool = False,
                       block_super: np.ndarray | None = None,
                       device="cuda") -> AdjustmentResult:
    """Blocked Schur adjustment on one device.

    super_blocks > 0 routes the solve through the three-level nested
    Schur factors (parallel/schur.py::NestedSchurFactors) — the
    national-scale junction path: the segmentation's blocks are grouped
    contiguously into that many super-blocks, junction parameters inside
    one super-block are eliminated at level 2, and only the
    super-junctions form the level-3 system.  block_super overrides the
    contiguous grouping with an explicit block→super-block assignment
    (length block_count): for 2D tiled segmentations a grid-aware
    grouping (utils/synthetic.py::grid_super_assignment) keeps the
    super-junction frontier O(sqrt(S)) where contiguous 1D bands make
    nearly every band station a super-junction.

    staged implies host assembly and, on the nested path, stages the
    level-1 factor pools in host RAM and streams them through the device
    (parallel/streamed.py) — for networks whose factors exceed device
    memory.  On the two-level path it changes only the assembly, as in
    the JAX package.

    device: where the normals, factors and solves live — "cuda" (the
    default: the level-1 and level-2 factors are the hand-written
    kernel) or "cpu" (every kernel's plain PyTorch version).

    With DTA_PROFILE set, result.profile also holds "route": the
    assembly ("device"/"host"), the solve ("device"/"host loop") and the
    float64 design pool's bytes (device assembly only)."""
    from ..parallel.schur import (BlockSystem, DeviceSchurFactors,
                                  NestedSchurFactors, build_block_system,
                                  build_nested_partition,
                                  schur_solve_device_refined,
                                  schur_solve_nested_factored)
    from .constraint_elim import ConstraintBasis
    from .device_assembly import DeviceAssembly
    from .device_solve import (DeviceRefinedSolve, pool_bytes,
                               want_device_solve)

    if block_super is not None and super_blocks == 0:
        raise ValueError("block_super given but super_blocks == 0 — the "
                         "nested path is not active")
    device = torch.device(device)
    opts = options or AdjustmentOptions()
    t0 = time.time()
    if seg is None:
        seg = (Segmentation.load(seg_file) if seg_file
               else segment_network(net))
    B = seg.block_count
    if super_blocks > 0:
        block_super = _block_super(B, super_blocks, block_super)
    blocks = [Block(net, opts, seg, b) for b in range(B)]
    first_fwd = _first_appearances(blocks, "fwd")

    # global junction stations (any station appearing in >1 block) and
    # the per-block parameter partition — pure numpy
    jpi_arr, part = _build_partition(net.nstations, blocks)
    jpi = {int(g): int(jpi_arr[g]) for g in np.nonzero(jpi_arr >= 0)[0]}

    x, y, z = geo_to_cart(net.lat, net.lon, net.height, net.datum.ellipsoid)
    xyz_all = np.stack([x, y, z], axis=-1)
    initial_xyz = xyz_all.copy()
    for blk in blocks:
        blk.est = xyz_all[blk.stations].reshape(-1).copy()
        blk.asm.fill(blk.est, apply_reductions=True)
        blk.Wc = blk.asm.constraint_weights()

    # hard constraints are eliminated from the parameter space (see
    # constraint_elim.py) — the huge-weight formulation conditions the
    # scaled normals at ~1e8+, past f32+refinement; elimination brings
    # real networks inside the f32 envelope
    basis = ConstraintBasis(net, opts)

    status = "Converged"
    it_log = []
    iteration = 0
    max_corr = np.inf
    factors = None
    bs = None
    nested_part = None

    # device-side normals formation (AᵀV⁻¹A as batched matmuls,
    # device_assembly.py) is the default; DTA_HOST_ASSEMBLY=1 forms them
    # on the host (numpy).  The streamed (staged) factors slice host
    # normals per chunk, so staged mode keeps host assembly.
    device_asm = (not staged
                  and os.environ.get("DTA_HOST_ASSEMBLY", "") != "1")
    da = matvec = dev_solver = None
    if device_asm:
        da = DeviceAssembly(blocks, part, basis, first_fwd, device=device)
        matvec = da.matvec
        # the device refined solve (device_solve.py) while the float64
        # design pool fits the budget, else the host refinement loop
        if want_device_solve(da):
            dev_solver = DeviceRefinedSolve(da)
    prof = ({"setup": 0.0, "fill": 0.0, "normals": 0.0, "rhs": 0.0,
             "build": 0.0, "factor": 0.0, "solve": 0.0, "update": 0.0,
             "stats": 0.0}
            if os.environ.get("DTA_PROFILE") else None)
    if prof is not None:
        # one-time per-network cost (block/assembler construction,
        # constraint basis, device plans + constant uploads) — kept OUT
        # of the per-iteration phases
        prof["setup"] = time.time() - t0

    def _sync():
        # phase timers must not attribute async device work to the next
        # phase; only pay the sync when profiling
        if prof is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    def _lap(name):
        nonlocal _t
        if prof is not None:
            _sync()
            prof[name] += time.perf_counter() - _t
            _t = time.perf_counter()

    for _ in range(opts.max_iterations):
        iteration += 1
        _t_iter = time.perf_counter()
        # trace range of what the log's "elapsed" covers (rhs .. update)
        _iter_range = record_function("dta.iteration")
        _iter_range.__enter__()
        _t = time.perf_counter()
        prev_bs = bs
        if dev_solver is not None:
            # ONE float64 value upload (scalar tiles only; GPS tiles are
            # device constants) serves the float32 build (cast on the
            # device) and the refined solve's residual operator
            vals_dev, mmc_dev = dev_solver.iteration_inputs()
            _lap("rhs")
            N32 = da.build_device(values=vals_dev)
            _lap("normals")
            bi = np.zeros((da.Bp, da.ni))
            bj = np.zeros((da.Bp, da.nj))
        elif device_asm:
            N32 = da.build_device()
            _lap("normals")
            bi, bj = da.rhs_pools()
            _lap("rhs")
        if device_asm:
            bs = BlockSystem(*N32, bi=bi, bj=bj, jmap=da.jmap_np,
                             jmask=da.jmask_np, imask=da.imask_np,
                             nj_global=da.nj_global)
            del N32
        else:
            # host assembly: per-block float64 normals and rhs (numpy),
            # constraints eliminated, gathered into the padded pools
            block_N, block_rhs = [], []
            for b, blk in enumerate(blocks):
                N, AtVinv = _block_normals(blk)
                rhs = AtVinv @ blk.asm.mmc
                _add_constraints(N, blk, first_fwd[b], skip=basis.proj)
                basis.transform_block(blk.stations, blk.asm.local, N, rhs,
                                      first_fwd[b])
                block_N.append(N)
                block_rhs.append(rhs)
            _lap("normals")
            bs = build_block_system(block_N, block_rhs,
                                    [p[0] for p in part],
                                    [p[1] for p in part],
                                    [p[2] for p in part])
            del block_N, block_rhs
            _lap("build")
        if prev_bs is not None:
            bs.copy_topology_caches(prev_bs)
        # re-factor when geometry changed (non-GPS present) or first pass
        refactor = factors is None or any(blk.asm.has_non_gps
                                          for blk in blocks)
        # with constraints eliminated the scaled systems condition at
        # ~1e4-1e6: f32 factorization + f64 residual refinement reaches
        # f64-level solutions
        solve_ev = None
        if super_blocks > 0:
            if nested_part is None:
                nested_part = build_nested_partition(bs, block_super)
            with record_function("dta.factor"):
                if not refactor:
                    factors.bs = bs
                elif factors is not None and not staged:
                    # re-linearised normals: refactor in place, reusing
                    # the resident topology tensors
                    factors.refactor(bs)
                else:
                    # staged factors are rebuilt from the fresh pools
                    # by the solve (they stream as they factor)
                    factors = None
                if factors is None and not staged:
                    factors = NestedSchurFactors(bs, nested_part,
                                                 device=device)
                _sync()
            _lap("factor")
            if dev_solver is not None:
                xi, xj, solve_ev = dev_solver.solve_nested(
                    factors, vals_dev, mmc_dev)
            else:
                xi, xj, factors = schur_solve_nested_factored(
                    bs, nested_part, factors=factors, streamed=staged,
                    matvec=matvec, device=device)
            if device_asm:
                # the nested factors are self-contained: the float32
                # pools are rebuilt at the next re-linearisation — free
                # them now.  Host-loop residuals come from the A-based
                # host matvec, not these pools.
                bs.Nii = bs.Nij = bs.Njj = None
        else:
            with record_function("dta.factor"):
                # device assembly: the f32 pools are already on the
                # device; host assembly: only their f32 casts go up
                if factors is None:
                    factors = DeviceSchurFactors(bs, device=device)
                elif refactor:
                    factors.update(bs)
                else:
                    factors.bs = bs
                _sync()
            _lap("factor")
            if dev_solver is not None:
                xi, xj, solve_ev = dev_solver.solve_flat(factors, vals_dev,
                                                         mmc_dev)
            else:
                xi, xj = schur_solve_device_refined(bs, factors,
                                                    matvec=matvec)
        _lap("solve")

        max_corr = 0.0
        max_stn = 0
        max_dx3, max_blk = np.zeros(3), 1
        for b, blk in enumerate(blocks):
            inner_p, junc_p, junc_g = part[b]
            dx = np.zeros(3 * len(blk.stations))
            dx[inner_p] = xi[b][:len(inner_p)]
            dx[junc_p] = xj[junc_g]
            blk.est = blk.est + dx
            i = int(np.argmax(np.abs(dx))) if len(dx) else 0
            if len(dx) and abs(dx[i]) > abs(max_corr):
                max_corr = dx[i]
                max_stn = blk.stations[i // 3]
                k = 3 * (i // 3)
                max_dx3, max_blk = dx[k:k + 3], b + 1
            xyz_all[blk.stations] = blk.est.reshape(-1, 3)
        _enu = rotate_cart_local(max_dx3, net.lat[max_stn],
                                 net.lon[max_stn])
        entry = {"iteration": iteration, "max_corr": float(max_corr),
                 "station": net.names[max_stn], "block": max_blk,
                 "enu": [float(v) for v in np.ravel(_enu)],
                 "elapsed": time.perf_counter() - _t_iter}
        _iter_range.__exit__(None, None, None)
        if solve_ev is not None:
            entry.update(solve_ev)      # solve_rel / solve_rounds
        it_log.append(entry)
        _lap("update")
        converged = abs(max_corr) <= opts.iteration_threshold
        la, lo, h = cart_to_geo(xyz_all[:, 0], xyz_all[:, 1],
                                xyz_all[:, 2], net.datum.ellipsoid)
        net.lat, net.lon, net.height = la, lo, h
        for blk in blocks:
            blk.est = xyz_all[blk.stations].reshape(-1).copy()
            blk.asm.fill(blk.est)
        if prof is not None:
            prof["fill"] += time.perf_counter() - _t
            # cumulative phase snapshot: per-iteration deltas give the
            # phase split of each iteration
            it_log[-1]["phases"] = dict(prof)
        if converged:
            break
    else:
        status = "Failed to converge"
    if abs(max_corr) > opts.iteration_threshold:
        status = "Failed to converge"

    # ---- statistics from the factored covariances -------------------------
    _t_stats = time.perf_counter()
    crit = _critical_value(opts.confidence_interval)
    m_count = sum(blk.asm.measurement_count() for blk in blocks)
    all_stations = sorted({g for blk in blocks for g in blk.stations})
    unknown_count = 3 * len(all_stations)
    for g in all_stations:
        for c in (net.constraints[g] + "FFF")[:3]:
            if c == "C":
                unknown_count -= 1

    chi_sq = 0.0
    outliers = 0
    pelzer_sum, pelzer_n = 0.0, 0
    stats_rows = []
    # one-time f64 Newton refinement of the f32 factors for variance
    # extraction: device-assembled runs refine against the float64 pools
    # built once on the device (their float32 pools are no longer needed
    # — free them first); host-assembled runs against their own float64
    # host pools
    if device_asm:
        bs.Nii = bs.Nij = bs.Njj = None
    if super_blocks == 0:
        factors._N32 = None
    prof_sub = {}

    def _subt(name, _last=[_t_stats]):
        # stats sub-phase timing (kept out of `prof` so the phase totals
        # don't double-count): each call closes the previous sub-phase
        if prof is not None:
            _sync()
            now = time.perf_counter()
            prof_sub[name] = now - _last[0]
            _last[0] = now

    N64 = da.build_f64() if device_asm else None
    _subt("stats.f64build")
    if super_blocks == 0:
        cov_factors = factors.newton_factors(N64=N64)
    else:
        cov_factors = None
        factors.newton_refine_cov(N64=N64)
    del N64
    _subt("stats.newton")
    S = net.nstations
    # O(S) covariance storage: per-station 3x3 blocks always; the dense
    # (3S,3S) matrix only for small networks (the reference likewise
    # stores per-block variances only in phased mode, dnaadjust.cpp:6770)
    dense_max = int(os.environ.get("DTA_DENSE_COV_MAX_STN", "5000"))
    cov = np.zeros((3 * S, 3 * S)) if S <= dense_max else None
    cov_stn = np.zeros((S, 3, 3))

    def _block_cov_at(b):
        """Block b's full covariance from the refined factors."""
        inner_p, junc_p, junc_g = part[b]
        if super_blocks > 0:
            return _block_cov_from_nested(
                factors, b, len(inner_p), len(junc_p), inner_p, junc_p,
                bs.jmap[b])
        return _block_cov_from_factors(
            cov_factors, b, len(inner_p), len(junc_p), inner_p, junc_p,
            bs.jmap[b], bs.jmask[b])

    # device statistics: adj_prec / GNSS VCVs / station covariance blocks
    # batched on the device — replaces the per-block host O(m n^2)
    # products (ComputePrecisionAdjMsrs, dnaadjust.cpp:7784).  The
    # dense-covariance route (small networks) keeps the host path, which
    # the full-VCV exports need anyway.
    use_dev_stats = (device_asm and cov is None
                     and os.environ.get("DTA_DEVICE_STATS", "1") != "0")
    dev_prec = dev_vcv3 = dev_cov3 = None
    if use_dev_stats:
        from .device_stats import device_block_stats
        dev_prec, dev_vcv3, dev_cov3 = device_block_stats(
            da, bs, cov_factors=cov_factors,
            nested=(factors, nested_part) if super_blocks > 0 else None)
    _subt("stats.device")
    # pre-group the device GNSS VCVs per block once
    vcv3_by_block = {}
    if use_dev_stats and dev_vcv3:
        for (bb, r), m in dev_vcv3.items():
            vcv3_by_block.setdefault(bb, {})[r] = m
    for b, blk in enumerate(blocks):
        inner_p, junc_p, junc_g = part[b]
        if use_dev_stats:
            vb = vcv3_by_block.get(b, {})
            rows, c2, outl, ps, pn = _measurement_stats(
                blk.asm, net, None, blk.est, crit,
                adj_prec=dev_prec[b][:blk.asm.nrows], adj_vcv3=vb)
            scol = da._scol[b]
            c3 = dev_cov3[b][scol]               # (k_b, 3, 3) station covs
            for li, g in enumerate(blk.stations):
                Pg = basis.proj.get(g)
                cov_stn[g] = (Pg @ c3[li] @ Pg if Pg is not None
                              else c3[li])
        else:
            cov_b = _block_cov_at(b)
            # eliminated constrained directions carry a unit pin in the
            # factored system; project them out so they report zero
            # variance
            basis.project_cov(blk.stations, blk.asm.local, cov_b)
            rows, c2, outl, ps, pn = _measurement_stats(
                blk.asm, net, cov_b, blk.est, crit)
            for g in blk.stations:
                l = blk.asm.local[g]
                cov_stn[g] = cov_b[3 * l:3 * l + 3, 3 * l:3 * l + 3]
            if cov is not None:
                # full within-block covariances into the dense matrix
                # (the reference's phased mode prints within-block
                # inter-station covariances; cross-block stay zero)
                gp = (3 * np.asarray(blk.stations,
                                     dtype=np.int64)[:, None]
                      + np.arange(3)).reshape(-1)
                lp = (3 * np.arange(len(blk.stations))[:, None]
                      + np.arange(3)).reshape(-1)
                cov[np.ix_(gp, gp)] = cov_b[np.ix_(lp, lp)]
        stats_rows.extend(rows)
        chi_sq += c2
        outliers += outl
        pelzer_sum += ps
        pelzer_n += pn

    _subt("stats.host")
    stats_rows.sort(key=lambda r: r.rec_idx)
    dof = m_count - unknown_count
    sigma0 = chi_sq / dof if dof else 0.0
    for r in stats_rows:
        r.tstat = r.nstat / np.sqrt(sigma0) if sigma0 > 1e-20 else 0.0
    chi_lower, chi_upper = (_chi2_limits(dof, opts.confidence_interval)
                            if dof > 0 else (0.0, 0.0))
    pass_fail = ("WARNING" if sigma0 < chi_lower else
                 "FAILED" if sigma0 > chi_upper else "PASSED")
    global_pelzer = (np.sqrt(pelzer_sum / pelzer_n) if pelzer_n
                     else UNRELIABLE)

    block_info = [(blk.index + 1,
                   [net.names[g] for g in blk.stations if g not in jpi],
                   [net.names[g] for g in blk.stations if g in jpi],
                   blk.asm.measurement_count()) for blk in blocks]

    # block-scoped covariance provider: past the dense cap the writers get
    # within-block inter-station covariances rebuilt lazily from the
    # retained factors — the reference's phased-mode semantics
    block_cov = None
    if cov is None:
        from .block_cov import BlockCovProvider

        def _compute_block_cov(b):
            cb = _block_cov_at(b)
            blk = blocks[b]
            basis.project_cov(blk.stations, blk.asm.local, cb)
            return cb

        block_cov = BlockCovProvider(
            _compute_block_cov, [blk.stations for blk in blocks])

    if prof is not None:
        prof["stats"] = time.perf_counter() - _t_stats
        tot = sum(prof.values())
        print("DTA_PROFILE per-phase (s, over {} iters): ".format(iteration) +
              "  ".join(f"{k}={v:.3f} ({100*v/max(tot,1e-12):.0f}%)"
                        for k, v in prof.items()),
              file=sys.stderr, flush=True)
        if prof_sub:
            print("DTA_PROFILE stats sub-phases (s): " +
                  "  ".join(f"{k}={v:.3f}" for k, v in prof_sub.items()),
                  file=sys.stderr, flush=True)
        prof["stats_sub"] = dict(prof_sub)
        prof["route"] = {
            "assembly": "device" if device_asm else "host",
            "solve": "device" if dev_solver is not None else "host loop",
            "pool_bytes": pool_bytes(da) if device_asm else None}

    return AdjustmentResult(
        status=status, iterations=iteration, max_corr=float(max_corr),
        chi_squared=float(chi_sq), sigma_zero=float(sigma0),
        degrees_of_freedom=dof, measurement_count=m_count,
        unknown_count=unknown_count, chi_upper=chi_upper,
        chi_lower=chi_lower, pass_fail=pass_fail,
        global_pelzer=float(global_pelzer), potential_outliers=outliers,
        critical_value=float(crit), xyz=xyz_all.copy(),
        lat=net.lat.copy(), lon=net.lon.copy(), height=net.height.copy(),
        cov_xyz=cov, cov_stn=cov_stn, msr_stats=stats_rows,
        iteration_log=it_log, block_info=block_info,
        initial_xyz=initial_xyz, elapsed=time.time() - t0,
        profile=prof, block_cov=block_cov,
        refine_evidence=getattr(factors, "cov_refine_evidence", None))
