"""Phased (block-segmented) least-squares adjustment.

The network is partitioned into blocks of inner/junction stations
(dynadjust_tpu_torch.segment).  Each iteration runs:

  forward pass   — blocks solved in order; junction estimates and their
                   a-posteriori covariances carried into the next block as
                   correlated pseudo-measurements,
  reverse pass   — the same in reverse order over an independent copy of
                   the estimates,
  combination    — middle blocks re-solved with junction contributions from
                   BOTH directions, yielding rigorous estimates/variances.

The first block is rigorous from the reverse pass, the last from the
forward pass; this matches the reference's sequential phased algorithm and
is mathematically a two-sweep block Schur-complement solve of the full
normal equations.

Port of the JAX package's ``adjust/phased.py``, on the host (numpy
throughout).  Its per-block device solve (``options.use_tpu``, which
``adjust --block1-phased --tpu`` asks for) is not ported (ROADMAP.md M9).

Algorithm parity: dnaadjust.cpp AdjustPhased :2579, AdjustPhasedForward
:2756, AdjustPhasedReverseCombine :3461,
CarryStnEstimatesandVariancesForward/Reverse :998/:1133,
PrepareAdjustmentCombine :3336, UpdateEstimatesFinal :3744 (rigorousness
rules :3747-3783), AddConstraintStationstoNormals* :1884-2037
(first-appearance bookkeeping).
"""

from __future__ import annotations

import time

import numpy as np

from ..geodesy.conversions import cart_to_geo, geo_to_cart
from ..network.data import NetworkData
from ..segment import Segmentation, segment_network
from .assembler import Assembler
from .options import AdjustmentOptions
from .simultaneous import (
    AdjustmentResult, _chi2_limits, _critical_value, _measurement_stats,
    _solve_normals, UNRELIABLE,
)


class _MtxStage:
    """Out-of-core staging of per-block matrices (.mtx memory-mapped
    files) — the analogue of the reference's staged adjustment
    (dnaadjust-stage.cpp: OffloadBlockToMappedFile /
    DeserialiseBlockFromMappedFile)."""

    def __init__(self, folder: str, name: str):
        import os
        self.dir = os.path.join(folder, f"{name}.mtx")
        os.makedirs(self.dir, exist_ok=True)
        self.meta = {}

    def offload(self, block: int, key: str, arr: np.ndarray) -> None:
        import os
        path = os.path.join(self.dir, f"b{block}.{key}.mtx")
        mm = np.memmap(path, dtype=np.float64, mode="w+", shape=arr.shape)
        mm[:] = arr
        mm.flush()
        del mm
        self.meta[(block, key)] = (path, arr.shape)

    def load(self, block: int, key: str) -> np.ndarray:
        path, shape = self.meta[(block, key)]
        return np.array(np.memmap(path, dtype=np.float64, mode="r",
                                  shape=shape))

    def has(self, block: int, key: str) -> bool:
        return (block, key) in self.meta

    def purge(self):
        import os
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


class Block:
    def __init__(self, net: NetworkData, opts: AdjustmentOptions,
                 seg: Segmentation, b: int):
        self.index = b
        self.stations = seg.parameter_stations(b)       # global indices
        self.jsl = seg.junction_stations[b]             # frontier to b+1
        recs = [net.measurements[ri] for ri in seg.measurements[b]]
        self.asm = Assembler(net, opts, station_subset=self.stations,
                             measurement_subset=recs,
                             record_indices=list(seg.measurements[b]))
        self.njsl = len(self.jsl)
        # local parameter offsets of the junction stations
        self.jsl_local = np.array([self.asm.local[g] for g in self.jsl],
                                  dtype=np.int64)
        self.est = None                 # forward-pass estimates (3k,)
        self.est_rev = None             # reverse-pass estimates
        self.rigorous_est = None
        self.rigorous_cov = None
        self.N_base = None              # measurement normals (no constraints)
        self.AtVinv = None
        self.Ninv_fwd = None

    def base_normals(self) -> np.ndarray:
        if self.N_base is not None:
            return self.N_base
        return self._stage.load(self.index, "N")

    def atvinv(self) -> np.ndarray:
        if self.AtVinv is not None:
            return self.AtVinv
        return self._stage.load(self.index, "AtVinv")

    def jsl_param_idx(self) -> np.ndarray:
        """Flattened parameter indices (3 per junction station)."""
        out = np.empty(3 * self.njsl, dtype=np.int64)
        for i, l in enumerate(self.jsl_local):
            out[3 * i:3 * i + 3] = (3 * l, 3 * l + 1, 3 * l + 2)
        return out

    def param_idx_of(self, globals_) -> np.ndarray:
        out = np.empty(3 * len(globals_), dtype=np.int64)
        for i, g in enumerate(globals_):
            l = self.asm.local[g]
            out[3 * i:3 * i + 3] = (3 * l, 3 * l + 1, 3 * l + 2)
        return out


def _first_appearances(blocks, direction: str):
    """Set of (block, station) pairs where each station first appears in the
    given sweep direction — constraint weights are added exactly once."""
    seen = set()
    order = range(len(blocks)) if direction == "fwd" else \
        range(len(blocks) - 1, -1, -1)
    first = {b: set() for b in range(len(blocks))}
    for b in order:
        for g in blocks[b].stations:
            if g not in seen:
                seen.add(g)
                first[b].add(g)
    return first


def adjust_phased(net: NetworkData, options: AdjustmentOptions | None = None,
                  seg_file: str | None = None,
                  seg: Segmentation | None = None,
                  stage_dir: str | None = None,
                  stage_name: str = "blocks",
                  block1: bool = False,
                  _trace: dict | None = None) -> AdjustmentResult:
    """stage_dir: when given, per-block normals/AtVinv are offloaded to
    memory-mapped .mtx files between uses instead of held resident —
    bounding peak memory to a couple of blocks (the reference's
    --staged-adjustment).

    _trace: when a dict is passed, iteration-1 per-block corrections of
    each sweep are recorded into it ({"fwd"|"rev"|"comb": {b: dx}}) — the
    hook that compares the sweeps' arithmetic side by side with another
    implementation of the reference's sweeps.

    block1: solve rigorous estimates for block 1 only, via a single
    reverse sweep (AdjustPhasedBlock1, dnaadjust.cpp:2675 — "only the
    reverse adjustment is needed to achieve rigorous estimates for
    block 1"); one iteration, no forward pass or combination."""
    opts = options or AdjustmentOptions()
    if opts.use_tpu:
        raise NotImplementedError(
            "the per-block device solve of the phased sweeps (use_tpu) is "
            "not ported to dynadjust_tpu_torch: ROADMAP.md M9")
    t0 = time.time()

    if seg is None:
        if seg_file:
            seg = Segmentation.load(seg_file)
        else:
            seg = segment_network(net)
    B = seg.block_count
    stage = _MtxStage(stage_dir, stage_name) if stage_dir else None

    blocks = [Block(net, opts, seg, b) for b in range(B)]
    for blk in blocks:
        blk._stage = stage
    first_fwd = _first_appearances(blocks, "fwd")
    first_rev = _first_appearances(blocks, "rev")

    # initial estimates per block from current geographic coordinates
    x, y, z = geo_to_cart(net.lat, net.lon, net.height, net.datum.ellipsoid)
    xyz_all = np.stack([x, y, z], axis=-1)
    initial_xyz = xyz_all.copy()
    for blk in blocks:
        blk.est = xyz_all[blk.stations].reshape(-1).copy()
        blk.asm.fill(blk.est, apply_reductions=True)
        blk.Wc = blk.asm.constraint_weights()

    status = "Converged"
    it_log = []
    iteration = 0
    max_corr = np.inf

    import time as _time
    for _ in range(opts.max_iterations):
        iteration += 1
        _t_iter = _time.perf_counter()
        max_corr = 0.0
        max_stn = 0

        # rebuild measurement normals for this linearisation point
        for blk in blocks:
            N, AtVinv = _block_normals(blk)
            if stage is not None:
                stage.offload(blk.index, "N", N)
                stage.offload(blk.index, "AtVinv", AtVinv)
                blk.N_base = None
                blk.AtVinv = None
            else:
                blk.N_base = N
                blk.AtVinv = AtVinv

        # ---- forward pass (skipped in block1 mode) -------------------------
        jsl_est_fwd = [None] * B        # junction estimates carried forward
        jsl_w_fwd = [None] * B          # junction weight matrices (Σ⁻¹)
        for b, blk in enumerate(blocks if not block1 else ()):
            N = blk.base_normals().copy()
            _add_constraints(N, blk, first_fwd[b])
            rhs = blk.atvinv() @ blk.asm.mmc
            if b > 0 and blocks[b - 1].njsl:
                _add_junction_contrib(N, rhs, blk, blocks[b - 1].jsl,
                                      jsl_w_fwd[b - 1], jsl_est_fwd[b - 1],
                                      blk.est)
            Ninv, dx = _solve_normals(N, rhs, opts.scale_normals_to_unity,
                                      opts.use_tpu)
            blk.est = blk.est + dx
            if _trace is not None and iteration == 1:
                _trace.setdefault("fwd", {})[b] = dx.copy()
            blk.Ninv_fwd = Ninv
            if blk.njsl:
                jidx = blk.jsl_param_idx()
                cov_j = Ninv[np.ix_(jidx, jidx)]
                jsl_w_fwd[b] = np.linalg.inv(cov_j)
                jsl_est_fwd[b] = blk.est[jidx]

        # ---- reverse pass + combination ----------------------------------
        jsl_est_rev = [None] * B
        jsl_w_rev = [None] * B
        for b in range(B - 1, -1, -1):
            blk = blocks[b]
            # reverse estimates start from the forward linearisation point
            est_r = xyz_all[blk.stations].reshape(-1).copy() \
                if blk.est_rev is None else blk.est_rev
            # mmc was computed at the (pre-solve) linearisation point; reuse
            N = blk.base_normals().copy()
            _add_constraints(N, blk, first_rev[b])
            rhs = blk.atvinv() @ blk.asm.mmc
            if b < B - 1 and blk.njsl:
                _add_junction_contrib(N, rhs, blk, blk.jsl,
                                      jsl_w_rev[b + 1], jsl_est_rev[b + 1],
                                      est_r)
            Ninv_r, dx_r = _solve_normals(N, rhs,
                                          opts.scale_normals_to_unity,
                                          opts.use_tpu)
            est_r = est_r + dx_r
            if _trace is not None and iteration == 1:
                _trace.setdefault("rev", {})[b] = dx_r.copy()
            blk.est_rev = est_r
            if b > 0:
                prev_jsl = blocks[b - 1].jsl
                if prev_jsl:
                    jidx = blk.param_idx_of(prev_jsl)
                    cov_j = Ninv_r[np.ix_(jidx, jidx)]
                    jsl_w_rev[b] = np.linalg.inv(cov_j)
                    jsl_est_rev[b] = est_r[jidx]

            # rigorous estimates for this block
            if block1:
                # only block 1 is rigorous; other blocks keep the reverse
                # sweep estimates (not rigorous, carried for the report)
                blk.rigorous_est = est_r
                blk.rigorous_cov = Ninv_r
            elif b == B - 1:
                blk.rigorous_est = blocks[b].est            # forward rigorous
                blk.rigorous_cov = blocks[b].Ninv_fwd
            elif b == 0:
                blk.rigorous_est = est_r                    # reverse rigorous
                blk.rigorous_cov = Ninv_r
            else:
                # combination: base + constraints(rev rules) + fwd + rev
                Nc = blk.base_normals().copy()
                _add_constraints(Nc, blk, first_rev[b])
                _subtract_combine_constraints(Nc, blk, first_fwd[b])
                rhs_c = blk.atvinv() @ blk.asm.mmc
                est_c = xyz_all[blk.stations].reshape(-1).copy()
                _add_junction_contrib(Nc, rhs_c, blk, blocks[b - 1].jsl,
                                      jsl_w_fwd[b - 1], jsl_est_fwd[b - 1],
                                      est_c)
                _add_junction_contrib(Nc, rhs_c, blk, blk.jsl,
                                      jsl_w_rev[b + 1], jsl_est_rev[b + 1],
                                      est_c)
                Ninv_c, dx_c = _solve_normals(Nc, rhs_c,
                                              opts.scale_normals_to_unity,
                                              opts.use_tpu)
                blk.rigorous_est = est_c + dx_c
                if _trace is not None and iteration == 1:
                    _trace.setdefault("comb", {})[b] = dx_c.copy()
                blk.rigorous_cov = Ninv_c

        # ---- convergence & relinearisation -------------------------------
        max_dx3, max_blk = np.zeros(3), 1
        for bno, blk in enumerate(blocks if not block1 else blocks[:1]):
            prev = xyz_all[blk.stations].reshape(-1)
            dx = blk.rigorous_est - prev
            i = int(np.argmax(np.abs(dx)))
            if abs(dx[i]) > abs(max_corr):
                max_corr = dx[i]
                max_stn = blk.stations[i // 3]
                k = 3 * (i // 3)
                max_dx3, max_blk = dx[k:k + 3], bno + 1
            xyz_all[blk.stations] = blk.rigorous_est.reshape(-1, 3)
        from ..geodesy.local_frame import rotate_cart_local
        _enu = rotate_cart_local(max_dx3, net.lat[max_stn],
                                 net.lon[max_stn])
        it_log.append({"iteration": iteration, "max_corr": float(max_corr),
                       "station": net.names[max_stn], "block": max_blk,
                       "enu": [float(v) for v in np.ravel(_enu)],
                       "elapsed": _time.perf_counter() - _t_iter})

        converged = abs(max_corr) <= opts.iteration_threshold
        # update geographic coordinates and refill at the new estimates
        la, lo, h = cart_to_geo(xyz_all[:, 0], xyz_all[:, 1], xyz_all[:, 2],
                                net.datum.ellipsoid)
        net.lat, net.lon, net.height = la, lo, h
        for blk in blocks:
            blk.est = xyz_all[blk.stations].reshape(-1).copy()
            blk.est_rev = blk.est.copy()
            blk.asm.fill(blk.est)
        if block1:
            # single pass only (the reference flags threshold-exceeded
            # rather than iterating, dnaadjust.cpp:2709)
            status = "Estimates solved for Block 1 only"
            if abs(max_corr) > opts.iteration_threshold:
                status += " (threshold exceeded)"
            break
        if converged:
            break
    else:
        status = "Failed to converge"
    if not block1 and abs(max_corr) > opts.iteration_threshold:
        status = "Failed to converge"

    # ---- statistics ------------------------------------------------------
    # block1 mode: only block 1 is rigorous, so statistics cover block 1
    # alone (the reference's Phased_Block_1Mode prints block-1 results)
    stat_blocks = blocks[:1] if block1 else blocks
    crit = _critical_value(opts.confidence_interval)
    m_count = sum(blk.asm.measurement_count() for blk in stat_blocks)
    # unknowns: every station counted once; constrained coords reduce count
    all_stations = sorted({g for blk in stat_blocks for g in blk.stations})
    unknown_count = 3 * len(all_stations)
    for g in all_stations:
        for c in (net.constraints[g] + "FFF")[:3]:
            if c == "C":
                unknown_count -= 1

    chi_sq = 0.0
    outliers = 0
    pelzer_sum, pelzer_n = 0.0, 0
    stats_rows = []
    for blk in stat_blocks:
        rows, c2, outl, ps, pn = _measurement_stats(
            blk.asm, net, blk.rigorous_cov, blk.rigorous_est, crit)
        stats_rows.extend(rows)
        chi_sq += c2
        outliers += outl
        pelzer_sum += ps
        pelzer_n += pn

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

    # assemble a full covariance view: per-station 3x3 from the rigorous
    # block covariances (later blocks are rigorous for their inner stations)
    S = net.nstations
    cov = np.zeros((3 * S, 3 * S))
    for blk in blocks:
        for g in blk.stations:
            l = blk.asm.local[g]
            cov[3 * g:3 * g + 3, 3 * g:3 * g + 3] = \
                blk.rigorous_cov[3 * l:3 * l + 3, 3 * l:3 * l + 3]

    block_info = [(blk.index + 1,
                   [net.names[g] for g in blk.stations
                    if g not in set(blk.jsl)],
                   [net.names[g] for g in blk.jsl],
                   blk.asm.measurement_count()) for blk in blocks]

    return AdjustmentResult(
        status=status, iterations=iteration, max_corr=float(max_corr),
        chi_squared=float(chi_sq), sigma_zero=float(sigma0),
        degrees_of_freedom=dof, measurement_count=m_count,
        unknown_count=unknown_count, chi_upper=chi_upper,
        chi_lower=chi_lower, pass_fail=pass_fail,
        global_pelzer=float(global_pelzer), potential_outliers=outliers,
        critical_value=float(crit), xyz=xyz_all.copy(),
        lat=net.lat.copy(), lon=net.lon.copy(), height=net.height.copy(),
        cov_xyz=cov, msr_stats=stats_rows, iteration_log=it_log,
        block_info=block_info, initial_xyz=initial_xyz, elapsed=time.time() - t0)


def _block_normals(blk: Block):
    """Measurement-only normals and AtVinv for one block (batched
    weight application — Assembler.atvinv)."""
    A = blk.asm.A
    AtVinv = blk.asm.atvinv()
    return AtVinv @ A, AtVinv


def _add_constraints(N, blk: Block, first_set, skip=()):
    """skip: stations whose constraint weights are handled elsewhere
    (constraint elimination replaces their huge-weight diagonal)."""
    for g in first_set:
        if g not in blk.asm.local or g in skip:
            continue
        l = 3 * blk.asm.local[g]
        li = blk.asm.local[g]
        N[l:l + 3, l:l + 3] += blk.Wc[li]


def _subtract_combine_constraints(N, blk: Block, first_fwd_set):
    """In combination, remove constraints for stations that appeared in an
    earlier block in the forward direction (their effect arrives via the
    forward junction carry) — AddConstraintStationstoNormalsCombine."""
    for li, g in enumerate(blk.stations):
        if g in first_fwd_set:
            continue    # first forward appearance here: constraint not yet
                        # applied in forward; keep the reverse one
        l = 3 * li
        N[l:l + 3, l:l + 3] -= blk.Wc[li]


def _add_junction_contrib(N, rhs, blk: Block, jsl_globals, W, jsl_est,
                          est_cur):
    """Add junction pseudo-measurements: x_j observed as jsl_est with weight
    W (3j x 3j, correlated)."""
    jidx = blk.param_idx_of(jsl_globals)
    N[np.ix_(jidx, jidx)] += W
    rhs[jidx] += W @ (jsl_est - est_cur[jidx])
