"""Refined Gauss-Newton solve on the device for the mixed-type path.

Each Gauss-Newton iteration solves the blocked normals with float32
explicit-inverse factors (parallel/schur.py) and refines against float64
residuals until the relative residual stops improving:

  * the float64 design pool A (B, M, P) is scattered on the device from
    the same per-iteration tile values the float32 normals build uses
    (device_assembly tile plan), and each residual matvec is
    y = P·AᵀV⁻¹A·P·x + D·x in native float64 — the true system, not the
    float32 normals;
  * the rhs b = P·AᵀV⁻¹·mmc is computed on the device from the uploaded
    misclosure pool;
  * the refinement policy (refine floor, rtol target, stall detector —
    the host loops' policy) runs as a Python loop over float32 factor
    applies and float64 residuals, each round one read of the residual
    norm.

Per iteration the host↔device traffic is the tile values and
misclosures up and the corrections down.

Port of the JAX package's ``adjust/device_solve.py`` (the float64
operator branch of ``_make_operator``, ``_refined_loop``, ``_flat_prog``,
``_nested_prog``, ``DeviceRefinedSolve``, the unsliced ``pool_bytes``
and ``want_device_solve``).  Past the design-pool budget
(DTA_DEVICE_SOLVE_BYTES) or with DTA_DEVICE_SOLVE=0 the adjustment takes
the host refinement loop of parallel/schur.py instead, as the JAX
package does.  Reference: the per-iteration Solve loop,
dnaadjust.cpp:6586.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _make_operator(dims, has_proj, vals, mmc, wdiag, bkt, Pm, jmap,
                   jmask64, db, dc3, dv, tb, tr, tc3):
    """(rhs, matvec) closures over the scattered float64 design pool.

    dims = (B, M, Pp, ni, nj_total)."""
    B, M, Pp, ni, nj_total = dims
    Pn = Pp // 3
    A64 = torch.zeros((B, M, Pp), dtype=torch.float64, device=vals.device)
    A64[tb[:, None], tr[:, None], tc3] = vals.to(torch.float64)

    def Ax(x):
        return (A64 @ x[:, :, None])[:, :, 0]

    def ATv(v):
        return (v[:, None, :] @ A64)[:, 0, :]

    def proj(v):
        if not has_proj:
            return v
        vr = v.reshape(B, Pn, 3)
        return torch.einsum("bsij,bsj->bsi", Pm, vr).reshape(B, Pp)

    def applyV(u):
        vu = u * wdiag
        for bb, rows, V in bkt:
            ug = u[bb[:, None], rows]
            vu[bb[:, None], rows] = torch.einsum("nik,nk->ni", V, ug)
        return vu

    def gather_j(y):
        return torch.zeros(nj_total, dtype=torch.float64,
                           device=y.device).index_add_(
            0, jmap.reshape(-1), (y[:, ni:] * jmask64).reshape(-1))

    def rhs():
        b_pool = proj(ATv(applyV(mmc)))
        return b_pool[:, :ni], gather_j(b_pool)

    def matvec(xi, xj_g):
        xj_b = xj_g[jmap] * jmask64
        x = torch.cat([xi, xj_b], dim=1)
        y = proj(ATv(applyV(Ax(proj(x)))))
        xg = x[db[:, None], dc3]
        y.index_put_((db[:, None], dc3), torch.einsum("kij,kj->ki", dv, xg),
                     accumulate=True)
        return y[:, :ni], gather_j(y)

    return rhs, matvec


def _refined_loop(policy, apply_fn, matvec_fn, bi, bj_g, imask64):
    """Shared refinement policy (the host loops'): initial apply, then
    rounds gated by the float64 relative residual with a `refine` floor
    and a stall detector.  policy = (refine, max_refine, rtol).
    Returns (xi, xj, rel, rounds)."""
    refine, max_refine, rtol = policy
    rhs_scale = max(float(bi.abs().max()), float(bj_g.abs().max()), 1e-30)
    xi, xj = apply_fn(bi, bj_g)

    def residual(xi, xj):
        yi, yj = matvec_fn(xi, xj)
        ri = bi * imask64 - yi
        rj = bj_g - yj
        rel = max(float(ri.abs().max()), float(rj.abs().max())) / rhs_scale
        return ri, rj, rel

    ri, rj, rel = residual(xi, xj)
    prev, k = np.inf, 0
    while k < max_refine and (k < refine or (rtol <= rel < 0.5 * prev)):
        dxi, dxj = apply_fn(ri, rj)
        xi = xi + dxi
        xj = xj + dxj
        prev = rel
        ri, rj, rel = residual(xi, xj)
        k += 1
    return xi, xj, rel, k


def _flat_prog(dims, policy, has_proj, vals, mmc, tb, tr, tc3, wdiag, bkt,
               Pm, db, dc3, dv, jmap, jmask64, imask64, owner64,
               Ainv, Y, Sinv, di, dj, djg, Nij_s, jmask32):
    """The flat refined solve: operator, rhs, refinement loop."""
    from ..parallel.schur import _schur_apply_inv_core
    B, M, Pp, ni, nj_total = dims
    rhs, matvec = _make_operator(
        dims, has_proj, vals, mmc, wdiag, bkt, Pm, jmap, jmask64,
        db, dc3, dv, tb, tr, tc3)
    bi, bj_g = rhs()
    f32 = Ainv.dtype

    def apply_fn(ri, rj_g):
        rjb = rj_g[jmap] * owner64
        xi, xj = _schur_apply_inv_core(
            Ainv, Y, Sinv, di, dj, djg, Nij_s, ri.to(f32), rjb.to(f32),
            jmap, jmask32, nj_total)
        return xi.to(torch.float64), xj.to(torch.float64)

    return _refined_loop(policy, apply_fn, matvec, bi, bj_g, imask64)


def _nested_prog(dims, policy, has_proj, vals, mmc, tb, tr, tc3, wdiag,
                 bkt, Pm, db, dc3, dv, jmap, jmask64, imask64, owner64,
                 factors, gidx):
    """The nested (three-level) refined solve: operator, rhs, refinement
    loop over the factors' applies."""
    rhs, matvec = _make_operator(
        dims, has_proj, vals, mmc, wdiag, bkt, Pm, jmap, jmask64,
        db, dc3, dv, tb, tr, tc3)
    bi, bj_g = rhs()
    f32 = factors.dtype

    def apply_fn(ri, rj_g):
        rjb = rj_g[jmap] * owner64
        xi, xj = factors.apply_device(ri.to(f32), rjb.to(f32), gidx)
        return xi.to(torch.float64), xj.to(torch.float64)

    return _refined_loop(policy, apply_fn, matvec, bi, bj_g, imask64)


def pool_bytes(da) -> float:
    """Bytes of the refined solve's float64 design pool (B, M, P)."""
    return float(da.Bp) * da.M * da.Pp * 8.0


def want_device_solve(da) -> bool:
    """Route the solve through the device refined solve?  DTA_DEVICE_SOLVE
    1 or 0 forces the answer; otherwise the float64 design pool must fit
    DTA_DEVICE_SOLVE_BYTES (8e9) alongside the factor pools."""
    v = os.environ.get("DTA_DEVICE_SOLVE", "")
    if v in ("0", "1"):
        return v == "1"
    budget = float(os.environ.get("DTA_DEVICE_SOLVE_BYTES", 8e9))
    return pool_bytes(da) <= budget


class DeviceRefinedSolve:
    """Per-topology constant device state of the refined solve.

    Built once from a DeviceAssembly; `solve_flat(factors, ...)` runs one
    full residual-refined solve.  Policy knobs mirror the host loops:
    `refine` floor rounds, DTA_MAX_REFINE cap, DTA_SOLVE_RTOL target.
    """

    def __init__(self, da, refine: int = 2):
        from ..parallel.schur import _owner_mask
        self.da = da
        max_refine = max(refine,
                         int(os.environ.get("DTA_MAX_REFINE", 12)))
        rtol = float(os.environ.get("DTA_SOLVE_RTOL", 1e-10))
        self.policy = (refine, max_refine, rtol)
        self.njg = da.nj_global
        self.nj_total = da.nj_global + 1
        self.dims = (da.Bp, da.M, da.Pp, da.ni, self.nj_total)

        pr = da._putr
        self._jmap = pr(da.jmap_np)
        self._jmask64 = pr(da.jmask_np.astype(np.float64))
        self._imask64 = pr(da.imask_np.astype(np.float64))
        self._owner64 = pr(_owner_mask(da.jmap_np, da.jmask_np)
                           .astype(np.float64))
        self._wdiag64 = pr(da._wdiag64_h[:, :da.M].astype(np.float64))
        self._buckets = []
        for k, bb, rr, V in da._v_buckets64_h:
            rows = rr[:, None] + np.arange(k, dtype=np.int32)
            self._buckets.append((pr(bb), pr(rows), pr(V)))
        self._pm = da.Pmat64 if da._has_proj else None
        self._gidx = None

    # ------------------------------------------------------------------
    def iteration_inputs(self):
        """Upload this linearisation's tile values (float64, SCALAR tiles
        only — GPS tiles are device constants, composed on the device)
        and the misclosure pool.  The same composed value vector feeds
        the float32 normals build (cast on the device) — one transfer
        serves both."""
        da = self.da
        dyn = np.ascontiguousarray(da.dyn_values(np.float64))
        vals_dev = da.compose_values(da._putr(dyn))
        mmc = np.zeros((da.Bp, da.M))
        for b, blk in enumerate(da.blocks):
            mmc[b, :blk.asm.nrows] = blk.asm.mmc
        return vals_dev, da._putr(mmc)

    def _common_args(self):
        da = self.da
        return (da._t_b, da._t_r, da._t_c3, self._wdiag64,
                self._buckets, self._pm, da._d_b, da._d_c3,
                da._d_v64, self._jmap, self._jmask64, self._imask64,
                self._owner64)

    # ------------------------------------------------------------------
    def solve_flat(self, factors, vals_dev, mmc_dev):
        """Flat (2-level) refined solve.

        factors: DeviceSchurFactors (explicit float32 inverses).
        Returns (xi (B, ni) float64 np, xj (njg,) float64 np,
        {"solve_rel": float, "solve_rounds": int})."""
        Ainv, Y, Sinv, di, dj, djg, Nij_s = factors.factors
        xi, xj, rel, k = _flat_prog(
            self.dims, self.policy, self._pm is not None,
            vals_dev, mmc_dev, *self._common_args(),
            Ainv, Y, Sinv, di, dj, djg, Nij_s, factors.jmask32)
        return (xi.cpu().numpy(), xj.cpu().numpy()[:self.njg],
                {"solve_rel": float(rel), "solve_rounds": int(k)})

    def solve_nested(self, factors, vals_dev, mmc_dev):
        """Nested (3-level) refined solve.

        factors: NestedSchurFactors (float32, resident).
        Returns (xi (B, ni) float64 np, xj (njg,) float64 np,
        {"solve_rel": float, "solve_rounds": int})."""
        xi, xj, rel, k = _nested_prog(
            self.dims, self.policy, self._pm is not None,
            vals_dev, mmc_dev, *self._common_args(), factors,
            self._gidx_for(factors))
        return (xi.cpu().numpy(), xj.cpu().numpy()[:self.njg],
                {"solve_rel": float(rel), "solve_rounds": int(k)})

    def _gidx_for(self, factors):
        """Junction-reconstruction gather index of the factors' partition
        (constant per topology, uploaded once)."""
        if self._gidx is None:
            from ..parallel.schur import _nested_gidx
            self._gidx = self.da._putr(
                _nested_gidx(factors.part, factors.nsj_total),
                torch.int64)
        return self._gidx
