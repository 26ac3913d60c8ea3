"""Fully device-resident Gauss-Newton adjustment for blocked GNSS networks.

The reference re-assembles normals and solves on the host every iteration
(PrepareAdjustmentBlock + Solve, dnaadjust.cpp:2873/6586).  Here the whole
loop lives on the device: the network topology (measurement scatter plan,
constant GPS normals, factorization) is uploaded once, and each iteration
is one _gn_step — rhs scatter-assembly, factored Schur apply, float64
residual refinement on the device, and the coordinate update.  The host
sees a single max-correction scalar per iteration.

Port of the JAX package's ``parallel/device_adjust.py``.  Its one jitted
step is a plain torch function here, its operations queued on the device
in order with no host sync inside; the factors are the explicit float32
inverses of parallel/schur.py::_schur_factor_inv (level 1 on the
Cholesky-inverse kernel).  The scatters are index_add_ on float64 tensors,
with int64 indices and a scratch slot (rhs pools) or row (stations) at the
end for padded entries; on a card they use atomics, so the sums are not
bitwise reproducible from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import AssemblyPlan, build_plan
from .blocked_adjust import BlockedNetwork
from .schur import (_device, _device_solve_refined, _owner_mask, _put,
                    _schur_factor_inv, _torch_dtype)


def _gn_step(x, Ainv, Y, Sinv, di, dj, djg, Nij_s,
             Nii64, Nij64, Njj64,
             pi, pj, obs, weight,
             bi1, bi2, bj1, bj2,
             inner_stn, junc_stn,
             jmap, jmask32, jmask64, imask64, owner64,
             nj_total, refine, B, ni, nj):
    """One Gauss-Newton iteration on the device: assemble rhs, refined
    solve, update coordinates.  Returns (x_new, max_corr), both device
    tensors."""
    S = x.shape[0]
    mmc = obs - (x[pj] - x[pi])                     # (M, 3) f64
    wm = (weight[:, None] * mmc).reshape(-1)

    # rhs scatter (scratch slot at the end absorbs remapped -1 indices)
    bi = x.new_zeros(B * ni + 1)
    bi.index_add_(0, bi1.reshape(-1), -wm)
    bi.index_add_(0, bi2.reshape(-1), wm)
    bj = x.new_zeros(B * nj + 1)
    bj.index_add_(0, bj1.reshape(-1), -wm)
    bj.index_add_(0, bj2.reshape(-1), wm)
    bi = bi[:B * ni].reshape(B, ni)
    bj = bj[:B * nj].reshape(B, nj)

    xi, xj = _device_solve_refined(
        Ainv, Y, Sinv, di, dj, djg, Nij_s, Nii64, Nij64, Njj64,
        bi, bj, jmap, jmask32, jmask64, imask64, owner64,
        nj_total, refine, "inv")

    # scatter corrections back to station layout (scratch row S); the
    # junction stations are set, not added
    dx = x.new_zeros(S + 1, 3)
    dxi = (xi * imask64).reshape(B, ni // 3, 3)
    dx.index_add_(0, inner_stn.reshape(-1), dxi.reshape(-1, 3))
    njg = junc_stn.shape[0]
    dx[junc_stn] = xj[:3 * njg].reshape(-1, 3)
    dx = dx[:S]
    max_corr = dx.abs().max()
    return x + dx, max_corr


class DeviceAdjustment:
    """Device-resident Gauss-Newton loop over an AssemblyPlan.

    For GPS-baseline networks the design is constant (±I), so the blocked
    normals and their factorization are built once, on `device` (the card
    by default); every iteration is one _gn_step.
    """

    def __init__(self, plan: AssemblyPlan, dtype=np.float32,
                 refine: int = 2, device=None):
        bn = plan.bn
        self.plan = plan
        self.refine = refine
        self.device = dev = _device(device)
        B = len(bn.blocks)
        self.B, self.ni, self.nj = B, plan.ni, plan.nj
        self.nj_total = plan.nj_global + 1
        f64, i64 = torch.float64, torch.int64
        dt = _torch_dtype(dtype)

        Nii, Nij, Njj = plan.N_struct
        self.Nii64 = _put(Nii, dev, f64)
        self.Nij64 = _put(Nij, dev, f64)
        self.Njj64 = _put(Njj, dev, f64)
        self.jmap = _put(plan.jmap, dev, i64)
        self.jmask32 = _put(plan.jmask, dev, dt)
        self.jmask64 = _put(plan.jmask, dev, f64)
        self.imask64 = _put(plan.imask, dev, f64)
        self.owner64 = _put(_owner_mask(plan.jmap, plan.jmask), dev, f64)

        self.pi = _put(bn.pairs[:, 0], dev, i64)
        self.pj = _put(bn.pairs[:, 1], dev, i64)
        self.obs = _put(bn.obs, dev, f64)
        self.weight = _put(bn.weight, dev, f64)

        def remap(idx, scratch):
            out = idx.astype(np.int64)
            out[out < 0] = scratch
            return _put(out, dev)

        self.bi1 = remap(plan.bi_idx_1, B * plan.ni)
        self.bi2 = remap(plan.bi_idx_2, B * plan.ni)
        self.bj1 = remap(plan.bj_idx_1, B * plan.nj)
        self.bj2 = remap(plan.bj_idx_2, B * plan.nj)

        # per-block inner station ids (filler = scratch row S)
        S = bn.nstations
        inner_stn = np.full((B, plan.ni // 3), S, dtype=np.int64)
        for b, (inner, junc) in enumerate(bn.blocks):
            inner_stn[b, :len(inner)] = inner
        self.inner_stn = _put(inner_stn, dev)
        self.junc_stn = _put(bn.junction_stations, dev, i64)

        self.factors = _schur_factor_inv(
            self.Nii64.to(dt), self.Nij64.to(dt), self.Njj64.to(dt),
            self.jmap, self.jmask32, self.nj_total)

    def step(self, x_dev):
        """(x_new, max_corr) of one iteration from device coordinates;
        nothing waits on the device."""
        return _gn_step(
            x_dev, *self.factors, self.Nii64, self.Nij64, self.Njj64,
            self.pi, self.pj, self.obs, self.weight,
            self.bi1, self.bi2, self.bj1, self.bj2,
            self.inner_stn, self.junc_stn,
            self.jmap, self.jmask32, self.jmask64, self.imask64,
            self.owner64,
            self.nj_total, self.refine, self.B, self.ni, self.nj)

    def run(self, x0, max_iterations: int = 10, threshold: float = 0.0005):
        """Gauss-Newton to convergence.  Returns (x, iterations, max_corr,
        history)."""
        x = _put(x0, self.device, torch.float64)
        history = []
        max_corr = np.inf
        for it in range(1, max_iterations + 1):
            x, mc = self.step(x)
            max_corr = float(mc)                     # one scalar sync
            history.append(max_corr)
            if max_corr <= threshold:
                return x.cpu().numpy(), it, max_corr, history
        return x.cpu().numpy(), max_iterations, max_corr, history


def adjust_blocked_device(bn: BlockedNetwork, x0, free_sd: float = 10.0,
                          max_iterations: int = 10,
                          threshold: float = 0.0005,
                          dtype=np.float32, refine: int = 2, device=None):
    """Device-resident counterpart of adjust_blocked (GPS networks), on
    `device` (the card by default)."""
    plan = build_plan(bn, 1.0 / (free_sd * free_sd))
    adj = DeviceAdjustment(plan, dtype=dtype, refine=refine, device=device)
    return adj.run(x0, max_iterations, threshold)
