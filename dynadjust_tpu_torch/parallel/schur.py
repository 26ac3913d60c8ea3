"""Two-level Schur complement solver of the blocked adjustment (flat).

Every block eliminates its inner stations independently — a batched
dense factorization — and the junction (interface) system is reduced
across blocks, solved once, and back-substituted in parallel:

    per block b (batched):
        N_b = [Nii Nij; Nji Njj]
        S_b = Njj − Nji Nii⁻¹ Nij          (Schur complement onto junctions)
    global junction system:
        S = Σ_b scatter(S_b),  x_j = S⁻¹ t
    back-substitution (batched):
        x_i(b) = Nii⁻¹ (bi − Nij x_j(b))

Algebraically the simultaneous solution — the cross-check the reference
relies on — with O(1) batched factorizations instead of the reference's
sequential forward/reverse block sweeps (dnaadjust.cpp:2756/3461).

Port of the flat subset of the JAX package's ``parallel/schur.py`` on
one device: factors are float32 explicit inverses (level-1 through the
Cholesky-inverse kernel, ops/blocked_chol.py), every apply is a matmul,
and float64 residual refinement (adjust/device_solve.py) restores
float64 accuracy.  Blocks are padded to uniform shapes: identity padding
on the diagonal keeps padded factorizations defined and the padded
entries inert.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function


@dataclass
class BlockSystem:
    """Padded batched block normal systems.

    B blocks, ni_max inner params, nj_max junction params per block,
    nj_global total junction params.  The normals pools are numpy arrays
    (host-assembled) or torch tensors (device-assembled).
    """
    Nii: np.ndarray         # (B, ni, ni)
    Nij: np.ndarray         # (B, ni, nj)
    Njj: np.ndarray         # (B, nj, nj)
    bi: np.ndarray          # (B, ni)
    bj: np.ndarray          # (B, nj)
    jmap: np.ndarray        # (B, nj) global junction param index (or filler)
    jmask: np.ndarray       # (B, nj) 1.0 for real junction params
    imask: np.ndarray       # (B, ni) 1.0 for real inner params
    nj_global: int

    # owner/scatter plans are pure topology — cached per BlockSystem so
    # no per-solve Python proportional to B*nj remains on the iteration
    # path (callers that rebuild normals for an unchanged topology should
    # carry them over via copy_topology_caches)
    _owner_idx_cache: tuple = None
    _owner_mask_cache: np.ndarray = None

    def owner_indices(self):
        """(flat positions, global ids): one owner slot per junction
        param (see _owner_indices)."""
        if self._owner_idx_cache is None:
            self._owner_idx_cache = _owner_indices(self.jmap, self.jmask)
        return self._owner_idx_cache

    def owner_mask(self):
        if self._owner_mask_cache is None:
            self._owner_mask_cache = _owner_mask(self.jmap, self.jmask)
        return self._owner_mask_cache

    def copy_topology_caches(self, other: "BlockSystem"):
        """Adopt another system's cached plans (same jmap/jmask)."""
        self._owner_idx_cache = other._owner_idx_cache
        self._owner_mask_cache = other._owner_mask_cache


def build_block_system(block_N, block_rhs, block_inner_idx, block_junc_idx,
                       junction_global_idx, dtype=np.float64) -> BlockSystem:
    """Assemble a BlockSystem from per-block dense normals.

    block_N[b]: (n_b, n_b) full block normals (inner+junction params)
    block_rhs[b]: (n_b,)
    block_inner_idx[b]: local param indices of inner params
    block_junc_idx[b]: local param indices of junction params
    junction_global_idx[b]: global junction param index for each junction
        param of block b
    """
    B = len(block_N)
    ni = max((len(i) for i in block_inner_idx), default=1) or 1
    nj = max((len(j) for j in block_junc_idx), default=1) or 1
    nj_global = int(max((np.max(g) for g in junction_global_idx
                         if len(g)), default=-1)) + 1

    Nii = np.zeros((B, ni, ni), dtype=dtype)
    Nij = np.zeros((B, ni, nj), dtype=dtype)
    Njj = np.zeros((B, nj, nj), dtype=dtype)
    bi = np.zeros((B, ni), dtype=dtype)
    bj = np.zeros((B, nj), dtype=dtype)
    jmap = np.zeros((B, nj), dtype=np.int32)
    jmask = np.zeros((B, nj), dtype=dtype)
    imask = np.zeros((B, ni), dtype=dtype)

    for b in range(B):
        ii = np.asarray(block_inner_idx[b], dtype=np.int64)
        jj = np.asarray(block_junc_idx[b], dtype=np.int64)
        N = np.asarray(block_N[b], dtype=dtype)
        r = np.asarray(block_rhs[b], dtype=dtype)
        ki, kj = len(ii), len(jj)
        Nii[b, :ki, :ki] = N[np.ix_(ii, ii)]
        if kj:
            Nij[b, :ki, :kj] = N[np.ix_(ii, jj)]
            Njj[b, :kj, :kj] = N[np.ix_(jj, jj)]
            bj[b, :kj] = r[jj]
            jmap[b, :kj] = junction_global_idx[b]
            jmask[b, :kj] = 1.0
        bi[b, :ki] = r[ii]
        imask[b, :ki] = 1.0
        # identity padding keeps the factorization defined
        for k in range(ki, ni):
            Nii[b, k, k] = 1.0
        # padded junction slots map to a scratch global slot (masked out)
        jmap[b, kj:] = nj_global
    return BlockSystem(Nii=Nii, Nij=Nij, Njj=Njj, bi=bi, bj=bj,
                       jmap=jmap, jmask=jmask, imask=imask,
                       nj_global=nj_global)


def _owner_mask(jmap, jmask):
    """(B, nj) mask with 1.0 at exactly one (block, slot) per global
    junction param — the slot that 'owns' the junction residual when a
    global vector is distributed back to block rhs form."""
    B, nj = jmap.shape
    mask = np.zeros((B, nj))
    seen = set()
    for b in range(B):
        for k in range(nj):
            g = int(jmap[b, k])
            if jmask[b, k] > 0 and g not in seen:
                seen.add(g)
                mask[b, k] = 1.0
    return mask


def _owner_indices(jmap, jmask):
    """One owner slot per global junction param: (flat positions into the
    (B*nj) block-rhs array, corresponding global param ids)."""
    flat = jmap.reshape(-1)
    mask = jmask.reshape(-1) > 0
    first_idx = {}
    for k in np.nonzero(mask)[0]:
        g = int(flat[k])
        if g not in first_idx:
            first_idx[g] = int(k)
    gi = np.fromiter(first_idx.values(), dtype=np.int32)
    gg = np.fromiter(first_idx.keys(), dtype=np.int32)
    return gi, gg


def _scatter_global(vals_b, jmap, nj_total):
    """(nj_total,) sum of per-block junction values into global slots."""
    out = torch.zeros(nj_total, dtype=vals_b.dtype, device=vals_b.device)
    return out.index_add_(0, jmap.reshape(-1), vals_b.reshape(-1))


def _scatter_junction_matrix(S_b, jmap, nj_total):
    """(nj_total, nj_total) sum of per-block Schur pieces, with the
    unused (scratch) diagonal slots identity-padded."""
    nj = jmap.shape[1]
    flat = (jmap[:, :, None] * nj_total + jmap[:, None, :]).reshape(-1)
    S = torch.zeros(nj_total * nj_total, dtype=S_b.dtype, device=S_b.device)
    S = S.index_add_(0, flat, S_b.reshape(-1)).reshape(nj_total, nj_total)
    diag = torch.diagonal(S)
    return S + torch.diag(torch.where(diag == 0.0, 1.0, 0.0).to(S.dtype))


def _unity_scale(Nii, Nij, Njj, bi, bj, jmap, jmask, nj_total):
    """Diagonal unity scaling of the full blocked system.

    The reference's --scale-normals-to-unity (Solve, dnaadjust.cpp:6614)
    generalised to the blocked layout: junction parameters appear in
    several blocks, so their global diagonal is reduced first to keep one
    consistent scale factor per parameter.  Essential for float32
    factorizations — the constraint dynamic range otherwise swamps the
    float32 mantissa.  Returns scaled system + (di, dj_block, djg)."""
    dii = torch.diagonal(Nii, dim1=-2, dim2=-1)
    djj = torch.diagonal(Njj, dim1=-2, dim2=-1) * jmask
    dj_global = _scatter_global(djj, jmap, nj_total)
    dj_global = torch.where(dj_global <= 0.0, 1.0, dj_global)
    djg = 1.0 / torch.sqrt(dj_global)          # (nj_total,) global factors
    di = 1.0 / torch.sqrt(torch.where(dii <= 0.0, 1.0, dii))
    dj = djg[jmap]
    dj = torch.where(jmask > 0, dj, 1.0)
    Nii = Nii * di[:, :, None] * di[:, None, :]
    Nij = Nij * di[:, :, None] * dj[:, None, :]
    Njj = Njj * dj[:, :, None] * dj[:, None, :]
    bi = bi * di
    bj = bj * dj
    return Nii, Nij, Njj, bi, bj, di, dj, djg


def _schur_factor_inv(Nii, Nij, Njj, jmap, jmask, nj_total):
    """Explicit-inverse factorization (the reference's dpotrf+dpotri,
    dnamatrix_contiguous.cpp:963-1006): returns (Ainv, Y, Sinv, di, dj,
    djg, Nij_s), every later apply a matmul.  The level-1 factor is the
    Cholesky-inverse kernel (ops/blocked_chol.block_reduce)."""
    from ..ops.blocked_chol import block_reduce
    from ..ops.recursive_inv import spd_inverse_rec_safe
    zero_b = torch.zeros_like(Nii[..., 0])
    zero_j = torch.zeros_like(Njj[..., 0])
    Nii_s, Nij_s, Njj_s, _, _, di, dj, djg = _unity_scale(
        Nii, Nij, Njj, zero_b, zero_j, jmap, jmask, nj_total)
    Ainv, Y, S_b = block_reduce(Nii_s, Nij_s, Njj_s)
    with record_function("dta.junction"):
        S_b = S_b * jmask[:, :, None] * jmask[:, None, :]
        S = _scatter_junction_matrix(S_b, jmap, nj_total)
        Sinv = spd_inverse_rec_safe(S[None])[0]
    return Ainv, Y, Sinv, di, dj, djg, Nij_s


def _schur_apply_inv_core(Ainv, Y, Sinv, di, dj, djg, Nij_s, bi, bj,
                          jmap, jmask, nj_total):
    """Solve with explicit inverses — matmuls only."""
    bi = bi * di
    bj = bj * dj
    w = torch.einsum("bij,bj->bi", Ainv, bi)
    t_b = (bj - torch.einsum("bki,bk->bi", Nij_s, w)) * jmask
    t = _scatter_global(t_b, jmap, nj_total)
    xj = Sinv @ t
    xj_b = xj[jmap] * jmask
    xi = (w - torch.einsum("bij,bj->bi", Y, xj_b)) * di
    return xi, xj * djg


def _newton_loop(A0, Nb, mm, max_rounds, tol):
    """Residual-driven Newton–Schulz A ← A(2I − N·A).

    Each round carries the live inverse residual err = max|I − N·A|; the
    loop stops at err ≤ tol, at max_rounds, or when a round stops halving
    the residual.  Returns (A, rounds_used, err_final) — the measured
    accuracy of the refined inverse is evidence, not an assumption (the
    rigour bar of the reference's f64 dpotri,
    dnamatrix_contiguous.cpp:996-1006)."""
    n = A0.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=A0.device)
    eye2 = 2.0 * eye

    def measure(A):
        T = eye2 - mm(Nb, A)          # T = 2I − N·A; I − N·A = T − I
        return T, float((T - eye).abs().max())

    A = A0.to(torch.float64)
    T, err = measure(A)
    prev, k = np.inf, 0
    while k < max_rounds and err > tol and err < 0.5 * prev:
        A = mm(A, T)
        A = 0.5 * (A + A.transpose(-1, -2))
        prev = err
        T, err = measure(A)
        k += 1
    return A, k, err


def _newton_l1_chunk(Nii_c, Nij_c, Njj_c, di_c, dj_c, Ainv_c, max_rounds,
                     tol):
    """Float64 Newton–Schulz on one chunk of level-1 inverses: returns
    (refined Ainv, Y = Ainv·Nij, Schur piece S, rounds_used, err)."""
    from ..ops.slicegemm import mm64
    Nii_c = Nii_c * di_c[:, :, None] * di_c[:, None, :]
    Nij_c = Nij_c * di_c[:, :, None] * dj_c[:, None, :]
    Njj_c = Njj_c * dj_c[:, :, None] * dj_c[:, None, :]
    A, k, err = _newton_loop(Ainv_c, Nii_c, mm64, max_rounds, tol)
    Y = mm64(A, Nij_c)
    S_c = Njj_c - mm64(Nij_c, Y, transa=True)
    return A, Y, S_c, k, err


def _newton_flat_junction(S_b, jmap, jmask64, Sinv32, nj_total,
                          max_rounds, tol):
    """Scatter the refined float64 Schur pieces into the global junction
    system and Newton-refine its inverse from the float32 one.  Returns
    (Sinv64, err) with the measured max|I − S·Sinv|."""
    from ..ops.slicegemm import mm64
    S_b = S_b * jmask64[:, :, None] * jmask64[:, None, :]
    S = _scatter_junction_matrix(S_b, jmap, nj_total)
    Si, _, err = _newton_loop(Sinv32, S, mm64, max_rounds, tol)
    return Si, err


class DeviceSchurFactors:
    """Device-resident mixed-precision blocked factors (the JAX package's
    method 'inv': explicit inverses).

    The blocked system's float32 normals pools are device tensors
    (adjust/device_assembly.py); the factorization runs in float32 and
    keeps explicit inverses, so every apply is a matmul.  Float64
    residuals come from the caller's A-based operator
    (adjust/device_solve.py)."""

    def __init__(self, bs: BlockSystem):
        if isinstance(bs.Nii, np.ndarray):
            raise ValueError("DeviceSchurFactors takes device-assembled "
                             "normals (torch tensors)")
        self.bs = bs
        self.nj_total = bs.nj_global + 1
        self.dtype = torch.float32
        self.device = bs.Nii.device

        def put(x, dt):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        self.jmap = put(bs.jmap, torch.int64)
        self.jmask32 = put(bs.jmask, self.dtype)
        self.jmask64 = put(bs.jmask, torch.float64)
        self._N32 = (bs.Nii.to(self.dtype), bs.Nij.to(self.dtype),
                     bs.Njj.to(self.dtype))
        self.refactor()

    def update(self, bs: BlockSystem):
        """Re-linearised normals for the same topology: swap the pools and
        refactor — the index/mask/owner tensors stay resident."""
        if tuple(bs.Nii.shape) != tuple(self.bs.Nii.shape):
            raise ValueError("update() requires the same block topology")
        self.bs = bs
        self._N32 = (bs.Nii.to(self.dtype), bs.Nij.to(self.dtype),
                     bs.Njj.to(self.dtype))
        self.refactor()

    def refactor(self):
        """(Re)factor the resident float32 normals."""
        self.factors = _schur_factor_inv(*self._N32, self.jmap,
                                         self.jmask32, self.nj_total)

    def solve_device(self, bi, bj):
        """One float32 apply of the factors; rhs and results stay on the
        device (the caller drives the float64 refinement)."""
        bi = torch.as_tensor(bi, device=self.device).to(self.dtype)
        bj = torch.as_tensor(bj, device=self.device).to(self.dtype)
        return _schur_apply_inv_core(*self.factors, bi, bj, self.jmap,
                                     self.jmask32, self.nj_total)

    def newton_factors(self, rounds: int = None, N64=None):
        """Float64 Newton-refined covariance factors (one-time, for the
        variance-extraction stage after convergence) against the float64
        normals pools N64 (DeviceAssembly.build_f64()).

        Rounds are residual-driven (_newton_loop; evidence stored in
        self.cov_refine_evidence).  The level-1 refinement runs in block
        chunks under DTA_NEWTON_CHUNK_BYTES of float64 workspace.

        The default tolerance is 1e-12, not the JAX package's 3e-9: there
        the products are mantissa-sliced on the TPU and a round costs
        several bf16 passes, here a round is two native float64 matmuls.
        At 3e-9 one Newton round lands just under the target on the
        10,000-station network (max|I − N·A| 2.6e-9, measured on an H100),
        so two runs whose float32 starting inverses differ in rounding
        give covariances that differ at ~1e-9; at 1e-12 the second round
        takes both to the float64 floor."""
        if rounds is None:
            rounds = int(os.environ.get("DTA_NEWTON_ROUNDS", 6))
        tol = float(os.environ.get("DTA_NEWTON_TOL", 1e-12))
        if N64 is None:
            raise ValueError("device-assembled normals: pass N64 "
                             "(DeviceAssembly.build_f64())")
        Ainv, Yf, Sinv, di, dj, djg, _ = self.factors
        B, ni = Ainv.shape[:2]
        nj = N64[2].shape[-1]
        per_block = 8.0 * (6.0 * ni * ni + 3.0 * ni * nj)
        budget = float(os.environ.get("DTA_NEWTON_CHUNK_BYTES", 8e9))
        want = max(1, int(budget / per_block))
        C = next(c for c in range(min(want, B), 0, -1) if B % c == 0)
        evid = {"l1_err": 0.0, "l1_rounds": 0, "tol": tol,
                "max_rounds": rounds}
        f64 = torch.float64
        parts, ev_parts = [], []
        for k in range(B // C):
            s = slice(k * C, (k + 1) * C)
            A_c, Y_c, S_c, k_used, err_c = _newton_l1_chunk(
                N64[0][s], N64[1][s], N64[2][s], di[s].to(f64),
                dj[s].to(f64), Ainv[s], rounds, tol)
            ev_parts.append((k_used, err_c))
            parts.append((A_c, Y_c, S_c))
        evid["l1_err"] = max([e for _, e in ev_parts], default=0.0)
        evid["l1_rounds"] = max([k for k, _ in ev_parts], default=0)
        A64 = torch.cat([p[0] for p in parts])
        Y64 = torch.cat([p[1] for p in parts])
        S_b = torch.cat([p[2] for p in parts])
        Si64, j_err = _newton_flat_junction(
            S_b, self.jmap, self.jmask64, Sinv, self.nj_total, rounds, tol)
        evid["junction_err"] = j_err
        self.cov_refine_evidence = evid
        Nij_s64 = N64[1] * di.to(f64)[:, :, None] * dj.to(f64)[:, None, :]
        return (A64, Y64, Si64, di.to(f64), dj.to(f64), djg.to(f64),
                Nij_s64)
