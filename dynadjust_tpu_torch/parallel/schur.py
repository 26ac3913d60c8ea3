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

Port of the JAX package's ``parallel/schur.py`` on one device: factors
are float32 explicit inverses (level-1 through the Cholesky-inverse
kernel, ops/blocked_chol.py), every apply is a matmul, and float64
residual refinement restores float64 accuracy — on the device
(adjust/device_solve.py) or in the host loops of this module
(schur_solve_device_refined, schur_solve_nested_factored) against the
host operator _block_matvec or DeviceAssembly.matvec.  Blocks are padded
to uniform shapes: identity padding on the diagonal keeps padded
factorizations defined and the padded entries inert.  The host-streamed
nested factors are in parallel/streamed.py.
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


def _block_matvec(bs: BlockSystem, xi, xj):
    """y = N x for the blocked system, in float64 on the host, from its
    host (numpy) normals pools.  Junction rows accumulate across blocks
    (the same scatter structure as the Schur reduction).  The JAX
    package's native C++ kernel for the block products is not ported:
    these are numpy matmuls."""
    xj_pad = np.concatenate([xj, [0.0]])     # scratch slot for padded maps
    xj_b = xj_pad[bs.jmap] * bs.jmask
    yi = (np.matmul(bs.Nii, xi[:, :, None])[:, :, 0]
          + np.matmul(bs.Nij, xj_b[:, :, None])[:, :, 0])
    yj_b = (np.matmul(xi[:, None, :], bs.Nij)[:, 0, :]
            + np.matmul(bs.Njj, xj_b[:, :, None])[:, :, 0]) * bs.jmask
    yj = np.zeros(bs.nj_global + 1)
    np.add.at(yj, bs.jmap.reshape(-1), yj_b.reshape(-1))
    return yi * bs.imask, yj[:bs.nj_global]


def _gather_rhs_junction(bs: BlockSystem):
    """(nj_global,) junction rhs summed over the blocks that share it."""
    t = np.zeros(bs.nj_global + 1)
    np.add.at(t, bs.jmap.reshape(-1), (bs.bj * bs.jmask).reshape(-1))
    return t[:bs.nj_global]


def _scaled(Nii, Nij, Njj, di, dj):
    """The blocked normals scaled by the unity scale vectors."""
    return (Nii * di[:, :, None] * di[:, None, :],
            Nij * di[:, :, None] * dj[:, None, :],
            Njj * dj[:, :, None] * dj[:, None, :])


def _unity_scale(Nii, Nij, Njj, bi, bj, jmap, jmask, nj_total):
    """Diagonal unity scaling of the full blocked system.

    The reference's --scale-normals-to-unity (Solve, dnaadjust.cpp:6614)
    generalised to the blocked layout: junction parameters appear in
    several blocks, so their global diagonal is reduced first to keep one
    consistent scale factor per parameter.  Essential for float32
    factorizations — the constraint dynamic range otherwise swamps the
    float32 mantissa.  Returns scaled system + (di, dj_block, djg)."""
    di, dj, djg = _nested_scale_vecs(Nii, Njj, jmap, jmask, nj_total)
    Nii, Nij, Njj = _scaled(Nii, Nij, Njj, di, dj)
    bi = bi * di
    bj = bj * dj
    return Nii, Nij, Njj, bi, bj, di, dj, djg


def _nested_scale_vecs(Nii, Njj, jmap, jmask, nj_total):
    """Unity scale vectors (di, dj_block, djg) from the blocked diagonals;
    the scaling itself happens where the pools are factored."""
    dii = torch.diagonal(Nii, dim1=-2, dim2=-1)
    djj = torch.diagonal(Njj, dim1=-2, dim2=-1) * jmask
    dj_global = _scatter_global(djj, jmap, nj_total)
    dj_global = torch.where(dj_global <= 0.0, 1.0, dj_global)
    djg = 1.0 / torch.sqrt(dj_global)          # (nj_total,) global factors
    di = 1.0 / torch.sqrt(torch.where(dii <= 0.0, 1.0, dii))
    dj = torch.where(jmask > 0, djg[jmap], 1.0)
    return di, dj, djg


def _junction_inverse(S_b, jmap, jmask, nj_total):
    """Scatter masked per-block Schur pieces into the global junction
    system and invert it."""
    from ..ops.recursive_inv import spd_inverse_rec_safe
    S_b = S_b * jmask[:, :, None] * jmask[:, None, :]
    S = _scatter_junction_matrix(S_b, jmap, nj_total)
    return spd_inverse_rec_safe(S[None])[0]


def _schur_factor_inv(Nii, Nij, Njj, jmap, jmask, nj_total):
    """Explicit-inverse factorization (the reference's dpotrf+dpotri,
    dnamatrix_contiguous.cpp:963-1006): returns (Ainv, Y, Sinv, di, dj,
    djg, Nij_s), every later apply a matmul.  The level-1 factor is the
    Cholesky-inverse kernel (ops/blocked_chol.block_reduce)."""
    from ..ops.blocked_chol import block_reduce
    zero_b = torch.zeros_like(Nii[..., 0])
    zero_j = torch.zeros_like(Njj[..., 0])
    Nii_s, Nij_s, Njj_s, _, _, di, dj, djg = _unity_scale(
        Nii, Nij, Njj, zero_b, zero_j, jmap, jmask, nj_total)
    Ainv, Y, S_b = block_reduce(Nii_s, Nij_s, Njj_s)
    with record_function("dta.junction"):
        Sinv = _junction_inverse(S_b, jmap, jmask, nj_total)
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
    Nii_c, Nij_c, Njj_c = _scaled(Nii_c, Nij_c, Njj_c, di_c, dj_c)
    A, k, err = _newton_loop(Ainv_c, Nii_c, mm64, max_rounds, tol)
    Y = mm64(A, Nij_c)
    S_c = Njj_c - mm64(Nij_c, Y, transa=True)
    return A, Y, S_c, k, err


def _newton_policy(rounds=None):
    """(max rounds, tolerance) of the float64 Newton refinement of the
    covariance factors: DTA_NEWTON_ROUNDS (6) and DTA_NEWTON_TOL (1e-12;
    see DeviceSchurFactors.newton_factors for why not the JAX package's
    3e-9)."""
    if rounds is None:
        rounds = int(os.environ.get("DTA_NEWTON_ROUNDS", 6))
    return rounds, float(os.environ.get("DTA_NEWTON_TOL", 1e-12))


def _newton_chunk(B, ni, nj):
    """Blocks per chunk of the level-1 Newton refinement: a divisor of B
    whose float64 workspace (~6 ni² + 3 ni·nj per block) stays under
    DTA_NEWTON_CHUNK_BYTES."""
    per_block = 8.0 * (6.0 * ni * ni + 3.0 * ni * nj)
    budget = float(os.environ.get("DTA_NEWTON_CHUNK_BYTES", 8e9))
    want = max(1, int(budget / per_block))
    return next(c for c in range(min(want, B), 0, -1) if B % c == 0)


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
    method 'inv': explicit inverses, in its device_f64=False mode).

    The factorization runs in float32 on the device and keeps explicit
    inverses, so every apply is a matmul.  The float32 pools are a cast
    of device-assembled normals (adjust/device_assembly.py), or host
    (numpy) normals cast to float32 on the host and uploaded — no float64
    normals live on the device.  Float64 residuals come from the caller:
    the A-based device operator (adjust/device_solve.py) or the host loop
    (schur_solve_device_refined).

    device: where the factors live — the pools' device for tensors, else
    "cuda"."""

    def __init__(self, bs: BlockSystem, device=None):
        self.bs = bs
        self.nj_total = bs.nj_global + 1
        self.dtype = torch.float32
        self.B_real = bs.Nii.shape[0]
        self.device_normals = isinstance(bs.Nii, torch.Tensor)
        if device is None:
            device = bs.Nii.device if self.device_normals else "cuda"
        self.device = torch.device(device)

        def put(x, dt):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        self.jmap = put(bs.jmap, torch.int64)
        self.jmask32 = put(bs.jmask, self.dtype)
        self.jmask64 = put(bs.jmask, torch.float64)
        self._N32 = self._pools32(bs)
        self.refactor()

    def _pools32(self, bs: BlockSystem):
        """The float32 normals pools on the device."""
        if self.device_normals:
            return tuple(a.to(self.device, self.dtype)
                         for a in (bs.Nii, bs.Nij, bs.Njj))
        return tuple(torch.as_tensor(np.asarray(a, dtype=np.float32),
                                     device=self.device)
                     for a in (bs.Nii, bs.Nij, bs.Njj))

    def update(self, bs: BlockSystem):
        """Re-linearised normals for the same topology: swap the pools and
        refactor — the index/mask/owner tensors stay resident."""
        if tuple(bs.Nii.shape) != tuple(self.bs.Nii.shape):
            raise ValueError("update() requires the same block topology")
        self.bs = bs
        self._N32 = self._pools32(bs)
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

    def solve(self, bi, bj):
        """One float32 apply from host rhs pools: (xi (B, ni), xj (njg,))
        float64 numpy; the float64 refinement is the host loop's
        (schur_solve_device_refined)."""
        xi, xj = self.solve_device(bi, bj)
        return (xi.double().cpu().numpy()[:self.B_real],
                xj.double().cpu().numpy()[:self.bs.nj_global])

    def newton_factors(self, rounds: int = None, N64=None):
        """Float64 Newton-refined covariance factors (one-time, for the
        variance-extraction stage after convergence) against the float64
        normals pools N64 (DeviceAssembly.build_f64()); N64=None takes the
        host-assembled system's own float64 pools (bs).

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
        rounds, tol = _newton_policy(rounds)
        if N64 is None:
            if self.device_normals:
                raise ValueError("device-assembled normals: pass N64 "
                                 "(DeviceAssembly.build_f64())")
            # host-assembled: one float64 upload of the host pools
            N64 = tuple(torch.as_tensor(a, dtype=torch.float64,
                                        device=self.device)
                        for a in (self.bs.Nii, self.bs.Nij, self.bs.Njj))
        Ainv, Yf, Sinv, di, dj, djg, _ = self.factors
        B = Ainv.shape[0]
        C = _newton_chunk(B, Ainv.shape[1], N64[2].shape[-1])
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


def _host_residual(bs: BlockSystem, matvec, xi, xj, rhs_j_global,
                   rhs_scale):
    """(ri, rj, rel): the float64 residual of (xi, xj) and its relative
    size against the rhs."""
    yi, yj = matvec(xi, xj)
    ri = (bs.bi * bs.imask) - yi
    rj = rhs_j_global - yj
    rel = max(float(np.abs(ri).max()), float(np.abs(rj).max())) / rhs_scale
    return ri, rj, rel


def _owned_rhs(bs: BlockSystem, rj):
    """The junction residual distributed back to block rhs form: the
    full residual to one owner slot per junction param."""
    gi, gg = bs.owner_indices()      # cached per topology
    rj_b = np.zeros_like(bs.bj).reshape(-1)
    rj_b[gi] = rj[gg]
    return rj_b.reshape(bs.bj.shape)


def schur_solve_device_refined(bs: BlockSystem,
                               factors: DeviceSchurFactors,
                               max_refine: int = 12, tol: float = 1e-13,
                               matvec=None):
    """Residual-driven mixed-precision solve on float32 device factors.

    Each round applies the factors once on the device; the host measures
    the true float64 residual and re-applies the factors to it until the
    relative residual reaches `tol` or stops halving (up to max_refine
    rounds) — the flat-path counterpart of schur_solve_nested_factored's
    loop.  matvec: the float64 operator (xi, xj) -> N·x; default the host
    normals' _block_matvec, or DeviceAssembly.matvec for device-assembled
    normals.  bs.bi/bs.bj are the host float64 rhs pools."""
    if matvec is None:
        def matvec(xi, xj):
            return _block_matvec(bs, xi, xj)
    xi, xj = factors.solve(bs.bi, bs.bj)
    rhs_j_global = _gather_rhs_junction(bs)
    rhs_scale = max(float(np.abs(bs.bi).max()),
                    float(np.abs(rhs_j_global).max()), 1e-30)
    prev_rel = np.inf
    for _ in range(max_refine):
        ri, rj, rel = _host_residual(bs, matvec, xi, xj, rhs_j_global,
                                     rhs_scale)
        if rel < tol or rel >= 0.5 * prev_rel:
            break
        prev_rel = rel
        di_, dj_ = factors.solve(ri, _owned_rhs(bs, rj))
        xi = xi + di_
        xj = xj + dj_
    return xi, xj


# ---------------------------------------------------------------------------
# nested (three-level) factors
# ---------------------------------------------------------------------------
#
# At national scale the global junction system itself is large.  The
# level-1 blocks are grouped into super-blocks: a junction parameter that
# only blocks of one super-block touch is eliminated at level 2 inside
# that super-block, and only the super-block interfaces form the final
# (small) dense system.  Every level-1 block lies wholly inside one
# super-block, so each S_b scatters into exactly one level-2 block — the
# dense global junction matrix is never formed.  Nested dissection as two
# batched Schur complements (cf. the reference's strictly sequential
# forward/reverse sweeps, dnaadjust.cpp:2756/3461).
#
# Port of the resident single-device subset of the JAX package's nested
# factors (``parallel/schur.py``: NestedPartition .. NestedSchurFactors
# and the covariance refinement); the host-streamed factors and the mesh
# are not part of this package.


@dataclass
class NestedPartition:
    """Level-2 partition of the global junction parameters.

    Super-block param space layout: [0, ni2) inner-junction slots,
    [ni2, ni2+nj2) super-junction slots, slot ni2+nj2 = scratch."""
    sb_of_block: np.ndarray     # (B,) super-block of each level-1 block
    l2slot: np.ndarray          # (B, nj) slot of each junction param in its
                                # super-block's space (scratch for padding)
    SB: int
    ni2: int
    nj2: int
    j2map: np.ndarray           # (SB, nj2) global super-junction index
    j2mask: np.ndarray          # (SB, nj2)
    i2mask: np.ndarray          # (SB, ni2)
    nsj_global: int             # number of super-junction params
    xj_kind: np.ndarray         # (njg,) 0 = inner2, 1 = super-junction
    xj_sb: np.ndarray           # (njg,) source super-block (kind 0)
    xj_slot: np.ndarray         # (njg,) source slot / global index


def build_nested_partition(bs: BlockSystem,
                           block_super: np.ndarray) -> NestedPartition:
    """Derive the level-2 partition from a super-block assignment of the
    level-1 blocks.  A junction param referenced by blocks of a single
    super-block becomes level-2 inner; one shared across super-blocks
    becomes a super-junction."""
    B, nj = bs.jmap.shape
    njg = bs.nj_global
    block_super = np.asarray(block_super, dtype=np.int64)
    SB = int(block_super.max()) + 1 if B else 1

    touched = [set() for _ in range(njg)]
    for b in range(B):
        sb = block_super[b]
        for k in range(nj):
            if bs.jmask[b, k] > 0:
                touched[int(bs.jmap[b, k])].add(int(sb))

    inner2 = [[] for _ in range(SB)]        # global junc param ids
    junc2 = [[] for _ in range(SB)]
    sj_global = {}                          # param id -> global sj index
    for g, sbs in enumerate(touched):
        if len(sbs) == 1:
            inner2[next(iter(sbs))].append(g)
        else:
            sj_global[g] = len(sj_global)
            for sb in sbs:
                junc2[sb].append(g)

    ni2 = max((len(v) for v in inner2), default=1) or 1
    nj2 = max((len(v) for v in junc2), default=1) or 1
    nsj = len(sj_global)

    # per-super-block slot of every junction param
    slot_of = {}                            # (sb, g) -> slot
    j2map = np.zeros((SB, nj2), dtype=np.int32)
    j2mask = np.zeros((SB, nj2))
    i2mask = np.zeros((SB, ni2))
    for sb in range(SB):
        for q, g in enumerate(inner2[sb]):
            slot_of[(sb, g)] = q
            i2mask[sb, q] = 1.0
        for q, g in enumerate(junc2[sb]):
            slot_of[(sb, g)] = ni2 + q
            j2map[sb, q] = sj_global[g]
            j2mask[sb, q] = 1.0

    scratch = ni2 + nj2
    l2slot = np.full((B, nj), scratch, dtype=np.int32)
    for b in range(B):
        sb = int(block_super[b])
        for k in range(nj):
            if bs.jmask[b, k] > 0:
                l2slot[b, k] = slot_of[(sb, int(bs.jmap[b, k]))]

    xj_kind = np.zeros(njg, dtype=np.int32)
    xj_sb = np.zeros(njg, dtype=np.int32)
    xj_slot = np.zeros(njg, dtype=np.int32)
    for g, sbs in enumerate(touched):
        if len(sbs) == 1:
            sb = next(iter(sbs))
            xj_sb[g] = sb
            xj_slot[g] = slot_of[(sb, g)]
        else:
            xj_kind[g] = 1
            xj_slot[g] = sj_global[g]

    return NestedPartition(
        sb_of_block=block_super.astype(np.int32), l2slot=l2slot, SB=SB,
        ni2=ni2, nj2=nj2, j2map=j2map, j2mask=j2mask, i2mask=i2mask,
        nsj_global=nsj, xj_kind=xj_kind, xj_sb=xj_sb, xj_slot=xj_slot)


def _scatter_add(shape, idx, vals):
    """zeros(shape) with vals summed at the flat positions idx."""
    out = torch.zeros(int(np.prod(shape)), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1)).reshape(
        shape)


def _scatter_l2_mats(S_b, sb_of_block, l2slot, SB, ni2, nj2):
    """Scatter per-block Schur pieces directly into the three level-2
    batched arrays (never materialising the full (SB, m2, m2) matrix).
    Symmetric input: the (junction, inner) orientation is recovered from
    the transpose.  Out-of-range slots land in a scratch row/column that
    is cut off."""
    a = l2slot[:, :, None]
    b = l2slot[:, None, :]
    sb = sb_of_block[:, None, None]
    inner_a, inner_b = a < ni2, b < ni2
    junc_a = (a >= ni2) & (a < ni2 + nj2)
    junc_b = (b >= ni2) & (b < ni2 + nj2)
    ia = torch.where(inner_a, a, ni2)
    ib = torch.where(inner_b, b, ni2)
    ja = torch.where(junc_a, a - ni2, nj2)
    jb = torch.where(junc_b, b - ni2, nj2)

    def part(r, c, nr, nc, m):
        idx = (sb * (nr + 1) + r) * (nc + 1) + c
        return _scatter_add((SB, nr + 1, nc + 1), idx,
                            S_b * m)[:, :nr, :nc]

    return (part(ia, ib, ni2, ni2, inner_a & inner_b),
            part(ia, jb, ni2, nj2, inner_a & junc_b),
            part(ja, jb, nj2, nj2, junc_a & junc_b))


def _scatter_l2_rhs(t_b, sb_of_block, l2slot, SB, ni2, nj2):
    sbv = sb_of_block[:, None]
    inner = l2slot < ni2
    junc = (l2slot >= ni2) & (l2slot < ni2 + nj2)
    ii = torch.where(inner, l2slot, ni2)
    jj = torch.where(junc, l2slot - ni2, nj2)
    bi2 = _scatter_add((SB, ni2 + 1), sbv * (ni2 + 1) + ii, t_b * inner)
    bj2 = _scatter_add((SB, nj2 + 1), sbv * (nj2 + 1) + jj, t_b * junc)
    return bi2[:, :ni2], bj2[:, :nj2]


def _nested_chunk_factor(Nii, Nij, Njj, di, dj, k, C):
    """Scale + factor + invert C level-1 blocks starting at block k·C
    (explicit inverses: every apply is a matmul)."""
    from ..ops.blocked_chol import block_reduce
    s = slice(k * C, (k + 1) * C)
    return block_reduce(*_scaled(Nii[s], Nij[s], Njj[s], di[s], dj[s]))


def _nested_l2_assemble(S_b, jmask, sb_of_block, l2slot, SB, ni2, nj2):
    S_b = S_b * jmask[:, :, None] * jmask[:, None, :]
    return _scatter_l2_mats(S_b, sb_of_block, l2slot, SB, ni2, nj2)


def _pad_l2(Nii2, i2mask):
    """Identity on the empty inner-junction slots, so that every level-2
    system (one with no inner-junction params at all included) is
    positive definite."""
    return Nii2 + torch.diag_embed(1.0 - i2mask)


def _nested_factor_stage1(Nii, Nij, Njj, jmap, jmask, sb_of_block,
                          l2slot, SB, ni2, nj2, nj_total):
    """Level-1 factorization + level-2 assembly, in chunks of at most 16
    blocks (the route for pools past DTA_NESTED_FUSE_BYTES)."""
    B = Nii.shape[0]
    di, dj, djg = _nested_scale_vecs(Nii, Njj, jmap, jmask, nj_total)
    C = next(c for c in range(min(16, B), 0, -1) if B % c == 0)
    parts = [_nested_chunk_factor(Nii, Nij, Njj, di, dj, k, C)
             for k in range(B // C)]
    Ainv = torch.cat([p[0] for p in parts])
    Y = torch.cat([p[1] for p in parts])
    S_b = torch.cat([p[2] for p in parts])
    del parts
    Nii2, Nij2, Njj2 = _nested_l2_assemble(S_b, jmask, sb_of_block,
                                           l2slot, SB, ni2, nj2)
    return Ainv, Y, Nii2, Nij2, Njj2, di, dj, djg


def _nested_l2_factor_one(Nii2, Nij2, i2mask, k):
    """Factor + invert ONE level-2 (super-block) system."""
    from ..ops.recursive_inv import spd_inverse_rec_safe
    A2invb = spd_inverse_rec_safe(
        _pad_l2(Nii2[k:k + 1], i2mask[k:k + 1]))[0]
    Y2b = A2invb @ Nij2[k]
    S2b = -(Nij2[k].transpose(0, 1) @ Y2b)
    return A2invb, Y2b, S2b


def _nested_l3_inv(S2_b, Njj2, j2mask, j2map, nsj_total):
    """Assemble + invert the super-junction system."""
    return _junction_inverse(Njj2 + S2_b, j2map, j2mask, nsj_total)


def _nested_factor_stage2(Nii2, Nij2, Njj2, i2mask, j2mask, j2map,
                          nsj_total):
    """Level-2 factorization (one super-block at a time) + level-3
    assembly/factorization."""
    parts = [_nested_l2_factor_one(Nii2, Nij2, i2mask, k)
             for k in range(Nii2.shape[0])]
    A2inv = torch.stack([p[0] for p in parts])
    Y2 = torch.stack([p[1] for p in parts])
    S2_b = torch.stack([p[2] for p in parts])
    del parts
    Sinv = _nested_l3_inv(S2_b, Njj2, j2mask, j2map, nsj_total)
    return A2inv, Y2, Sinv


def _nested_factor_full(Nii, Nij, Njj, jmap, jmask, sbb, l2slot, i2mask,
                        j2mask, j2map, SB, ni2, nj2, nsj_total, nj_total):
    """All three factor levels in one pass (pools within
    DTA_NESTED_FUSE_BYTES): the level-1 and the level-2 eliminations
    both go through block_reduce — the Cholesky-inverse kernel in
    float32."""
    from ..ops.blocked_chol import block_reduce
    with record_function("dta.level1"):
        di, dj, djg = _nested_scale_vecs(Nii, Njj, jmap, jmask, nj_total)
        Ainv, Y, S_b = block_reduce(*_scaled(Nii, Nij, Njj, di, dj))
    with record_function("dta.level2"):
        Nii2, Nij2, Njj2 = _nested_l2_assemble(S_b, jmask, sbb, l2slot,
                                               SB, ni2, nj2)
        del S_b
        A2inv, Y2, S2_b = block_reduce(_pad_l2(Nii2, i2mask), Nij2,
                                       torch.zeros_like(Njj2))
    with record_function("dta.level3"):
        Sinv = _nested_l3_inv(S2_b, Njj2, j2mask, j2map, nsj_total)
    return Ainv, Y, A2inv, Y2, Sinv, di, dj, djg


def _nested_apply_fwd(Ainv, Y, A2inv, Y2, Sinv, di, dj, jmask, sbb,
                      l2slot, j2map, j2mask, bi, bj, SB, ni2, nj2,
                      nsj_total):
    """Forward half of the apply: level-1 elimination, level-2
    elimination, super-junction solve."""
    bi = bi * di
    bj = bj * dj
    w = torch.einsum("bij,bj->bi", Ainv, bi)
    t_b = (bj - torch.einsum("bkj,bk->bj", Y, bi)) * jmask
    bi2, bj2 = _scatter_l2_rhs(t_b, sbb, l2slot, SB, ni2, nj2)
    w2 = torch.einsum("bij,bj->bi", A2inv, bi2)
    t2_b = (bj2 - torch.einsum("bkj,bk->bj", Y2, bi2)) * j2mask
    xsj = Sinv @ _scatter_global(t2_b, j2map, nsj_total)
    xsj_b = xsj[j2map] * j2mask
    xi2 = w2 - torch.einsum("bij,bj->bi", Y2, xsj_b)
    return w, xi2, xsj


def _nested_apply_bwd(w, Y, di, xj_b):
    return (w - torch.einsum("bij,bj->bi", Y, xj_b)) * di


def _nested_gidx(part: NestedPartition, nsj_total: int) -> np.ndarray:
    """Junction-reconstruction gather index (constant per topology):
    global junction param g reads concat([xi2.ravel(), xsj])[gidx[g]]."""
    ni2 = part.ni2
    return np.where(part.xj_kind == 0,
                    part.xj_sb * ni2 + np.minimum(part.xj_slot, ni2 - 1),
                    part.SB * ni2 + np.minimum(part.xj_slot,
                                               nsj_total - 1))


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, np.dtype(dtype).name)


class NestedSchurFactors:
    """Device-resident three-level factorization (factor once, apply
    many).

    Persistent state: Ainv (level-1 block inverses), Y (eliminated
    coupling), A2inv/Y2 (level 2), Sinv (super-junction inverse), scale
    factors.  Explicit inverses (the reference's dpotri) keep applies
    pure matmuls; float64 refinement absorbs the extra rounding.

    bs: a BlockSystem whose pools are tensors (device-assembled) or numpy
    arrays; device defaults to the pools' device, or "cuda" for numpy
    pools.  dtype float32 (the kernel route) or float64 (library
    Cholesky; the reference's float64 check).  The factor takes one pass
    (_nested_factor_full) when the pools fit DTA_NESTED_FUSE_BYTES (6e8),
    else the staged route (_nested_factor_stage1/2)."""

    def __init__(self, bs: BlockSystem, part: NestedPartition,
                 dtype=torch.float32, device=None):
        self.bs = bs
        self.part = part
        self.dtype = _torch_dtype(dtype)
        if device is None:
            device = (bs.Nii.device if isinstance(bs.Nii, torch.Tensor)
                      else "cuda")
        self.device = torch.device(device)
        self.nj_total = bs.nj_global + 1
        self.nsj_total = part.nsj_global + 1
        self.B_real = bs.Nii.shape[0]

        def put(x, dt):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        i64 = torch.int64
        self.jmap = put(bs.jmap, i64)
        self.jmask = put(bs.jmask, self.dtype)
        self.sbb = put(part.sb_of_block, i64)
        self.l2slot = put(part.l2slot, i64)
        self.j2map = put(part.j2map, i64)
        self.j2mask = put(part.j2mask, self.dtype)
        self._i2mask_dev = put(part.i2mask, self.dtype)
        pool_bytes = 4.0 * sum(float(np.prod(a.shape))
                               for a in (bs.Nii, bs.Nij, bs.Njj))
        self._small = pool_bytes <= float(
            os.environ.get("DTA_NESTED_FUSE_BYTES", 6e8))
        self.refactor()

    def refactor(self, bs: BlockSystem = None):
        """(Re-)factor from fresh normals pools (same topology), reusing
        every device-resident index/mask tensor."""
        if bs is not None:
            self.bs = bs
        part = self.part
        # drop the previous factor pools before re-factoring (memory at
        # national scale) and any refined covariance state they backed
        self.factors = None
        self._cov_l1_h = self._cov_l1_dev = None
        self._l2_host = self._l2_dev_refined = None
        pools = [torch.as_tensor(a, device=self.device).to(self.dtype)
                 for a in (self.bs.Nii, self.bs.Nij, self.bs.Njj)]
        if self._small:
            self.factors = _nested_factor_full(
                *pools, self.jmap, self.jmask, self.sbb, self.l2slot,
                self._i2mask_dev, self.j2mask, self.j2map, part.SB,
                part.ni2, part.nj2, self.nsj_total, self.nj_total)
        else:
            Ainv, Y, Nii2, Nij2, Njj2, di, dj, djg = _nested_factor_stage1(
                *pools, self.jmap, self.jmask, self.sbb, self.l2slot,
                part.SB, part.ni2, part.nj2, self.nj_total)
            del pools
            A2inv, Y2, Sinv = _nested_factor_stage2(
                Nii2, Nij2, Njj2, self._i2mask_dev, self.j2mask,
                self.j2map, self.nsj_total)
            self.factors = (Ainv, Y, A2inv, Y2, Sinv, di, dj, djg)
        return self

    def apply_device(self, bi, bj, gidx):
        """One apply of the factors on device tensors in the factor
        dtype: (xi (B, ni) unscaled, xj (nj_total,) unscaled).  gidx:
        _nested_gidx of the partition, on the device."""
        Ainv, Y, A2inv, Y2, Sinv, di, dj, djg = self.factors
        part = self.part
        w, xi2, xsj = _nested_apply_fwd(
            Ainv, Y, A2inv, Y2, Sinv, di, dj, self.jmask, self.sbb,
            self.l2slot, self.j2map, self.j2mask, bi, bj, part.SB,
            part.ni2, part.nj2, self.nsj_total)
        xj_real = torch.cat([xi2.reshape(-1), xsj])[gidx]
        xj = torch.cat([xj_real, xj_real.new_zeros(
            self.nj_total - xj_real.shape[0])])
        xi = _nested_apply_bwd(w, Y, di, xj[self.jmap] * self.jmask)
        return xi, xj * djg

    def solve(self, bi, bj):
        """One apply from numpy rhs pools: (xi (B, ni), xj (njg,))
        float64 numpy."""
        def put(x, dt=self.dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        gidx = put(_nested_gidx(self.part, self.nsj_total), torch.int64)
        xi, xj = self.apply_device(put(bi), put(bj), gidx)
        njg = self.bs.nj_global
        return (xi.cpu().double().numpy()[:self.B_real],
                xj.cpu().double().numpy()[:njg])

    # ---- covariance stage ------------------------------------------------

    def newton_refine_cov(self, rounds: int = None, N64=None):
        """One-time float64 Newton refinement of the nested float32
        factors for the variance-extraction stage (_refine_nested_cov).
        Afterwards level1_block / junction_cov return float64-quality
        covariances.  No-op when the factors are already float64 or
        refined.

        N64: (Nii, Nij, Njj) float64 pools — required when the normals
        were device-assembled in float32 (DeviceAssembly.build_f64());
        else the host-assembled system's own pools (bs).  The refined
        level-1 pools stay on the device when they fit DTA_COV_DEV_BYTES
        (4e9), else they go to the host; the level-2/3 pools stay on the
        device.

        The tolerance default is the flat path's (1e-12,
        _newton_policy), not the JAX package's resident 3e-9, for the
        same reason: on the 24 x 24 network with super_blocks=2 the
        card's and the CPU's station covariances differ by 1.9e-9
        relative at 3e-9 and by 9.7e-15 at 1e-12 (an H100, tools/
        nested_newton_tol.py)."""
        if (self.dtype == torch.float64 or self._cov_l1_h is not None
                or self._cov_l1_dev is not None):
            return
        rounds, tol = _newton_policy(rounds)
        bs = self.bs
        if N64 is None:
            N64 = (bs.Nii, bs.Nij, bs.Njj)
            if not isinstance(bs.Nii, np.ndarray):
                raise ValueError("device-assembled normals: pass N64 "
                                 "(DeviceAssembly.build_f64())")
        N64 = [torch.as_tensor(a, device=self.device) for a in N64]
        B, ni = N64[0].shape[:2]
        nj = N64[2].shape[1]
        Ainv, Y, A2inv, Y2, Sinv, di, dj, djg = self.factors
        keep_dev = (B * ni * (ni + nj) * 8.0 <=
                    float(os.environ.get("DTA_COV_DEV_BYTES", 4e9)))
        A_parts, Y_parts = [], []

        def store(s, A_c, Y_c):
            if not keep_dev:
                A_c, Y_c = A_c.cpu().numpy(), Y_c.cpu().numpy()
            A_parts.append(A_c)
            Y_parts.append(Y_c)

        evid, l2 = _refine_nested_cov(
            self, (B, ni, nj), lambda s: [a[s] for a in N64],
            lambda s: Ainv[s], di, dj, (A2inv, Sinv), store, rounds, tol)
        self.cov_refine_evidence, self._l2_dev_refined = evid, l2
        if keep_dev:
            self._cov_l1_dev = (torch.cat(A_parts), torch.cat(Y_parts))
        else:
            self._cov_l1_h = (np.concatenate(A_parts),
                              np.concatenate(Y_parts))

    def cov_l1_host(self):
        """Host view of the refined level-1 pools (downloaded on first
        use when they were kept on the device)."""
        if self._cov_l1_h is None and self._cov_l1_dev is not None:
            self._cov_l1_h = tuple(a.cpu().numpy()
                                   for a in self._cov_l1_dev)
        return self._cov_l1_h

    def level1_block(self, b):
        """(Ainv_b, Y_b, di_b) float64 numpy: the refined pools when
        there are any, else the factors."""
        Ainv, Y, A2inv, Y2, Sinv, di, dj, djg = self.factors
        refined = self.cov_l1_host()
        if refined is not None:
            Ah, Yh = refined
            return Ah[b], Yh[b], _np64(di[b])
        return _np64(Ainv[b]), _np64(Y[b]), _np64(di[b])

    def junction_cov(self, gsel):
        """Scaled covariance over global junction params gsel
        (nested_junction_cov of the refined level-2/3 pools, or of the
        factors)."""
        if self._l2_host is None:
            src = self._l2_dev_refined or self.factors[2:5]
            self._l2_host = tuple(_np64(a) for a in src)
        return nested_junction_cov(self.part, *self._l2_host, gsel)

    @property
    def djg_np(self):
        return _np64(self.factors[7])


def schur_solve_nested_factored(bs: BlockSystem, part: NestedPartition,
                                refine: int = 2, dtype=torch.float32,
                                factors=None, streamed: bool = False,
                                max_refine: int = 12, matvec=None,
                                device=None):
    """Nested mixed-precision solve with factor reuse: one three-level
    float32 factorization, then float64 host residual refinement over
    cheap applies.  Pass `factors` back in to skip re-factorizing when
    the normals are unchanged.  Returns (xi, xj, factors).

    streamed=True stages the level-1 factors in host RAM and streams
    them through the device per chunk (parallel/streamed.py) — for
    networks whose factors exceed device memory (the reference's staged
    .mtx mode, dnaadjust-stage.cpp:59); DTA_STREAMED_F64 (default 1)
    refines each chunk in float64 as it is factored.

    The refinement is residual-driven: rounds continue until the
    relative residual is under DTA_SOLVE_RTOL (1e-10) or stops halving,
    with `refine` rounds at least and DTA_MAX_REFINE (max_refine) at
    most.  matvec: as schur_solve_device_refined's."""
    if factors is None:
        if streamed:
            from .streamed import StreamedNestedSchurFactors
            factors = StreamedNestedSchurFactors(
                bs, part, dtype, device=device,
                refine_inline=os.environ.get("DTA_STREAMED_F64",
                                             "1") != "0")
        else:
            factors = NestedSchurFactors(bs, part, dtype, device=device)
    if matvec is None:
        def matvec(xi, xj):
            return _block_matvec(bs, xi, xj)
    xi, xj = factors.solve(bs.bi, bs.bj)
    rhs_j_global = _gather_rhs_junction(bs)
    rhs_scale = max(float(np.abs(bs.bi).max()),
                    float(np.abs(rhs_j_global).max()), 1e-30)
    max_refine = max(refine, int(os.environ.get("DTA_MAX_REFINE",
                                                max_refine)))
    rtol = float(os.environ.get("DTA_SOLVE_RTOL", 1e-10))
    prev_rel = np.inf
    for round_no in range(max_refine):
        ri, rj, rel = _host_residual(bs, matvec, xi, xj, rhs_j_global,
                                     rhs_scale)
        if round_no >= refine and (rel < rtol or rel >= 0.5 * prev_rel):
            break
        prev_rel = rel
        di_, dj_ = factors.solve(ri, _owned_rhs(bs, rj))
        xi = xi + di_
        xj = xj + dj_
    return xi, xj, factors


def _np64(x):
    return x.detach().cpu().double().numpy()


def _refine_nested_cov(f, dims, n64_chunk, ainv_chunk, di, dj, a2_src,
                       store, rounds, tol):
    """Float64 Newton refinement of nested float32 factors, shared by the
    resident (NestedSchurFactors) and the host-streamed
    (parallel/streamed.py) factors: the level-1 inverses are refined in
    block chunks, the level-2 systems re-assembled in float64 from the
    refined pieces, and the level-2/3 inverses refined against them.

    f: the factors (its part, device, nsj_total and the device topology
    tensors jmask, sbb, l2slot, j2map, j2mask, _i2mask_dev); dims =
    (B, ni, nj) of the level-1 pools; n64_chunk(s) -> the float64
    (Nii, Nij, Njj) of the blocks s on the device; ainv_chunk(s) -> their
    float32 inverses on the device; di, dj: the scale vectors the factors
    were built with (device tensors); a2_src = (A2inv, Sinv) float32;
    store(s, A, Y): takes each chunk's refined float64 level-1 pools.

    Returns (evidence, (A2inv, Y2, Sinv) float64 device tensors).  The
    evidence holds the worst measured max|I − N·A| at each level, the
    level-1 rounds, tol, max_rounds and tier (the full (8, 8): the
    products are native float64)."""
    from ..ops.slicegemm import CROSS_MAX, NSLICES
    part, dev, f64 = f.part, f.device, torch.float64
    B, ni, nj = dims
    evid = {"l1_err": 0.0, "l1_rounds": 0, "l2_err": 0.0,
            "l3_err": 0.0, "tol": tol, "max_rounds": rounds,
            "tier": [NSLICES, CROSS_MAX]}
    C = _newton_chunk(B, ni, nj)
    jmask64 = f.jmask.to(f64)
    di, dj = di.to(f64), dj.to(f64)
    shapes = ((part.ni2, part.ni2), (part.ni2, part.nj2),
              (part.nj2, part.nj2))
    L2 = [torch.zeros((part.SB, *sh), dtype=f64, device=dev)
          for sh in shapes]
    l1_ev = []
    for k in range(B // C):
        s = slice(k * C, (k + 1) * C)
        A_c, Y_c, S_c, k_used, err_c = _newton_l1_chunk(
            *n64_chunk(s), di[s], dj[s], ainv_chunk(s), rounds, tol)
        l1_ev.append((k_used, err_c))
        store(s, A_c, Y_c)
        L2 = [a + b for a, b in zip(L2, _nested_l2_assemble(
            S_c, jmask64[s], f.sbb[s], f.l2slot[s], part.SB,
            part.ni2, part.nj2))]
        del A_c, Y_c, S_c
    evid["l1_err"] = max(e for _, e in l1_ev)
    evid["l1_rounds"] = max(k for k, _ in l1_ev)

    evid["l2_err"], evid["l3_err"], l2 = _refine_nested_l23(
        f, L2, *a2_src, rounds, tol)
    return evid, l2


def _refine_nested_l23(f, L2, A2inv, Sinv, rounds, tol):
    """Float64 Newton refinement of the level-2/3 inverses (float32
    A2inv, Sinv) against the float64 level-2 assemblies L2 = (Nii2, Nij2,
    Njj2); f as in _refine_nested_cov.  Returns (l2_err, l3_err,
    (A2inv, Y2, Sinv) float64 device tensors)."""
    part, f64 = f.part, torch.float64
    Nii2, Nij2, Njj2 = L2
    i2m = f._i2mask_dev.to(f64)
    CS = _newton_chunk(part.SB, part.ni2, part.nj2)
    l2parts = [_newton_l2_batch(Nii2[k:k + CS], Nij2[k:k + CS],
                                i2m[k:k + CS], A2inv[k:k + CS],
                                rounds, tol)
               for k in range(0, part.SB, CS)]
    l2_err = max(o[3] for o in l2parts)
    A2d = torch.cat([o[0] for o in l2parts])
    Y2d = torch.cat([o[1] for o in l2parts])
    S2_b = torch.cat([o[2] for o in l2parts])
    del l2parts
    Sinv64, l3_err = _newton_flat_junction(
        Njj2 + S2_b, f.j2map, f.j2mask.to(f64), Sinv, f.nsj_total,
        rounds, tol)
    return l2_err, l3_err, (A2d, Y2d, Sinv64)


def _newton_l2_batch(Nii2, Nij2, i2mask, A2inv32, max_rounds, tol):
    """Float64 Newton–Schulz on a batch of level-2 inverses (same
    identity padding as the factor; the worst block's residual drives
    the rounds): (A2inv, Y2, S2, err)."""
    from ..ops.slicegemm import mm64
    A2, _, err = _newton_loop(A2inv32, _pad_l2(Nii2, i2mask), mm64,
                              max_rounds, tol)
    Y2 = mm64(A2, Nij2)
    S2 = -mm64(Nij2, Y2, transa=True)
    return A2, Y2, S2, err


def nested_junction_cov(part: NestedPartition, A2inv, Y2, Sinv, gsel):
    """Scaled a-posteriori covariance over global junction params `gsel`.

    The level-2 analogue of reading Sinv blocks on the flat path: with
    W = Y2[sb] and the level-3 inverse Sinv,
        Cov(inner2_sb)      = A2inv[sb] + W Sinv_sel Wᵀ
        Cov(inner2_sb, xsj) = −W Sinv[j2map[sb], :]
        Cov(xsj)            = Sinv
    (the standard 2x2 block-inverse identities, same as the reference's
    combine-pass variance recovery, dnaadjust.cpp:3196).  All params of
    one level-1 block live in a single super-block by construction, so
    any block's junction params are covered.  Returns (k, k) in the
    djg-scaled space (float64 numpy inputs)."""
    gsel = np.asarray(gsel, dtype=np.int64)
    k = len(gsel)
    kind = part.xj_kind[gsel]
    sbs = {int(s) for s in part.xj_sb[gsel[kind == 0]]}
    if len(sbs) > 1:
        raise ValueError("junction params span multiple super-blocks")
    cov = np.zeros((k, k))
    sj_idx = part.xj_slot[gsel]          # inner2 slot (kind 0) / sj (kind 1)
    Sl = np.asarray(Sinv, dtype=np.float64)
    i1 = np.nonzero(kind == 1)[0]
    if (kind == 0).any():
        sb = next(iter(sbs))
        jm2 = part.j2map[sb]
        C_loc = Sl[np.ix_(jm2, jm2)] * np.outer(part.j2mask[sb],
                                                part.j2mask[sb])
        i0 = np.nonzero(kind == 0)[0]
        # only the selected rows of the level-2 covariance are needed:
        # U_sel C U_selᵀ is O(k0 nj2² + k0² nj2), not O(ni2² nj2)
        r0 = np.asarray(sj_idx[i0], dtype=np.int64)
        U_sel = np.asarray(Y2[sb], dtype=np.float64)[r0, :]   # (k0, nj2)
        A2_sel = np.asarray(A2inv[sb], dtype=np.float64)[np.ix_(r0, r0)]
        USC = U_sel @ C_loc
        cov[np.ix_(i0, i0)] = A2_sel + USC @ U_sel.T
        if len(i1):
            X_sel = -(U_sel * part.j2mask[sb][None, :]) \
                @ Sl[np.ix_(jm2, sj_idx[i1])]                 # (k0, k1)
            cov[np.ix_(i0, i1)] = X_sel
            cov[np.ix_(i1, i0)] = X_sel.T
    if len(i1):
        cov[np.ix_(i1, i1)] = Sl[np.ix_(sj_idx[i1], sj_idx[i1])]
    return cov
