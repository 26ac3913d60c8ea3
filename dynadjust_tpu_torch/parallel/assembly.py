"""Vectorised blocked-normals assembly for large GPS networks.

Precomputes all scatter index structures once (the network topology is
static); per-iteration work reduces to vectorised residual scatters.  For
GPS-only networks the normal matrix is constant across iterations, so
Gauss-Newton iterations cost one rhs scatter + one device solve each —
the host never loops over measurements in Python.

This is the host-side runtime counterpart of the reference's
multithreaded PrepareAdjustmentBlock (SURVEY §2.3 P4), redesigned as
array scatters instead of thread pools.

Port of the JAX package's ``parallel/assembly.py``, host numpy copied.
``assemble`` takes its baseline residuals from the host kernel library
(ops/native.py), as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .schur import BlockSystem
from .blocked_adjust import BlockedNetwork


@dataclass
class AssemblyPlan:
    """Static scatter structures for a blocked GPS network."""
    bn: BlockedNetwork
    ni: int
    nj: int
    nj_global: int
    # per-measurement: block, local param offsets, inner/junction placement
    msr_block: np.ndarray
    # flat scatter indices into the (B*ni) bi / (B*nj) bj arrays, one per
    # measurement endpoint component; -1 entries are dropped
    bi_idx_1: np.ndarray        # (M, 3) flat index for station1 (or -1)
    bi_idx_2: np.ndarray
    bj_idx_1: np.ndarray
    bj_idx_2: np.ndarray
    jmap: np.ndarray
    jmask: np.ndarray
    imask: np.ndarray
    N_struct: tuple = None      # cached constant normals (Nii, Nij, Njj)


def build_plan(bn: BlockedNetwork, free_weight: float,
               fixed_weight: float = 1.0e6) -> AssemblyPlan:
    B = len(bn.blocks)
    ni = max((3 * len(i) for i, j in bn.blocks), default=3)
    nj = max((3 * len(j) for i, j in bn.blocks), default=3)
    jpi = bn.junction_param_index()
    nj_global = 3 * len(bn.junction_stations)

    # per-block local placement: inner params first, then junction params
    inner_off = []          # station -> (block, local inner offset) or junc
    place = {}
    jmap = np.full((B, nj), nj_global, dtype=np.int32)
    jmask = np.zeros((B, nj), dtype=np.float64)
    imask = np.zeros((B, ni), dtype=np.float64)
    for b, (inner, junc) in enumerate(bn.blocks):
        for k, s in enumerate(inner):
            place[(b, int(s))] = ("i", 3 * k)
        imask[b, :3 * len(inner)] = 1.0
        for k, s in enumerate(junc):
            place[(b, int(s))] = ("j", 3 * k)
            jmap[b, 3 * k:3 * k + 3] = 3 * jpi[int(s)] + np.arange(3)
        jmask[b, :3 * len(junc)] = 1.0

    M = len(bn.pairs)
    bi1 = np.full((M, 3), -1, dtype=np.int64)
    bi2 = np.full((M, 3), -1, dtype=np.int64)
    bj1 = np.full((M, 3), -1, dtype=np.int64)
    bj2 = np.full((M, 3), -1, dtype=np.int64)
    for m in range(M):
        b = int(bn.block_of_msr[m])
        for which, s, bi_arr, bj_arr in (
                (0, int(bn.pairs[m, 0]), bi1, bj1),
                (1, int(bn.pairs[m, 1]), bi2, bj2)):
            kind, off = place[(b, s)]
            if kind == "i":
                bi_arr[m] = b * ni + off + np.arange(3)
            else:
                bj_arr[m] = b * nj + off + np.arange(3)

    plan = AssemblyPlan(bn=bn, ni=ni, nj=nj, nj_global=nj_global,
                        msr_block=bn.block_of_msr.copy(),
                        bi_idx_1=bi1, bi_idx_2=bi2, bj_idx_1=bj1,
                        bj_idx_2=bj2, jmap=jmap, jmask=jmask, imask=imask)
    plan.N_struct = _build_constant_normals(plan, free_weight, fixed_weight)
    return plan


def _scatter(shape_flat, idx, vals):
    """out[idx] += vals for valid (>=0) indices."""
    out = np.zeros(shape_flat)
    sel = idx >= 0
    np.add.at(out, idx[sel], vals[sel])
    return out


def _build_constant_normals(plan: AssemblyPlan, free_weight, fixed_weight):
    """GPS design is ±I: the normals depend only on topology+weights."""
    bn = plan.bn
    B = len(bn.blocks)
    ni, nj = plan.ni, plan.nj
    Nii = np.zeros(B * ni * ni)
    Nij = np.zeros(B * ni * nj)
    Njj = np.zeros(B * nj * nj)

    w3 = np.repeat(bn.weight[:, None], 3, axis=1)       # (M, 3)

    def diag_flat(idx, n_cols, base_stride):
        """flat (b*n + off) -> flat (b, off, off) diagonal index in a
        (B, n, n) array."""
        b = idx // n_cols
        off = idx % n_cols
        return (b * n_cols + off) * n_cols + off

    # diagonal contributions (+w at both endpoints)
    for idx in (plan.bi_idx_1, plan.bi_idx_2):
        sel = idx >= 0
        np.add.at(Nii, diag_flat(idx[sel], ni, ni), w3[sel])
    for idx in (plan.bj_idx_1, plan.bj_idx_2):
        sel = idx >= 0
        np.add.at(Njj, diag_flat(idx[sel], nj, nj), w3[sel])

    # cross contributions (-w between endpoints), placed by kind pairing
    def cross(idx_a, idx_b, arr, n_a, n_b):
        sel = (idx_a >= 0) & (idx_b >= 0)
        a = idx_a[sel]
        b_ = idx_b[sel]
        blk = a // n_a
        ra = a % n_a
        cb = b_ % n_b
        flat = (blk * n_a + ra) * n_b + cb
        np.add.at(arr, flat, -w3[sel])

    # inner-inner (both directions)
    cross(plan.bi_idx_1, plan.bi_idx_2, Nii, ni, ni)
    cross(plan.bi_idx_2, plan.bi_idx_1, Nii, ni, ni)
    # inner-junction
    cross(plan.bi_idx_1, plan.bj_idx_2, Nij, ni, nj)
    cross(plan.bi_idx_2, plan.bj_idx_1, Nij, ni, nj)
    # junction-junction
    cross(plan.bj_idx_1, plan.bj_idx_2, Njj, nj, nj)
    cross(plan.bj_idx_2, plan.bj_idx_1, Njj, nj, nj)

    Nii = Nii.reshape(len(bn.blocks), ni, ni)
    Nij = Nij.reshape(len(bn.blocks), ni, nj)
    Njj = Njj.reshape(len(bn.blocks), nj, nj)

    # constraint weights on the diagonal (once per station, owner block)
    fixed_set = (set(int(s) for s in bn.constrained)
                 if bn.constrained is not None else set())
    seen = set()
    jpi = bn.junction_param_index()
    for b, (inner, junc) in enumerate(bn.blocks):
        for k, s in enumerate(inner):
            s = int(s)
            if s in seen:
                continue
            seen.add(s)
            wc = fixed_weight if s in fixed_set else free_weight
            for c in range(3):
                Nii[b, 3 * k + c, 3 * k + c] += wc
        for k, s in enumerate(junc):
            s = int(s)
            if s in seen:
                continue
            seen.add(s)
            wc = fixed_weight if s in fixed_set else free_weight
            for c in range(3):
                Njj[b, 3 * k + c, 3 * k + c] += wc

    # identity padding for unused inner slots
    for b, (inner, junc) in enumerate(bn.blocks):
        for k in range(3 * len(inner), plan.ni):
            Nii[b, k, k] = 1.0
    return (Nii, Nij, Njj)


def assemble(plan: AssemblyPlan, x: np.ndarray) -> BlockSystem:
    """BlockSystem at linearisation point x (S, 3) — constant normals +
    vectorised rhs scatter."""
    from ..ops.native import baseline_residuals
    bn = plan.bn
    B = len(bn.blocks)
    mmc = baseline_residuals(bn.pairs, bn.obs, x)             # (M, 3)
    wm = bn.weight[:, None] * mmc                             # (M, 3)

    bi = _scatter(B * plan.ni, plan.bi_idx_1, -wm)
    bi += _scatter(B * plan.ni, plan.bi_idx_2, wm)
    bj = _scatter(B * plan.nj, plan.bj_idx_1, -wm)
    bj += _scatter(B * plan.nj, plan.bj_idx_2, wm)

    Nii, Nij, Njj = plan.N_struct
    return BlockSystem(Nii=Nii, Nij=Nij, Njj=Njj,
                       bi=bi.reshape(B, plan.ni),
                       bj=bj.reshape(B, plan.nj),
                       jmap=plan.jmap, jmask=plan.jmask, imask=plan.imask,
                       nj_global=plan.nj_global)
