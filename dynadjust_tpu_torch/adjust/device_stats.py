"""Device-side adjusted-measurement statistics for blocked adjustments.

The reference's statistics pass multiplies the full design matrix into
the a-posteriori covariance per block (ComputePrecisionAdjMsrs,
dnaadjust.cpp:7784) — an O(m·n²) product per block.  Here the per-block
covariance pools are assembled batched on the device from the
Newton-refined Schur factors, and

    adj_prec = diag(A · Ninv · Aᵀ)        (per design row)
    adj_vcv3 = (A · Ninv · Aᵀ)[3x3]       (per GNSS observation triple)
    cov3     = station-diagonal 3×3 blocks of Ninv

are computed with float64 products in block chunks, leaving only O(m)
row bookkeeping on the host.

Port of the JAX package's ``adjust/device_stats.py``
(``device_block_stats`` with ``_fused_flat_chunk`` for the two-level
factors and ``_fused_nested_chunk`` for the three-level ones).  The JAX
package runs these products at a reduced mantissa-slicing tier on the
TPU; the GPU has native float64.  Parity: the chunks express the same
2x2 block-inverse identities as tpu_blocked._block_cov_from_factors and
_block_cov_from_nested.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.slicegemm import mm64


def _l1_cov(Ainv_c, Y_c, Cj, di_c, djg_sel):
    """Level-1 2x2 block-inverse identities: per-block covariance pool
    from the refined inner inverse, coupling Y and junction covariance
    Cj — the batched form of _block_cov_from_factors."""
    YS = mm64(Y_c, Cj)
    cov_ii = (Ainv_c + mm64(YS, Y_c.transpose(1, 2))) \
        * di_c[:, :, None] * di_c[:, None, :]
    cov_ij = -YS * di_c[:, :, None] * djg_sel[:, None, :]
    cov_jj = Cj * djg_sel[:, :, None] * djg_sel[:, None, :]
    top = torch.cat([cov_ii, cov_ij], dim=2)
    bot = torch.cat([cov_ij.transpose(1, 2), cov_jj], dim=2)
    return torch.cat([top, bot], dim=1)


def _finish_chunk(cov, A64, Pmat_c, bb, r3):
    """Project constrained columns of the chunk's float64 design pool and
    derive the three reported quantities."""
    C, M, P = A64.shape
    Pn = P // 3
    if Pmat_c is not None:
        A64 = torch.einsum("bmsk,bskl->bmsl", A64.reshape(C, M, Pn, 3),
                           Pmat_c).reshape(C, M, P)
    G = mm64(A64, cov)                           # (C, M, P)
    ap = (G * A64).sum(dim=2)
    idx = torch.arange(Pn, device=cov.device)
    Cr = cov.reshape(C, Pn, 3, Pn, 3)
    d3 = Cr[:, idx, :, idx, :].permute(1, 0, 2, 3)
    Gg = G[bb[:, None], r3, :]                   # (R, 3, P)
    Ag = A64[bb[:, None], r3, :]
    v = torch.einsum("nap,nbp->nab", Gg, Ag)
    return ap, d3, v


def _flat_chunk(Ainv_c, Y_c, Sinv, di_c, djg, jmap_c, jmask_c, A64,
                Pmat_c, bb, r3):
    """Covariance pool of one block chunk from the flat refined factors,
    then the A-side products."""
    Ssel = Sinv[jmap_c[:, :, None], jmap_c[:, None, :]]
    Ssel = Ssel * jmask_c[:, :, None] * jmask_c[:, None, :]
    djg_sel = djg[jmap_c] * jmask_c
    cov = _l1_cov(Ainv_c, Y_c, Ssel, di_c, djg_sel)
    return _finish_chunk(cov, A64, Pmat_c, bb, r3)


def _nested_chunk(A2d, Y2d, Sd, Ainv_c, Y_c, di_c, djg_sel, sbb, s0, s1,
                  jm2, m2, k0d, k1d, A64, Pmat_c, bb, r3):
    """Nested (3-level) chunk: junction covariance Cj from the refined
    level-2/3 inverses (the batched nested_junction_cov identities),
    then the level-1 identities and the A-side products."""
    Cloc = Sd[jm2[:, :, None], jm2[:, None, :]]
    Cloc = Cloc * m2[:, :, None] * m2[:, None, :]
    U = Y2d[sbb[:, None], s0, :]                 # (C, nj, nj2)
    A2sel = A2d[sbb[:, None, None], s0[:, :, None], s0[:, None, :]]
    UC = mm64(U, Cloc)
    C00 = A2sel + mm64(UC, U.transpose(1, 2))
    X01 = -mm64(U * m2[:, None, :], Sd[jm2[:, :, None], s1[:, None, :]])
    C11 = Sd[s1[:, :, None], s1[:, None, :]]
    Cj = (C00 * k0d[:, :, None] * k0d[:, None, :]
          + X01 * k0d[:, :, None] * k1d[:, None, :]
          + X01.transpose(1, 2) * k1d[:, :, None] * k0d[:, None, :]
          + C11 * k1d[:, :, None] * k1d[:, None, :])
    cov = _l1_cov(Ainv_c, Y_c, Cj, di_c, djg_sel)
    return _finish_chunk(cov, A64, Pmat_c, bb, r3)


def _nested_chunk_indices(factors, part, jmap_np, jmask_np, sl):
    """Host-side index prep for one nested chunk (cheap numpy): each
    junction slot's super-block, its level-2 inner slot (kind 0) or
    super-junction index (kind 1), and the kind masks."""
    g = np.minimum(jmap_np, len(part.xj_kind) - 1)
    kind = part.xj_kind[g] * (jmask_np > 0)
    slot = part.xj_slot[g]
    sbb = np.asarray(part.sb_of_block[sl])
    k0 = (kind == 0) & (jmask_np > 0)
    k1 = (kind == 1) & (jmask_np > 0)
    s0 = np.where(k0, np.minimum(slot, part.ni2 - 1), 0)
    s1 = np.where(k1, np.minimum(slot, factors.nsj_total - 1), 0)
    return (sbb, s0, s1, part.j2map[sbb], part.j2mask[sbb],
            k0.astype(np.float64), k1.astype(np.float64))


def _chunk_gps_plan(gps_rows, b0, b1):
    """GNSS row-triple gather plan of the blocks [b0, b1): entries
    [(chunk-relative block, block, rows0)], and the (block, row0) pairs."""
    entries = [(bi, b, gps_rows[b])
               for bi, b in enumerate(range(b0, b1)) if len(gps_rows[b])]
    bb = np.concatenate([np.full(len(r), bi) for bi, _, r in entries]
                        or [np.zeros(0)]).astype(np.int64)
    rr = np.concatenate([r for _, _, r in entries]
                        or [np.zeros(0)]).astype(np.int64)
    return entries, bb, rr


def device_block_stats(da, bs, cov_factors=None, nested=None,
                       chunk: int = 16):
    """adj_prec per design row, adj_vcv3 per GNSS observation, and
    station-diagonal 3×3 covariance blocks, in block chunks.

    da: the DeviceAssembly (tile plans, projectors);
    cov_factors: flat refined factors (newton_factors output), or
    nested=(factors, part): NestedSchurFactors after newton_refine_cov.
    Returns (adj_prec (B, M) np.float64, vcv3 {(b, row0): (3,3)},
    cov3 (B, Pn, 3, 3) np.float64) — cov3 indexed by station slot."""
    B, M, P = da.B, da.M, da.Pp
    Pn = P // 3
    dev = da.device
    # the chunk divides the block count and keeps the float64 design
    # pool, G = A·Ninv and the covariance pools (~3 of each per block)
    # under DTA_STATS_CHUNK_BYTES
    budget = float(os.environ.get("DTA_STATS_CHUNK_BYTES", 8e9))
    per_block = 8.0 * 3.0 * (M * P + P * P)
    chunk = min(chunk, max(1, int(budget / per_block)))
    chunk = next(c for c in range(min(chunk, B), 0, -1) if B % c == 0)
    adj_prec = np.zeros((B, M))
    cov3 = np.zeros((B, Pn, 3, 3))
    vcv3 = {}
    gps_rows = da.gps_row_plan()          # per block: (rows0 array)
    if nested is None:
        Ainv, Y, Sinv, di, dj, djg, _ = cov_factors
    else:
        factors, part = nested
        # refined level-1 pools (device, or host past DTA_COV_DEV_BYTES);
        # the refined level-2/3 pools stay on the device
        Ainv, Y = factors._cov_l1_dev or factors._cov_l1_h
        A2d, Y2d, Sd = factors._l2_dev_refined
        djg = factors.djg_np
        di = factors.factors[5]
    di = di.to(torch.float64)

    for c0 in range(0, B, chunk):
        sl = slice(c0, c0 + chunk)
        jmap_np = np.asarray(bs.jmap[sl])
        jmask_np = np.asarray(bs.jmask[sl], dtype=np.float64)
        t0, t1 = int(da._t_range[c0]), int(da._t_range[c0 + chunk])
        A64 = torch.zeros((chunk, M, P), dtype=torch.float64, device=dev)
        A64[(da._t_b[t0:t1] - c0)[:, None], da._t_r[t0:t1, None],
            da._t_c3[t0:t1]] = da._putr(
                da.scalar_values(np.float64, c0, c0 + chunk))
        entries, bb, rr = _chunk_gps_plan(gps_rows, c0, c0 + chunk)
        r3 = rr[:, None] + np.arange(3)
        Pmat_c = da.Pmat64[sl] if da._has_proj else None
        common = (A64, Pmat_c, da._putr(bb), da._putr(r3))
        if nested is None:
            ap, d3, v = _flat_chunk(Ainv[sl], Y[sl], Sinv, di[sl], djg,
                                    da._putr(jmap_np), da._putr(jmask_np),
                                    *common)
        else:
            idxs = _nested_chunk_indices(factors, part, jmap_np,
                                         jmask_np, sl)
            djg_sel = djg[np.minimum(jmap_np, len(djg) - 1)] * jmask_np
            ap, d3, v = _nested_chunk(
                A2d, Y2d, Sd, torch.as_tensor(Ainv[sl], device=dev),
                torch.as_tensor(Y[sl], device=dev), di[sl],
                da._putr(djg_sel), *(da._putr(x) for x in idxs), *common)
        adj_prec[sl] = ap.cpu().numpy()
        cov3[sl] = d3.cpu().numpy()
        if len(bb):
            v_np = v.cpu().numpy()
            e = 0
            for _, b, rows0 in entries:
                for r0 in rows0:
                    vcv3[(b, int(r0))] = v_np[e]
                    e += 1
    return adj_prec, vcv3, cov3
