"""Device-side normals formation: N = AᵀV⁻¹A per block, batched.

This moves the reference's per-iteration hot loop — AᵀV⁻¹A assembly
(UpdateNormals_*/UpdateAtVinv, dnaadjust.cpp:1285-1833) — onto the GPU as
batched matmuls over padded block pools.

Design:
  * The design matrix A is filled on host (vectorised, adjust/vector_fill)
    but never shipped dense: its sparsity is ≤3 station tiles per scalar
    row and constant ±I tiles for GPS rows.  The GPS tile values are
    uploaded once; each re-linearisation uploads only the scalar-row tile
    VALUES ((K, 3)) and a scatter (``index_put_``) rebuilds the dense
    (B, M, P) pool.
  * Block columns are PERMUTED to [inner | junction] order up front, so
    the batched product lands directly in the Nii/Nij/Njj pool layout.
  * The block-diagonal weight matrix V⁻¹ (scalar 1/var rows + direction
    set / GPS cluster k×k blocks) is device-resident and constant per
    topology; WA is a row scale plus a few batched small matmuls.
  * Hard-constraint elimination (constraint_elim.ConstraintBasis) is
    applied as a column projection of A (N~ = P N P follows), and the
    first-appearance diagonal terms are a constant 3×3 tile scatter-add.

The same tile plan with float64 values gives the one-time float64
normals pools of the covariance stage (build_f64), formed as the Gram
product of V^{-1/2}A in native float64.

Port of the JAX package's ``adjust/device_assembly.py``: the host plans
(_compile_tiles, _compile_weights, set_constraints, the gram plan,
rhs_pools, matvec) are copied; the device programs are torch operations.
Past DTA_BUILD_HBM_BUDGET the build runs in block chunks.

With a mesh (parallel/multihost.py) the block axis is padded to a
multiple of the ranks (padding blocks: zero design rows, identity Nii
through the pad tiles); every rank keeps the full (small) plans, builds
only its shard of the pools (in one pass: no chunked build), and the
host operators (rhs_pools, matvec) run over its blocks and are gathered
or summed over the ranks, so every rank holds the same results.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class DeviceAssembly:
    """Per-topology compiled device assembly of the blocked normals.

    Built once from the blocks/partition; per iteration `build_device()`
    turns the freshly host-filled A matrices into device-resident
    (Nii, Nij, Njj) float32 pools.
    """

    def __init__(self, blocks, part, basis, first_fwd, device="cuda",
                 mesh=None):
        self.blocks = blocks
        self.part = part
        self.basis = basis
        self.dtype = torch.float32
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        B = len(blocks)
        self.B = B

        ki_l = [len(p[0]) for p in part]
        kj_l = [len(p[1]) for p in part]
        ni = max(ki_l) if ki_l else 3
        # pad an all-inner segmentation's junction dim to 3 (not 1): Pp
        # must stay a multiple of 3 for the per-station-column reshapes
        # (projection, Pmat, device_stats)
        nj = max(max(kj_l), 3) if kj_l else 3
        M = max(blk.asm.nrows for blk in blocks)
        self.ni, self.nj, self.M = ni, nj, M
        self.Pp = ni + nj                      # pooled params per block
        nj_global = int(max((int(np.max(p[2])) for p in part if len(p[2])),
                            default=-1)) + 1
        self.nj_global = nj_global
        # a mesh pads the block axis to a multiple of its ranks, so that
        # every rank holds an equal shard [lo, hi) of the pools
        self.Bp = mesh.padded(B) if mesh is not None else B
        sh = mesh.shard(self.Bp) if mesh is not None else slice(0, B)
        self.lo, self.hi = sh.start, sh.stop

        # ---- per-block station-slot permutation -------------------------
        # part[b] indices are station-granular triples; slot of station
        # with local index l: inner stations 0.., junction ni//3 + ..
        self._scol = []                         # (k_b,) station slot per blk
        jmap = np.full((self.Bp, nj), nj_global, dtype=np.int32)
        jmask = np.zeros((self.Bp, nj))
        imask = np.zeros((self.Bp, ni))
        for b, blk in enumerate(blocks):
            inner_p, junc_p, junc_g = part[b]
            k_b = len(blk.stations)
            scol = np.empty(k_b, dtype=np.int64)
            scol[inner_p[::3] // 3] = np.arange(len(inner_p) // 3)
            if len(junc_p):
                scol[junc_p[::3] // 3] = ni // 3 + \
                    np.arange(len(junc_p) // 3)
                jmap[b, :len(junc_g)] = junc_g
                jmask[b, :len(junc_g)] = 1.0
            imask[b, :len(inner_p)] = 1.0
            self._scol.append(scol)
        self.jmap_np, self.jmask_np, self.imask_np = jmap, jmask, imask

        self._compile_tiles()
        self._compile_weights()
        self.set_constraints(first_fwd,
                             lambda b: blocks[b].Wc)

    def _putr(self, x, dtype=None):
        """Host array -> device tensor (indices as int64)."""
        x = np.asarray(x)
        if dtype is None and np.issubdtype(x.dtype, np.integer):
            dtype = torch.int64
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _scalar_row_tiles(self, b):
        """(rows, local-station, flat-A-index) triples of every scalar
        design-row tile of block b, vectorised over the vector-fill
        buckets (row/l1/l2/l3 columnar arrays — no per-item Python)."""
        asm = self.blocks[b].asm
        n = asm.A.shape[1]
        if asm._vector_plan is None:
            from .vector_fill import VectorPlan
            asm._vector_plan = VectorPlan(asm)
        rows, locs = [], []
        for bk in asm._vector_plan.b.values():
            for l in (bk.l1, bk.l2, bk.l3):
                m = l >= 0
                rows.append(bk.row[m])
                locs.append(l[m] // 3)
        rows = (np.concatenate(rows) if rows
                else np.zeros(0, dtype=np.int64))
        locs = (np.concatenate(locs) if locs
                else np.zeros(0, dtype=np.int64))
        order = np.argsort(rows * n + 3 * locs, kind="stable")
        rows, locs = rows[order], locs[order]
        return rows, locs, rows * n + 3 * locs

    def _compile_tiles(self):
        """Tile scatter plan: scalar rows (values gathered from the host
        fill each iteration) + constant GPS ±e_k tiles.  Everything
        scatters into zeros per build — no persistent dense base pool."""
        bidx, ridx, cidx = [], [], []
        self._gather = []                       # per block (Kb, 3) flat idx
        self._gps_vals = []                     # per block (Kg, 3) const
        for b, blk in enumerate(self.blocks):
            asm = blk.asm
            scol = self._scol[b]
            rows, locs, src = self._scalar_row_tiles(b)
            self._gather.append(src[:, None] + np.arange(3))
            # constant GPS design tiles (±e_k at (row0+k, station)),
            # vectorised over the assembler's flat GNSS plan
            if not hasattr(asm, "_gps_rows"):
                asm._compile_gps_plan()
            r0 = asm._gps_rows
            gb_rows, gb_cols, gb_vals = [rows], [scol[locs]], [None]
            if len(r0):
                kk = np.arange(3)
                eye = np.eye(3)
                c1 = scol[asm._gps_l1 // 3]
                ymask = asm._gps_l2 < 0
                sign = np.where(ymask, 1.0, -1.0)
                gb_rows.append((r0[:, None] + kk).reshape(-1))
                gb_cols.append(np.repeat(c1, 3))
                gb_vals.append((sign[:, None, None] * eye).reshape(-1, 3))
                nz = ~ymask
                if nz.any():
                    c2 = scol[asm._gps_l2[nz] // 3]
                    gb_rows.append((r0[nz][:, None] + kk).reshape(-1))
                    gb_cols.append(np.repeat(c2, 3))
                    gb_vals.append(np.broadcast_to(
                        eye, (nz.sum(), 3, 3)).reshape(-1, 3))
            all_rows = np.concatenate(gb_rows)
            all_cols = np.concatenate(gb_cols)
            self._gps_vals.append(
                np.concatenate([v for v in gb_vals[1:]])
                if len(gb_vals) > 1 else np.zeros((0, 3)))
            bidx.append(np.full(len(all_rows), b, dtype=np.int32))
            ridx.append(all_rows)
            cidx.append(all_cols)
        self._t_b_h = np.concatenate(bidx).astype(np.int32)
        self._t_r_h = np.concatenate(ridx).astype(np.int32)
        c = np.concatenate(cidx).astype(np.int32)
        self._t_c3_h = (3 * c[:, None]
                        + np.arange(3, dtype=np.int32))
        self._t_b = self._putr(self._t_b_h)
        self._t_r = self._putr(self._t_r_h)
        self._t_c3 = self._putr(self._t_c3_h)
        # per-block combined tile counts (scalar then gps): tiles of
        # blocks [b0, b1) are the contiguous range _t_range[b0:b1+1]
        self._t_range = np.zeros(self.B + 1, dtype=np.int64)
        for b in range(self.B):
            self._t_range[b + 1] = self._t_range[b] + \
                len(self._gather[b]) + len(self._gps_vals[b])
        # split dynamic (scalar, re-gathered per linearisation) from
        # CONSTANT (GPS ±e_k) tile values: per-iteration uploads then
        # carry only the scalar tiles (compose_values recombines on the
        # device)
        pos, off = [], 0
        const_vals = np.zeros((int(self._t_range[-1]), 3))
        for b in range(self.B):
            k_s = len(self._gather[b])
            k_g = len(self._gps_vals[b])
            pos.append(np.arange(off, off + k_s, dtype=np.int32))
            if k_g:
                const_vals[off + k_s:off + k_s + k_g] = self._gps_vals[b]
            off += k_s + k_g
        self._dyn_pos_h = np.concatenate(pos) if pos else \
            np.zeros(0, dtype=np.int32)
        self._dyn_pos = self._putr(self._dyn_pos_h)
        self._const_vals = self._putr(const_vals)

    def dyn_values(self, dtype=None):
        """Per-iteration (scalar-tile) values only — the dynamic half of
        scalar_values; GPS tiles are device constants."""
        dtype = dtype or np.float32
        parts = [self.blocks[b].asm.A.ravel()[self._gather[b]]
                 for b in range(self.B)]
        if not parts:
            return np.zeros((0, 3), dtype=dtype)
        return np.concatenate(parts).astype(dtype)

    def compose_values(self, dyn_dev):
        """Device-side full tile-value vector from the uploaded dynamic
        values + the constant GPS tiles."""
        out = self._const_vals.clone()
        out[self._dyn_pos] = dyn_dev.to(out.dtype)
        return out

    def _compile_weights(self):
        """Device weight plan: scalar 1/var row scale + per-k bucketed V
        stacks (constant per topology)."""
        wdiag = np.zeros((self.Bp, self.M))
        buckets = {}
        for b, blk in enumerate(self.blocks):
            asm = blk.asm
            if not hasattr(asm, "_w_rows"):
                asm._compile_weight_plan()
            if len(asm._w_rows):
                wdiag[b, asm._w_rows] = asm._w_diag
            for r0s, VT in asm._w_buckets:
                k = VT.shape[1]
                ent = buckets.setdefault(k, ([], [], []))
                ent[0].extend([b] * len(r0s))
                ent[1].extend(r0s.tolist())
                ent[2].append(VT)
        self.wdiag = self._putr(wdiag, self.dtype)
        self._wdiag64_h = wdiag                 # host f64 master
        # the host plan stores Vᵀ stacks (assembler.py); transpose back to
        # V so WA = V·A and N = AᵀVA exactly matches the host convention
        self._v_buckets64_h = [
            (k, np.asarray(bb, dtype=np.int32),
             np.asarray(rr, dtype=np.int32),
             np.ascontiguousarray(np.concatenate(vv).transpose(0, 2, 1)))
            for k, (bb, rr, vv) in sorted(buckets.items())]
        self._v_buckets = [
            (k, self._putr(bb), self._putr(rr), self._putr(V, self.dtype))
            for k, bb, rr, V in self._v_buckets64_h]

    def set_constraints(self, first_fwd, Wc_of_block):
        """Finish the constant diagonal tiles once Wc is available.

        Wc_of_block: callable b -> (k_b, 3, 3) per-station constraint
        weights (Block.Wc).  Mirrors phased._add_constraints +
        ConstraintBasis.transform_block's diagonal terms."""
        basis = self.basis
        cb, cc, cv = [], [], []
        for b, blk in enumerate(self.blocks):
            asm = blk.asm
            scol = self._scol[b]
            Wc = Wc_of_block(b)
            for g in first_fwd[b]:
                if g not in asm.local:
                    continue
                l = asm.local[g]
                D = basis.diag.get(g)
                cb.append(b)
                cc.append(scol[l])
                cv.append(D if D is not None else Wc[l])
            # identity padding of unused inner slots
            ki = len(self.part[b][0])
            for q in range(ki // 3, self.ni // 3):
                cb.append(b)
                cc.append(q)
                cv.append(np.eye(3))
        for b in range(self.B, self.Bp):        # mesh padding blocks
            for q in range(self.ni // 3):
                cb.append(b)
                cc.append(q)
                cv.append(np.eye(3))
        self._d_b_h = np.asarray(cb, dtype=np.int32)
        c = np.asarray(cc, dtype=np.int32)
        self._d_c3_h = 3 * c[:, None] + np.arange(3, dtype=np.int32)
        self._d_v64_h = (np.stack(cv).astype(np.float64)
                         if cv else np.zeros((0, 3, 3)))
        self._d_b = self._putr(self._d_b_h)
        self._d_c3 = self._putr(self._d_c3_h)
        self._d_v = self._putr(self._d_v64_h, self.dtype)
        self._d_v64 = self._putr(self._d_v64_h)

        # per-station projection matrices (identity unless constrained);
        # f64 master — the f32 cast is for the fast path only (a rounded
        # projector perturbs N entries at |N|·eps32, visible in the
        # covariance stage)
        Pm = np.zeros((self.Bp, self.Pp // 3, 3, 3))
        Pm[..., :, :] = np.eye(3)
        self._has_proj = False
        for b, blk in enumerate(self.blocks):
            scol = self._scol[b]
            for g, Pg in basis.proj.items():
                l = blk.asm.local.get(g)
                if l is not None:
                    Pm[b, scol[l]] = Pg
                    self._has_proj = True
        self.Pmat = self._putr(Pm, self.dtype)
        self.Pmat64 = self._putr(Pm)
        del Pm
        self._range_plans = {}

    # ------------------------------------------------------------------
    def scalar_values(self, dtype=None, b0=None, b1=None):
        """Current tile values — scalar rows gathered from the host A
        fill + constant GPS ±e_k tiles — (K, 3) in tile order, optionally
        restricted to blocks [b0, b1)."""
        dtype = dtype or np.float32
        rng = range(b0 or 0, self.B if b1 is None else b1)
        parts = []
        for b in rng:
            parts.append(self.blocks[b].asm.A.ravel()[self._gather[b]])
            parts.append(self._gps_vals[b])
        if not parts:
            return np.zeros((0, 3), dtype=dtype)
        return np.concatenate(parts).astype(dtype)

    def _proj_host(self):
        """Host-side sparse constrained-column projection entries
        (block, 3-col index, 3x3 projector)."""
        if not hasattr(self, "_proj_host_cache"):
            pb, pc, pm = [], [], []
            for b, blk in enumerate(self.blocks):
                scol = self._scol[b]
                for g, Pg in self.basis.proj.items():
                    l = blk.asm.local.get(g)
                    if l is not None:
                        pb.append(b)
                        pc.append(int(scol[l]))
                        pm.append(Pg)
            self._proj_host_cache = (
                np.asarray(pb, dtype=np.int32),
                3 * np.asarray(pc, dtype=np.int32)[:, None]
                + np.arange(3, dtype=np.int32),
                np.stack(pm) if pm else np.zeros((0, 3, 3)))
        return self._proj_host_cache

    def _auto_chunk_blocks(self) -> int:
        """Blocks per build chunk so the build's peak device memory stays
        under DTA_BUILD_HBM_BUDGET (default 6 GB): a chunk holds A and WA
        (each C·M·Pp float32) plus the bucket gathers — ~3x C·M·Pp·4
        bytes — alongside the full output pools."""
        budget = float(os.environ.get("DTA_BUILD_HBM_BUDGET", 6e9))
        per_block = 3.0 * self.M * self.Pp * 4.0
        out_bytes = self.Bp * (self.ni ** 2 + self.ni * self.nj
                               + self.nj ** 2) * 4.0
        c = int(max(1.0, (budget - 2.0 * out_bytes) / per_block))
        return min(c, self.Bp)

    def _range_plan(self, b0, b1):
        """Device index plan of the blocks [b0, b1): their tile range,
        weight-bucket entries, projections and diagonal tiles, with block
        indices relative to b0."""
        key = (b0, b1)
        plan = self._range_plans.get(key)
        if plan is not None:
            return plan
        pr = self._putr
        t0 = int(self._t_range[min(b0, self.B)])
        t1 = int(self._t_range[min(b1, self.B)])
        buckets = []
        for (k, bb, rr, V), (_, bbd, rrd, Vd) in zip(self._v_buckets64_h,
                                                    self._v_buckets):
            sel = np.nonzero((bb >= b0) & (bb < b1))[0]
            if len(sel):
                s = pr(sel)
                rows = rrd[s][:, None] + torch.arange(k, device=self.device)
                buckets.append((bbd[s] - b0, rows, Vd[s]))
        pb, pc3, pm = self._proj_host()
        ps = np.nonzero((pb >= b0) & (pb < b1))[0]
        ds = np.nonzero((self._d_b_h >= b0) & (self._d_b_h < b1))[0]
        plan = {
            "tiles": (t0, t1, self._t_b[t0:t1] - b0, self._t_r[t0:t1],
                      self._t_c3[t0:t1]),
            "buckets": buckets,
            "proj": (pr(pb[ps] - b0), pr(pc3[ps]), pr(pm[ps], self.dtype)),
            "diag": (pr(self._d_b_h[ds] - b0), pr(self._d_c3_h[ds]),
                     self._d_v[pr(ds)]),
        }
        self._range_plans[key] = plan
        return plan

    def _build_range(self, vals, b0, b1):
        """(Nii, Nij, Njj) of the blocks [b0, b1): tile scatter,
        constrained-column projection, weight application, AᵀV⁻¹A,
        constraint diagonals, slicing."""
        plan = self._range_plan(b0, b1)
        t0, t1, tb, tr, tc3 = plan["tiles"]
        A = torch.zeros((b1 - b0, self.M, self.Pp), dtype=self.dtype,
                        device=self.device)
        A[tb[:, None], tr[:, None], tc3] = vals[t0:t1]
        prb, prc3, prm = plan["proj"]
        if prb.shape[0]:
            G = A[prb[:, None], :, prc3]               # (n, 3, rows)
            A[prb[:, None], :, prc3] = torch.einsum("nkm,nkl->nlm", G, prm)
        WA = A * self.wdiag[b0:b1, :, None]
        bc_budget = float(os.environ.get("DTA_BUCKET_CHUNK_BYTES", 4e8))
        for bb, rows, V in plan["buckets"]:
            k = rows.shape[1]
            ec = max(1, int(bc_budget / (k * self.Pp * 4)))
            for e0 in range(0, bb.shape[0], ec):
                bbc = bb[e0:e0 + ec, None]
                rc = rows[e0:e0 + ec]
                WA[bbc, rc, :] = V[e0:e0 + ec] @ A[bbc, rc, :]
        N = A.transpose(1, 2) @ WA
        del A, WA
        db, dc3, dv = plan["diag"]
        N.index_put_((db[:, None, None], dc3[:, :, None], dc3[:, None, :]),
                     dv, accumulate=True)
        ni = self.ni
        return N[:, :ni, :ni], N[:, :ni, ni:], N[:, ni:, ni:]

    def build_device(self, values=None):
        """Assemble the (Nii, Nij, Njj) float32 pools on the device from
        the current host A fill.  values: the composed tile-value vector
        already on the device (any float dtype; DeviceRefinedSolve
        uploads it once per iteration for both the build and the solve),
        else gathered from the host fill.  Past DTA_BUILD_HBM_BUDGET the
        build runs in block chunks.  Under a mesh: this rank's shard
        [lo, hi) of the pools, in one pass."""
        if values is None:
            values = self.scalar_values(np.float32)
        vals = torch.as_tensor(values, device=self.device).to(self.dtype)
        if self.mesh is not None:
            return self._build_range(vals, self.lo, self.hi)
        C = self._auto_chunk_blocks()
        if C >= self.Bp:
            return self._build_range(vals, 0, self.Bp)
        outs = [self._build_range(vals, b0, min(b0 + C, self.Bp))
                for b0 in range(0, self.Bp, C)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    def build_f64(self):
        """One-time float64 pools for the covariance stage.

        Formed as the Gram product N = B̃ᵀB̃ with B̃ = V^{-1/2}A (weighted,
        projected, permuted — assembled on host as sparse float64 tiles,
        scattered on the device) in native float64.  Constraint/pad
        diagonal tiles are added exactly afterwards.  Under a mesh: this
        rank's shard [lo, hi) of the pools."""
        if not hasattr(self, "_g_idx"):
            self._compile_gram_plan()
        vals = self._putr(self._gram_values())
        gb, gr, gc3 = self._g_idx
        db, dc3, dv = self._d_b, self._d_c3, self._d_v64
        if self.mesh is not None:
            t0 = int(self._g_range[min(self.lo, self.B)])
            t1 = int(self._g_range[min(self.hi, self.B)])
            gb, gr, gc3 = gb[t0:t1] - self.lo, gr[t0:t1], gc3[t0:t1]
            vals = vals[t0:t1]
            ds = self._putr(np.nonzero((self._d_b_h >= self.lo)
                                       & (self._d_b_h < self.hi))[0])
            db, dc3, dv = db[ds] - self.lo, dc3[ds], dv[ds]
        B64 = torch.zeros((self.hi - self.lo, self.M, self.Pp),
                          dtype=torch.float64, device=self.device)
        B64[gb[:, None], gr[:, None], gc3] = vals
        N = B64.transpose(1, 2) @ B64
        del B64
        N.index_put_((db[:, None, None], dc3[:, :, None], dc3[:, None, :]),
                     dv, accumulate=True)
        ni = self.ni
        return N[:, :ni, :ni], N[:, :ni, ni:], N[:, ni:, ni:]

    def gps_row_plan(self):
        """Per block: array of GNSS observation base rows (row0 + 3i) —
        the rows whose 3×3 adjusted VCVs the reporting path prints."""
        if not hasattr(self, "_gps_rows_per_block"):
            out = []
            for blk in self.blocks:
                rows = []
                for g in blk.asm.gps_items:
                    rows.extend(g.row0 + 3 * i
                                for i in range(len(g.stations1)))
                out.append(np.asarray(rows, dtype=np.int64))
            self._gps_rows_per_block = out
        return self._gps_rows_per_block

    # -- gram (W^{1/2}A) tile plan --------------------------------------
    def _compile_gram_plan(self):
        """Sparse tile plan for B̃ = V^{-1/2}A: scalar rows keep A's
        sparsity with a √w row scale; direction-set/GPS-cluster rows are
        Lᵀ·A_rows (W = L·Lᵀ) over the union of the entry's stations.
        Tiles are (row, station) 3-vectors; values are recomputed per
        build from the current host A fill (gathers + small batched
        matmuls), and constrained-station tiles are projected on host."""
        self._g_scalar = []        # per block: (gather (K,3), sqrtw (K,),
                                   #            tile offset)
        self._flat_off = np.zeros(len(self.blocks) + 1, dtype=np.int64)
        for b, blk in enumerate(self.blocks):
            self._flat_off[b + 1] = self._flat_off[b] + blk.asm.A.size
        bucket_groups = {}
        T = 0
        scalar_parts = []          # (offset, b, rows, cols)
        self._g_range = np.zeros(len(self.blocks) + 1, dtype=np.int64)
        for b, blk in enumerate(self.blocks):
            self._g_range[b] = T
            asm = blk.asm
            n = asm.A.shape[1]
            scol = self._scol[b]
            if not hasattr(asm, "_w_rows"):
                asm._compile_weight_plan()
            # scalar (diagonal-weight) rows: the vector-plan tiles,
            # filtered to rows carrying a scalar weight (direction-set
            # angles belong to correlated buckets below)
            rows, locs, src = self._scalar_row_tiles(b)
            wrow = np.full(asm.nrows, np.nan)
            if len(asm._w_rows):
                # _w_diag is the weight 1/sigma^2; rows scale by sqrt(w)
                wrow[asm._w_rows] = np.sqrt(asm._w_diag)
            keep = np.isfinite(wrow[rows]) if len(rows) else \
                np.zeros(0, dtype=bool)
            rows, locs, src = rows[keep], locs[keep], src[keep]
            scalar_parts.append((T, b, rows, scol[locs]))
            self._g_scalar.append((src[:, None] + np.arange(3),
                                   wrow[rows], T))
            T += len(rows)
            # correlated-weight entries: direction sets + GPS clusters
            for obj in list(asm.dirn_sets) + list(asm.gps_items):
                k = obj.vinv.shape[0]
                r0 = obj.row0
                if hasattr(obj, "angles"):          # direction set
                    stns = sorted({s for a in obj.angles
                                   for s in (a.s1, a.s2, a.s3) if s >= 0})
                else:                               # GPS cluster
                    stns = sorted(set(obj.stations1) | set(obj.stations2))
                u = len(stns)
                cols = np.asarray([asm.local[s] for s in stns],
                                  dtype=np.int64)
                # block-LOCAL flat index (the gather reads each
                # block's own A view — concatenating all A pools into
                # one 2+ GB buffer measured 15 s on this host for a few
                # MB of gathered tiles)
                gidx = ((r0 + np.arange(k))[:, None] * n +
                        (3 * cols)[None, :])
                grp = bucket_groups.setdefault((k, u), ([], [], [], []))
                grp[0].append(gidx)                  # concat-flat indices
                grp[1].append(np.asarray(obj.vinv, dtype=np.float64))
                grp[2].append(T)                     # this entry's tiles
                grp[3].append((b, r0, scol[cols]))
                T += k * u
        self._g_range[len(self.blocks)] = T
        self._g_total = T
        # position-indexed scatter arrays + one batched Cholesky and one
        # vectorised index fill per (k, u) group — no per-entry Python
        gb_full = np.empty(T, dtype=np.int64)
        gr_full = np.empty(T, dtype=np.int64)
        gc_full = np.empty(T, dtype=np.int64)
        for off, b, rows, cols in scalar_parts:
            gb_full[off:off + len(rows)] = b
            gr_full[off:off + len(rows)] = rows
            gc_full[off:off + len(rows)] = cols
        self._g_buckets = []
        for (k, u), (gidxs, Vs, offs, meta) in sorted(
                bucket_groups.items()):
            offs = np.asarray(offs, dtype=np.int64)
            nE = len(offs)
            pos = offs[:, None] + np.arange(k * u)   # (nE, k*u)
            bs_ = np.asarray([m[0] for m in meta], dtype=np.int64)
            r0s = np.asarray([m[1] for m in meta], dtype=np.int64)
            cs = np.stack([m[2] for m in meta])      # (nE, u)
            p = pos.reshape(-1)
            gb_full[p] = np.repeat(bs_, k * u)
            gr_full[p] = (r0s[:, None, None] + np.arange(k)[:, None]
                          + np.zeros((1, 1, u), dtype=np.int64)) \
                .reshape(nE, -1).reshape(-1)
            gc_full[p] = np.broadcast_to(
                cs[:, None, :], (nE, k, u)).reshape(-1)
            V = np.stack(Vs)
            LT = np.linalg.cholesky(
                0.5 * (V + V.transpose(0, 2, 1))).transpose(0, 2, 1)
            self._g_buckets.append((k, u, np.stack(gidxs),
                                    np.ascontiguousarray(LT), pos, bs_))
        self._g_idx_h = (gb_full.astype(np.int32),
                         gr_full.astype(np.int32),
                         (3 * gc_full[:, None]
                          + np.arange(3)).astype(np.int32))
        self._g_idx = tuple(self._putr(a) for a in self._g_idx_h)
        # constrained-station tiles: projected on host (v ← v·P)
        self._g_proj = None
        if self.basis.proj:
            tile_station = {}       # (b, scol) -> P
            for b, blk in enumerate(self.blocks):
                scol = self._scol[b]
                for g, Pg in self.basis.proj.items():
                    l = blk.asm.local.get(g)
                    if l is not None:
                        tile_station[(b, int(scol[l]))] = Pg
            sel, mats = [], []
            for (b, c), Pg in tile_station.items():
                hit = np.nonzero((gb_full == b) & (gc_full == c))[0]
                sel.append(hit)
                mats.append(np.broadcast_to(Pg, (len(hit), 3, 3)))
            if sel:
                self._g_proj = (np.concatenate(sel),
                                np.concatenate(mats))

    def _gram_values(self):
        """Current B̃ tile values (T, 3) float64."""
        vals = np.zeros((self._g_total, 3))
        for b, blk in enumerate(self.blocks):
            g, w, off = self._g_scalar[b]
            if len(g):
                vals[off:off + len(g)] = \
                    blk.asm.A.ravel()[g] * w[:, None]
        # per (k, u) group: B_rows = Lᵀ @ A_rows over the station union
        # — entries gathered from each block's OWN A view (block-local
        # indices), then one batched matmul
        flats = [blk.asm.A.ravel() for blk in self.blocks]
        for k, u, gidx, LT, pos, bb in self._g_buckets:
            nE = gidx.shape[0]
            idx3 = (gidx[:, :, :, None] + np.arange(3)) \
                .reshape(nE, k, 3 * u)
            G = np.empty((nE, k, 3 * u))
            for b in np.unique(bb):
                m = bb == b
                G[m] = flats[b][idx3[m]]
            out = LT @ G                             # (nE, k, 3u)
            vals[pos.reshape(-1)] = \
                out.reshape(nE, k, u, 3).reshape(-1, 3)
        if self._g_proj is not None:
            sel, mats = self._g_proj
            vals[sel] = np.einsum("tj,tjk->tk", vals[sel], mats)
        return vals

    # ------------------------------------------------------------------
    # host-side f64: rhs pools and the refinement matvec
    # ------------------------------------------------------------------
    def _apply_v(self, asm, u):
        """V⁻¹ @ u on host f64 (scalar rows + bucketed blocks; same Vᵀ
        convention as Assembler.atvinv)."""
        out = np.zeros_like(u)
        if len(asm._w_rows):
            out[asm._w_rows] = u[asm._w_rows] * asm._w_diag
        for r0s, VT in asm._w_buckets:
            k = VT.shape[1]
            idx = r0s[:, None] + np.arange(k)
            # rows of V@u where the stored stack is Vᵀ: V u = Σ_k VT[k,i] u_k
            out[idx] = np.einsum("nki,nk->ni", VT, u[idx])
        return out

    def _project_strips(self, blk, v):
        for g, Pg in self.basis.proj.items():
            l = blk.asm.local.get(g)
            if l is not None:
                v[3 * l:3 * l + 3] = Pg @ v[3 * l:3 * l + 3]
        return v

    def _my_blocks(self):
        """The real blocks of this rank's shard (all without a mesh)."""
        return range(self.lo, min(self.hi, self.B))

    def rhs_pools(self):
        """Host f64 (bi, bj) pools: AᵀV⁻¹·mmc, projected + permuted (this
        rank's blocks, gathered under a mesh)."""
        bi = np.zeros((self.hi - self.lo, self.ni))
        bj = np.zeros((self.hi - self.lo, self.nj))
        for b in self._my_blocks():
            blk = self.blocks[b]
            asm = blk.asm
            if not hasattr(asm, "_w_rows"):
                asm._compile_weight_plan()
            # rhs = Aᵀ (V mmc) — the host path's AtVinv@mmc is
            # (VᵀA)ᵀ mmc = Aᵀ V mmc, identical
            rhs = asm.A.T @ self._apply_v(asm, asm.mmc)
            rhs = self._project_strips(blk, rhs)
            inner_p, junc_p, _ = self.part[b]
            bi[b - self.lo, :len(inner_p)] = rhs[inner_p]
            bj[b - self.lo, :len(junc_p)] = rhs[junc_p]
        if self.mesh is not None:
            from ..parallel.multihost import gather_np
            bi, bj = gather_np(bi, self.mesh), gather_np(bj, self.mesh)
        return bi, bj

    def matvec(self, xi, xj):
        """y = N x in f64 on host through A (the refinement residual
        operator): y = P AᵀV⁻¹A P x + C x per block, junction rows
        accumulated globally — replaces _block_matvec when no host f64
        normals exist.  Under a mesh each rank runs its own blocks: yi is
        gathered and yj summed over the ranks."""
        yi = np.zeros((self.hi - self.lo, self.ni))
        yj = np.zeros(self.nj_global + 1)
        xj_pad = np.concatenate([np.asarray(xj, dtype=np.float64), [0.0]])
        for b in self._my_blocks():
            blk = self.blocks[b]
            asm = blk.asm
            inner_p, junc_p, junc_g = self.part[b]
            n = asm.A.shape[1]
            x = np.zeros(n)
            x[inner_p] = xi[b][:len(inner_p)]
            if len(junc_p):
                x[junc_p] = xj_pad[junc_g]
            px = self._project_strips(blk, x.copy())
            u = asm.A @ px
            vu = self._apply_v(asm, u)
            y = asm.A.T @ vu
            y = self._project_strips(blk, y)
            # constant diagonal terms (constraints / basis pins)
            y += self._diag_matvec(b, x)
            yi[b - self.lo, :len(inner_p)] = y[inner_p]
            if len(junc_p):
                np.add.at(yj, junc_g, y[junc_p])
        if self.mesh is not None:
            from ..parallel.multihost import gather_np, psum_np
            yi, yj = gather_np(yi, self.mesh), psum_np(yj, self.mesh)
        return yi, yj[:self.nj_global]

    def _diag_matvec(self, b, x):
        if not hasattr(self, "_diag_host"):
            self._diag_host = {}
        ent = self._diag_host.get(b)
        if ent is None:
            # rebuild the block's (station, 3x3) diag list from the tiles
            db = self._d_b_h
            dc = self._d_c3_h[:, 0] // 3
            dv = self._d_v64_h
            sel = np.nonzero(db == b)[0]
            scol = self._scol[b]
            inv = {int(s): l for l, s in enumerate(scol)}
            rows, mats = [], []
            for t in sel:
                l = inv.get(int(dc[t]))
                if l is None:
                    continue                    # padding tile
                rows.append(l)
                mats.append(dv[t])
            ent = (np.asarray(rows, dtype=np.int64),
                   np.stack(mats) if mats else np.zeros((0, 3, 3)))
            self._diag_host[b] = ent
        rows, mats = ent
        y = np.zeros_like(x)
        if len(rows):
            xs = x[(3 * rows)[:, None] + np.arange(3)]
            ys = np.einsum("nij,nj->ni", mats, xs)
            np.add.at(y.reshape(-1, 3), rows, ys)
        return y
