"""Host-streamed nested (three-level) factors: networks whose level-1
factors exceed device memory.

The analogue of the reference's staged adjustment (--staged-adjustment;
per-block matrices memory-mapped to .mtx files, dnaadjust-stage.cpp:59,
OffloadBlockToMappedFile dnaadjust.hpp:530): the level-1 normals and
their factors live in host RAM, and chunks of C blocks stream through the
device for the O(n³) work.  Only the level-2/3 factors (junction-sized)
stay on the device, so device memory holds one chunk at a time and the
network is bounded by host RAM.

Transfers: on a CUDA device the host pools and the chunk staging
buffers are page-locked, and copies are asynchronous on the current
stream.  Numpy reads a buffer that a device→host copy filled only after
the stream is synchronised, and a staging buffer is refilled only after
its last upload has completed.  One stream serves every chunk: chunk
k+1's upload does not overlap chunk k's factor.  The factor pass keeps
each chunk's upload, compute and download milliseconds (CUDA events) in
``chunk_ms``.

Port of the streamed section of the JAX package's ``parallel/schur.py``
(``_streamed_chunk_factor_refine``, ``_streamed_fwd/bwd_chunk``,
``_streamed_mid_solve``, ``StreamedNestedSchurFactors``, the streamed
branch of ``_nested_newton_refine_cov`` and the streamed accessors),
with two differences:

  * the float64 products are native (no mantissa slicing), and the
    Newton tolerance is the port's (parallel/schur.py::_newton_policy);
  * each route unscales with the scale vectors its pools were built
    with: float64 on the inline-refined route, their float32 roundings
    (held in float64) on the two-phase route.  The JAX package unscales
    the inline-refined level-1 pools with the float32 roundings and the
    two-phase junction covariance with the float64 values, so its staged
    station covariances differ from its resident ones by about 1e-7
    relative (ROADMAP.md F4).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.blocked_chol import block_reduce
from .schur import (BlockSystem, NestedPartition, _nested_factor_stage2,
                    _nested_gidx, _nested_l2_assemble, _newton_loop,
                    _newton_policy, _np64, _refine_nested_cov,
                    _refine_nested_l23, _scaled, _scatter_global,
                    _scatter_l2_rhs, _torch_dtype, nested_junction_cov)


class _HostLink:
    """Host↔device copies of the streamed pools on the current stream.

    On a CUDA device host chunks go up through page-locked staging
    buffers (one per slot, shape and dtype, reused) and come down into
    page-locked buffers; both copies are non-blocking, and a downloaded
    buffer is valid after sync().  On the CPU the copies are plain.
    `bytes` counts what went up and down."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs = {}
        self.bytes = {"up": 0, "down": 0}

    def pinned(self, shape, dtype):
        """An empty host tensor, page-locked on a CUDA device."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def _slot(self, slot, shape, dtype):
        key = (slot, tuple(shape), dtype)
        ent = self._bufs.get(key)
        if ent is None:
            ent = self._bufs[key] = [self.pinned(shape, dtype), None]
        elif ent[1] is not None:
            ent[1].synchronize()        # its last copy has completed
        return ent

    def up(self, a, slot):
        """Device copy of the host array or tensor a.  A page-locked
        tensor goes up directly, anything else through staging buffer
        `slot`."""
        t = torch.as_tensor(a)
        self.bytes["up"] += t.numel() * t.element_size()
        if not self.cuda:
            return t.to(self.device)
        if t.is_pinned():
            return t.to(self.device, non_blocking=True)
        ent = self._slot(slot, t.shape, t.dtype)
        ent[0].copy_(t)
        out = ent[0].to(self.device, non_blocking=True)
        ent[1] = torch.cuda.Event()
        ent[1].record()
        return out

    def down(self, t, slot=None, out=None):
        """Host copy of device tensor t into `out` (a page-locked host
        tensor) or staging buffer `slot`; read it after sync()."""
        self.bytes["down"] += t.numel() * t.element_size()
        if out is None:
            if not self.cuda:
                return t.cpu()
            out = self._slot(slot, t.shape, t.dtype)[0]
        out.copy_(t, non_blocking=self.cuda)
        return out

    def mark(self):
        """A recorded CUDA event (None on the CPU)."""
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def sync(self):
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


def _streamed_chunk_factor_refine(NiiT, Nij_c, Njj_c, di_c, dj_c, iu, n,
                                  max_rounds, tol):
    """Factor AND Newton-refine one streamed chunk in a single pass:

      * the float64 Nii chunk arrives packed as its upper triangle (half
        the dominant upload) and is unpacked on the device;
      * the float32 factor runs on a fresh float32 cast through
        block_reduce (the kernel) — the float32 pools never cross the
        link, and the kernel's jittered retry reads that cast, not the
        float64 system the Newton loop reads;
      * the residual-driven float64 Newton refinement runs at once
        against the resident float64 chunk;
      * the refined inverse leaves packed as its upper triangle.

    iu: the (rows, cols) upper-triangle indices of an (n, n) block on
    the device.  Returns (packed A64, Y64, S_c, rounds, err)."""
    from ..ops.slicegemm import mm64
    C = NiiT.shape[0]
    up = NiiT.new_zeros((C, n, n))
    up[:, iu[0], iu[1]] = NiiT
    Nii_s = up + torch.triu(up, 1).transpose(1, 2)
    del up
    Nii_s *= di_c[:, :, None]
    Nii_s *= di_c[:, None, :]
    Nij_s = Nij_c * di_c[:, :, None] * dj_c[:, None, :]
    Njj_s = Njj_c * dj_c[:, :, None] * dj_c[:, None, :]
    f32 = torch.float32
    Ainv32, _, _ = block_reduce(Nii_s.to(f32), Nij_s.to(f32),
                                Njj_s.to(f32))
    A64, k, err = _newton_loop(Ainv32, Nii_s, mm64, max_rounds, tol)
    del Ainv32
    Y64 = mm64(A64, Nij_s)
    S_c = Njj_s - mm64(Nij_s, Y64, transa=True)
    return A64[:, iu[0], iu[1]], Y64, S_c, k, err


def _streamed_fwd_chunk(Ainv_c, Y_c, bi_c, bj_c, jmask_c):
    """Forward elimination of one chunk: w = Nii⁻¹ bi and the junction
    contribution t = (bj − Nji Nii⁻¹ bi)·mask."""
    w_c = torch.einsum("bij,bj->bi", Ainv_c, bi_c)
    t_c = (bj_c - torch.einsum("bkj,bk->bj", Y_c, bi_c)) * jmask_c
    return w_c, t_c


def _streamed_bwd_chunk(Y_c, w_c, xjb_c, di_c):
    """Back-substitution of one chunk: x_i = (w − Nii⁻¹Nij x_j)·di."""
    return (w_c - torch.einsum("bij,bj->bi", Y_c, xjb_c)) * di_c


def _streamed_mid_solve(A2inv, Y2, Sinv, bi2, bj2, j2map, j2mask,
                        nsj_total):
    """Level-2 elimination + level-3 solve (small, device-resident)."""
    w2 = torch.einsum("bij,bj->bi", A2inv, bi2)
    t2_b = (bj2 - torch.einsum("bkj,bk->bj", Y2, bi2)) * j2mask
    xsj = Sinv @ _scatter_global(t2_b, j2map, nsj_total)
    xsj_b = xsj[j2map] * j2mask
    xi2 = w2 - torch.einsum("bij,bj->bi", Y2, xsj_b)
    return xi2, xsj


class StreamedNestedSchurFactors:
    """Host-staged three-level factorization.

    bs: a host-assembled BlockSystem (numpy float64 pools); part its
    nested partition; dtype the factor dtype (float32: the kernel
    route).  chunk: blocks per streamed chunk (default from the memory
    budgets below; always a divisor of B).  device: where the chunks are
    factored ("cuda" unless given).

    refine_inline: factor AND float64-Newton-refine each chunk in one
    streamed pass (_streamed_chunk_factor_refine) with triangle-packed
    transfers — the refined float64 pools land in host RAM and the
    applies run there in float64 (_solve_host; DTA_STREAM_APPLY=device
    streams them through the device instead).  Its chunk keeps the
    float64 transients of one pass (about 6 ni² + 3 ni·nj float64 and
    3 ni² float32 per block) under DTA_NEWTON_CHUNK_BYTES (3e9).  False
    keeps the two-phase pipeline: float32 factors now, streamed to the
    device on every apply, newton_refine_cov later; its chunk moves
    about DTA_STREAM_CHUNK_BYTES (1 GiB) of float32 normals."""

    def __init__(self, bs: BlockSystem, part: NestedPartition,
                 dtype=torch.float32, chunk: int = None,
                 refine_inline: bool = False, device=None):
        self.bs = bs
        self.part = part
        self.dtype = _torch_dtype(dtype)
        self.device = torch.device(device if device is not None
                                   else "cuda")
        self.nj_total = bs.nj_global + 1
        self.nsj_total = part.nsj_global + 1
        B, ni = bs.Nii.shape[:2]
        nj = bs.Njj.shape[1]
        self.B_real = B
        dev, f64 = self.device, torch.float64
        link = self._link = _HostLink(dev)

        # unity-scale vectors from the diagonals (host, float64); the
        # two-phase route holds their factor-dtype rounding, the values
        # its pools are scaled by
        dii = np.einsum("bii->bi", bs.Nii)
        djj = np.einsum("bii->bi", bs.Njj) * bs.jmask
        djg = np.zeros((self.nj_total,))
        np.add.at(djg, bs.jmap.reshape(-1), djj.reshape(-1))
        djg = 1.0 / np.sqrt(np.where(djg <= 0.0, 1.0, djg))
        di = 1.0 / np.sqrt(np.where(dii <= 0.0, 1.0, dii))
        if not refine_inline:
            np_dt = torch.empty(0, dtype=self.dtype).numpy().dtype
            di = di.astype(np_dt).astype(np.float64)
            djg = djg.astype(np_dt).astype(np.float64)
        dj = np.where(bs.jmask > 0, djg[bs.jmap], 1.0)
        self.di_h, self.dj_h, self.djg_h = di, dj, djg

        def put(x, dt):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        self._di, self._dj = put(di, f64), put(dj, f64)
        self.jmap = put(bs.jmap, torch.int64)
        self.jmask = put(bs.jmask, self.dtype)
        self.sbb = put(part.sb_of_block, torch.int64)
        self.l2slot = put(part.l2slot, torch.int64)
        self.j2map = put(part.j2map, torch.int64)
        self.j2mask = put(part.j2mask, self.dtype)
        self._i2mask_dev = put(part.i2mask, self.dtype)
        self._gidx = put(_nested_gidx(part, self.nsj_total), torch.int64)

        if chunk is None:
            if refine_inline:
                per_block = (8.0 * (6.0 * ni * ni + 3.0 * ni * nj)
                             + 4.0 * 3.0 * ni * ni)
                budget = float(os.environ.get("DTA_NEWTON_CHUNK_BYTES",
                                              3e9))
                chunk = max(1, int(budget / per_block))
            else:
                per_block = (2 * ni * ni + 2 * ni * nj + nj * nj) * \
                    torch.empty(0, dtype=self.dtype).element_size()
                target = int(os.environ.get("DTA_STREAM_CHUNK_BYTES",
                                            1 << 30))
                chunk = max(1, min(B, target // max(per_block, 1)))
        self.C = next(c for c in range(min(chunk, B), 0, -1)
                      if B % c == 0)
        C = self.C

        self._cov_l1_h = self._l1_pinned = None
        self._l2_host = self._l2_dev = None
        self.chunk_ms = []
        l2_dtype = f64 if refine_inline else self.dtype
        shapes = ((part.ni2, part.ni2), (part.ni2, part.nj2),
                  (part.nj2, part.nj2))
        L2 = [torch.zeros((part.SB, *sh), dtype=l2_dtype, device=dev)
              for sh in shapes]
        l2args = (part.SB, part.ni2, part.nj2)
        if refine_inline:
            rounds, tol = _newton_policy()
            from ..ops.slicegemm import CROSS_MAX, NSLICES
            evid = {"l1_err": 0.0, "l1_rounds": 0, "l2_err": 0.0,
                    "l3_err": 0.0, "tol": tol, "max_rounds": rounds,
                    "tier": [NSLICES, CROSS_MAX], "inline": True}
            iu0, iu1 = np.triu_indices(ni)
            iu = (put(iu0, torch.int64), put(iu1, torch.int64))
            Ah = link.pinned((B, ni, ni), f64)
            Yh = link.pinned((B, ni, nj), f64)
            Ah_np = Ah.numpy()
            jm64 = self.jmask.to(f64)
            # the two-phase float32 pools never exist on this route
            self.Ainv_h = self.Y_h = None
            for k in range(0, B, C):
                sl = slice(k, k + C)
                e0 = link.mark()
                up = (link.up(bs.Nii[sl][:, iu0, iu1], "nii"),
                      link.up(bs.Nij[sl], "nij"),
                      link.up(bs.Njj[sl], "njj"))
                e1 = link.mark()
                A_tri, Y_c, S_c, k_used, err = \
                    _streamed_chunk_factor_refine(
                        *up, self._di[sl], self._dj[sl], iu, ni,
                        rounds, tol)
                del up
                evid["l1_err"] = max(evid["l1_err"], err)
                evid["l1_rounds"] = max(evid["l1_rounds"], k_used)
                L2 = [a + b for a, b in zip(L2, _nested_l2_assemble(
                    S_c, jm64[sl], self.sbb[sl], self.l2slot[sl],
                    *l2args))]
                e2 = link.mark()
                tri = link.down(A_tri, "tri")
                link.down(Y_c, out=Yh[sl])
                e3 = link.mark()
                link.sync()
                self._time_chunk(e0, e1, e2, e3)
                tri = tri.numpy()
                Ah_np[sl][:, iu0, iu1] = tri
                Ah_np[sl][:, iu1, iu0] = tri
                del A_tri, Y_c, S_c
            self._set_l1_refined(Ah, Yh)
        else:
            # host factor pools (the .mtx analogue)
            self.Ainv_h = link.pinned((B, ni, ni), self.dtype)
            self.Y_h = link.pinned((B, ni, nj), self.dtype)
            np_dt = self.Ainv_h.numpy().dtype
            for k in range(0, B, C):
                sl = slice(k, k + C)
                e0 = link.mark()
                up = [link.up(a[sl].astype(np_dt), name) for a, name in
                      ((bs.Nii, "nii"), (bs.Nij, "nij"), (bs.Njj, "njj"))]
                e1 = link.mark()
                Ainv_c, Y_c, S_c = block_reduce(*_scaled(
                    *up, self._di[sl].to(self.dtype),
                    self._dj[sl].to(self.dtype)))
                del up
                L2 = [a + b for a, b in zip(L2, _nested_l2_assemble(
                    S_c, self.jmask[sl], self.sbb[sl], self.l2slot[sl],
                    *l2args))]
                e2 = link.mark()
                link.down(Ainv_c, out=self.Ainv_h[sl])
                link.down(Y_c, out=self.Y_h[sl])
                e3 = link.mark()
                link.sync()
                self._time_chunk(e0, e1, e2, e3)
                del Ainv_c, Y_c, S_c

        Nii2, Nij2, Njj2 = L2
        A2inv, Y2, Sinv = _nested_factor_stage2(
            Nii2.to(self.dtype), Nij2.to(self.dtype), Njj2.to(self.dtype),
            self._i2mask_dev, self.j2mask, self.j2map, self.nsj_total)
        self.l2_factors = (A2inv, Y2, Sinv)
        if refine_inline:
            # refine the level-2/3 inverses against the float64
            # assemblies (device-resident, junction-sized)
            evid["l2_err"], evid["l3_err"], l2 = _refine_nested_l23(
                self, L2, A2inv, Sinv, rounds, tol)
            self._set_l2_refined(l2)
            self.cov_refine_evidence = evid

    # ---- bookkeeping --------------------------------------------------

    def _time_chunk(self, e0, e1, e2, e3):
        """Record one chunk's upload / compute / download ms (after the
        stream was synchronised; CUDA only)."""
        if e0 is not None:
            self.chunk_ms.append({"up": e0.elapsed_time(e1),
                                  "compute": e1.elapsed_time(e2),
                                  "down": e2.elapsed_time(e3)})

    def _set_l1_refined(self, Ah, Yh):
        """Adopt refined float64 level-1 pools (page-locked host
        tensors): numpy views for the host applies and the writers."""
        self._l1_pinned = (Ah, Yh)
        self._cov_l1_h = (Ah.numpy(), Yh.numpy())

    def _set_l2_refined(self, l2):
        self._l2_dev = l2
        self._l2_host = tuple(_np64(a) for a in l2)

    # ---- applies --------------------------------------------------------

    def solve(self, bi, bj):
        """One apply from host rhs pools: (xi (B, ni), xj (njg,)) float64
        numpy.  Once float64-refined pools exist the apply runs on the
        host (_solve_host) unless DTA_STREAM_APPLY=device; otherwise the
        level-1 pools stream through the device twice (forward
        elimination, back-substitution)."""
        refined = self._l1_pinned
        if refined is not None and \
                os.environ.get("DTA_STREAM_APPLY", "host") != "device":
            return self._solve_host(bi, bj)
        bs, part, link = self.bs, self.part, self._link
        if refined is not None:
            Ah, Yh = refined
            A2inv, Y2, Sinv = self._l2_dev
            dt = torch.float64
        else:
            Ah, Yh = self.Ainv_h, self.Y_h
            A2inv, Y2, Sinv = self.l2_factors
            dt = self.dtype
        B, C = self.B_real, self.C
        dev = self.device
        di, dj, jmask = self._di.to(dt), self._dj.to(dt), self.jmask.to(dt)
        bi_s = torch.as_tensor(np.asarray(bi), device=dev).to(dt) * di
        bj_s = torch.as_tensor(np.asarray(bj), device=dev).to(dt) * dj

        # forward elimination, streamed
        W = []
        bi2 = torch.zeros((part.SB, part.ni2), dtype=dt, device=dev)
        bj2 = torch.zeros((part.SB, part.nj2), dtype=dt, device=dev)
        for k in range(0, B, C):
            sl = slice(k, k + C)
            w_c, t_c = _streamed_fwd_chunk(
                link.up(Ah[sl], "a"), link.up(Yh[sl], "y"), bi_s[sl],
                bj_s[sl], jmask[sl])
            a, b = _scatter_l2_rhs(t_c, self.sbb[sl], self.l2slot[sl],
                                   part.SB, part.ni2, part.nj2)
            bi2, bj2 = bi2 + a, bj2 + b
            W.append(w_c)

        # level-2/3 solve (device-resident, junction-sized), then the
        # junction reconstruction
        xi2, xsj = _streamed_mid_solve(A2inv, Y2, Sinv, bi2, bj2,
                                       self.j2map, self.j2mask.to(dt),
                                       self.nsj_total)
        xj = torch.cat([xi2.reshape(-1), xsj])[self._gidx]
        xj_b = torch.cat([xj, xj.new_zeros(1)])[self.jmap] * jmask

        # back-substitution, streamed
        xi = [_streamed_bwd_chunk(link.up(Yh[k:k + C], "y"), W[k // C],
                                  xj_b[k:k + C], di[k:k + C])
              for k in range(0, B, C)]
        xi = torch.cat(xi).double().cpu().numpy()
        return xi, xj.double().cpu().numpy() * self.djg_h[:bs.nj_global]

    def _solve_host(self, bi, bj):
        """Apply the refined float64 factors entirely on the host (numpy):
        with the refined pools already in host RAM the apply is memory
        bandwidth, with no link traffic (the reference's staged mode
        likewise keeps big state where it lives,
        dnaadjust-stage.cpp:59)."""
        bs, part = self.bs, self.part
        Ah, Yh = self._cov_l1_h
        A2h, Y2h, Sh = self._l2_host
        SB, ni2, nj2 = part.SB, part.ni2, part.nj2
        bi_s = np.asarray(bi) * self.di_h
        bj_s = np.asarray(bj) * self.dj_h
        # level-1 forward elimination
        w = np.matmul(Ah, bi_s[:, :, None])[:, :, 0]
        t_b = (bj_s - np.matmul(bi_s[:, None, :], Yh)[:, 0, :]) \
            * bs.jmask
        # level-2 rhs scatter (host replica of _scatter_l2_rhs)
        l2s = part.l2slot
        sbv = np.broadcast_to(part.sb_of_block[:, None], l2s.shape)
        inner = l2s < ni2
        junc = (l2s >= ni2) & (l2s < ni2 + nj2)
        bi2 = np.zeros((SB, ni2 + 1))
        bj2 = np.zeros((SB, nj2 + 1))
        np.add.at(bi2, (sbv, np.where(inner, l2s, ni2)), t_b * inner)
        np.add.at(bj2, (sbv, np.where(junc, l2s - ni2, nj2)),
                  t_b * junc)
        bi2, bj2 = bi2[:, :ni2], bj2[:, :nj2]
        # level-2 elimination + level-3 solve
        w2 = np.matmul(A2h, bi2[:, :, None])[:, :, 0]
        t2_b = (bj2 - np.matmul(bi2[:, None, :], Y2h)[:, 0, :]) \
            * part.j2mask
        t2 = np.zeros(self.nsj_total)
        np.add.at(t2, part.j2map.reshape(-1), t2_b.reshape(-1))
        xsj = Sh @ t2
        xsj_b = xsj[part.j2map] * part.j2mask
        xi2 = w2 - np.matmul(Y2h, xsj_b[:, :, None])[:, :, 0]
        # junction reconstruction + level-1 back-substitution
        njg = bs.nj_global
        xj = np.where(part.xj_kind == 0,
                      xi2[part.xj_sb,
                          np.minimum(part.xj_slot, ni2 - 1)],
                      xsj[np.minimum(part.xj_slot, self.nsj_total - 1)])
        xj_pad = np.concatenate([xj, [0.0]])
        xj_b = xj_pad[bs.jmap] * bs.jmask
        xi = (w - np.matmul(Yh, xj_b[:, :, None])[:, :, 0]) * self.di_h
        return xi, xj * self.djg_h[:njg]

    # ---- covariance stage -----------------------------------------------

    def newton_refine_cov(self, rounds: int = None, N64=None):
        """One-time float64 Newton refinement of the two-phase float32
        factors (no-op once refined, as after an inline-refined factor):
        the level-1 chunks stream through the device again, with the
        float64 normals (N64, default the host pools) and the float32
        inverses up and the refined float64 pools down into page-locked
        host RAM; the level-2/3 pools are refined on the device
        (schur._refine_nested_cov)."""
        if self._l1_pinned is not None:
            return
        rounds, tol = _newton_policy(rounds)
        bs, link = self.bs, self._link
        if N64 is None:
            N64 = (bs.Nii, bs.Nij, bs.Njj)
        B, ni = N64[0].shape[:2]
        nj = N64[2].shape[1]
        Ah = link.pinned((B, ni, ni), torch.float64)
        Yh = link.pinned((B, ni, nj), torch.float64)

        def store(s, A_c, Y_c):
            link.down(A_c, out=Ah[s])
            link.down(Y_c, out=Yh[s])
            link.sync()

        A2inv, _, Sinv = self.l2_factors
        evid, l2 = _refine_nested_cov(
            self, (B, ni, nj),
            lambda s: [link.up(a[s], f"n64_{i}")
                       for i, a in enumerate(N64)],
            lambda s: link.up(self.Ainv_h[s], "ainv"), self._di,
            self._dj, (A2inv, Sinv), store, rounds, tol)
        self.cov_refine_evidence = evid
        self._set_l1_refined(Ah, Yh)
        self._set_l2_refined(l2)

    def level1_block(self, b):
        """(Ainv_b, Y_b, di_b) float64 numpy: the refined pools when
        there are any, else the float32 factors."""
        if self._cov_l1_h is not None:
            Ah, Yh = self._cov_l1_h
            return Ah[b], Yh[b], self.di_h[b]
        return (self.Ainv_h[b].double().numpy(),
                self.Y_h[b].double().numpy(), self.di_h[b])

    def junction_cov(self, gsel):
        """Scaled covariance over global junction params gsel
        (nested_junction_cov of the refined level-2/3 pools, or of the
        float32 factors)."""
        if self._l2_host is None:
            self._l2_host = tuple(_np64(a) for a in self.l2_factors)
        return nested_junction_cov(self.part, *self._l2_host, gsel)

    @property
    def djg_np(self):
        return self.djg_h
