"""Blocked GNSS-network adjustment over the Schur solver.

Drives synthetic/large GPS-baseline networks: builds per-block normal
systems (batched padded arrays), iterates Gauss-Newton with the two-level
Schur solve on one device, and returns adjusted coordinates.  The
free-station constraint weighting replicates the reference's
regularisation (free SD 10 m on every coordinate).

Port of the JAX package's ``parallel/blocked_adjust.py``: BlockedNetwork
and build_normals are its host numpy, copied; adjust_blocked keeps its
float64 (schur_solve), float32-refined (schur_solve_refined) and nested
(block_super) branches on `device` (the card by default), and its
mesh-sharded branch (schur_solve_sharded; schur_solve_refined(mesh=...))
over a process group of parallel/multihost.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .schur import build_block_system, schur_solve, \
    schur_solve_refined, schur_solve_sharded, build_nested_partition, \
    schur_solve_nested_factored


@dataclass
class BlockedNetwork:
    """A GPS-baseline network partitioned into blocks."""
    nstations: int
    pairs: np.ndarray           # (M, 2) station indices per baseline
    obs: np.ndarray             # (M, 3)
    weight: np.ndarray          # (M,) per-component weight (1/var)
    blocks: list                # [(inner_stations, junction_stations)]
    junction_stations: np.ndarray
    constrained: np.ndarray = None   # station indices pinned (CCC analogue)
    # derived
    block_of_msr: np.ndarray = None
    station_params: list = None

    def __post_init__(self):
        self._assign_measurements()

    def _assign_measurements(self):
        B = len(self.blocks)
        owner = np.full(self.nstations, -1, dtype=np.int64)
        member = [dict() for _ in range(B)]
        for b, (inner, junc) in enumerate(self.blocks):
            for s in inner:
                owner[s] = b
            for li, s in enumerate(np.concatenate([inner, junc])):
                member[b][int(s)] = li
        jset = set(int(s) for s in self.junction_stations)

        self.block_of_msr = np.empty(len(self.pairs), dtype=np.int64)
        for m, (i, j) in enumerate(self.pairs):
            i, j = int(i), int(j)
            if i not in jset:
                b = owner[i]
            elif j not in jset:
                b = owner[j]
            else:
                # junction-junction baseline: first block containing both
                b = next(bb for bb in range(B)
                         if i in member[bb] and j in member[bb])
            assert i in member[b] and j in member[b], (m, i, j, b)
            self.block_of_msr[m] = b
        self.member = member

    def junction_param_index(self):
        return {int(s): k for k, s in enumerate(self.junction_stations)}


def build_normals(bn: BlockedNetwork, x: np.ndarray, free_weight: float,
                  fixed_weight: float = 1.0e6):
    """Per-block dense normals + rhs at linearisation point x (S, 3).

    GPS baselines: design ±I, weight w per component.  Every station gets
    the free-station constraint weight on its diagonal, added in the block
    that owns it (junctions: the first block containing them)."""
    B = len(bn.blocks)
    block_N, block_rhs = [], []
    inner_idx, junc_idx, junc_global = [], [], []
    jpi = bn.junction_param_index()

    fixed_set = (set(int(s) for s in bn.constrained)
                 if bn.constrained is not None else set())
    constrained = set()
    for b, (inner, junc) in enumerate(bn.blocks):
        stations = np.concatenate([inner, junc])
        n = 3 * len(stations)
        N = np.zeros((n, n))
        r = np.zeros(n)
        member = bn.member[b]

        # vectorised scatter of this block's baselines (the python
        # per-measurement loop dominated assembly at national scale)
        ms = np.nonzero(bn.block_of_msr == b)[0]
        if len(ms):
            loc = np.full(bn.nstations, -1, dtype=np.int64)
            for sg, li_ in member.items():
                loc[sg] = li_
            gi = bn.pairs[ms, 0]
            gj = bn.pairs[ms, 1]
            li = 3 * loc[gi]
            lj = 3 * loc[gj]
            w = bn.weight[ms]
            mmc = bn.obs[ms] - (x[gj] - x[gi])
            Nf = N.ravel()
            for k in range(3):
                np.add.at(Nf, (li + k) * n + (li + k), w)
                np.add.at(Nf, (lj + k) * n + (lj + k), w)
                np.add.at(Nf, (li + k) * n + (lj + k), -w)
                np.add.at(Nf, (lj + k) * n + (li + k), -w)
                np.add.at(r, li + k, -w * mmc[:, k])
                np.add.at(r, lj + k, w * mmc[:, k])

        for s in stations:
            s = int(s)
            if s not in constrained:
                constrained.add(s)
                l = 3 * member[s]
                w_c = fixed_weight if s in fixed_set else free_weight
                for k in range(3):
                    N[l + k, l + k] += w_c

        block_N.append(N)
        block_rhs.append(r)
        ki = 3 * len(inner)
        inner_idx.append(np.arange(ki))
        junc_idx.append(np.arange(ki, n))
        jg = np.empty(3 * len(junc), dtype=np.int64)
        for t, s in enumerate(junc):
            jg[3 * t:3 * t + 3] = 3 * jpi[int(s)] + np.arange(3)
        junc_global.append(jg)

    return build_block_system(block_N, block_rhs, inner_idx, junc_idx,
                              junc_global)


def adjust_blocked(bn: BlockedNetwork, x0: np.ndarray,
                   free_sd: float = 10.0, max_iterations: int = 10,
                   threshold: float = 0.0005, mesh=None,
                   dtype=np.float64, block_super=None, device=None):
    """Gauss-Newton over the blocked system, its solves on `device` (the
    card by default).  Returns (x, iterations, max_corr, history).

    block_super: optional super-block assignment — switches the solve to
    the memory-lean 3-level nested Schur (required at national scale,
    where the flat junction system no longer fits one dense solve).
    mesh (parallel/multihost.py): the flat solves are sharded over its
    ranks (each rank passes the same network and gets the same x); the
    nested branch stays on `device`, as in the JAX package."""
    x = np.asarray(x0, dtype=np.float64).copy()
    free_weight = 1.0 / (free_sd * free_sd)
    history = []
    from .assembly import build_plan, assemble
    plan = build_plan(bn, free_weight)
    part = None
    factors = None
    for it in range(1, max_iterations + 1):
        bs = assemble(plan, x)
        if block_super is not None:
            if part is None:
                part = build_nested_partition(bs, block_super)
            # GNSS design is constant (+/-I): the normals do not change
            # between relinearisations, so the 3-level factorization is
            # reused for the whole Gauss-Newton loop
            xi, xj, factors = schur_solve_nested_factored(
                bs, part, refine=2,
                dtype=np.float32 if dtype == np.float64 else dtype,
                factors=factors, device=device)
        elif dtype != np.float64:
            # f32 factorizations + f64 residual refinement
            xi, xj = schur_solve_refined(bs, mesh=mesh, dtype=dtype,
                                         device=device)
        elif mesh is not None:
            xi, xj = schur_solve_sharded(bs, mesh)
        else:
            xi, xj = schur_solve(bs, device=device)
        # apply corrections
        max_corr = 0.0
        for b, (inner, junc) in enumerate(bn.blocks):
            ki = 3 * len(inner)
            dxi = np.asarray(xi[b][:ki], dtype=np.float64).reshape(-1, 3)
            x[inner] += dxi
            if len(dxi):
                max_corr = max(max_corr, float(np.abs(dxi).max()))
        dxj = np.asarray(xj, dtype=np.float64).reshape(-1, 3)
        x[bn.junction_stations] += dxj
        if len(dxj):
            max_corr = max(max_corr, float(np.abs(dxj).max()))
        history.append(max_corr)
        if max_corr <= threshold:
            return x, it, max_corr, history
    return x, max_iterations, max_corr, history
