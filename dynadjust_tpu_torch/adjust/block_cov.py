"""Lazy block-scoped a-posteriori covariance access.

Past the dense-covariance cap (DTA_DENSE_COV_MAX_STN) the full (3S,3S)
matrix is never materialised — it would be terabytes at national scale.
The reference has the same regime: in phased mode it prints
inter-station covariances only from the rigorous PER-BLOCK variance
matrices (dnaadjust_printer.cpp:4330-4390, serialisation
dnaadjust.cpp:6770); stations in different blocks have no printed
covariance.  This provider reproduces exactly that: per-block covariance
matrices are rebuilt on demand from the retained Schur factors (the same
block-inverse identities the statistics pass uses) with a small LRU, so
the writers get within-block station-pair covariances in O(S·k) memory.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class BlockCovProvider:
    def __init__(self, compute, block_stations, cache_blocks: int = 4):
        """compute(b) -> (3k, 3k) covariance in block-local station
        order; block_stations[b] = global station indices of block b."""
        self._compute = compute
        self.block_stations = [np.asarray(s, dtype=np.int64)
                               for s in block_stations]
        self._local = [dict((int(g), i) for i, g in enumerate(s))
                       for s in self.block_stations]
        # primary (first-appearance) block per station — the block whose
        # rigorous variances the reference reports for the station
        self._primary = {}
        self._blocks_of = {}
        for b, st in enumerate(self.block_stations):
            for g in st:
                self._primary.setdefault(int(g), b)
                self._blocks_of.setdefault(int(g), []).append(b)
        self._cache = OrderedDict()
        self._cache_blocks = cache_blocks

    def block_of(self, g: int) -> int | None:
        """Primary (first-appearance) block of station g, or None for a
        station absent from every block (the writers then print no
        covariances for it instead of crashing)."""
        return self._primary.get(int(g))

    def __getstate__(self):
        """Pickle the block layout only: the compute closure holds the
        adjustment's factors (device memory, a local function) and the
        cache is rebuilt from it.  A provider loaded back knows which
        stations share a block but raises when asked for a block's
        covariance."""
        state = dict(self.__dict__)
        state["_compute"] = None
        state["_cache"] = OrderedDict()
        return state

    def block_cov(self, b: int) -> np.ndarray:
        c = self._cache.get(b)
        if c is None:
            if self._compute is None:
                raise RuntimeError(
                    "block covariances are not stored in a saved result "
                    "past the dense-covariance cap (DTA_DENSE_COV_MAX_STN); "
                    "run the adjustment again to report them")
            c = self._compute(b)
            self._cache[b] = c
            while len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(b)
        return c

    def partners(self, g: int):
        """Stations sharing ANY block with g (including g itself) —
        junction stations co-occur with different partners in each block
        they appear in, and the per-block variance printing covers every
        such pair (pair_cov resolves whichever block holds the pair).
        Empty for a station absent from every block."""
        bl = self._blocks_of.get(int(g))
        if not bl:
            return np.zeros(0, dtype=np.int64)
        if len(bl) == 1:
            return self.block_stations[bl[0]]
        seen = {}
        for b in bl:
            for s in self.block_stations[b]:
                seen.setdefault(int(s), None)
        return np.fromiter(seen.keys(), dtype=np.int64, count=len(seen))

    def pair_cov(self, i: int, j: int) -> np.ndarray | None:
        """(3,3) covariance of stations i, j, or None when they share no
        block (the reference's phased mode likewise prints none).
        Resolved in whichever block holds BOTH stations — junction
        pairs may co-occur only in a non-primary block of either."""
        i, j = int(i), int(j)
        for b in self._blocks_of.get(i, ()):
            lj = self._local[b].get(j)
            if lj is not None:
                li = self._local[b][i]
                C = self.block_cov(b)
                return C[3 * li:3 * li + 3, 3 * lj:3 * lj + 3]
        return None
