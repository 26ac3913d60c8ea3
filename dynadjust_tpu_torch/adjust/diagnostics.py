"""Iteration diagnostics: oscillating (non-converging) station detection.

Parity reference: dna_adjust::UpdateIterationDiagnostics
(dnaadjust.cpp:7450-7554) and PrintOscillationSummary (:7556) — consecutive
anti-parallel corrections of similar magnitude flag stations that bounce
between positions instead of converging.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geodesy.local_frame import rotate_cart_local


@dataclass
class OscillationRecord:
    station: int
    first_iteration: int
    last_iteration: int
    cycles: int
    first_mag: float
    last_mag: float
    last_enu: tuple = (0.0, 0.0, 0.0)


@dataclass
class OscillationTracker:
    prev: dict = field(default_factory=dict)        # station -> dx (3,)
    counts: dict = field(default_factory=dict)
    history: dict = field(default_factory=dict)     # station -> record

    def update(self, iteration: int, station_ids, dx, lat, lon):
        """dx: (k, 3) correction vectors for the given stations."""
        for s, d in zip(station_ids, np.asarray(dx).reshape(-1, 3)):
            s = int(s)
            mag = float(np.linalg.norm(d))
            p = self.prev.get(s)
            self.prev[s] = d.copy()
            if p is None:
                continue
            pmag = float(np.linalg.norm(p))
            if mag < 0.001 and pmag < 0.001:
                self.counts[s] = 0
                continue
            denom = mag * pmag
            cos = float(d @ p) / denom if denom > 1e-30 else 0.0
            ratio = mag / pmag if pmag > 1e-30 else 0.0
            if cos < -0.5 and 0.3 < ratio < 3.0:
                self.counts[s] = self.counts.get(s, 0) + 1
            else:
                self.counts[s] = 0
            if self.counts.get(s, 0) >= 2:
                enu = rotate_cart_local(d, lat[s], lon[s])
                local_mag = float(np.linalg.norm(enu))
                rec = self.history.get(s)
                if rec is None:
                    self.history[s] = OscillationRecord(
                        station=s, first_iteration=iteration,
                        last_iteration=iteration,
                        cycles=self.counts[s], first_mag=local_mag,
                        last_mag=local_mag, last_enu=tuple(enu))
                else:
                    rec.last_iteration = iteration
                    rec.cycles = self.counts[s]
                    rec.last_mag = local_mag
                    rec.last_enu = tuple(enu)

    def summary(self, names, min_mag: float = 0.1, limit: int = 20):
        """Formatted summary lines of significant oscillators."""
        recs = [r for r in self.history.values()
                if max(r.first_mag, r.last_mag) >= min_mag]
        recs.sort(key=lambda r: -max(r.first_mag, r.last_mag))
        lines = []
        if not recs:
            return lines
        lines.append(f"+ Oscillating stations detected ({len(recs)} total, "
                     f"showing top {min(limit, len(recs))}):")
        for r in recs[:limit]:
            e, n, up = r.last_enu
            horiz = float(np.hypot(e, n))
            vert = abs(up)
            if vert < 0.01 * horiz:
                direction = "horizontal"
            elif horiz < 0.01 * vert:
                direction = "vertical"
            else:
                direction = "3D"
            lines.append(
                f"  - {names[r.station]} — {r.first_mag:.1f}m to "
                f"{r.last_mag:.1f}m, {direction}, {r.cycles} cycles "
                f"(iterations {r.first_iteration}-{r.last_iteration})")
        return lines
