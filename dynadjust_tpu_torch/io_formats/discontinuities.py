"""SINEX discontinuity files: station renaming by observation epoch.

A discontinuity file (e.g. disconts20201205.snx) carries a
+SOLUTION/DISCONTINUITY block dividing each site's time series into
windows.  Sites with more than one position ('P') window are
discontinuity sites: any station reference whose observation epoch falls
in window w is renamed to ``SITE_YYYYDDD`` where YYYY/DDD come from the
window's start date (first window starts at 1900-001).

Parity reference: DnaIoSnx::ParseDiscontinuityFile / ParseSinexDiscontinuities
(include/io/dnaiosnxread.cpp:86,~210), rename_discont_station
(include/io/dnaiosnx.hpp:159), dna_import::ApplyDiscontinuities /
AddDiscontinuityStations (dnaimport/dnainterop.cpp:825-1010).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, replace

from .dna import DirectionSet, GpsCluster, Measurement, Station
from ..params.datums import parse_epoch

# "00:000" start → before the advent of GPS (TIME_IMMEMORIAL = 1900);
# "00:000" end → far future
_IMMEMORIAL = datetime.date(1900, 1, 1)
_FAR_FUTURE = datetime.date(2200, 12, 31)


@dataclass
class DiscontinuityWindow:
    site: str
    solution_id: int
    start: datetime.date
    end: datetime.date
    exists: bool = False        # site has >1 'P' window


def _yy_doy_to_date(tok: str, terminal: str) -> datetime.date:
    """'yy:doy' → date; 00:000 maps to immemorial/far-future."""
    parts = tok.split(":")
    yy, doy = int(parts[0]), int(parts[1])
    if yy == 0 and doy == 0:
        return _IMMEMORIAL if terminal == "from" else _FAR_FUTURE
    year = 2000 + yy if yy <= 50 else 1900 + yy
    return datetime.date(year, 1, 1) + datetime.timedelta(days=max(doy, 1) - 1)


def read_discontinuities(path: str) -> dict:
    """Parse a discontinuity SINEX file → {site: [DiscontinuityWindow]}.

    Only 'P' (position) model rows are considered; a site with multiple P
    windows is flagged as a discontinuity site."""
    windows: dict[str, list[DiscontinuityWindow]] = {}
    in_block = False
    for line in open(path, errors="replace"):
        if line.startswith("%ENDSNX"):
            break
        if line.startswith("+"):
            in_block = line.startswith("+SOLUTION/DISCONTINUITY")
            continue
        if line.startswith("-"):
            in_block = False
            continue
        if not in_block or line.startswith("*") or not line.strip():
            continue
        site = line[1:5].strip()
        try:
            sol = int(line[9:13].strip() or "0")
            model = line[42:43].strip()
            if model != "P":
                continue
            start = _yy_doy_to_date(line[16:22].strip(), "from")
            end = _yy_doy_to_date(line[29:35].strip(), "to")
        except (ValueError, IndexError):
            continue
        windows.setdefault(site, []).append(
            DiscontinuityWindow(site, sol, start, end))
    for site, ws in windows.items():
        if len(ws) > 1:
            for w in ws:
                w.exists = True
    return windows


def rename_site(disconts: dict, site: str,
                date: datetime.date | None) -> str | None:
    """Renamed site name for an observation at `date`, or None if the site
    has no discontinuity or the date matches no window.

    Matches rename_discont_station: suffix is the matched window's start
    year + zero-padded day-of-year."""
    if date is None:
        return None
    for w in disconts.get(site, ()):
        if not w.exists:
            continue
        if w.start <= date < w.end:
            return f"{site}_{w.start.year}{w.start.timetuple().tm_yday:03d}"
    return None


def _epoch_date(epoch: str) -> datetime.date | None:
    if not epoch:
        return None
    try:
        return parse_epoch(epoch)
    except (ValueError, IndexError):
        return None


def apply_discontinuities(stations: list, measurements: list,
                          disconts: dict) -> list:
    """Rename station references in measurements whose epoch falls in a
    discontinuity window, and clone the affected stations under their new
    names.  Mutates in place; returns [(old, new)] rename pairs.

    Parity: ApplyDiscontinuitiesMeasurements (dnainterop.cpp:866) +
    AddDiscontinuityStations (:773)."""
    renames: dict[str, str] = {}

    def _rn(name: str, date) -> str:
        if not name:
            return name
        new = rename_site(disconts, name, date)
        if new is None:
            return name
        renames[new] = name
        return new

    for rec in measurements:
        if isinstance(rec, GpsCluster):
            date = _epoch_date(rec.epoch)
            for ob in rec.obs:
                ob.first = _rn(ob.first, date)
                ob.second = _rn(ob.second, date)
        elif isinstance(rec, DirectionSet):
            date = _epoch_date(rec.epoch)
            rec.first = _rn(rec.first, date)
            rec.ro = _rn(rec.ro, date)
            rec.directions = [
                (_rn(t, date), v, sd, ign)
                for (t, v, sd, ign) in rec.directions]
        elif isinstance(rec, Measurement):
            date = _epoch_date(rec.epoch)
            rec.first = _rn(rec.first, date)
            rec.second = _rn(rec.second, date)
            rec.third = _rn(rec.third, date)

    # clone stations for each renamed reference not already present
    by_name = {s.name for s in stations}
    originals = {s.name: s for s in stations}
    for new, old in sorted(renames.items()):
        if new in by_name or old not in originals:
            continue
        stations.append(replace(originals[old], name=new,
                                description=(originals[old].description +
                                             f" (discontinuity of {old})")
                                .strip()))
        by_name.add(new)
    return sorted((old, new) for new, old in renames.items())


def export_discontinuities(path: str, disconts: dict):
    """Raw-text dump of parsed discontinuity windows
    (--export-discont-file)."""
    L = ["# Discontinuity information",
         f"{'Site':<10}{'Solution':>9}  {'From':<12}{'To':<12}"
         f"{'Discontinuity?':>15}"]
    for site in sorted(disconts):
        for w in disconts[site]:
            L.append(f"{site:<10}{w.solution_id:>9}  "
                     f"{w.start.isoformat() if w.start else '':<12}"
                     f"{w.end.isoformat() if w.end else '':<12}"
                     f"{'yes' if w.exists else 'no':>15}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
