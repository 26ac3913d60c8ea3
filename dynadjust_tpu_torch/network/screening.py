"""Import-time data screening: bounding box extraction, station
include/exclude lists, unused-station detection, similar-measurement
search — the dnaimport screening feature set.

Parity reference: dnaimportwrapper.cpp (bounding box :3344,
include/exclude :3394, similar-msr search :2096-2300,
--flag-unused-stations).
"""

from __future__ import annotations

import numpy as np

from ..io_formats.dna import Measurement, GpsCluster, DirectionSet
from ..segment.segmenter import record_stations


def stations_of_record(rec) -> list:
    """Station NAMES referenced by a parsed record."""
    out = []
    if isinstance(rec, GpsCluster):
        for ob in rec.obs:
            out.append(ob.first)
            if ob.second:
                out.append(ob.second)
    elif isinstance(rec, DirectionSet):
        out.append(rec.first)
        out.append(rec.ro)
        out.extend(t for (t, _, _, _) in rec.directions)
    elif isinstance(rec, Measurement):
        out.extend(n for n in (rec.first, rec.second, rec.third) if n)
    seen, ded = set(), []
    for s in out:
        if s not in seen:
            seen.add(s)
            ded.append(s)
    return ded


def unused_stations(stations: list, measurements: list) -> list:
    """Stations with no (non-ignored) measurements connected."""
    used = set()
    for rec in measurements:
        if getattr(rec, "ignore", False):
            continue
        used.update(stations_of_record(rec))
    return [s.name for s in stations if s.name not in used]


def filter_bounding_box(stations: list, measurements: list,
                        lat_min_deg: float, lon_min_deg: float,
                        lat_max_deg: float, lon_max_deg: float,
                        keep_connected: bool = True,
                        split_clusters: bool = False,
                        transcend: bool = False):
    """Keep stations inside the box (and measurements wholly between kept
    stations).  Station lat/lon interpreted from packed-DMS/XYZ as built by
    build_network — pass parsed Station records pre-import.

    transcend: also keep measurements with at least one station in the
    box, pulling their outside stations back in
    (--get-msrs-transcending-box)."""
    from ..geodesy.conversions import dms_to_deg, cart_to_geo
    keep = set()
    for s in stations:
        ct = (s.coord_type or "LLH").upper()
        if ct.startswith("LL"):
            lat = float(dms_to_deg(s.p1))
            lon = float(dms_to_deg(s.p2))
        elif ct == "XYZ":
            la, lo, _ = cart_to_geo(s.p1, s.p2, s.p3)
            lat, lon = np.degrees(float(la)), np.degrees(float(lo))
        else:
            keep.add(s.name)
            continue
        if lat_min_deg <= lat <= lat_max_deg and \
                lon_min_deg <= lon <= lon_max_deg:
            keep.add(s.name)
    if transcend:
        for rec in measurements:
            names = stations_of_record(rec)
            if any(n in keep for n in names):
                keep.update(names)
    return _apply_station_filter(stations, measurements, keep,
                                 split_clusters)


def filter_stations_assoc_msrs(stations: list, measurements: list,
                               include: list = None, exclude: list = None,
                               split_clusters: bool = False):
    """--include-stns-assoc-msrs / --exclude-stns-assoc-msrs: keep (or
    drop) the named stations AND every measurement associated with them;
    include mode pulls in all stations connected through those
    measurements."""
    names = {s.name for s in stations}
    if include:
        seed = set(include) & names
        keep = set(seed)
        for rec in measurements:
            rn = stations_of_record(rec)
            if any(n in seed for n in rn):
                keep.update(rn)
    else:
        drop = set(exclude or [])
        keep = names - drop
        # measurements touching a dropped station are removed by the
        # station filter below
    return _apply_station_filter(stations, measurements, keep,
                                 split_clusters)


def filter_stations(stations: list, measurements: list, include: list = None,
                    exclude: list = None, split_clusters: bool = False):
    """Keep only `include` (plus stations connected through kept
    measurements), or drop `exclude` and their measurements."""
    names = {s.name for s in stations}
    if include:
        keep = set(include) & names
    else:
        keep = names - set(exclude or [])
    return _apply_station_filter(stations, measurements, keep,
                                 split_clusters)


def _apply_station_filter(stations, measurements, keep: set,
                          split_clusters: bool = False):
    kept_msrs = []
    for rec in measurements:
        if all(n in keep for n in stations_of_record(rec)):
            kept_msrs.append(rec)
        elif split_clusters and isinstance(rec, GpsCluster):
            part = split_cluster(rec, keep)
            if part is not None:
                kept_msrs.append(part)
    kept_stns = [s for s in stations if s.name in keep]
    return kept_stns, kept_msrs


def split_cluster(rec: GpsCluster, keep: set):
    """Split an X/Y (or G) cluster at a selection boundary: retain only the
    observations whose stations are all kept, dropping their covariance
    blocks to removed observations.  Returns a new cluster, or None if no
    observation survives.

    Parity: dna_import::SplitClusterMsrsConnectedToStns
    (dnaimport/dnainterop.cpp:3509) — the --split-clusters import option."""
    import copy

    retained = []
    for i, ob in enumerate(rec.obs):
        stns = (ob.first, ob.second) if rec.mtype in ("G", "X") \
            else (ob.first,)
        if all(s in keep for s in stns if s):
            retained.append(i)
    if not retained:
        return None
    if len(retained) == len(rec.obs):
        return rec

    out = copy.copy(rec)
    out.obs = []
    for pos, i in enumerate(retained):
        ob = copy.copy(rec.obs[i])
        ob.vec = np.array(rec.obs[i].vec, copy=True)
        ob.vcv = np.array(rec.obs[i].vcv, copy=True)
        # covs[k] is the 3x3 block to the (i+1+k)-th observation; keep
        # only the blocks pointing at retained later observations
        ob.covs = [np.array(rec.obs[i].covs[j - i - 1], copy=True)
                   for j in retained[pos + 1:]]
        out.obs.append(ob)
    return out


def find_similar_measurements(measurements: list) -> list:
    """Pairs of measurements of the same type between the same stations
    (the --search-similar-msr screen).  Returns list of (i, j) indices."""
    from collections import defaultdict
    index = defaultdict(list)
    for i, rec in enumerate(measurements):
        if isinstance(rec, Measurement):
            key = (rec.mtype, rec.first, rec.second, rec.third)
            index[key].append(i)
        elif isinstance(rec, GpsCluster) and rec.mtype == "G":
            ob = rec.obs[0]
            key = ("G", ob.first, ob.second, "")
            index[key].append(i)
    out = []
    for key, idxs in index.items():
        if len(idxs) > 1:
            for a in range(len(idxs) - 1):
                out.append((idxs[a], idxs[a + 1]))
    return out


def find_nearby_stations(stations: list, tolerance_m: float = 30.0) -> list:
    """Pairs of distinct stations closer than tolerance (possible
    duplicates) — the --search-nearby-stn screen."""
    from ..geodesy.conversions import dms_to_rad, geo_to_cart, cart_to_geo
    pts = []
    for s in stations:
        ct = (s.coord_type or "LLH").upper()
        if ct.startswith("LL"):
            la = float(dms_to_rad(s.p1))
            lo = float(dms_to_rad(s.p2))
            x, y, z = geo_to_cart(la, lo, s.p3)
            pts.append((float(x), float(y), float(z)))
        elif ct == "XYZ":
            pts.append((s.p1, s.p2, s.p3))
        elif ct == "UTM":
            from ..geodesy.projections import grid_to_geo
            zone = int((s.hemi_zone or "0").lstrip("SNsn") or 0)
            la, lo = grid_to_geo(s.p1, s.p2, zone)
            x, y, z = geo_to_cart(float(la), float(lo), s.p3)
            pts.append((float(x), float(y), float(z)))
        else:
            pts.append((np.nan, np.nan, np.nan))
    pts = np.asarray(pts)
    out = []
    # grid hash for O(n) neighbour search
    cell = max(tolerance_m, 1.0)
    buckets = {}
    for i, p in enumerate(pts):
        if not np.isfinite(p).all():
            continue
        key = tuple((p // cell).astype(np.int64))
        buckets.setdefault(key, []).append(i)
    for key, idxs in buckets.items():
        neigh = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    k2 = (key[0] + dx, key[1] + dy, key[2] + dz)
                    neigh.extend(buckets.get(k2, []))
        for i in idxs:
            for j in neigh:
                if j <= i:
                    continue
                if np.linalg.norm(pts[i] - pts[j]) < tolerance_m:
                    out.append((stations[i].name, stations[j].name,
                                float(np.linalg.norm(pts[i] - pts[j]))))
    return sorted(set(out))


_VERTICAL_TYPES = set("HRVZL")


def ignore_insufficient_measurements(stations: list, measurements: list):
    """Iteratively flag stations with too few measurements to be estimable
    and ignore their (non-GNSS) measurements, until a fixpoint.

    Rules (IgnoreInsufficientMeasurements, dnaimport/dnainterop.cpp):
    a station with exactly one measurement is estimable only if that
    measurement is GNSS (3D), or it is a vertical type (H R V Z L) and
    the station is 2D/3D-constrained (CCF/CCC), or the station is fully
    constrained (CCC).  Returns the list of poorly constrained station
    names."""
    constr = {s.name: (s.constraints or "FFF").upper() for s in stations}
    poorly: list = []

    def _constraint_kind(c):
        if c.startswith("CC"):
            return "CCC" if c == "CCC" else "CCF"
        return c

    while True:
        # association count + single-association record per station
        count: dict = {}
        single: dict = {}
        for rec in measurements:
            if getattr(rec, "ignore", False):
                continue
            for name in stations_of_record(rec):
                count[name] = count.get(name, 0) + 1
                single[name] = rec
        insufficient = []
        for s in stations:
            if count.get(s.name, 0) != 1:
                continue
            rec = single[s.name]
            c = constr.get(s.name, "FFF")
            if isinstance(rec, GpsCluster):
                continue                    # GNSS estimates 3D
            mtype = rec.mtype if isinstance(rec, Measurement) else "D"
            if mtype in _VERTICAL_TYPES:
                if c in ("CCC", "CCF"):
                    continue
            else:
                if c == "CCC":
                    continue
            insufficient.append(s.name)
        if not insufficient:
            break
        poorly.extend(insufficient)
        bad = set(insufficient)
        for rec in measurements:
            if getattr(rec, "ignore", False) or isinstance(rec, GpsCluster):
                continue
            if bad & set(stations_of_record(rec)):
                rec.ignore = True
    return poorly
