"""Auxiliary input files: GNSS baseline scalar files, Type B uncertainty
files, station renaming files.

Format reference: dnaioscalar.cpp (scalar file), dnaiotbu.hpp:51-123
(Type B), dna renaming files (dsg.renaming sample).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BaselineScalar:
    station1: str
    station2: str
    v_scale: float = 1.0
    p_scale: float = 1.0
    l_scale: float = 1.0
    h_scale: float = 1.0


def read_scalar_file(path: str) -> list:
    """GNSS baseline VCV scalar file → list of BaselineScalar."""
    out = []
    in_table = False
    for line in open(path, errors="replace"):
        if line.startswith("Station 1"):
            in_table = True
            continue
        if not in_table or line.startswith("-") or not line.strip():
            continue
        s1 = line[0:20].strip()
        s2 = line[20:40].strip()
        toks = line[40:].split()
        if not s1 or not s2 or len(toks) < 4:
            continue
        out.append(BaselineScalar(s1, s2, *(float(t) for t in toks[:4])))
    return out


def apply_baseline_scalars(measurements: list, scalars: list) -> int:
    """Apply scalar-file entries to matching G/X baselines (both station
    orders accepted).  Returns the number of clusters updated."""
    from .dna import GpsCluster
    table = {}
    for s in scalars:
        table[(s.station1, s.station2)] = s
        table[(s.station2, s.station1)] = s
    n = 0
    for rec in measurements:
        if not isinstance(rec, GpsCluster) or rec.mtype not in ("G", "X"):
            continue
        for ob in rec.obs:
            key = (ob.first, ob.second)
            if key in table:
                s = table[key]
                rec.vscale = s.v_scale
                rec.pscale = s.p_scale
                rec.lscale = s.l_scale
                rec.hscale = s.h_scale
                n += 1
                break
    return n


@dataclass
class TypeBUncertainty:
    station: str            # station name, or "" for a global default
    sd_e: float = 0.0       # metres, 1 sigma, local frame
    sd_n: float = 0.0
    sd_up: float = 0.0


def read_typeb_file(path: str) -> list:
    """Type B uncertainty file (fixed columns: name 20, e 13, n 13, up 13)."""
    out = []
    for line in open(path, errors="replace"):
        if line.startswith(("!", "*", "#")) or not line.strip():
            continue
        name = line[0:20].strip()
        if not name:
            continue

        def fld(a, b):
            t = line[a:b].strip() if len(line) > a else ""
            return float(t) if t else 0.0
        out.append(TypeBUncertainty(name, fld(20, 33), fld(33, 46),
                                    fld(46, 59)))
    return out


def parse_typeb_global(spec: str) -> TypeBUncertainty:
    """--type-b-global e,n,up (metres)."""
    toks = [t.strip() for t in spec.split(",")]
    vals = [float(t) if t else 0.0 for t in toks[:3]]
    vals += [0.0] * (3 - len(vals))
    return TypeBUncertainty("", *vals)


def apply_type_b(net, res, typeb_list, global_tb=None):
    """Add Type B variances (local frame) onto the a-posteriori station
    covariances — reference: PrintAdjStation type b application,
    dnaadjust_printer.cpp (reapplyTypeBUncertainties)."""
    from ..geodesy.local_frame import propagate_variance_local_cart
    by_name = {tb.station: tb for tb in typeb_list or []}
    n = 0
    for i, name in enumerate(net.names):
        tb = by_name.get(name, global_tb)
        if tb is None:
            continue
        v_local = np.diag([tb.sd_e ** 2, tb.sd_n ** 2, tb.sd_up ** 2])
        v_cart = propagate_variance_local_cart(v_local, res.lat[i],
                                               res.lon[i])
        res.add_station_cov(i, v_cart)
        n += 1
    return n


def read_renaming_file(path: str) -> dict:
    """Station renaming file: maps old name → new name."""
    out = {}
    for line in open(path, errors="replace"):
        if line.startswith(("!", "*", "#")) or not line.strip():
            continue
        toks = line.split()
        if len(toks) >= 2:
            out[toks[0]] = toks[1]
    return out


def apply_renaming(stations: list, measurements: list, renames: dict) -> int:
    from .dna import GpsCluster, DirectionSet, Measurement
    n = 0
    for s in stations:
        if s.name in renames:
            s.name = renames[s.name]
            n += 1
    for rec in measurements:
        if isinstance(rec, GpsCluster):
            for ob in rec.obs:
                ob.first = renames.get(ob.first, ob.first)
                if ob.second:
                    ob.second = renames.get(ob.second, ob.second)
        elif isinstance(rec, DirectionSet):
            rec.first = renames.get(rec.first, rec.first)
            rec.ro = renames.get(rec.ro, rec.ro)
            rec.directions = [
                (renames.get(t, t), v, sd, ig)
                for (t, v, sd, ig) in rec.directions]
        elif isinstance(rec, Measurement):
            rec.first = renames.get(rec.first, rec.first)
            if rec.second:
                rec.second = renames.get(rec.second, rec.second)
            if rec.third:
                rec.third = renames.get(rec.third, rec.third)
    return n
