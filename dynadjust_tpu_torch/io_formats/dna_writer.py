"""DNA v3.01 station (.stn) and measurement (.msr) writers.

Column layout mirrors the v3.01 positions/widths in dnaiodnatypes.hpp so
written files round-trip through read_dna_stn/read_dna_msr and through the
reference's own import.
"""

from __future__ import annotations

import datetime

import numpy as np

from .dna import (
    Station, Measurement, GpsCluster, DirectionSet, ANGULAR_TYPES,
)
from ..geodesy.conversions import rad_to_dms

_RAD_TO_SEC = 180.0 / np.pi * 3600.0


def _header(kind: str, frame: str, epoch: str, count: int) -> str:
    today = datetime.date.today().strftime("%d.%m.%Y")
    return (f"!#=DNA 3.01 {kind}    {today}    {frame:>10}    {epoch}"
            f"{count:>10}")


def write_dna_stn(path: str, net, adjusted=None, ellipsoidal=False):
    """Write stations from a NetworkData (current coordinates, LLH packed
    DMS with orthometric height; ``ellipsoidal=True`` writes LLh with the
    ellipsoidal height instead)."""
    lines = [_header("STN", net.frame, net.epoch, net.nstations),
             "* Station file exported by dynadjust_tpu_torch"]
    lat = adjusted.lat if adjusted is not None else net.lat
    lon = adjusted.lon if adjusted is not None else net.lon
    hgt = adjusted.height if adjusted is not None else net.height
    for i in range(net.nstations):
        H = hgt[i] if ellipsoidal else hgt[i] - net.geoid_sep[i]
        lines.append(
            f"{net.names[i]:<20}{net.constraints[i]:<4}"
            f"{'LLh' if ellipsoidal else 'LLH'}"
            f"{float(rad_to_dms(lat[i])):>20.10f}"
            f"{float(rad_to_dms(lon[i])):>20.10f}"
            f"{H:>20.4f}"
            f"{'':<4}{net.descriptions[i]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _ang_cols(rad: float) -> str:
    """'ddd mm ss.ssss' at v3.01 angular columns (d:4, m:2, s:8)."""
    neg = rad < 0
    dms = abs(float(rad_to_dms(rad)))
    d = int(dms)
    rem = (dms - d) * 100.0
    m = int(rem + 1e-9)
    s = (rem - m) * 100.0
    if s > 59.99999:
        s = 0.0
        m += 1
    if m >= 60:
        m -= 60
        d += 1
    sign = "-" if neg else ""
    # v3.01 angular columns: degrees (76,4), minutes (80,2), seconds (82,8);
    # the seconds keep two whole digits ("00.4779"), which the reader
    # needs: it reads one whole digit as the tens of seconds
    return f"{sign + str(d):>3} {m:02d} {s:07.4f}"


def write_dna_msr(path: str, net):
    """Write measurement records back out in DNA v3.01 layout."""
    records = net.measurements
    count = len(records)
    lines = [_header("MSR", net.frame, net.epoch, count),
             "* Measurement file exported by dynadjust_tpu_torch"]
    for rec in records:
        if isinstance(rec, GpsCluster):
            _write_gps(lines, rec)
        elif isinstance(rec, DirectionSet):
            _write_dirnset(lines, rec)
        elif isinstance(rec, Measurement):
            _write_scalar(lines, rec)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _ignore_flag(rec) -> str:
    return "*" if getattr(rec, "ignore", False) else " "


def _write_scalar(lines, m: Measurement):
    head = f"{m.mtype}{_ignore_flag(m)}{m.first:<20}{m.second:<20}" \
           f"{m.third:<20}"
    if m.mtype in ANGULAR_TYPES:
        body = f"{'':14}{_ang_cols(m.value)}"
        sd = f"{m.sd * _RAD_TO_SEC:>9.4f}"
        line = head + body + sd
    else:
        line = head + f"{m.value:>14.4f}{'':14}{m.sd:>9.6f}"
    if m.inst_height or m.targ_height:
        line += f"{m.inst_height:>7.3f}{m.targ_height:>7.3f}"
    lines.append(line)


def _write_dirnset(lines, d: DirectionSet):
    lines.append(
        f"D{_ignore_flag(d)}{d.first:<20}{d.ro:<20}"
        f"{len(d.directions):<20}{'':14}{_ang_cols(d.ro_value)}"
        f"{d.ro_sd * _RAD_TO_SEC:>9.4f}")
    for (target, val, sd, ign) in d.directions:
        lines.append(
            f"D{'*' if ign else ' '}{'':20}{'':20}{target:<20}"
            f"{'':14}{_ang_cols(val)}{sd * _RAD_TO_SEC:>9.4f}")


def _num20(v: float) -> str:
    return f"{v:>20.10e}" if abs(v) < 1e-3 else f"{v:>20.4f}"


def _write_gps(lines, cl: GpsCluster):
    n = len(cl.obs)
    first = cl.obs[0]
    if cl.mtype == "Y":
        head = (f"Y{_ignore_flag(cl)}{first.first:<20}"
                f"{cl.coord_type:<20}{n:<20}")
    elif cl.mtype == "X":
        head = (f"X{_ignore_flag(cl)}{first.first:<20}{first.second:<20}"
                f"{n:<20}")
    else:
        head = (f"G{_ignore_flag(cl)}{first.first:<20}{first.second:<20}"
                f"{'':20}")
    head += (f"{cl.vscale:>10.2f}{cl.pscale:>10.2f}{cl.lscale:>10.2f}"
             f"{cl.hscale:>10.2f}{cl.epsg_frame:>20}{cl.epoch:>20}")
    lines.append(head)
    for b, ob in enumerate(cl.obs):
        if b > 0:
            if cl.mtype == "Y":
                lines.append(f"Y{_ignore_flag(cl)}{ob.first:<20}")
            else:
                lines.append(f"{cl.mtype}{_ignore_flag(cl)}{ob.first:<20}"
                             f"{ob.second:<20}")
        vec = ob.vec
        if cl.mtype == "Y" and cl.coord_type.upper().startswith("LL"):
            vec = [float(rad_to_dms(ob.vec[0])),
                   float(rad_to_dms(ob.vec[1])), ob.vec[2]]
        V = ob.vcv
        pad = " " * 62
        lines.append(f"{pad}{vec[0]:>20.10f}{V[0, 0]:>20.13e}")
        lines.append(f"{pad}{vec[1]:>20.10f}{V[0, 1]:>20.13e}"
                     f"{V[1, 1]:>20.13e}")
        lines.append(f"{pad}{vec[2]:>20.10f}{V[0, 2]:>20.13e}"
                     f"{V[1, 2]:>20.13e}{V[2, 2]:>20.13e}")
        for C in ob.covs:
            for r in range(3):
                lines.append(f"{pad}{'':20}{C[r, 0]:>20.13e}"
                             f"{C[r, 1]:>20.13e}{C[r, 2]:>20.13e}")
