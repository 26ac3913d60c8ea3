"""SINEX reader: station estimates with full covariance imported as
stations + one GPS point (Y) cluster, and a SINEX writer for adjustment
results.

Semantics reference: dnaimport's ParseSNX (dnainterop.cpp:722) imports the
SOLUTION/ESTIMATE block as a correlated Y cluster; the writer mirrors
snx_file_writer.cpp's block layout.
"""

from __future__ import annotations

import datetime

import numpy as np

from .dna import Station, GpsCluster, GpsObs
from ..geodesy.conversions import cart_to_geo, rad_to_dms
from ..params.ellipsoids import GRS80


def _sinex_epoch_to_date(tok: str):
    """yy:doy:sssss → date."""
    parts = tok.split(":")
    if len(parts) != 3:
        return None
    yy = int(parts[0])
    year = 2000 + yy if yy < 50 else 1900 + yy
    doy = int(parts[1])
    if doy == 0:
        doy = 1
    return datetime.date(year, 1, 1) + datetime.timedelta(days=doy - 1)


def read_sinex(path: str, frame: str = "", epoch: str = "",
               disconts: dict | None = None):
    """Returns (stations, measurements, frame, epoch).

    Stations get XYZ coordinates from SOLUTION/ESTIMATE; the estimates and
    their covariance become a single correlated Y cluster.  disconts: a
    discontinuity table from read_discontinuities — solution estimates are
    renamed SITE_YYYYDDD by their estimate epoch (reference: ParseSNX with
    apply_discontinuities, dnainterop.cpp:722)."""
    lines = open(path, errors="replace").read().splitlines()
    section = None
    est = {}                    # code -> [X, Y, Z]
    order = []                  # parameter index -> (code, comp)
    descs = {}
    ref_epoch = ""
    cov = {}

    for line in lines:
        if line.startswith("+"):
            section = line[1:].split()[0].strip()
            continue
        if line.startswith("-"):
            section = None
            continue
        if line.startswith("*") or line.startswith("%"):
            continue
        if section == "SITE/ID":
            code = line[1:5].strip()
            descs[code] = line[21:44].strip()
        elif section == "SOLUTION/ESTIMATE":
            toks = line.split()
            if len(toks) < 9:
                continue
            idx = int(toks[0])
            ptype = toks[1]
            code = toks[2]
            ref_epoch = ref_epoch or toks[5]
            if disconts:
                from .discontinuities import rename_site
                renamed = rename_site(disconts, code,
                                      _sinex_epoch_to_date(toks[5]))
                if renamed:
                    descs.setdefault(renamed, descs.get(code, ""))
                    code = renamed
            val = float(toks[8])
            if ptype in ("STAX", "STAY", "STAZ"):
                comp = {"STAX": 0, "STAY": 1, "STAZ": 2}[ptype]
                est.setdefault(code, [0.0, 0.0, 0.0])[comp] = val
                order.append((idx, code, comp))
        elif section and section.startswith("SOLUTION/MATRIX_ESTIMATE"):
            toks = line.split()
            if len(toks) < 3:
                continue
            p1 = int(toks[0])
            p2 = int(toks[1])
            for k, v in enumerate(toks[2:]):
                cov[(p1, p2 + k)] = float(v)
                cov[(p2 + k, p1)] = float(v)

    codes = []
    for idx, code, comp in sorted(order):
        if code not in codes:
            codes.append(code)
    param_of = {}
    for idx, code, comp in order:
        param_of[(code, comp)] = idx

    n = len(codes)
    V = np.zeros((3 * n, 3 * n))
    for a, ca in enumerate(codes):
        for i in range(3):
            for b, cb in enumerate(codes):
                for j in range(3):
                    key = (param_of[(ca, i)], param_of[(cb, j)])
                    if key in cov:
                        V[3 * a + i, 3 * b + j] = cov[key]

    ep_date = _sinex_epoch_to_date(ref_epoch) if ref_epoch else None
    epoch_str = ep_date.strftime("%d.%m.%Y") if ep_date else epoch
    frame = frame or "ITRF2005"

    stations, obs_list = [], []
    cl = GpsCluster(mtype="Y", ignore=False, coord_type="XYZ",
                    vscale=1.0, pscale=1.0, lscale=1.0, hscale=1.0,
                    epsg_frame=frame, epoch=epoch_str, cluster_id=1)
    for a, code in enumerate(codes):
        xyz = np.asarray(est[code])
        stations.append(Station(
            name=code, constraints="FFF", coord_type="XYZ",
            p1=xyz[0], p2=xyz[1], p3=xyz[2],
            description=descs.get(code, ""),
            frame=frame, epoch=epoch_str))
        ob = GpsObs(first=code, second="", vec=xyz.copy(),
                    vcv=V[3 * a:3 * a + 3, 3 * a:3 * a + 3])
        for b in range(a + 1, n):
            ob.covs.append(V[3 * a:3 * a + 3, 3 * b:3 * b + 3])
        cl.obs.append(ob)
    return stations, [cl], frame, epoch_str


def _dms_spaced(rad: float, precision: int = 5) -> str:
    """FormatDmsString(RadtoDms(rad), precision, withSpaces=True,
    withSymbols=False) parity (dnatemplatefuncs.hpp:253): packed-DMS
    fixed-format, decimal point -> space, a space after the minutes,
    and (precision > 4) a decimal point inside the seconds —
    e.g. 133°53'07.8" -> '133 53 07.8'."""
    s = f"{float(rad_to_dms(rad)):.{precision}f}"
    dec = s.find(".")
    if dec == 0:
        s = "0" + s
        dec = 1
    out = s[:dec] + " " + s[dec + 1:]
    if precision > 2:
        out = out[:dec + 3] + " " + out[dec + 3:]
    if precision > 4:
        out = out[:dec + 6] + "." + out[dec + 6:]
    return out


def write_sinex(path: str, net, res, agency: str = "DTA"):
    """Write adjusted station estimates + covariance as SINEX 2.01."""
    now = datetime.datetime.now()
    yy = now.year % 100
    doy = now.timetuple().tm_yday
    S = net.nstations
    hdr = (f"%=SNX 2.01 {agency} {yy:02d}:{doy:03d}:00000 {agency} "
           f"00:001:00000 00:001:00000 C {3 * S:05d} 2 X V")
    L = [hdr]
    L.append("+FILE/COMMENT")
    L.append(" Produced by dynadjust_tpu_torch")
    L.append("-FILE/COMMENT")
    L.append("+SITE/ID")
    L.append("*CODE PT __DOMES__ T _STATION DESCRIPTION__ APPROX_LON_ "
             "APPROX_LAT_ _APP_H_")
    # columns per the reference writer (snx_file_writer.cpp:213-238):
    # name[:4], "A", name[:9] in the DOMES field, T="P", description,
    # then approx lon/lat as "ddd mm ss.sssss" (FormatDmsString
    # precision 5 with spaces) and the height at 7.1
    for i in range(S):
        code = net.names[i][:4].ljust(4)
        domes = net.names[i][:9].ljust(9)
        lon_s = _dms_spaced(res.lon[i], 5)
        lat_s = _dms_spaced(res.lat[i], 5)
        L.append(f" {code}  A {domes} P {net.descriptions[i][:22]:<22} "
                 f"{lon_s:>11} {lat_s:>11} {res.height[i]:7.1f}")
    L.append("-SITE/ID")
    L.append("+SOLUTION/STATISTICS")
    L.append("*_STATISTICAL PARAMETER________ __VALUE(S)____________")
    # the reference prints observation/unknown counts, DoF and the
    # variance factor (SerialiseStatistics, snx_file_writer.cpp:242-262)
    L.append(f" {'NUMBER OF OBSERVATIONS':<30} "
             f"{res.measurement_count:>22}")
    L.append(f" {'NUMBER OF UNKNOWNS':<30} {res.unknown_count:>22}")
    L.append(f" {'NUMBER OF DEGREES OF FREEDOM':<30} "
             f"{res.measurement_count - res.unknown_count:>22}")
    L.append(f" {'VARIANCE FACTOR':<30} {res.sigma_zero:>22.6f}")
    L.append("-SOLUTION/STATISTICS")
    L.append("+SOLUTION/ESTIMATE")
    L.append("*INDEX TYPE__ CODE PT SOLN _REF_EPOCH__ UNIT S "
             "__ESTIMATED VALUE____ _STD_DEV___")
    idx = 1
    for i in range(S):
        code = net.names[i][:4].ljust(4)
        for comp, t in enumerate(("STAX", "STAY", "STAZ")):
            sd = np.sqrt(res.station_cov(i)[comp, comp])
            L.append(f" {idx:5d} {t:<6} {code}  A    1 "
                     f"{yy:02d}:{doy:03d}:00000 m    1 "
                     f"{res.xyz[i][comp]: .14E} {sd:.5E}")
            idx += 1
    L.append("-SOLUTION/ESTIMATE")
    L.append("+SOLUTION/MATRIX_ESTIMATE L COVA")
    L.append("*PARA1 PARA2 ____PARA2+0__________ ____PARA2+1__________ "
             "____PARA2+2__________")
    if res.cov_xyz is not None:
        L.append(lambda f: _write_dense_cova(f, res.cov_xyz))
    elif getattr(res, "block_cov", None) is not None:
        # national scale: within-block inter-station covariances from the
        # per-block factors (the reference's phased-mode block-scoped
        # variances); SINEX permits omitting unstored (zero) lower-
        # triangle elements, so cross-block pairs are simply absent
        L.append(lambda f: _write_block_cova(f, res, S))
    else:
        # per-station 3x3 blocks only
        for i in range(S):
            Vc = res.station_cov(i)
            for rr in range(3):
                r = 3 * i + rr + 1
                c = 3 * i + 1
                vals = [f"{Vc[rr, k]: .14E}" for k in range(rr + 1)]
                L.append(f" {r:5d} {c:5d} " + " ".join(vals))
    L.append("-SOLUTION/MATRIX_ESTIMATE L COVA")
    L.append("%ENDSNX")
    with open(path, "w") as f:
        # the covariance sections are streamed row by row
        for part in L:
            if callable(part):
                part(f)
            else:
                f.write(part + "\n")


# covariance lines of 1-3 values: the f-string form
# " {r:5d} {c:5d} " + " ".join(f"{v: .14E}" ...) as %-formats, which
# format many lines in one call
_FORMATS = {k: " %5d %5d" + " % .14E" * k + "\n" for k in (1, 2, 3)}
# rows (dense section) or stations (block section) per table of lines
_STEP = 64


def _lines(parts) -> str:
    """The lines of a table given in (rows, cols, vals, counts) parts:
    row rows[k], first column cols[k] and the first counts[k] values of
    vals[k] (n, 3)."""
    rows, cols, vals, counts = (np.concatenate(x) for x in zip(*parts))
    table = np.empty((len(counts), 5), dtype=object)
    table[:, 0], table[:, 1], table[:, 2:] = rows, cols, vals
    keep = np.arange(5) < 2 + counts[:, None]
    return ("".join(_FORMATS[k] for k in counts.tolist())
            % tuple(table[keep].tolist()))


def _write_dense_cova(f, cov):
    """Lower triangle of the dense (3S, 3S) covariance, three values to a
    line, each row from column 1."""
    n = cov.shape[0]

    def rows(r0):
        for r in range(r0 + 1, min(n, r0 + _STEP) + 1):
            m = (r + 2) // 3                    # lines of row r
            vals = np.zeros(3 * m)
            vals[:r] = cov[r - 1, :r]
            counts = np.full(m, 3)
            counts[-1] = r - 3 * (m - 1)
            yield (np.full(m, r), np.arange(1, 3 * m, 3),
                   vals.reshape(m, 3), counts)

    for r0 in range(0, n, _STEP):
        f.write(_lines(rows(r0)))


def _write_block_cova(f, res, S):
    """The lower triangle of the block-scoped covariance matrix past the
    dense cap: for each station i and component rr, one line per partner
    j < i (stations sharing a block with i, ascending) holding
    cov(j_k, i_rr), k = 0..2, from the first block of j that holds both,
    then the diagonal line from res.station_cov(i).  Each block's
    covariance is fetched once: a station-ordered walk through the
    provider's small cache would rebuild blocks again and again (about
    8e5 rebuilds for 10,000 stations in 12 blocks)."""
    bc = res.block_cov
    B = len(bc.block_stations)
    loc = np.full((B, S), -1, dtype=np.int64)
    for b, st in enumerate(bc.block_stations):
        loc[b, st] = np.arange(len(st))
    covs = [bc.block_cov(b) for b in range(B)]
    partners = []
    for i in range(S):
        P = np.asarray(bc.partners(i), dtype=np.int64)
        partners.append(np.sort(P[P < i]))

    def station(i):
        P = partners[i]
        V = np.empty((len(P), 3, 3))                # V[p, k, rr]
        if len(P):
            both = (loc[:, P] >= 0) & (loc[:, i] >= 0)[:, None]
            first = np.argmax(both, axis=0)
            for b in np.unique(first):
                sel = first == b
                rows = 3 * loc[b, P[sel]][:, None] + np.arange(3)
                cols = 3 * loc[b, i] + np.arange(3)
                V[sel] = covs[b][rows[:, :, None], cols[None, None, :]]
        Vc = res.station_cov(i)
        cols = np.append(3 * P + 1, 3 * i + 1)
        for rr in range(3):
            diag = np.zeros(3)
            diag[:rr + 1] = Vc[rr, :rr + 1]
            yield (np.full(len(P) + 1, 3 * i + rr + 1), cols,
                   np.vstack([V[:, :, rr], diag]),
                   np.append(np.full(len(P), 3), rr + 1))

    def stations(i0):
        for i in range(i0, min(S, i0 + _STEP)):
            yield from station(i)

    for i0 in range(0, S, _STEP):
        f.write(_lines(stations(i0)))
