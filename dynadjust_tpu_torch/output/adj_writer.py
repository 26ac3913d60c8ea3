"""Adjustment report writers: .adj (full report) and .xyz (coordinates).

Table layouts match the reference's DynAdjustPrinter fixed-column output so
the reference's own golden files (gnss.simult.adj.expected et al.) validate
this framework directly.

Format reference: dnaadjust_printer.cpp (PrintAdjStation :~1400,
PrintMeasurementValue<LinearMeasurement>/<AngularMeasurement>,
PrintAdjMeasurementStatistics); widths from
include/config/dnaconsts-iostream.hpp:63-82.
"""

from __future__ import annotations

import datetime
import math

import numpy as np

from ..geodesy.conversions import rad_to_dms, cart_to_geo
from ..geodesy.local_frame import rotation_cart_to_local
from ..network.data import NetworkData

# column widths (dnaconsts-iostream.hpp)
STATION = 20
CONSTRAINT = 6
LAT_EAST = 13
LON_NORTH = 15
HEIGHT = 11
XYZ_W = 15
STDDEV = 10
MSR = 19
CORR = 12
PREC = 13
STAT = 11
REL = 12
OUTLIER = 12
PAD2 = 2
PAD3 = 3
PRINT_VAR_PAD = 35

OUTPUTLINE = "-" * 80


def format_elapsed_hms(t: float) -> str:
    """boost::posix_time duration style: 00:00:00.009000 (fraction
    omitted when zero) — formatElapsedTime parity
    (tests/test_format_elapsed_time.cpp)."""
    h, rem = divmod(int(t), 3600)
    m, s = divmod(rem, 60)
    frac = t - int(t)
    out = f"{h:02d}:{m:02d}:{s:02d}"
    if frac >= 0.5e-6:
        out += f".{int(round(frac * 1e6)):06d}"
    return out


def format_elapsed_ms(t: float) -> str:
    """Millisecond style used by the phased printers: 7.151ms."""
    return f"{t * 1000:.3f}ms"


def format_elapsed_time(t: float) -> str:
    """FormatElapsedTime parity (tests/test_format_elapsed_time.cpp):
    <1 s -> N.NNNms; <60 s -> N.NNNs; otherwise HH:MM:SS."""
    if t < 1.0:
        return f"{t * 1000:.3f}ms"
    if t < 60.0:
        return f"{t:.3f}s"
    h, rem = divmod(int(t), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


def format_dms(rad: float, dec_places: int = 5, add4: bool = True) -> str:
    """Packed-DMS string of a radians value; dec_places is the seconds
    precision (total decimals = 4 + dec_places when add4)."""
    total = dec_places + (4 if add4 else 0)
    return f"{float(rad_to_dms(rad)):.{total}f}"


_DEFAULT_COORD_TYPES = "PLHhXYZ"


def _coord_cols(net, i, xyz, lat, lon, h, coord_types,
                prec_m=4, prec_s=5, stn_angular="dms"):
    """Per-station coordinate columns for a stn-coord-types string:
    P=lat, L=lon, H=ortho, h=ellipsoidal, X/Y/Z=cartesian, E/N=UTM
    easting/northing, z=zone (PrintAdjStations coord type handling)."""
    out = []
    en = None
    for c in coord_types:
        if c == "P":
            if stn_angular == "ddeg":
                out.append(f"{math.degrees(lat):>{LAT_EAST}.{prec_s + 4}f}")
            else:
                out.append(f"{format_dms(lat, prec_s):>{LAT_EAST}}")
        elif c == "L":
            if stn_angular == "ddeg":
                out.append(f"{math.degrees(lon):>{LON_NORTH}.{prec_s + 4}f}")
            else:
                out.append(f"{format_dms(lon, prec_s):>{LON_NORTH}}")
        elif c == "H":
            out.append(f"{h - net.geoid_sep[i]:>{HEIGHT}.{prec_m}f}")
        elif c == "h":
            out.append(f"{h:>{HEIGHT}.{prec_m}f}")
        elif c in "XYZ":
            out.append(f"{xyz['XYZ'.index(c)]:>{XYZ_W}.{prec_m}f}")
        elif c in ("E", "N", "z"):
            if en is None:
                from ..geodesy.projections import geo_to_grid
                east, north, zone = geo_to_grid(lat, lon)
                en = (east, north, zone)
            if c == "E":
                out.append(f"{en[0]:>{XYZ_W}.4f}")
            elif c == "N":
                out.append(f"{en[1]:>{XYZ_W}.4f}")
            else:
                out.append(f"{int(en[2]):>{PAD3 + 3}d}")
    return "".join(out)


def _coord_headers(coord_types):
    names = {"P": ("Latitude", LAT_EAST), "L": ("Longitude", LON_NORTH),
             "H": ("H(Ortho)", HEIGHT), "h": ("h(Ellipse)", HEIGHT),
             "X": ("X", XYZ_W), "Y": ("Y", XYZ_W), "Z": ("Z", XYZ_W),
             "E": ("Easting", XYZ_W), "N": ("Northing", XYZ_W),
             "z": ("Zone", PAD3 + 3)}
    out = ""
    width = 0
    for c in coord_types:
        if c in names:
            t, w = names[c]
            out += f"{t:>{w}}"
            width += w
    return out, width


def _station_line(net: NetworkData, i: int, xyz, lat, lon, h, sd_enu,
                  coord_types=_DEFAULT_COORD_TYPES, corr=None,
                  prec_m=4, prec_s=5, stn_angular="dms") -> str:
    line = (f"{net.names[i]:<{STATION}}"
            f"{net.constraints[i]:<{CONSTRAINT}}"
            + _coord_cols(net, i, xyz, lat, lon, h, coord_types,
                          prec_m, prec_s, stn_angular) +
            f"{'':<{PAD2}}"
            f"{sd_enu[0]:>{STDDEV}.{prec_m}f}"
            f"{sd_enu[1]:>{STDDEV}.{prec_m}f}"
            f"{sd_enu[2]:>{STDDEV}.{prec_m}f}")
    if corr is not None:
        line += (f"{'':<{PAD2}}"
                 f"{corr[0]:>{HEIGHT}.{prec_m}f}"
                 f"{corr[1]:>{HEIGHT}.{prec_m}f}"
                 f"{corr[2]:>{HEIGHT}.{prec_m}f}")
    line += f"{'':<{PAD2}}{net.descriptions[i]}"
    return line


def _station_header(coord_types=_DEFAULT_COORD_TYPES,
                    stn_corr: bool = False) -> list:
    cols, width = _coord_headers(coord_types)
    hdr = (f"{'Station':<{STATION}}{'Const':<{CONSTRAINT}}"
           + cols +
           f"{'':<{PAD2}}{'SD(e)':>{STDDEV}}{'SD(n)':>{STDDEV}}"
           f"{'SD(up)':>{STDDEV}}")
    total = STATION + CONSTRAINT + width + PAD2 * 2 + STDDEV * 3 + 56
    if stn_corr:
        hdr += (f"{'':{PAD2}}{'Corr(e)':>{HEIGHT}}{'Corr(n)':>{HEIGHT}}"
                f"{'Corr(up)':>{HEIGHT}}")
        total += PAD2 + 3 * HEIGHT
    hdr += f"{'':{PAD2}}Description"
    # the reference reserves 56 columns for the description in the rule
    return [hdr, "-" * max(total, 80)]


def station_lines(net: NetworkData, res,
                  coord_types=_DEFAULT_COORD_TYPES,
                  stn_corr: bool = False, prec_m=4, prec_s=5,
                  stn_angular="dms", file_order=False) -> list:
    lines = []
    corr = None
    if stn_corr:
        # corrections to initial coordinates, in the local frame at the
        # adjusted position (PrintAdjStation, dnaadjust_printer.cpp:4043)
        xyz0 = getattr(res, "initial_xyz", None)
        if xyz0 is None:
            # fallback: rebuild from supplied heights (original height =
            # initial + N when supplied orthometric)
            from ..geodesy.conversions import geo_to_cart
            from ..network.data import ORTHOMETRIC
            h0 = net.initial_height + np.where(
                np.asarray(net.height_ref) == ORTHOMETRIC,
                net.geoid_sep, 0.0)
            x0, y0, z0 = geo_to_cart(net.lat, net.lon, h0,
                                     net.datum.ellipsoid)
            xyz0 = np.stack([np.asarray(x0), np.asarray(y0),
                             np.asarray(z0)], axis=-1)
    order = range(net.nstations)
    if file_order and getattr(net, "station_file_order", None):
        order = sorted(order, key=lambda i: net.station_file_order[i])
    for i in order:
        V = res.station_cov(i)
        R = rotation_cart_to_local(res.lat[i], res.lon[i])
        Vl = R @ V @ R.T
        sd = np.sqrt(np.diag(Vl))
        if stn_corr:
            corr = R @ (res.xyz[i] - xyz0[i])
        lines.append(_station_line(net, i, res.xyz[i], res.lat[i],
                                   res.lon[i], res.height[i], sd,
                                   coord_types, corr, prec_m, prec_s,
                                   stn_angular))
    return lines


def _fmt_angular(rad: float, prec: int, width: int,
                 style: str = "separated") -> str:
    """Fixed-width angular display.

    style: 'separated' (ddd mm ss.ssss, default), 'symbols'
    (ddd°mm'ss.ssss"), 'hp' (packed ddd.mmssss), 'ddeg' (decimal
    degrees) — the reference's --angular-msr-type / --dms-msr-format
    options (FormatAngularMeasurement, dnaadjust_printer.cpp)."""
    if style == "ddeg":
        return f"{math.degrees(rad):>{width}.{5 + prec}f}"
    if style == "hp":
        return f"{float(rad_to_dms(rad)):>{width}.{2 + prec}f}"
    neg = rad < 0
    dms = abs(float(rad_to_dms(rad)))
    d = int(dms)
    rem = (dms - d) * 100.0
    m = int(rem + 1e-9)
    s = (rem - m) * 100.0
    if s < 0.0:
        s = 0.0
    # guard rollover
    if s > 59.999999:
        s = 0.0
        m += 1
    if m >= 60:
        m -= 60
        d += 1
    sign = "-" if neg else ""
    if style == "symbols":
        txt = f"{sign}{d}\u00b0{m:02d}'{s:0{3 + prec}.{prec}f}\""
    else:
        txt = f"{sign}{d} {m:02d} {s:0{3 + prec}.{prec}f}"
    return f"{txt:>{width}}"


def _fz(v: float, nd: int = 2) -> float:
    """Avoid '-0.00': values that round to zero print unsigned (matches
    the reference's iostream output of tiny statistics)."""
    return 0.0 if round(v, nd) == 0 else v


def _msr_stat_cols(r, tstat=False) -> str:
    out = f"{_fz(r.nstat):>{STAT}.2f}"
    if tstat:
        out += f"{_fz(r.tstat):>{STAT}.2f}"
    out += f"{_fz(r.pelzer):>{REL}.2f}"
    return out


def _gnss_alt_rows(net, rows3, units: str):
    """Convert a GPS X/Y/Z stat-row triple to alternate units.

    units: 'enu' (local east/north/up), 'aed' (azimuth, vertical angle,
    slope distance), 'adu' (azimuth, slope distance, up).
    Parity: DynAdjustPrinter GNSS alternate-units printing
    (dnaadjust_printer.cpp:4790-...) with PropagateVariances_CartLocal /
    _LocalPolar_Diagonal (dnatemplatematrixfuncs.hpp)."""
    import copy

    import numpy as np

    from ..geodesy.local_frame import rotation_local_to_cart

    rx = rows3[0]
    if rx.vcv3 is None:
        return rows3
    s1, s2 = rx.s1, rx.s2
    if s2 >= 0:
        mid_lat = 0.5 * (net.lat[s1] + net.lat[s2])
        mid_lon = 0.5 * (net.lon[s1] + net.lon[s2])
    else:
        mid_lat, mid_lon = net.lat[s1], net.lon[s1]
    R = rotation_local_to_cart(mid_lat, mid_lon)

    meas = np.array([r.pre_adj_meas for r in rows3])
    adj = np.array([r.adjusted for r in rows3])
    ml = R.T @ meas
    al = R.T @ adj
    vl = R.T @ rx.vcv3 @ R
    avl = R.T @ rx.adj_vcv3 @ R

    if units == "enu":
        vals_m, vals_a = ml, al
        var_m = np.diag(vl)
        var_a = np.diag(avl)
        cards = "enu"
        is_ang = (False, False, False)
    else:
        az = math.atan2(ml[0], ml[1]) % (2.0 * math.pi)
        dist = float(np.linalg.norm(ml))
        elev = math.asin(ml[2] / dist) if dist > 0 else 0.0
        az_a = math.atan2(al[0], al[1]) % (2.0 * math.pi)
        dist_a = float(np.linalg.norm(al))
        elev_a = math.asin(al[2] / dist_a) if dist_a > 0 else 0.0
        ca, sa = math.cos(az), math.sin(az)
        ce, se = math.cos(elev), math.sin(elev)
        J = np.array([[ca / dist, -sa / dist, 0.0],
                      [-sa * se / dist, -ca * se / dist, ce / dist],
                      [sa * ce, ca * ce, se]])
        vp = np.diag(J @ vl @ J.T)
        avp = np.diag(J @ avl @ J.T)
        if units == "aed":
            vals_m = np.array([az, elev, dist])
            vals_a = np.array([az_a, elev_a, dist_a])
            var_m = vp
            var_a = avp
            cards = "aes"
            is_ang = (True, True, False)
        else:   # adu
            vals_m = np.array([az, dist, ml[2]])
            vals_a = np.array([az_a, dist_a, al[2]])
            var_m = np.array([vp[0], vp[2], vl[2, 2]])
            var_a = np.array([avp[0], avp[2], avl[2, 2]])
            cards = "asu"
            is_ang = (True, False, False)

    sigma0 = max(getattr(net, "_sigma0_hint", 1.0), 1e-20)
    out = []
    for k in range(3):
        r = copy.copy(rows3[k])
        r.cardinal = cards[k]
        r.pre_adj_meas = float(vals_m[k])
        r.measured = float(vals_m[k])
        r.adjusted = float(vals_a[k])
        r.correction = float(vals_a[k] - vals_m[k])
        r.meas_var = max(float(var_m[k]), 0.0)
        r.adj_prec = max(float(var_a[k]), 0.0)
        r.resid_prec = abs(r.meas_var - r.adj_prec)
        r.pelzer = (math.sqrt(r.meas_var / r.resid_prec)
                    if r.resid_prec > 0 else 999.9999)
        r.nstat = (r.correction / math.sqrt(r.resid_prec)
                   if r.resid_prec > 0 else 0.0)
        r.tstat = r.nstat / math.sqrt(sigma0)
        r._force_angular = is_ang[k]
        out.append(r)
    return out


def _y_llh_rows(net, res, rows3, rec, point_idx, sigma0):
    """Convert a Y-cluster point's X/Y/Z stat rows to geographic P/L/H(h)
    rows for printing: adjusted cartesian → geographic (ortho height for
    LLH), a-priori variances from the as-entered geographic VCV, adjusted
    precisions propagated Cartesian→Geographic
    (PrintAdjMeasurements_YLLH, dnaadjust_printer.cpp:2488;
    ReduceYLLHMeasurementsforPrinting, dnaadjust.cpp:9981)."""
    import copy

    import numpy as np

    from ..geodesy.conversions import cart_to_geo
    from ..geodesy.local_frame import geo_cart_jacobian

    ell = net.datum.ellipsoid
    ct = rec.coord_type.upper()
    ob = rec.obs[point_idx]
    meas = np.asarray(ob.vec, dtype=np.float64)      # lat, lon (rad), h
    vcv_geo = np.asarray(ob.vcv, dtype=np.float64) * rec.vscale

    s1 = rows3[0].s1
    adj_xyz = np.array([r.adjusted for r in rows3])
    lat, lon, h = (float(v) for v in cart_to_geo(*adj_xyz, ell))
    sep = 0.0
    if ct == "LLH" and abs(net.geoid_sep[s1]) > 1e-4:
        sep = float(net.geoid_sep[s1])
        h -= sep

    # a-priori precisions: the reference re-loads the cartesian VCV at the
    # adjusted station coordinates (ellipsoidal height) and propagates it
    # back to geographic at the adjusted ORTHO-reduced position — the
    # height mismatch is part of the printed numbers
    # (PrintAdjMeasurements_YLLH step 3, dnaadjust_printer.cpp:2566)
    J_cur = geo_cart_jacobian(res.lat[s1], res.lon[s1], res.height[s1],
                              ell)
    V_cart = J_cur @ vcv_geo @ J_cur.T
    Jinv = np.linalg.inv(geo_cart_jacobian(lat, lon, h, ell))
    var_geo = np.diag(Jinv @ V_cart @ Jinv.T)

    # adjusted precisions: the reference propagates only the diagonal of
    # the cartesian adjusted VCV (PrintAdjMeasurements_YLLH step 2 builds
    # var_cart_adj from measAdjPrec alone)
    adj_vcv3 = rows3[0].adj_vcv3
    if adj_vcv3 is not None:
        D = np.diag(np.diag(np.asarray(adj_vcv3)))
        var_adj = np.diag(Jinv @ D @ Jinv.T)
    else:
        var_adj = np.zeros(3)

    cards = ("P", "L", "H" if ct == "LLH" else "h")
    vals_a = (lat, lon, h)
    is_ang = (True, True, False)
    out = []
    for k in range(3):
        r = copy.copy(rows3[k])
        r.cardinal = cards[k]
        r.pre_adj_meas = float(meas[k])
        r.measured = float(meas[k])
        r.adjusted = float(vals_a[k])
        r.correction = r.adjusted - r.pre_adj_meas
        r.meas_var = max(float(var_geo[k]), 0.0)
        r.adj_prec = max(float(var_adj[k]), 0.0)
        r.resid_prec = abs(r.meas_var - r.adj_prec)
        r.pelzer = (math.sqrt(r.meas_var / r.resid_prec)
                    if r.resid_prec > 0 else 999.99)
        if r.pelzer < 0 or r.pelzer > 700.0:
            r.pelzer = 999.99
        r.nstat = (r.correction / math.sqrt(r.resid_prec)
                   if r.resid_prec > 0 else 0.0)
        r.tstat = r.nstat / math.sqrt(max(sigma0, 1e-20))
        r.pre_adj_corr = sep if k == 2 else 0.0
        r._force_angular = is_ang[k]
        out.append(r)
    return out


def measurement_lines(net: NetworkData, res, msr_prec_m=4,
                      msr_prec_s=4, tstat=False, gnss_units=0,
                      database_ids=False, sort_by=0,
                      include_ignored=False,
                      angular_style="separated") -> list:
    """The Adjusted Measurements table.

    tstat: add the T-stat column (--output-adj-msr-tstat).
    gnss_units: 0 as-measured XYZ, 1 ENU, 2 AED, 3 ADU
    (--output-adj-gnss-units).
    database_ids: append measurement id and (for D/G/X/Y) cluster id
    columns (--output-database-ids; PrintMeasurementDatabaseID).
    sort_by: 0 file order, 1 type, 2 instrument, 3 target, 4 measured
    value, 5 correction, 6 adj sd, 7 n-stat (--sort-adj-msr,
    ADJ_MSR_SORT_UI).
    include_ignored: keep rows for ignored measurements
    (--output-ignored-msrs)."""
    lines = []
    hdr = (f"{'M':<2}{'Station 1':<{STATION}}{'Station 2':<{STATION}}"
           f"{'Station 3':<{STATION}}{'*':<{PAD3}}{'C':<{PAD2}}"
           f"{'Measured':>{MSR}}{'Adjusted':>{MSR}}{'Correction':>{CORR}}"
           f"{'Meas. SD':>{PREC}}{'Adj. SD':>{PREC}}{'Corr. SD':>{PREC}}"
           f"{'N-stat':>{STAT}}"
           + (f"{'T-stat':>{STAT}}" if tstat else "")
           + f"{'Pelzer Rel':>{REL}}"
           f"{'Pre Adj Corr':>{PREC + 1}}{'Outlier?':>{OUTLIER}}"
           + (f"{'Meas. ID':>{STDDEV}}{'Cluster ID':>{STDDEV}}"
              if database_ids else ""))
    lines.append(hdr)
    lines.append("-" * (206 + (STAT if tstat else 0)))

    stats_rows = res.msr_stats
    if database_ids:
        # annotate every row with its database id while rows are still
        # in record order (per-record occurrence counters resolve which
        # direction / cluster baseline a row belongs to); conversions
        # and sorts below carry the annotation with the row
        occ = {}
        for r in stats_rows:
            rec = (net.measurements[r.rec_idx]
                   if r.rec_idx < len(net.measurements) else None)
            k = occ.get(r.rec_idx, 0)
            occ[r.rec_idx] = k + 1
            r._dbid = _row_msr_id(rec, k)
    if not include_ignored:
        stats_rows = [r for r in stats_rows if not r.ignore]

    # Y point clusters entered in geographic terms print as P/L/H rows
    # (PrintAdjMeasurements_YLLH, dnaadjust_printer.cpp:2488)
    sigma0 = res.sigma_zero
    y_llh = []
    point_no = {}
    i = 0
    while i < len(stats_rows):
        r = stats_rows[i]
        rec = (net.measurements[r.rec_idx]
               if r.rec_idx < len(net.measurements) else None)
        if (r.mtype == "Y" and r.cardinal == "X" and i + 2 < len(stats_rows)
                and rec is not None
                and getattr(rec, "coord_type", "XYZ").upper()
                .startswith("LL")):
            p = point_no.get(r.rec_idx, 0)
            point_no[r.rec_idx] = p + 1
            conv = _y_llh_rows(net, res, stats_rows[i:i + 3],
                               rec, p, sigma0)
            for cr in conv:                     # carry the database id
                cr._dbid = getattr(r, "_dbid", None)
            y_llh.extend(conv)
            i += 3
        else:
            y_llh.append(r)
            i += 1
    stats_rows = y_llh
    if sort_by:
        keyfns = {
            1: lambda r: (r.mtype, r.rec_idx),
            2: lambda r: (net.names[r.s1] if r.s1 >= 0 else "", r.rec_idx),
            3: lambda r: (net.names[r.s2] if r.s2 >= 0 else "", r.rec_idx),
            4: lambda r: (r.pre_adj_meas, r.rec_idx),
            5: lambda r: (-abs(r.correction), r.rec_idx),
            6: lambda r: (-r.adj_prec, r.rec_idx),
            7: lambda r: (-abs(r.nstat), r.rec_idx),
        }
        fn = keyfns.get(sort_by)
        if fn is not None:
            stats_rows = sorted(stats_rows, key=fn)
    if gnss_units:
        units = {1: "enu", 2: "aed", 3: "adu"}[gnss_units]
        net._sigma0_hint = res.sigma_zero
        converted = []
        i = 0
        while i < len(stats_rows):
            r = stats_rows[i]
            if r.mtype in ("G", "X", "Y") and r.cardinal == "X" and                     i + 2 < len(stats_rows):
                conv = _gnss_alt_rows(net, stats_rows[i:i + 3], units)
                for cr in conv:                 # carry the database id
                    cr._dbid = getattr(r, "_dbid", None)
                converted.extend(conv)
                i += 3
            else:
                converted.append(r)
                i += 1
        stats_rows = converted

    angular = set("ABDIJKPQVZ")
    for r in stats_rows:
        s1 = net.names[r.s1] if r.s1 >= 0 else ""
        s2 = net.names[r.s2] if r.s2 >= 0 else ""
        s3 = net.names[r.s3] if r.s3 >= 0 else ""
        if r.mtype in ("G", "X", "Y"):
            s3 = ""
            if r.mtype == "Y":
                s2 = ""
        ignore_flag = "*" if r.ignore else " "
        head = (f"{r.mtype:<2}{s1:<{STATION}}{s2:<{STATION}}"
                f"{s3:<{STATION}}{ignore_flag:<{PAD3}}"
                f"{r.cardinal:<{PAD2}}")
        row_angular = (r.mtype in angular or
                       getattr(r, "_force_angular", False))
        if row_angular:
            ps = msr_prec_s
            body = (_fmt_angular(r.pre_adj_meas, ps, MSR,
                                 angular_style) +
                    _fmt_angular(r.adjusted, ps, MSR,
                                 angular_style) +
                    f"{_nz(_sec(r.correction), ps):>{CORR}.{ps}f}" +
                    f"{_sec(math.sqrt(r.meas_var)):>{PREC}.{ps}f}" +
                    f"{_sec(math.sqrt(r.adj_prec)):>{PREC}.{ps}f}" +
                    f"{_sec(math.sqrt(r.resid_prec)):>{PREC}.{ps}f}" +
                    _msr_stat_cols(r, tstat) +
                    f"{_nz(_sec(r.pre_adj_corr), ps):>{PREC + 1}.{ps}f}")
        else:
            body = (f"{r.pre_adj_meas:>{MSR}.{msr_prec_m}f}"
                    f"{r.adjusted:>{MSR}.{msr_prec_m}f}"
                    f"{_nz(r.correction, msr_prec_m):>{CORR}.{msr_prec_m}f}"
                    f"{math.sqrt(r.meas_var):>{PREC}.{msr_prec_m}f}"
                    f"{math.sqrt(r.adj_prec):>{PREC}.{msr_prec_m}f}"
                    f"{math.sqrt(r.resid_prec):>{PREC}.{msr_prec_m}f}"
                    + _msr_stat_cols(r, tstat) +
                    f"{_nz(r.pre_adj_corr, msr_prec_m):>{PREC + 1}.{msr_prec_m}f}")
        outlier = f"{'*':>{OUTLIER}}" if r.outlier else f"{'':{OUTLIER}}"
        line = head + body + outlier
        if database_ids:
            # real database ids from the records (parsed from input /
            # .dbid, io_formats/dbid.py); blank when unset — the
            # reference prints spaces for unset ids
            # (PrintMeasurementDatabaseID, dnaadjust_printer.cpp:239)
            rec = net.measurements[r.rec_idx] \
                if r.rec_idx < len(net.measurements) else None
            mid = getattr(r, "_dbid", None)
            line += (f"{mid:>{STDDEV}}" if mid is not None
                     else " " * STDDEV)
            if r.mtype in ("D", "G", "X", "Y"):
                cid = getattr(rec, "db_cluster_id", None)
                line += (f"{cid:>{STDDEV}}" if cid is not None
                         else " " * STDDEV)
        lines.append(line)
    return lines


def _row_msr_id(rec, k: int):
    """Database id of the k-th stat row of a record: scalar -> its own
    id; direction set -> the k-th direction's id; GPS cluster -> the
    (k//3)-th baseline/point's id (rows come as X/Y/Z triples)."""
    from ..io_formats.dna import GpsCluster, DirectionSet
    if rec is None:
        return None
    if isinstance(rec, GpsCluster):
        b = k // 3
        return rec.obs[b].msr_id if b < len(rec.obs) else None
    if isinstance(rec, DirectionSet):
        ids = rec.direction_ids
        if ids is not None and k < len(ids):
            return ids[k]
        return rec.msr_id
    return getattr(rec, "msr_id", None)


def _sec(rad: float) -> float:
    return rad * 180.0 / math.pi * 3600.0


def _nz(v: float, places: int = 4) -> float:
    """Remove negative zero at the given print precision."""
    if v < 0 and round(v, places) == 0.0:
        return 0.0
    return v


def write_adj(path: str, net: NetworkData, res, opts, cmdline: str = "",
              print_adj_msr: bool = True, geoid_file: str = "",
              tstat: bool = False, gnss_units: int = 0,
              msr_to_stn: bool = False, sort_msr_to_stn: str = "name",
              database_ids: bool = False, sort_adj_msr: int = 0,
              print_ignored: bool = False,
              stn_coord_types: str = _DEFAULT_COORD_TYPES,
              angular_style: str = "separated", stn_corr: bool = False,
              msr_prec_m: int = 4, msr_prec_s: int = 4,
              stn_prec_m: int = 4, stn_prec_s: int = 5,
              stn_angular: str = "dms", stn_file_order: bool = False,
              output_stn_blocks: bool = False,
              output_msr_blocks: bool = False, comments: str = "",
              mode_text: str = "simultaneous", n_blocks: int = 0,
              total_time_s: float = 0.0, stations_file: str = "",
              measurements_file: str = ""):
    # header layout is line-for-line the reference's .adj prelude
    # (gnss.simult.adj.expected:1-53) so dnadiff --skip-headers aligns
    now = datetime.datetime.now()
    L = []
    L.append(OUTPUTLINE)
    L.append("DYNADJUST-TPU ADJUSTMENT OUTPUT FILE")
    L.append("")
    L.append(f"{'Version:':<{PRINT_VAR_PAD}}0.1.0")
    import platform
    import torch
    L.append(f"{'Build:':<{PRINT_VAR_PAD}}Python "
             f"{platform.python_version()} (PyTorch {torch.__version__}, "
             f"CUDA {torch.version.cuda or 'none'})")
    L.append(f"{'File created:':<{PRINT_VAR_PAD}}"
             f"{now.strftime('%A, %d %B %Y, %H:%M:%S')}")
    L.append(f"{'File name:':<{PRINT_VAR_PAD}}{path}")
    L.append("")
    L.append(f"{'Command line arguments:':<{PRINT_VAR_PAD}}{cmdline}")
    L.append("")
    L.append(f"{'Stations file:':<{PRINT_VAR_PAD}}{stations_file}")
    L.append(f"{'Measurements file:':<{PRINT_VAR_PAD}}"
             f"{measurements_file}")
    L.append(f"{'Reference frame:':<{PRINT_VAR_PAD}}{net.frame}")
    L.append(f"{'Epoch:':<{PRINT_VAR_PAD}}{net.epoch}")
    if geoid_file:
        L.append(f"{'Geoid model:':<{PRINT_VAR_PAD}}{geoid_file}")
    L.append(f"{'Constrained Station S.D. (m):':<{PRINT_VAR_PAD}}"
             f"{opts.fixed_std_dev:g}")
    L.append(f"{'Free Station S.D. (m):':<{PRINT_VAR_PAD}}"
             f"{opts.free_std_dev:g}")
    L.append(f"{'Iteration threshold:':<{PRINT_VAR_PAD}}"
             f"{opts.iteration_threshold:g}")
    L.append(f"{'Maximum iterations:':<{PRINT_VAR_PAD}}"
             f"{opts.max_iterations}")
    L.append(f"{'Test confidence interval:':<{PRINT_VAR_PAD}}"
             f"{opts.confidence_interval:.1f}%")
    L.append(f"{'Uncertainties SD(e,n,up):':<{PRINT_VAR_PAD}}"
             f"68.3% (1 sigma)")
    L.append(f"{'Station coordinate types:':<{PRINT_VAR_PAD}}"
             f"{stn_coord_types}")
    L.append(f"{'Stations printed in blocks:':<{PRINT_VAR_PAD}}"
             f"{'Yes' if output_stn_blocks else 'No'}")
    if stn_corr:
        L.append(f"{'Station coordinate corrections:':<{PRINT_VAR_PAD}}"
                 "Yes")
    if comments:
        # wrap at the value column like the reference (PRINT_VAL_PAD)
        words = comments.split()
        line, var = "", "Comments: "
        for w in words:
            if line and len(line) + 1 + len(w) > 45:
                L.append(f"{var:<{PRINT_VAR_PAD}}{line}")
                line, var = w, " "
            else:
                line = f"{line} {w}".strip()
        if line:
            L.append(f"{var:<{PRINT_VAR_PAD}}{line}")
    L.append(OUTPUTLINE)
    L.append("")
    # progress block (dnaadjust.cpp:200,309,10339; line-count parity
    # with the golden headers)
    L.append("+ Initialising adjustment")
    L.append("+ Loading network files")
    L.append("+ Allocating memory")
    L.append("")
    prep = "+ Preparing for adjustment"
    if n_blocks:
        prep += f" ({n_blocks} block{'s' if n_blocks != 1 else ''})"
    L.append(prep + "...  done.")
    L.append(f"+ Commencing {mode_text} adjustment")
    L.append("")
    L.append("")

    def _fmt_elapsed(t):
        if "phased" in mode_text:
            return format_elapsed_ms(t)
        return format_elapsed_hms(t)

    def _fmt_enu(enu):
        # precision graded by the largest component
        # (dnaadjust.cpp:7416-7427)
        e, n, u = enu
        mx = max(abs(e), abs(n), abs(u))
        if mx > 0.000999:
            return f"{e:.3f}, {n:.3f}, {u:.3f}"
        if mx > 0.00009:
            return f"{e:.4f}, {n:.4f}, {u:.4f}"
        return f"{e:.1e}, {n:.1e}, {u:.1e}"

    for entry in res.iteration_log:
        L.append(OUTPUTLINE)
        L.append(f"{'ITERATION':<{PRINT_VAR_PAD}}{entry['iteration']}")
        L.append("")
        L.append(f"{'Elapsed time':<{PRINT_VAR_PAD}}"
                 f"{_fmt_elapsed(entry.get('elapsed', 0.0))}")
        where = (f"Block {entry['block']}, station {entry['station']}"
                 if "block" in entry else f"Station {entry['station']}")
        L.append(f"{'Maximum station correction':<{PRINT_VAR_PAD}}{where}")
        if "enu" in entry:
            L.append(f"{'':{PRINT_VAR_PAD}}{_fmt_enu(entry['enu'])} "
                     f"(e, n, up)")
        else:
            L.append(f"{'':{PRINT_VAR_PAD}}{entry['max_corr']:.6g} (max)")
        L.append("")
        if "est" in entry:
            # per-iteration adjusted stations (--output-iter-adj-stn)
            from ..geodesy.conversions import cart_to_geo
            est = entry["est"].reshape(-1, 3)
            L.append(f"{'Station':<{STATION}}{'X':>{MSR}}{'Y':>{MSR}}"
                     f"{'Z':>{MSR}}")
            L.append("-" * (STATION + 3 * MSR))
            for i in range(net.nstations):
                L.append(f"{net.names[i]:<{STATION}}"
                         f"{est[i, 0]:>{MSR}.4f}{est[i, 1]:>{MSR}.4f}"
                         f"{est[i, 2]:>{MSR}.4f}")
            L.append("")
        if "stat" in entry:
            st = entry["stat"]
            L.append(f"{'Chi squared':<{PRINT_VAR_PAD}}"
                     f"{st['chi_sq']:.2f}")
            L.append(f"{'Sigma zero':<{PRINT_VAR_PAD}}"
                     f"{st['sigma0']:.3f}")
            L.append(f"{'Degrees of freedom':<{PRINT_VAR_PAD}}"
                     f"{st['dof']}")
            L.append("")
        if "msr_rows" in entry:
            import types
            fake = types.SimpleNamespace(msr_stats=entry["msr_rows"],
                                         sigma_zero=1.0)
            if entry.get("cmp_only"):
                L.append("Comparison of Measurements")
            else:
                L.append("Adjusted Measurements")
            L.append("------------------------------------------")
            L.append("")
            L.extend(measurement_lines(net, fake,
                                       angular_style=angular_style))
            L.append("")
        L.append("")

    L.append(OUTPUTLINE)
    L.append(f"{'SOLUTION':<{PRINT_VAR_PAD}}{res.status}")
    L.append(f"{'Total time':<{PRINT_VAR_PAD}}"
             f"{_fmt_elapsed(total_time_s)}")
    L.append("")
    L.append(f"{'Number of unknown parameters':<{PRINT_VAR_PAD}}"
             f"{res.unknown_count}")
    outlier_note = (f"  ({res.potential_outliers} potential outliers)"
                    if res.potential_outliers else "")
    L.append(f"{'Number of measurements':<{PRINT_VAR_PAD}}"
             f"{res.measurement_count}{outlier_note}")
    L.append(f"{'Degrees of freedom':<{PRINT_VAR_PAD}}"
             f"{res.degrees_of_freedom}")
    L.append(f"{'Chi squared':<{PRINT_VAR_PAD}}{res.chi_squared:.2f}")
    L.append(f"{'Rigorous Sigma Zero':<{PRINT_VAR_PAD}}"
             f"{res.sigma_zero:.3f}")
    L.append(f"{'Global (Pelzer) Reliability':<{PRINT_VAR_PAD}}"
             f"{res.global_pelzer:.3f}   "
             f"(excludes non redundant measurements)")
    L.append("")
    chi_prefix = f"Chi-Square test ({opts.confidence_interval:.1f}%)"
    L.append(f"{chi_prefix:<{PRINT_VAR_PAD}}"
             f"{res.chi_lower:.3f} < {res.sigma_zero:.3f} < "
             f"{res.chi_upper:.3f}"
             f"{'*** ' + res.pass_fail + ' ***':>24}")
    L.append("")
    L.append("")

    if print_adj_msr:
        L.append("Adjusted Measurements")
        L.append("------------------------------------------")
        L.append("")
        L.extend(measurement_lines(net, res, msr_prec_m=msr_prec_m,
                                   msr_prec_s=msr_prec_s, tstat=tstat,
                                   gnss_units=gnss_units,
                                   database_ids=database_ids,
                                   sort_by=sort_adj_msr,
                                   include_ignored=print_ignored,
                                   angular_style=angular_style))
        L.append("")
        L.append("")
    if msr_to_stn:
        L.extend(msr_to_stn_lines(net, sort=sort_msr_to_stn))
        L.append("")

    if ((output_stn_blocks or output_msr_blocks) and
            getattr(res, "block_info", None)):
        # segmentation block membership (--output-stn-blocks /
        # --output-msr-blocks; phased mode only)
        L.append("Network Segmentation")
        L.append("------------------------------------------")
        L.append("")
        for bno, inner, junc, mcount in res.block_info:
            L.append(f"{'Block':<{PRINT_VAR_PAD}}{bno}")
            L.append(f"{'Measurements':<{PRINT_VAR_PAD}}{mcount}")
            if output_stn_blocks:
                L.append(f"{'Inner stations':<{PRINT_VAR_PAD}}"
                         f"{len(inner)}")
                for k in range(0, len(inner), 6):
                    L.append(f"{'':{PAD2}}" + "  ".join(
                        f"{n:<{STATION}}" for n in inner[k:k + 6]).rstrip())
                L.append(f"{'Junction stations':<{PRINT_VAR_PAD}}"
                         f"{len(junc)}")
                for k in range(0, len(junc), 6):
                    L.append(f"{'':{PAD2}}" + "  ".join(
                        f"{n:<{STATION}}" for n in junc[k:k + 6]).rstrip())
            L.append("")
        L.append("")

    L.append("Adjusted Coordinates")
    L.append("------------------------------------------")
    L.append("")
    L.extend(_station_header(stn_coord_types, stn_corr))
    L.extend(station_lines(net, res, stn_coord_types, stn_corr,
                           prec_m=stn_prec_m, prec_s=stn_prec_s,
                           stn_angular=stn_angular,
                           file_order=stn_file_order))
    L.append("")

    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def write_xyz(path: str, net: NetworkData, res,
              stn_coord_types: str = _DEFAULT_COORD_TYPES,
              stn_corr: bool = False, stn_prec_m: int = 4,
              stn_prec_s: int = 5, stn_angular: str = "dms",
              stn_file_order: bool = False):
    L = ["Adjusted Coordinates", "",
         *_station_header(stn_coord_types, stn_corr),
         *station_lines(net, res, stn_coord_types, stn_corr,
                        prec_m=stn_prec_m, prec_s=stn_prec_s,
                        stn_angular=stn_angular,
                        file_order=stn_file_order), ""]
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


MSR_TYPE_ORDER = "ABCDEGHIJKLMPQRSVXYZ"


def msr_to_stn_lines(net: NetworkData, sort: str = "name") -> list:
    """Measurements-to-station connectivity summary
    (PrintMeasurementsToStation, dnaadjust_printer.cpp:720; row format
    MsrTally::coutSummaryMsrToStn).  sort: name | count | count_desc |
    file_order (--sort-msr-to-stn)."""
    from ..io_formats.dna import Measurement, GpsCluster, DirectionSet

    NW = 8
    counts = {i: {t: 0 for t in MSR_TYPE_ORDER}
              for i in range(net.nstations)}

    def bump(name, t):
        i = net.station_index(name)
        if i is not None and i >= 0:
            counts[i][t] += 1

    for rec in net.measurements:
        if getattr(rec, "ignore", False):
            continue
        if isinstance(rec, GpsCluster):
            for ob in rec.obs:
                bump(ob.first, rec.mtype)
                if ob.second:
                    bump(ob.second, rec.mtype)
        elif isinstance(rec, DirectionSet):
            bump(rec.first, "D")
            bump(rec.ro, "D")
            for (tgt, _v, _sd, ign) in rec.directions:
                if not ign:
                    bump(tgt, "D")
        elif isinstance(rec, Measurement):
            for n in (rec.first, rec.second, rec.third):
                if n:
                    bump(n, rec.mtype)

    order = list(range(net.nstations))
    if sort == "name":
        order.sort(key=lambda i: net.names[i])
    elif sort == "count":
        order.sort(key=lambda i: sum(counts[i].values()))
    elif sort == "count_desc":
        order.sort(key=lambda i: -sum(counts[i].values()))
    elif sort == "file_order" and net.station_file_order:
        # original input-file position (station_t.fileOrder,
        # CompareStnFileOrder in test_msr_to_stn_sort.cpp)
        order.sort(key=lambda i: net.station_file_order[i])

    lines = ["", "Measurements to Station ",
             "------------------------------------------", ""]
    hdr = f"{'Station':<{STATION}}"
    for t in MSR_TYPE_ORDER:
        hdr += f"{t:>{NW}}"
    hdr += f"{'Total':>{STAT}}"
    lines.append(hdr)
    rule = "-" * (STATION + NW * 20 + STAT)
    lines.append(rule)

    def row(name, c):
        s = f"{name:<{STATION}}"
        for t in MSR_TYPE_ORDER:
            s += f"{c[t]:>{NW}}" if c[t] else f"{'':>{NW}}"
        s += f"{sum(c.values()):>{STAT}}"
        return s

    for i in order:
        lines.append(row(net.names[i], counts[i]))
    lines.append(rule)
    totals = {t: sum(counts[i][t] for i in range(net.nstations))
              for t in MSR_TYPE_ORDER}
    lines.append(row("Totals", totals))
    lines.append("")
    return lines
