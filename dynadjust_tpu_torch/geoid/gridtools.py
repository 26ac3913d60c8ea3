"""Geoid grid tooling: create an NTv2 grid from AUSGeoid DAT files, export
grids to ASCII, interpolate point files (DAT/CSV modes).

Parity reference: dna_geoid_interpolation::CreateNTv2File
(dnageoid.cpp:1036), ExportToAscii/Binary (:1372/:1521),
ProcessCsvFile/ProcessDatFile (point-file interpolation modes).
"""

from __future__ import annotations

import re
import struct

import numpy as np

from ..io_formats.ntv2 import NTv2Grid, SubGrid


def _dms_tokens_to_seconds(hemi_deg: str, minutes: str, seconds: str):
    """'S34' '0' '0.000' → signed seconds-of-arc (positive N / E)."""
    sign = -1.0 if hemi_deg[0].upper() in ("S", "W") else 1.0
    deg = float(hemi_deg[1:])
    return sign * (deg * 3600.0 + float(minutes) * 60.0 + float(seconds))


def read_ausgeoid_dat(path: str):
    """AUSGeoid 'GEO' DAT format: N value, lat DMS, lon DMS, deflections.

    Returns (records) of (lat_sec, lon_sec, N, defl_pm, defl_pv)."""
    out = []
    for line in open(path, errors="replace"):
        toks = line.split()
        if len(toks) < 10 or toks[0] != "GEO":
            continue
        n_value = float(toks[1])
        lat = _dms_tokens_to_seconds(toks[2], toks[3], toks[4])
        lon = _dms_tokens_to_seconds(toks[5], toks[6], toks[7])
        defl_pm = float(toks[8])
        defl_pv = float(toks[9])
        out.append((lat, lon, n_value, defl_pm, defl_pv))
    return out


def create_ntv2_from_dat(dat_path: str, uncertainty_path: str = "",
                         gs_type: str = "SECONDS", version: str = "1.0.0.0",
                         system_from: str = "GDA94",
                         system_to: str = "AHD_1971",
                         sub_grid_name: str = "AUSGEOID",
                         created: str = "", updated: str = "",
                         semi_major_from: float = 6378137.0,
                         semi_minor_from: float = 6356752.314,
                         semi_major_to: float = 6378137.0,
                         semi_minor_to: float = 6356752.314) -> NTv2Grid:
    """Build an in-memory NTv2 grid from an AUSGeoid DAT file.

    uncertainty_path: optional WINTER DAT uncertainty file whose N-value
    column fills the 4th grid component (CreateNTv2File,
    dnageoid.cpp:1036)."""
    recs = read_ausgeoid_dat(dat_path)
    if not recs:
        raise ValueError(f"no GEO records in {dat_path}")
    lats = sorted({r[0] for r in recs})
    lons = sorted({r[1] for r in recs})
    lat_inc = min(np.diff(lats)) if len(lats) > 1 else 60.0
    lon_inc = min(np.diff(lons)) if len(lons) > 1 else 60.0

    s_lat, n_lat = lats[0], lats[-1]
    # NTv2 longitudes are positive west: east limit = -max(lon)
    e_long, w_long = -lons[-1], -lons[0]

    sg = SubGrid(name=sub_grid_name[:8], parent="NONE", s_lat=s_lat,
                 n_lat=n_lat, e_long=e_long, w_long=w_long, lat_inc=lat_inc,
                 long_inc=lon_inc)
    sg.created = created
    sg.updated = updated
    vals = np.zeros((sg.nrows, sg.ncols, 4), dtype=np.float32)
    for (lat, lon, n, dpm, dpv) in recs:
        r = int(round((lat - s_lat) / lat_inc))
        c = int(round((-lon - e_long) / lon_inc))
        if 0 <= r < sg.nrows and 0 <= c < sg.ncols:
            vals[r, c] = (n, dpm, dpv, 0.0)
    if uncertainty_path:
        for (lat, lon, unc, _, _) in read_ausgeoid_dat(uncertainty_path):
            r = int(round((lat - s_lat) / lat_inc))
            c = int(round((-lon - e_long) / lon_inc))
            if 0 <= r < sg.nrows and 0 <= c < sg.ncols:
                vals[r, c, 3] = unc
    sg.values = vals
    return NTv2Grid(gs_type=gs_type.upper().ljust(8), version=version,
                    system_from=system_from, system_to=system_to,
                    ellipsoid_from=(semi_major_from, semi_minor_from),
                    ellipsoid_to=(semi_major_to, semi_minor_to),
                    subgrids=[sg])


def write_gsb(grid: NTv2Grid, path: str):
    """Write an NTv2 binary grid (Canadian layout)."""
    def rec_str(key, val):
        return key.encode().ljust(8) + val.encode().ljust(8)

    def rec_int(key, val):
        return key.encode().ljust(8) + struct.pack("<i", val) + b"\x00" * 4

    def rec_dbl(key, val):
        return key.encode().ljust(8) + struct.pack("<d", val)

    blob = b""
    blob += rec_int("NUM_OREC", 11)
    blob += rec_int("NUM_SREC", 11)
    blob += rec_int("NUM_FILE", len(grid.subgrids))
    blob += rec_str("GS_TYPE ", grid.gs_type.strip())
    blob += rec_str("VERSION ", grid.version.strip())
    blob += rec_str("SYSTEM_F", grid.system_from.strip())
    blob += rec_str("SYSTEM_T", grid.system_to.strip())
    blob += rec_dbl("MAJOR_F ", grid.ellipsoid_from[0])
    blob += rec_dbl("MINOR_F ", grid.ellipsoid_from[1])
    blob += rec_dbl("MAJOR_T ", grid.ellipsoid_to[0])
    blob += rec_dbl("MINOR_T ", grid.ellipsoid_to[1])
    for sg in grid.subgrids:
        blob += rec_str("SUB_NAME", sg.name.strip())
        blob += rec_str("PARENT  ", sg.parent.strip())
        blob += rec_str("CREATED ", getattr(sg, "created", "") or "")
        blob += rec_str("UPDATED ", getattr(sg, "updated", "") or "")
        blob += rec_dbl("S_LAT   ", sg.s_lat)
        blob += rec_dbl("N_LAT   ", sg.n_lat)
        blob += rec_dbl("E_LONG  ", sg.e_long)
        blob += rec_dbl("W_LONG  ", sg.w_long)
        blob += rec_dbl("LAT_INC ", sg.lat_inc)
        blob += rec_dbl("LONG_INC", sg.long_inc)
        blob += rec_int("GS_COUNT", sg.nrows * sg.ncols)
        blob += np.ascontiguousarray(
            sg.values.reshape(-1, 4), dtype="<f4").tobytes()
    blob += b"END     " + b"\x00" * 8
    with open(path, "wb") as f:
        f.write(blob)


def export_ascii(grid: NTv2Grid, path: str):
    """Export grid to NTv2 ASCII (.asc)."""
    L = []
    L.append(f"NUM_OREC{11:>8}")
    L.append(f"NUM_SREC{11:>8}")
    L.append(f"NUM_FILE{len(grid.subgrids):>8}")
    L.append(f"GS_TYPE {grid.gs_type.strip():>8}")
    L.append(f"VERSION {grid.version.strip():>8}")
    L.append(f"SYSTEM_F{grid.system_from.strip():>8}")
    L.append(f"SYSTEM_T{grid.system_to.strip():>8}")
    L.append(f"MAJOR_F {grid.ellipsoid_from[0]:>12.3f}")
    L.append(f"MINOR_F {grid.ellipsoid_from[1]:>12.3f}")
    L.append(f"MAJOR_T {grid.ellipsoid_to[0]:>12.3f}")
    L.append(f"MINOR_T {grid.ellipsoid_to[1]:>12.3f}")
    for sg in grid.subgrids:
        L.append(f"SUB_NAME{sg.name.strip():>8}")
        L.append(f"PARENT  {sg.parent.strip():>8}")
        L.append(f"CREATED {'':>8}")
        L.append(f"UPDATED {'':>8}")
        L.append(f"S_LAT   {sg.s_lat:>15.6f}")
        L.append(f"N_LAT   {sg.n_lat:>15.6f}")
        L.append(f"E_LONG  {sg.e_long:>15.6f}")
        L.append(f"W_LONG  {sg.w_long:>15.6f}")
        L.append(f"LAT_INC {sg.lat_inc:>15.6f}")
        L.append(f"LONG_INC{sg.long_inc:>15.6f}")
        L.append(f"GS_COUNT{sg.nrows * sg.ncols:>6}")
        for row in sg.values.reshape(-1, 4):
            L.append(f"{row[0]:10.6f}{row[1]:10.6f}{row[2]:10.6f}"
                     f"{row[3]:10.6f}")
    L.append("END     " + f"{3.33e32:>10.2E}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def interpolate_point_file(grid: NTv2Grid, in_path: str, out_path: str,
                           method: str = "bicubic",
                           convert_heights: bool = False,
                           dms: bool = True, direction: int = 0):
    """Interpolate a DAT or CSV point file (name, lat, lon[, height]) and
    write results alongside; returns (interpolated, skipped).

    dms=True (reference default): coordinates in packed ddd.mmssss."""
    from ..geodesy.conversions import dms_to_rad
    is_csv = in_path.lower().endswith(".csv")
    done = skipped = 0
    out_lines = []
    for line in open(in_path, errors="replace"):
        if not line.strip():
            continue
        if is_csv:
            toks = [t.strip() for t in line.split(",")]
        else:
            toks = [line[0:12].strip(), line[12:28].strip(),
                    line[28:43].strip(), line[43:57].strip()]
        name = toks[0] if toks else ""
        try:
            if dms:
                lat = float(dms_to_rad(float(toks[1])))
                lon = float(dms_to_rad(float(toks[2])))
            else:
                lat = np.radians(float(toks[1]))
                lon = np.radians(float(toks[2]))
        except (ValueError, IndexError):
            skipped += 1
            out_lines.append(f"{name:<12} ERROR invalid coordinates")
            continue
        vals = grid.interpolate(lat, lon, method)
        if vals is None:
            skipped += 1
            out_lines.append(f"{name:<12} ERROR outside grid")
            continue
        done += 1
        h = ""
        if convert_heights and len(toks) > 3 and toks[3]:
            # direction 0: orthometric->ellipsoidal (+N); 1: reverse (-N)
            sgn = -1.0 if direction else 1.0
            try:
                h = f"{float(toks[3]) + sgn * vals[0]:14.4f}"
            except ValueError:
                h = ""
        out_lines.append(
            f"{name:<12}{np.degrees(lat):>16.9f}{np.degrees(lon):>16.9f}"
            f"{vals[0]:>10.3f}{vals[1]:>10.3f}{vals[2]:>10.3f}{h}")
    with open(out_path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    return done, skipped


def grid_summary(grid: NTv2Grid, path: str = "") -> list:
    """Textual summary of an NTv2 grid file (--summary;
    PrintGridFileSummary semantics)."""
    L = []
    if path:
        L.append(f"{'Grid file:':<28}{path}")
    L.append(f"{'GS type:':<28}{grid.gs_type.strip()}")
    L.append(f"{'Version:':<28}{grid.version.strip()}")
    L.append(f"{'From system:':<28}{grid.system_from.strip()}")
    L.append(f"{'To system:':<28}{grid.system_to.strip()}")
    L.append(f"{'Sub-grids:':<28}{len(grid.subgrids)}")
    for sg in grid.subgrids:
        L.append(f"  {'Sub-grid:':<26}{sg.name.strip()} "
                 f"(parent {sg.parent.strip() or 'NONE'})")
        L.append(f"  {'Extent (lat):':<26}{sg.s_lat / 3600.0:.6f} to "
                 f"{sg.n_lat / 3600.0:.6f} deg")
        L.append(f"  {'Extent (lon):':<26}{-sg.w_long / 3600.0:.6f} to "
                 f"{-sg.e_long / 3600.0:.6f} deg")
        L.append(f"  {'Interval:':<26}{sg.lat_inc:.1f} x "
                 f"{sg.long_inc:.1f} sec")
        L.append(f"  {'Nodes:':<26}{sg.nrows} x {sg.ncols} = "
                 f"{sg.nrows * sg.ncols}")
    return L


def export_dna_geo(path: str, net):
    """DNA geoid file: per-station N value and deflections in seconds
    (--export-dna-geo-file; format as sampleData/urban-network.geo)."""
    import math
    L = ["# DNA geoid file."]
    for i in range(net.nstations):
        pm = math.degrees(net.meridian_def[i]) * 3600.0
        pv = math.degrees(net.vertical_def[i]) * 3600.0
        L.append(f"{net.names[i]:<20}{net.geoid_sep[i]:>30.3f}"
                 f"{pm:>19.3f}{pv:>10.3f}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
