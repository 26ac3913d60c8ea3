"""Tectonic plate identification and plate motion models.

Reads PB2002/MORVEL56 digitised plate boundaries (.dig: plate id followed
by lon,lat vertex pairs) and Euler pole files (.dat: id, pole lat, pole
lon, deg/Ma rotation rate), converts Euler poles to cartesian rotation
rates (mas/yr), and locates stations by point-in-polygon.

Parity reference: dnaiotpb.cpp (file formats),
dna_reftran::CalculateRotations (dnareftran.cpp:207 — pole → mas/yr
conversion), IdentifyStationPlate (:103).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_RAD_TO_SEC = 180.0 / np.pi * 3600.0


@dataclass
class PlateModel:
    # list of (plate id, (n, 2) lon/lat polygon) — one id may own several
    # polygons (MORVEL56's dig reuses 'NB' for North Bismarck and Nubia)
    polygons: list
    rotations: dict         # plate id -> (rx, ry, rz) mas/yr

    def identify(self, lat_rad: float, lon_rad: float) -> str | None:
        """Plate containing the point (ray casting in lon/lat degrees)."""
        lon = np.degrees(lon_rad)
        lat = np.degrees(lat_rad)
        best = None
        best_span = np.inf
        for name, poly in self.polygons:
            # test every longitude-congruent copy of the point that lands
            # inside the polygon's unwrapped longitude window (polygons
            # that ring the globe span a full 360° after unwrapping, so a
            # single recentred copy is not sufficient)
            lo_min, lo_max = poly[:, 0].min(), poly[:, 0].max()
            k0 = int(np.ceil((lo_min - lon) / 360.0))
            k1 = int(np.floor((lo_max - lon) / 360.0))
            if any(_point_in_polygon(lon + 360.0 * k, lat, poly)
                   for k in range(k0, k1 + 1)):
                # smallest polygon wins where digitised regions overlap
                span = (lo_max - lo_min) * (poly[:, 1].max() -
                                            poly[:, 1].min())
                if span < best_span:
                    best, best_span = name, span
        return best

    def rotation_rates(self, plate: str):
        """Cartesian rotation rates (mas/yr) for a plate."""
        return self.rotations.get(plate)


def _point_in_polygon(x, y, poly: np.ndarray) -> bool:
    """Even-odd ray casting; poly (n, 2) of (lon, lat)."""
    px = poly[:, 0]
    py = poly[:, 1]
    x1, y1 = px, py
    x2, y2 = np.roll(px, -1), np.roll(py, -1)
    cond = (y1 > y) != (y2 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
    crossings = np.count_nonzero(cond & (x < xin))
    return crossings % 2 == 1


def read_plate_boundaries(path: str) -> list:
    """.dig file → [(plate id, (n, 2) lon/lat array)].  A list, not a
    dict: ids repeat (IdentifyStationPlate scans every digitised region,
    dnareftran.cpp:103)."""
    polys = []
    name = None
    points = []
    for line in open(path, errors="replace"):
        line = line.strip()
        if not line:
            continue
        if line.startswith("*"):
            if name and points:
                polys.append((name, np.asarray(points)))
            name, points = None, []
            continue
        if "," in line:
            try:
                lon, lat = (float(t) for t in line.split(",")[:2])
                points.append((lon, lat))
                continue
            except ValueError:
                pass
        # a plate identifier line
        if name and points:
            polys.append((name, np.asarray(points)))
        name = line.split()[0]
        points = []
    if name and points:
        polys.append((name, np.asarray(points)))
    return polys


def read_plate_poles(path: str) -> dict:
    """.dat pole file → {plate id: (pole_lat_deg, pole_lon_deg,
    rot_deg_per_Ma)}."""
    out = {}
    for line in open(path, errors="replace"):
        if line.startswith(("*", "#")) or not line.strip():
            continue
        toks = line.split()
        if len(toks) < 4:
            continue
        try:
            out[toks[0]] = (float(toks[1]), float(toks[2]), float(toks[3]))
        except ValueError:
            continue
    return out


def euler_to_cartesian_rates(pole_lat_deg, pole_lon_deg, rate_deg_ma):
    """Euler pole → cartesian rotation rates in mas/yr
    (CalculateRotations parity: rad/Ma → arcsec/Ma → mas/yr)."""
    r_rot = np.radians(rate_deg_ma)
    r_lat = np.radians(pole_lat_deg)
    r_lon = np.radians(pole_lon_deg)
    f = _RAD_TO_SEC / 1000.0
    return (r_rot * np.cos(r_lat) * np.cos(r_lon) * f,
            r_rot * np.cos(r_lat) * np.sin(r_lon) * f,
            r_rot * np.sin(r_lat) * f)


def _unwrap_polygon(poly: np.ndarray) -> np.ndarray:
    """Unwrap longitudes so consecutive vertices never jump across the
    dateline (continuous curve).  Polygons that ring a pole (NA, AN:
    unwrapped ring ends 360° from its start) are closed over the pole cap
    so planar ray casting sees the polar interior."""
    lon = poly[:, 0].copy()
    d = np.diff(lon)
    shift = np.concatenate([[0.0], np.cumsum(np.where(
        d > 180.0, -360.0, np.where(d < -180.0, 360.0, 0.0)))])
    out = poly.copy()
    out[:, 0] = lon + shift
    if abs(out[-1, 0] - out[0, 0]) > 350.0:
        pole = 90.0 if out[:, 1].mean() > 0.0 else -90.0
        out = np.vstack([out, [out[-1, 0], pole], [out[0, 0], pole]])
    return out


def load_plate_model(boundaries_path: str, poles_path: str) -> PlateModel:
    polys = [(k, _unwrap_polygon(v))
             for k, v in read_plate_boundaries(boundaries_path)]
    poles = read_plate_poles(poles_path)
    rotations = {name: euler_to_cartesian_rates(*pole)
                 for name, pole in poles.items()}
    missing = {k for k, _ in polys} - set(rotations)
    if missing:
        raise ValueError(f"plates without pole parameters: {missing}")
    return PlateModel(polygons=polys, rotations=rotations)
