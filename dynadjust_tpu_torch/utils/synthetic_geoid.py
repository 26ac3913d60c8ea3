"""Seeded NTv2 geoid grids for runs without a published geoid model.

The N value is a smooth field (a few sinusoids of several degrees'
wavelength with seeded phases) scaled into [n_lo, n_hi] metres over the
grid; the deflections of the vertical are its gradient, ξ = -∂N/∂φ / R
and η = -∂N/(R cos φ ∂λ), scaled so that the largest is max_defl_sec
seconds.  Node values are float32, as in a .gsb file.
"""

from __future__ import annotations

import numpy as np

from ..io_formats.ntv2 import NTv2Grid, SubGrid

_R = 6371000.0
_RAD_TO_SEC = 180.0 / np.pi * 3600.0


class _Field:
    """N(φ, λ) = Σ a_k sin(u_k φ + v_k λ + p_k) and its gradient."""

    def __init__(self, seed: int, terms: int = 4):
        rng = np.random.default_rng(seed)
        wave = np.radians(rng.uniform(4.0, 12.0, terms))   # wavelengths
        ang = rng.uniform(0.0, np.pi, terms)
        self.u = 2 * np.pi / wave * np.cos(ang)
        self.v = 2 * np.pi / wave * np.sin(ang)
        self.a = rng.uniform(0.5, 1.0, terms)
        self.p = rng.uniform(0.0, 2 * np.pi, terms)

    def __call__(self, lat, lon):
        arg = (self.u[:, None] * lat.ravel() + self.v[:, None] * lon.ravel()
               + self.p[:, None])
        f = (self.a[:, None] * np.sin(arg)).sum(0)
        c = self.a[:, None] * np.cos(arg)
        dlat = (c * self.u[:, None]).sum(0)
        dlon = (c * self.v[:, None]).sum(0)
        return (f.reshape(lat.shape), dlat.reshape(lat.shape),
                dlon.reshape(lat.shape))


def _nodes(s_lat, n_lat, w_lon, e_lon, inc_sec):
    """Node latitudes/longitudes (radians, (rows, cols)) of a sub-grid in
    NTv2 order: rows from the south, columns from the east."""
    rows = int(round((n_lat - s_lat) * 3600.0 / inc_sec)) + 1
    cols = int(round((e_lon - w_lon) * 3600.0 / inc_sec)) + 1
    lat = np.radians(s_lat + np.arange(rows) * inc_sec / 3600.0)
    lon = np.radians(e_lon - np.arange(cols) * inc_sec / 3600.0)
    return np.meshgrid(lat, lon, indexing="ij")


def _subgrid(name, parent, s_lat, n_lat, w_lon, e_lon, inc_sec):
    return SubGrid(name=name, parent=parent, s_lat=s_lat * 3600.0,
                   n_lat=n_lat * 3600.0, e_long=-e_lon * 3600.0,
                   w_long=-w_lon * 3600.0, lat_inc=float(inc_sec),
                   long_inc=float(inc_sec))


def synthetic_geoid_grid(s_lat: float, n_lat: float, w_lon: float,
                         e_lon: float, inc_sec: float = 60.0, seed: int = 0,
                         n_lo: float = 3.0, n_hi: float = 7.0,
                         max_defl_sec: float = 1.5, child=None) -> NTv2Grid:
    """An NTv2 grid over [s_lat, n_lat] x [w_lon, e_lon] (degrees, east
    positive) at inc_sec seconds.  child=(s_lat, n_lat, w_lon, e_lon,
    inc_sec) adds a denser sub-grid of the same field under the parent."""
    field = _Field(seed)
    lat, lon = _nodes(s_lat, n_lat, w_lon, e_lon, inc_sec)
    f, _, _ = field(lat, lon)
    f_lo, f_hi = float(f.min()), float(f.max())
    n_scale = (n_hi - n_lo) / (f_hi - f_lo)

    def values(lat, lon):
        f, dlat, dlon = field(lat, lon)
        xi = -n_scale * dlat / _R * _RAD_TO_SEC
        eta = -n_scale * dlon / (_R * np.cos(lat)) * _RAD_TO_SEC
        return n_lo + n_scale * (f - f_lo), xi, eta

    n, xi, eta = values(lat, lon)
    d_scale = min(1.0, max_defl_sec / max(np.abs(xi).max(),
                                          np.abs(eta).max()))
    grids = [("PARENT", "NONE", (s_lat, n_lat, w_lon, e_lon, inc_sec))]
    if child is not None:
        grids.append(("CHILD", "PARENT", tuple(child)))
    subgrids = []
    for name, parent, box in grids:
        sg = _subgrid(name, parent, *box)
        la, lo = _nodes(*box)
        n, xi, eta = values(la, lo)
        sg.values = np.stack([n, d_scale * xi, d_scale * eta,
                              np.full_like(n, 0.05)], axis=-1).astype(
                                  np.float32)
        assert sg.values.shape[:2] == (sg.nrows, sg.ncols)
        subgrids.append(sg)
    return NTv2Grid(gs_type="SECONDS ", version="1.0.0.0",
                    system_from="GDA2020", system_to="AHD_1971",
                    ellipsoid_from=(6378137.0, 6356752.314),
                    ellipsoid_to=(6378137.0, 6356752.314),
                    subgrids=subgrids)


def orthometric_levelling(net, grid: NTv2Grid, method: str = "bicubic") -> int:
    """Make a synthetic network's level differences (L) orthometric.

    synthetic_mixed_network simulates L as differences of ellipsoidal
    heights, which is right only where N = 0.  Levelling measures
    orthometric differences ΔH = Δh − ΔN, so each L value gets the grid's
    −ΔN between its stations (interpolated as apply_geoid does, float32
    N).  Returns the number of records changed."""
    n_at = {}

    def n_value(name):
        if name not in n_at:
            i = net.station_index(name)
            vals = grid.interpolate(net.lat[i], net.lon[i], method)
            n_at[name] = float(np.float32(vals[0]))
        return n_at[name]

    count = 0
    for rec in net.measurements:
        if getattr(rec, "mtype", "") == "L":
            rec.value -= n_value(rec.second) - n_value(rec.first)
            count += 1
    return count
