"""Geoid interpolation stage: populate N values and deflections of the
vertical on a network from an NTv2 grid, optionally converting orthometric
heights to ellipsoidal.

Parity reference: dna_geoid_interpolation::PopulateStationRecords,
DynAdjust dynadjust/dynadjust/dnageoid/dnageoid.cpp:119-180
(geoidSep stored as float32; currentHeight = initialHeight + geoidSep only
for orthometric-supplied heights).
"""

from __future__ import annotations

import numpy as np

from ..io_formats.ntv2 import NTv2Grid
from ..network.data import NetworkData, ORTHOMETRIC

_RAD_TO_SEC = 180.0 / np.pi * 3600.0


def apply_geoid(net: NetworkData, grid: NTv2Grid, convert_heights: bool = True,
                method: str = "bicubic") -> int:
    """Interpolate geoid values for every station.  Returns the number of
    stations interpolated; stations outside the grid are left untouched."""
    count = 0
    for i in range(net.nstations):
        vals = grid.interpolate(net.lat[i], net.lon[i], method)
        if vals is None:
            continue
        n_value = float(np.float32(vals[0]))
        net.geoid_sep[i] = n_value
        net.meridian_def[i] = float(np.float32(vals[1])) / _RAD_TO_SEC
        net.vertical_def[i] = float(np.float32(vals[2])) / _RAD_TO_SEC
        if net.height_ref[i] == ORTHOMETRIC:
            # net.height is ALWAYS ellipsoidal once N is known: the
            # reference adds geoidSep on the fly wherever the supplied
            # height type is orthometric (e.g. PrintAdjStation,
            # dnaadjust_printer.cpp:3938), so --convert-stn-hts only
            # changes the stored/exported height type, not the adjustment
            net.height[i] = net.initial_height[i] + n_value
            if convert_heights:
                net.height_ref[i] = 0          # now stored ellipsoidal
        count += 1
    net.geoid_applied = True
    return count


def interpolate_points(grid: NTv2Grid, lats_rad, lons_rad,
                       method: str = "bicubic"):
    """Free-point interpolation (the geoid tool's file/point modes)."""
    out = np.full((len(lats_rad), 4), np.nan)
    for i, (la, lo) in enumerate(zip(lats_rad, lons_rad)):
        vals = grid.interpolate(la, lo, method)
        if vals is not None:
            out[i] = vals
    return out
