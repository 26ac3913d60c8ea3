"""Transverse Mercator (UTM) projection conversions.

Redfearn's series, as used for MGA (Map Grid of Australia) zones.

Parity reference: include/functions/dnatemplategeodesyfuncs.hpp
GeoToGrid :363, GridToGeo :434; projection constants from
include/parameters/dnadatumprojectionparam.hpp:54-60.
"""

from __future__ import annotations

import numpy as np

from ..params.ellipsoids import Ellipsoid, GRS80
from .conversions import prime_vertical, prime_meridian

FALSE_E = 500000.0
FALSE_N = 10000000.0
K0 = 0.9996
ZONE_WIDTH = 6.0            # degrees
LCM_ZONE1 = -177.0          # longitude of central meridian of zone 1
LWE_ZONE0 = -186.0          # longitude of western edge of zone 0
LCM_ZONE0 = -183.0


def geo_to_grid(lat, lon, e: Ellipsoid = GRS80, zone: int | None = None):
    """Geographic (radians) → (easting, northing, zone)."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if zone is None:
        zone = np.floor((np.degrees(lon) - LWE_ZONE0) / ZONE_WIDTH)
    cm = np.radians(zone * ZONE_WIDTH + LCM_ZONE0)
    w = lon - cm

    e2 = e.e1sq
    e4, e6 = e2 * e2, e2 * e2 * e2
    nu = prime_vertical(e, lat)
    rho = prime_meridian(e, lat)
    psi = nu / rho

    A0 = 1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256
    A2 = 3.0 / 8 * (e2 + e4 / 4 + 15 * e6 / 128)
    A4 = 15.0 / 256 * (e4 + 3 * e6 / 4)
    A6 = 35 * e6 / 3072
    m = e.a * (A0 * lat - A2 * np.sin(2 * lat) + A4 * np.sin(4 * lat) -
               A6 * np.sin(6 * lat))

    cl, sl = np.cos(lat), np.sin(lat)
    t = np.tan(lat)
    t2, t4, t6 = t * t, t ** 4, t ** 6

    # easting
    term1 = (w ** 2 / 6) * cl ** 2 * (psi - t2)
    term2 = (w ** 4 / 120) * cl ** 4 * (
        4 * psi ** 3 * (1 - 6 * t2) + psi ** 2 * (1 + 8 * t2) -
        psi * 2 * t2 + t4)
    term3 = (w ** 6 / 5040) * cl ** 6 * (61 - 479 * t2 + 179 * t4 - t4)
    E = K0 * nu * w * cl * (1 + term1 + term2 + term3) + FALSE_E

    # northing
    n1 = w ** 2 / 2 * nu * sl * cl
    n2 = w ** 4 / 24 * nu * sl * cl ** 3 * (4 * psi ** 2 + psi - t2)
    n3 = w ** 6 / 720 * nu * sl * cl ** 5 * (
        8 * psi ** 4 * (11 - 24 * t2) - 28 * psi ** 3 * (1 - 6 * t2) +
        psi ** 2 * (1 - 32 * t2) - psi * 2 * t2 + t4)
    n4 = w ** 8 / 40320 * nu * sl * cl ** 7 * (
        1385 - 3111 * t2 + 543 * t4 - t6)
    N = K0 * (m + n1 + n2 + n3 + n4) + FALSE_N
    return E, N, zone


def grid_to_geo(easting, northing, zone, e: Ellipsoid = GRS80):
    """(easting, northing, zone) → geographic (radians)."""
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)

    f = e.f
    a = e.a
    b = a * (1 - f)
    e2 = 2 * f - f * f
    n = (a - b) / (a + b)
    n2, n3, n4 = n * n, n ** 3, n ** 4
    G = a * (1 - n) * (1 - n2) * (1 + 9 * n2 / 4 + 225 * n4 / 64) * \
        (np.pi / 180.0)

    ep = easting - FALSE_E
    npr = northing - FALSE_N
    m = npr / K0
    sigma = m * np.pi / (180.0 * G)

    lat_p = (sigma +
             (3 * n / 2 - 27 * n3 / 32) * np.sin(2 * sigma) +
             (21 * n2 / 16 - 55 * n4 / 32) * np.sin(4 * sigma) +
             (151 * n3 / 96) * np.sin(6 * sigma) +
             (1097 * n4 / 512) * np.sin(8 * sigma))

    sp = np.sin(lat_p)
    rho = a * (1 - e2) / (1 - e2 * sp * sp) ** 1.5
    nu = a / np.sqrt(1 - e2 * sp * sp)
    psi = nu / rho
    t = np.tan(lat_p)
    t2, t4, t6 = t * t, t ** 4, t ** 6
    x = ep / (K0 * nu)
    num1 = t / (K0 * rho)

    term1 = num1 * x * ep / 2
    term2 = num1 * ep * x ** 3 / 24 * (
        -4 * psi ** 2 + 9 * psi * (1 - t2) + 12 * t2)
    term3 = num1 * ep * x ** 5 / 720 * (
        8 * psi ** 4 * (11 - 24 * t2) - 12 * psi ** 3 * (21 - 71 * t2) +
        15 * psi ** 2 * (15 - 98 * t2 + 15 * t4) +
        180 * psi * (5 * t2 - 3 * t4) + 360 * t4)
    term4 = num1 * ep * x ** 7 / 40320 * (
        1385 + 3633 * t2 + 4095 * t4 + 1575 * t6)
    lat = lat_p - term1 + term2 - term3 + term4

    cm = (zone * ZONE_WIDTH + LCM_ZONE1 - ZONE_WIDTH) * np.pi / 180.0
    sec = 1.0 / np.cos(lat_p)
    t1 = x * sec
    t2_ = x ** 3 / 6 * sec * (psi + 2 * t2)
    t3_ = x ** 5 / 120 * sec * (
        -4 * psi ** 3 * (1 - 6 * t2) + psi ** 2 * (9 - 68 * t2) +
        72 * psi * t2 + 24 * t4)
    t4_ = x ** 7 / 5040 * sec * (61 + 662 * t2 + 1320 * t4 + 720 * t6)
    lon = cm + t1 - t2_ + t3_ - t4_
    return lat, lon
