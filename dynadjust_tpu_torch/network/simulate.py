"""Measurement simulation: replace observation values with values computed
from the current station coordinates (zero-residual network) and assign
nominal standard deviations.

Used to fabricate test networks and to validate a measurement plan before
observing.  Parity reference: dna_import::SimulateMSR
(dnaimport/dnainterop.cpp) and the per-type CDna*::SimulateMsr methods
(include/measurement_types/dna{distance,direction,directionset,height,
heightdifference,coordinate,gpsbaseline,gpspoint}.cpp) — including the
nominal sigmas (0.01″ angles, 0.021″ coordinates, 3·√km cm distances,
24 mm heights, canned GNSS VCVs) and reverse-applied deflection
corrections so that adjusting the simulated file reproduces the input
coordinates exactly.
"""

from __future__ import annotations

import numpy as np

from ..geodesy import measurements as gm
from ..geodesy.conversions import geo_to_cart, cart_to_geo
from ..io_formats.dna import DirectionSet, GpsCluster, Measurement
from .data import NetworkData

_SEC_TO_RAD = np.pi / 180.0 / 3600.0
_E4_SEC_DEFLECTION = 1.0e-4 * _SEC_TO_RAD

# nominal GNSS VCVs (upper triangle XX XY XZ YY YZ ZZ)
_GPS_BASELINE_VCV = np.array([
    [4.022e-05, -1.369e-05, 3.975e-05],
    [-1.369e-05, 1.487e-05, -2.035e-05],
    [3.975e-05, -2.035e-05, 6.803e-05]])
_GPS_POINT_VCV_XYZ = np.array([
    [4.022e-04, -1.369e-04, 3.975e-04],
    [-1.369e-04, 1.487e-04, -2.035e-04],
    [3.975e-04, -2.035e-04, 6.803e-04]])
_GPS_POINT_VCV_LLH = np.array([
    [9.402e-09, 5.876e-10, 5.876e-10],
    [5.876e-10, 9.402e-09, 5.876e-10],
    [5.876e-10, 5.876e-10, 2.500e-01]])

_SIM_EPOCH = "01.10.1985"


def _dist_sd(value: float) -> float:
    return 3.0 * np.sqrt(abs(value) / 1000.0) / 100.0


def simulate_measurements(net: NetworkData) -> int:
    """Overwrite every measurement's value/sd with simulated quantities
    computed from the network's current coordinates.  Returns the number
    of measurement records simulated."""
    ell = net.datum.ellipsoid
    X, Y, Z = geo_to_cart(net.lat, net.lon, net.height, ell)
    lat, lon = net.lat, net.lon
    gs = net.geoid_sep
    vdef, mdef = net.vertical_def, net.meridian_def

    def has_defl(s):
        return (abs(vdef[s]) > _E4_SEC_DEFLECTION or
                abs(mdef[s]) > _E4_SEC_DEFLECTION)

    def p(s):
        return X[s], Y[s], Z[s]

    count = 0
    for rec in net.measurements:
        count += 1
        if isinstance(rec, GpsCluster):
            _simulate_gps(net, rec, X, Y, Z, ell)
            continue
        if isinstance(rec, DirectionSet):
            s1 = net.station_index(rec.first)
            s2 = net.station_index(rec.ro)
            rec.ro_value = _sim_direction(net, s1, s2, X, Y, Z, has_defl)
            rec.ro_sd = 0.010 * _SEC_TO_RAD
            dirs = []
            for (tgt, _v, _sd, ign) in rec.directions:
                st = net.station_index(tgt)
                dirs.append((tgt, _sim_direction(net, s1, st, X, Y, Z,
                                                 has_defl),
                             0.010 * _SEC_TO_RAD, ign))
            rec.directions = dirs
            rec.epoch = _SIM_EPOCH
            continue
        if not isinstance(rec, Measurement):
            continue

        t = rec.mtype
        s1 = net.station_index(rec.first)
        s2 = net.station_index(rec.second) if rec.second else -1
        s3 = net.station_index(rec.third) if rec.third else -1

        if t == "A":
            comp, d12, d13, *_ = gm.horizontal_angle(
                *p(s1), *p(s2), *p(s3), lat[s1], lon[s1])
            if has_defl(s1):
                zen12 = gm.zenith_distance(*p(s1), *p(s2), lat[s1], lon[s1],
                                           lat[s2], lon[s2], 0.0, 0.0)[0]
                zen13 = gm.zenith_distance(*p(s1), *p(s3), lat[s1], lon[s1],
                                           lat[s3], lon[s3], 0.0, 0.0)[0]
                comp += gm.hz_angle_deflection_correction(
                    d12, zen12, d13, zen13, vdef[s1], mdef[s1])
            rec.value = float(comp) % (2.0 * np.pi)
            rec.sd = 0.01 * _SEC_TO_RAD
        elif t in ("B", "K"):
            comp, *_ = gm.direction(*p(s1), *p(s2), lat[s1], lon[s1])
            if t == "K" and has_defl(s1):
                zen = gm.zenith_distance(*p(s1), *p(s2), lat[s1], lon[s1],
                                         lat[s2], lon[s2], 0.0, 0.0)[0]
                comp += gm.laplace_correction(comp, zen, vdef[s1],
                                              mdef[s1], lat[s1])
            rec.value = float(comp) % (2.0 * np.pi)
            rec.sd = 0.010 * _SEC_TO_RAD
        elif t == "S":
            rec.inst_height = rec.targ_height = 0.0
            comp = gm.slope_distance(*p(s1), *p(s2), lat[s1], lon[s1],
                                     0.0, 0.0)[0]
            rec.value = float(comp)
            rec.sd = _dist_sd(rec.value)
        elif t == "C":
            comp = gm.ellipsoid_chord_distance(
                *p(s1), *p(s2), lat[s1], lat[s2],
                net.height[s1], net.height[s2], ell)[0]
            rec.value = float(comp)
            rec.sd = _dist_sd(rec.value)
        elif t == "E":
            chord = gm.ellipsoid_chord_distance(
                *p(s1), *p(s2), lat[s1], lat[s2],
                net.height[s1], net.height[s2], ell)[0]
            comp = gm.ellipsoid_chord_to_arc(
                chord, *p(s1), *p(s2), lat[s1], lon[s1], lat[s2], ell)
            rec.value = float(comp)
            rec.sd = _dist_sd(rec.value)
        elif t == "M":
            chord = gm.ellipsoid_chord_distance(
                *p(s1), *p(s2), lat[s1], lat[s2],
                net.height[s1], net.height[s2], ell)[0]
            comp = gm.ellipsoid_chord_to_msl_arc(
                chord, lat[s1], lat[s2], gs[s1], gs[s2], ell)
            rec.value = float(comp)
            rec.sd = _dist_sd(rec.value)
        elif t in ("V", "Z"):
            rec.inst_height, rec.targ_height = 1.650, 1.651
            fn = gm.zenith_distance if t == "V" else gm.vertical_angle
            comp = fn(*p(s1), *p(s2), lat[s1], lon[s1], lat[s2], lon[s2],
                      1.650, 1.651)[0]
            if has_defl(s1):
                az = gm.direction(*p(s1), *p(s2), lat[s1], lon[s1])[0]
                corr = gm.zenith_deflection_correction(az, vdef[s1],
                                                       mdef[s1])
                comp = comp - corr if t == "V" else comp + corr
            rec.value = float(comp)
            rec.sd = 0.010 * _SEC_TO_RAD
        elif t in ("H", "R"):
            comp = net.height[s1]
            if t == "H" and abs(gs[s1]) > 1e-4:
                comp = comp - gs[s1]
            rec.value = float(comp)
            rec.sd = 0.024
        elif t == "L":
            comp = net.height[s2] - net.height[s1]
            if abs(gs[s1]) > 1e-4 or abs(gs[s2]) > 1e-4:
                comp -= gs[s2] - gs[s1]
            dist = gm.slope_distance(*p(s1), *p(s2), lat[s1], lon[s1],
                                     0.0, 0.0)[0]
            rec.value = float(comp)
            rec.sd = _dist_sd(dist)
        elif t in ("P", "I"):
            comp = lat[s1]
            if t == "I" and abs(mdef[s1]) > _E4_SEC_DEFLECTION:
                comp = lat[s1] + mdef[s1]
            rec.value = float(comp)
            rec.sd = 0.021 * _SEC_TO_RAD
        elif t in ("Q", "J"):
            comp = lon[s1]
            if t == "J" and abs(vdef[s1]) > _E4_SEC_DEFLECTION:
                comp = lon[s1] + vdef[s1] / np.cos(lat[s1])
            rec.value = float(comp)
            rec.sd = 0.021 * _SEC_TO_RAD
        else:
            count -= 1
            continue
        rec.epoch = _SIM_EPOCH
    return count


def _sim_direction(net, s1, s2, X, Y, Z, has_defl):
    comp, *_ = gm.direction(X[s1], Y[s1], Z[s1], X[s2], Y[s2], Z[s2],
                            net.lat[s1], net.lon[s1])
    if has_defl(s1):
        zen = gm.zenith_distance(X[s1], Y[s1], Z[s1], X[s2], Y[s2], Z[s2],
                                 net.lat[s1], net.lon[s1],
                                 net.lat[s2], net.lon[s2], 0.0, 0.0)[0]
        comp += gm.direction_deflection_correction(
            comp, zen, net.vertical_def[s1], net.meridian_def[s1])
    return float(comp) % (2.0 * np.pi)


def _simulate_gps(net: NetworkData, rec: GpsCluster, X, Y, Z, ell):
    geographic = (rec.mtype == "Y" and
                  rec.coord_type.upper().startswith("LL"))
    for ob in rec.obs:
        s1 = net.station_index(ob.first)
        if rec.mtype in ("G", "X"):
            s2 = net.station_index(ob.second)
            ob.vec = np.array([X[s2] - X[s1], Y[s2] - Y[s1], Z[s2] - Z[s1]])
            ob.vcv = _GPS_BASELINE_VCV.copy()
        else:
            if geographic:
                h = net.height[s1]
                if abs(net.geoid_sep[s1]) > 1e-4 and \
                        rec.coord_type.upper() == "LLH":
                    h = h - net.geoid_sep[s1]
                ob.vec = np.array([net.lat[s1], net.lon[s1], h])
                ob.vcv = _GPS_POINT_VCV_LLH.copy()
            else:
                ob.vec = np.array([X[s1], Y[s1], Z[s1]])
                ob.vcv = _GPS_POINT_VCV_XYZ.copy()
        ob.covs = [np.zeros((3, 3)) for _ in ob.covs]
