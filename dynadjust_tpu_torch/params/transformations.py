"""Helmert 14-parameter frame transformations and plate motion models.

Implements the reference-frame transformation engine: direct published
parameter lookup (forward or reversed), joining via ITRF2014 when no direct
set exists, epoch propagation of parameter rates, and the Australian plate
motion model.

Parity references (algorithm studied from, not copied):
  DynAdjust dynadjust/dynadjust/dnareftran/dnareftran.cpp
    (JoinTransformationParameters :720, DetermineElapsedTime :1279)
  DynAdjust dynadjust/include/functions/dnatemplatematrixfuncs.hpp
    (ReduceParameters :729, Transform_7parameter :785,
     FormHelmertRotationMatrix :694)
"""

from __future__ import annotations

import math
import numpy as np

from ._helmert_table import HELMERT_PARAMS
from .datums import Datum, decimal_year

_MAS_TO_RAD = math.pi / 180.0 / 3600.0 / 1000.0  # milli-arc-sec → radians

# Australian Plate Motion Model (ICSM GDA2020 Tech Manual): Euler rotation
# rates in mas/yr, equal to the ITRF2014→GDA2020 rotation rates.
AUS_PMM_ROTATION_RATES = (1.50379, 1.18346, 1.20716)


class TransformationError(ValueError):
    pass


def _lookup(frm: str, to: str):
    """Return (ref_epoch, params[14], sign) for frm→to.

    sign=+1 when published direction matches, −1 when the reverse set is
    used (parameters negated, per transformation_parameter_set::reverse()).
    """
    if (frm, to) in HELMERT_PARAMS:
        ep, p = HELMERT_PARAMS[(frm, to)]
        return ep, list(p), +1
    if (to, frm) in HELMERT_PARAMS:
        ep, p = HELMERT_PARAMS[(to, frm)]
        return ep, [-v for v in p], -1
    raise TransformationError(f"no direct parameters {frm} -> {to}")


def reduce_parameters(params14, elapsed_years: float, dynamic: bool = True):
    """Collapse a 14-parameter set to 7 at the given elapsed time.

    Returns [tx_m, ty_m, tz_m, scale(unitless), rx_rad, ry_rad, rz_rad].
    """
    p = params14
    r = [p[0] / 1000.0, p[1] / 1000.0, p[2] / 1000.0, p[3] / 1e9,
         p[4], p[5], p[6]]
    if dynamic:
        r[0] += p[7] / 1000.0 * elapsed_years
        r[1] += p[8] / 1000.0 * elapsed_years
        r[2] += p[9] / 1000.0 * elapsed_years
        r[3] += p[10] / 1e9 * elapsed_years
        r[4] += p[11] * elapsed_years
        r[5] += p[12] * elapsed_years
        r[6] += p[13] * elapsed_years
    # mas → radians
    r[4] *= _MAS_TO_RAD
    r[5] *= _MAS_TO_RAD
    r[6] *= _MAS_TO_RAD
    return r


def helmert_rotation_matrix(rx, ry, rz) -> np.ndarray:
    """Small-angle Helmert rotation matrix (coordinate-frame convention).

    Matches FormHelmertRotationMatrix (non-rigorous branch; the rigorous
    branch engages only for rotations > 10 arc-seconds which geodetic frame
    ties never reach).
    """
    if max(abs(rx), abs(ry), abs(rz)) > 10.0:  # values still in radians: huge
        cx, sx = math.cos(rx), math.sin(rx)
        cy, sy = math.cos(ry), math.sin(ry)
        cz, sz = math.cos(rz), math.sin(rz)
        return np.array([
            [cy * cz, cy * sz, -sy],
            [sx * sy * cz - cx * sz, sx * sy * sz + cx * cz, sx * cy],
            [cx * sy * cz + sx * sz, cx * sy * sz - sx * cz, cx * cy]])
    return np.array([
        [1.0, rz, -ry],
        [-rz, 1.0, rx],
        [ry, -rx, 1.0]])


def transform_7(xyz: np.ndarray, reduced7) -> np.ndarray:
    """Apply a reduced 7-parameter transformation to points (..., 3).

    x' = (1 + s) * R x + t   (element order follows TransformCartesian:
    rotate, then scale, then translate).
    """
    t = np.asarray(reduced7[:3])
    s = reduced7[3]
    R = helmert_rotation_matrix(reduced7[4], reduced7[5], reduced7[6])
    return (xyz @ R.T) * (1.0 + s) + t


def _elapsed_for(direction_fwd: bool, datum_from: Datum, datum_to: Datum,
                 ref_epoch: float) -> float:
    """Elapsed time Δt = t − t0 used to propagate parameter rates.

    For dynamic↔static: t is the epoch of the coordinates on the dynamic
    side (datum_from if published direction is forward, datum_to otherwise).
    For dynamic→dynamic: t is the 'from' epoch.
    Parity: DetermineElapsedTime, dnareftran.cpp:1279-1423.
    """
    if not datum_from.dynamic and not datum_to.dynamic:
        return 0.0
    if datum_from.dynamic and datum_to.dynamic:
        t = datum_from.epoch_decimal
    elif direction_fwd:
        # forward: epoch of the 'from' (data) coordinates
        t = datum_from.epoch_decimal
    else:
        t = datum_to.epoch_decimal
    if t is None:
        raise TransformationError(
            f"dynamic frame transformation {datum_from.frame}->"
            f"{datum_to.frame} requires an epoch")
    return t - ref_epoch


def reduced_parameters_between(datum_from: Datum, datum_to: Datum):
    """Compute reduced 7 parameters for datum_from→datum_to, joining via
    ITRF2014 when no direct set exists.  Returns the 7-list."""
    if datum_from.same_as(datum_to):
        return [0.0] * 7

    dynamic = datum_from.dynamic or datum_to.dynamic
    try:
        ref_epoch, p14, sign = _lookup(datum_from.frame, datum_to.frame)
        dt = _elapsed_for(sign > 0, datum_from, datum_to, ref_epoch)
        return reduce_parameters(p14, dt, dynamic)
    except TransformationError:
        pass

    # Join via ITRF2014 (reference: JoinTransformationParameters :720).
    # Step epoch: datumTo's epoch when going static→dynamic / dynamic→dynamic,
    # datumFrom's epoch when dynamic→static.
    if datum_from.dynamic and not datum_to.dynamic:
        step_epoch = datum_from.epoch
    else:
        step_epoch = datum_to.epoch or datum_from.epoch
    step = Datum("ITRF2014", step_epoch)

    def leg(d_from, d_to):
        ref_epoch, p14, sign = _lookup(d_from.frame, d_to.frame)
        dyn = d_from.dynamic or d_to.dynamic
        # For step legs the elapsed time always uses the dynamic data epoch
        if dyn:
            t = (d_from.epoch_decimal if d_from.dynamic else None)
            if t is None:
                t = d_to.epoch_decimal if d_to.dynamic else None
            if t is None:
                raise TransformationError("step leg missing epoch")
            dt = t - ref_epoch
        else:
            dt = 0.0
        return reduce_parameters(p14, dt, dyn)

    r1 = leg(datum_from, step)
    r2 = leg(step, datum_to)
    return [a + b for a, b in zip(r1, r2)]


def transform_points(xyz: np.ndarray, datum_from: Datum,
                     datum_to: Datum) -> np.ndarray:
    """Transform cartesian points (..., 3) from datum_from to datum_to."""
    r7 = reduced_parameters_between(datum_from, datum_to)
    return transform_7(np.asarray(xyz, dtype=np.float64), r7)


def plate_motion_reduced(epoch_from, epoch_to,
                         rates_mas_yr=AUS_PMM_ROTATION_RATES):
    """Reduced parameters for a plate-motion epoch propagation on ITRF."""
    dt = decimal_year(epoch_from) - decimal_year(epoch_to)
    p14 = [0.0] * 11 + list(rates_mas_yr)
    return reduce_parameters(p14, dt, True)
