"""Reference frame transformation stage (reftran).

Transforms station coordinates and frame-bound measurements (GPS baselines,
baseline clusters, point clusters) to the project datum via Helmert
14-parameter sets (joined through ITRF2014 when needed) or plate motion
models.

Parity reference: DynAdjust dynadjust/dynadjust/dnareftran/
dnareftran.cpp — TransformStationRecords :1451, TransformMeasurementRecords
:1611, TransformMeasurement_GX :1740 (the baseline is transformed by
transforming both endpoints and differencing; VCVs are not transformed),
TransformMeasurement_Y :1827.
"""

from __future__ import annotations

import numpy as np

from ..geodesy.conversions import geo_to_cart, cart_to_geo
from ..io_formats.dna import GpsCluster
from ..network.data import NetworkData
from ..params.datums import Datum
from ..params.substitutions import substitute_frame
from ..params.transformations import (
    reduced_parameters_between, transform_7, plate_motion_reduced,
    AUS_PMM_ROTATION_RATES, TransformationError,
)


def _resolve_datum(frame: str, epoch: str) -> Datum:
    """Datum for a measurement/station frame, applying WGS84-ensemble
    substitutions (reference: ApplyToFrameSubstitution /
    REFTRAN_WGS84 handling)."""
    return Datum.from_name(substitute_frame(frame, epoch), epoch)


def _needs_pmm(datum_from: Datum, datum_to: Datum) -> bool:
    """Dynamic→dynamic with differing epochs requires the 3-step
    ITRF2014 + plate-motion-model path (reference: Transform routing,
    dnareftran.cpp:1195-1256 case __dynamic_to_dynamic__ b/c)."""
    if not (datum_from.dynamic and datum_to.dynamic):
        return False
    ef, et = datum_from.epoch_decimal, datum_to.epoch_decimal
    return ef is not None and et is not None and abs(ef - et) > 1e-9


def _transform_xyz(xyz, datum_from: Datum, datum_to: Datum,
                   plates=None, plate_model=None):
    """Transform cartesian points (n, 3); when the epoch changes between
    dynamic frames, route via ITRF2014 + PMM
    (TransformFrames_PlateMotionModel, dnareftran.cpp:970):
      1. Helmert datum_from → ITRF2014 @ epoch_from
      2. PMM epoch_from → epoch_to (per-station plate, or the Australian
         PMM when no plate model is loaded — plate_model_option 0)
      3. Helmert ITRF2014 @ epoch_to → datum_to
    plates: per-point plate ids (aligned with xyz rows) or None."""
    xyz = np.asarray(xyz, dtype=np.float64)
    if not _needs_pmm(datum_from, datum_to):
        return transform_7(xyz, reduced_parameters_between(
            datum_from, datum_to))

    step1 = Datum("ITRF2014", datum_from.epoch)
    step2 = Datum("ITRF2014", datum_to.epoch)
    if datum_from.frame != "ITRF2014":
        xyz = transform_7(xyz, reduced_parameters_between(datum_from, step1))
    if plate_model is None or plates is None:
        xyz = transform_7(xyz, plate_motion_reduced(
            datum_from.epoch, datum_to.epoch, AUS_PMM_ROTATION_RATES))
    else:
        out = np.array(xyz, copy=True)
        for plate in set(plates):
            rates = (plate_model.rotation_rates(plate) if plate
                     else None) or AUS_PMM_ROTATION_RATES
            sel = np.asarray([p == plate for p in plates])
            out[sel] = transform_7(xyz[sel], plate_motion_reduced(
                datum_from.epoch, datum_to.epoch, rates))
        xyz = out
    if datum_to.frame != "ITRF2014":
        xyz = transform_7(xyz, reduced_parameters_between(step2, datum_to))
    return xyz


def station_plates(net: NetworkData, plate_model) -> list:
    """Per-station plate ids (reference: IdentifyStationPlate,
    dnareftran.cpp:103 — boost::geometry::within over the digitised
    boundaries)."""
    return [plate_model.identify(net.lat[i], net.lon[i])
            for i in range(net.nstations)]


def transform_network(net: NetworkData, frame: str | None = None,
                      epoch: str = "", plate_model=None) -> dict:
    """Transform all stations and measurements to (frame, epoch); defaults
    to the network's project datum.  plate_model: optional PlateModel for
    per-station plate motion (reference --plate-model-option 1; without it
    the Australian PMM applies to epoch changes).  Returns a stats dict."""
    datum_to = (Datum.from_name(frame, epoch) if frame
                else net.datum)

    stats = {"stations": 0, "stations_skipped": 0,
             "measurements": 0, "measurements_skipped": 0}

    plates = (station_plates(net, plate_model)
              if plate_model is not None else None)

    # --- stations --------------------------------------------------------
    # Stations carry their source frame when imported from SINEX
    # (net.station_frames); transform each (frame, epoch) group.  Parity:
    # per-station epsgCode/epoch in station_t, TransformStationRecords
    # :1451.
    if net.station_frames is not None:
        groups: dict = {}
        for i in range(net.nstations):
            key = (net.station_frames[i] or net.frame,
                   net.station_epochs[i] or net.epoch)
            groups.setdefault(key, []).append(i)
    else:
        groups = {(net.frame, net.epoch): list(range(net.nstations))}

    for (gframe, gepoch), idx in groups.items():
        datum_from = _resolve_datum(gframe, gepoch)
        if datum_from.same_as(datum_to):
            stats["stations_skipped"] += len(idx)
            continue
        idx = np.asarray(idx)
        x, y, z = geo_to_cart(net.lat[idx], net.lon[idx], net.height[idx],
                              datum_from.ellipsoid)
        xyz = np.stack([x, y, z], axis=-1)
        gplates = [plates[i] for i in idx] if plates is not None else None
        xyz = _transform_xyz(xyz, datum_from, datum_to, gplates,
                             plate_model)
        la, lo, h = cart_to_geo(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                datum_to.ellipsoid)
        net.lat[idx], net.lon[idx], net.height[idx] = la, lo, h
        stats["stations"] += len(idx)
    if net.station_frames is not None:
        net.station_frames = [datum_to.frame] * net.nstations
        net.station_epochs = [epoch or net.epoch] * net.nstations

    # --- measurements ----------------------------------------------------
    for rec in net.measurements:
        if not isinstance(rec, GpsCluster):
            continue    # local-frame measurements are not frame-bound
        datum_m = _resolve_datum(rec.epsg_frame, rec.epoch)
        if datum_m.same_as(datum_to):
            stats["measurements_skipped"] += 1
            continue
        if rec.mtype in ("G", "X"):
            _transform_baselines(net, rec, datum_m, datum_to,
                                 plates, plate_model)
        else:
            _transform_points(net, rec, datum_m, datum_to,
                              plates, plate_model)
        rec.epsg_frame = datum_to.frame
        rec.epoch = epoch or net.epoch
        stats["measurements"] += 1

    net.reftran_applied = True
    net.datum = datum_to
    net.frame = datum_to.frame
    return stats


def _transform_baselines(net: NetworkData, rec: GpsCluster,
                         datum_from: Datum, datum_to: Datum,
                         plates=None, plate_model=None):
    """Transform G/X baselines: endpoint coordinates are transformed and the
    baseline re-differenced (vector transformation; VCV unchanged)."""
    ell = datum_from.ellipsoid
    for obs in rec.obs:
        i1 = net.station_index(obs.first)
        x1 = np.array(geo_to_cart(net.lat[i1], net.lon[i1], net.height[i1],
                                  ell))
        ends = np.stack([x1, x1 + obs.vec])
        p = [plates[i1], plates[i1]] if plates is not None else None
        endsm = _transform_xyz(ends, datum_from, datum_to, p, plate_model)
        obs.vec = endsm[1] - endsm[0]


def _transform_points(net: NetworkData, rec: GpsCluster,
                      datum_from: Datum, datum_to: Datum,
                      plates=None, plate_model=None):
    ell_from = datum_from.ellipsoid
    ell_to = datum_to.ellipsoid
    geographic = rec.coord_type.upper().startswith("LL")
    for obs in rec.obs:
        if geographic:
            xyz = np.array(geo_to_cart(obs.vec[0], obs.vec[1], obs.vec[2],
                                       ell_from))
        else:
            xyz = obs.vec
        i1 = net.station_index(obs.first)
        p = [plates[i1]] if plates is not None else None
        xyzm = _transform_xyz(xyz[None, :], datum_from, datum_to,
                              p, plate_model)[0]
        if geographic:
            la, lo, h = cart_to_geo(*xyzm, ell_to)
            obs.vec = np.array([float(la), float(lo), float(h)])
        else:
            obs.vec = np.asarray(xyzm)
