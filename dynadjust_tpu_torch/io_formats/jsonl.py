"""DynAdjust JSONL station/measurement reader (the DynaML JSON mirror).

Format reference: the reference's dnaparser_jsonl.cpp and the sample files
gnss-networkstn.jsonl / gnss-networkmsr.jsonl (one JSON object per line:
a DnaXmlFormat header then DnaStation / DnaMeasurement records with the
same element vocabulary as DynaML.xsd).
"""

from __future__ import annotations

import json

import numpy as np

from .dna import (
    Station, Measurement, GpsCluster, GpsObs, DirectionSet, ANGULAR_TYPES,
)
from ..geodesy.conversions import dms_to_rad

_SEC_TO_RAD = np.pi / 180.0 / 3600.0


def _f(d, key, default=0.0):
    v = d.get(key, default)
    if v in ("", None):
        return default
    return float(v)


def read_jsonl(path: str):
    """Returns (stations, measurements, frame, epoch)."""
    frame, epoch = "GDA2020", "01.01.2020"
    stations, measurements = [], []
    cluster_id = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "DnaXmlFormat" in obj:
                hdr = obj["DnaXmlFormat"]
                frame = hdr.get("referenceframe", frame)
                epoch = hdr.get("epoch", epoch)
            elif "DnaStation" in obj:
                s = obj["DnaStation"]
                c = s.get("StationCoord", {})
                stations.append(Station(
                    name=str(s.get("Name", "")),
                    constraints=s.get("Constraints", "FFF"),
                    coord_type=s.get("Type", "LLH"),
                    p1=_f(c, "XAxis"), p2=_f(c, "YAxis"),
                    p3=_f(c, "Height"),
                    hemi_zone=str(c.get("HemisphereZone", "")),
                    description=str(s.get("Description", ""))))
            elif "DnaMeasurement" in obj:
                cluster_id += 1
                rec = _parse_measurement(obj["DnaMeasurement"], frame,
                                         epoch, cluster_id)
                if rec is not None:
                    measurements.append(rec)
    return stations, measurements, frame, epoch


def _vcv_from(d):
    V = np.zeros((3, 3))
    V[0, 0] = _f(d, "SigmaXX")
    V[0, 1] = V[1, 0] = _f(d, "SigmaXY")
    V[0, 2] = V[2, 0] = _f(d, "SigmaXZ")
    V[1, 1] = _f(d, "SigmaYY")
    V[1, 2] = V[2, 1] = _f(d, "SigmaYZ")
    V[2, 2] = _f(d, "SigmaZZ")
    return V


def _cov_from(d):
    return np.array([
        [_f(d, "m11"), _f(d, "m12"), _f(d, "m13")],
        [_f(d, "m21"), _f(d, "m22"), _f(d, "m23")],
        [_f(d, "m31"), _f(d, "m32"), _f(d, "m33")]])


def _aslist(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _parse_measurement(d, frame, epoch, cluster_id):
    mtype = str(d.get("Type", "")).upper()
    ignore = str(d.get("Ignore", "")).strip() != ""
    m_frame = d.get("ReferenceFrame", frame) or frame
    m_epoch = d.get("Epoch", epoch) or epoch
    obs_epoch = str(d.get("EpochOfObservation", "") or "")

    def _id(obj, key="MeasurementID"):
        v = str(obj.get(key, "") or "")
        try:
            return int(v) if v else None
        except ValueError:
            return None

    if mtype in ("G", "X", "Y"):
        coord_type = d.get("Coords", "XYZ") or "XYZ"
        cl = GpsCluster(
            mtype=mtype, ignore=ignore, coord_type=coord_type,
            vscale=_f(d, "Vscale", 1.0) or 1.0,
            pscale=_f(d, "Pscale", 1.0) or 1.0,
            lscale=_f(d, "Lscale", 1.0) or 1.0,
            hscale=_f(d, "Hscale", 1.0) or 1.0,
            epsg_frame=m_frame, epoch=m_epoch, cluster_id=cluster_id,
            obs_epoch=obs_epoch)
        cl.db_cluster_id = _id(d, "ClusterID")
        top_id = _id(d)
        first = str(d.get("First", ""))
        second = str(d.get("Second", ""))
        key = "GPSBaseline" if mtype in ("G", "X") else "Clusterpoint"
        cov_key = "GPSCovariance" if mtype in ("G", "X") else \
            "PointCovariance"
        geographic = coord_type.upper().startswith("LL")
        for ob_d in _aslist(d.get(key)):
            vec = np.array([_f(ob_d, "X"), _f(ob_d, "Y"), _f(ob_d, "Z")])
            if mtype == "Y" and geographic:
                vec = np.array([float(dms_to_rad(vec[0])),
                                float(dms_to_rad(vec[1])), vec[2]])
            # every cluster entry names its own stations (point "Name",
            # baseline "First"/"Second"); the header First/Second only
            # covers the first entry
            ob_first = str(ob_d.get("Name") or ob_d.get("First") or first)
            ob_second = str(ob_d.get("Second") or second)
            ob = GpsObs(first=ob_first,
                        second=ob_second if mtype != "Y" else "",
                        vec=vec, vcv=_vcv_from(ob_d),
                        msr_id=(_id(ob_d) if _id(ob_d) is not None
                                else top_id))
            for cov_d in _aslist(ob_d.get(cov_key)):
                ob.covs.append(_cov_from(cov_d))
            cl.obs.append(ob)
        return cl

    if mtype == "D":
        ds = DirectionSet(
            ignore=ignore, first=str(d.get("First", "")),
            ro=str(d.get("Second", "")),
            ro_value=float(dms_to_rad(_f(d, "Value"))),
            ro_sd=_f(d, "StdDev") * _SEC_TO_RAD, epoch=m_epoch,
            obs_epoch=obs_epoch)
        ds.msr_id = _id(d)
        ds.db_cluster_id = _id(d, "ClusterID")
        dir_ids = []
        for dd in _aslist(d.get("Directions")):
            ds.directions.append((
                str(dd.get("Target", "")),
                float(dms_to_rad(_f(dd, "Value"))),
                _f(dd, "StdDev") * _SEC_TO_RAD,
                str(dd.get("Ignore", "")).strip() != ""))
            dir_ids.append(_id(dd))
        if any(i is not None for i in dir_ids):
            ds.direction_ids = dir_ids
        return ds

    m = Measurement(mtype=mtype, ignore=ignore,
                    first=str(d.get("First", "")),
                    second=str(d.get("Second", "")),
                    third=str(d.get("Third", "")), epoch=m_epoch,
                    obs_epoch=obs_epoch)
    if mtype in ANGULAR_TYPES:
        m.value = float(dms_to_rad(_f(d, "Value")))
        m.sd = _f(d, "StdDev") * _SEC_TO_RAD
    else:
        m.value = _f(d, "Value")
        m.sd = _f(d, "StdDev")
    m.inst_height = _f(d, "InstHeight")
    m.targ_height = _f(d, "TargHeight")
    m.msr_id = _id(d)
    return m
