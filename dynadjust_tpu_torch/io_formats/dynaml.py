"""DynaML (XML) station/measurement reader and writer.

Schema reference: DynAdjust sampleData/DynaML.xsd; parsing semantics
from dnaimport's generated SAX parsers (dnaparser_pimpl.cxx).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from .dna import (
    Station, Measurement, GpsCluster, GpsObs, DirectionSet,
    ANGULAR_TYPES, LINEAR_TYPES,
)
from ..geodesy.conversions import dms_to_rad

_SEC_TO_RAD = np.pi / 180.0 / 3600.0


def _txt(el, tag, default=""):
    c = el.find(tag)
    return (c.text or "").strip() if c is not None and c.text else default


def _num(el, tag, default=0.0):
    t = _txt(el, tag)
    return float(t) if t else default


# ---------------------------------------------------------------------------
# XSD-equivalent validation (the reference validates DynaML via a
# Xerces/XSD grammar, dnainterop.cpp:465 + sampleData/DynaML.xsd; this
# enforces the same structure in pure python: known element names,
# required children, required root attribute values)
# ---------------------------------------------------------------------------

_XSD_SIMPLE = {
    "Name", "Constraints", "Coords", "Description", "First", "Second",
    "Third", "Value", "StdDev", "InstHeight", "TargHeight", "Total",
    "Type", "Ignore", "Vscale", "Pscale", "Lscale", "Hscale", "Height",
    "HemisphereZone", "Target", "X", "Y", "Z", "XAxis", "YAxis",
    "SigmaXX", "SigmaXY", "SigmaXZ", "SigmaYY", "SigmaYZ", "SigmaZZ",
    "Source", "ReferenceFrame", "Epoch", "EpochOfObservation",
    "MeasurementID", "ClusterID",
    "m11", "m12", "m13", "m21", "m22", "m23", "m31", "m32", "m33",
}
_XSD_MSR_CHILDREN = _XSD_SIMPLE | {"Directions", "GPSBaseline",
                                   "Clusterpoint"}
_COV_SEQ = tuple(f"m{r}{c}" for r in (1, 2, 3) for c in (1, 2, 3))
_VCV_REQ = ("X", "Y", "Z", "SigmaXX", "SigmaXY", "SigmaXZ",
            "SigmaYY", "SigmaYZ", "SigmaZZ")


def _xsd_err(msg):
    raise ValueError(f"DynaML schema validation: {msg}")


def _require(el, names, ctx):
    have = {c.tag for c in el}
    for n in names:
        if n not in have:
            _xsd_err(f"<{ctx}> is missing required element <{n}>")


def _check_vcv_entry(el, cov_tag):
    _require(el, _VCV_REQ, el.tag)
    for c in el:
        if c.tag == cov_tag:
            _require(c, _COV_SEQ, cov_tag)
        elif c.tag not in _XSD_SIMPLE:
            _xsd_err(f"unexpected element <{c.tag}> in <{el.tag}>")


def validate_dynaml_tree(root) -> None:
    """Structural validation per sampleData/DynaML.xsd; raises
    ValueError on the first violation (the reference aborts the import
    the same way when Xerces rejects the document)."""
    if root.tag != "DnaXmlFormat":
        _xsd_err(f"root element is <{root.tag}>, expected <DnaXmlFormat>")
    ftype = root.get("type")
    if ftype not in ("Measurement File", "Station File", "Combined File"):
        _xsd_err(f"DnaXmlFormat type attribute {ftype!r} is not one of "
                 f"'Measurement File'/'Station File'/'Combined File'")
    for el in root:
        if el.tag == "DnaStation":
            if ftype == "Measurement File":
                _xsd_err("<DnaStation> in a 'Measurement File'")
            _require(el, ("Name", "Constraints", "Type", "StationCoord"),
                     "DnaStation")
            for c in el:
                if c.tag == "StationCoord":
                    _require(c, ("Name", "XAxis", "YAxis", "Height"),
                             "StationCoord")
                elif c.tag not in _XSD_SIMPLE:
                    _xsd_err(f"unexpected element <{c.tag}> in "
                             f"<DnaStation>")
        elif el.tag == "DnaMeasurement":
            if ftype == "Station File":
                _xsd_err("<DnaMeasurement> in a 'Station File'")
            _require(el, ("Type",), "DnaMeasurement")
            for c in el:
                if c.tag == "GPSBaseline":
                    _check_vcv_entry(c, "GPSCovariance")
                elif c.tag == "Clusterpoint":
                    _check_vcv_entry(c, "PointCovariance")
                elif c.tag == "Directions":
                    _require(c, ("Target", "Value", "StdDev"),
                             "Directions")
                elif c.tag not in _XSD_MSR_CHILDREN:
                    _xsd_err(f"unexpected element <{c.tag}> in "
                             f"<DnaMeasurement>")
        else:
            _xsd_err(f"unexpected element <{el.tag}> under "
                     f"<DnaXmlFormat>")


def read_dynaml(path: str):
    """Read a DynaML file (station, measurement or combined).

    Returns (stations, measurements, frame, epoch)."""
    tree = ET.parse(path)
    root = tree.getroot()
    import os as _os
    if _os.environ.get("DTA_NO_XML_VALIDATE", "") != "1":
        validate_dynaml_tree(root)
    frame = root.get("referenceframe", "GDA2020")
    epoch = root.get("epoch", "01.01.2020")

    stations, measurements = [], []
    cluster_id = 0
    for el in root:
        if el.tag == "DnaStation":
            coord = el.find("StationCoord")
            stations.append(Station(
                name=_txt(el, "Name"),
                constraints=_txt(el, "Constraints", "FFF"),
                coord_type=_txt(el, "Type", "LLH"),
                p1=_num(coord, "XAxis"),
                p2=_num(coord, "YAxis"),
                p3=_num(coord, "Height"),
                hemi_zone=_txt(coord, "HemisphereZone"),
                description=_txt(el, "Description"),
            ))
        elif el.tag == "DnaMeasurement":
            cluster_id += 1
            rec = _parse_measurement(el, frame, epoch, cluster_id)
            if rec is not None:
                measurements.append(rec)
    return stations, measurements, frame, epoch


def _is_ignored(el) -> bool:
    ig = el.find("Ignore")
    return ig is not None and (ig.text or "").strip() != ""


def _parse_measurement(el, frame, epoch, cluster_id):
    mtype = _txt(el, "Type").upper()
    ignore = _is_ignored(el)
    source = _txt(el, "Source", "")
    m_frame = _txt(el, "ReferenceFrame", frame)
    m_epoch = _txt(el, "Epoch", epoch)
    obs_epoch = _txt(el, "EpochOfObservation", "")

    def _id(e, tag="MeasurementID"):
        v = _txt(e, tag)
        try:
            return int(v) if v else None
        except ValueError:
            return None

    if mtype in ("G", "X", "Y"):
        cl = GpsCluster(
            mtype=mtype, ignore=ignore,
            coord_type=_txt(el, "Coords", "XYZ") or "XYZ",
            vscale=_num(el, "Vscale", 1.0) or 1.0,
            pscale=_num(el, "Pscale", 1.0) or 1.0,
            lscale=_num(el, "Lscale", 1.0) or 1.0,
            hscale=_num(el, "Hscale", 1.0) or 1.0,
            epsg_frame=m_frame, epoch=m_epoch, cluster_id=cluster_id,
            obs_epoch=obs_epoch, source=source)
        cl.db_cluster_id = _id(el, "ClusterID")
        top_id = _id(el)
        first = _txt(el, "First")
        second = _txt(el, "Second")
        tag = "GPSBaseline" if mtype in ("G", "X") else "Clusterpoint"
        cov_tag = "GPSCovariance" if mtype in ("G", "X") else \
            "PointCovariance"
        geographic = cl.coord_type.upper().startswith("LL")
        for ob_el in el.findall(tag):
            vec = np.array([_num(ob_el, "X"), _num(ob_el, "Y"),
                            _num(ob_el, "Z")])
            if mtype == "Y" and geographic:
                vec = np.array([float(dms_to_rad(vec[0])),
                                float(dms_to_rad(vec[1])), vec[2]])
            V = np.zeros((3, 3))
            V[0, 0] = _num(ob_el, "SigmaXX")
            V[0, 1] = V[1, 0] = _num(ob_el, "SigmaXY")
            V[0, 2] = V[2, 0] = _num(ob_el, "SigmaXZ")
            V[1, 1] = _num(ob_el, "SigmaYY")
            V[1, 2] = V[2, 1] = _num(ob_el, "SigmaYZ")
            V[2, 2] = _num(ob_el, "SigmaZZ")
            ob = GpsObs(first=first, second=second if mtype != "Y" else "",
                        vec=vec, vcv=V,
                        msr_id=(_id(ob_el) if _id(ob_el) is not None
                                else top_id))
            for cov_el in ob_el.findall(cov_tag):
                C = np.array([
                    [_num(cov_el, "m11"), _num(cov_el, "m12"),
                     _num(cov_el, "m13")],
                    [_num(cov_el, "m21"), _num(cov_el, "m22"),
                     _num(cov_el, "m23")],
                    [_num(cov_el, "m31"), _num(cov_el, "m32"),
                     _num(cov_el, "m33")]])
                ob.covs.append(C)
            cl.obs.append(ob)
        return cl

    if mtype == "D":
        ds = DirectionSet(
            ignore=ignore, first=_txt(el, "First"), ro=_txt(el, "Second"),
            ro_value=float(dms_to_rad(_num(el, "Value"))),
            ro_sd=_num(el, "StdDev") * _SEC_TO_RAD, epoch=m_epoch,
            obs_epoch=obs_epoch, source=source)
        ds.msr_id = _id(el)
        ds.db_cluster_id = _id(el, "ClusterID")
        dir_ids = []
        for d_el in el.findall("Directions"):
            ds.directions.append((
                _txt(d_el, "Target"),
                float(dms_to_rad(_num(d_el, "Value"))),
                _num(d_el, "StdDev") * _SEC_TO_RAD,
                _is_ignored(d_el),
            ))
            dir_ids.append(_id(d_el))
        if any(i is not None for i in dir_ids):
            ds.direction_ids = dir_ids
        return ds

    m = Measurement(mtype=mtype, ignore=ignore, first=_txt(el, "First"),
                    second=_txt(el, "Second"), third=_txt(el, "Third"),
                    epoch=m_epoch, obs_epoch=obs_epoch, source=source)
    if mtype in ANGULAR_TYPES:
        m.value = float(dms_to_rad(_num(el, "Value")))
        m.sd = _num(el, "StdDev") * _SEC_TO_RAD
    else:
        m.value = _num(el, "Value")
        m.sd = _num(el, "StdDev")
    m.inst_height = _num(el, "InstHeight")
    m.targ_height = _num(el, "TargHeight")
    m.msr_id = _id(el)
    return m


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_dynaml_stn(path: str, net, comment: str = ""):
    from ..geodesy.conversions import rad_to_dms
    lines = ['<?xml version="1.0"?>',
             f'<DnaXmlFormat type="Station File" referenceframe='
             f'"{net.frame}" epoch="{net.epoch}" '
             f'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
             f'xsi:noNamespaceSchemaLocation="DynaML.xsd">']
    for i in range(net.nstations):
        H = net.height[i] - net.geoid_sep[i]
        lines.extend([
            "  <DnaStation>",
            f"    <Name>{net.names[i]}</Name>",
            f"    <Constraints>{net.constraints[i]}</Constraints>",
            "    <Type>LLH</Type>",
            "    <StationCoord>",
            f"      <Name>{net.names[i]}</Name>",
            f"      <XAxis>{float(rad_to_dms(net.lat[i])):.10f}</XAxis>",
            f"      <YAxis>{float(rad_to_dms(net.lon[i])):.10f}</YAxis>",
            f"      <Height>{H:.4f}</Height>",
            "    </StationCoord>",
            f"    <Description>{net.descriptions[i]}</Description>",
            "  </DnaStation>"])
    lines.append("</DnaXmlFormat>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_dynaml_combined(path: str, net, comment: str = ""):
    """Single DynaML file holding stations then measurements
    (--single-xml-file; dynaml_header "Combined File",
    dnainterop.cpp:4640)."""
    import io as _io
    import os
    import tempfile
    stn_buf = path + ".stn.tmp"
    msr_buf = path + ".msr.tmp"
    write_dynaml_stn(stn_buf, net, comment)
    write_dynaml_msr(msr_buf, net, comment)
    stn = open(stn_buf).read().splitlines()
    msr = open(msr_buf).read().splitlines()
    os.remove(stn_buf)
    os.remove(msr_buf)
    head = stn[1].replace('type="Station File"', 'type="Combined File"')
    body = stn[2:-1] + msr[2:-1]
    with open(path, "w") as f:
        f.write("\n".join([stn[0], head, *body, "</DnaXmlFormat>"]) + "\n")


def write_dynaml_msr(path: str, net, comment: str = ""):
    """DynaML measurement export covering all record types (round-trips
    through read_dynaml; reference: --export-xml-files measurement file,
    CDnaMeasurement::WriteDynaMLMsr)."""
    import numpy as np

    from ..geodesy.conversions import rad_to_dms

    RAD_TO_SEC = 180.0 / 3.141592653589793 * 3600.0
    L = ['<?xml version="1.0"?>',
         f'<DnaXmlFormat type="Measurement File" referenceframe='
         f'"{net.frame}" epoch="{net.epoch}" '
         f'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
         f'xsi:noNamespaceSchemaLocation="DynaML.xsd">']

    def ig(rec):
        return "*" if getattr(rec, "ignore", False) else ""

    for rec in net.measurements:
        if isinstance(rec, GpsCluster):
            L.append("  <DnaMeasurement>")
            L.append(f"    <Type>{rec.mtype}</Type>")
            L.append(f"    <Source>{getattr(rec, 'source', '')}"
                     f"</Source>")
            L.append(f"    <Ignore>{ig(rec)}</Ignore>")
            L.append(f"    <ReferenceFrame>{rec.epsg_frame}"
                     f"</ReferenceFrame>")
            L.append(f"    <Epoch>{rec.epoch}</Epoch>")
            if getattr(rec, "obs_epoch", "") and rec.obs_epoch != rec.epoch:
                L.append(f"    <EpochOfObservation>{rec.obs_epoch}"
                         f"</EpochOfObservation>")
            L.append(f"    <Vscale>{rec.vscale:g}</Vscale>")
            L.append(f"    <Pscale>{rec.pscale:g}</Pscale>")
            L.append(f"    <Lscale>{rec.lscale:g}</Lscale>")
            L.append(f"    <Hscale>{rec.hscale:g}</Hscale>")
            if rec.mtype == "Y":
                L.append(f"    <Coords>{rec.coord_type}</Coords>")
            first = rec.obs[0].first if rec.obs else ""
            L.append(f"    <First>{first}</First>")
            if rec.mtype in ("G", "X") and rec.obs:
                L.append(f"    <Second>{rec.obs[0].second}</Second>")
            tag = "GPSBaseline" if rec.mtype in ("G", "X") \
                else "Clusterpoint"
            cov_tag = "GPSCovariance" if rec.mtype in ("G", "X") \
                else "PointCovariance"
            geographic = (rec.mtype == "Y" and
                          rec.coord_type.upper().startswith("LL"))
            for ob in rec.obs:
                v = ob.vec
                if geographic:
                    v = [float(rad_to_dms(v[0])), float(rad_to_dms(v[1])),
                         v[2]]
                L.append(f"    <{tag}>")
                L.append(f"      <X>{v[0]:.8f}</X>")
                L.append(f"      <Y>{v[1]:.8f}</Y>")
                L.append(f"      <Z>{v[2]:.8f}</Z>")
                V = np.asarray(ob.vcv)
                L.append(f"      <SigmaXX>{V[0, 0]:.10e}</SigmaXX>")
                L.append(f"      <SigmaXY>{V[0, 1]:.10e}</SigmaXY>")
                L.append(f"      <SigmaXZ>{V[0, 2]:.10e}</SigmaXZ>")
                L.append(f"      <SigmaYY>{V[1, 1]:.10e}</SigmaYY>")
                L.append(f"      <SigmaYZ>{V[1, 2]:.10e}</SigmaYZ>")
                L.append(f"      <SigmaZZ>{V[2, 2]:.10e}</SigmaZZ>")
                if ob.msr_id is not None:
                    L.append(f"      <MeasurementID>{ob.msr_id}"
                             f"</MeasurementID>")
                if getattr(rec, "db_cluster_id", None) is not None:
                    L.append(f"      <ClusterID>{rec.db_cluster_id}"
                             f"</ClusterID>")
                for C in ob.covs:
                    L.append(f"      <{cov_tag}>")
                    for r in range(3):
                        for c in range(3):
                            L.append(f"        <m{r + 1}{c + 1}>"
                                     f"{C[r, c]:.10e}</m{r + 1}{c + 1}>")
                    L.append(f"      </{cov_tag}>")
                L.append(f"    </{tag}>")
            L.append("  </DnaMeasurement>")
        elif isinstance(rec, DirectionSet):
            L.append("  <DnaMeasurement>")
            L.append("    <Type>D</Type>")
            L.append(f"    <Source>{getattr(rec, 'source', '')}"
                     f"</Source>")
            L.append(f"    <Ignore>{ig(rec)}</Ignore>")
            L.append(f"    <First>{rec.first}</First>")
            L.append(f"    <Second>{rec.ro}</Second>")
            L.append(f"    <Value>{float(rad_to_dms(rec.ro_value)):.6f}"
                     f"</Value>")
            L.append(f"    <StdDev>{rec.ro_sd * RAD_TO_SEC:.4f}</StdDev>")
            if getattr(rec, "obs_epoch", "") and rec.obs_epoch != rec.epoch:
                L.append(f"    <EpochOfObservation>{rec.obs_epoch}"
                         f"</EpochOfObservation>")
            L.append(f"    <Total>{len(rec.directions)}</Total>")
            if getattr(rec, "msr_id", None) is not None:
                L.append(f"    <MeasurementID>{rec.msr_id}"
                         f"</MeasurementID>")
            dir_ids = getattr(rec, "direction_ids", None) or \
                [None] * len(rec.directions)
            for (t, v, sd, ign), did in zip(rec.directions, dir_ids):
                L.append("    <Directions>")
                L.append(f"      <Ignore>{'*' if ign else ''}</Ignore>")
                L.append(f"      <Target>{t}</Target>")
                L.append(f"      <Value>{float(rad_to_dms(v)):.6f}"
                         f"</Value>")
                L.append(f"      <StdDev>{sd * RAD_TO_SEC:.4f}</StdDev>")
                if did is not None:
                    L.append(f"      <MeasurementID>{did}"
                             f"</MeasurementID>")
                L.append("    </Directions>")
            L.append("  </DnaMeasurement>")
        elif isinstance(rec, Measurement):
            L.append("  <DnaMeasurement>")
            L.append(f"    <Type>{rec.mtype}</Type>")
            L.append(f"    <Source>{getattr(rec, 'source', '')}"
                     f"</Source>")
            L.append(f"    <Ignore>{ig(rec)}</Ignore>")
            L.append(f"    <First>{rec.first}</First>")
            if rec.second:
                L.append(f"    <Second>{rec.second}</Second>")
            if rec.third:
                L.append(f"    <Third>{rec.third}</Third>")
            if rec.mtype in ANGULAR_TYPES:
                L.append(f"    <Value>"
                         f"{float(rad_to_dms(rec.value)):.6f}</Value>")
                L.append(f"    <StdDev>{rec.sd * RAD_TO_SEC:.4f}"
                         f"</StdDev>")
            else:
                L.append(f"    <Value>{rec.value:.4f}</Value>")
                L.append(f"    <StdDev>{rec.sd:.4f}</StdDev>")
            if rec.inst_height or rec.targ_height:
                L.append(f"    <InstHeight>{rec.inst_height:.3f}"
                         f"</InstHeight>")
                L.append(f"    <TargHeight>{rec.targ_height:.3f}"
                         f"</TargHeight>")
            if getattr(rec, "obs_epoch", "") and rec.obs_epoch != rec.epoch:
                L.append(f"    <EpochOfObservation>{rec.obs_epoch}"
                         f"</EpochOfObservation>")
            if getattr(rec, "msr_id", None) is not None:
                L.append(f"    <MeasurementID>{rec.msr_id}"
                         f"</MeasurementID>")
            L.append("  </DnaMeasurement>")
    L.append("</DnaXmlFormat>")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
