"""Reference-compatible binary station/measurement files (.bst/.bms).

The reference serialises its station and measurement records as raw
C-struct dumps behind a small text+binary header
(`BstFile::WriteFile` / `BmsFile::WriteFile`, include/io/bst_file.cpp:177,
bms_file.cpp; header layout `DynadjustFile::WriteFileInfo/WriteFileMetadata`,
include/io/dynadjust_file.cpp:67-117).  This module reproduces the exact
byte layout (GCC x86-64 struct padding) with numpy structured dtypes, so a
user can hand `.bst`/`.bms` files produced by the reference tools straight
to this framework — and vice versa.

Struct sources:
- station_t      include/config/dnatypes-structs.hpp:270-323 (352 bytes)
- measurement_t  include/measurement_types/dnameasurement.hpp:133-194
  (208 bytes)
- binary_file_meta_t / input_file_meta_t  dnatypes-structs.hpp:350-420
- field widths   include/config/dnatypes-basic.hpp:66-76
- per-type record flattening  CDna*::WriteBinaryMsr (e.g.
  dnadistance.cpp:295, dnagpsbaseline.cpp:421, dnadirectionset.cpp:430,
  dnagpspoint.cpp:530, dnameasurement.cpp:224 for covariance rows)

Copy of the JAX package's ``io_formats/binary.py``.  The header and the
metadata keep its application name ("dynadjust_tpu"), so the files the
two packages write are byte-identical but for the one padding byte of
each measurement row, which the JAX writer leaves uninitialised and this
one writes as 0.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

FILE_VERSION = "1.2"            # __FILE_VERSION__, dynadjust_file.hpp:40
_FIELD_W = 10                   # identifier_field_width
_VERSION_HDR = b"VERSION   "
_DATE_HDR = b"CREATED ON"
_APP_HDR = b"CREATED BY"

MOD_NAME_WIDTH = 20
FILE_NAME_WIDTH = 256
STN_EPSG_WIDTH = 7
STN_EPOCH_WIDTH = 12

# measStart codes (dnatypes-basic.hpp:172-179)
X_MEAS, Y_MEAS, Z_MEAS, X_COV, Y_COV, Z_COV = range(6)

# COORD_TYPE enum (dnatypes-basic.hpp:128-135)
_COORD_TYPE_I = {"XYZ": 0, "LLh": 1, "LLH": 2, "UTM": 3, "ENU": 4}
_COORD_TYPE_S = {v: k for k, v in _COORD_TYPE_I.items()}

# HEIGHT_SYSTEM enum (reference: ORTHOMETRIC=0, ELLIPSOIDAL=1 —
# note our network.data uses the opposite numbering internally)
_REF_ORTHOMETRIC, _REF_ELLIPSOIDAL = 0, 1

# EPSG ids (LatLonEht variants; dnaconsts-datums.hpp:34-87)
_FRAME_EPSG = {
    "GDA94": 4939, "GDA2020": 7843, "AGD66": 4202, "AGD84": 4203,
    "ITRF2020": 9989, "ITRF2014": 7912, "ITRF2008": 7911,
    "ITRF2005": 7910, "ITRF2000": 7909, "ITRF1988": 7900,
    "ITRF1989": 7901, "ITRF1990": 7902, "ITRF1991": 7903,
    "ITRF1992": 7904, "ITRF1993": 7905, "ITRF1994": 7906,
    "ITRF1996": 7907, "ITRF1997": 7908,
    "WGS84_TRANSIT": 7816, "WGS84_G730": 7657, "WGS84_G873": 7659,
    "WGS84_G1150": 7661, "WGS84_G1674": 7663, "WGS84_G1762": 7665,
    "WGS84_G2139": 9754, "WGS84": 4979,
}
# accept both geographic-3D and cartesian ids when reading
_EPSG_FRAME = {v: k for k, v in _FRAME_EPSG.items()}
_EPSG_FRAME.update({
    4938: "GDA94", 7842: "GDA2020", 9988: "ITRF2020", 7789: "ITRF2014",
    5332: "ITRF2008", 4896: "ITRF2005", 4919: "ITRF2000", 4910: "ITRF1988",
    4911: "ITRF1989", 4912: "ITRF1990", 4913: "ITRF1991", 4914: "ITRF1992",
    4915: "ITRF1993", 4916: "ITRF1994", 4917: "ITRF1996", 4918: "ITRF1997",
    4283: "GDA94", 7844: "GDA2020", 4978: "WGS84", 4979: "WGS84",
})

# station_t — offsets follow GCC x86-64 padding of the struct
STATION_DTYPE = np.dtype({
    "names": [
        "stationName", "stationNameOrig", "stationConst", "stationType",
        "suppliedStationType", "initialLatitude", "currentLatitude",
        "initialLongitude", "currentLongitude", "initialHeight",
        "currentHeight", "suppliedHeightRefFrame", "geoidSep",
        "geoidSepUnc", "meridianDef", "verticalDef", "zone",
        "description", "fileOrder", "nameOrder", "clusterID",
        "unusedStation", "epsgCode", "epoch", "observation_epoch",
        "plate",
    ],
    "formats": [
        "S31", "S40", "S4", "S4",
        "<u2", "<f8", "<f8",
        "<f8", "<f8", "<f8",
        "<f8", "<u2", "<f4",
        "<f4", "<f8", "<f8", "<i2",
        "S129", "<u4", "<u4", "<u4",
        "<u2", "S7", "S12", "S12",
        "S3",
    ],
    "offsets": [
        0, 31, 71, 75,
        80, 88, 96,
        104, 112, 120,
        128, 136, 140,
        144, 152, 160, 168,
        170, 300, 304, 308,
        312, 314, 321, 333,
        345,
    ],
    "itemsize": 352,
})

# measurement_t
MEAS_DTYPE = np.dtype({
    "names": [
        "measType", "measStart", "measurementStations", "epsgCode",
        "epoch", "observation_epoch", "coordType", "ignore",
        "station1", "station2", "station3", "vectorCount1",
        "vectorCount2", "clusterID", "fileOrder", "sourceFileIndex",
        "term1", "term2", "term3", "term4",
        "scale1", "scale2", "scale3", "scale4",
        "measAdj", "measCorr", "measAdjPrec", "residualPrec",
        "NStat", "TStat", "PelzerRel", "preAdjCorr", "preAdjMeas",
    ],
    "formats": [
        "S1", "i1", "i1", "S7",
        "S12", "S12", "S4", "?",
        "<u4", "<u4", "<u4", "<u4",
        "<u4", "<u4", "<u4", "<u4",
        "<f8", "<f8", "<f8", "<f8",
        "<f8", "<f8", "<f8", "<f8",
        "<f8", "<f8", "<f8", "<f8",
        "<f8", "<f8", "<f8", "<f8", "<f8",
    ],
    "offsets": [
        0, 1, 2, 3,
        10, 22, 34, 38,
        40, 44, 48, 52,
        56, 60, 64, 68,
        72, 80, 88, 96,
        104, 112, 120, 128,
        136, 144, 152, 160,
        168, 176, 184, 192, 200,
    ],
    "itemsize": 208,
})


def _pad_field(s: str) -> bytes:
    # right-justified in a 10-char field (WriteVersion, snprintf "%*s")
    return s[:_FIELD_W].rjust(_FIELD_W).encode()


def _write_header(f, app_name: str = "dynadjust_tpu"):
    f.write(_VERSION_HDR + _pad_field(FILE_VERSION))
    f.write(_DATE_HDR + _pad_field(_dt.date.today().isoformat()))
    f.write(_APP_HDR + _pad_field(app_name))


def _read_header(f):
    def field():
        f.read(_FIELD_W)            # field name
        return f.read(_FIELD_W).decode(errors="replace").strip()
    version = field()
    date = field()
    app = field()
    return version, date, app


def _cstr(b: bytes) -> str:
    return b.split(b"\0", 1)[0].decode(errors="replace")


def _write_meta(f, *, bin_count: int, reduced: bool, epsg: str,
                epoch: str, observation_epoch: str, reftran: bool,
                geoid: bool, input_files=(), source_files=(),
                modified_by: str = "dynadjust_tpu"):
    """binary_file_meta_t layout (dynadjust_file.cpp:83-117)."""
    f.write(np.uint64(bin_count).tobytes())
    f.write(bytes([1 if reduced else 0]))
    f.write(modified_by.encode()[:MOD_NAME_WIDTH].ljust(MOD_NAME_WIDTH,
                                                        b"\0"))
    f.write(epsg.encode()[:STN_EPSG_WIDTH].ljust(STN_EPSG_WIDTH, b"\0"))
    f.write(epoch.encode()[:STN_EPOCH_WIDTH].ljust(STN_EPOCH_WIDTH, b"\0"))
    f.write(observation_epoch.encode()[:STN_EPOCH_WIDTH]
            .ljust(STN_EPOCH_WIDTH, b"\0"))
    f.write(bytes([1 if reftran else 0]))
    f.write(bytes([1 if geoid else 0]))
    f.write(np.uint64(len(input_files)).tobytes())
    for (fname, fepsg, fepoch, fobs, ftype, dtype_) in input_files:
        f.write(fname.encode()[:FILE_NAME_WIDTH].ljust(FILE_NAME_WIDTH,
                                                       b"\0"))
        f.write(fepsg.encode()[:STN_EPSG_WIDTH].ljust(STN_EPSG_WIDTH,
                                                      b"\0"))
        f.write(fepoch.encode()[:STN_EPOCH_WIDTH].ljust(STN_EPOCH_WIDTH,
                                                        b"\0"))
        f.write(fobs.encode()[:STN_EPOCH_WIDTH].ljust(STN_EPOCH_WIDTH,
                                                      b"\0"))
        f.write(np.uint16(ftype).tobytes())
        f.write(np.uint16(dtype_).tobytes())
    f.write(np.uint64(len(source_files)).tobytes())
    for fname in source_files:
        f.write(fname.encode()[:FILE_NAME_WIDTH].ljust(FILE_NAME_WIDTH,
                                                       b"\0"))


def _read_meta(f, version: str) -> dict:
    vmajor, vminor = (int(t) for t in (version.split(".") + ["0"])[:2])

    def at_least(ma, mi):
        return (vmajor, vminor) >= (ma, mi)

    meta = {}
    meta["bin_count"] = int(np.frombuffer(f.read(8), "<u8")[0])
    meta["reduced"] = bool(f.read(1)[0])
    meta["modified_by"] = _cstr(f.read(MOD_NAME_WIDTH))
    meta["epsg"] = _cstr(f.read(STN_EPSG_WIDTH))
    meta["epoch"] = _cstr(f.read(STN_EPOCH_WIDTH))
    if at_least(1, 2):
        meta["observation_epoch"] = _cstr(f.read(STN_EPOCH_WIDTH))
    else:
        meta["observation_epoch"] = meta["epoch"]
    meta["reftran"] = bool(f.read(1)[0])
    meta["geoid"] = bool(f.read(1)[0])
    nfiles = int(np.frombuffer(f.read(8), "<u8")[0])
    files = []
    for _ in range(nfiles):
        fname = _cstr(f.read(FILE_NAME_WIDTH))
        fepsg = _cstr(f.read(STN_EPSG_WIDTH))
        fepoch = _cstr(f.read(STN_EPOCH_WIDTH))
        fobs = _cstr(f.read(STN_EPOCH_WIDTH)) if at_least(1, 2) else fepoch
        ftype = int(np.frombuffer(f.read(2), "<u2")[0])
        dtype_ = int(np.frombuffer(f.read(2), "<u2")[0])
        files.append((fname, fepsg, fepoch, fobs, ftype, dtype_))
    meta["input_files"] = files
    sources = []
    if at_least(1, 1):
        nsrc = int(np.frombuffer(f.read(8), "<u8")[0])
        for _ in range(nsrc):
            sources.append(_cstr(f.read(FILE_NAME_WIDTH)))
    meta["source_files"] = sources
    return meta


def frame_epsg_string(frame: str) -> str:
    from ..params.datums import canonical_frame
    return str(_FRAME_EPSG.get(canonical_frame(frame), 0))


def frame_from_epsg(epsg: str) -> str:
    try:
        code = int(epsg)
    except (TypeError, ValueError):
        return ""
    hit = _EPSG_FRAME.get(code, "")
    if hit:
        return hit
    # full registry fallback: any code the reference accepts
    # (params/epsg.py — NAD83(CSRS) family, SIRGAS, WGS84 variants)
    from ..params.datums import frame_from_epsg_code
    return frame_from_epsg_code(code)


# ---------------------------------------------------------------------------
# .bst
# ---------------------------------------------------------------------------

def write_bst(path: str, net) -> None:
    from .dna import Station  # noqa: F401  (kept for type context)
    from ..network.data import ORTHOMETRIC as _OUR_ORTHO

    n = net.nstations
    rec = np.zeros(n, dtype=STATION_DTYPE)
    for i in range(n):
        rec["stationName"][i] = net.names[i].encode()[:30]
        rec["stationNameOrig"][i] = net.names[i].encode()[:39]
        rec["stationConst"][i] = (net.constraints[i] or "FFF").encode()[:3]
        ct = net.coord_types[i] if i < len(net.coord_types) else "LLH"
        rec["stationType"][i] = ct.encode()[:3]
        rec["suppliedStationType"][i] = _COORD_TYPE_I.get(ct, 2)
        rec["initialLatitude"][i] = net.lat[i]
        rec["currentLatitude"][i] = net.lat[i]
        rec["initialLongitude"][i] = net.lon[i]
        rec["currentLongitude"][i] = net.lon[i]
        rec["initialHeight"][i] = net.initial_height[i]
        rec["currentHeight"][i] = net.height[i]
        rec["suppliedHeightRefFrame"][i] = (
            _REF_ORTHOMETRIC if net.height_ref[i] == _OUR_ORTHO
            else _REF_ELLIPSOIDAL)
        rec["geoidSep"][i] = net.geoid_sep[i]
        rec["meridianDef"][i] = net.meridian_def[i]
        rec["verticalDef"][i] = net.vertical_def[i]
        rec["description"][i] = (net.descriptions[i] or "").encode()[:128]
        rec["fileOrder"][i] = (net.station_file_order[i]
                               if net.station_file_order else i)
        rec["nameOrder"][i] = i
        frames = net.station_frames or [""] * n
        rec["epsgCode"][i] = frame_epsg_string(
            frames[i] or net.frame).encode()
        epochs = net.station_epochs or [""] * n
        rec["epoch"][i] = (epochs[i] or net.epoch or "").encode()[:11]
        rec["observation_epoch"][i] = (
            net.observation_epoch or "").encode()[:11]
    # nameOrder: position in the name-sorted station list
    for k, i in enumerate(sorted(range(n), key=lambda j: net.names[j])):
        rec["nameOrder"][i] = k

    with open(path, "wb") as f:
        _write_header(f)
        _write_meta(
            f, bin_count=n, reduced=True,
            epsg=frame_epsg_string(net.frame), epoch=net.epoch or "",
            observation_epoch=net.observation_epoch or "",
            reftran=bool(net.reftran_applied),
            geoid=bool(net.geoid_applied))
        f.write(rec.tobytes())


def read_bst(path: str):
    """-> (structured station array, meta dict)."""
    with open(path, "rb") as f:
        version, _, _ = _read_header(f)
        meta = _read_meta(f, version)
        rec = np.frombuffer(f.read(STATION_DTYPE.itemsize *
                                   meta["bin_count"]),
                            dtype=STATION_DTYPE)
    return rec, meta


# ---------------------------------------------------------------------------
# .bms
# ---------------------------------------------------------------------------

_ONE_STATION = set("HIJPQRY")
_THREE_STATION = set("A")


def measurement_rows(net) -> np.ndarray:
    """Flatten our measurement records into measurement_t rows, exactly
    as the reference's per-type WriteBinaryMsr methods do."""
    from .dna import GpsCluster, Measurement, DirectionSet

    idx = net.name_to_idx
    rows = []
    file_order = [0]

    def new_row(mtype, start=X_MEAS):
        r = np.zeros(1, dtype=MEAS_DTYPE)[0]
        r["measType"] = mtype.encode()
        r["measStart"] = start
        r["scale1"] = r["scale2"] = r["scale3"] = r["scale4"] = 1.0
        r["measurementStations"] = 1
        r["epsgCode"] = frame_epsg_string(net.frame).encode()
        r["fileOrder"] = file_order[0]
        file_order[0] += 1
        return r

    for rec in net.measurements:
        if isinstance(rec, GpsCluster):
            epsg = frame_epsg_string(rec.epsg_frame or net.frame).encode()
            nvec = len(rec.obs)
            for ob in rec.obs:
                for start, (t1, t2, t3, t4) in zip(
                        (X_MEAS, Y_MEAS, Z_MEAS),
                        (((ob.vec[0]), ob.vcv[0, 0], 0.0, 0.0),
                         ((ob.vec[1]), ob.vcv[0, 1], ob.vcv[1, 1], 0.0),
                         ((ob.vec[2]), ob.vcv[0, 2], ob.vcv[1, 2],
                          ob.vcv[2, 2]))):
                    r = new_row(rec.mtype, start)
                    r["epsgCode"] = epsg
                    r["epoch"] = (rec.epoch or "").encode()[:11]
                    r["observation_epoch"] = (
                        rec.obs_epoch or "").encode()[:11]
                    r["ignore"] = rec.ignore
                    r["station1"] = idx[ob.first]
                    if ob.second:
                        r["station2"] = idx[ob.second]
                        r["measurementStations"] = 2
                    if rec.mtype == "Y":
                        r["coordType"] = rec.coord_type.encode()[:3]
                    r["vectorCount1"] = nvec
                    r["vectorCount2"] = len(ob.covs)
                    r["clusterID"] = rec.cluster_id
                    r["scale1"] = rec.pscale
                    r["scale2"] = rec.lscale
                    r["scale3"] = rec.hscale
                    r["scale4"] = rec.vscale
                    r["term1"], r["term2"] = t1, t2
                    r["term3"], r["term4"] = t3, t4
                    rows.append(r)
                for C in ob.covs:
                    # CDnaCovariance::WriteBinaryMsr: 3 rows (one per
                    # matrix row); fileOrder stays default 0 while the
                    # running index advances by 3 (dnameasurement.cpp:226)
                    for start, mrow in zip((X_COV, Y_COV, Z_COV), C):
                        r = new_row(rec.mtype, start)
                        r["fileOrder"] = 0
                        r["epsgCode"] = epsg
                        r["epoch"] = (rec.epoch or "").encode()[:11]
                        r["station1"] = idx[ob.first]
                        if ob.second:
                            r["station2"] = idx[ob.second]
                        r["clusterID"] = rec.cluster_id
                        r["term1"], r["term2"], r["term3"] = mrow
                        rows.append(r)
        elif isinstance(rec, DirectionSet):
            r = new_row("D")
            r["epoch"] = (rec.epoch or "").encode()[:11]
            r["observation_epoch"] = (rec.obs_epoch or "").encode()[:11]
            r["ignore"] = rec.ignore
            r["station1"] = idx[rec.first]
            r["station2"] = idx[rec.ro]
            r["measurementStations"] = 2
            r["vectorCount1"] = len(rec.directions) + 1
            nonign = sum(1 for d in rec.directions if not d[3])
            if not rec.ignore and nonign > 0:
                r["vectorCount2"] = nonign + 1
            r["term1"] = rec.ro_value
            r["term2"] = rec.ro_sd ** 2
            rows.append(r)
            for (target, value, sd, ign) in rec.directions:
                r = new_row("D", Y_MEAS)
                r["epoch"] = (rec.epoch or "").encode()[:11]
                r["ignore"] = ign
                r["station1"] = idx[rec.first]
                r["station2"] = idx[target]
                r["measurementStations"] = 2
                r["vectorCount1"] = len(rec.directions) + 1
                r["term1"] = value
                r["term2"] = sd ** 2
                rows.append(r)
        elif isinstance(rec, Measurement):
            r = new_row(rec.mtype)
            r["epoch"] = (rec.epoch or "").encode()[:11]
            r["observation_epoch"] = (rec.obs_epoch or "").encode()[:11]
            r["ignore"] = rec.ignore
            r["station1"] = idx[rec.first]
            ns = 1
            if rec.second:
                r["station2"] = idx[rec.second]
                ns = 2
            if rec.third:
                r["station3"] = idx[rec.third]
                ns = 3
            r["measurementStations"] = ns
            r["term1"] = rec.value
            r["term2"] = rec.sd ** 2
            r["term3"] = rec.inst_height
            r["term4"] = rec.targ_height
            rows.append(r)
    # the struct padding (byte 39 of each row) is written as 0: np.array
    # of the records would leave it uninitialised, so that one network's
    # file changed from run to run
    out = np.zeros(len(rows), dtype=MEAS_DTYPE)
    for k, r in enumerate(rows):
        out[k] = r
    return out


def write_bms(path: str, net) -> None:
    rows = measurement_rows(net)
    with open(path, "wb") as f:
        _write_header(f)
        _write_meta(
            f, bin_count=len(rows), reduced=True,
            epsg=frame_epsg_string(net.frame), epoch=net.epoch or "",
            observation_epoch=net.observation_epoch or "",
            reftran=bool(net.reftran_applied),
            geoid=bool(net.geoid_applied))
        f.write(rows.tobytes())


def read_bms(path: str):
    """-> (structured measurement-row array, meta dict)."""
    with open(path, "rb") as f:
        version, _, _ = _read_header(f)
        meta = _read_meta(f, version)
        rows = np.frombuffer(f.read(MEAS_DTYPE.itemsize *
                                    meta["bin_count"]),
                             dtype=MEAS_DTYPE)
    return rows, meta


def records_from_rows(rows, names) -> list:
    """Rebuild our measurement record objects from measurement_t rows
    (inverse of measurement_rows)."""
    from .dna import GpsCluster, GpsObs, Measurement, DirectionSet

    recs = []
    i = 0
    n = len(rows)
    while i < n:
        r = rows[i]
        t = r["measType"].decode()
        if t in ("G", "X", "Y"):
            nvec = int(r["vectorCount1"])
            cl = GpsCluster(
                mtype=t, ignore=bool(r["ignore"]),
                coord_type=_cstr(r["coordType"]) or "XYZ",
                pscale=float(r["scale1"]), lscale=float(r["scale2"]),
                hscale=float(r["scale3"]), vscale=float(r["scale4"]),
                epsg_frame=frame_from_epsg(_cstr(r["epsgCode"])),
                epoch=_cstr(r["epoch"]), cluster_id=int(r["clusterID"]),
                obs_epoch=_cstr(r["observation_epoch"]))
            for _ in range(nvec):
                rx, ry, rz = rows[i], rows[i + 1], rows[i + 2]
                i += 3
                V = np.array([
                    [rx["term2"], ry["term2"], rz["term2"]],
                    [ry["term2"], ry["term3"], rz["term3"]],
                    [rz["term2"], rz["term3"], rz["term4"]]])
                ob = GpsObs(
                    first=names[int(rx["station1"])],
                    second=(names[int(rx["station2"])]
                            if t != "Y" else ""),
                    vec=np.array([rx["term1"], ry["term1"], rz["term1"]]),
                    vcv=V)
                ncov = int(rx["vectorCount2"])
                for _ in range(ncov):
                    c0, c1, c2 = rows[i], rows[i + 1], rows[i + 2]
                    i += 3
                    ob.covs.append(np.array([
                        [c0["term1"], c0["term2"], c0["term3"]],
                        [c1["term1"], c1["term2"], c1["term3"]],
                        [c2["term1"], c2["term2"], c2["term3"]]]))
                cl.obs.append(ob)
            recs.append(cl)
        elif t == "D":
            total = int(r["vectorCount1"])
            ds = DirectionSet(
                ignore=bool(r["ignore"]),
                first=names[int(r["station1"])],
                ro=names[int(r["station2"])],
                ro_value=float(r["term1"]),
                ro_sd=float(np.sqrt(r["term2"])),
                epoch=_cstr(r["epoch"]),
                obs_epoch=_cstr(r["observation_epoch"]))
            i += 1
            for _ in range(total - 1):
                d = rows[i]
                i += 1
                ds.directions.append((
                    names[int(d["station2"])], float(d["term1"]),
                    float(np.sqrt(d["term2"])), bool(d["ignore"])))
            recs.append(ds)
        else:
            m = Measurement(
                mtype=t, ignore=bool(r["ignore"]),
                first=names[int(r["station1"])],
                second=(names[int(r["station2"])]
                        if r["measurementStations"] >= 2 else ""),
                third=(names[int(r["station3"])]
                       if r["measurementStations"] >= 3 else ""),
                value=float(r["term1"]),
                sd=float(np.sqrt(r["term2"])),
                inst_height=float(r["term3"]),
                targ_height=float(r["term4"]),
                epoch=_cstr(r["epoch"]),
                obs_epoch=_cstr(r["observation_epoch"]))
            i += 1
            recs.append(m)
    return recs


def network_from_binary(bst_path: str, bms_path: str):
    """Reference .bst + .bms -> NetworkData."""
    from ..network.data import (NetworkData, ORTHOMETRIC as _OUR_ORTHO,
                                ELLIPSOIDAL as _OUR_ELL)
    from ..params.datums import Datum

    stn, smeta = read_bst(bst_path)
    names = [_cstr(s["stationName"]) for s in stn]
    frame = frame_from_epsg(smeta["epsg"]) or "GDA2020"
    n = len(stn)
    href = np.where(
        stn["suppliedHeightRefFrame"] == _REF_ORTHOMETRIC,
        _OUR_ORTHO, _OUR_ELL).astype(np.int32)
    station_frames = [frame_from_epsg(_cstr(s["epsgCode"])) or ""
                      for s in stn]
    station_epochs = [_cstr(s["epoch"]) for s in stn]
    net = NetworkData(
        names=names,
        name_to_idx={nm: i for i, nm in enumerate(names)},
        constraints=[_cstr(s["stationConst"]) or "FFF" for s in stn],
        coord_types=[_cstr(s["stationType"]) or "LLH" for s in stn],
        lat=stn["currentLatitude"].astype(np.float64).copy(),
        lon=stn["currentLongitude"].astype(np.float64).copy(),
        height=stn["currentHeight"].astype(np.float64).copy(),
        initial_height=stn["initialHeight"].astype(np.float64).copy(),
        height_ref=href,
        geoid_sep=stn["geoidSep"].astype(np.float64).copy(),
        meridian_def=stn["meridianDef"].astype(np.float64).copy(),
        vertical_def=stn["verticalDef"].astype(np.float64).copy(),
        descriptions=[_cstr(s["description"]) for s in stn],
        measurements=[],
        frame=frame, epoch=smeta["epoch"],
        datum=Datum.from_name(frame, smeta["epoch"]),
        geoid_applied=smeta["geoid"],
        reftran_applied=smeta["reftran"],
        station_frames=(station_frames
                        if any(f != frame for f in station_frames)
                        else None),
        station_epochs=(station_epochs
                        if any(e and e != smeta["epoch"]
                               for e in station_epochs) else None),
        station_file_order=[int(s["fileOrder"]) for s in stn],
        observation_epoch=smeta["observation_epoch"],
    )
    if bms_path:
        rows, _ = read_bms(bms_path)
        net.measurements = records_from_rows(rows, names)
    return net


# ---------------------------------------------------------------------------
# .asl / .aml / .map (binary association and name-map files)
# ---------------------------------------------------------------------------
# Formats (all little-endian, behind the 60-byte info header):
# .asl  u64 count; per station: u32 assocMsrCount, u32 amlStnIndex,
#       u16 validity           (operator<<, dnatemplatestnmsrfuncs.hpp:903)
# .aml  u64 count; u32 bms-row index per entry (aml_file.cpp:120-129)
# .map  u32 count; per entry: char[31] station name, u32 index
#       (map_file.cpp WriteFile)

STN_NAME_WIDTH = 31
VALID_STATION, INVALID_STATION = 1, 0


def _associations_with_ignored(net):
    """Per-station associated measurement record indices, INCLUDING
    ignored measurements (assocMsrCount semantics, dnastation.hpp:136)."""
    from ..network.screening import stations_of_record
    assoc = {i: [] for i in range(net.nstations)}
    for m, rec in enumerate(net.measurements):
        for name in stations_of_record(rec):
            i = net.name_to_idx.get(name)
            if i is not None:
                assoc[i].append(m)
    return assoc


def record_row_starts(net) -> list:
    """First .bms row index of each measurement record (mirrors the
    flattening of measurement_rows)."""
    from .dna import GpsCluster, DirectionSet
    starts, k = [], 0
    for rec in net.measurements:
        starts.append(k)
        if isinstance(rec, GpsCluster):
            k += sum(3 + 3 * len(ob.covs) for ob in rec.obs)
        elif isinstance(rec, DirectionSet):
            k += 1 + len(rec.directions)
        else:
            k += 1
    return starts


def write_asl_aml(asl_path: str, aml_path: str, net) -> None:
    assoc = _associations_with_ignored(net)
    starts = record_row_starts(net)
    aml_entries = []
    with open(asl_path, "wb") as f:
        _write_header(f)
        f.write(np.uint64(net.nstations).tobytes())
        for i in range(net.nstations):
            n = len(assoc[i])
            f.write(np.uint32(n).tobytes())
            f.write(np.uint32(len(aml_entries)).tobytes())
            f.write(np.uint16(VALID_STATION if n else
                              INVALID_STATION).tobytes())
            aml_entries.extend(starts[m] for m in assoc[i])
    with open(aml_path, "wb") as f:
        _write_header(f)
        f.write(np.uint64(len(aml_entries)).tobytes())
        f.write(np.asarray(aml_entries, dtype="<u4").tobytes())


def read_asl(path: str):
    """-> structured array (assocMsrCount, amlStnIndex, validity)."""
    dt = np.dtype([("assocMsrCount", "<u4"), ("amlStnIndex", "<u4"),
                   ("validity", "<u2")])
    with open(path, "rb") as f:
        _read_header(f)
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        return np.frombuffer(f.read(dt.itemsize * n), dtype=dt)


def read_aml(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        _read_header(f)
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        return np.frombuffer(f.read(4 * n), dtype="<u4")


def write_map(path: str, net) -> None:
    with open(path, "wb") as f:
        _write_header(f)
        f.write(np.uint32(net.nstations).tobytes())
        # name-sorted, as the reference's station map is
        for nm in sorted(net.names):
            f.write(nm.encode()[:STN_NAME_WIDTH - 1]
                    .ljust(STN_NAME_WIDTH, b"\0"))
            f.write(np.uint32(net.name_to_idx[nm]).tobytes())


def read_map(path: str) -> list:
    out = []
    with open(path, "rb") as f:
        _read_header(f)
        n = int(np.frombuffer(f.read(4), "<u4")[0])
        for _ in range(n):
            nm = _cstr(f.read(STN_NAME_WIDTH))
            i = int(np.frombuffer(f.read(4), "<u4")[0])
            out.append((nm, i))
    return out
