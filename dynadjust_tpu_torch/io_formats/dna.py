"""DNA station (.stn) and measurement (.msr) file reader.

Implements the fixed-column DNA interchange format, versions 1.00 / 3.00 /
3.01 / 3.02, covering all 20 measurement types (A B C D E G H I J K L M P Q
R S V X Y Z).

Format reference (column layouts studied from):
  DynAdjust dynadjust/include/io/dnaiodnatypes.hpp (field
  locations/widths per version)
  DynAdjust dynadjust/dynadjust/dnaimport/dnainterop.cpp
  (ParseDNASTN :1447, ParseDNAMSR :1666 and per-type parsers)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geodesy.conversions import dms_to_rad

# ---------------------------------------------------------------------------
# Column layouts: (location, width) per field, keyed by format version
# ---------------------------------------------------------------------------

_STN_FIELDS = ("name", "const", "type", "e_phi_x", "n_lam_y", "ht_z",
               "hemi_zo", "desc")
_MSR_FIELDS = ("type", "ignore", "inst", "targ1", "targ2", "linear", "gps",
               "gps_vcv_1", "gps_vcv_2", "gps_vcv_3", "vscale", "pscale",
               "lscale", "hscale", "reframe", "epoch", "ang_d", "ang_m",
               "ang_s", "stddev", "inst_ht", "targ_ht", "id_msr",
               "id_cluster", "obs_epoch")

_STN_LAYOUTS = {
    "1.00": dict(zip(_STN_FIELDS, zip(
        (0, 10, 14, 17, 31, 45, 59, 63),
        (10, 3, 3, 14, 14, 14, 3, 128)))),
    "3.00": dict(zip(_STN_FIELDS, zip(
        (0, 20, 24, 27, 41, 55, 69, 73),
        (20, 3, 3, 14, 14, 14, 3, 128)))),
    "3.01": dict(zip(_STN_FIELDS, zip(
        (0, 20, 24, 27, 47, 67, 87, 91),
        (20, 3, 3, 20, 20, 20, 3, 128)))),
}
_STN_LAYOUTS["3.02"] = _STN_LAYOUTS["3.01"]

_MSR_LAYOUTS = {
    "1.00": dict(zip(_MSR_FIELDS, zip(
        (0, 1, 2, 12, 22, 32, 32, 46, 57, 68, 32, 46, 57, 68, 79, 89,
         46, 50, 54, 60, 69, 76, 83, 93, 0),
        (1, 1, 10, 10, 10, 14, 14, 11, 11, 11, 14, 11, 11, 11, 10, 10,
         4, 4, 6, 9, 7, 7, 10, 10, 0)))),
    "3.00": dict(zip(_MSR_FIELDS, zip(
        (0, 1, 2, 22, 42, 62, 62, 76, 90, 104, 62, 69, 76, 83, 90, 104,
         76, 80, 82, 90, 99, 106, 118, 128, 0),
        (1, 1, 20, 20, 20, 14, 14, 14, 14, 14, 7, 7, 7, 7, 14, 14,
         4, 2, 8, 9, 7, 7, 10, 10, 0)))),
    "3.01": dict(zip(_MSR_FIELDS, zip(
        (0, 1, 2, 22, 42, 62, 62, 82, 102, 122, 62, 72, 82, 92, 102, 122,
         76, 80, 82, 90, 99, 106, 142, 152, 0),
        (1, 1, 20, 20, 20, 14, 20, 20, 20, 20, 10, 10, 10, 10, 20, 20,
         4, 2, 8, 9, 7, 7, 10, 10, 0)))),
}
_MSR_LAYOUTS["3.02"] = dict(_MSR_LAYOUTS["3.01"])
_MSR_LAYOUTS["3.02"]["obs_epoch"] = (162, 14)

_SEC_TO_RAD = np.pi / 180.0 / 3600.0

ANGULAR_TYPES = set("ABDIJKPQVZ")
LINEAR_TYPES = set("CEHLMRS")
GPS_TYPES = set("GXY")


@dataclass
class Station:
    name: str
    constraints: str            # e.g. "FFF", "CCC", "CCF"
    coord_type: str             # LLH, LLh, XYZ, UTM, ENU
    p1: float                   # lat (packed DMS) / X / easting
    p2: float                   # lon / Y / northing
    p3: float                   # H(ortho for LLH, ellipsoidal for LLh) / Z
    hemi_zone: str = ""
    description: str = ""
    frame: str = ""             # source frame (SINEX import); "" = project
    epoch: str = ""


@dataclass
class GpsObs:
    """One baseline (G/X) or point (Y) within a cluster."""
    first: str
    second: str                 # empty for Y clusters
    vec: np.ndarray             # (3,) X/Y/Z or lat/lon/h (Y LLH)
    vcv: np.ndarray             # (3, 3) full (symmetrised) apriori VCV
    covs: list = field(default_factory=list)  # 3x3 blocks to FOLLOWING obs
    msr_id: int | None = None   # measurement database id (msr_database_id_map)


@dataclass
class GpsCluster:
    mtype: str                  # 'G', 'X' or 'Y'
    ignore: bool
    coord_type: str             # for Y: LLH / XYZ
    vscale: float
    pscale: float
    lscale: float
    hscale: float
    epsg_frame: str
    epoch: str
    obs: list = field(default_factory=list)    # list[GpsObs]
    cluster_id: int = 0
    obs_epoch: str = ""         # epoch of observation (v1.2 metadata)
    source: str = ""            # provenance tag (<Source>, issue #317)
    # database ids (msr_database_id_map, dnameasurement.hpp:497): the
    # cluster-level database id printed by --output-database-ids and
    # serialised to .dbid (dnainterop.cpp:5117)
    db_cluster_id: int | None = None


@dataclass
class Measurement:
    """Non-GPS scalar measurement (types A B C E H I J K L M P Q R S V Z)."""
    mtype: str
    ignore: bool
    first: str
    second: str = ""
    third: str = ""
    value: float = 0.0          # radians for angular, metres for linear
    sd: float = 0.0             # same units as value
    inst_height: float = 0.0
    targ_height: float = 0.0
    epoch: str = ""
    obs_epoch: str = ""         # epoch of observation (v1.2 metadata)
    source: str = ""            # provenance tag (<Source>, issue #317)
    msr_id: int | None = None   # measurement database id


@dataclass
class DirectionSet:
    """Type D: a round of directions from one instrument station."""
    ignore: bool
    first: str                  # instrument
    ro: str                     # reference object (initial target)
    ro_value: float             # radians
    ro_sd: float                # radians
    directions: list = field(default_factory=list)
    # directions: list of (target, value_rad, sd_rad, ignored)
    epoch: str = ""
    obs_epoch: str = ""         # epoch of observation (v1.2 metadata)
    source: str = ""            # provenance tag (<Source>, issue #317)
    msr_id: int | None = None   # database id of the set (RO row)
    db_cluster_id: int | None = None
    # per-direction database ids, parallel to `directions` (None = unset)
    direction_ids: list | None = None


def _ffld(line: str, layout: dict, name: str) -> float:
    """Float field; blank -> 0.0, leading-token parse for misaligned
    rows (simulation input files; atof parity)."""
    return _float_prefix(_fld(line, layout, name))


def _fld(line: str, layout: dict, name: str) -> str:
    loc, width = layout[name]
    if width == 0 or loc >= len(line):
        return ""
    return line[loc:loc + width].strip()


def _float_prefix(s: str) -> float:
    """atof-style parse: the longest leading numeric prefix of a
    (possibly misaligned) fixed-width field; 0.0 when the slice holds no
    number — matching the reference's C parsing when a column slice
    straddles neighbouring values or text."""
    import re as _re
    s = s.strip()
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:
        m = _re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
        return float(m.group(0)) if m else 0.0


def _parse_header(line: str):
    """!#=DNA <ver> <STN/MSR> <date> <frame> <epoch> <count> ..."""
    toks = line.split()
    if not toks or not toks[0].startswith("!#=DNA"):
        raise ValueError(f"not a DNA file header: {line!r}")
    version = toks[1] if len(toks) > 1 else "1.00"
    ftype = toks[2] if len(toks) > 2 else ""
    frame = toks[4] if len(toks) > 4 else ""
    epoch = toks[5] if len(toks) > 5 else ""
    count = int(toks[6]) if len(toks) > 6 else 0
    return version, ftype, frame, epoch, count


def _is_comment(line: str) -> bool:
    # Comments carry '*'/'#'/'!' in COLUMN 1.  An indented '*' is not a
    # comment: continuation rows of ignored measurements have a blank
    # type char and the ignore flag '*' in column 2 (' *   ...'), as
    # dnaimport's own exports write them (dsg-ignored.msr).
    if not line.strip():
        return True
    return line[0] in "*#!"


def read_dna_stn(path: str):
    """Read a DNA station file.  Returns (stations, frame, epoch)."""
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    version, _, frame, epoch, _ = _parse_header(lines[0])
    layout = _STN_LAYOUTS.get(version, _STN_LAYOUTS["3.01"])

    stations = []
    for line in lines[1:]:
        if _is_comment(line):
            continue
        name = _fld(line, layout, "name")
        if not name:
            continue
        stations.append(Station(
            name=name,
            constraints=_fld(line, layout, "const"),
            coord_type=_fld(line, layout, "type"),
            p1=float(_fld(line, layout, "e_phi_x")),
            p2=float(_fld(line, layout, "n_lam_y")),
            p3=float(_fld(line, layout, "ht_z")),
            hemi_zone=_fld(line, layout, "hemi_zo"),
            description=line[layout["desc"][0]:].strip()
            if len(line) > layout["desc"][0] else "",
        ))
    return stations, frame, epoch


class _MsrReader:
    def __init__(self, lines, layout, default_frame, default_epoch):
        self.lines = lines
        self.i = 0
        self.layout = layout
        self.frame = default_frame
        self.epoch = default_epoch

    def peek(self):
        while self.i < len(self.lines) and _is_comment(self.lines[self.i]):
            self.i += 1
        return self.lines[self.i] if self.i < len(self.lines) else None

    def next(self):
        line = self.peek()
        if line is not None:
            self.i += 1
        return line

    def f(self, line, name):
        return _fld(line, self.layout, name)

    def fv(self, line, name):
        """Float field; blank -> 0.0, leading-token parse (simulation
        input files carry station names without values and misaligned
        scale columns)."""
        return _float_prefix(_fld(line, self.layout, name))

    # -- value parsers ------------------------------------------------------

    def angular_rad(self, line) -> float:
        """d m s columns → packed DMS → radians (ParseAngularValue parity)."""
        d = self.f(line, "ang_d")
        m = int(self.f(line, "ang_m") or 0)
        s_raw = self.f(line, "ang_s") or "0"
        s = float(s_raw)
        packed = f"{d}.{m:02d}"
        if s < 10 and not s_raw.startswith("0"):
            packed += "0"
        packed += s_raw.replace(".", "")
        return float(dms_to_rad(float(packed)))

    def stddev(self, line) -> float:
        return _float_prefix(self.f(line, "stddev"))

    def scale(self, line, which) -> float:
        v = self.f(line, which)
        if not v:
            return 1.0
        try:
            return float(v)
        except ValueError:
            return _float_prefix(v)

    def dbids(self, line):
        """(msr_id, cluster_id) database ids, None when blank — the
        trailing columns the reference writes when database ids are set
        (WriteDNAMsr, dmw.msr_id_msr/msr_id_cluster)."""
        out = []
        for name in ("id_msr", "id_cluster"):
            v = self.f(line, name)
            try:
                out.append(int(v) if v else None)
            except ValueError:
                out.append(None)
        return tuple(out)


def read_dna_msr(path: str):
    """Read a DNA measurement file.

    Returns (records, frame, epoch) where records is a list of
    Measurement | GpsCluster | DirectionSet in file order.
    """
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    version, _, frame, epoch, _ = _parse_header(lines[0])
    layout = _MSR_LAYOUTS.get(version, _MSR_LAYOUTS["3.01"])
    rd = _MsrReader(lines[1:], layout, frame, epoch)

    records = []
    cluster_id = 0
    while True:
        line = rd.next()
        if line is None:
            break
        mtype = _fld(line, layout, "type").upper()
        if not mtype:
            continue
        ignore = _fld(line, layout, "ignore") == "*"

        if mtype in ("G", "X"):
            cluster_id += 1
            records.append(_read_gps_baselines(rd, line, mtype, ignore,
                                               cluster_id))
        elif mtype == "Y":
            cluster_id += 1
            records.append(_read_gps_points(rd, line, ignore, cluster_id))
        elif mtype == "D":
            rec = _read_directions(rd, line, ignore)
            if rec is not None:
                records.append(rec)
        elif mtype in ANGULAR_TYPES:
            records.append(_read_angular(rd, line, mtype, ignore))
        elif mtype in LINEAR_TYPES:
            records.append(_read_linear(rd, line, mtype, ignore))
        else:
            raise ValueError(f"unknown measurement type {mtype!r}: {line}")
    return records, frame, epoch


def _two_station(mtype):
    return mtype in set("BCEKLMSVZ") | {"G", "X"}


def _read_angular(rd: _MsrReader, line, mtype, ignore) -> Measurement:
    m = Measurement(mtype=mtype, ignore=ignore, first=rd.f(line, "inst"))
    if mtype == "A":
        m.second = rd.f(line, "targ1")
        m.third = rd.f(line, "targ2")
    elif mtype in "BKVZ":
        m.second = rd.f(line, "targ1")
    # I J P Q: single station
    m.value = rd.angular_rad(line)
    m.sd = rd.stddev(line) * _SEC_TO_RAD
    m.inst_height = _float_prefix(rd.f(line, "inst_ht"))
    m.targ_height = _float_prefix(rd.f(line, "targ_ht"))
    m.epoch = rd.f(line, "epoch") or rd.epoch
    m.obs_epoch = rd.f(line, "obs_epoch")
    m.msr_id = rd.dbids(line)[0]
    return m


def _read_linear(rd: _MsrReader, line, mtype, ignore) -> Measurement:
    m = Measurement(mtype=mtype, ignore=ignore, first=rd.f(line, "inst"))
    if mtype in "CELMS":
        m.second = rd.f(line, "targ1")
    # H and R: single-station heights
    m.value = rd.fv(line, "linear")
    m.sd = rd.stddev(line)
    m.inst_height = _float_prefix(rd.f(line, "inst_ht"))
    m.targ_height = _float_prefix(rd.f(line, "targ_ht"))
    m.epoch = rd.f(line, "epoch") or rd.epoch
    m.obs_epoch = rd.f(line, "obs_epoch")
    m.msr_id = rd.dbids(line)[0]
    return m


def _read_directions(rd: _MsrReader, line, ignore):
    ds = DirectionSet(
        ignore=ignore,
        first=rd.f(line, "inst"),
        ro=rd.f(line, "targ1"),
        ro_value=rd.angular_rad(line),
        ro_sd=rd.stddev(line) * _SEC_TO_RAD,
        epoch=rd.f(line, "epoch") or rd.epoch,
        obs_epoch=rd.f(line, "obs_epoch"),
    )
    ds.msr_id, ds.db_cluster_id = rd.dbids(line)
    count = int(rd.f(line, "targ2"))
    dir_ids = []
    for _ in range(count):
        dline = rd.next()
        d_ignore = _fld(dline, rd.layout, "ignore") == "*"
        ds.directions.append((
            rd.f(dline, "targ2") or rd.f(dline, "targ1") or rd.f(dline, "inst"),
            rd.angular_rad(dline),
            rd.stddev(dline) * _SEC_TO_RAD,
            d_ignore,
        ))
        dir_ids.append(rd.dbids(dline)[0])
    if any(i is not None for i in dir_ids):
        ds.direction_ids = dir_ids
    return ds


def _gps_scales_frame(rd, line):
    return (rd.scale(line, "vscale"), rd.scale(line, "pscale"),
            rd.scale(line, "lscale"), rd.scale(line, "hscale"),
            rd.f(line, "reframe") or rd.frame,
            rd.f(line, "epoch") or rd.epoch)


def _continuation_follows(rd: _MsrReader) -> bool:
    """True when the next line is a cluster continuation row (blank type
    char in column 1).  Simulation input files (--simulate) list cluster
    headers with no component rows."""
    nxt = rd.peek()
    return nxt is not None and len(nxt) > 1 and nxt[0] == " "


def _read_vcv_rows(rd: _MsrReader):
    """Read the three X/Y/Z component lines of one GPS obs.

    Returns (vec(3,), vcv(3,3) symmetric).  Simulation records without
    component rows yield zeros (values filled by --simulate)."""
    lay = rd.layout
    v = np.zeros(3)
    V = np.zeros((3, 3))
    if not _continuation_follows(rd):
        return v, np.eye(3)
    lx = rd.next()
    v[0] = _ffld(lx, lay, "gps")
    V[0, 0] = _ffld(lx, lay, "gps_vcv_1")
    ly = rd.next()
    v[1] = _ffld(ly, lay, "gps")
    V[0, 1] = V[1, 0] = _ffld(ly, lay, "gps_vcv_1")
    V[1, 1] = _ffld(ly, lay, "gps_vcv_2")
    lz = rd.next()
    v[2] = _ffld(lz, lay, "gps")
    V[0, 2] = V[2, 0] = _ffld(lz, lay, "gps_vcv_1")
    V[1, 2] = V[2, 1] = _ffld(lz, lay, "gps_vcv_2")
    V[2, 2] = _ffld(lz, lay, "gps_vcv_3")
    return v, V


def _read_cov_block(rd: _MsrReader):
    """Read one 3x3 cross-covariance block (three lines of three values)."""
    lay = rd.layout
    C = np.zeros((3, 3))
    if not _continuation_follows(rd):
        return C
    for r in range(3):
        ln = rd.next()
        C[r, 0] = _ffld(ln, lay, "gps_vcv_1")
        C[r, 1] = _ffld(ln, lay, "gps_vcv_2")
        C[r, 2] = _ffld(ln, lay, "gps_vcv_3")
    return C


def _read_gps_baselines(rd: _MsrReader, line, mtype, ignore, cid) -> GpsCluster:
    vscale, pscale, lscale, hscale, refframe, ep = _gps_scales_frame(rd, line)
    count = 1
    if mtype == "X":
        count = int(rd.f(line, "targ2"))
    cl = GpsCluster(mtype=mtype, ignore=ignore, coord_type="XYZ",
                    vscale=vscale, pscale=pscale, lscale=lscale,
                    hscale=hscale, epsg_frame=refframe, epoch=ep,
                    cluster_id=cid, obs_epoch=rd.f(line, "obs_epoch"))
    mid, cl.db_cluster_id = rd.dbids(line)
    first, second = rd.f(line, "inst"), rd.f(line, "targ1")
    for b in range(count):
        if b > 0:
            hline = rd.next()
            first, second = rd.f(hline, "inst"), rd.f(hline, "targ1")
            mid = rd.dbids(hline)[0]
        vec, vcv = _read_vcv_rows(rd)
        obs = GpsObs(first=first, second=second, vec=vec, vcv=vcv,
                     msr_id=mid)
        for _ in range(count - 1 - b):
            obs.covs.append(_read_cov_block(rd))
        cl.obs.append(obs)
    return cl


def _read_gps_points(rd: _MsrReader, line, ignore, cid) -> GpsCluster:
    vscale, pscale, lscale, hscale, refframe, ep = _gps_scales_frame(rd, line)
    coord_type = rd.f(line, "targ1") or "XYZ"
    count = int(rd.f(line, "targ2") or 1)
    cl = GpsCluster(mtype="Y", ignore=ignore, coord_type=coord_type,
                    vscale=vscale, pscale=pscale, lscale=lscale,
                    hscale=hscale, epsg_frame=refframe, epoch=ep,
                    cluster_id=cid, obs_epoch=rd.f(line, "obs_epoch"))
    mid, cl.db_cluster_id = rd.dbids(line)
    first = rd.f(line, "inst")
    for p in range(count):
        if p > 0:
            hline = rd.next()
            first = rd.f(hline, "inst")
            mid = rd.dbids(hline)[0]
        vec, vcv = _read_vcv_rows(rd)
        if coord_type.upper() in ("LLH", "LLH".lower(), "LLh"):
            # lat/lon given in packed DMS; convert to radians
            vec = np.array([float(dms_to_rad(vec[0])),
                            float(dms_to_rad(vec[1])), vec[2]])
        obs = GpsObs(first=first, second="", vec=vec, vcv=vcv,
                     msr_id=mid)
        for _ in range(count - 1 - p):
            obs.covs.append(_read_cov_block(rd))
        cl.obs.append(obs)
    return cl
