"""In-memory network model — the analogue of the reference's binary
station/measurement files (.bst/.bms) plus association lists.

Stations are held as a columnar struct-of-arrays; measurements as parsed
record objects carrying their own frame/epoch (mutated by reftran, consumed
by adjust).

Parity reference: station semantics from
DynAdjust dynadjust/include/config/dnatypes-structs.hpp:270-323
(station_t: current coordinates always geographic + ellipsoidal height).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geodesy.conversions import dms_to_rad, cart_to_geo, geo_to_cart
from ..io_formats.dna import Station, Measurement, GpsCluster, DirectionSet
from ..params.datums import Datum
from ..params.ellipsoids import Ellipsoid

ORTHOMETRIC = 1
ELLIPSOIDAL = 0


@dataclass
class NetworkData:
    """The complete network state shared by geoid/reftran/segment/adjust."""
    names: list
    name_to_idx: dict
    constraints: list               # per-station 3-char codes
    coord_types: list               # as supplied (LLH/LLh/XYZ/UTM)
    lat: np.ndarray                 # current latitude (rad)
    lon: np.ndarray                 # current longitude (rad)
    height: np.ndarray              # current ellipsoidal height (m)
    initial_height: np.ndarray
    height_ref: np.ndarray          # ORTHOMETRIC / ELLIPSOIDAL per station
    geoid_sep: np.ndarray
    meridian_def: np.ndarray        # rad
    vertical_def: np.ndarray        # rad
    descriptions: list
    measurements: list              # Measurement | GpsCluster | DirectionSet
    frame: str
    epoch: str
    datum: Datum

    # progress flags, mirroring binary_file_meta_t reduced/reftran/geoid
    geoid_applied: bool = False
    geoid_file: str = ""        # NTv2 grid used (printed in .adj header)
    reftran_applied: bool = False
    # per-station source frame/epoch ("" = the project frame) — set by
    # SINEX import; reftran transforms each (frame, epoch) group
    # separately (reference: per-station epsgCode/epoch in station_t)
    station_frames: list = None
    station_epochs: list = None
    # original input-file position of each station (fileOrder analogue;
    # used by --sort-stn-orig-order)
    station_file_order: list = None
    # project-level epoch of observation (--observation-epoch; recorded
    # like binary_file_meta_t.observation_epoch, dnainterop.cpp:218)
    observation_epoch: str = ""

    @property
    def nstations(self) -> int:
        return len(self.names)

    def station_xyz(self) -> np.ndarray:
        x, y, z = geo_to_cart(self.lat, self.lon, self.height,
                              self.datum.ellipsoid)
        return np.stack([x, y, z], axis=-1)

    def station_index(self, name: str) -> int:
        return self.name_to_idx[name]


def build_network(stations: list, measurements: list, frame: str,
                  epoch: str) -> NetworkData:
    """Build a NetworkData from parsed DNA records (the import step)."""
    datum = Datum.from_name(frame, epoch)
    ell = datum.ellipsoid
    n = len(stations)
    lat = np.zeros(n)
    lon = np.zeros(n)
    hgt = np.zeros(n)
    init_h = np.zeros(n)
    height_ref = np.zeros(n, dtype=np.int32)
    names, consts, ctypes, descs = [], [], [], []

    for i, s in enumerate(stations):
        names.append(s.name)
        consts.append((s.constraints or "FFF").upper())
        ct = s.coord_type or "LLH"
        ctypes.append(ct)
        descs.append(s.description)
        if ct in ("LLH", "LLh"):
            lat[i] = float(dms_to_rad(s.p1))
            lon[i] = float(dms_to_rad(s.p2))
            hgt[i] = s.p3
            init_h[i] = s.p3
            height_ref[i] = ORTHOMETRIC if ct == "LLH" else ELLIPSOIDAL
        elif ct == "LLH-G":          # decimal degrees, orthometric height
            lat[i] = np.radians(s.p1)
            lon[i] = np.radians(s.p2)
            hgt[i] = s.p3
            init_h[i] = s.p3
            height_ref[i] = ORTHOMETRIC
        elif ct == "XYZ":
            la, lo, h = cart_to_geo(s.p1, s.p2, s.p3, ell)
            lat[i], lon[i], hgt[i] = float(la), float(lo), float(h)
            init_h[i] = hgt[i]
            height_ref[i] = ELLIPSOIDAL
        elif ct == "UTM":
            from ..geodesy.projections import grid_to_geo
            zone = int(s.hemi_zone.lstrip("SNsn") or 0)
            la, lo = grid_to_geo(s.p1, s.p2, zone, ell)
            lat[i], lon[i] = la, lo
            hgt[i] = s.p3
            init_h[i] = s.p3
            height_ref[i] = ORTHOMETRIC
        else:
            raise ValueError(f"unsupported station coordinate type {ct!r}")

    name_to_idx = {nm: i for i, nm in enumerate(names)}
    sframes = [getattr(s, "frame", "") or "" for s in stations]
    sepochs = [getattr(s, "epoch", "") or "" for s in stations]
    if not any(sframes):
        sframes = sepochs = None
    return NetworkData(
        names=names, name_to_idx=name_to_idx, constraints=consts,
        coord_types=ctypes, lat=lat, lon=lon, height=hgt,
        initial_height=init_h, height_ref=height_ref,
        geoid_sep=np.zeros(n), meridian_def=np.zeros(n),
        vertical_def=np.zeros(n), descriptions=descs,
        measurements=measurements, frame=frame, epoch=epoch, datum=datum,
        station_frames=sframes, station_epochs=sepochs)


def normalise_observation_epoch(value: str) -> str:
    """Normalise a --observation-epoch value to dd.mm.yyyy
    (dnaimportwrapper.cpp:321-339): 'today' -> today's date; a bare year
    gains '01.01.'; anything else must parse as dd.mm.yyyy."""
    import datetime
    v = (value or "").strip()
    if not v:
        return ""
    if v.lower() == "today":
        return datetime.date.today().strftime("%d.%m.%Y")
    if "." not in v:
        v = "01.01." + v
    try:
        datetime.datetime.strptime(v, "%d.%m.%Y")
    except ValueError:
        raise ValueError(f"Cannot parse observation epoch '{value}'")
    return v


def apply_observation_epoch(measurements: list, obs_epoch: str) -> int:
    """Apply the project-level observation epoch to every measurement
    whose epoch of observation is not explicitly set — empty or equal to
    the record's reference-frame epoch, the auto-default
    (ApplyProjectObservationEpoch, dnainterop.cpp:223-265).  Returns the
    number of records updated."""
    if not obs_epoch:
        return 0
    n = 0
    for rec in measurements:
        cur = getattr(rec, "obs_epoch", "")
        if not cur or cur == getattr(rec, "epoch", ""):
            rec.obs_epoch = obs_epoch
            n += 1
    return n


def _record_from_reference(rec):
    """The same measurement record as this package's dataclass (matched
    by class name; GNSS clusters convert their observations too)."""
    from dataclasses import fields
    from ..io_formats import dna
    cls = getattr(dna, type(rec).__name__)
    vals = {f.name: getattr(rec, f.name) for f in fields(cls)}
    if cls is dna.GpsCluster:
        vals["obs"] = [_record_from_reference(o) for o in rec.obs]
    return cls(**vals)


def from_reference(net, seg=None):
    """This package's (NetworkData, Segmentation) from another package's
    network and segmentation objects of the same layout, read attribute
    by attribute (records are rebuilt as this package's record types).
    Lets one network run through two adjustment engines side by side."""
    from ..segment import Segmentation
    d = net.datum
    fields = {k: getattr(net, k) for k in NetworkData.__dataclass_fields__
              if k != "datum"}
    for k in ("lat", "lon", "height", "initial_height", "height_ref",
              "geoid_sep", "meridian_def", "vertical_def"):
        fields[k] = np.array(fields[k], copy=True)
    for k in ("names", "constraints", "coord_types", "descriptions",
              "measurements"):
        fields[k] = list(fields[k])
    fields["name_to_idx"] = dict(fields["name_to_idx"])
    fields["measurements"] = [_record_from_reference(r)
                              for r in fields["measurements"]]
    out = NetworkData(datum=Datum(d.frame, d.epoch), **fields)
    if seg is None:
        return out
    s = Segmentation(
        inner_stations=[list(x) for x in seg.inner_stations],
        junction_stations=[list(x) for x in seg.junction_stations],
        measurements=[list(x) for x in seg.measurements],
        networks=list(seg.networks))
    return out, s
