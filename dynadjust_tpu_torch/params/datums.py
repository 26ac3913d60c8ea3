"""Datum registry: names, EPSG codes, static/dynamic classification, epochs.

Parity reference: dnadatum.hpp and dnaepsg.hpp (EPSG registry) of
DynAdjust — here reduced to the data actually needed for frame
transformation and reporting.  A copy of the JAX package's
``params/datums.py``, with the full EPSG registry (``params/epsg.py``)
folded into the alias, code and epoch tables.
"""

from dataclasses import dataclass
import calendar
import datetime as _dt

from .ellipsoids import Ellipsoid, ellipsoid_for_datum

# Frames with time-dependent coordinates (ITRF-style).  Static frames are
# plate-fixed national datums.
_DYNAMIC_FRAMES = {
    "ITRF1988", "ITRF1989", "ITRF1990", "ITRF1991", "ITRF1992", "ITRF1993",
    "ITRF1994", "ITRF1996", "ITRF1997", "ITRF2000", "ITRF2005", "ITRF2008",
    "ITRF2014", "ITRF2020",
    "WGS84", "WGS84_TRANSIT", "WGS84_G730", "WGS84_G873", "WGS84_G1150",
    "WGS84_G1674", "WGS84_G1762", "WGS84_G2139",
}

# Alternate spellings → canonical names
_ALIASES = {
    "ITRF88": "ITRF1988", "ITRF89": "ITRF1989", "ITRF90": "ITRF1990",
    "ITRF91": "ITRF1991", "ITRF92": "ITRF1992", "ITRF93": "ITRF1993",
    "ITRF94": "ITRF1994", "ITRF96": "ITRF1996", "ITRF97": "ITRF1997",
    "WGS 84": "WGS84",
}

# EPSG codes (3D cartesian variants) for reporting; from dnaepsg.hpp.
_EPSG = {
    "GDA2020": 7842, "GDA94": 4938, "WGS84": 4978,
    "ITRF1988": 4910, "ITRF1989": 4911, "ITRF1990": 4912, "ITRF1991": 4913,
    "ITRF1992": 4914, "ITRF1993": 4915, "ITRF1994": 4916, "ITRF1996": 4917,
    "ITRF1997": 4918, "ITRF2000": 4919, "ITRF2005": 4896, "ITRF2008": 5332,
    "ITRF2014": 7789, "ITRF2020": 9988,
    "AGD66": 4202, "AGD84": 4203,
}

# Default reference epochs for static datums (decimal years)
_STATIC_REFERENCE_EPOCH = {
    "GDA2020": 2020.0,
    "GDA94": 1994.0,
}


def _internal_name(ref_label: str) -> str:
    """Reference-style label -> this module's canonical spelling
    ('WGS84 (G730)' -> 'WGS84_G730'; NAD83/SIRGAS keep their label)."""
    key = ref_label.strip().upper()
    if key.startswith("WGS84 (") and key.endswith(")"):
        inner = key[7:-1].strip()
        return "WGS84" if inner == "ENSEMBLE" else f"WGS84_{inner}"
    return key


# fold the full EPSG registry (params/epsg.py — every frame family the
# reference's dnaepsg.hpp accepts: NAD83(CSRS) v2-v8, SIRGAS, Yacare,
# WGS84 realisations) into the alias / code / epoch tables
from . import epsg as _epsg_registry

for _fr in _epsg_registry.FRAMES:
    _canon = _internal_name(_fr.name)
    for _al in _fr.aliases:
        _ALIASES.setdefault(_al.upper(), _canon)
    _ALIASES.setdefault(_fr.name.upper(), _canon)
    _EPSG.setdefault(_canon,
                     _fr.code_xyz if _fr.code_xyz is not None else _fr.code)
    if _fr.static and _fr.epoch and _canon not in _STATIC_REFERENCE_EPOCH:
        _d, _m, _y = _fr.epoch.split(".")
        _days = 366.0 if calendar.isleap(int(_y)) else 365.0
        _doy = _dt.date(int(_y), int(_m), int(_d)).timetuple().tm_yday
        _STATIC_REFERENCE_EPOCH[_canon] = round(
            int(_y) + (_doy - 0.5) / _days, 4)


def canonical_frame(name: str) -> str:
    key = name.strip().upper()
    key = _ALIASES.get(key, key)
    # realisation spellings: "WGS84 (G730)" -> WGS84_G730,
    # "WGS84 (ensemble)" -> WGS84 (the reference's frame labels,
    # imp-frame-misc-18..27 CI tests)
    if key.startswith("WGS84 (") and key.endswith(")"):
        inner = key[7:-1].strip()
        key = "WGS84" if inner == "ENSEMBLE" else f"WGS84_{inner}"
    return key


# every frame label the reference recognises (dnaepsg.hpp registry);
# used to reject unknown -r labels (import-no-frame CI test)
KNOWN_FRAMES = (_DYNAMIC_FRAMES | {"GDA94", "GDA2020", "AGD66", "AGD84"}
                | {_internal_name(f.name) for f in _epsg_registry.FRAMES})


def frame_from_epsg_code(code) -> str:
    """Any EPSG code the reference accepts (geographic 2D/3D or
    geocentric) -> this module's canonical frame name; '' if unknown."""
    fr = _epsg_registry.frame_for_code(code) \
        if str(code).strip().lstrip("-").isdigit() else None
    return _internal_name(fr.name) if fr is not None else ""


def is_known_frame(name: str) -> bool:
    return canonical_frame(name) in KNOWN_FRAMES


def is_dynamic_frame(name: str) -> bool:
    return canonical_frame(name) in _DYNAMIC_FRAMES


def parse_epoch(epoch: str) -> _dt.date | None:
    """Parse a dd.mm.yyyy epoch string (reference format)."""
    epoch = epoch.strip()
    if not epoch:
        return None
    if epoch.lower() == "today":
        # the reference resolves 'today' wherever an epoch is accepted
        # (dnaimportwrapper.cpp:301)
        return _dt.date.today()
    for fmt in ("%d.%m.%Y", "%d-%m-%Y", "%d/%m/%Y", "%Y-%m-%d"):
        try:
            return _dt.datetime.strptime(epoch, fmt).date()
        except ValueError:
            continue
    # decimal year?
    try:
        y = float(epoch)
        year = int(y)
        days = 366 if calendar.isleap(year) else 365
        doy = (y - year) * days + 0.5
        return _dt.date(year, 1, 1) + _dt.timedelta(days=max(0.0, doy - 1))
    except ValueError:
        raise ValueError(f"unparseable epoch: {epoch!r}")


def decimal_year(d: _dt.date) -> float:
    """Decimal year: year + (doy - 0.5)/days_in_year.

    Parity: referenceEpoch/yearFraction,
    include/functions/dnatemplatedatetimefuncs.hpp:290-328.
    """
    days = 366.0 if calendar.isleap(d.year) else 365.0
    doy = d.timetuple().tm_yday
    return d.year + (doy - 0.5) / days


@dataclass(frozen=True)
class Datum:
    frame: str                  # canonical frame name
    epoch: _dt.date | None = None   # epoch of the coordinates (dynamic frames)

    @staticmethod
    def from_name(frame: str, epoch: str = "") -> "Datum":
        frame = canonical_frame(frame)
        ep = parse_epoch(epoch) if epoch else None
        if ep is None and not is_dynamic_frame(frame):
            # static datums pin their reference epoch
            ref = _STATIC_REFERENCE_EPOCH.get(frame)
            if ref is not None:
                ep = parse_epoch(str(ref))
        return Datum(frame, ep)

    @property
    def dynamic(self) -> bool:
        return is_dynamic_frame(self.frame)

    @property
    def ellipsoid(self) -> Ellipsoid:
        return ellipsoid_for_datum(self.frame)

    @property
    def epsg(self) -> int:
        return _EPSG.get(self.frame, 0)

    @property
    def epoch_decimal(self) -> float | None:
        if self.frame in _STATIC_REFERENCE_EPOCH:
            return _STATIC_REFERENCE_EPOCH[self.frame]
        return decimal_year(self.epoch) if self.epoch else None

    def same_as(self, other: "Datum") -> bool:
        if self.frame != other.frame:
            return False
        if self.dynamic:
            return self.epoch == other.epoch
        return True


def datum_from_name(frame: str, epoch: str = "") -> Datum:
    return Datum.from_name(frame, epoch)
