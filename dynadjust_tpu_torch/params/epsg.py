"""Full EPSG datum registry — table-driven parity with the reference's
dnaepsg.hpp / dnaconsts-datums.hpp (code constants verified against
DynAdjust's include/parameters/dnaconsts-datums.hpp:34-211;
lookup semantics against dnaepsg.hpp: epsgCodeFromName:117,
epsgStringFromName:241, isEpsgDatumStatic:377,
referenceepochFromEpsgCode:611, datumFromEpsgCode:750,
isEpsgWGS84Ensemble:1002).

Every frame row carries all its EPSG variants — geographic 3D
(LatLonEht), geographic 2D (LatLon) and geocentric (XYZ) — so any code
the reference accepts resolves here too.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EpsgFrame:
    name: str                   # canonical frame label (reference *_s)
    code: int                   # geographic 3D (LatLonEht) — *_i
    code_xyz: int | None        # geocentric — *_i_xyz
    code_2d: int | None         # geographic 2D — *_i_2d
    epoch: str                  # reference epoch, dd.mm.yyyy
    static: bool
    aliases: tuple = ()
    canonical_code: int | None = None   # epsgStringFromName result
                                        # (defaults to code_xyz or code)


def _f(name, code, xyz, d2, epoch, static, aliases=(), canonical=None):
    return EpsgFrame(name, code, xyz, d2, epoch, static, tuple(aliases),
                     canonical)


def _nad83_aliases(v):
    return (f"NAD83 (CSRS) v{v}", f"NAD83(CSRS)V{v}", f"NAD83 (CSRS) V{v}")


FRAMES = [
    _f("AGD66", 4202, None, None, "01.01.1966", True),
    _f("AGD84", 4203, None, None, "01.01.1984", True),
    _f("GDA94", 4939, 4938, 4283, "01.01.1994", True),
    _f("GDA2020", 7843, 7842, 7844, "01.01.2020", True),
    # ITRF: dynamic; epsg strings provide the XYZ definition only
    _f("ITRF2020", 9989, 9988, None, "01.01.2020", False),
    _f("ITRF2014", 7912, 7789, None, "01.01.2010", False),
    _f("ITRF2008", 7911, 5332, None, "01.01.2008", False),
    _f("ITRF2005", 7910, 4896, None, "01.01.2005", False),
    _f("ITRF2000", 7909, 4919, None, "01.01.2000", False),
    _f("ITRF1997", 7908, 4918, None, "01.01.1997", False, ["ITRF97"]),
    _f("ITRF1996", 7907, 4917, None, "01.01.1996", False, ["ITRF96"]),
    _f("ITRF1994", 7906, 4916, None, "01.01.1994", False, ["ITRF94"]),
    _f("ITRF1993", 7905, 4915, None, "01.01.1993", False, ["ITRF93"]),
    _f("ITRF1992", 7904, 4914, None, "01.01.1992", False, ["ITRF92"]),
    _f("ITRF1991", 7903, 4913, None, "01.01.1991", False, ["ITRF91"]),
    _f("ITRF1990", 7902, 4912, None, "01.01.1990", False, ["ITRF90"]),
    _f("ITRF1989", 7901, 4911, None, "01.01.1989", False, ["ITRF89"]),
    _f("ITRF1988", 7900, 4910, None, "01.01.1988", False, ["ITRF88"]),
    # WGS84 ensemble (static per the reference's classification) and
    # its dynamic realisations; WGS84 epochs are in-use start dates
    _f("WGS84", 4979, 4978, None, "", True,
       ["WGS 84", "WGS84 (ensemble)"]),
    _f("WGS84 (transit)", 7816, 7815, None, "01.01.1987", False,
       ["WGS 84 (transit)"]),
    _f("WGS84 (G730)", 7657, 7656, None, "02.01.1994", False,
       ["WGS 84 (G730)"]),
    _f("WGS84 (G873)", 7659, 7658, None, "29.09.1996", False,
       ["WGS 84 (G873)"]),
    _f("WGS84 (G1150)", 7661, 7660, None, "20.01.2002", False,
       ["WGS 84 (G1150)"]),
    _f("WGS84 (G1674)", 7663, 7662, None, "07.05.2012", False,
       ["WGS 84 (G1674)"]),
    _f("WGS84 (G1762)", 7665, 7664, None, "16.10.2013", False,
       ["WGS 84 (G1762)"]),
    _f("WGS84 (G2139)", 9754, 9753, None, "03.01.2021", False,
       ["WGS 84 (G2139)"]),
    # NAD83(CSRS) ensemble + versioned realisations (static)
    _f("NAD83(CSRS)", 4955, 4954, None, "01.01.2010", True,
       ["NAD83 (CSRS)"]),
    _f("NAD83(CSRS)v2", 8235, 8233, None, "01.01.1997", True,
       _nad83_aliases(2)),
    _f("NAD83(CSRS)v3", 8239, 8238, None, "01.01.1997", True,
       _nad83_aliases(3)),
    _f("NAD83(CSRS)v4", 8244, 8242, None, "01.01.2002", True,
       _nad83_aliases(4)),
    _f("NAD83(CSRS)v5", 8248, 8247, None, "01.01.2006", True,
       _nad83_aliases(5)),
    _f("NAD83(CSRS)v6", 8251, 8250, None, "01.01.2010", True,
       _nad83_aliases(6)),
    _f("NAD83(CSRS)v7", 8254, 8253, None, "01.01.2010", True,
       _nad83_aliases(7)),
    _f("NAD83(CSRS)v8", 10413, 10412, None, "01.01.2010", True,
       _nad83_aliases(8)),
    # SIRGAS (South America) — static classification per the reference
    _f("Yacare (ROU-USAMS)", 4309, None, None, "01.01.1963", True),
    _f("SIRGAS-ROU98", 5380, 5379, None, "03.07.1995", True,
       ["SIRGAS ROU98"]),
    _f("SIRGAS 1995", 4975, 4974, None, "01.04.1995", True,
       ["SIRGAS1995", "SIRGAS95"]),
    _f("SIRGAS 2000", 4989, 4988, None, "01.04.2000", True,
       ["SIRGAS2000"]),
]

# WGS84 ensemble member code (6326) accepted alongside 4978/4979
WGS84_ENSEMBLE_CODE = 6326

# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

_BY_NAME: dict[str, EpsgFrame] = {}
_BY_CODE: dict[int, EpsgFrame] = {}
for fr in FRAMES:
    _BY_NAME[fr.name.upper()] = fr
    for a in fr.aliases:
        _BY_NAME[a.upper()] = fr
    for c in (fr.code, fr.code_xyz, fr.code_2d):
        if c is not None:
            _BY_CODE[c] = fr
_BY_CODE[WGS84_ENSEMBLE_CODE] = _BY_NAME["WGS84"]


def frame_for_name(name: str) -> EpsgFrame | None:
    return _BY_NAME.get(name.strip().upper())


def frame_for_code(code: int) -> EpsgFrame | None:
    return _BY_CODE.get(int(code))


def epsg_code_from_name(name: str) -> int:
    """The reference's epsgCodeFromName: label -> XYZ code (3D code when
    no geocentric variant exists).  Raises ValueError on unknown."""
    fr = frame_for_name(name)
    if fr is None:
        raise ValueError(f"epsgCodeFromName: {name!r} is not a supported "
                         f"reference frame label")
    return fr.code_xyz if fr.code_xyz is not None else fr.code


def epsg_string_from_name(name: str) -> str:
    """epsgStringFromName parity: label -> geocentric code string."""
    return str(epsg_code_from_name(name))


def datum_from_epsg_code(code) -> str:
    """datumFromEpsgCode parity: ANY accepted variant code -> label."""
    fr = frame_for_code(int(code))
    if fr is None:
        raise ValueError(f"datumFromEpsgCode: EPSG code {code!r} is not "
                         f"a supported EPSG code")
    return fr.name


def is_epsg_datum_static(code) -> bool:
    fr = frame_for_code(int(code))
    if fr is None:
        raise ValueError(f"isEpsgDatumStatic: EPSG code {code!r} is not "
                         f"a supported EPSG code")
    return fr.static


def reference_epoch_from_epsg_code(code) -> str:
    fr = frame_for_code(int(code))
    if fr is None:
        raise ValueError(f"referenceepochFromEpsgCode: EPSG code "
                         f"{code!r} is not a supported EPSG code")
    return fr.epoch


def is_epsg_wgs84_ensemble(code) -> bool:
    return int(code) in (4978, 4979, WGS84_ENSEMBLE_CODE)


def all_accepted_codes() -> list[int]:
    return sorted(_BY_CODE.keys())


def all_accepted_names() -> list[str]:
    return sorted(_BY_NAME.keys())
