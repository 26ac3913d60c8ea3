"""WGS84-ensemble reference frame substitutions.

'WGS84' names an ensemble of realisations; transformations require the
epoch-appropriate ITRF equivalent.  Windows follow NGA realisation dates
(as tabulated in the reference's dnaframesubstitutions.hpp).
"""

from __future__ import annotations

import datetime as _dt

from .datums import canonical_frame, parse_epoch

# (frame, from_date, to_date_or_None, substitute)
_SUBSTITUTIONS = [
    ("WGS84_TRANSIT", "01.01.1987", "01.01.1994", "ITRF1990"),
    ("WGS84_G730", "02.01.1994", "28.09.1996", "ITRF1991"),
    ("WGS84_G873", "29.09.1996", "19.01.2002", "ITRF1994"),
    ("WGS84_G1150", "20.01.2002", "06.05.2012", "ITRF2000"),
    ("WGS84_G1674", "07.05.2012", "15.10.2013", "ITRF2008"),
    ("WGS84_G1762", "16.10.2013", "02.01.2021", "ITRF2008"),
    ("WGS84_G2139", "02.01.2021", None, "ITRF2014"),
]

# epoch-windowed substitution for the bare ensemble name
_ENSEMBLE_WINDOWS = [
    (parse_epoch(f), parse_epoch(t) if t else None, sub)
    for (_, f, t, sub) in _SUBSTITUTIONS
]

_NAMED = {canonical_frame(name): sub for (name, _, _, sub) in _SUBSTITUTIONS}


def substitute_frame(frame: str, epoch: str = "") -> str:
    """Resolve a WGS84 (ensemble or realisation) frame to its ITRF
    substitute.  Non-WGS84 frames pass through unchanged.

    The bare 'WGS84' ensemble requires an epoch (reference behaviour:
    REFTRAN_WGS84_TRANS_UNSUPPORTED without one)."""
    cf = canonical_frame(frame)
    if cf in _NAMED:
        return _NAMED[cf]
    if cf == "WGS84":
        if not epoch:
            raise ValueError(
                "transforming from the WGS 84 ensemble requires an epoch "
                "to select the appropriate realisation")
        d = parse_epoch(epoch)
        for (f, t, sub) in _ENSEMBLE_WINDOWS:
            if d >= f and (t is None or d <= t):
                return sub
        return "ITRF2014"
    return cf
