"""Import integrity checks (--test-integrity).

Validates the parsed network the way the reference's TestIntegrity...
routines validate the binary files: unresolved station references,
non-positive-definite apriori VCVs, inconsistent cluster covariance
counts, duplicate station names, and zero/negative standard deviations.
Returns a list of human-readable problem strings (empty = clean).
"""

from __future__ import annotations

import numpy as np

from ..io_formats.dna import DirectionSet, GpsCluster, Measurement


def check_integrity(stations: list, measurements: list) -> list:
    problems: list[str] = []
    names = [s.name for s in stations]
    nameset = set(names)
    if len(nameset) != len(names):
        seen, dups = set(), set()
        for n in names:
            if n in seen:
                dups.add(n)
            seen.add(n)
        problems.append(f"duplicate station names: {sorted(dups)[:10]}")

    def _chk(name, where):
        if name and name not in nameset:
            problems.append(f"{where}: unknown station '{name}'")

    for m, rec in enumerate(measurements):
        tag = f"measurement {m}"
        if isinstance(rec, GpsCluster):
            tag += f" ({rec.mtype} cluster)"
            nobs = len(rec.obs)
            for k, ob in enumerate(rec.obs):
                _chk(ob.first, tag)
                if rec.mtype in ("G", "X"):
                    _chk(ob.second, tag)
                vcv = np.asarray(ob.vcv, dtype=float)
                try:
                    ev = np.linalg.eigvalsh(0.5 * (vcv + vcv.T))
                    if ev.min() <= 0:
                        problems.append(
                            f"{tag} obs {k}: apriori VCV not positive "
                            f"definite (min eig {ev.min():.3e})")
                except np.linalg.LinAlgError:
                    problems.append(f"{tag} obs {k}: invalid VCV")
                want = nobs - k - 1
                if len(ob.covs) not in (0, want):
                    problems.append(
                        f"{tag} obs {k}: covariance block count "
                        f"{len(ob.covs)} != {want}")
        elif isinstance(rec, DirectionSet):
            tag += " (D set)"
            _chk(rec.first, tag)
            _chk(rec.ro, tag)
            if rec.ro_sd <= 0:
                problems.append(f"{tag}: non-positive RO std dev")
            for (t, _v, sd, ign) in rec.directions:
                _chk(t, tag)
                if sd <= 0 and not ign:
                    problems.append(f"{tag}: non-positive std dev to {t}")
        elif isinstance(rec, Measurement):
            tag += f" ({rec.mtype})"
            for n in (rec.first, rec.second, rec.third):
                _chk(n, tag)
            if rec.sd <= 0 and not rec.ignore:
                problems.append(f"{tag}: non-positive std dev")
    return problems
