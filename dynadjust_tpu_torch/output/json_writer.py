"""JSONL adjustment report siblings (--output-json).

One JSON object per line: a DnaAdjustmentReport header, then DnaStation
records (adjusted coordinates, uncertainty, corrections) and
DnaMeasurement records (adjusted measurement statistics).

Field names follow the reference's DynAdjustJsonPrinter
(dnaadjust/dnaadjust_json_printer.cpp: HeaderRecord :56,
StationIdentity :70, StationCoordLLH :123, UncertaintyBlockFromCart
:134, CorrectionsBlockFromContext :196) so downstream consumers of the
reference's .jsonl reports can ingest these directly.
"""

from __future__ import annotations

import json

import numpy as np

from ..geodesy.conversions import rad_to_dms
from ..geodesy.local_frame import rotation_cart_to_local
from .uncertainty import error_ellipse, positional_uncertainty


def _header(net, report: str) -> dict:
    return {"DnaAdjustmentReport": {
        "type": "Adjustment",
        "report": report,
        "software": "dynadjust_tpu_torch 0.1.0",
        "referenceframe": net.frame,
        "epoch": net.epoch,
    }}


def _station_record(net, res, i, original_xyz=None) -> dict:
    Vc = res.station_cov(i)
    R = rotation_cart_to_local(res.lat[i], res.lon[i])
    Vl = R @ Vc @ R.T
    a, b, az = error_ellipse(Vl)
    hz, vt = positional_uncertainty(a, b, float(np.sqrt(max(Vl[2, 2],
                                                            0.0))))
    s = {
        "Name": net.names[i],
        "Constraints": net.constraints[i],
        "Type": "LLH",
        "StationCoord": {
            "Name": net.names[i],
            "XAxis": float(rad_to_dms(res.lat[i])),
            "YAxis": float(rad_to_dms(res.lon[i])),
            "Height": float(res.height[i]),
        },
        "Adjusted": {
            "X": float(res.xyz[i][0]),
            "Y": float(res.xyz[i][1]),
            "Z": float(res.xyz[i][2]),
            "Lat": float(rad_to_dms(res.lat[i])),
            "Lon": float(rad_to_dms(res.lon[i])),
            "Height": float(res.height[i]),
        },
        "Uncertainty": {
            "SE": float(np.sqrt(max(Vl[0, 0], 0.0))),
            "SN": float(np.sqrt(max(Vl[1, 1], 0.0))),
            "SU": float(np.sqrt(max(Vl[2, 2], 0.0))),
            "SemiMajor": float(a),
            "SemiMinor": float(b),
            "Orientation": float(az),
            "HzPosU": float(hz),
            "VtPosU": float(vt),
            "VarianceLocal": [[float(v) for v in row] for row in Vl],
            "VarianceCart": [[float(v) for v in row] for row in Vc],
        },
    }
    if net.descriptions[i]:
        s["Description"] = net.descriptions[i]
    if original_xyz is not None:
        d = res.xyz[i] - original_xyz[i]
        e = R @ d
        s["Corrections"] = {"dE": float(e[0]), "dN": float(e[1]),
                            "dUp": float(e[2])}
    return {"DnaStation": s}


def _measurement_record(net, r) -> dict:
    rec = (net.measurements[r.rec_idx]
           if 0 <= r.rec_idx < len(net.measurements) else None)
    obs_epoch = getattr(rec, "obs_epoch", "") if rec is not None else ""
    m = {
        "Type": r.mtype,
        "Cardinal": r.cardinal.strip(),
        "First": net.names[r.s1] if r.s1 >= 0 else "",
        "Second": net.names[r.s2] if r.s2 >= 0 else "",
        "Third": net.names[r.s3] if r.s3 >= 0 else "",
        "Measured": float(r.pre_adj_meas),
        "Adjusted": float(r.adjusted),
        "Correction": float(r.correction),
        "MeasSD": float(np.sqrt(max(r.meas_var, 0.0))),
        "AdjSD": float(np.sqrt(max(r.adj_prec, 0.0))),
        "CorrSD": float(np.sqrt(max(r.resid_prec, 0.0))),
        "NStat": float(r.nstat),
        "TStat": float(r.tstat),
        "PelzerRel": float(r.pelzer),
        "Outlier": bool(r.outlier),
        "Ignored": bool(r.ignore),
    }
    # EpochOfObservation only when explicitly set (AddObservationEpoch,
    # dnaadjust_json_printer.cpp:232-236)
    if obs_epoch.strip():
        m["EpochOfObservation"] = obs_epoch.strip()
    return {"DnaMeasurement": m}


def write_adj_jsonl(path: str, net, res, original_xyz=None,
                    include_measurements: bool = True) -> int:
    """Write the adjustment report as JSONL; returns record count."""
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps(_header(net, "adj")) + "\n")
        for i in range(net.nstations):
            f.write(json.dumps(_station_record(net, res, i,
                                               original_xyz)) + "\n")
            n += 1
        if include_measurements:
            for r in res.msr_stats:
                f.write(json.dumps(_measurement_record(net, r)) + "\n")
                n += 1
        f.write(json.dumps({"DnaStatistics": {
            "Iterations": res.iterations,
            "ChiSquared": float(res.chi_squared),
            "SigmaZero": float(res.sigma_zero),
            "DegreesOfFreedom": int(res.degrees_of_freedom),
            "Measurements": int(res.measurement_count),
            "Unknowns": int(res.unknown_count),
            "PassFail": res.pass_fail,
            "GlobalPelzer": float(res.global_pelzer),
            "PotentialOutliers": int(res.potential_outliers),
        }}) + "\n")
    return n + 2


def write_xyz_jsonl(path: str, net, res) -> int:
    """Station coordinates report as JSONL (--output-json .xyz mirror)."""
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps(_header(net, "xyz")) + "\n")
        for i in range(net.nstations):
            f.write(json.dumps(_station_record(net, res, i)) + "\n")
            n += 1
    return n + 1


def write_apu_jsonl(path: str, net, res, confidence: float = 95.0) -> int:
    """Positional uncertainty report as JSONL (--output-json .apu mirror;
    OnPositionalUncertainty, dnaadjust_json_printer.hpp:84)."""
    import numpy as np

    from ..geodesy.local_frame import rotation_cart_to_local
    from .uncertainty import error_ellipse, positional_uncertainty
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps(_header(net, "apu")) + "\n")
        for i in range(net.nstations):
            Vc = res.station_cov(i)
            R = rotation_cart_to_local(res.lat[i], res.lon[i])
            Vl = R @ Vc @ R.T
            a, b, az = error_ellipse(Vl)
            hz, vt = positional_uncertainty(a, b,
                                            float(np.sqrt(max(Vl[2, 2],
                                                              0.0))))
            f.write(json.dumps({"DnaPositionalUncertainty": {
                "Station": net.names[i],
                "Latitude": float(np.degrees(res.lat[i])),
                "Longitude": float(np.degrees(res.lon[i])),
                "HzPosU": float(hz), "VtPosU": float(vt),
                "SemiMajor": float(a), "SemiMinor": float(b),
                "Orientation": float(np.degrees(az)),
                "VarianceENU": [[float(Vl[r][c]) for c in range(3)]
                                for r in range(3)],
            }}) + "\n")
            n += 1
    return n + 1


def write_cor_jsonl(path: str, net, res, original_xyz) -> int:
    """Corrections report as JSONL (--output-json .cor mirror)."""
    import numpy as np

    from ..geodesy.local_frame import rotation_cart_to_local
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps(_header(net, "cor")) + "\n")
        for i in range(net.nstations):
            d = res.xyz[i] - original_xyz[i]
            R = rotation_cart_to_local(res.lat[i], res.lon[i])
            e, nn, up = (float(v) for v in (R @ d))
            f.write(json.dumps({"DnaCorrection": {
                "Station": net.names[i],
                "East": e, "North": nn, "Up": up,
                "SDistance": float(np.linalg.norm(d)),
                "HDistance": float(np.hypot(e, nn)),
            }}) + "\n")
            n += 1
    return n + 1
