"""Positional uncertainty (.apu) and station corrections (.cor) writers,
error ellipse computation.

Format/maths reference: dnaadjust_printer.cpp PrintPosUncertainty :~2700
(ENU/XYZ variance units, error ellipse, PU radii);
dnatemplatematrixfuncs.hpp ErrorEllipseParameters, PositionalUncertainty
(HPOS_UNCERT polynomial, dnaconsts.hpp:105-108);
PrintCorStations (dnaadjust.cpp:8651).
"""

from __future__ import annotations

import numpy as np

from ..geodesy.conversions import rad_to_dms
from ..geodesy.local_frame import rotation_cart_to_local
from ..geodesy import measurements as gm
from ..network.data import NetworkData
from .adj_writer import (
    STATION, PAD2, LAT_EAST, LON_NORTH, STAT, PREC, MSR, HEIGHT, OUTPUTLINE,
    format_dms,
)

# horizontal circular-confidence polynomial (95%), dnaconsts.hpp:105-108
_Q0, _Q1, _Q2, _Q3 = 1.96079, 0.004071, 0.114276, 0.371625


def error_ellipse(var_local: np.ndarray):
    """(semi-major, semi-minor, azimuth) of the 1-sigma horizontal error
    ellipse from a local (e,n,up) covariance."""
    e2 = var_local[0, 0]
    n2 = var_local[1, 1]
    en = var_local[0, 1]
    W = (e2 - n2) ** 2 + 4.0 * en * en
    if W < 0.0:
        W = 0.0
    a2 = 0.5 * (e2 + n2 + np.sqrt(W))
    b2 = 0.5 * (e2 + n2 - np.sqrt(W))
    if a2 < 0 or b2 < 0:
        return -1.0, -1.0, -1.0
    if abs(e2 - n2) < 1e-25:
        az = 0.0 if en < 1e-25 else np.pi / 4.0
    else:
        az = 0.5 * np.arctan2(2.0 * en, n2 - e2)
    return float(np.sqrt(a2)), float(np.sqrt(b2)), float(az)


def positional_uncertainty(semimajor, semiminor, sd_up):
    """95% circularised horizontal radius + 1.96-sigma vertical."""
    if semimajor < 0 or semiminor < 0:
        return -1.0, -1.0
    c = semiminor / semimajor if semimajor > 0 else 0.0
    K = _Q0 + _Q1 * c + _Q2 * c * c + _Q3 * c ** 3
    return semimajor * K, sd_up * 1.96


def write_apu(path: str, net: NetworkData, res, vcv_units: str = "ENU",
              confidence: float = 95.0, all_covariances: bool = False):
    """all_covariances: also print the 3x3 covariance blocks between each
    station and every later station (--output-all-covariances)."""
    L = [OUTPUTLINE, "DYNADJUST-TPU POSITIONAL UNCERTAINTY OUTPUT FILE", ""]
    L.append(f"{'PU confidence interval:':<35}{confidence:.1f}%")
    L.append(f"{'Error ellipse axes:':<35}1 sigma")
    L.append(f"{'Variance matrix units:':<35}{vcv_units}")
    L.append(f"{'Full covariance matrix:':<35}"
             f"{'Yes' if all_covariances else 'No'}")
    L.append(OUTPUTLINE)
    L.append("")
    L.append("Positional Uncertainty")
    L.append("------------------------------------------")
    L.append("")
    v1, v2, v3 = {"ENU": ("Variance(e)", "Variance(n)", "Variance(up)"),
                  "LLH": ("Variance(P)", "Variance(L)", "Variance(H)")
                  }.get(vcv_units,
                        ("Variance(X)", "Variance(Y)", "Variance(Z)"))
    hdr = (f"{'Station':<{STATION}}{'':{PAD2}}"
           f"{'Latitude':>{LAT_EAST}}{'Longitude':>{LON_NORTH}}"
           f"{'Hz PosU':>{STAT}}{'Vt PosU':>{STAT}}"
           f"{'Semi-major':>{PREC}}{'Semi-minor':>{PREC}}"
           f"{'Orientation':>{PREC}}"
           f"{v1:>{MSR}}{v2:>{MSR}}{v3:>{MSR}}")
    L.append(hdr)
    width = (STATION + PAD2 + LAT_EAST + LON_NORTH + STAT * 2 + PREC * 3 +
             MSR * 3)
    L.append("-" * width)

    for i in range(net.nstations):
        Vc = res.station_cov(i)
        R = rotation_cart_to_local(res.lat[i], res.lon[i])
        Vl = R @ Vc @ R.T
        a, b, az = error_ellipse(Vl)
        hz, vt = positional_uncertainty(a, b, np.sqrt(Vl[2, 2]))
        if vcv_units == "ENU":
            V = Vl
        elif vcv_units == "LLH":
            # polar units: propagate cartesian -> geographic (rad^2, m^2)
            from ..geodesy.local_frame import geo_cart_jacobian
            Jinv = np.linalg.inv(geo_cart_jacobian(
                res.lat[i], res.lon[i], res.height[i],
                net.datum.ellipsoid))
            V = Jinv @ Vc @ Jinv.T
        else:
            V = Vc
        row = (f"{net.names[i]:<{STATION}}{'':{PAD2}}"
               f"{format_dms(res.lat[i], 5):>{LAT_EAST}}"
               f"{format_dms(res.lon[i], 5):>{LON_NORTH}}"
               f"{hz:>{STAT}.4f}{vt:>{STAT}.4f}"
               f"{a:>{PREC}.4f}{b:>{PREC}.4f}"
               f"{float(rad_to_dms(az)):>{PREC}.4f}"
               f"{V[0, 0]:>{MSR}.9e}{V[0, 1]:>{MSR}.9e}"
               f"{V[0, 2]:>{MSR}.9e}")
        L.append(row)
        pad = STATION + PAD2 + LAT_EAST + LON_NORTH + STAT * 2 + PREC * 3
        L.append(f"{'':{pad + MSR}}{V[1, 1]:>{MSR}.9e}{V[1, 2]:>{MSR}.9e}")
        L.append(f"{'':{pad + 2 * MSR}}{V[2, 2]:>{MSR}.9e}")
        if all_covariances:
            Ri = R
            if res.cov_xyz is not None:
                js = range(i + 1, net.nstations)

                def _pair(jv):
                    return res.cov_xyz[3 * i:3 * i + 3,
                                       3 * jv:3 * jv + 3]
            elif getattr(res, "block_cov", None) is not None:
                # past the dense cap: within-block covariances from the
                # per-block factors — the reference's phased-mode output
                # (per-block rigorous variances; cross-block pairs are
                # not printed, dnaadjust_printer.cpp:4330-4390)
                js = sorted(int(j) for j in res.block_cov.partners(i)
                            if j > i)
                _pair = lambda jv: res.block_cov.pair_cov(i, jv)
            else:
                raise ValueError(
                    "--output-all-covariances needs the dense covariance "
                    "or a blocked adjustment's covariance provider "
                    "(set DTA_DENSE_COV_MAX_STN to force dense)")
            for j in js:
                C = _pair(j)
                if C is None:
                    continue
                if vcv_units == "ENU":
                    Rj = rotation_cart_to_local(res.lat[j], res.lon[j])
                    C = Ri @ C @ Rj.T
                name_pad = STATION + PAD2
                for r_ in range(3):
                    prefix = (f"{net.names[j]:<{name_pad}}" if r_ == 0
                              else " " * name_pad)
                    L.append(prefix + "".join(
                        f"{C[r_, c_]:>{MSR}.9e}" for c_ in range(3)))
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def write_cor(path: str, net: NetworkData, res, original_xyz: np.ndarray,
              hz_threshold: float = 0.0, vt_threshold: float = 0.0):
    """Corrections to initial station coordinates (azimuth, vertical angle,
    slope/horizontal distance, and local e/n/up components).

    hz_threshold / vt_threshold: only print stations whose horizontal /
    vertical correction exceeds the threshold (--hz-corr-threshold /
    --vt-corr-threshold; both zero = print everything)."""
    L = [OUTPUTLINE, "DYNADJUST-TPU CORRECTIONS OUTPUT FILE", OUTPUTLINE, ""]
    hdr = (f"{'Station':<{STATION}}{'':{PAD2}}"
           f"{'Azimuth':>{MSR}}{'V. Angle':>{MSR}}"
           f"{'S. Distance':>{MSR}}{'H. Distance':>{MSR}}"
           f"{'east':>{HEIGHT}}{'north':>{HEIGHT}}{'up':>{HEIGHT}}")
    L.append(hdr)
    L.append("-" * (STATION + PAD2 + 4 * MSR + 3 * HEIGHT))
    for i in range(net.nstations):
        d = res.xyz[i] - original_xyz[i]
        R = rotation_cart_to_local(res.lat[i], res.lon[i])
        e, n, up = R @ d
        s_dist = float(np.linalg.norm(d))
        h_dist = float(np.hypot(e, n))
        if ((hz_threshold > 0.0 or vt_threshold > 0.0) and
                h_dist < hz_threshold and abs(up) < vt_threshold):
            continue
        az = float(gm.direction_from_local(e, n)) if h_dist > 1e-12 else 0.0
        va = float(np.arctan2(up, h_dist)) if s_dist > 1e-12 else 0.0
        L.append(
            f"{net.names[i]:<{STATION}}{'':{PAD2}}"
            f"{float(rad_to_dms(az)):>{MSR}.4f}"
            f"{float(rad_to_dms(va)):>{MSR}.4f}"
            f"{s_dist:>{MSR}.4f}{h_dist:>{MSR}.4f}"
            f"{e:>{HEIGHT}.4f}{n:>{HEIGHT}.4f}{up:>{HEIGHT}.4f}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
