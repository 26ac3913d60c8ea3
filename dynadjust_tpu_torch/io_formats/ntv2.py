"""NTv2 geoid grid reader (.gsb binary and .asc/.dat ASCII).

The AUSGeoid NTv2 layout stores, per node, four float32 values:
N value (m), deflection in prime meridian (seconds), deflection in prime
vertical (seconds), N uncertainty (m).  Sub-grid nodes run from the
south-east corner, west across each row (longitudes positive WEST), then
north row by row.

Format reference: the NTv2 format specification; binary layout studied from
DynAdjust dynadjust/dynadjust/dnageoid/dnageoid.cpp
(OpenGridFile :2552, ReadBinaryShifts).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np



# Numerical Recipes bicubic interpolation coefficient table (bcucof)
_BICUBIC_WT = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [-3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1, 0, 0, 0, 0],
    [2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, -3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1],
    [0, 0, 0, 0, 2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1],
    [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
    [9, -9, 9, -9, 6, 3, -3, -6, 6, -6, -3, 3, 4, 2, 1, 2],
    [-6, 6, -6, 6, -4, -2, 2, 4, -3, 3, 3, -3, -2, -1, -1, -2],
    [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
    [-6, 6, -6, 6, -3, -3, 3, 3, -4, 4, 2, -2, -2, -2, -1, -1],
    [4, -4, 4, -4, 2, 2, -2, -2, 2, -2, -2, 2, 1, 1, 1, 1],
], dtype=np.float64)

@dataclass
class SubGrid:
    name: str
    parent: str
    s_lat: float        # seconds
    n_lat: float
    e_long: float       # seconds, positive WEST
    w_long: float
    lat_inc: float
    long_inc: float
    # node values, shape (nrows, ncols, 4): N, defl_meridian, defl_primev, unc
    values: np.ndarray = field(default=None, repr=False)

    @property
    def ncols(self) -> int:
        return int((self.w_long - self.e_long + 1e-5) / self.long_inc) + 1

    @property
    def nrows(self) -> int:
        return int((self.n_lat - self.s_lat + 1e-5) / self.lat_inc) + 1


@dataclass
class NTv2Grid:
    gs_type: str                    # SECONDS or RADIANS
    version: str
    system_from: str
    system_to: str
    ellipsoid_from: tuple
    ellipsoid_to: tuple
    subgrids: list = field(default_factory=list)

    @staticmethod
    def read(path: str) -> "NTv2Grid":
        if path.lower().endswith((".asc", ".dat", ".txt", ".prn")):
            return _read_ascii(path)
        return _read_gsb(path)

    def find_subgrid(self, lat_sec: float, lon_west_sec: float):
        """Find the densest sub-grid containing the point, returning
        (subgrid, limit_flag) where limit_flag ∈ {1..4} marks points on the
        upper latitude / longitude limits (virtual-cell handling).

        Parity: FindSubGrid, dnageoid.cpp:1675-1776.
        """
        current_parent = "NONE"
        chosen = None
        flag = 0
        while True:
            best = None
            best_flag = None
            for sg in self.subgrids:
                if sg.parent.strip() != current_parent.strip():
                    continue
                d_n = abs(lat_sec - sg.n_lat)
                d_s = abs(lat_sec - sg.s_lat)
                d_w = abs(lon_west_sec - sg.w_long)
                d_e = abs(lon_west_sec - sg.e_long)
                on_n = d_n < 1e-5
                on_s = d_s < 1e-5
                on_w = d_w < 1e-5
                on_e = d_e < 1e-5
                inside = ((lat_sec < sg.n_lat or on_n) and
                          (lat_sec > sg.s_lat or on_s) and
                          (lon_west_sec < sg.w_long or on_w) and
                          (lon_west_sec > sg.e_long or on_e))
                if not inside:
                    continue
                if not on_n and not on_w:
                    f = 1
                elif on_n and not on_w:
                    f = 2
                elif not on_n and on_w:
                    f = 3
                else:
                    f = 4
                if best is None or f < best_flag:
                    best, best_flag = sg, f
            if best is None:
                break
            chosen, flag = best, best_flag
            current_parent = best.name
        if chosen is None:
            return None, 0
        return chosen, flag

    def interpolate(self, lat_rad: float, lon_rad: float,
                    method: str = "bicubic"):
        """Interpolate (N, defl_meridian_sec, defl_primev_sec, unc) at a
        geographic position.  Returns None if outside the grid.

        Parity: InterpolateNvalue_BiLinear, dnageoid.cpp:1855-2010 —
        including the float32 rounding of node coordinates and scale
        factors, which the reference applies.
        """
        lat = lat_rad * 180.0 / np.pi * 3600.0
        lon = -lon_rad * 180.0 / np.pi * 3600.0     # NTv2: positive west
        sg, flag = self.find_subgrid(lat, lon)
        if sg is None:
            return None
        row = int((lat - sg.s_lat + 1e-5) / sg.lat_inc)
        col = int((lon - sg.e_long + 1e-5) / sg.long_inc)
        ncols = sg.ncols

        def node(r, c):
            # node values are float32 on disk; arithmetic proceeds in f64
            return sg.values[r, c].astype(np.float64)

        # A = lower-right, B = lower-left, C = upper-right, D = upper-left
        rA, cA = row, col
        rB, cB = row, col + 1
        rC, cC = row + 1, col
        rD, cD = row + 1, col + 1
        if flag == 2:          # on upper latitude limit
            rC, cC = rA, cA
            rD, cD = rB, cB
        elif flag == 3:        # on upper longitude limit
            rB, cB = rA, cA
            rD, cD = rC, cC
        elif flag == 4:
            rB, cB = rA, cA
            rC, cC = rA, cA
            rD, cD = rA, cA

        if method == "bicubic":
            vals = self._bicubic(sg, flag, lat, lon, row, col,
                                 (rA, cA), (rB, cB), (rC, cC), (rD, cD))
        else:
            a = node(rA, cA)
            b = node(rB, cB)
            c = node(rC, cC)
            d = node(rD, cD)

            lat_a = np.float32(sg.s_lat + row * sg.lat_inc)
            lon_a = np.float32(sg.e_long + col * sg.long_inc)
            dy = np.float32((lat - lat_a) / sg.lat_inc)
            dx = np.float32((lon - lon_a) / sg.long_inc)

            a0 = a
            a1 = b - a
            a2 = c - a
            a3 = a + d - b - c
            vals = a0 + a1 * dx + a2 * dy + a3 * dx * dy
        if self.gs_type.strip().upper() == "RADIANS":
            vals = vals.copy()
            rad_to_sec = np.float32(180.0 * 3600.0 / np.pi)
            vals[1] *= rad_to_sec
            vals[2] *= rad_to_sec
        return vals

    def _bicubic(self, sg, flag, lat, lon, row, col, A, B, C, D):
        """Numerical-Recipes bicubic (bcuint) over the 16-node stencil with
        virtual-cell handling at sub-grid edges.

        Parity: InterpolateNvalue_BiCubic, dnageoid.cpp:2010-2400 and
        bicubic_interpolation.hpp (bcucof/bcuint)."""
        nrows, ncols = sg.nrows, sg.ncols

        # 16-node stencil:   P O N M
        #                    L D C K
        #                    J B A I
        #                    H G F E
        I_ = (row, col - 1)
        J = (row, col + 2)
        K = (row + 1, col - 1)
        L = (row + 1, col + 2)
        E = (row - 1, col - 1)
        F = (row - 1, col)
        G = (row - 1, col + 1)
        H = (row - 1, col + 2)
        M = (row + 2, col - 1)
        N = (row + 2, col)
        O = (row + 2, col + 1)
        P = (row + 2, col + 2)

        def within_interval(v, limit, inc):
            # IsWithin*GridInterval, dnageoid.cpp:1777-1832: point within
            # one grid interval of the sub-grid limit (fuzzy boundary)
            d = abs(v - limit) - inc
            if abs(d) < 1e-5:
                d = 0.0
            return d < inc or d == 0.0

        low_lat = within_interval(lat, sg.s_lat, sg.lat_inc)
        up_lat = within_interval(lat, sg.n_lat, sg.lat_inc)
        low_lon = within_interval(lon, sg.e_long, sg.long_inc)
        up_lon = within_interval(lon, sg.w_long, sg.long_inc)

        if flag == 1:
            if low_lat and low_lon:
                I_, K, M = A, C, N
                E, F, G, H = I_, A, B, J
            elif low_lat and up_lon:
                J, L, P = B, D, O
                E, F, G, H = I_, A, B, J
            elif low_lat:
                E, F, G, H = I_, A, B, J
            elif up_lat and low_lon:
                K, I_, E = C, A, F
                M, N, O, P = K, C, D, L
            elif up_lat and up_lon:
                L, J, P = D, B, O
                M, N, O, P = K, C, D, L
            elif up_lat:
                M, N, O, P = K, C, D, L
            elif low_lon:
                E, I_, K, M = F, A, C, N
            elif up_lon:
                H, J, L, P = G, B, D, O
        elif flag == 2:
            if low_lon:
                I_, E = A, F
            elif up_lon:
                J, H = B, G
            M = K = I_
            N = C = A
            O = D = B
            P = L = J
        elif flag == 3:
            if low_lat:
                F, E = A, I_
            if up_lat:
                N, K = C, M
            H = G = F
            J = B = A
            L = D = C
            P = O = N
        elif flag == 4:
            J = B = A
            N = C = A
            D = A
            P = L = O = D
            H = G = F
            M = K = I_

        def nd(rc):
            r, c = rc
            r = min(max(r, 0), nrows - 1)
            c = min(max(c, 0), ncols - 1)
            return sg.values[r, c].astype(np.float64)

        pN = [nd(A), nd(B), nd(C), nd(D), nd(E), nd(F), nd(G), nd(H),
              nd(I_), nd(J), nd(K), nd(L), nd(M), nd(N), nd(O), nd(P)]
        pN = np.stack(pN)   # (16, 4)

        lat_lower = sg.s_lat + row * sg.lat_inc
        lon_lower = sg.e_long + col * sg.long_inc
        lon_upper = lon_lower + sg.long_inc
        d1 = abs(lon - lon_upper)
        d2 = abs(lat - lat_lower)

        y = np.stack([pN[1], pN[0], pN[2], pN[3]])
        y1 = np.stack([(pN[0] - pN[9]) / 2.0,
                       (pN[8] - pN[1]) / 2.0,
                       (pN[10] - pN[3]) / 2.0,
                       (pN[2] - pN[11]) / 2.0])
        y2 = np.stack([(pN[3] - pN[6]) / 2.0,
                       (pN[2] - pN[5]) / 2.0,
                       (pN[13] - pN[0]) / 2.0,
                       (pN[14] - pN[1]) / 2.0])
        y12 = np.stack([(pN[2] - pN[5] - pN[11] + pN[7]) / 4.0,
                        (pN[10] - pN[4] - pN[3] + pN[6]) / 4.0,
                        (pN[12] - pN[8] - pN[14] + pN[1]) / 4.0,
                        (pN[13] - pN[0] - pN[15] + pN[9]) / 4.0])

        t = d1 / sg.long_inc
        u = d2 / sg.lat_inc
        out = np.zeros(pN.shape[1])
        for comp in range(pN.shape[1]):
            x = np.concatenate([y[:, comp], y1[:, comp], y2[:, comp],
                                y12[:, comp]])
            cl = _BICUBIC_WT @ x
            c = cl.reshape(4, 4)
            val = 0.0
            for i in range(3, -1, -1):
                val = t * val + ((c[i, 3] * u + c[i, 2]) * u + c[i, 1]) * u \
                    + c[i, 0]
            out[comp] = val
        return out


def _read_gsb(path: str) -> NTv2Grid:
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def rec_int():
        nonlocal off
        # 8-byte identifier + int32 + 4 pad bytes
        val = struct.unpack_from("<i", data, off + 8)[0]
        off += 16
        return val

    def rec_str():
        nonlocal off
        s = data[off + 8:off + 16].decode("ascii", "replace")
        off += 16
        return s

    def rec_dbl():
        nonlocal off
        v = struct.unpack_from("<d", data, off + 8)[0]
        off += 16
        return v

    num_orec = rec_int()
    num_srec = rec_int()
    num_file = rec_int()
    gs_type = rec_str()
    version = rec_str()
    system_f = rec_str()
    system_t = rec_str()
    major_f = rec_dbl()
    minor_f = rec_dbl()
    major_t = rec_dbl()
    minor_t = rec_dbl()

    grid = NTv2Grid(gs_type=gs_type, version=version, system_from=system_f,
                    system_to=system_t, ellipsoid_from=(major_f, minor_f),
                    ellipsoid_to=(major_t, minor_t))
    for _ in range(num_file):
        name = rec_str()
        parent = rec_str()
        rec_str()   # CREATED
        rec_str()   # UPDATED
        s_lat = rec_dbl()
        n_lat = rec_dbl()
        e_long = rec_dbl()
        w_long = rec_dbl()
        lat_inc = rec_dbl()
        long_inc = rec_dbl()
        gs_count = rec_int()
        sg = SubGrid(name=name, parent=parent, s_lat=s_lat, n_lat=n_lat,
                     e_long=e_long, w_long=w_long, lat_inc=lat_inc,
                     long_inc=long_inc)
        vals = np.frombuffer(data, dtype="<f4", count=gs_count * 4,
                             offset=off).reshape(gs_count, 4)
        off += gs_count * 16
        sg.values = vals.reshape(sg.nrows, sg.ncols, 4)
        grid.subgrids.append(sg)
    return grid


def _read_ascii(path: str) -> NTv2Grid:
    with open(path, "r") as f:
        toks = f.read().splitlines()
    idx = 0

    def kv():
        nonlocal idx
        line = toks[idx]
        idx += 1
        return line[:8].strip(), line[8:].strip()

    hdr = {}
    for _ in range(11):
        k, v = kv()
        hdr[k] = v
    grid = NTv2Grid(
        gs_type=hdr.get("GS_TYPE", "SECONDS"),
        version=hdr.get("VERSION", ""), system_from=hdr.get("SYSTEM_F", ""),
        system_to=hdr.get("SYSTEM_T", ""),
        ellipsoid_from=(float(hdr.get("MAJOR_F", 0)), float(hdr.get("MINOR_F", 0))),
        ellipsoid_to=(float(hdr.get("MAJOR_T", 0)), float(hdr.get("MINOR_T", 0))))
    nfile = int(hdr.get("NUM_FILE", 1))
    for _ in range(nfile):
        sub = {}
        for _ in range(11):
            k, v = kv()
            sub[k] = v
        sg = SubGrid(
            name=sub["SUB_NAME"], parent=sub["PARENT"],
            s_lat=float(sub["S_LAT"]), n_lat=float(sub["N_LAT"]),
            e_long=float(sub["E_LONG"]), w_long=float(sub["W_LONG"]),
            lat_inc=float(sub["LAT_INC"]), long_inc=float(sub["LONG_INC"]))
        count = int(sub["GS_COUNT"])
        vals = np.zeros((count, 4), dtype=np.float32)
        for i in range(count):
            line = toks[idx]
            idx += 1
            parts = line.split()
            if len(parts) < 4:
                # setw(10) fixed columns fuse when a negative value fills
                # the field (the reference writes and reads them this way)
                parts = [line[k:k + 10] for k in range(0, 40, 10)]
            vals[i] = [float(p) for p in parts[:4]]
        sg.values = vals.reshape(sg.nrows, sg.ncols, 4)
        grid.subgrids.append(sg)
    return grid
