"""The port's DNA readers, writers and UTM stations against the JAX
package's.

read_dna_stn / read_dna_msr of both packages read the same files into
equal records, field by field: the seeded synthetic mixed network's
files (every measurement type it writes) and a station file of UTM
grid coordinates, which both packages' build_network convert to the
same geographic coordinates (geodesy/projections.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.io_formats import dna as jdna
from dynadjust_tpu.io_formats import dna_writer as jwriter
from dynadjust_tpu.geodesy import projections as jproj
from dynadjust_tpu.network import build_network as jbuild
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.io_formats import dna as tdna
from dynadjust_tpu_torch.io_formats import dna_writer as twriter
from dynadjust_tpu_torch.geodesy import projections as tproj
from dynadjust_tpu_torch.network import build_network as tbuild
from dynadjust_tpu_torch.network.data import from_reference


def _fields(rec):
    out = {}
    for f in dataclasses.fields(rec):
        v = getattr(rec, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        elif isinstance(v, list):
            v = [_fields(x) if dataclasses.is_dataclass(x) else x
                 for x in v]
        out[f.name] = v
    return type(rec).__name__, out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    net, _ = synthetic_mixed_network(6, 6, block_rows=3, block_cols=3,
                                     seed=2)
    jwriter.write_dna_stn(str(d / "n.stn"), net)
    jwriter.write_dna_msr(str(d / "n.msr"), net)
    return d, net


def test_station_records_equal(files):
    d, _ = files
    sj, fj, ej = jdna.read_dna_stn(str(d / "n.stn"))
    st, ft, et = tdna.read_dna_stn(str(d / "n.stn"))
    assert (ft, et) == (fj, ej)
    assert [_fields(s) for s in st] == [_fields(s) for s in sj]


def test_measurement_records_equal(files):
    d, net = files
    rj, fj, ej = jdna.read_dna_msr(str(d / "n.msr"))
    rt, ft, et = tdna.read_dna_msr(str(d / "n.msr"))
    assert (ft, et) == (fj, ej)
    types = {r.mtype for r in rj}
    assert types == {r.mtype for r in net.measurements}
    assert len(types) >= 6
    assert [_fields(r) for r in rt] == [_fields(r) for r in rj]


def test_writers_write_the_same_records(files, tmp_path):
    """The port's writers on the port's copy of the network give the JAX
    writers' files, but for the comment naming the package and the
    angles' seconds, which the port writes with two whole digits."""
    d, net = files
    tnet = from_reference(net)
    for kind in ("stn", "msr"):
        getattr(twriter, f"write_dna_{kind}")(str(tmp_path / f"t.{kind}"),
                                              tnet)
        tl = (tmp_path / f"t.{kind}").read_text().splitlines()
        jl = (d / f"n.{kind}").read_text().splitlines()
        assert tl[0] == jl[0]
        assert tl[1].startswith("*") and "dynadjust_tpu_torch" in tl[1]
        if kind == "msr":
            jl = [zero_padded_seconds(ln) for ln in jl]
        assert tl[2:] == jl[2:]


def zero_padded_seconds(line):
    """A DNA angular measurement line with its seconds written as the
    port's writer writes them, with two whole digits ("00.4779" where the
    JAX writer writes " 0.4779", which its reader misreads as 04.779")."""
    if len(line) >= 90 and line[0] in "ABDIJKPQVZ":
        return f"{line[:82]} {float(line[82:90]):07.4f}{line[90:]}"
    return line


@pytest.mark.parametrize("seconds", [0.4779, 5.1234, 12.3456])
def test_angle_seconds_read_back(tmp_path, seconds):
    """An angle written by the port's writer reads back, within the
    file's 1e-4", through both packages' readers.  The JAX writer pads
    seconds below 10 with a space, and its reader (the port's too) takes
    a one-digit "0.4779" as 04.779": angles whose seconds are below 1
    come back wrong from the JAX writer's files (ROADMAP.md F8)."""
    jnet, _ = synthetic_mixed_network(3, 3, block_rows=3, block_cols=3,
                                      seed=0)
    jnet.measurements = [r for r in jnet.measurements if r.mtype == "A"]
    value = np.radians(269.0 + 59.0 / 60.0 + seconds / 3600.0)
    jnet.measurements[0].value = value
    twriter.write_dna_msr(str(tmp_path / "t.msr"), from_reference(jnet))
    jwriter.write_dna_msr(str(tmp_path / "j.msr"), jnet)
    sec = np.radians(1.0 / 3600.0)
    for read in (tdna.read_dna_msr, jdna.read_dna_msr):
        got = read(str(tmp_path / "t.msr"))[0][0].value
        assert abs(got - value) < 1e-4 * sec
        got = read(str(tmp_path / "j.msr"))[0][0].value
        assert (abs(got - value) > sec) == (seconds < 1.0)


UTM = [  # name, easting, northing, height, zone (southern hemisphere)
    ("U1", 333000.1234, 6250000.5678, 12.3456, "S55"),
    ("U2", 500000.0000, 5812345.0000, 250.0000, "S54"),
    ("U3", 712345.6789, 7000000.0000, 0.5000, "S56"),
]


def _utm_file(path):
    lines = ["!#=DNA 3.01 STN    01.01.2020      GDA2020    01.01.2020"
             f"{len(UTM):>10}"]
    for name, e, n, h, zone in UTM:
        lines.append(f"{name:<20}{'FFF':<4}UTM{e:>20.4f}{n:>20.4f}"
                     f"{h:>20.4f}{zone:<3} {name} grid station")
    path.write_text("\n".join(lines) + "\n")


def test_utm_stations(tmp_path):
    p = tmp_path / "utm.stn"
    _utm_file(p)
    sj, fj, ej = jdna.read_dna_stn(str(p))
    st, _, _ = tdna.read_dna_stn(str(p))
    assert [_fields(s) for s in st] == [_fields(s) for s in sj]
    assert [s.coord_type for s in st] == ["UTM"] * len(UTM)
    nj = jbuild(sj, [], fj, ej)
    nt = tbuild(st, [], fj, ej)
    np.testing.assert_array_equal(nt.lat, nj.lat)
    np.testing.assert_array_equal(nt.lon, nj.lon)
    np.testing.assert_array_equal(nt.height, nj.height)
    np.testing.assert_array_equal(nt.height_ref, nj.height_ref)
    assert np.all(nt.lat < 0)
    # the projection round trip closes at the millimetre
    for (name, e, n, _, zone), la, lo in zip(UTM, nt.lat, nt.lon):
        e2, n2, z2 = tproj.geo_to_grid(la, lo, nt.datum.ellipsoid)[:3]
        assert int(z2) == int(zone[1:])
        assert abs(e2 - e) < 1e-3 and abs(n2 - n) < 1e-3


def test_projection_functions_equal():
    rng = np.random.default_rng(5)
    lat = np.radians(rng.uniform(-44, -10, 50))
    lon = np.radians(rng.uniform(113, 154, 50))
    for la, lo in zip(lat, lon):
        gj = jproj.geo_to_grid(la, lo)
        gt = tproj.geo_to_grid(la, lo)
        np.testing.assert_array_equal(np.asarray(gt, dtype=float),
                                      np.asarray(gj, dtype=float))
        np.testing.assert_array_equal(
            np.asarray(tproj.grid_to_geo(gt[0], gt[1], int(gt[2])),
                       dtype=float),
            np.asarray(jproj.grid_to_geo(gj[0], gj[1], int(gj[2])),
                       dtype=float))
