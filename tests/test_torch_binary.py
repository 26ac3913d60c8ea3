"""The reference's binary files (.bst/.bms with .asl, .aml, .map and .dbid)
and the JSONL inputs in the port against the JAX package.

A seeded 8 x 8 mixed network, with one three-baseline GNSS cluster
(covariance blocks between its baselines), a direction set whose values
are simulated from the coordinates, and database ids on every record:

  * write_bst, write_bms, write_asl_aml, write_map and write_dbid of both
    packages write the same bytes (but for the padding byte of each .bms
    row, which the JAX writer leaves uninitialised and the port writes
    as 0);
  * read_bst, read_bms and records_from_rows of both packages read those
    files back to the same rows and records, and to the network's own;
  * import --export-bst-bms on both CLIs (from DNA files) writes the same
    six files;
  * the network imported from the .bst/.bms pair (the .dbid beside the
    .bms) through the port's CLI adjusts to the same .adj, below "Number
    of unknown parameters", as the DNA import (saved xyz within 1e-8 m),
    on the host route and on --phased --tpu --device cpu;
  * metadata of either binary file prints what the JAX CLI prints;
  * .jsonl station and measurement files (DynaML's vocabulary, written by
    this file's write_jsonl from the records of the DNA files): read_jsonl
    of both packages gives the same stations, records, frame and epoch,
    and import of them saves the network that the JAX CLI saves and that
    the DNA import saves (angles within 1e-12 relative: they cross the
    file as DMS).
"""

import copy
import json
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.io_formats import binary as jbin
from dynadjust_tpu.io_formats import dbid as jdbid
from dynadjust_tpu.io_formats import dna as jdna
from dynadjust_tpu.io_formats import jsonl as jjsonl
from dynadjust_tpu.io_formats.dna import (ANGULAR_TYPES, DirectionSet,
                                          GpsCluster)
from dynadjust_tpu.geodesy.conversions import rad_to_dms
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.network.simulate import simulate_measurements
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from dynadjust_tpu_torch.io_formats import binary as tbin
from dynadjust_tpu_torch.io_formats import dbid as tdbid
from dynadjust_tpu_torch.io_formats import jsonl as tjsonl
from dynadjust_tpu_torch.network.data import from_reference

MARKER = "Number of unknown parameters"
EXPORTS = ("bst", "bms", "asl", "aml", "map", "dbid")
# byte 39 of each measurement row is struct padding: the JAX writer
# leaves it uninitialised (np.array of records), the port writes 0
_ROW = tbin.MEAS_DTYPE.itemsize
_PAD = 39


def _same_bytes(name, port, jax):
    """The port's file `port` equals the JAX package's `jax`, a .bms file
    but for its rows' padding byte, which must be 0 in the port's."""
    if not name.endswith(".bms"):
        return port == jax
    rows = (len(port) // _ROW) * _ROW      # the header is shorter than a row
    head = len(port) - rows
    pad = np.arange(head + _PAD, len(port), _ROW)
    a, b = (np.frombuffer(x, np.uint8).copy() for x in (port, jax))
    assert len(a) == len(b) and not a[pad].any()
    b[pad] = 0
    return np.array_equal(a, b)


def mixed_network(rows=8, cols=8, seed=2):
    """The JAX package's synthetic mixed network with a three-baseline
    GNSS cluster, a direction set and database ids."""
    net, _ = synthetic_mixed_network(rows, cols, block_rows=4, block_cols=4,
                                     seed=seed)
    recs = net.measurements
    gi = [k for k, r in enumerate(recs) if isinstance(r, GpsCluster)][:3]
    cluster = recs[gi[0]]
    cluster.obs = [recs[k].obs[0] for k in gi]
    for a, ob in enumerate(cluster.obs):
        ob.covs = [np.full((3, 3), 1e-6) + 1e-6 * np.eye(3)
                   for _ in cluster.obs[a + 1:]]
    del recs[gi[1]], recs[gi[2] - 1]
    n = net.names
    ds = DirectionSet(ignore=False, first=n[cols + 1], ro=n[1],
                      ro_value=0.0, ro_sd=np.radians(2.0 / 3600.0),
                      directions=[(n[cols + 2], 0.0,
                                   np.radians(2.0 / 3600.0), False),
                                  (n[2 * cols + 1], 0.0,
                                   np.radians(2.0 / 3600.0), False)])
    recs.append(ds)
    sim = copy.deepcopy(net)
    simulate_measurements(sim)
    ds.ro_value = sim.measurements[-1].ro_value
    ds.directions = [(t, v, sd, ig) for (t, _, sd, ig), (_, v, _, _) in
                     zip(ds.directions, sim.measurements[-1].directions)]
    for k, r in enumerate(recs):
        if isinstance(r, GpsCluster):
            r.db_cluster_id = 5000 + k
            for j, ob in enumerate(r.obs):
                ob.msr_id = 100 * k + j
        elif isinstance(r, DirectionSet):
            r.msr_id, r.db_cluster_id = 100 * k, 7000
            r.direction_ids = [100 * k + 1, None]
        else:
            r.msr_id = 100 * k
    return net


@pytest.fixture(scope="module")
def nets():
    jnet = mixed_network()
    return jnet, from_reference(jnet)


WRITERS = {
    "bst": lambda m, net, p: m.write_bst(p("bst"), net),
    "bms": lambda m, net, p: m.write_bms(p("bms"), net),
    "asl_aml": lambda m, net, p: m.write_asl_aml(p("asl"), p("aml"), net),
    "map": lambda m, net, p: m.write_map(p("map"), net),
}


@pytest.mark.parametrize("writer", [*WRITERS, "dbid"])
def test_writers_write_the_same_bytes(nets, tmp_path, writer):
    out = {}
    for side, net, mod, dmod in (("jax", nets[0], jbin, jdbid),
                                 ("torch", nets[1], tbin, tdbid)):
        d = tmp_path / side
        d.mkdir()
        path = lambda ext: str(d / f"n.{ext}")
        if writer == "dbid":
            dmod.write_dbid(path("dbid"), net)
        else:
            WRITERS[writer](mod, net, path)
        out[side] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert out["jax"] and out["torch"].keys() == out["jax"].keys()
    assert all(len(b) > 4 and _same_bytes(name, out["torch"][name], b)
               for name, b in out["jax"].items())


def test_read_back(nets, tmp_path):
    jnet, tnet = nets
    bst, bms, dbid = (str(tmp_path / f"n.{e}") for e in ("bst", "bms",
                                                         "dbid"))
    tbin.write_bst(bst, tnet)
    tbin.write_bms(bms, tnet)
    tdbid.write_dbid(dbid, tnet)
    rows = {}
    for side, mod in (("jax", jbin), ("torch", tbin)):
        srows, smeta = mod.read_bst(bst)
        mrows, mmeta = mod.read_bms(bms)
        rows[side] = (srows, mrows, smeta, mmeta)
    for a, b in zip(rows["jax"], rows["torch"]):
        if isinstance(a, dict):
            assert a == b
        else:
            assert a.tobytes() == b.tobytes()      # the same array read
    srows, mrows, smeta, _ = rows["torch"]
    assert smeta["bin_count"] == tnet.nstations
    np.testing.assert_array_equal(srows["currentLatitude"], tnet.lat)
    np.testing.assert_array_equal(srows["currentHeight"], tnet.height)
    rj = jbin.records_from_rows(mrows, jnet.names)
    rt = tbin.records_from_rows(mrows, tnet.names)
    jdbid.apply_dbid(type("N", (), {"measurements": rj}), jdbid.read_dbid(
        dbid))
    tdbid.apply_dbid(type("N", (), {"measurements": rt}), tdbid.read_dbid(
        dbid))
    assert len(rt) == len(rj) == len(tnet.measurements)
    assert [repr(r).split("(", 1)[1] for r in rt] == \
        [repr(r).split("(", 1)[1] for r in rj]
    for got, want in zip(rt, tnet.measurements):
        assert type(got) is type(want)
        if hasattr(want, "obs"):
            assert [o.msr_id for o in got.obs] == [o.msr_id for o in want.obs]
            for go, wo in zip(got.obs, want.obs):
                np.testing.assert_array_equal(go.vec, wo.vec)
                assert len(go.covs) == len(wo.covs)
        elif hasattr(want, "directions"):
            assert got.direction_ids == want.direction_ids
            assert [d[0] for d in got.directions] == \
                [d[0] for d in want.directions]
            assert got.ro_value == want.ro_value
        else:
            assert (got.mtype, got.value, got.msr_id) == \
                (want.mtype, want.value, want.msr_id)


@pytest.fixture(scope="module")
def exported(nets, tmp_path_factory):
    """DNA files of the network, and import --export-bst-bms of both
    CLIs from them: {side: folder}."""
    d = tmp_path_factory.mktemp("binary")
    write_dna_stn(str(d / "n.stn"), nets[0])
    write_dna_msr(str(d / "n.msr"), nets[0])
    out = {"dna": d}
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        (d / side).mkdir()
        assert main(["import", "-n", "n", str(d / "n.stn"),
                     str(d / "n.msr"), "--export-bst-bms",
                     "--output-folder", str(d / side)]) == 0
        out[side] = d / side
    return out


@pytest.mark.parametrize("ext", EXPORTS)
def test_export_bst_bms_files_identical(exported, ext):
    a = (exported["torch"] / f"n.{ext}").read_bytes()
    assert a and _same_bytes(f"n.{ext}", a,
                             (exported["jax"] / f"n.{ext}").read_bytes())


@pytest.mark.parametrize("route", [[], ["--phased", "--tpu"]],
                         ids=["host", "phased-tpu"])
def test_binary_import_adjusts_like_dna_import(exported, tmp_path, route):
    src = exported["torch"]
    inputs = {"dna": [str(exported["dna"] / "n.stn"),
                      str(exported["dna"] / "n.msr")],
              "binary": [str(src / "n.bst"), str(src / "n.bms")]}
    adj = "n.phased.adj" if route else "n.simult.adj"
    text, res = {}, {}
    for kind, files in inputs.items():
        w = tmp_path / kind
        w.mkdir()
        common = ["--output-folder", str(w)]
        assert torch_main(["import", "-n", "n", *files, *common]) == 0
        assert torch_main(["segment", "n", "--min-inner-stns", "20",
                           "--max-block-stns", "40", *common]) == 0
        assert torch_main(["adjust", "n", *route, "--device", "cpu",
                           *common]) == 0
        lines = (w / adj).read_text().splitlines()
        text[kind] = lines[next(k for k, ln in enumerate(lines)
                                if MARKER in ln):]
        with open(w / "n.results.pkl", "rb") as f:
            res[kind] = pickle.load(f)
    assert res["binary"].status == "Converged"
    assert text["binary"] == text["dna"]
    # the .bst holds radians, the DNA file and the import DMS: the
    # coordinates differ in the last bit
    assert np.abs(res["binary"].xyz - res["dna"].xyz).max() < 1e-8


@pytest.mark.parametrize("ext", ["bst", "bms"])
def test_metadata_of_binary_files(exported, capsys, ext):
    path = str(exported["torch"] / f"n.{ext}")
    printed = {}
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        capsys.readouterr()
        assert main(["metadata", path]) == 0
        printed[side] = capsys.readouterr().out
    assert "bin_count:" in printed["torch"]
    assert printed["torch"] == printed["jax"]


# --- JSONL inputs ----------------------------------------------------------

def _dms(rad):
    return float(rad_to_dms(rad))


def _sec(rad):
    return float(np.degrees(rad) * 3600.0)


def _jsonl_measurement(rec):
    """One DnaMeasurement object (DynaML's vocabulary) for a record."""
    if isinstance(rec, GpsCluster):
        key, cov = (("GPSBaseline", "GPSCovariance") if rec.mtype != "Y"
                    else ("Clusterpoint", "PointCovariance"))
        obs = []
        for ob in rec.obs:
            V = ob.vcv
            obs.append({
                "First": ob.first, "Second": ob.second,
                "X": ob.vec[0], "Y": ob.vec[1], "Z": ob.vec[2],
                "SigmaXX": V[0, 0], "SigmaXY": V[0, 1], "SigmaXZ": V[0, 2],
                "SigmaYY": V[1, 1], "SigmaYZ": V[1, 2], "SigmaZZ": V[2, 2],
                cov: [{f"m{i + 1}{j + 1}": c[i, j] for i in range(3)
                       for j in range(3)} for c in ob.covs]})
        return {"Type": rec.mtype, "Coords": rec.coord_type,
                "Vscale": rec.vscale, "Pscale": rec.pscale,
                "Lscale": rec.lscale, "Hscale": rec.hscale,
                "ReferenceFrame": rec.epsg_frame, "Epoch": rec.epoch,
                key: obs}
    if isinstance(rec, DirectionSet):
        return {"Type": "D", "First": rec.first, "Second": rec.ro,
                "Value": _dms(rec.ro_value), "StdDev": _sec(rec.ro_sd),
                "Directions": [{"Target": t, "Value": _dms(v),
                                "StdDev": _sec(sd)}
                               for t, v, sd, _ in rec.directions]}
    angular = rec.mtype in ANGULAR_TYPES
    return {"Type": rec.mtype, "First": rec.first, "Second": rec.second,
            "Third": rec.third,
            "Value": _dms(rec.value) if angular else rec.value,
            "StdDev": _sec(rec.sd) if angular else rec.sd,
            "InstHeight": rec.inst_height, "TargHeight": rec.targ_height}


def write_jsonl(path, stations, records, frame, epoch):
    """A DynAdjust JSONL file: a DnaXmlFormat header line, then one
    DnaStation or DnaMeasurement object per line."""
    with open(path, "w") as f:
        f.write(json.dumps({"DnaXmlFormat": {"referenceframe": frame,
                                             "epoch": epoch}}) + "\n")
        for s in stations:
            f.write(json.dumps({"DnaStation": {
                "Name": s.name, "Constraints": s.constraints,
                "Type": s.coord_type, "Description": s.description,
                "StationCoord": {"XAxis": s.p1, "YAxis": s.p2,
                                 "Height": s.p3,
                                 "HemisphereZone": s.hemi_zone}}}) + "\n")
        for r in records:
            f.write(json.dumps({"DnaMeasurement": _jsonl_measurement(r)},
                               default=float) + "\n")


@pytest.fixture(scope="module")
def jsonl(exported):
    """The network's stations and measurements as two .jsonl files,
    written from the records the JAX package reads from its DNA files."""
    d = exported["dna"]
    stns, frame, epoch = jdna.read_dna_stn(str(d / "n.stn"))
    recs, _, _ = jdna.read_dna_msr(str(d / "n.msr"))
    write_jsonl(d / "nstn.jsonl", stns, [], frame, epoch)
    write_jsonl(d / "nmsr.jsonl", [], recs, frame, epoch)
    return [str(d / "nstn.jsonl"), str(d / "nmsr.jsonl")]


def _fields(rec):
    return repr(rec).split("(", 1)[1]


def test_read_jsonl_agrees(jsonl):
    for path in jsonl:
        got, want = tjsonl.read_jsonl(path), jjsonl.read_jsonl(path)
        assert got[2:] == want[2:]                  # frame, epoch
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            assert [_fields(r) for r in a] == [_fields(r) for r in b]
    stations, recs = (tjsonl.read_jsonl(p) for p in jsonl)
    assert len(stations[0]) == 64 and len(recs[1]) > 200
    assert {type(r).__name__ for r in recs[1]} == {
        "GpsCluster", "DirectionSet", "Measurement"}


def _close(a, b):
    """Two records of the same measurement: the same fields, numbers
    within 1e-12 relative (angles cross the JSONL file as DMS)."""
    assert type(a).__name__ == type(b).__name__
    va, vb = vars(a), vars(b)
    assert va.keys() == vb.keys()
    for k in va:
        x, y = va[k], vb[k]
        if k in ("obs", "directions"):
            assert len(x) == len(y)
            for p, q in zip(x, y):
                _close(p, q) if hasattr(p, "vec") else \
                    np.testing.assert_allclose(p[1:3], q[1:3], rtol=1e-12)
        elif k == "covs":
            np.testing.assert_allclose(x, y, rtol=0, atol=0)
        elif isinstance(y, (float, np.ndarray)) and not isinstance(y, bool):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-300)
        else:
            assert x == y, k


def test_import_jsonl_saves_the_dna_network(exported, jsonl, tmp_path):
    nets = {}
    for side, main, files in (
            ("jax", jax_main, jsonl), ("torch", torch_main, jsonl),
            ("dna", torch_main, [str(exported["dna"] / "n.stn"),
                                 str(exported["dna"] / "n.msr")])):
        (tmp_path / side).mkdir()
        assert main(["import", "-n", "n", *files,
                     "--output-folder", str(tmp_path / side)]) == 0
        nets[side] = _load(tmp_path / side)
    t, j, d = nets["torch"], nets["jax"], nets["dna"]
    assert t.names == j.names == d.names
    assert (t.frame, t.epoch) == (j.frame, j.epoch) == (d.frame, d.epoch)
    for k in ("lat", "lon", "height"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        np.testing.assert_array_equal(getattr(t, k), getattr(d, k))
    assert [_fields(r) for r in t.measurements] == \
        [_fields(r) for r in j.measurements]
    assert len(t.measurements) == len(d.measurements)
    for a, b in zip(t.measurements, d.measurements):
        _close(a, b)


def _load(folder):
    with open(folder / "n.net.pkl", "rb") as f:
        return pickle.load(f)
