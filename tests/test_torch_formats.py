"""The port's exchange formats against the JAX package's: discontinuity
files (io_formats/discontinuities.py), DynaML (io_formats/dynaml.py),
SINEX (io_formats/sinex.py), the JSON report (output/json_writer.py),
the association lists (io_formats/assoc_files.py) and the numeric file
diff (diff.py).

Both packages write from the same seeded network and the same
adjustment result (the port's, on the CPU).  Written files must be
byte-identical, below the lines that carry the run's date or the
package's name (SINEX: the %=SNX line and the "Produced by" comment;
JSON: the "software" field).  Both readers must read the files back
equal to each other and to what was written (SINEX values to their 15
printed digits, 1e-14 relative; DynaML coordinates to their 10 printed
decimals of packed DMS, heights to 4).
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu import diff as JD
from dynadjust_tpu.io_formats import assoc_files as JA
from dynadjust_tpu.io_formats import discontinuities as JC
from dynadjust_tpu.io_formats import dynaml as JX
from dynadjust_tpu.io_formats import sinex as JS
from dynadjust_tpu.io_formats.dna import read_dna_msr as j_msr
from dynadjust_tpu.io_formats.dna import read_dna_stn as j_stn
from dynadjust_tpu.output import json_writer as JJ
from dynadjust_tpu.utils.synthetic_mixed import (
    synthetic_mixed_network as j_synthetic)
from dynadjust_tpu_torch import diff as TD
from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.geodesy.conversions import rad_to_dms
from dynadjust_tpu_torch.io_formats import assoc_files as TA
from dynadjust_tpu_torch.io_formats import discontinuities as TC
from dynadjust_tpu_torch.io_formats import dynaml as TX
from dynadjust_tpu_torch.io_formats import sinex as TS
from dynadjust_tpu_torch.io_formats.dna import read_dna_msr as t_msr
from dynadjust_tpu_torch.io_formats.dna import read_dna_stn as t_stn
from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                       write_dna_stn)
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.output import json_writer as TJ
from dynadjust_tpu_torch.utils.synthetic_mixed import synthetic_mixed_network


def _fields(obj):
    """A record as a comparable structure (numpy arrays as lists)."""
    out = {}
    for k, v in vars(obj).items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, list):
            v = [_fields(x) if hasattr(x, "__dict__") else
                 (x.tolist() if isinstance(x, np.ndarray) else x)
                 for x in v]
        out[k] = v
    return out


def _same_records(a, b):
    assert [type(x).__name__ for x in a] == [type(x).__name__ for x in b]
    assert [_fields(x) for x in a] == [_fields(x) for x in b]


def _twins(**kw):
    """A seeded 6 x 6 network (four-character names, as SINEX site codes
    hold) as the JAX package's objects and as the port's, and the port's
    blocked adjustment of it on the CPU.  Each package's writers get its
    own network (they test record types); both get the one result."""
    jnet, jseg = j_synthetic(6, 6, block_rows=3, block_cols=3, seed=3)
    net, seg = from_reference(jnet, jseg)
    res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                             device="cpu", **kw)
    assert res.status == "Converged"
    # the adjustment leaves its coordinates in the port's network
    for k in ("lat", "lon", "height"):
        setattr(jnet, k, getattr(net, k).copy())
    return jnet, net, res


@pytest.fixture(scope="module")
def adjusted():
    return _twins()


# ---------------------------------------------------------------- discont

def _write_disconts(path):
    """A seeded discontinuity file: S0_0 and S1_1 break on 2015-06-01
    (two P windows each), S2_2 has one window (not a discontinuity
    site), and a V row that is skipped."""
    rows = [" S0_0  A    1 P 00:000:00000 15:152:00000 P - antenna",
            " S0_0  A    2 P 15:152:00000 00:000:00000 P - antenna",
            " S1_1  A    1 P 00:000:00000 15:152:00000 P - quake",
            " S1_1  A    2 P 15:152:00000 00:000:00000 P - quake",
            " S1_1  A    1 P 00:000:00000 00:000:00000 V - velocity",
            " S2_2  A    1 P 00:000:00000 00:000:00000 P - none"]
    path.write_text("%=SNX 2.01 TST 20:001:00000\n+SOLUTION/DISCONTINUITY\n"
                    + "\n".join(rows) + "\n-SOLUTION/DISCONTINUITY\n"
                    "%ENDSNX\n")


@pytest.fixture(scope="module")
def dna_with_epochs(tmp_path_factory):
    """DNA files of a seeded 5 x 5 network whose records are observed
    in 2012 (even records) and 2018 (odd records)."""
    d = tmp_path_factory.mktemp("disc")
    net, _ = synthetic_mixed_network(5, 5, block_rows=5, block_cols=5,
                                     seed=4)
    for k, rec in enumerate(net.measurements):
        rec.epoch = "01.06.2012" if k % 2 == 0 else "01.06.2018"
        if hasattr(rec, "epsg_frame"):
            rec.epsg_frame = "GDA2020"
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    _write_disconts(d / "disc.snx")
    return d


def test_discontinuities_match_jax(dna_with_epochs, tmp_path):
    d = dna_with_epochs
    tw = TC.read_discontinuities(str(d / "disc.snx"))
    jw = JC.read_discontinuities(str(d / "disc.snx"))
    assert {k: [_fields(w) for w in v] for k, v in tw.items()} == \
        {k: [_fields(w) for w in v] for k, v in jw.items()}
    assert [w.exists for w in tw["S0_0"]] == [True, True]
    assert not tw["S2_2"][0].exists
    out = []
    for read_s, read_m, mod in ((t_stn, t_msr, TC), (j_stn, j_msr, JC)):
        stns = read_s(str(d / "n.stn"))[0]
        recs = read_m(str(d / "n.msr"))[0]
        pairs = mod.apply_discontinuities(stns, recs,
                                          mod.read_discontinuities(
                                              str(d / "disc.snx")))
        out.append((pairs, stns, recs))
    (tp, ts, tr), (jp, js, jr) = out
    assert tp == jp
    assert {new for _, new in tp} == {"S0_0_1900001", "S0_0_2015152",
                                      "S1_1_1900001", "S1_1_2015152"}
    _same_records(ts, js)
    _same_records(tr, jr)
    TC.export_discontinuities(str(tmp_path / "t.txt"), tw)
    JC.export_discontinuities(str(tmp_path / "j.txt"), jw)
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()


# ----------------------------------------------------------------- DynaML

@pytest.mark.parametrize("kind", ["stn", "msr", "combined"])
def test_dynaml_writers_and_readers_match_jax(adjusted, tmp_path, kind):
    jnet, net, _ = adjusted
    write = {"stn": "write_dynaml_stn", "msr": "write_dynaml_msr",
             "combined": "write_dynaml_combined"}[kind]
    getattr(TX, write)(str(tmp_path / "t.xml"), net)
    getattr(JX, write)(str(tmp_path / "j.xml"), jnet)
    assert (tmp_path / "t.xml").read_text() == \
        (tmp_path / "j.xml").read_text()
    ts, tr, tf, te = TX.read_dynaml(str(tmp_path / "t.xml"))
    js, jr, jf, je = JX.read_dynaml(str(tmp_path / "t.xml"))
    assert (tf, te) == (jf, je) == (net.frame, net.epoch)
    _same_records(ts, js)
    _same_records(tr, jr)
    if kind != "msr":
        assert [s.name for s in ts] == net.names
        assert [s.constraints for s in ts] == net.constraints
        lat = np.array([s.p1 for s in ts])
        hgt = np.array([s.p3 for s in ts])
        assert np.abs(lat - rad_to_dms(net.lat)).max() <= 5e-11
        assert np.abs(hgt - (net.height - net.geoid_sep)).max() <= 5e-5
    if kind != "stn":
        assert len(tr) == len(net.measurements)
        assert [r.mtype for r in tr] == [r.mtype for r in net.measurements]


# ------------------------------------------------------------------ SINEX

def _below_header(path):
    """A SINEX file without its %=SNX line (the run's date) and its
    "Produced by" comment (the package's name)."""
    lines = path.read_text().splitlines()
    assert lines[0].startswith("%=SNX") and "Produced by" in lines[2]
    return lines[1:2] + lines[3:]


@pytest.mark.parametrize("section", ["dense", "blocks"])
def test_sinex_writer_and_reader_match_jax(tmp_path, monkeypatch, section):
    """The dense covariance section (below DTA_DENSE_COV_MAX_STN) and the
    block-scoped one (past it) give the JAX writer's file."""
    if section == "blocks":
        monkeypatch.setenv("DTA_DENSE_COV_MAX_STN", "10")
    jnet, net, res = _twins()
    assert (res.block_cov is not None) == (section == "blocks")
    TS.write_sinex(str(tmp_path / "t.snx"), net, res)
    JS.write_sinex(str(tmp_path / "j.snx"), jnet, res)
    assert _below_header(tmp_path / "t.snx") == \
        _below_header(tmp_path / "j.snx")
    ts, tr, tf, te = TS.read_sinex(str(tmp_path / "t.snx"), "ITRF2014")
    js, jr, jf, je = JS.read_sinex(str(tmp_path / "t.snx"), "ITRF2014")
    assert (tf, te) == (jf, je)
    _same_records(ts, js)
    _same_records(tr, jr)
    assert [s.name for s in ts] == net.names
    xyz = np.array([[s.p1, s.p2, s.p3] for s in ts])
    assert np.abs(xyz - res.xyz).max() <= 1e-14 * np.abs(res.xyz).max()
    got = np.array([ob.vcv for ob in tr[0].obs])
    want = np.array([res.station_cov(i) for i in range(net.nstations)])
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


# ------------------------------------------------------------------- JSON

@pytest.mark.parametrize("report", ["adj", "xyz", "apu", "cor"])
def test_json_reports_match_jax(adjusted, tmp_path, report):
    jnet, tnet, res = adjusted
    for mod, tag, net in ((TJ, "t", tnet), (JJ, "j", jnet)):
        path = str(tmp_path / f"{tag}.jsonl")
        if report == "adj":
            n = mod.write_adj_jsonl(path, net, res, res.initial_xyz)
        elif report == "xyz":
            n = mod.write_xyz_jsonl(path, net, res)
        elif report == "apu":
            n = mod.write_apu_jsonl(path, net, res, 95.0)
        else:
            n = mod.write_cor_jsonl(path, net, res, res.initial_xyz)
        assert n >= net.nstations
    t = (tmp_path / "t.jsonl").read_text().splitlines()
    j = (tmp_path / "j.jsonl").read_text().splitlines()
    assert len(t) == len(j)
    for a, b in zip(t, j):
        a, b = json.loads(a), json.loads(b)
        for rec in (a, b):
            rec.get("DnaAdjustmentReport", {}).pop("software", None)
        assert a == b
    head = json.loads(t[0]).get("DnaAdjustmentReport")
    if head:
        assert head["software"].startswith("dynadjust_tpu_torch")


# ------------------------------------------------------ association lists

def test_association_exports_match_jax(adjusted, tmp_path):
    jnet, net, _ = adjusted
    for name in ("export_asl", "export_aml", "export_map"):
        nt = getattr(TA, name)(str(tmp_path / "t.txt"), net)
        nj = getattr(JA, name)(str(tmp_path / "j.txt"), jnet)
        assert nt == nj
        assert (tmp_path / "t.txt").read_text() == \
            (tmp_path / "j.txt").read_text(), name


# ------------------------------------------------------------------- diff

DIFF_CASES = {
    "equal": ([], 0.0),
    "within": (["-t", "1e-3"], 1e-4),
    "beyond": (["-t", "1e-5"], 1e-4),
    "marker": (["--skip-to-marker", "BODY", "-t", "1e-3"], 1e-4),
    "headers": (["--skip-headers", "2", "-v"], 1e-2),
}


@pytest.mark.parametrize("case", list(DIFF_CASES))
def test_diff_matches_jax(tmp_path, capsys, case):
    """compare_files and the diff entry point on seeded number tables
    (the second file perturbed by `eps`, and a header line that differs
    in text): the same verdict, differences, output and exit code."""
    args, eps = DIFF_CASES[case]
    rng = np.random.default_rng(len(case))
    vals = rng.normal(size=(12, 4)) * 100
    body = ["BODY"] + [" ".join(f"{v:.6f}" for v in row) for row in vals]
    (tmp_path / "a.txt").write_text("\n".join(["run A", "x 1"] + body))
    bvals = vals + eps * rng.choice([-1, 1], size=vals.shape)
    (tmp_path / "b.txt").write_text("\n".join(
        ["run B", "x 1"] + ["BODY"] + [" ".join(f"{v:.6f}" for v in row)
                                        for row in bvals]))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    out = []
    for mod in (TD, JD):
        capsys.readouterr()
        rc = mod.main([a, b, *args])
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    kw = {"tolerance": float(args[args.index("-t") + 1])
          if "-t" in args else 0.0}
    assert TD.compare_files(a, b, **kw) == JD.compare_files(a, b, **kw)
    assert os.path.exists(a)
