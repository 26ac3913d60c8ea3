"""The port's CLI options against the JAX package's, and its refusals.

Import screening and export flags (DNA, DynaML, association lists,
discontinuity files), adjust's report and export flags (JSON, SINEX,
DynaML) and the SINEX and DynaML inputs run through both CLIs in-process
on the same seeded 8 x 8 DNA files (the port with --device cpu); the
saved networks and the written files must agree (below the lines that
carry the run's date or the package's name; DNA measurement files with
their angles' seconds as the port writes them).  adjust and dynadjust
--phased --tpu --devices 2 --device cpu (two gloo ranks) print the JAX
CLI's statistics with --devices 4; --devices with --staged-adjustment
exits 1 with the JAX CLI's words, and adjust --tpu or dynadjust --tpu
without --device cpu
exits non-zero when no card is present, before writing anything, while
the host route runs without a card.
"""

import json
import pickle
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from test_torch_dna import zero_padded_seconds

MARKER = "Number of unknown parameters"


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                     seed=1)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    (d / "rename.txt").write_text("S0_0 RENAMED_A\nS1_1 RENAMED_B\n")
    # the same network observed in 2012 (even records) and 2018 (odd),
    # and a discontinuity file breaking S0_0 and S1_1 in 2015
    for k, rec in enumerate(net.measurements):
        rec.epoch = "01.06.2012" if k % 2 == 0 else "01.06.2018"
        if hasattr(rec, "epsg_frame"):
            rec.epsg_frame = "GDA2020"
    write_dna_msr(str(d / "e.msr"), net)
    rows = [" S0_0  A    1 P 00:000:00000 15:152:00000 P - antenna",
            " S0_0  A    2 P 15:152:00000 00:000:00000 P - antenna",
            " S1_1  A    1 P 00:000:00000 15:152:00000 P - quake",
            " S1_1  A    2 P 15:152:00000 00:000:00000 P - quake"]
    (d / "disc.snx").write_text("+SOLUTION/DISCONTINUITY\n" + "\n".join(rows)
                                + "\n-SOLUTION/DISCONTINUITY\n%ENDSNX\n")
    return d


def _import(main, folder, dna, extra, msr="n.msr"):
    folder.mkdir()
    rc = main(["import", "-n", "n", str(dna / "n.stn"), str(dna / msr),
               "--output-folder", str(folder), *extra])
    return rc


def _net(folder):
    with open(folder / "n.net.pkl", "rb") as f:
        return pickle.load(f)


def _body(path):
    """A written file without its header lines (title, dates, paths); a
    DNA measurement file with its angles' seconds as the port writes
    them."""
    lines = path.read_text().splitlines()
    if path.name.endswith(".msr"):
        lines = list(map(zero_padded_seconds, lines))
    return [ln for ln in lines
            if not ln.startswith(("!#=DNA", "*", "File ", "Command"))]


IMPORT_FLAGS = {
    "flag-unused": ["--flag-unused-stations", "--test-integrity"],
    "include-types": ["--include-msr-types", "GSL"],
    "exclude-types": ["--exclude-msr-types", "A"],
    "stations": ["--include-stns-assoc-msrs", "S2_2,S3_3,S2_3"],
    "exclude-stations": ["--exclude-stns", "S0_0,S7_7"],
    "rename": ["--stn-renaming-file", "{dna}/rename.txt"],
    "scale": ["--vscale", "2.0", "--prefer-single-x-as-g"],
    "export": ["--export-dna", "--output-msr-to-stn"],
    "similar": ["--search-similar-msr", "--ignore-similar-msr",
                "--remove-ignored-msr"],
    "frame": ["-r", "ITRF2014", "--override-input-ref-frame",
              "--observation-epoch", "2019"],
    "xml-files": ["--export-xml-files"],
    "single-xml-file": ["--single-xml-file"],
    "assoc-lists": ["--export-asl-file", "--export-aml-file",
                    "--export-map-file"],
    "discontinuities": ["-d", "{dna}/disc.snx", "--export-discont-file",
                        "--include-stns", "S0_0,S1_1,S0_1,S1_0"],
}
# the files each new export case must write
EXPORTED = {"xml-files": ("nstn.xml", "nmsr.xml"),
            "single-xml-file": ("n.xml",),
            "assoc-lists": ("n.asl.txt", "n.aml.txt", "n.map.txt"),
            "discontinuities": ("n.discont.txt",)}
# files the import cases may write (compared where the JAX CLI wrote one)
IMPORT_FILES = ("n.export.stn", "n.export.msr", "n.m2s", "nstn.xml",
                "nmsr.xml", "n.xml", "n.asl.txt", "n.aml.txt", "n.map.txt",
                "n.discont.txt")


@pytest.mark.parametrize("case", list(IMPORT_FLAGS))
def test_import_flags_agree(dna, tmp_path, case):
    extra = [a.format(dna=dna) for a in IMPORT_FLAGS[case]]
    msr = "e.msr" if case == "discontinuities" else "n.msr"
    assert _import(jax_main, tmp_path / "jax", dna, extra, msr) == 0
    assert _import(torch_main, tmp_path / "torch", dna, extra, msr) == 0
    nj, nt = _net(tmp_path / "jax"), _net(tmp_path / "torch")
    assert nt.names == nj.names
    assert nt.constraints == nj.constraints
    np.testing.assert_array_equal(nt.lat, nj.lat)
    np.testing.assert_array_equal(nt.height, nj.height)
    assert (nt.frame, nt.epoch) == (nj.frame, nj.epoch)
    assert len(nt.measurements) == len(nj.measurements)
    for a, b in zip(nt.measurements, nj.measurements):
        assert type(a).__name__ == type(b).__name__
        assert repr(a).split("(", 1)[1] == repr(b).split("(", 1)[1]
    written = [name for name in IMPORT_FILES
               if (tmp_path / "jax" / name).exists()]
    for name in written:
        assert (_body(tmp_path / "torch" / name)
                == _body(tmp_path / "jax" / name)), name
    assert set(EXPORTED.get(case, ())) <= set(written)
    if case == "discontinuities":
        assert {"S0_0_2015152", "S1_1_1900001"} <= set(nt.names)


def test_report_files_agree(dna, tmp_path):
    """adjust's report options on the host route: .adj with adjusted
    measurements and corrections, .apu and .cor, Type B."""
    args = ["--output-adj-msr", "--output-pos-uncertainty",
            "--output-corrections-file", "--stn-corrections",
            "--type-b-global", "0.001,0.001,0.002",
            "--export-dna-stn-file", "--output-msr-to-stn"]
    for main, sub, dev in ((jax_main, "jax", []),
                           (torch_main, "torch", ["--device", "cpu"])):
        folder = tmp_path / sub
        assert _import(main, folder, dna, []) == 0
        assert main(["adjust", "n", *args, *dev,
                     "--output-folder", str(folder)]) == 0
    j, t = tmp_path / "jax", tmp_path / "torch"
    for name in ("n.simult.adj", "n.apu", "n.cor"):
        lines_j = (j / name).read_text().splitlines()
        lines_t = (t / name).read_text().splitlines()
        mark = MARKER if name.endswith(".adj") else "Station"
        ij = next(k for k, ln in enumerate(lines_j) if mark in ln)
        it = next(k for k, ln in enumerate(lines_t) if mark in ln)
        assert lines_t[it:] == lines_j[ij:], name
    assert _body(t / "n.adjusted.stn") == _body(j / "n.adjusted.stn")


ADJUST_EXPORTS = {
    "json": (["--output-json", "--output-pos-uncertainty",
              "--output-corrections-file"],
             ["n.adj.jsonl", "n.xyz.jsonl", "n.apu.jsonl", "n.cor.jsonl"]),
    "snx": (["--export-snx"], ["n.snx"]),
    "xml": (["--export-xml"], ["n.adjusted.stn.xml", "n.adjusted.msr.xml"]),
    "xml-stn-msr": (["--export-xml-stn-file", "--export-xml-msr-file"],
                    ["n.adjusted.stn.xml", "n.adjusted.msr.xml"]),
}


def _json_records(path):
    """A JSONL report without the "software" field (the package's
    name)."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.get("DnaAdjustmentReport", {}).pop("software", None)
        out.append(rec)
    return out


@pytest.mark.parametrize("case", list(ADJUST_EXPORTS))
def test_adjust_exports_agree(dna, tmp_path, case):
    """adjust's JSON, SINEX and DynaML exports on the host route: the JAX
    CLI's files (JSON records equal but for the software name; SINEX
    below its %=SNX date line and "Produced by" comment)."""
    flags, files = ADJUST_EXPORTS[case]
    for main, sub, dev in ((jax_main, "jax", []),
                           (torch_main, "torch", ["--device", "cpu"])):
        assert _import(main, tmp_path / sub, dna, []) == 0
        assert main(["adjust", "n", *flags, *dev,
                     "--output-folder", str(tmp_path / sub)]) == 0
    for name in files:
        t, j = tmp_path / "torch" / name, tmp_path / "jax" / name
        if name.endswith(".jsonl"):
            assert _json_records(t) == _json_records(j), name
        elif name.endswith(".snx"):
            lt, lj = t.read_text().splitlines(), j.read_text().splitlines()
            assert lt[0].split()[:3] == lj[0].split()[:3]
            assert lt[3:] == lj[3:] and lt[1] == lj[1]
        else:
            assert t.read_text() == j.read_text(), name


@pytest.mark.parametrize("ext", [".snx", ".xml"])
def test_sinex_and_dynaml_inputs_agree(dna, tmp_path, ext):
    """A SINEX file (written by adjust --export-snx) and a combined
    DynaML file (import --single-xml-file) imported by both CLIs: the
    same saved network."""
    src = tmp_path / "src"
    assert _import(jax_main, src, dna, ["--single-xml-file"]) == 0
    assert jax_main(["adjust", "n", "--export-snx",
                     "--output-folder", str(src)]) == 0
    path = str(src / ("n.snx" if ext == ".snx" else "n.xml"))
    for main, sub in ((jax_main, "jax"), (torch_main, "torch")):
        (tmp_path / sub).mkdir()
        assert main(["import", "-n", "n", path, "-r", "ITRF2014",
                     "--output-folder", str(tmp_path / sub)]) == 0
    nj, nt = _net(tmp_path / "jax"), _net(tmp_path / "torch")
    assert nt.names == nj.names and len(nt.names) > 0
    np.testing.assert_array_equal(nt.lat, nj.lat)
    np.testing.assert_array_equal(nt.height, nj.height)
    assert (nt.frame, nt.epoch) == (nj.frame, nj.epoch)
    assert len(nt.measurements) == len(nj.measurements) > 0
    for a, b in zip(nt.measurements, nj.measurements):
        assert type(a).__name__ == type(b).__name__
        assert repr(a).split("(", 1)[1] == repr(b).split("(", 1)[1]


REFUSED = {
    "adjust": [(["--phased", "--tpu", "--devices", "2",
                 "--staged-adjustment", "--create-stage-files"],
                "--devices cannot be combined with --staged-adjustment")],
    "dynadjust": [(["--phased", "--tpu", "--devices", "2",
                    "--staged-adjustment"],
                   "--devices cannot be combined with --staged-adjustment")],
}
CASES = [(verb, flags, message) for verb, rows in REFUSED.items()
         for flags, message in rows]


@pytest.mark.parametrize("verb,flags,message", CASES,
                         ids=["_".join([v, *f]) for v, f, _ in CASES])
def test_unported_flags_exit_nonzero(dna, tmp_path, capsys, verb, flags,
                                     message):
    """Flags the port refuses, with the JAX CLI's words: --devices with
    --staged-adjustment (the host-streamed factors are single-device);
    dynadjust stops before its first stage."""
    if verb == "adjust":
        assert _import(torch_main, tmp_path / "w", dna, []) == 0
        argv = ["adjust", "n", *flags, "--device", "cpu"]
    else:
        (tmp_path / "w").mkdir()
        argv = ["dynadjust", "-n", "n", str(dna / "n.stn"),
                str(dna / "n.msr"), *flags, "--device", "cpu"]
    capsys.readouterr()
    assert torch_main([*argv, "--output-folder", str(tmp_path / "w")]) == 1
    err = capsys.readouterr().err
    assert "- Error:" in err and message in err, err
    if verb == "dynadjust":
        assert not list((tmp_path / "w").iterdir())


DEVICES_SEGMENT = ["--min-inner-stns", "10", "--max-block-stns", "20"]


def _devices_run(main, folder, dna, verb, extra):
    """import -> segment -> adjust --phased --tpu (or the dynadjust verb)
    in folder: (exit code, the saved results)."""
    if verb == "adjust":
        assert _import(main, folder, dna, []) == 0
        assert main(["segment", "n", *DEVICES_SEGMENT, "--output-folder",
                     str(folder)]) == 0
        argv = ["adjust", "n"]
    else:
        folder.mkdir()
        argv = ["dynadjust", "-n", "n", str(dna / "n.stn"),
                str(dna / "n.msr"), *DEVICES_SEGMENT]
    rc = main([*argv, "--phased", "--tpu", *extra, "--output-folder",
               str(folder)])
    with open(folder / "n.results.pkl", "rb") as f:
        return rc, pickle.load(f)


@pytest.mark.parametrize("verb", ["adjust", "dynadjust"])
def test_devices_route_matches_jax(dna, tmp_path, capsys, verb):
    """--phased --tpu --devices 2 --device cpu: two gloo ranks (this
    process and one spawned) print the JAX CLI's Chi squared and Sigma
    zero with --devices 4 on the same files (tests/test_cli.py:180-205),
    and save xyz within 1e-8 m of the port's single-device run."""
    runs = {}
    for key, main, extra in (
            ("jax", jax_main, ["--devices", "4"]),
            ("torch", torch_main, ["--devices", "2", "--device", "cpu"]),
            ("single", torch_main, ["--device", "cpu"])):
        capsys.readouterr()
        rc, res = _devices_run(main, tmp_path / key, dna, verb, extra)
        text = capsys.readouterr().out
        runs[key] = (rc, res, re.findall(r"Chi squared [\d.]+|"
                                         r"Sigma zero [\d.]+", text))
    for key, (rc, res, stats) in runs.items():
        assert rc == 0 and res.status == "Converged", key
        assert len(stats) >= 2, (key, stats)
    assert runs["torch"][2][:2] == runs["jax"][2][:2]
    assert runs["torch"][1].iterations == runs["single"][1].iterations
    assert np.abs(runs["torch"][1].xyz - runs["single"][1].xyz).max() \
        <= 1e-8


@pytest.mark.parametrize("route", [
    ["--tpu"], ["--phased", "--tpu"], ["--block1-phased", "--tpu"],
    ["--phased", "--tpu", "--tpu-super-blocks", "2"],
    ["dynadjust", "--phased", "--tpu"]])
def test_adjust_without_card_exits_nonzero(dna, tmp_path, capsys, route):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    if route[0] == "dynadjust":
        # the pipeline verb stops before its import stage: nothing written
        (tmp_path / "w").mkdir()
        capsys.readouterr()
        assert torch_main(["dynadjust", "-n", "n", str(dna / "n.stn"),
                           str(dna / "n.msr"), *route[1:],
                           "--output-folder", str(tmp_path / "w")]) == 1
        assert "--device cpu" in capsys.readouterr().err
        assert not list((tmp_path / "w").iterdir())
        return
    assert _import(torch_main, tmp_path / "w", dna, []) == 0
    if route[0] != "--tpu":
        assert torch_main(["segment", "n", "--min-inner-stns", "10",
                           "--max-block-stns", "20",
                           "--output-folder", str(tmp_path / "w")]) == 0
    capsys.readouterr()
    assert torch_main(["adjust", "n", *route,
                       "--output-folder", str(tmp_path / "w")]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "w" / "n.results.pkl").exists()


def test_host_adjust_needs_no_card(dna, tmp_path):
    """The host float64 route never touches the device: it runs with the
    default --device on a machine with or without a card, and writes what
    the route with --device cpu writes."""
    out = {}
    for name, extra in (("default", []), ("cpu", ["--device", "cpu"])):
        w = tmp_path / name
        assert _import(torch_main, w, dna, []) == 0
        assert torch_main(["adjust", "n", "--output-folder", str(w),
                           *extra]) == 0
        out[name] = w
    for ext in ("xyz", "simult.adj"):
        a = (out["default"] / f"n.{ext}").read_text().split(MARKER)[-1]
        b = (out["cpu"] / f"n.{ext}").read_text().split(MARKER)[-1]
        assert a == b, ext
