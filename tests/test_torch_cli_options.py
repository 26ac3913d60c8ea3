"""The port's CLI options against the JAX package's, and its refusals.

Import screening and export flags, and adjust's report flags, run through
both CLIs in-process on the same seeded 8 x 8 DNA files (the port with
--device cpu); the saved networks and the written files must agree.  A
flag or input whose module the port does not hold exits non-zero naming
its ROADMAP item, and adjust --tpu without --device cpu exits non-zero
when no card is present, while the host route runs without a card.
"""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main

MARKER = "Number of unknown parameters"


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                     seed=1)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    (d / "rename.txt").write_text("S0_0 RENAMED_A\nS1_1 RENAMED_B\n")
    return d


def _import(main, folder, dna, extra):
    folder.mkdir()
    rc = main(["import", "-n", "n", str(dna / "n.stn"), str(dna / "n.msr"),
               "--output-folder", str(folder), *extra])
    return rc


def _net(folder):
    with open(folder / "n.net.pkl", "rb") as f:
        return pickle.load(f)


def _body(path):
    """A written file without its header lines (title, dates, paths)."""
    lines = path.read_text().splitlines()
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
}


@pytest.mark.parametrize("case", list(IMPORT_FLAGS))
def test_import_flags_agree(dna, tmp_path, case):
    extra = [a.format(dna=dna) for a in IMPORT_FLAGS[case]]
    assert _import(jax_main, tmp_path / "jax", dna, extra) == 0
    assert _import(torch_main, tmp_path / "torch", dna, extra) == 0
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
    for name in ("n.export.stn", "n.export.msr", "n.m2s"):
        if (tmp_path / "jax" / name).exists():
            assert (_body(tmp_path / "torch" / name)
                    == _body(tmp_path / "jax" / name)), name


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


UNPORTED = {
    "import": [(["--simulate"], "M8"), (["--export-bst-bms"], "M8"),
               (["--export-xml-files"], "M8"),
               (["-d", "disc.snx"], "M8")],
    "adjust": [(["--phased", "--tpu", "--devices", "2"], "M7"),
               (["--block1-phased", "--tpu"], "M9"),
               (["--output-json"], "M8"), (["--export-snx"], "M8"),
               (["--export-xml"], "M8")],
}
CASES = [(verb, flags, item) for verb, rows in UNPORTED.items()
         for flags, item in rows]


@pytest.mark.parametrize("verb,flags,item", CASES,
                         ids=["_".join([v, *f]) for v, f, _ in CASES])
def test_unported_flags_exit_nonzero(dna, tmp_path, capsys, verb, flags,
                                     item):
    if verb == "adjust":
        assert _import(torch_main, tmp_path / "w", dna, []) == 0
        argv = ["adjust", "n", *flags, "--device", "cpu"]
    else:
        (tmp_path / "w").mkdir()
        argv = ["import", "-n", "n", str(dna / "n.stn"),
                str(dna / "n.msr"), *flags]
    capsys.readouterr()
    assert torch_main([*argv, "--output-folder", str(tmp_path / "w")]) == 1
    err = capsys.readouterr().err
    assert "not ported" in err and f"ROADMAP.md {item}" in err, err


@pytest.mark.parametrize("ext", [".bst", ".jsonl", ".snx", ".xml"])
def test_unported_inputs_exit_nonzero(tmp_path, capsys, ext):
    path = tmp_path / f"in{ext}"
    path.write_text("")
    assert torch_main(["import", "-n", "n", str(path),
                       "--output-folder", str(tmp_path)]) == 1
    assert "ROADMAP.md M8" in capsys.readouterr().err


@pytest.mark.parametrize("route", [
    ["--tpu"], ["--phased", "--tpu"],
    ["--phased", "--tpu", "--tpu-super-blocks", "2"]])
def test_adjust_without_card_exits_nonzero(dna, tmp_path, capsys, route):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert _import(torch_main, tmp_path / "w", dna, []) == 0
    if "--phased" in route:
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
