"""The port's reftran, geoid, metadata, diff and dynadjust verbs against
the JAX package's CLI, in-process on the same files (the port with
--device cpu where a device route runs).

Inputs, made from seeds: an 8 x 8 synthetic mixed network written as DNA
files (stations as ellipsoidal heights, LLh; level differences made
orthometric for the grid), a 1' NTv2 grid over it with N 3-7 m and
deflections <= 1.5" (utils/synthetic_geoid.py), a pair of plates with
their Euler poles, an AUSGeoid .dat file and a point file.

Each verb runs in its own folder per package.  Held equal: exit codes,
what the verb prints (with the folder names made alike), the saved
networks (station positions within 1e-9 m cartesian, N values,
deflections and frames exactly), and the written files (byte-identical,
or below the lines holding the run's date, its folder or the package's
name).  dynadjust's host routes write .adj and .xyz byte-identical below
"Number of unknown parameters" / "Adjusted Coordinates"; its
--phased --tpu route agrees with the host phased route within 1e-4 in
every printed number and 1e-7 m in the saved xyz; dynadjust.log holds
the same stages once its dates and times are masked.
"""

import contextlib
import io
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.diff import compare_files
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from dynadjust_tpu_torch.geodesy.conversions import geo_to_cart
from dynadjust_tpu_torch.geoid.gridtools import write_gsb
from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                       write_dna_stn)
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.utils.synthetic_geoid import (orthometric_levelling,
                                                       synthetic_geoid_grid)
from test_torch_dna import zero_padded_seconds

MARKER = "Number of unknown parameters"
SEGMENT = ["--min-inner-stns", "20", "--max-block-stns", "40"]
FRAME = ["-r", "ITRF2014", "-e", "01.01.2024"]
MAINS = {"jax": jax_main, "torch": torch_main}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    grid = synthetic_geoid_grid(-37.5, -36.0, 142.5, 144.0, seed=1)
    write_gsb(grid, str(d / "grid.gsb"))
    jnet, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                      seed=6)
    net = from_reference(jnet)
    orthometric_levelling(net, grid)
    write_dna_stn(str(d / "n.stn"), net, ellipsoidal=True)
    write_dna_msr(str(d / "n.msr"), net)
    (d / "plates.dig").write_text(
        "AU\n142.0,-38.0\n143.2,-38.0\n143.2,-36.0\n142.0,-36.0\n"
        "142.0,-38.0\n*** end ***\n"
        "XP\n143.2,-38.0\n144.5,-38.0\n144.5,-36.0\n143.2,-36.0\n"
        "143.2,-38.0\n*** end ***\n")
    (d / "poles.dat").write_text("AU  32.2447  38.2022  0.6285\n"
                                 "XP  -12.3400  101.2500  0.4100\n")
    rng = np.random.default_rng(8)
    rows = []
    for r in range(4):
        for c in range(5):
            lat_s = 36 * 3600 + 50 * 60 - r * 120
            lon_s = 143 * 3600 + c * 120
            rows.append(f"GEO {rng.uniform(3, 7):8.3f} S{lat_s // 3600} "
                        f"{lat_s % 3600 // 60} {lat_s % 60:.3f} "
                        f"E{lon_s // 3600} {lon_s % 3600 // 60} "
                        f"{lon_s % 60:.3f} {rng.uniform(-1, 1):8.3f} "
                        f"{rng.uniform(-1, 1):8.3f}")
    (d / "g.dat").write_text("\n".join(rows) + "\n")
    pts = [f"{'P%d' % k:<12}{-36.9 + 0.05 * k:>16.9f}"
           f"{143.1 + 0.02 * k:>15.9f}{50.0 + k:>14.3f}" for k in range(8)]
    (d / "pts.dat").write_text("\n".join(pts) + "\n")
    return d


def _run(side, folder, argv, files=True):
    """One verb of one CLI in `folder`: (exit code, stdout, stderr),
    masked as _masked does."""
    folder.mkdir(parents=True, exist_ok=True)
    out, err = io.StringIO(), io.StringIO()
    args = [*argv, "--output-folder", str(folder)] if files else argv
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = MAINS[side](args)
    return rc, _masked(out.getvalue(), folder), _masked(err.getvalue(),
                                                          folder)


def _masked(text, folder):
    """Printed text with the folder as <dir>, elapsed seconds as <secs>,
    and without the port's per-step times line."""
    text = re.sub(r"\(\d+\.\d+ s\)", "(<secs>)",
                  text.replace(str(folder), "<dir>"))
    return "".join(ln for ln in text.splitlines(True)
                   if not ln.startswith("  Times (s):"))


def _both(tmp_path, verbs, files=True):
    """Run the verbs in order on each side; returns the last verb's
    (exit code, stdout, stderr) per side."""
    last = {}
    for side in MAINS:
        for argv in verbs:
            last[side] = _run(side, tmp_path / side, argv, files)
    return last


def _import(inputs, extra=()):
    return ["import", "-n", "n", str(inputs / "n.stn"),
            str(inputs / "n.msr"), *extra]


def _net(folder):
    with open(folder / "n.net.pkl", "rb") as f:
        return pickle.load(f)


def _same_networks(a, b):
    assert (a.frame, a.epoch) == (b.frame, b.epoch)
    xa = np.stack(geo_to_cart(a.lat, a.lon, a.height, a.datum.ellipsoid), -1)
    xb = np.stack(geo_to_cart(b.lat, b.lon, b.height, b.datum.ellipsoid), -1)
    assert np.abs(xa - xb).max() <= 1e-9
    for k in ("geoid_sep", "meridian_def", "vertical_def", "height_ref"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.station_frames == b.station_frames
    assert [getattr(r, "epsg_frame", "") for r in a.measurements] == \
        [getattr(r, "epsg_frame", "") for r in b.measurements]
    for ra, rb in zip(a.measurements, b.measurements):
        for oa, ob in zip(getattr(ra, "obs", ()), getattr(rb, "obs", ())):
            assert np.abs(oa.vec - ob.vec).max() <= \
                1e-12 * max(1.0, np.abs(ob.vec).max())


def _body(path):
    """A written file without the lines that carry the run's date, its
    folder or the package's name; a DNA measurement file with its
    angles' seconds as the port writes them."""
    lines = path.read_text().splitlines()
    if path.name.endswith(".msr"):
        lines = list(map(zero_padded_seconds, lines))
    return [ln for ln in lines
            if not ln.startswith(("!#=DNA", "* Station file",
                                  "* Measurement file", "# "))]



# reftran keeps the network's epoch label (the import's, 01.01.2020),
# which names its exports: ROADMAP.md F6, a condition of the JAX package
REFTRAN = {
    "frame": (["reftran", "n", *FRAME], []),
    "project-datum": (["reftran", "n"], []),
    "export-dna": (["reftran", "n", "-r", "GDA94", "--export-dna"],
                   ["n.GDA94.stn", "n.GDA94.msr"]),
    "export-xml": (["reftran", "n", *FRAME, "--export-xml"],
                   ["n.ITRF2014.01.01.2020stn.xml",
                    "n.ITRF2014.01.01.2020msr.xml"]),
    "single-xml": (["reftran", "n", *FRAME, "--export-xml",
                    "--single-xml-file"], ["n.ITRF2014.01.01.2020.xml"]),
    "plates": (["reftran", "n", "-r", "ITRF2008", "-e", "01.01.2020",
                "-b", "{d}/plates.dig", "-m", "{d}/poles.dat"], []),
    "override": (["reftran", "n", "-r", "ITRF2008",
                  "--override-input-ref-frame"], []),
    "missing-poles": (["reftran", "n", "-b", "{d}/plates.dig"], []),
}


@pytest.mark.parametrize("mode", list(REFTRAN))
def test_reftran_verb_matches_jax(inputs, tmp_path, mode):
    argv, files = REFTRAN[mode]
    argv = [a.format(d=inputs) for a in argv]
    imp = _import(inputs, ["-r", "ITRF2014", "-e", "01.01.2010"]
                  if mode == "plates" else [])
    out = _both(tmp_path, [imp, argv])
    assert out["torch"] == out["jax"]
    if mode == "missing-poles":
        assert out["torch"][0] == 1
        return
    assert out["torch"][0] == 0
    _same_networks(_net(tmp_path / "torch"), _net(tmp_path / "jax"))
    for name in files:
        assert _body(tmp_path / "torch" / name) == \
            _body(tmp_path / "jax" / name), name


GEOID = {
    "network": (["geoid", "n", "-g", "{d}/grid.gsb"], []),
    "convert": (["geoid", "n", "-g", "{d}/grid.gsb", "--convert-stn-hts"],
                []),
    "bilinear-geo-file": (["geoid", "n", "-g", "{d}/grid.gsb", "-m", "0",
                           "--convert-stn-hts", "--export-dna-geo-file"],
                          ["n.geo"]),
    "summary": (["geoid", "-g", "{d}/grid.gsb", "--summary"], []),
    "interactive": (["geoid", "-g", "{d}/grid.gsb", "--interactive",
                     "--latitude", "-36.85", "--longitude", "143.1",
                     "--decimal-degrees"], []),
    "interactive-dms": (["geoid", "-g", "{d}/grid.gsb", "-e",
                         "--latitude", "-36.5130", "--longitude",
                         "143.0645", "-m", "1"], []),
    "ascii": (["geoid", "-g", "{d}/grid.gsb", "--export-ascii-grid",
               "{o}/g.asc"], ["g.asc"]),
    "gsb": (["geoid", "-g", "{d}/grid.gsb", "--export-ntv2-gsb-file",
             "{o}/g.gsb"], ["g.gsb"]),
    "point-file": (["geoid", "-g", "{d}/grid.gsb", "-t", "{o}/pts.dat",
                    "--decimal-degrees"], ["pts.dat.geoid.txt"]),
    "create-ntv2": (["geoid", "-g", "{o}/new.gsb", "--create-ntv2",
                     "{d}/g.dat", "--creation-date", "17.10.2026"],
                    ["new.gsb"]),
    "create-c-d": (["geoid", "-g", "{o}/new.gsb", "-c", "-d",
                    "{d}/g.dat"], ["new.gsb"]),
    "no-network": (["geoid", "-g", "{d}/grid.gsb"], []),
}


@pytest.mark.parametrize("mode", list(GEOID))
def test_geoid_verb_matches_jax(inputs, tmp_path, mode):
    argv, files = GEOID[mode]
    out = {}
    for side in MAINS:
        folder = tmp_path / side
        folder.mkdir()
        shutil.copy(inputs / "pts.dat", folder / "pts.dat")
        verbs = [_import(inputs), [a.format(d=inputs, o=folder)
                                   for a in argv]]
        for v in verbs:
            out[side] = _run(side, folder, v)
    rc, stdout, stderr = out["torch"]
    assert out["torch"] == out["jax"], (out["torch"], out["jax"])
    assert rc == (1 if mode == "no-network" else 0), stderr
    if argv[1] == "n":
        _same_networks(_net(tmp_path / "torch"), _net(tmp_path / "jax"))
    for name in files:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_metadata_matches_jax(inputs, tmp_path):
    out = _both(tmp_path, [_import(inputs), ["reftran", "n", *FRAME],
                           ["geoid", "n", "-g", str(inputs / "grid.gsb")],
                           ["metadata", "n"]])
    assert out["torch"] == out["jax"]
    assert "Reftran applied:" in out["torch"][1]


def _dynadjust(inputs, extra):
    return ["dynadjust", "-n", "n", str(inputs / "n.stn"),
            str(inputs / "n.msr"), *FRAME, "-g", str(inputs / "grid.gsb"),
            "--convert-stn-hts", *SEGMENT, *extra]


def _log_stages(folder):
    """dynadjust.log with its dates and stage times masked."""
    text = (folder / "dynadjust.log").read_text()
    text = re.sub(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "<when>", text,
                  flags=re.M)
    return re.sub(r"\(\d+\.\d+ s\)", "(<secs>)", text)


def _below(path, marker):
    lines = path.read_text().splitlines()
    i = next(k for k, ln in enumerate(lines) if marker in ln)
    return lines[i:]


@pytest.mark.parametrize("route", ["simultaneous", "phased"])
def test_dynadjust_host_routes_match_jax(inputs, tmp_path, route):
    """The pipeline verb on the host routes: every stage's output and
    the .adj and .xyz byte-identical below their headers."""
    extra = ["--phased"] if route == "phased" else []
    out = _both(tmp_path, [_dynadjust(inputs, extra)])
    assert out["torch"][0] == out["jax"][0] == 0
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert _log_stages(t) == _log_stages(j)
    # segment runs with --phased only (no explicit program switches)
    want = ["import", "reftran", "geoid", "segment", "adjust"]
    if route != "phased":
        want.remove("segment")
    assert re.findall(r"(\w+)\s+done", _log_stages(t)) == want
    adj = "n.phased.adj" if route == "phased" else "n.simult.adj"
    assert _below(t / adj, MARKER) == _below(j / adj, MARKER)
    assert _below(t / "n.xyz", "Adjusted Coordinates") == \
        _below(j / "n.xyz", "Adjusted Coordinates")
    assert "*** PASSED ***" in out["torch"][1]
    _same_networks(_net(t), _net(j))


def test_dynadjust_device_route_matches_host(inputs, tmp_path):
    """dynadjust --phased --tpu --device cpu (the port) against the host
    phased route (the JAX CLI): numbers within 1e-4, xyz within 1e-7 m,
    the same log stages."""
    _run("jax", tmp_path / "jax", _dynadjust(inputs, ["--phased"]))
    rc, stdout, _ = _run("torch", tmp_path / "torch", _dynadjust(
        inputs, ["--phased", "--tpu", "--device", "cpu"]))
    assert rc == 0 and "*** PASSED ***" in stdout
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert _log_stages(t) == _log_stages(j)
    for name, mark in (("n.phased.adj", MARKER), ("n.xyz", "")):
        ok, diffs = compare_files(str(t / name), str(j / name), 1e-4,
                                  skip_to_marker=mark)
        assert ok, diffs[:5]
    rj = pickle.load(open(j / "n.results.pkl", "rb"))
    rt = pickle.load(open(t / "n.results.pkl", "rb"))
    assert np.abs(rt.xyz - rj.xyz).max() <= 1e-7
    assert rt.iterations == rj.iterations


def test_dynadjust_stage_switches_and_project(inputs, tmp_path):
    """--export-project writes the same project file; the implicit
    <net>.dnaproj then drives a later run of explicit stages, and a
    failed stage stops the pipeline, in both CLIs alike."""
    out = {}
    for side in MAINS:
        folder = tmp_path / side
        for argv in (_dynadjust(inputs, ["--export-project",
                                         str(folder / "p.dnaproj"),
                                         "--import", "--reftran",
                                         "--geoid"]),
                     ["dynadjust", "-n", "n", "--segment", *SEGMENT],
                     ["dynadjust", "-n", "n", "--adjust", "--phased"]):
            out[side] = _run(side, folder, argv)
    assert out["torch"] == out["jax"]
    j, t = tmp_path / "jax", tmp_path / "torch"
    for name in ("p.dnaproj", "n.dnaproj"):
        pt, pj = (_masked((f / name).read_text(), f) for f in (t, j))
        assert pt == pj, name
    assert _log_stages(t) == _log_stages(j)
    assert _below(t / "n.phased.adj", MARKER) == \
        _below(j / "n.phased.adj", MARKER)
    # no stage switch and no files: refused alike
    out = _both(tmp_path / "none", [["dynadjust", "-n", "m"]])
    assert out["torch"] == out["jax"] and out["torch"][0] == 1


def test_dynadjust_export_xml(inputs, tmp_path):
    """--export-xml reaches the reftran stage too (the JAX CLI's reftran
    stage stops there with an AttributeError: ROADMAP.md F5); the port
    writes the transformed and the adjusted networks as DynaML, equal to
    what the reftran and adjust verbs write."""
    rc, _, err = _run("torch", tmp_path / "p", _dynadjust(
        inputs, ["--export-xml"]))
    assert rc == 0, err
    out = _both(tmp_path / "v", [_import(inputs, FRAME),
                                 ["reftran", "n", *FRAME, "--export-xml"]])
    assert out["torch"][0] == 0
    for name in ("n.ITRF2014.01.01.2024stn.xml",
                 "n.ITRF2014.01.01.2024msr.xml"):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "v" / "jax" / name).read_text()
    for name in ("n.adjusted.stn.xml", "n.adjusted.msr.xml"):
        assert (tmp_path / "p" / name).exists()
    with pytest.raises(AttributeError):
        _run("jax", tmp_path / "j", _dynadjust(inputs, ["--export-xml"]))


def test_diff_verb_matches_jax(inputs, tmp_path):
    """diff on two .adj files of the pipeline (host and --phased host):
    the same output and exit code at a loose and at a zero tolerance."""
    _run("jax", tmp_path / "a", _dynadjust(inputs, []))
    _run("jax", tmp_path / "b", _dynadjust(inputs, ["--phased"]))
    a, b = str(tmp_path / "a" / "n.simult.adj"), \
        str(tmp_path / "b" / "n.phased.adj")
    for argv in ([a, b, "-t", "1e-3", "--skip-to-marker", MARKER],
                 [a, b, "--skip-to-marker", "Adjusted Coordinates", "-v"],
                 [a, a]):
        out = _both(tmp_path, [["diff", *argv]], files=False)
        assert out["torch"] == out["jax"]
