"""The port's NTv2 grids and geoid stage (io_formats/ntv2.py,
geoid/gridtools.py, geoid/__init__.py) against the JAX package's.

A seeded grid (utils/synthetic_geoid.py: a 1' parent sub-grid and a 15"
child sub-grid, N 3-7 m, deflections <= 1.5") and a seeded AUSGeoid .dat
file go through both packages:

  * written files (.gsb, NTv2 ASCII, interpolated point files, DNA .geo)
    are byte-identical, and both readers read them back equal;
  * bilinear and bicubic interpolation at seeded points (in the parent,
    in the child, outside the grid) agree exactly (the same float64
    numpy arithmetic);
  * apply_geoid, with and without converting orthometric heights,
    leaves equal N values, deflections, heights and height types;
  * grid_summary prints the same lines.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.geoid import apply_geoid as j_apply
from dynadjust_tpu.geoid import gridtools as JG
from dynadjust_tpu.io_formats.ntv2 import NTv2Grid as JGrid
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.geoid import apply_geoid as t_apply
from dynadjust_tpu_torch.geoid import gridtools as TG
from dynadjust_tpu_torch.io_formats.ntv2 import NTv2Grid as TGrid
from dynadjust_tpu_torch.network.data import ORTHOMETRIC, from_reference
from dynadjust_tpu_torch.utils.synthetic_geoid import synthetic_geoid_grid

# the parent covers the synthetic networks (lat -37.., lon 143..) with a
# margin; the child lies inside it
BOX = (-37.5, -36.0, 142.5, 144.0)
CHILD = (-37.2, -36.9, 142.9, 143.2, 15.0)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid")
    grid = synthetic_geoid_grid(*BOX, inc_sec=60.0, seed=3, child=CHILD)
    TG.write_gsb(grid, str(d / "t.gsb"))
    JG.write_gsb(grid, str(d / "j.gsb"))
    return d, grid


def _subgrids(grid):
    return [(sg.name.strip(), sg.parent.strip(), sg.s_lat, sg.n_lat,
             sg.e_long, sg.w_long, sg.lat_inc, sg.long_inc,
             sg.values.tolist()) for sg in grid.subgrids]


def _header(grid):
    return (grid.gs_type.strip(), grid.version.strip(),
            grid.system_from.strip(), grid.system_to.strip(),
            tuple(grid.ellipsoid_from), tuple(grid.ellipsoid_to))


def test_gsb_files_and_readers_agree(grids):
    d, grid = grids
    assert (d / "t.gsb").read_bytes() == (d / "j.gsb").read_bytes()
    gt, gj = TGrid.read(str(d / "t.gsb")), JGrid.read(str(d / "t.gsb"))
    assert _header(gt) == _header(gj) == _header(grid)
    assert _subgrids(gt) == _subgrids(gj) == _subgrids(grid)
    assert [sg.parent for sg in gt.subgrids] == ["NONE    ", "PARENT  "]


def _points(n=60, seed=11):
    """Seeded points: 2/3 over the parent (some in the child), the rest
    around the grid's edges and outside it."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(BOX[0] - 0.2, BOX[1] + 0.2, n)
    lon = rng.uniform(BOX[2] - 0.2, BOX[3] + 0.2, n)
    lat[:10] = rng.uniform(CHILD[0], CHILD[1], 10)
    lon[:10] = rng.uniform(CHILD[2], CHILD[3], 10)
    return np.radians(lat), np.radians(lon)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_interpolation_matches_jax(grids, method):
    d, _ = grids
    gt, gj = TGrid.read(str(d / "t.gsb")), JGrid.read(str(d / "t.gsb"))
    lat, lon = _points()
    inside = 0
    for la, lo in zip(lat, lon):
        vt, vj = gt.interpolate(la, lo, method), gj.interpolate(la, lo,
                                                                method)
        assert (vt is None) == (vj is None)
        if vt is not None:
            inside += 1
            assert np.array_equal(np.asarray(vt), np.asarray(vj))
    assert 30 < inside < len(lat)       # some points fall outside


@pytest.mark.parametrize("convert", [False, True],
                         ids=["keep-type", "convert-stn-hts"])
def test_apply_geoid_matches_jax(grids, convert):
    d, _ = grids
    jnet, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                      seed=2)
    # half the stations carry orthometric heights, as a DNA file with
    # LLH rows would give them
    jnet.height_ref[::2] = ORTHOMETRIC
    jnet.initial_height[:] = jnet.height
    tnet = from_reference(jnet)
    nj = j_apply(jnet, JGrid.read(str(d / "t.gsb")), convert_heights=convert)
    nt = t_apply(tnet, TGrid.read(str(d / "t.gsb")), convert_heights=convert)
    assert nt == nj == 64
    for k in ("geoid_sep", "meridian_def", "vertical_def", "height",
              "height_ref"):
        assert np.array_equal(getattr(tnet, k), getattr(jnet, k)), k
    assert tnet.geoid_applied and jnet.geoid_applied
    assert 3.0 <= tnet.geoid_sep.min() and tnet.geoid_sep.max() <= 7.0
    # N and the deflections are float32-rounded, as in the reference
    assert np.array_equal(tnet.geoid_sep,
                          tnet.geoid_sep.astype(np.float32))


def _write_dat(path, seed=4):
    """A seeded AUSGeoid 'GEO' file: a 6 x 8 node grid at 2' spacing."""
    rng = np.random.default_rng(seed)
    lines = ["AUSGeoid test file"]
    for r in range(6):
        for c in range(8):
            lat_s = 36 * 3600 + 20 * 60 - r * 120       # S36 20' .. south
            lon_s = 143 * 3600 + c * 120
            n, pm, pv = (rng.uniform(3, 7), rng.uniform(-1.5, 1.5),
                         rng.uniform(-1.5, 1.5))
            lines.append(
                f"GEO {n:8.3f} S{lat_s // 3600} {lat_s % 3600 // 60} "
                f"{lat_s % 60:.3f} E{lon_s // 3600} {lon_s % 3600 // 60} "
                f"{lon_s % 60:.3f} {pm:8.3f} {pv:8.3f}")
    path.write_text("\n".join(lines) + "\n")


def test_create_ntv2_from_dat_matches_jax(tmp_path):
    _write_dat(tmp_path / "g.dat")
    _write_dat(tmp_path / "u.dat", seed=5)
    kw = dict(uncertainty_path=str(tmp_path / "u.dat"),
              created="17.10.2026", updated="17.10.2026")
    gt = TG.create_ntv2_from_dat(str(tmp_path / "g.dat"), **kw)
    gj = JG.create_ntv2_from_dat(str(tmp_path / "g.dat"), **kw)
    assert _header(gt) == _header(gj)
    assert _subgrids(gt) == _subgrids(gj)
    assert gt.subgrids[0].nrows == 6 and gt.subgrids[0].ncols == 8
    TG.write_gsb(gt, str(tmp_path / "t.gsb"))
    JG.write_gsb(gj, str(tmp_path / "j.gsb"))
    assert (tmp_path / "t.gsb").read_bytes() == \
        (tmp_path / "j.gsb").read_bytes()


def test_ascii_export_and_read_back(grids, tmp_path):
    d, grid = grids
    TG.export_ascii(grid, str(tmp_path / "t.asc"))
    JG.export_ascii(grid, str(tmp_path / "j.asc"))
    assert (tmp_path / "t.asc").read_text() == \
        (tmp_path / "j.asc").read_text()
    gt, gj = TGrid.read(str(tmp_path / "t.asc")), \
        JGrid.read(str(tmp_path / "t.asc"))
    assert _header(gt) == _header(gj)
    assert _subgrids(gt) == _subgrids(gj)
    # the ASCII grid holds the values to its printed 6 decimals
    for a, b in zip(gt.subgrids, grid.subgrids):
        assert np.abs(a.values - b.values).max() <= 5e-7 + 1e-7


def test_summary_point_file_and_geo_export_match_jax(grids, tmp_path):
    d, _ = grids
    gt, gj = TGrid.read(str(d / "t.gsb")), JGrid.read(str(d / "t.gsb"))
    assert TG.grid_summary(gt, "g.gsb") == JG.grid_summary(gj, "g.gsb")
    lat, lon = _points(20, seed=12)
    rows = [f"{'P%d' % k:<12}{float(np.degrees(a)):>16.9f}"
            f"{float(np.degrees(b)):>15.9f}{100.0 + k:>14.3f}"
            for k, (a, b) in enumerate(zip(lat, lon))]
    (tmp_path / "pts.dat").write_text("\n".join(rows) + "\nBAD x y\n")
    for direction in (0, 1):
        out = []
        for mod, g, tag in ((TG, gt, "t"), (JG, gj, "j")):
            path = tmp_path / f"{tag}{direction}.txt"
            out.append(mod.interpolate_point_file(
                g, str(tmp_path / "pts.dat"), str(path), method="bicubic",
                convert_heights=True, dms=False, direction=direction))
        assert out[0] == out[1] and out[0][0] > 5
        assert (tmp_path / f"t{direction}.txt").read_text() == \
            (tmp_path / f"j{direction}.txt").read_text()
    jnet, _ = synthetic_mixed_network(6, 6, block_rows=3, block_cols=3,
                                      seed=1)
    tnet = from_reference(jnet)
    j_apply(jnet, gj)
    t_apply(tnet, gt)
    TG.export_dna_geo(str(tmp_path / "t.geo"), tnet)
    JG.export_dna_geo(str(tmp_path / "j.geo"), jnet)
    assert (tmp_path / "t.geo").read_text() == \
        (tmp_path / "j.geo").read_text()
