"""The port's reference frame transformation (params/transformations.py,
params/substitutions.py, reftran/) against the JAX package's.

The same seeded synthetic mixed network goes through both packages'
transform_network (the port's network carried over with
network/data.py::from_reference before either is transformed).  Station
positions must agree within 1e-9 m (cartesian) and every GNSS cluster
value within 1e-12 relative; frames, epochs and the returned counts must
be equal.  Cases: static -> static, static -> dynamic, dynamic ->
dynamic with an epoch change (the Australian plate motion model), the
plate-model route on a seeded pair of plates, per-station frames, and
every frame label of the port's EPSG registry.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.geodesy.conversions import geo_to_cart as j_g2c
from dynadjust_tpu.io_formats.dna import Station as JStation
from dynadjust_tpu.network import build_network as j_build
from dynadjust_tpu.reftran import transform_network as j_transform
from dynadjust_tpu.reftran.plates import load_plate_model as j_plates
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.io_formats.dna import Station as TStation
from dynadjust_tpu_torch.network import build_network as t_build
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.params import epsg as PE
from dynadjust_tpu_torch.params.transformations import TransformationError
from dynadjust_tpu_torch.reftran import transform_network as t_transform
from dynadjust_tpu_torch.reftran.plates import load_plate_model as t_plates

XYZ_TOL = 1e-9          # m, station positions
VEC_TOL = 1e-12         # relative, GNSS cluster values


def _relabel(net, frame, epoch):
    """Every station and record of net on (frame, epoch), untransformed."""
    net.frame, net.epoch = frame, epoch
    net.datum = type(net.datum).from_name(frame, epoch)
    for rec in net.measurements:
        if hasattr(rec, "epsg_frame"):
            rec.epsg_frame, rec.epoch = frame, epoch


def _pair(rows=6, frame="GDA2020", epoch="01.01.2020"):
    """The seeded network in both packages, its stations and records on
    (frame, epoch) (the generator leaves the records' frame blank, as a
    DNA import would fill it)."""
    jnet, _ = synthetic_mixed_network(rows, rows, block_rows=3,
                                      block_cols=3, seed=5)
    _relabel(jnet, frame, epoch)
    tnet = from_reference(jnet)
    _relabel(tnet, frame, epoch)
    return jnet, tnet


def _assert_same(jnet, tnet, jstats, tstats):
    assert tstats == jstats
    assert (tnet.frame, tnet.epoch) == (jnet.frame, jnet.epoch)
    assert (tnet.datum.frame, tnet.datum.epoch) == \
        (jnet.datum.frame, jnet.datum.epoch)
    ell = jnet.datum.ellipsoid
    xj = np.stack(j_g2c(jnet.lat, jnet.lon, jnet.height, ell), -1)
    xt = np.stack(j_g2c(tnet.lat, tnet.lon, tnet.height, ell), -1)
    assert np.abs(xt - xj).max() <= XYZ_TOL
    for a, b in zip(tnet.measurements, jnet.measurements):
        assert getattr(a, "epsg_frame", None) == getattr(b, "epsg_frame",
                                                         None)
        assert getattr(a, "epoch", None) == getattr(b, "epoch", None)
        for oa, ob in zip(getattr(a, "obs", ()), getattr(b, "obs", ())):
            assert np.abs(oa.vec - ob.vec).max() <= \
                VEC_TOL * max(1.0, np.abs(ob.vec).max())


CASES = {
    # name: (source frame, source epoch) or None (GDA2020 @ 2020), target
    "static-static": (None, ("GDA94", "")),
    "static-dynamic": (None, ("ITRF2014", "01.01.2024")),
    "dynamic-dynamic-pmm": (("ITRF2014", "01.01.2010"),
                            ("ITRF2008", "01.01.2020")),
    "default-datum": (("ITRF2014", "01.01.2018"), (None, "")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transform_network_matches_jax(case):
    src, (frame, epoch) = CASES[case]
    jnet, tnet = _pair(6, *(src or ("GDA2020", "01.01.2020")))
    if case == "default-datum":
        # a network whose records sit on another frame than its project
        # datum: transform_network with no target uses the datum
        for net in (jnet, tnet):
            net.frame, net.epoch = "GDA2020", "01.01.2020"
            net.datum = type(net.datum).from_name("GDA2020", "01.01.2020")
    js = j_transform(jnet, frame, epoch)
    ts = t_transform(tnet, frame, epoch)
    assert ts["measurements"] > 0
    _assert_same(jnet, tnet, js, ts)


def _write_plates(d, seed=0):
    """Two quadrilateral plates splitting the synthetic network (lat
    -37..-36.75, lon 143..143.25) at lon 143.12, and their Euler poles
    (the first the Australian plate's, the second seeded)."""
    rng = np.random.default_rng(seed)
    quads = {"AU": [(142.0, -38.0), (143.12, -38.0), (143.12, -36.0),
                    (142.0, -36.0)],
             "XP": [(143.12, -38.0), (144.5, -38.0), (144.5, -36.0),
                    (143.12, -36.0)]}
    lines = []
    for name, pts in quads.items():
        lines.append(name)
        lines += [f"{lon:.6f},{lat:.6f}" for lon, lat in pts + pts[:1]]
        lines.append("*** end of line segment ***")
    (d / "plates.dig").write_text("\n".join(lines) + "\n")
    pole = (rng.uniform(-60, 60), rng.uniform(-180, 180),
            rng.uniform(0.2, 1.0))
    (d / "poles.dat").write_text(
        "* plate  lat  lon  rate (deg/Ma)\n"
        "AU  32.2447  38.2022  0.6285\n"
        f"XP  {pole[0]:.4f}  {pole[1]:.4f}  {pole[2]:.4f}\n")
    return str(d / "plates.dig"), str(d / "poles.dat")


def test_plate_model_route_matches_jax(tmp_path):
    dig, poles = _write_plates(tmp_path)
    pj, pt = j_plates(dig, poles), t_plates(dig, poles)
    assert [(k, v.tolist()) for k, v in pt.polygons] == \
        [(k, v.tolist()) for k, v in pj.polygons]
    assert pt.rotations == pj.rotations
    jnet, tnet = _pair(frame="ITRF2014", epoch="01.01.2010")
    plates = {pt.identify(la, lo) for la, lo in zip(tnet.lat, tnet.lon)}
    assert plates == {"AU", "XP"}       # both plates carry stations
    js = j_transform(jnet, "ITRF2008", "01.01.2020", plate_model=pj)
    ts = t_transform(tnet, "ITRF2008", "01.01.2020", plate_model=pt)
    _assert_same(jnet, tnet, js, ts)


def test_per_station_frames_match_jax():
    """Stations carrying their own frame (as SINEX imports them) are
    transformed per (frame, epoch) group, as
    tests/test_aux_features.py::test_per_station_frames_reftran."""
    nets = []
    for Station, build in ((JStation, j_build), (TStation, t_build)):
        stns = [Station(name="A", constraints="FFF", coord_type="LLH",
                        p1=-37.4854687, p2=144.5830432, p3=100.0),
                Station(name="B", constraints="FFF", coord_type="LLH",
                        p1=-36.4854687, p2=145.5830432, p3=120.0,
                        frame="ITRF2014", epoch="01.01.2018"),
                Station(name="C", constraints="FFF", coord_type="LLH",
                        p1=-36.9854687, p2=145.0830432, p3=80.0,
                        frame="ITRF2008", epoch="01.06.2015")]
        nets.append(build(stns, [], "GDA2020", "01.01.2020"))
    jnet, tnet = nets
    js = j_transform(jnet, "GDA2020", "01.01.2020")
    ts = t_transform(tnet, "GDA2020", "01.01.2020")
    assert ts["stations"] == 2 and ts["stations_skipped"] == 1
    assert tnet.station_frames == jnet.station_frames
    assert tnet.station_epochs == jnet.station_epochs
    _assert_same(jnet, tnet, js, ts)


LABELS = sorted({lab for fr in PE.FRAMES for lab in (fr.name, *fr.aliases)})


@pytest.mark.parametrize("label", LABELS)
def test_every_frame_label_transforms_like_jax(tmp_path, label):
    """Each frame label of the registry (at its frame's reference epoch)
    to GDA2020 with the seeded plate model: both packages give the same
    coordinates, or both refuse with the same message."""
    frame = next(fr for fr in PE.FRAMES
                 if label in (fr.name, *fr.aliases))
    dig, poles = _write_plates(tmp_path)
    jnet, tnet = _pair(rows=3, frame=label, epoch=frame.epoch)
    out = []
    for fn, net, pm in ((j_transform, jnet, j_plates(dig, poles)),
                        (t_transform, tnet, t_plates(dig, poles))):
        try:
            out.append(fn(net, "GDA2020", "01.01.2020", plate_model=pm))
        except Exception as e:          # noqa: BLE001 - compared below
            out.append(e)
    js, ts = out
    if isinstance(js, Exception):
        assert type(ts).__name__ == type(js).__name__
        assert str(ts) == str(js)
        assert isinstance(ts, (TransformationError, KeyError, ValueError))
        return
    _assert_same(jnet, tnet, js, ts)
