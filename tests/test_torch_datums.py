"""The port's datum registry (params/datums.py with the EPSG registry of
params/epsg.py folded in) against the JAX package's, over every frame
label of the registry."""

import pytest

from dynadjust_tpu.params import datums as JD
from dynadjust_tpu.params.epsg import FRAMES
from dynadjust_tpu_torch.params import datums as PD
from dynadjust_tpu_torch.params import epsg as PE

LABELS = sorted({lab for fr in FRAMES for lab in (fr.name, *fr.aliases)})


def _record(mod, label):
    d = mod.Datum.from_name(label)
    return (d.frame, (d.ellipsoid.a, d.ellipsoid.inv_f), d.dynamic, d.epoch,
            d.epoch_decimal, d.epsg)


def test_registry_is_a_copy():
    assert len(LABELS) == 82
    assert [f.__dict__ for f in PE.FRAMES] == [f.__dict__ for f in FRAMES]


def test_datum_from_name_matches_jax():
    """Canonical name, ellipsoid, dynamic flag, reference epoch and EPSG
    code agree for every frame label and alias."""
    bad = {lab: (_record(PD, lab), _record(JD, lab)) for lab in LABELS
           if _record(PD, lab) != _record(JD, lab)}
    assert not bad, bad


@pytest.mark.parametrize("what", ["known_frames", "epsg_codes"])
def test_lookups_match_jax(what):
    if what == "known_frames":
        assert PD.KNOWN_FRAMES == JD.KNOWN_FRAMES
        assert all(PD.is_known_frame(lab) for lab in LABELS)
    else:
        codes = {c for fr in FRAMES
                 for c in (fr.code, fr.code_xyz, fr.code_2d) if c}
        assert [PD.frame_from_epsg_code(c) for c in sorted(codes)] == \
            [JD.frame_from_epsg_code(c) for c in sorted(codes)]
