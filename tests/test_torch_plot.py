"""The port's plot verb against the JAX CLI's.

Both CLIs import, segment and adjust the same seeded 8 x 8 DNA files,
then plot them: the network map, one block (--block-number), the
segmentation graph, a map with error ellipses, positional uncertainty
circles and correction arrows as PNG, and one map per block
(--phased-block-view).  The port must write a non-empty file wherever
the JAX CLI writes one, and its parser takes the JAX verb's arguments
(the same options in --help).  Skipped where matplotlib is not installed.
"""

import contextlib
import io
import re

import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main

PLOTS = {
    "map": [],
    "block": ["--block-number", "2", "--label-stations"],
    "graph": ["--segmentation-graph"],
    "uncertainty": ["--error-ellipses", "--positional-uncertainty",
                    "--correction-arrows", "--export-png"],
    "blocks": ["--phased-block-view"],
}


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    pytest.importorskip("matplotlib")
    d = tmp_path_factory.mktemp("plot")
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                     seed=4)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        common = ["--output-folder", str(d / side)]
        (d / side).mkdir()
        assert main(["import", "-n", "n", str(d / "n.stn"),
                     str(d / "n.msr"), *common]) == 0
        assert main(["segment", "n", "--min-inner-stns", "20",
                     "--max-block-stns", "40", *common]) == 0
        assert main(["adjust", "n", "--phased", *common]) == 0
    return d


@pytest.mark.parametrize("case", list(PLOTS))
def test_plot_writes_what_jax_writes(projects, tmp_path, case):
    written = {}
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / side
        out.mkdir()
        assert main(["plot", "n", *PLOTS[case],
                     "--input-folder", str(projects / side),
                     "--output-folder", str(out)]) == 0
        written[side] = {p.name: p.stat().st_size for p in out.iterdir()}
    assert written["jax"]
    assert written["torch"].keys() == written["jax"].keys()
    assert all(size > 0 for size in written["torch"].values())


def _help(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(["plot", "--help"])
    assert e.value.code == 0
    return buf.getvalue()


def test_plot_takes_the_jax_arguments():
    """The same options and the same help for each (the usage lines wrap
    at other places, as the program names differ in length)."""
    t, j = _help(torch_main), _help(jax_main)
    opts = re.compile(r"(?<![\w-])--?[a-zA-Z][\w-]*")
    assert sorted(set(opts.findall(t))) == sorted(set(opts.findall(j)))
    assert len(set(opts.findall(j))) > 30
    assert t.split("\noptions:")[1] == j.split("\noptions:")[1]
