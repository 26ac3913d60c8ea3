"""Project state persistence between pipeline stages.

The reference pipeline communicates through binary .bst/.bms files; here a
single pickled NetworkData plays that role (``<name>.net.pkl``), alongside a
JSON project file (``<name>.json``) holding stage settings and progress —
the .dnaproj analogue.

Parity reference: config/dnaprojectfile.cpp (project file round-trip);
io/bst_file.cpp, bms_file.cpp (inter-stage binary state).
"""

from __future__ import annotations

import json
import os
import pickle

from .network.data import NetworkData


def net_path(folder: str, name: str) -> str:
    return os.path.join(folder, f"{name}.net.pkl")


def proj_path(folder: str, name: str) -> str:
    return os.path.join(folder, f"{name}.json")


def save_network(net: NetworkData, folder: str, name: str):
    with open(net_path(folder, name), "wb") as f:
        pickle.dump(net, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_network(folder: str, name: str) -> NetworkData:
    with open(net_path(folder, name), "rb") as f:
        return pickle.load(f)


def update_project(folder: str, name: str, stage: str, settings: dict):
    path = proj_path(folder, name)
    proj = {}
    if os.path.exists(path):
        with open(path) as f:
            proj = json.load(f)
    proj.setdefault("name", name)
    proj[stage] = settings
    with open(path, "w") as f:
        json.dump(proj, f, indent=2)
    _update_dnaproj_file(folder, name, stage, settings)


# our settings keys -> the reference's .dnaproj keys per section
_DNAPROJ_KEYS = {
    "import": {"files": "stn-msr-file", "frame": "reference-frame",
               "epoch": "epoch"},
    "geoid": {"grid": "ntv2-file", "convert_heights": "convert-stn-hts"},
    "reftran": {"frame": "reference-frame", "epoch": "epoch"},
    "segment": {"min_inner_stns": "min-inner-stns",
                "max_block_stns": "max-block-stns",
                "blocks": "blocks"},
    "adjust": {"mode": "adjustment-mode", "iterations": "iterations",
               "sigma_zero": "sigma-zero", "status": "status"},
}


def _update_dnaproj_file(folder: str, name: str, stage: str,
                         settings: dict):
    """Mirror every stage's settings into <name>.dnaproj — each
    reference tool writes the shared project file after it runs
    (CDnaProjectFile; dnaimportwrapper.cpp:267), which is what lets a
    later `<tool> -p <name>.dnaproj` pick the project up."""
    from .io_formats.dnaproj import update_dnaproj
    keymap = _DNAPROJ_KEYS.get(stage, {})
    entries = []
    for k, v in settings.items():
        key = keymap.get(k, k.replace("_", "-"))
        if isinstance(v, (list, tuple)):
            for item in v:
                entries.append((key, str(item)))
        elif isinstance(v, bool):
            entries.append((key, "yes" if v else "no"))
        else:
            if stage == "adjust" and k == "mode":
                v = f"{v}-adjustment"
            entries.append((key, str(v)))
    update_dnaproj(os.path.join(folder, f"{name}.dnaproj"), stage,
                   entries, network_name=name)


def load_project(folder: str, name: str) -> dict:
    path = proj_path(folder, name)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}
