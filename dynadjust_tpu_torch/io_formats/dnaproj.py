"""DynAdjust .dnaproj project files: reader + writer.

Format (CDnaProjectFile, include/config/dnaprojectfile.cpp): '#section'
headers, fixed 35-column key field, repeated keys allowed (stn-msr-file).

The reader returns {section: [(key, value), ...]} preserving repeats and
order; `settings()` flattens to {section: {key: value-or-list}}.
"""

from __future__ import annotations

_KEY_W = 35


def read_dnaproj(path: str) -> dict:
    sections: dict[str, list] = {}
    current = None
    for raw in open(path, errors="replace"):
        line = raw.rstrip("\n")
        s = line.strip()
        if not s or s.startswith("---"):
            continue
        if s.startswith("#") and "(" in s:
            current = s[1:].split()[0].strip().lower()
            sections.setdefault(current, [])
            continue
        if s.startswith("#"):
            continue                        # a plain comment
        if current is None:
            continue
        key = line[:_KEY_W].strip()
        val = line[_KEY_W:].strip()
        if key:
            sections[current].append((key, val))
    return sections


def settings(sections: dict) -> dict:
    """{section: {key: value}} with repeated keys collected into lists."""
    out: dict = {}
    for sec, items in sections.items():
        d: dict = {}
        for k, v in items:
            if k in d:
                if not isinstance(d[k], list):
                    d[k] = [d[k]]
                d[k].append(v)
            else:
                d[k] = v
        out[sec] = d
    return out


def _yes(v) -> bool:
    return str(v).strip().lower() in ("yes", "1", "true")


def write_dnaproj(path: str, sections: dict):
    """Write a project file in the reference layout."""
    L = [f"# {path} project file.", ""]
    for sec, items in sections.items():
        L.append(f"#{sec} ({_KEY_W})".ljust(_KEY_W) + "VALUE")
        L.append("-" * 80)
        for k, v in items:
            L.append(f"{k:<{_KEY_W}}{v}")
        L.append("")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def project_to_args(path: str) -> dict:
    """Map a .dnaproj to the CLI argument names of the dynadjust
    orchestrator (subset: the settings this framework implements)."""
    import os

    cfg = settings(read_dnaproj(path))
    g = cfg.get("general", {})
    imp = cfg.get("import", {})
    ref = cfg.get("reftran", {})
    geo = cfg.get("geoid", {})
    seg = cfg.get("segment", {})
    adj = cfg.get("adjust", {})
    out = cfg.get("output", {})

    folder = g.get("input-folder", ".") or "."
    files = imp.get("stn-msr-file", [])
    if isinstance(files, str):
        files = [files] if files else []
    files = [f if os.path.isabs(f) else os.path.join(folder, f)
             for f in files]

    args = {
        "network_name": g.get("network-name", "network"),
        "output_folder": g.get("output-folder", ".") or ".",
        "files": files,
        "reference_frame": imp.get("reference-frame", ""),
        "discontinuity_file": imp.get("discontinuity-file", ""),
        "stn_renaming_file": imp.get("stn-renaming-file", ""),
        "baseline_scalar_file": imp.get("baseline-scalar-file", ""),
        "bounding_box": imp.get("bounding-box", ""),
        "split_clusters": _yes(imp.get("split-gnss-cluster-msrs", "no")),
        "prefer_single_x_as_g": _yes(imp.get("prefer-single-x-as-g",
                                             "no")),
        "flag_unused_stations": _yes(imp.get("flag-unused-stations", "no")),
        "search_nearby_stn": _yes(imp.get("search-nearby-stn", "no")),
        "search_similar_msr": _yes(imp.get("search-similar-msr", "no")),
        "simulate": _yes(imp.get("simulate-msr-file", "no")),
        "epoch": ref.get("epoch", ""),
        "grid": geo.get("ntv2-file", ""),
        "interpolation_method": ("bicubic"
                                 if geo.get("interpolation-method", "1")
                                 .strip() == "1" else "bilinear"),
        "convert_stn_hts": _yes(geo.get("convert-stn-hts", "no")),
        "min_inner_stns": int(float(seg.get("min-inner-stns", 150) or 150)),
        "max_block_stns": int(float(seg.get("max-block-stns", 150) or 150)),
        "starting_stns": seg.get("starting-stns", ""),
        "phased": "phased" in adj.get("adjustment-mode",
                                      "simultaneous-adjustment"),
        "staged_adjustment": _yes(adj.get("staged-adjustment", "no")),
        "confidence_interval": float(adj.get("conf-interval", 95) or 95),
        "iteration_threshold": float(adj.get("iteration-threshold", 0.0005)
                                     or 0.0005),
        "max_iterations": int(float(adj.get("max-iterations", 10) or 10)),
        "free_stn_sd": float(adj.get("free-stn-sd", 10.0) or 10.0),
        "fixed_stn_sd": float(adj.get("fixed-stn-sd", 1e-6) or 1e-6),
        "output_adj_msr": _yes(out.get("output-adj-msr", "no")),
        "output_adj_msr_tstat": _yes(out.get("output-tstat-adj-msr", "no")),
        "output_adj_gnss_units": int(float(out.get("output-adj-gnss-units",
                                                   0) or 0)),
        "output_msr_to_stn": _yes(out.get("output-msr-to-stn", "no")),
        "output_database_ids": _yes(out.get("output-database-ids", "no")),
        "output_pos_uncertainty": _yes(out.get("output-pos-uncertainty",
                                               "no")),
        "output_corrections_file": _yes(out.get("output-corrections-file",
                                                "no")),
    }
    return args


def update_dnaproj(path: str, section: str, entries: list,
                   network_name: str = ""):
    """Merge one tool's settings into a .dnaproj, creating it if absent —
    every reference tool writes its settings back into the shared project
    file after each run (CDnaProjectFile::UpdateSettings*,
    dnaimportwrapper.cpp:267)."""
    existing = {}
    order = []
    try:
        existing = read_dnaproj(path)
        order = list(existing.keys())
    except (OSError, ValueError):
        pass
    if network_name:
        gen = existing.setdefault("general", [])
        if not any(k == "network-name" for k, _ in gen):
            gen.append(("network-name", network_name))
        if "general" not in order:
            order.insert(0, "general")
    existing[section] = list(entries)
    if section not in order:
        order.append(section)
    write_dnaproj(path, {s: existing[s] for s in order})
