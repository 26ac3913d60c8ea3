"""Command-line interface: the pipeline verbs import, segment and adjust.

Usage:
    python -m dynadjust_tpu_torch import  -n NAME stations.stn measurements.msr
    python -m dynadjust_tpu_torch segment NAME [--min-inner-stns N]
                                              [--max-block-stns N]
    python -m dynadjust_tpu_torch adjust  NAME [--tpu] [--phased]
                                              [--block1-phased]
                                              [--staged-adjustment]
                                              [--tpu-super-blocks N]
                                              [--device cuda|cpu] ...

The verbs take the JAX package's arguments and write the same files
(``<name>.net.pkl``, ``.seg``, ``.sap``, ``.adj``, ``.xyz``,
``.results.pkl``, ...).  ``adjust`` keeps the host float64 LAPACK route
by default, and ``--phased``, ``--block1-phased`` or
``--staged-adjustment`` without ``--tpu`` take the host sequential
phased adjustment (adjust/phased.py).  ``--tpu`` selects the device
routes: the dense simultaneous solve (parallel/dense_device.py) and,
with ``--phased`` or ``--staged-adjustment``, the blocked Schur
adjustment (adjust/tpu_blocked.py; host-streamed factors when staged).
They run on ``--device``
(default ``cuda``); ``adjust --tpu`` exits non-zero when the card it asks
for is absent.  The host route needs no card and ``--device`` does not
touch it.  A flag or input whose module this package does not hold yet
exits non-zero, naming the ROADMAP.md item that ports it.

Parity reference: per-tool wrappers dna*wrapper/*.cpp of DynAdjust.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# flags whose modules are not in this package yet: (argument attribute,
# flag, ROADMAP.md item that ports it)
_UNPORTED = {
    "import": (
        ("discontinuity_file", "-d/--discontinuity-file", "M8"),
        ("export_discont_file", "--export-discont-file", "M8"),
        ("export_asl_file", "--export-asl-file", "M8"),
        ("export_aml_file", "--export-aml-file", "M8"),
        ("export_map_file", "--export-map-file", "M8"),
        ("export_xml_files", "--export-xml-files", "M8"),
        ("single_xml_file", "--single-xml-file", "M8"),
        ("export_bst_bms", "--export-bst-bms", "M8"),
        ("simulate", "--simulate", "M8"),
    ),
    "segment": (),
    "adjust": (
        ("devices", "--devices", "M7"),
        ("output_json", "--output-json", "M8"),
        ("export_snx", "--export-snx", "M8"),
        ("export_xml", "--export-xml", "M8"),
        ("export_xml_stn_file", "--export-xml-stn-file", "M8"),
        ("export_xml_msr_file", "--export-xml-msr-file", "M8"),
    ),
}
# input file types whose readers are not ported (ROADMAP.md M8)
_UNPORTED_INPUTS = (".bst", ".bms", ".jsonl", ".snx", ".SNX", ".xml")


def _refuse_unported(args) -> bool:
    """Print an error and return True when args ask for a module this
    package does not hold."""
    why = [f"{flag} (ROADMAP.md {item})"
           for attr, flag, item in _UNPORTED[args.command]
           if getattr(args, attr, None)]
    if args.command == "import":
        why += [f"input {f} (ROADMAP.md M8)" for f in args.files
                if f.endswith(_UNPORTED_INPUTS)]
    if (args.command == "adjust" and args.block1_phased and args.tpu
            and not args.report_mode):
        why.append("--block1-phased --tpu: the per-block device solve of "
                   "the phased sweeps (ROADMAP.md M9)")
    if why:
        print("- Error: not ported to dynadjust_tpu_torch yet: "
              + "; ".join(why), file=sys.stderr)
    return bool(why)


def _refuse_missing_card(args) -> bool:
    """adjust --tpu runs on the card unless --device cpu asks for the CPU:
    with no card it stops instead of carrying on on the CPU.  The host
    float64 route (no --tpu) never touches the device and needs no card."""
    if (args.command != "adjust" or args.report_mode or not args.tpu
            or args.device != "cuda"):
        return False
    import torch
    if torch.cuda.is_available():
        return False
    print("- Error: adjust --tpu runs on the CUDA card (--device cuda) and "
          "no card is present; pass --device cpu to run on the CPU",
          file=sys.stderr)
    return True


def _cmd_import(args) -> int:
    from .io_formats.dna import read_dna_stn, read_dna_msr
    from .network import build_network
    from . import project

    if not args.network_name:
        k = 1
        while os.path.exists(os.path.join(args.output_folder,
                                          f"network{k}.net.pkl")):
            k += 1
        args.network_name = f"network{k}"
        print(f"+ Network name defaulted to {args.network_name}")

    if getattr(args, "export_from_binary", False):
        # exports from the saved network store, no re-parse
        # (EXPORT_FROM_BINARY; the reference's binary files are our store)
        net = project.load_network(getattr(args, 'input_folder', '') or
                               args.output_folder, args.network_name)
        base = os.path.join(args.output_folder, args.network_name)
        if getattr(args, "export_dna", False):
            from .io_formats.dna_writer import write_dna_stn, write_dna_msr
            write_dna_stn(f"{base}.export.stn", net)
            write_dna_msr(f"{base}.export.msr", net)
            print(f"+ Exported DNA files: {base}.export.stn/.msr")
        return 0
    # the reference requires files / block / contiguous-network / seg
    # options on the command line itself — a project file alone is
    # "Nothing to do" (dnaimportwrapper.cpp:226, import-misc-07 CI test)
    _pf = getattr(args, "_project_filled", set())
    _cli_files = bool(args.files) and "files" not in _pf
    if not _cli_files and not (
            getattr(args, "import_block_stn_msr", 0) or
            getattr(args, "import_contiguous_stn_msr", -1) >= 0 or
            getattr(args, "seg_file", "")):
        print("- Nothing to do - no files specified.", file=sys.stderr)
        return 1

    stations, frame, epoch = [], "", ""
    measurements = []
    if not args.files:
        # block/contiguous extraction from the saved store
        # (the reference re-reads its own .bst/.bms in this mode)
        from .io_formats.dna import Station
        from .geodesy.conversions import rad_to_dms
        src_net = project.load_network(
            getattr(args, 'input_folder', '') or args.output_folder,
            args.network_name)
        frame, epoch = src_net.frame, src_net.epoch
        for i in range(src_net.nstations):
            stations.append(Station(
                name=src_net.names[i],
                constraints=src_net.constraints[i], coord_type="LLh",
                p1=float(rad_to_dms(src_net.lat[i])),
                p2=float(rad_to_dms(src_net.lon[i])),
                p3=float(src_net.height[i]),
                description=src_net.descriptions[i]))
        measurements = list(src_net.measurements)
    for path in args.files:
        if path.endswith(".stn"):
            stns, frame, epoch = read_dna_stn(path)
            stations.extend(stns)
        elif path.endswith(".msr"):
            recs, mframe, mepoch = read_dna_msr(path)
            measurements.extend(recs)
            frame = frame or mframe
            epoch = epoch or mepoch
        else:
            print(f"error: unrecognised input file type: {path}",
                  file=sys.stderr)
            return 1

    if getattr(args, "epoch", ""):
        epoch = args.epoch
    if args.reference_frame:
        from .params.datums import Datum as _Datum, is_known_frame
        try:
            if not is_known_frame(args.reference_frame):
                raise ValueError("not in the EPSG frame registry")
            _Datum.from_name(args.reference_frame, epoch or "")
        except (KeyError, ValueError) as e:
            print(f"- Error: {args.reference_frame} is not a recognised "
                  f"reference frame ({e})", file=sys.stderr)
            return 1
        frame = args.reference_frame
        if getattr(args, "override_input_ref_frame", False):
            # relabel every record's frame with -r, no transformation
            # (OVERRIDE_INPUT_FRAME, imp-gnss1 CI test)
            fr = frame.upper()
            for rec in measurements:
                if hasattr(rec, "epsg_frame"):
                    rec.epsg_frame = fr
            for s in stations:
                if getattr(s, "frame", ""):
                    s.frame = fr
            print(f"+ Input reference frame overridden to {fr}")

    # --- import-time screening and auxiliaries --------------------------
    if getattr(args, "include_msr_types", "") or \
            getattr(args, "exclude_msr_types", ""):
        from .io_formats.dna import Measurement, GpsCluster, DirectionSet
        inc = set(getattr(args, "include_msr_types", "").upper())
        exc = set(getattr(args, "exclude_msr_types", "").upper())

        def _mt(rec):
            return rec.mtype if not isinstance(rec, DirectionSet) else "D"
        before = len(measurements)
        if inc:
            measurements = [r for r in measurements if _mt(r) in inc]
        if exc:
            measurements = [r for r in measurements if _mt(r) not in exc]
        print(f"+ Measurement type filter retained {len(measurements)} of "
              f"{before} records")
    if getattr(args, "prefer_single_x_as_g", False):
        from .io_formats.dna import GpsCluster
        n = 0
        for rec in measurements:
            if isinstance(rec, GpsCluster) and rec.mtype == "X" and \
                    len(rec.obs) == 1:
                rec.mtype = "G"
                n += 1
        if n:
            print(f"+ Converted {n} single-baseline X clusters to G")
    if any(getattr(args, k, 1.0) != 1.0
           for k in ("vscale", "pscale", "lscale", "hscale")):
        from .io_formats.dna import GpsCluster
        n = 0
        for rec in measurements:
            if isinstance(rec, GpsCluster):
                rec.vscale *= getattr(args, "vscale", 1.0)
                rec.pscale *= getattr(args, "pscale", 1.0)
                rec.lscale *= getattr(args, "lscale", 1.0)
                rec.hscale *= getattr(args, "hscale", 1.0)
                n += 1
        print(f"+ Applied global VCV scalars to {n} GNSS clusters")
    if getattr(args, "stn_renaming_file", ""):
        from .io_formats.aux_files import read_renaming_file, apply_renaming
        renames = read_renaming_file(args.stn_renaming_file)
        n = apply_renaming(stations, measurements, renames)
        print(f"+ Renamed {n} stations")
    if getattr(args, "baseline_scalar_file", ""):
        from .io_formats.aux_files import read_scalar_file, \
            apply_baseline_scalars
        scalars = read_scalar_file(args.baseline_scalar_file)
        n = apply_baseline_scalars(measurements, scalars)
        print(f"+ Applied VCV scalars to {n} baseline clusters")
    if getattr(args, "bounding_box", ""):
        from .network.screening import filter_bounding_box
        vals = [float(t) for t in args.bounding_box.split(",")]
        stations, measurements = filter_bounding_box(
            stations, measurements, *vals,
            split_clusters=getattr(args, "split_clusters", False),
            transcend=getattr(args, "get_msrs_transcending_box", False))
        print(f"+ Bounding box retained {len(stations)} stations, "
              f"{len(measurements)} measurement records")
    if getattr(args, "include_stns", "") or getattr(args, "exclude_stns", ""):
        from .network.screening import filter_stations
        inc = [t for t in args.include_stns.split(",") if t]
        exc = [t for t in args.exclude_stns.split(",") if t]
        stations, measurements = filter_stations(
            stations, measurements, inc or None, exc or None,
            split_clusters=getattr(args, "split_clusters", False))
        print(f"+ Station filter retained {len(stations)} stations, "
              f"{len(measurements)} measurement records")
    if getattr(args, "include_stns_assoc_msrs_alias", ""):
        args.include_stns_assoc_msrs = args.include_stns_assoc_msrs_alias
    if getattr(args, "exclude_stns_assoc_msrs_alias", ""):
        args.exclude_stns_assoc_msrs = args.exclude_stns_assoc_msrs_alias
    if (getattr(args, "include_stns_assoc_msrs", "") or
            getattr(args, "exclude_stns_assoc_msrs", "")):
        from .network.screening import filter_stations_assoc_msrs
        inc = [t for t in args.include_stns_assoc_msrs.split(",") if t]
        exc = [t for t in args.exclude_stns_assoc_msrs.split(",") if t]
        stations, measurements = filter_stations_assoc_msrs(
            stations, measurements, inc or None, exc or None,
            split_clusters=getattr(args, "split_clusters", False))
        print(f"+ Associated-measurement filter retained "
              f"{len(stations)} stations, {len(measurements)} "
              f"measurement records")
    if (getattr(args, "import_block_stn_msr", 0) or
            getattr(args, "import_contiguous_stn_msr", -1) >= 0):
        # extract one segmentation block / contiguous sub-network
        # (ImportStnsMsrsFromBlock / FromNetwork,
        # dnaimportwrapper.cpp:799/831)
        from .network.screening import filter_stations
        from .segment.segmenter import Segmentation
        from . import project as _project
        seg_path = (getattr(args, "seg_file", "") or
                    os.path.join(args.output_folder,
                                 f"{args.network_name}.seg.pkl"))
        bno = getattr(args, "import_block_stn_msr", 0)
        if seg_path.endswith(".seg"):
            # text .seg interchange format (the reference's own)
            from .segment.segmenter import read_seg_block_names
            if not bno:
                print("error: text .seg extraction supports "
                      "--import-block-stn-msr only", file=sys.stderr)
                return 1
            keep = sorted(read_seg_block_names(seg_path, bno))
            what = f"block {bno}"
        else:
            seg = Segmentation.load(seg_path)
            # the seg file indexes the source network's stations: derive
            # the source name from the seg filename (<name>.seg.pkl)
            src_name = os.path.basename(seg_path).split(".seg")[0]
            src = _project.load_network(os.path.dirname(seg_path) or
                                        args.output_folder, src_name)
            if bno:
                idxs = seg.parameter_stations(bno - 1)
                what = f"block {bno}"
            else:
                # 0-based network ids (ImportStnsMsrsFromNetwork,
                # dnainterop.cpp:4050)
                nno = getattr(args, "import_contiguous_stn_msr", -1)
                if nno >= len(set(seg.networks)):
                    print(f"- Error: The specified network ID {nno} "
                          f"exceeds the number of contiguous networks.",
                          file=sys.stderr)
                    return 1
                idxs = sorted({g for b in range(seg.block_count)
                               if seg.networks[b] == nno
                               for g in seg.parameter_stations(b)})
                what = f"contiguous network {nno}"
            keep = sorted(src.names[i] for i in idxs)
        stations, measurements = filter_stations(
            stations, measurements, include=keep,
            split_clusters=getattr(args, "split_clusters", False))
        print(f"+ Imported {len(stations)} stations, "
              f"{len(measurements)} measurement records from {what}")
        # the reference writes the extracted data under a modified
        # network name (<name>.block-N / <name>.network-N), leaving the
        # source binary files intact (dnaimportwrapper.cpp:414-422)
        args.network_name += (f".block-{bno}" if bno else
                              f".network-{args.import_contiguous_stn_msr}")
    if getattr(args, "ignore_insufficient_msrs", False):
        from .network.screening import ignore_insufficient_measurements
        poorly = ignore_insufficient_measurements(stations, measurements)
        if poorly:
            print(f"- Warning: {len(poorly)} poorly constrained stations "
                  f"(measurements ignored): {' '.join(poorly[:20])}")
    if getattr(args, "test_integrity", False):
        from .network.integrity import check_integrity
        probs = check_integrity(stations, measurements)
        if probs:
            print(f"- Integrity check found {len(probs)} problems:")
            for pr in probs[:20]:
                print(f"    {pr}")
        else:
            print("+ Integrity check passed")
    if getattr(args, "flag_unused_stations", False):
        from .network.screening import unused_stations
        unused = unused_stations(stations, measurements)
        if unused:
            print(f"- Warning: {len(unused)} unused stations: "
                  f"{' '.join(unused[:20])}")
    if getattr(args, "search_similar_msr", False) or \
            getattr(args, "ignore_similar_msr", False):
        from .network.screening import find_similar_measurements
        sim = find_similar_measurements(measurements)
        print(f"+ Similar measurement pairs found: {len(sim)}")
        if getattr(args, "ignore_similar_msr", False):
            for (_a, b) in sim:
                measurements[b].ignore = True
            print(f"+ Ignored {len(sim)} later duplicates")
    if getattr(args, "remove_ignored_msr", False):
        before = len(measurements)
        measurements = [r for r in measurements
                        if not getattr(r, "ignore", False)]
        print(f"+ Removed {before - len(measurements)} ignored "
              f"measurements")
    if getattr(args, "search_nearby_stn", False):
        from .network.screening import find_nearby_stations
        near = find_nearby_stations(
            stations, tolerance_m=getattr(args, "nearby_stn_buffer", 30.0))
        for a, b, d in near[:20]:
            print(f"  nearby: {a} ~ {b} ({d:.1f} m)")
        if near:
            # the reference exits non-zero when nearby stations are
            # found, forcing the user to review (import-nearby CI test)
            print(f"- Error: {len(near)} nearby station pair(s) found "
                  f"within the buffer; review and rerun", file=sys.stderr)
            return 1

    # mirror the reference: binary station records are name-sorted, but
    # the original file order is kept for --sort-stn-orig-order
    from .network.screening import stations_of_record
    known = {s.name for s in stations}
    missing = sorted({nm for rec in measurements
                      for nm in stations_of_record(rec)
                      if nm not in known})
    if missing:
        print(f"- Error: {len(missing)} measurement station(s) are not "
              f"in the station file: {' '.join(missing[:10])}",
              file=sys.stderr)
        return 1
    orig_order = {s.name: k for k, s in enumerate(stations)}
    stations.sort(key=lambda s: s.name)
    net = build_network(stations, measurements, frame, epoch)
    net.station_file_order = [orig_order[n] for n in net.names]
    if getattr(args, "geo_file", ""):
        # LoadDNAGeoidFile (dnaimportwrapper.cpp:2385): per-station
        # N value and deflections (seconds) from a DNA .geo file
        import numpy as _np
        from .network.data import ORTHOMETRIC
        n_geo = 0
        sec = _np.pi / 180.0 / 3600.0
        for line in open(args.geo_file, errors="replace"):
            t = line.split()
            if len(t) < 4 or line.lstrip().startswith(("#", "*", "!")):
                continue
            i = net.name_to_idx.get(t[0])
            try:
                nval, pm, pv = float(t[1]), float(t[2]), float(t[3])
            except ValueError:
                continue
            if i is None:
                continue
            net.geoid_sep[i] = nval
            net.meridian_def[i] = pm * sec
            net.vertical_def[i] = pv * sec
            if net.height_ref[i] == ORTHOMETRIC:
                net.height[i] = net.initial_height[i] + nval
            n_geo += 1
        net.geoid_applied = True
        print(f"+ Imported geoid information for {n_geo} stations "
              f"from {args.geo_file}")
    if getattr(args, "observation_epoch", ""):
        from .network.data import (normalise_observation_epoch,
                                   apply_observation_epoch)
        oe = normalise_observation_epoch(args.observation_epoch)
        n_oe = apply_observation_epoch(net.measurements, oe)
        net.observation_epoch = oe
        print(f"+ Observation epoch {oe} applied to {n_oe} measurements")
    if getattr(args, "export_dna", False):
        from .io_formats.dna_writer import write_dna_stn, write_dna_msr
        base = os.path.join(args.output_folder, args.network_name)
        write_dna_stn(f"{base}.export.stn", net)
        write_dna_msr(f"{base}.export.msr", net)
        print(f"+ Exported DNA files: {base}.export.stn/.msr")
    if getattr(args, "output_msr_to_stn", False):
        from .output.adj_writer import msr_to_stn_lines
        sort = {0: "name", 1: "count", 2: "file_order"}.get(
            getattr(args, "sort_msr_to_stn_field", 0), "name")
        base = os.path.join(args.output_folder, args.network_name)
        with open(f"{base}.m2s", "w") as f:
            f.write("\n".join(msr_to_stn_lines(net, sort=sort)) + "\n")
        print(f"+ Wrote {base}.m2s")
    project.save_network(net, args.output_folder, args.network_name)
    project.update_project(args.output_folder, args.network_name, "import",
                           {"files": args.files, "frame": frame,
                            "epoch": epoch})
    # parse tally (the reference's import summary block)
    from collections import Counter
    from .io_formats.dna import DirectionSet as _DS, GpsCluster as _GC
    tally = Counter()
    for rec in net.measurements:
        if isinstance(rec, _GC):
            tally[rec.mtype] += (len(rec.obs) * 3)
        elif isinstance(rec, _DS):
            tally["D"] += len(rec.directions)
        else:
            tally[rec.mtype] += 1
    parts = "  ".join(f"{t}:{n}" for t, n in sorted(tally.items()))
    print(f"+ Measurement tally ({sum(tally.values())} rows): {parts}")
    print(f"+ Imported {net.nstations} stations, "
          f"{len(net.measurements)} measurement records "
          f"({frame} @ {epoch})")
    return 0


def _cmd_segment(args) -> int:
    from .segment import segment_network
    from . import project

    net = project.load_network(getattr(args, 'input_folder', '') or
                               args.output_folder, args.network_name)
    if not any(not getattr(r, "ignore", False) for r in net.measurements):
        print("- Error: all measurements are ignored; nothing to "
              "segment", file=sys.stderr)
        return 1
    starting = args.starting_stns
    if getattr(args, "net_file", False):
        net_path = os.path.join(args.output_folder,
                                f"{args.network_name}.net")
        if not os.path.exists(net_path):
            print(f"- Error: {net_path} does not exist (--net-file)",
                  file=sys.stderr)
            return 1
        if os.path.exists(net_path):
            # .net format: title block then one station name per line
            # (DYNADJUST BLOCK 1 STATIONS FILE, e.g. gnss_b1.net)
            extra = []
            for t in open(net_path):
                t = t.strip()
                if (not t or t.startswith(("#", "-", "!")) or " " in t):
                    continue
                extra.append(t)
            starting = ",".join([starting] * bool(starting) + extra)
            print(f"+ First-block stations from {net_path}: {len(extra)}")
    seg = segment_network(
        net, min_inner_stns=args.min_inner_stns,
        max_block_stns=args.max_block_stns, starting_stns=starting,
        force_contiguous=bool(getattr(args, "contiguous_blocks", 0)),
        search_level=getattr(args, "search_level", 0))
    project.save_network(net, args.output_folder, args.network_name)
    seg.save(os.path.join(args.output_folder,
                          f"{args.network_name}.seg.pkl"))
    from .segment.segmenter import write_seg_file, write_sap_file, \
        verify_station_connections
    write_seg_file(getattr(args, "seg_file", "") or
                   os.path.join(args.output_folder,
                                f"{args.network_name}.seg"),
                   net, seg, args.min_inner_stns, args.max_block_stns,
                   starting, " ".join(sys.argv))
    write_sap_file(os.path.join(args.output_folder,
                                f"{args.network_name}.sap"), net, seg)
    if getattr(args, "test_integrity", False):
        probs = verify_station_connections(net, seg)
        if probs:
            print(f"- Integrity check: {len(probs)} problems")
            for pr in probs[:10]:
                print(f"    {pr}")
        else:
            print("+ Segmentation integrity verified")
    project.update_project(args.output_folder, args.network_name, "segment",
                           {"blocks": seg.block_count,
                            "min_inner_stns": args.min_inner_stns,
                            "max_block_stns": args.max_block_stns})
    print(f"+ Segmented network into {seg.block_count} blocks")
    for b in range(seg.block_count):
        print(f"    block {b + 1}: {len(seg.inner_stations[b])} inner, "
              f"{len(seg.junction_stations[b])} junction, "
              f"{len(seg.measurements[b])} measurements")
    return 0


def _cmd_adjust(args) -> int:
    from .adjust import adjust_simultaneous, AdjustmentOptions
    from .output import write_adj, write_xyz
    from . import project

    # wall-clock seconds of each step, printed with the summary
    steps, t_step = {}, time.perf_counter()

    def _step(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now

    net = project.load_network(getattr(args, 'input_folder', '') or
                               args.output_folder, args.network_name)
    if not any(not getattr(r, "ignore", False) for r in net.measurements):
        print("- Error: all measurements are ignored; nothing to "
              "adjust", file=sys.stderr)
        return 1
    opts = AdjustmentOptions(
        max_iterations=args.max_iterations,
        iteration_threshold=args.iteration_threshold,
        confidence_interval=args.confidence_interval,
        free_std_dev=args.free_stn_sd,
        fixed_std_dev=args.fixed_stn_sd,
        use_tpu=getattr(args, "tpu", False),
        profile=getattr(args, "profile", False),
        verbose_level=getattr(args, "verbose_level", 0),
        debug_file=(os.path.join(args.output_folder,
                                 f"{args.network_name}.dbg")
                    if getattr(args, "verbose_level", 0) >= 3 else ""),
        output_iter_stations=getattr(args, "output_iter_adj_stn", False),
        output_iter_adj_stat=getattr(args, "output_iter_adj_stat", False),
        output_iter_adj_msr=getattr(args, "output_iter_adj_msr", False),
        output_iter_cmp_msr=getattr(args, "output_iter_cmp_msr", False),
        checkpoint_file=getattr(args, "checkpoint_file", ""),
        scale_normals_to_unity=args.scale_normals_to_unity,
        mode="phased" if args.phased else "simultaneous",
    )
    if args.constraints:
        _apply_cli_constraints(net, args.constraints)
    typeb_list, typeb_global = None, None
    if args.type_b_file:
        from .io_formats.aux_files import read_typeb_file
        typeb_list = read_typeb_file(args.type_b_file)
    if args.type_b_global:
        from .io_formats.aux_files import parse_typeb_global
        typeb_global = parse_typeb_global(args.type_b_global)

    import pickle
    in_folder = getattr(args, "input_folder", "") or args.output_folder
    base0 = os.path.join(args.output_folder, args.network_name)
    res_file = f"{base0}.results.pkl"
    if not os.path.exists(res_file):
        alt = os.path.join(in_folder, f"{args.network_name}.results.pkl")
        if os.path.exists(alt):
            res_file = alt

    _step("load")
    t0 = time.time()
    if args.report_mode:
        # regenerate reports from the serialised rigorous results
        # (reference: --report-mode + DeSerialiseAdjustedVarianceMatrices)
        if not os.path.exists(res_file):
            print("error: no saved adjustment results for report mode",
                  file=sys.stderr)
            return 1
        with open(res_file, "rb") as f:
            res = pickle.load(f)
    elif args.phased or args.block1_phased or args.staged_adjustment:
        # --staged-adjustment implies phased mode (the reference's staged
        # adjustment is a phased variant, dnaadjustwrapper.cpp)
        seg_file = os.path.join(args.output_folder,
                                f"{args.network_name}.seg.pkl")
        if not os.path.exists(seg_file):
            alt = os.path.join(in_folder, f"{args.network_name}.seg.pkl")
            if os.path.exists(alt):
                seg_file = alt
        if not os.path.exists(seg_file):
            # the reference requires a prior segmentation for phased
            # adjustment (adjust-no-seg CI test)
            print(f"- Error: no segmentation found for "
                  f"{args.network_name}; run segment first",
                  file=sys.stderr)
            return 1
        stage_base = args.stage_path or args.output_folder
        if args.staged_adjustment and not args.create_stage_files and \
                not os.path.exists(os.path.join(
                    stage_base, f"{args.network_name}.mtx")):
            # stage files from a previous run are required unless
            # --create-stage-files (adjust-no-memmap-02 CI test)
            print("- Error: no stage (.mtx) files found; rerun with "
                  "--create-stage-files", file=sys.stderr)
            return 1
        if args.tpu and not args.block1_phased:
            # device-native phased: the parallel blocked Schur solve
            # (two-level, or nested with --tpu-super-blocks; host-streamed
            # factors when staged) instead of the sequential
            # forward/reverse/combine sweeps
            from .adjust.tpu_blocked import adjust_tpu_blocked
            res = adjust_tpu_blocked(
                net, opts, seg_file,
                super_blocks=getattr(args, "tpu_super_blocks", 0),
                staged=bool(args.staged_adjustment), device=args.device)
        else:
            from .adjust.phased import adjust_phased
            res = adjust_phased(
                net, opts, seg_file,
                stage_dir=stage_base if args.staged_adjustment else None,
                stage_name=args.network_name, block1=args.block1_phased)
    else:
        res = adjust_simultaneous(net, opts, device=args.device)
    elapsed = time.time() - t0
    _step("adjust")

    if args.purge_stage_files:
        import shutil
        shutil.rmtree(os.path.join(args.stage_path or args.output_folder,
                                   f"{args.network_name}.mtx"),
                      ignore_errors=True)

    if not args.report_mode:
        with open(res_file, "wb") as f:
            pickle.dump(res, f, protocol=pickle.HIGHEST_PROTOCOL)
    _step("results.pkl")

    if typeb_list is not None or typeb_global is not None:
        from .io_formats.aux_files import apply_type_b
        n = apply_type_b(net, res, typeb_list, typeb_global)
        print(f"+ Applied Type B uncertainties to {n} stations")

    mode = "phased" if args.phased else "simultaneous"
    base = os.path.join(args.output_folder, args.network_name)
    suffix = ("phased-block1" if args.block1_phased
              else "phased-mt" if (args.phased and
                                   getattr(args, "multi_thread", False))
              else "phased" if args.phased else "simult")
    adj_path = f"{base}.{suffix}.adj"
    mode_text = ("sequential phased" if (args.phased or args.block1_phased
                                         or args.staged_adjustment)
                 else "simultaneous")
    from .project import net_path as _net_path
    _store = _net_path(args.output_folder, args.network_name)
    _step("type_b")
    write_adj(adj_path, net, res, opts, cmdline=" ".join(sys.argv),
              mode_text=mode_text,
              n_blocks=(len(res.block_info) if res.block_info else 0),
              total_time_s=elapsed,
              stations_file=_store, measurements_file=_store,
              geoid_file=getattr(net, "geoid_file", ""),
              print_adj_msr=args.output_adj_msr,
              tstat=getattr(args, "output_adj_msr_tstat", False),
              gnss_units=getattr(args, "output_adj_gnss_units", 0),
              msr_to_stn=getattr(args, "output_msr_to_stn", False),
              sort_msr_to_stn=(
                  {0: "name", 1: "count", 2: "file_order",
                   3: "count_desc"}[args.sort_msr_to_stn_field]
                  if getattr(args, "sort_msr_to_stn_field", -1) >= 0
                  else getattr(args, "sort_msr_to_stn", "name")),
              database_ids=getattr(args, "output_database_ids", False),
              sort_adj_msr=getattr(args, "sort_adj_msr", 0),
              print_ignored=getattr(args, "output_ignored_msrs", False),
              stn_coord_types=getattr(args, "stn_coord_types", "PLHhXYZ"),
              angular_style=("ddeg"
                             if getattr(args, "angular_msr_type", 0) == 1
                             else getattr(args, "angular_msr_format",
                                          "separated")),
              stn_corr=getattr(args, "stn_corrections", False),
              msr_prec_m=getattr(args, "precision_msr_linear", 4),
              msr_prec_s=getattr(args, "precision_msr_angular", 4),
              stn_prec_m=getattr(args, "precision_stn_linear", 4),
              stn_prec_s=getattr(args, "precision_stn_angular", 5),
              stn_angular=("ddeg" if getattr(args, "angular_stn_type", 0)
                           else "dms"),
              stn_file_order=getattr(args, "sort_stn_orig_order", False),
              output_stn_blocks=getattr(args, "output_stn_blocks", False),
              output_msr_blocks=getattr(args, "output_msr_blocks", False),
              comments=getattr(args, "comments", ""))
    _step("write_adj")
    write_xyz(f"{base}.xyz", net, res,
              stn_coord_types=getattr(args, "stn_coord_types", "PLHhXYZ"),
              stn_corr=getattr(args, "stn_corrections", False),
              stn_prec_m=getattr(args, "precision_stn_linear", 4),
              stn_prec_s=getattr(args, "precision_stn_angular", 5),
              stn_angular=("ddeg" if getattr(args, "angular_stn_type", 0)
                           else "dms"),
              stn_file_order=getattr(args, "sort_stn_orig_order", False))
    _step("write_xyz")
    if args.output_pos_uncertainty:
        from .output.uncertainty import write_apu
        units = {0: "XYZ", 1: "ENU", 2: "LLH"}.get(
            getattr(args, "output_apu_vcv_units", 1), "ENU")
        write_apu(f"{base}.apu", net, res, vcv_units=units,
                  confidence=opts.confidence_interval,
                  all_covariances=getattr(args, "output_all_covariances",
                                          False))
    if args.output_corrections_file:
        from .output.uncertainty import write_cor
        from .geodesy.conversions import geo_to_cart
        import numpy as _np
        if getattr(res, "initial_xyz", None) is not None:
            _oxyz2 = res.initial_xyz
        else:
            ox, oy, oz = geo_to_cart(net.lat, net.lon, net.height,
                                     net.datum.ellipsoid)
            _oxyz2 = _np.stack([ox, oy, oz], axis=-1)
        write_cor(f"{base}.cor", net, res, _oxyz2,
                  hz_threshold=getattr(args, "hz_corr_threshold", 0.0),
                  vt_threshold=getattr(args, "vt_corr_threshold", 0.0))
    if (getattr(args, "export_dna_stn_file", False) or
            getattr(args, "export_dna_msr_file", False)):
        from .io_formats.dna_writer import write_dna_stn, write_dna_msr
        if getattr(args, "export_dna_stn_file", False):
            write_dna_stn(f"{base}.adjusted.stn", net)
        if getattr(args, "export_dna_msr_file", False):
            write_dna_msr(f"{base}.adjusted.msr", net)
    _step("other_writers")
    project.save_network(net, args.output_folder, args.network_name)
    project.update_project(args.output_folder, args.network_name, "adjust",
                           {"mode": mode, "status": res.status,
                            "iterations": res.iterations,
                            "sigma_zero": res.sigma_zero})
    _step("save")

    print(f"+ Commencing {mode} adjustment")
    for e in res.iteration_log:
        print(f"  iteration {e['iteration']}: max correction "
              f"{e['max_corr']:.6g} m (station {e['station']})")
    for line in getattr(res, "oscillation", []) or []:
        print(line)
    print(f"+ {res.status} in {res.iterations} iterations "
          f"({elapsed:.2f} s)")
    print(f"  Measurements {res.measurement_count}  "
          f"Unknowns {res.unknown_count}  DoF {res.degrees_of_freedom}")
    print(f"  Chi squared {res.chi_squared:.2f}  "
          f"Sigma zero {res.sigma_zero:.3f}")
    print(f"  Chi-square test ({opts.confidence_interval:.1f}%)  "
          f"{res.chi_lower:.3f} < {res.sigma_zero:.3f} < "
          f"{res.chi_upper:.3f}  *** {res.pass_fail} ***")
    print(f"  Output: {adj_path}")
    print("  Times (s): " + "  ".join(f"{k} {v:.3f}"
                                      for k, v in steps.items()))
    # the reference returns ADJUST_SUCCESS from every normal completion
    # (threshold-exceeded / test-failed included); only exceptions fail
    # (dnaadjustwrapper.cpp:1466)
    return 0


def _apply_cli_constraints(net, spec: str):
    toks = [t.strip() for t in spec.split(",") if t.strip()]
    for name, cc in zip(toks[::2], toks[1::2]):
        if name not in net.name_to_idx:
            raise SystemExit(f"- Error: constraint station '{name}' is "
                             f"not in the network")
        cc = cc.upper()
        if len(cc) != 3 or any(c not in "CF" for c in cc):
            raise SystemExit(f"- Error: invalid constraint code '{cc}' "
                             f"for station {name} (use C/F triplets)")
        net.constraints[net.station_index(name)] = cc


# --help-module matches any caption by case-insensitive substring
_HELP_MODULES = (
    "Standard options", "Output options", "Export options",
    "Generic options", "Reference frame options",
    "Data screening options", "GNSS variance matrix scaling options",
    "Network simulation options", "Adjustment mode options",
    "Phased adjustment options", "Configuration options",
    "Stage adjustment options", "NTv2 creation options",
    "Interpolation options", "Interactive interpolation options",
    "Text file interpolation options", "Transformation options",
    "Data configuration options", "Title block options",
    "Mapping options",
)


class _HelpModule(argparse.Action):
    """--help-module <name>: print the verb's help and exit 0 when the
    name matches a known module title (substring, case-insensitive);
    unknown modules error, as the reference does
    (dnaimportwrapper.cpp:1463-1490)."""

    def __call__(self, parser, namespace, values, option_string=None):
        v = str(values).upper()
        if not any(v in m.upper() for m in _HELP_MODULES):
            print(f"- Error: Help module '{values}' is not in the list "
                  f"of options.", file=sys.stderr)
            parser.exit(1)
        parser.print_help()
        parser.exit(0)


def _add_common(p, project_opt=True):
    p.add_argument("--help-module", action=_HelpModule,
                   help="print help for this tool (reference help-module)")
    try:
        p.add_argument("--verbose-level", dest="verbose_level",
                       type=int, default=0,
                       help="verbosity (0-3; reference VERBOSE level; "
                            "boost-style prefixes like --verbose work)")
    except argparse.ArgumentError:
        pass                    # verb defines its own verbose option
    p.add_argument("--output-folder", default=".",
                   help="project/output folder")
    p.add_argument("-i", "--input-folder", default="",
                   help="folder to look in for interim project files "
                        "(default: the output folder)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress progress output")
    if project_opt:
        p.add_argument("-p", "--project-file", dest="tool_project_file",
                       default="",
                       help="load defaults from a .dnaproj project file")
    p.add_argument("--version", action="version",
                   version="dynadjust_tpu_torch")


def _add_adjust_args(p):
    p.add_argument("--output-adj-msr", action="store_true",
                   help="print adjusted measurements to the .adj file")
    p.add_argument("--output-adj-msr-tstat", "--output-tstat-adj-msr",
                   dest="output_adj_msr_tstat", action="store_true",
                   help="add the T-stat column to the adjusted "
                        "measurements table")
    p.add_argument("--output-adj-gnss-units", type=int, default=0,
                   choices=(0, 1, 2, 3),
                   help="adjusted GNSS baseline units: 0 as measured "
                        "(XYZ), 1 local ENU, 2 polar az/vert-angle/dist, "
                        "3 polar az/dist/up")
    p.add_argument("--checkpoint-file", default="",
                   help="save iteration state here and resume from it if "
                        "present (long-running adjustments)")
    p.add_argument("--angular-msr-format", default="separated",
                   choices=("separated", "symbols", "hp", "ddeg"),
                   help="angular measurement display format")
    p.add_argument("--angular-msr-type", type=int, default=0,
                   choices=(0, 1),
                   help="0: DMS (default), 1: decimal degrees "
                        "(OUTPUT_ANGULAR_TYPE_MSR); sets the display "
                        "format accordingly")
    p.add_argument("--precision-stn-linear", type=int, default=4,
                   help="decimal places for linear station values")
    p.add_argument("--precision-stn-angular", type=int, default=5,
                   help="seconds decimals for angular station coords")
    p.add_argument("--precision-msr-linear", type=int, default=4,
                   help="decimal places for linear measurement values")
    p.add_argument("--precision-msr-angular", type=int, default=4,
                   help="seconds decimals for angular measurement values")
    p.add_argument("--angular-stn-type", type=int, default=0,
                   help="station coordinate format: 0 DMS, 1 decimal "
                        "degrees")
    p.add_argument("--sort-stn-orig-order", action="store_true",
                   help="print stations in input-file order instead of "
                        "name order")
    p.add_argument("--stn-coord-types", default="PLHhXYZ",
                   help="station table coordinate columns: P lat, L lon, "
                        "H ortho, h ellipsoidal, X Y Z cartesian, "
                        "E N UTM, z zone")
    p.add_argument("--comments", default="",
                   help="user comments printed in the output file header")
    p.add_argument("--max-threads", type=int, default=0,
                   help="host BLAS/solver thread cap (reference parity; "
                        "0 = library default)")
    p.add_argument("--sort-adj-msr", "--sort-adj-msr-field",
                   dest="sort_adj_msr", type=int, default=0,
                   choices=range(8),
                   help="adjusted measurement sort: 0 file order, 1 type,"
                        " 2 instrument, 3 target, 4 value, 5 correction, "
                        "6 adj sd, 7 n-stat")
    p.add_argument("--output-ignored-msrs", action="store_true",
                   help="include ignored measurements in the adjusted "
                        "measurements table")
    p.add_argument("--output-json", action="store_true",
                   help="write a JSONL sibling of the adjustment report "
                        "(DnaAdjustmentReport/DnaStation/DnaMeasurement "
                        "records)")
    p.add_argument("--output-iter-adj-stat", action="store_true",
                   help="print adjustment statistics at each iteration")
    p.add_argument("--output-iter-adj-msr", action="store_true",
                   help="print adjusted measurements at each iteration")
    p.add_argument("--output-iter-cmp-msr", action="store_true",
                   help="print computed measurements at each iteration")
    p.add_argument("--output-iter-adj-stn", action="store_true",
                   help="print adjusted station coordinates at each "
                        "iteration")
    p.add_argument("--output-apu-vcv-units", type=int, default=1,
                   help="VCV units in the .apu file: 0 XYZ (cartesian), "
                        "1 ENU (local, default), 2 LLH (polar)")
    p.add_argument("--output-all-covariances", action="store_true",
                   help="print inter-station covariance blocks in the "
                        ".apu file")
    p.add_argument("--output-database-ids", action="store_true",
                   help="append measurement/cluster id columns to the "
                        "adjusted measurements table")
    p.add_argument("--output-stn-blocks", action="store_true",
                   help="list each segmentation block's stations in the "
                        ".adj (phased)")
    p.add_argument("--output-msr-blocks", action="store_true",
                   help="list per-block measurement counts in the .adj "
                        "(phased)")
    p.add_argument("--output-msr-to-stn", action="store_true",
                   help="print the measurement-to-station connectivity "
                        "summary")
    p.add_argument("--sort-msr-to-stn", default="name",
                   choices=("name", "count", "count_desc", "file_order"),
                   help="sort order of the msr-to-stn summary")
    p.add_argument("--sort-msr-to-stn-field", type=int, default=-1,
                   choices=(-1, 0, 1, 2, 3),
                   help="numeric m2s sort (OUTPUT_MSR_TO_STN_SORTBY): "
                        "0 name, 1 count, 2 file order, 3 count desc")
    p.add_argument("--block1-phased", action="store_true",
                   help="rigorous estimates for block 1 only (single "
                        "reverse sweep; AdjustPhasedBlock1)")
    p.add_argument("--phased", action="store_true",
                   help="phased (block-segmented) adjustment")
    p.add_argument("--multi-thread", action="store_true",
                   help="accepted for reference CLI compatibility "
                        "(device parallelism is automatic)")
    p.add_argument("--profile", action="store_true",
                   help="print hot-spot timing counters to stderr")
    p.add_argument("--verbose-level", type=int, default=0,
                   help=">=3 dumps normals/rhs/corrections to a .dbg file")
    p.add_argument("--tpu", action="store_true",
                   help="solve on the device (--device): the float32 "
                        "Cholesky-inverse kernel with a Newton-refined "
                        "float64 inverse; with --phased, the blocked "
                        "Schur adjustment")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the --tpu routes run: cuda (default; "
                        "exits non-zero without a card) or cpu (every "
                        "kernel's plain PyTorch version); the host route "
                        "(no --tpu) runs on the host either way")
    p.add_argument("--devices", type=int, default=0,
                   help="multi-device sharding (not ported: ROADMAP.md M7)")
    p.add_argument("--tpu-super-blocks", type=int, default=0,
                   help="with --phased --tpu: group the segmentation "
                        "blocks into this many super-blocks and solve "
                        "through the 3-level nested Schur factors (the "
                        "national-scale junction path)")
    p.add_argument("--scale-normals-to-unity", action="store_true")
    p.add_argument("--max-iterations", type=int, default=10)
    p.add_argument("--iteration-threshold", type=float, default=0.0005)
    p.add_argument("--confidence-interval", type=float, default=95.0)
    p.add_argument("--free-stn-sd", type=float, default=10.0)
    p.add_argument("--fixed-stn-sd", type=float, default=1.0e-6)
    p.add_argument("--constraints", default="",
                   help="station constraints: name,CCC,name2,FFC,...")
    p.add_argument("--output-pos-uncertainty", action="store_true",
                   help="write positional uncertainty (.apu) file")
    p.add_argument("--stn-corrections", action="store_true",
                   help="append corrections to initial coordinates "
                        "(e,n,up) to the adjusted station table")
    p.add_argument("--hz-corr-threshold", type=float, default=0.0,
                   help="only print corrections whose horizontal component "
                        "exceeds this (m)")
    p.add_argument("--vt-corr-threshold", type=float, default=0.0,
                   help="only print corrections whose vertical component "
                        "exceeds this (m)")
    p.add_argument("--output-corrections-file", action="store_true",
                   help="write station corrections (.cor) file")
    p.add_argument("--export-snx", "--export-sinex-file",
                   dest="export_snx", action="store_true",
                   help="export adjusted coordinates + covariance as SINEX")
    p.add_argument("--export-xml", "--export-xml-files",
                   dest="export_xml", action="store_true",
                   help="export adjusted stations+measurements as DynaML")
    p.add_argument("--export-xml-stn-file", action="store_true",
                   help="export adjusted stations as DynaML")
    p.add_argument("--export-xml-msr-file", action="store_true",
                   help="export measurements as DynaML")
    p.add_argument("--export-dna-stn-file", action="store_true",
                   help="export adjusted stations as DNA .stn")
    p.add_argument("--export-dna-msr-file", action="store_true",
                   help="export measurements as DNA .msr")
    p.add_argument("--report-results", action="store_true",
                   help="accepted for parity (results are always "
                        "reported to the .adj file)")
    p.add_argument("--type-b-file", "--type-b-sd-file",
                   dest="type_b_file", default="",
                   help="Type B uncertainty file")
    p.add_argument("--type-b-global", "--type-b-sd-global",
                   dest="type_b_global", default="",
                   help="global Type B sd: e,n,up (metres)")
    p.add_argument("--report-mode", action="store_true",
                   help="regenerate reports from saved results without "
                        "re-adjusting")
    p.add_argument("--stage-path", default="",
                   help="directory for staged .mtx files (default: output "
                        "folder)")
    p.add_argument("--create-stage-files", action="store_true",
                   help="force re-creation of stage .mtx files (accepted "
                        "for reference CLI parity; stage files are always "
                        "rebuilt per run)")
    p.add_argument("--purge-stage-files", action="store_true",
                   help="delete stage .mtx files after the adjustment")
    p.add_argument("--staged-adjustment", action="store_true",
                   help="offload per-block matrices to memory-mapped "
                        ".mtx files (bounded memory)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dynadjust_tpu_torch",
        description="geodetic network adjustment in PyTorch on a CUDA card")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("import", help="import station/measurement files")
    p.add_argument("-n", "--network-name", default="",
                   help="network name (default: first free 'networkN', "
                        "dnaimportwrapper.cpp:245)")
    p.add_argument("files", nargs="*")
    p.add_argument("--export-from-binary", action="store_true",
                   help="run exports from the saved network store instead "
                        "of re-parsing input files")
    p.add_argument("-r", "--reference-frame", default="")
    p.add_argument("-e", "--epoch", default="",
                   help="project reference epoch (dd.mm.yyyy)")
    p.add_argument("--observation-epoch", default="",
                   help="project-level epoch of observation (dd.mm.yyyy, "
                        "yyyy, or 'today') applied to measurements whose "
                        "observation epoch is unset "
                        "(dnaimportwrapper.cpp:321, "
                        "ApplyProjectObservationEpoch)")
    p.add_argument("--stn-renaming-file", default="")
    p.add_argument("-d", "--discontinuity-file", default="",
                   help="SINEX discontinuity file; renames station "
                        "references to SITE_YYYYDDD by observation epoch")
    p.add_argument("--export-asl-file", action="store_true",
                   help="export the station association list (text)")
    p.add_argument("--export-aml-file", action="store_true",
                   help="export the associated measurement list (text)")
    p.add_argument("--export-map-file", action="store_true",
                   help="export the station name-index map (text)")
    p.add_argument("--test-integrity", action="store_true",
                   help="validate station references, VCVs and cluster "
                        "covariance structure")
    p.add_argument("--prefer-single-x-as-g", action="store_true",
                   help="treat single-baseline X clusters as G baselines")
    p.add_argument("--include-msr-types", default="",
                   help="keep only these measurement type letters")
    p.add_argument("--exclude-msr-types", default="",
                   help="drop these measurement type letters")
    p.add_argument("--vscale", "--v-scale", dest="vscale", type=float,
                   default=1.0, help="global GNSS VCV scalar")
    p.add_argument("--pscale", "--p-scale", dest="pscale", type=float,
                   default=1.0)
    p.add_argument("--lscale", "--l-scale", dest="lscale", type=float,
                   default=1.0)
    p.add_argument("--hscale", "--h-scale", dest="hscale", type=float,
                   default=1.0)
    p.add_argument("--geo-file", default="",
                   help="import N values/deflections from a DNA .geo "
                        "file (LoadDNAGeoidFile)")
    p.add_argument("--ignore-similar-msr", action="store_true",
                   help="ignore the later measurement of each similar "
                        "pair")
    p.add_argument("--remove-ignored-msr", action="store_true",
                   help="drop ignored measurements entirely")
    p.add_argument("--ignore-insufficient-msrs", action="store_true",
                   help="detect stations with insufficient measurements "
                        "and ignore their measurements")
    p.add_argument("--split-gnss-cluster-msrs",
                   dest="split_clusters", action="store_true",
                   help="split GNSS X/Y clusters straddling a bounding box "
                        "or station selection boundary")
    p.add_argument("--simulate", action="store_true",
                   help="replace measurement values with values computed "
                        "from the station coordinates (zero-residual "
                        "network) and write a simulated .msr file")
    p.add_argument("--baseline-scalar-file", default="")
    p.add_argument("--get-msrs-transcending-box", action="store_true",
                   help="keep measurements crossing the bounding box and "
                        "their outside stations")
    p.add_argument("--include-stns-assoc-msrs", default="",
                   help="keep these stations and every associated "
                        "measurement (comma-separated names)")
    p.add_argument("--exclude-stns-assoc-msrs", default="",
                   help="drop these stations and every associated "
                        "measurement (comma-separated names)")
    p.add_argument("--import-block-stn-msr", type=int, default=0,
                   help="extract stations/measurements of this "
                        "segmentation block (1-based)")
    p.add_argument("--import-contiguous-stn-msr", type=int, default=-1,
                   help="extract stations/measurements of this contiguous "
                        "sub-network (1-based)")
    p.add_argument("--seg-file", default="",
                   help="segmentation file for block extraction (default: "
                        "<network>.seg.pkl)")
    p.add_argument("--nearby-stn-buffer", type=float, default=30.0,
                   help="distance (m) for the nearby-station search")
    p.add_argument("--export-discont-file", action="store_true",
                   help="export parsed discontinuity info as text")
    p.add_argument("--output-msr-to-stn", action="store_true",
                   help="write the measurement-to-station summary (.m2s)")
    p.add_argument("--sort-msr-to-stn-field", type=int, default=0,
                   help="m2s sort: 0 name, 1 count, 2 file order")
    p.add_argument("--export-xml-files", action="store_true",
                   help="export the network as DynaML station+measurement "
                        "files")
    p.add_argument("--single-xml-file", action="store_true",
                   help="export one combined DynaML file instead of "
                        "separate stn/msr files")
    p.add_argument("--bounding-box", default="",
                   help="lat_min,lon_min,lat_max,lon_max (degrees)")
    p.add_argument("--include-stns", default="")
    p.add_argument("--exclude-stns", default="")
    # exact-match aliases: the reference has ONLY the assoc-msrs forms,
    # so its CI abbreviates them as --include-stn/--exclude-stn
    p.add_argument("--include-stn", dest="include_stns_assoc_msrs_alias",
                   default="", help=argparse.SUPPRESS)
    p.add_argument("--exclude-stn", dest="exclude_stns_assoc_msrs_alias",
                   default="", help=argparse.SUPPRESS)
    p.add_argument("--flag-unused-stations", action="store_true")
    p.add_argument("--search-similar-gnss-msr", "--search-similar-msr",
                   dest="search_similar_msr", action="store_true")
    p.add_argument("--search-nearby-stn", action="store_true")
    p.add_argument("--export-dna", action="store_true",
                   help="re-export parsed data as DNA .stn/.msr")
    p.add_argument("--export-bst-bms", action="store_true",
                   help="export reference-compatible binary station/"
                        "measurement files (<name>.bst/<name>.bms, raw "
                        "station_t/measurement_t records)")
    p.add_argument("--override-input-ref-frame", action="store_true",
                   help="relabel all input data with -r without "
                        "transforming")
    _add_common(p)
    p.set_defaults(func=_cmd_import)

    p = sub.add_parser("segment", help="segment network into blocks")
    p.add_argument("network_name", nargs="?", default="")
    p.add_argument("--seg-file", default="",
                   help="output .seg file path override")
    p.add_argument("--min-inner-stns", type=int, default=150)
    p.add_argument("--max-block-stns", type=int, default=150)
    p.add_argument("--starting-stns", default="")
    p.add_argument("--net-file", action="store_true",
                   help="seed the first block with stations from "
                        "<network>.net")
    p.add_argument("--contiguous-blocks", type=int, default=0,
                   help="0: isolated networks as individual blocks "
                        "(default); 1: force contiguous blocks")
    p.add_argument("--search-level", type=int, default=0,
                   help="station search depth (accepted for parity; "
                        "selection is always global-lowest here)")
    p.add_argument("--test-integrity", action="store_true",
                   help="verify station-measurement connections per block")
    _add_common(p)
    p.set_defaults(func=_cmd_segment)

    p = sub.add_parser("adjust", help="least squares adjustment")
    p.add_argument("network_name", nargs="?", default="")
    _add_adjust_args(p)
    _add_common(p)
    p.set_defaults(func=_cmd_adjust)

    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    # options whose values may begin with '-' (e.g. southern-hemisphere
    # bounding boxes): fold the value into --opt=value form so argparse
    # does not mistake it for a flag
    _dashval = {"--bounding-box", "--latitude", "--longitude",
                "--centre-latitude", "--centre-longitude"}
    # legacy spelling kept out of the parser so the reference's --split
    # abbreviation stays unambiguous
    _alias = {"--split-clusters": "--split-gnss-cluster-msrs"}
    k = 0
    while k < len(argv) - 1:
        argv[k] = _alias.get(argv[k], argv[k])
        # boost::program_options allows unambiguous prefixes
        # (e.g. --bounding for --bounding-box), so match prefixes too
        tok = argv[k]
        is_dashval = len(tok) > 3 and tok.startswith("--") and any(
            full.startswith(tok) for full in _dashval)
        if is_dashval and argv[k + 1].startswith("-"):
            argv[k] = f"{tok}={argv[k + 1]}"
            del argv[k + 1]
        k += 1
    if argv:
        argv[-1] = _alias.get(argv[-1], argv[-1])
    args = parser.parse_args(argv)
    if getattr(args, "tool_project_file", ""):
        # per-tool project-file defaults (every reference tool accepts
        # `-p project.dnaproj`): fill unset args from the project
        from .io_formats.dnaproj import project_to_args
        loaded = project_to_args(args.tool_project_file)
        filled = set()
        for k, v in loaded.items():
            cur = getattr(args, k, None)
            if cur in (None, "", [], False, 0):
                setattr(args, k, v)
                filled.add(k)
        args._project_filled = filled
    if getattr(args, "multi_thread", False):
        args.phased = True
    if _refuse_unported(args) or _refuse_missing_card(args):
        return 1
    if hasattr(args, "network_name") and not args.network_name and \
            args.command in ("reftran", "segment", "adjust", "plot"):
        print("error: network name required (positional or via "
              "-p project file)", file=sys.stderr)
        return 1
    if getattr(args, "quiet", False):
        import contextlib
        import io as _io
        with contextlib.redirect_stdout(_io.StringIO()):
            return args.func(args)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
