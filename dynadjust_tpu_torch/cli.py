"""Command-line interface: the pipeline verbs of DynAdjust (import,
reftran, geoid, segment, adjust), the one-shot pipeline verb dynadjust,
and the metadata, diff and plot utilities.

Usage:
    python -m dynadjust_tpu_torch import  -n NAME stations.stn measurements.msr
    python -m dynadjust_tpu_torch reftran NAME [-r FRAME] [-e EPOCH]
    python -m dynadjust_tpu_torch geoid   NAME -g grid.gsb [--convert-stn-hts]
    python -m dynadjust_tpu_torch segment NAME [--min-inner-stns N]
                                              [--max-block-stns N]
    python -m dynadjust_tpu_torch adjust  NAME [--tpu] [--phased]
                                              [--block1-phased]
                                              [--staged-adjustment]
                                              [--tpu-super-blocks N]
                                              [--device cuda|cpu] ...
    python -m dynadjust_tpu_torch dynadjust -n NAME files... [-r FRAME]
                                              [-g grid.gsb] [adjust flags]
    python -m dynadjust_tpu_torch metadata NAME|FILE.bst|FILE.bms
    python -m dynadjust_tpu_torch diff FILE1 FILE2 [-t TOL]
    python -m dynadjust_tpu_torch plot NAME [--segmentation-graph]
                                              [--block-number N] ...

The verbs take the JAX package's arguments and write the same files
(``<name>.net.pkl``, ``.seg``, ``.sap``, ``.adj``, ``.xyz``,
``.results.pkl``, ``.adj.jsonl``, ``.snx``, DynaML ``.xml``, the
reference's binary ``.bst``/``.bms`` with ``.dbid``, ...); ``import``
also reads ``.bst``/``.bms`` and ``.jsonl`` inputs and ``--simulate``
writes ``<name>.simulated.msr``.
``adjust`` keeps the host float64 LAPACK route by default, and
``--phased``, ``--block1-phased`` or ``--staged-adjustment`` without
``--tpu`` take the host sequential phased adjustment (adjust/phased.py).
``--tpu`` selects the device routes: the dense simultaneous solve
(parallel/dense_device.py), the same solve per block of the sequential
sweeps with ``--block1-phased``, and, with ``--phased`` or
``--staged-adjustment``, the blocked Schur adjustment
(adjust/tpu_blocked.py; host-streamed factors when staged).  They run on
``--device`` (default ``cuda``); ``adjust --tpu`` and ``dynadjust --tpu``
exit non-zero before their first stage when the card they ask for is
absent.  The host route needs no card and ``--device`` does not touch
it.  ``reftran``, ``geoid``, ``metadata``, ``diff`` and ``plot``
(matplotlib, imported when the verb runs) are host code.
``adjust --phased --tpu --devices N`` (and ``dynadjust``) shards the
blocked adjustment over N ranks (parallel/multihost.py): N local ranks
(torch.multiprocessing, spawn; rank r on cuda:r over nccl, or on the CPU
over gloo with --device cpu), this process being rank 0; or, with
DTA_COORDINATOR / DTA_NUM_PROCESSES / DTA_PROCESS_ID set, this process
joins that group as one rank.  Rank 0 alone prints and writes the
adjustment's output files; under DTA_COORDINATOR, dynadjust's stages
before adjust run on rank 0 alone while the other ranks wait, then
every rank reads their files (a folder that every rank sees).

Parity reference: per-tool wrappers dna*wrapper/*.cpp and the dynadjust
pipeline (dynadjust/dynadjust.cpp:96-427) of DynAdjust.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

def _mesh_route(args) -> bool:
    """Whether this command runs the mesh route: --devices N on an
    adjust stage that takes the blocked device solve (--phased or
    --staged-adjustment with --tpu, not --block1-phased); elsewhere
    --devices is ignored, as in the JAX CLI."""
    return bool(getattr(args, "devices", 0) and _runs_adjust(args)
                and not args.report_mode and args.tpu
                and not args.block1_phased
                and (args.phased or args.staged_adjustment))


def _refuse_devices(args) -> bool:
    """Print an error and return True for a --devices request that cannot
    run: with --staged-adjustment, or more local cards than are
    visible."""
    if not _mesh_route(args):
        return False
    if args.staged_adjustment:
        # the host-streamed factors are single-device; a mesh would raise
        # deep inside adjust_tpu_blocked
        print("- Error: --devices cannot be combined with "
              "--staged-adjustment (host-streamed factors are "
              "single-device)", file=sys.stderr)
        return True
    if args.device == "cuda" and not os.environ.get("DTA_COORDINATOR"):
        import torch
        ncard = torch.cuda.device_count()
        if args.devices > ncard:
            print(f"- Error: --devices {args.devices} but only {ncard} "
                  f"devices visible", file=sys.stderr)
            return True
    return False


def _run_as_rank(args) -> int:
    """Run the command as one rank of the group that DTA_COORDINATOR,
    DTA_NUM_PROCESSES and DTA_PROCESS_ID describe (one process per card
    on each host): every rank runs the adjustment, rank 0 alone prints
    and writes.  dynadjust's stages before adjust run on rank 0 alone;
    the other ranks wait for them and then read the files they wrote,
    so the output folder must be one that every rank sees."""
    import contextlib
    import torch.distributed as dist
    from .parallel import multihost as mh
    mh.init_distributed(cpu=args.device == "cpu")
    try:
        world = dist.get_world_size()
        if world != args.devices:
            print(f"- Error: --devices {args.devices} but the distributed "
                  f"run has {world} ranks (DTA_NUM_PROCESSES)",
                  file=sys.stderr)
            return 1
        args.rank = dist.get_rank()
        if args.rank == 0 and not getattr(args, "quiet", False):
            return args.func(args)
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return args.func(args)
    finally:
        dist.destroy_process_group()


def _rank0_value(v: int) -> int:
    """Rank 0's v on every rank of the distributed run: an all_reduce of
    rank 0's v and the other ranks' zeros."""
    import torch
    from .parallel import multihost as mh
    mesh = mh.global_block_mesh()
    t = torch.tensor([v if mesh.rank == 0 else 0], dtype=torch.int64,
                     device=mesh.host_device)
    return int(mh.psum(t, mesh).item())


def _adjust_rank(mesh, net, opts, seg_file, kw):
    """A local helper rank of adjust --devices: the same adjustment, its
    result dropped (rank 0 reports)."""
    import contextlib
    from .adjust.tpu_blocked import adjust_tpu_blocked
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        adjust_tpu_blocked(net, opts, seg_file, mesh=mesh, **kw)


def _adjust_on_devices(args, net, opts, seg_file, kw):
    """adjust_tpu_blocked over args.devices ranks.  Inside a distributed
    run (_run_as_rank) this process is one rank: returns the result on
    rank 0 and None on the others.  Otherwise this process is rank 0 of
    a local group: ranks 1 .. N-1 are spawned (the network and options
    pickled to them), the group meets in a file store, every rank
    adjusts, and the helpers are joined (killed past the time limit; a
    failed rank raises)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from .adjust.tpu_blocked import adjust_tpu_blocked
    from .parallel import multihost as mh
    if dist.is_initialized():
        mesh = mh.global_block_mesh()
        res = adjust_tpu_blocked(net, opts, seg_file, mesh=mesh, **kw)
        return res if mesh.rank == 0 else None
    world = args.devices
    cpu = args.device == "cpu"
    backend, device = mh.placement(world, device="cpu" if cpu else None)
    if not cpu:
        # build the kernels once here, before the ranks would race on it
        from .ops import kernels
        kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs = mh.start_ranks(_adjust_rank, range(1, world), world, init,
                               backend, device,
                               args=(net, opts, seg_file, kw),
                               threads=torch.get_num_threads())
        try:
            mh.init_distributed(num_processes=world, process_id=0,
                                init_method=init, backend=backend,
                                device=device or "cuda:0")
            try:
                res = adjust_tpu_blocked(net, opts, seg_file,
                                         mesh=mh.global_block_mesh(), **kw)
            finally:
                dist.destroy_process_group()
        except BaseException:
            for p in procs:
                p.kill()
            raise
        mh.join_ranks(procs)
    return res


def _runs_adjust(args) -> bool:
    """Whether this verb runs the adjust stage: adjust always; dynadjust
    unless explicit program switches leave --adjust out."""
    if args.command == "adjust":
        return True
    if args.command != "dynadjust":
        return False
    switches = (args.run_import, args.run_reftran, args.run_geoid,
                args.run_segment, args.run_adjust)
    return args.run_adjust or not any(switches)


def _refuse_missing_card(args) -> bool:
    """adjust --tpu (and dynadjust --tpu) runs on the card unless --device
    cpu asks for the CPU: with no card it stops before its first stage
    instead of carrying on on the CPU.  The host float64 route (no --tpu)
    never touches the device and needs no card."""
    if (not _runs_adjust(args) or args.report_mode or not args.tpu
            or args.device != "cuda"):
        return False
    import torch
    if torch.cuda.is_available():
        return False
    print(f"- Error: {args.command} --tpu runs on the CUDA card (--device "
          f"cuda) and no card is present; pass --device cpu to run on the "
          f"CPU", file=sys.stderr)
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

    disconts = None
    if getattr(args, "discontinuity_file", ""):
        from .io_formats.discontinuities import read_discontinuities
        disconts = read_discontinuities(args.discontinuity_file)
        nsites = sum(1 for ws in disconts.values() if ws[0].exists)
        print(f"+ Loaded discontinuity file: {nsites} discontinuity sites")

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
        if getattr(args, "export_xml_files", False) or \
                getattr(args, "single_xml_file", False):
            from .io_formats.dynaml import (write_dynaml_stn,
                                            write_dynaml_msr,
                                            write_dynaml_combined)
            if getattr(args, "single_xml_file", False):
                write_dynaml_combined(f"{base}.xml", net)
                print(f"+ Exported combined DynaML: {base}.xml")
            else:
                write_dynaml_stn(f"{base}stn.xml", net)
                write_dynaml_msr(f"{base}msr.xml", net)
                print(f"+ Exported DynaML: {base}stn.xml / {base}msr.xml")
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
    _bst_names = []
    for path in args.files:
        if path.endswith(".stn"):
            stns, frame, epoch = read_dna_stn(path)
            stations.extend(stns)
        elif path.endswith(".bst"):
            # reference binary station file (raw station_t records)
            from .io_formats.dna import Station
            from .io_formats.binary import (read_bst, frame_from_epsg,
                                            _cstr as _bs)
            from .geodesy.conversions import rad_to_dms
            rows_b, meta_b = read_bst(path)
            for s in rows_b:
                nm = _bs(s["stationName"])
                _bst_names.append(nm)
                stations.append(Station(
                    name=nm,
                    constraints=_bs(s["stationConst"]) or "FFF",
                    coord_type="LLh",
                    p1=float(rad_to_dms(s["currentLatitude"])),
                    p2=float(rad_to_dms(s["currentLongitude"])),
                    p3=float(s["currentHeight"]),
                    description=_bs(s["description"])))
            frame = frame or frame_from_epsg(meta_b["epsg"])
            epoch = epoch or meta_b["epoch"]
        elif path.endswith(".bms"):
            # reference binary measurement file; station indices refer
            # to the .bst listed before it
            from .io_formats.binary import read_bms, records_from_rows
            if not _bst_names:
                print("- Error: a .bms file requires its .bst station "
                      "file to be listed first", file=sys.stderr)
                return 1
            rows_m, _ = read_bms(path)
            recs_m = records_from_rows(rows_m, _bst_names)
            dbid_path = path[:-4] + ".dbid"
            if os.path.exists(dbid_path):
                # re-attach measurement database ids (LoadDatabaseId)
                from .io_formats.dbid import read_dbid, apply_dbid
                from types import SimpleNamespace
                try:
                    apply_dbid(SimpleNamespace(measurements=recs_m),
                               read_dbid(dbid_path))
                except ValueError as e:
                    print(f"- Warning: ignoring {dbid_path}: {e}",
                          file=sys.stderr)
            measurements.extend(recs_m)
        elif path.endswith(".msr"):
            recs, mframe, mepoch = read_dna_msr(path)
            measurements.extend(recs)
            frame = frame or mframe
            epoch = epoch or mepoch
        elif path.endswith(".jsonl"):
            from .io_formats.jsonl import read_jsonl
            stns, recs, jframe, jepoch = read_jsonl(path)
            stations.extend(stns)
            measurements.extend(recs)
            frame = frame or jframe
            epoch = epoch or jepoch
        elif path.endswith((".snx", ".SNX")):
            from .io_formats.sinex import read_sinex
            stns, recs, sframe, sepoch = read_sinex(path, disconts=disconts)
            stations.extend(stns)
            measurements.extend(recs)
            frame = frame or sframe
            epoch = epoch or sepoch
        elif path.endswith(".xml"):
            from .io_formats.dynaml import read_dynaml
            stns, recs, xframe, xepoch = read_dynaml(path)
            stations.extend(stns)
            measurements.extend(recs)
            frame = frame or xframe
            epoch = epoch or xepoch
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
    discont_pairs = []
    if disconts:
        from .io_formats.discontinuities import apply_discontinuities
        discont_pairs = apply_discontinuities(stations, measurements,
                                              disconts)
        if discont_pairs:
            print(f"+ Applied discontinuities: {len(discont_pairs)} "
                  f"station renames")

    def _expand_discont(names):
        # user-supplied station lists name the original sites; add the
        # discontinuity-renamed variants (BuildExtractStationsList,
        # dnainterop.cpp:136-172)
        out = list(names)
        for nm in names:
            out.extend(new for old, new in discont_pairs if old == nm)
        return out
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
        inc = _expand_discont([t for t in args.include_stns.split(",") if t])
        exc = _expand_discont([t for t in args.exclude_stns.split(",") if t])
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
        inc = _expand_discont(
            [t for t in args.include_stns_assoc_msrs.split(",") if t])
        exc = _expand_discont(
            [t for t in args.exclude_stns_assoc_msrs.split(",") if t])
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
    if getattr(args, "simulate", False):
        from .network.simulate import simulate_measurements
        from .io_formats.dna_writer import write_dna_msr
        n = simulate_measurements(net)
        base = os.path.join(args.output_folder, args.network_name)
        write_dna_msr(f"{base}.simulated.msr", net)
        print(f"+ Simulated {n} measurement records -> "
              f"{base}.simulated.msr")
    if getattr(args, "export_asl_file", False) or \
            getattr(args, "export_aml_file", False) or \
            getattr(args, "export_map_file", False):
        from .io_formats import assoc_files
        base = os.path.join(args.output_folder, args.network_name)
        if args.export_asl_file:
            assoc_files.export_asl(f"{base}.asl.txt", net)
            print(f"+ Exported {base}.asl.txt")
        if args.export_aml_file:
            assoc_files.export_aml(f"{base}.aml.txt", net)
            print(f"+ Exported {base}.aml.txt")
        if args.export_map_file:
            assoc_files.export_map(f"{base}.map.txt", net)
            print(f"+ Exported {base}.map.txt")
    if getattr(args, "export_dna", False):
        from .io_formats.dna_writer import write_dna_stn, write_dna_msr
        base = os.path.join(args.output_folder, args.network_name)
        write_dna_stn(f"{base}.export.stn", net)
        write_dna_msr(f"{base}.export.msr", net)
        print(f"+ Exported DNA files: {base}.export.stn/.msr")
    if getattr(args, "export_xml_files", False) or \
            getattr(args, "single_xml_file", False):
        from .io_formats.dynaml import (write_dynaml_stn, write_dynaml_msr,
                                        write_dynaml_combined)
        base = os.path.join(args.output_folder, args.network_name)
        if getattr(args, "single_xml_file", False):
            write_dynaml_combined(f"{base}.xml", net)
            print(f"+ Exported combined DynaML: {base}.xml")
        else:
            write_dynaml_stn(f"{base}stn.xml", net)
            write_dynaml_msr(f"{base}msr.xml", net)
            print(f"+ Exported DynaML files: {base}stn.xml / {base}msr.xml")
    if getattr(args, "export_discont_file", "") and disconts:
        from .io_formats.discontinuities import export_discontinuities
        base = os.path.join(args.output_folder, args.network_name)
        export_discontinuities(f"{base}.discont.txt", disconts)
        print(f"+ Exported discontinuity info: {base}.discont.txt")
    if getattr(args, "export_bst_bms", False):
        # reference-compatible binary files (the full set the reference
        # import writes: bst/bms/asl/aml/map)
        from .io_formats.binary import (write_bst, write_bms,
                                        write_asl_aml, write_map)
        from .io_formats.dbid import write_dbid
        base = os.path.join(args.output_folder, args.network_name)
        write_bst(f"{base}.bst", net)
        write_bms(f"{base}.bms", net)
        write_asl_aml(f"{base}.asl", f"{base}.aml", net)
        write_map(f"{base}.map", net)
        # measurement database ids, one record per binary row (the
        # reference's SerialiseDatabaseId, dnainterop.cpp:5117)
        write_dbid(f"{base}.dbid", net)
        print(f"+ Exported binary files: "
              f"{base}.bst/.bms/.asl/.aml/.map/.dbid")
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



def _cmd_geoid(args) -> int:
    from .io_formats.ntv2 import NTv2Grid
    from .geoid import apply_geoid
    from . import project

    # reference-CLI aliases
    if args.interpolation_method in ("0", "1"):
        args.interpolation_method = ("bilinear"
                                     if args.interpolation_method == "0"
                                     else "bicubic")
    if getattr(args, "create_ntv2_flag", False) and not args.create_ntv2:
        if not getattr(args, "dat_file", ""):
            print("error: -c requires -d/--dat-file", file=sys.stderr)
            return 1
        args.create_ntv2 = args.dat_file
    if getattr(args, "export_ntv2_asc_flag", False) and \
            not args.export_ascii_grid:
        args.export_ascii_grid = args.grid + ".asc"
    if getattr(args, "export_ntv2_gsb_flag", False) and \
            not args.export_ntv2_gsb_file:
        args.export_ntv2_gsb_file = args.grid + ".gsb"

    if getattr(args, "create_ntv2", ""):
        from .geoid.gridtools import create_ntv2_from_dat, write_gsb
        grid = create_ntv2_from_dat(
            args.create_ntv2,
            uncertainty_path=getattr(args, "dat_uncertainty_file", ""),
            gs_type=getattr(args, "grid_shift_type", "SECONDS"),
            version=getattr(args, "grid_version", "1.0.0.0"),
            system_from=getattr(args, "system_from", "GDA94"),
            system_to=getattr(args, "system_to", "AHD_1971"),
            sub_grid_name=getattr(args, "sub_grid_name", "AUSGEOID"),
            created=getattr(args, "creation_date", ""),
            updated=getattr(args, "update_date", ""),
            semi_major_from=getattr(args, "semi_major_from", 6378137.0),
            semi_minor_from=getattr(args, "semi_minor_from", 6356752.314),
            semi_major_to=getattr(args, "semi_major_to", 6378137.0),
            semi_minor_to=getattr(args, "semi_minor_to", 6356752.314))
        write_gsb(grid, args.grid)
        print(f"+ Created NTv2 grid {args.grid} from {args.create_ntv2}")
        return 0
    if getattr(args, "summary", False):
        from .geoid.gridtools import grid_summary
        grid = NTv2Grid.read(args.grid)
        for line in grid_summary(grid, args.grid):
            print(line)
        return 0
    if getattr(args, "interactive", False):
        from .geodesy.conversions import dms_to_rad
        import numpy as _np
        grid = NTv2Grid.read(args.grid)
        if not args.latitude or not args.longitude:
            print("error: --latitude and --longitude required for "
                  "interactive interpolation", file=sys.stderr)
            return 1
        if getattr(args, "decimal_degrees", False):
            lat = _np.radians(float(args.latitude))
            lon = _np.radians(float(args.longitude))
        else:
            lat = float(dms_to_rad(float(args.latitude)))
            lon = float(dms_to_rad(float(args.longitude)))
        vals = grid.interpolate(lat, lon, args.interpolation_method)
        if vals is None:
            print("- Error: point is outside the grid", file=sys.stderr)
            return 1
        print(f"{'Latitude:':<28}{_np.degrees(lat):.9f}")
        print(f"{'Longitude:':<28}{_np.degrees(lon):.9f}")
        print(f"{'N value:':<28}{vals[0]:.3f} m")
        print(f"{'Deflection (meridian):':<28}{vals[1]:.3f} sec")
        print(f"{'Deflection (prime vert):':<28}{vals[2]:.3f} sec")
        return 0
    if getattr(args, "export_ascii_grid", ""):
        from .geoid.gridtools import export_ascii
        grid = NTv2Grid.read(args.grid)
        export_ascii(grid, args.export_ascii_grid)
        print(f"+ Exported {args.grid} to {args.export_ascii_grid}")
        return 0
    if getattr(args, "export_ntv2_gsb_file", ""):
        from .geoid.gridtools import write_gsb
        grid = NTv2Grid.read(args.grid)
        write_gsb(grid, args.export_ntv2_gsb_file)
        print(f"+ Exported {args.grid} to {args.export_ntv2_gsb_file}")
        return 0
    if getattr(args, "point_file", ""):
        from .geoid.gridtools import interpolate_point_file
        grid = NTv2Grid.read(args.grid)
        out = args.point_file + ".geoid.txt"
        done, skipped = interpolate_point_file(
            grid, args.point_file, out, method=args.interpolation_method,
            convert_heights=True,
            dms=not getattr(args, "decimal_degrees", False),
            direction=getattr(args, "direction", 0))
        print(f"+ Interpolated {done} points ({skipped} skipped) -> {out}")
        return 0
    if not args.network_name:
        print("error: network name required", file=sys.stderr)
        return 1

    net = project.load_network(getattr(args, 'input_folder', '') or
                               args.output_folder, args.network_name)
    grid = NTv2Grid.read(args.grid)
    n = apply_geoid(net, grid, convert_heights=args.convert_stn_hts,
                    method=args.interpolation_method)
    net.geoid_file = args.grid
    project.save_network(net, args.output_folder, args.network_name)
    project.update_project(args.output_folder, args.network_name, "geoid",
                           {"grid": args.grid,
                            "convert_heights": args.convert_stn_hts})
    print(f"+ Interpolated geoid components for {n} of "
          f"{net.nstations} stations")
    if getattr(args, "export_dna_geo_file", False):
        from .geoid.gridtools import export_dna_geo
        base = os.path.join(args.output_folder, args.network_name)
        export_dna_geo(f"{base}.geo", net)
        print(f"+ Exported DNA geoid file: {base}.geo")
    return 0


def _cmd_reftran(args) -> int:
    from .reftran import transform_network
    from . import project

    plate_model = None
    if getattr(args, "plate_model_option", 0) == 1 and not \
            getattr(args, "plate_boundary_file", ""):
        print("- Error: --plate-model-option 1 requires a plate boundary "
              "file (-b) and pole file (-m)", file=sys.stderr)
        return 1
    for fattr in ("plate_boundary_file", "plate_pole_file"):
        fp = getattr(args, fattr, "")
        if fp and not os.path.exists(fp):
            print(f"- Error: {fp} does not exist", file=sys.stderr)
            return 1
    if bool(getattr(args, "plate_boundary_file", "")) != \
            bool(getattr(args, "plate_pole_file", "")):
        print("- Error: the plate motion model needs both -b (boundaries)"
              " and -m (Euler poles)", file=sys.stderr)
        return 1
    if getattr(args, "plate_boundary_file", "") and \
            getattr(args, "plate_pole_file", ""):
        from .reftran.plates import load_plate_model
        plate_model = load_plate_model(args.plate_boundary_file,
                                       args.plate_pole_file)
        print(f"+ Loaded plate motion model "
              f"({len(plate_model.polygons)} plates)")

    net = project.load_network(getattr(args, 'input_folder', '') or
                               args.output_folder, args.network_name)
    if getattr(args, "override_input_ref_frame", False) and \
            args.reference_frame:
        # --override-input-ref-frame: relabel without transformation
        # (replace the frame recorded from the input files)
        net.frame = args.reference_frame.upper()
        if net.station_frames:
            net.station_frames = [""] * net.nstations
        print(f"+ Input reference frame overridden to {net.frame}")
    stats = transform_network(net, args.reference_frame or None,
                              args.epoch or "", plate_model=plate_model)
    project.save_network(net, args.output_folder, args.network_name)
    project.update_project(args.output_folder, args.network_name, "reftran",
                           {"frame": net.frame, "epoch": net.epoch})
    print(f"+ Transformed {stats['stations']} stations "
          f"({stats['stations_skipped']} already on {net.frame}), "
          f"{stats['measurements']} measurement clusters "
          f"({stats['measurements_skipped']} skipped)")
    if getattr(args, "export_dna", False) or \
            getattr(args, "export_xml", False):
        # export name: <network>.<frame>[.<epoch>] (epoch only when the
        # target frame is dynamic), dnareftranwrapper.cpp:255-263
        from .params.datums import is_dynamic_frame
        base_name = f"{args.network_name}.{net.frame}"
        if is_dynamic_frame(net.frame) and net.epoch:
            base_name += f".{net.epoch}"
        base = os.path.join(args.output_folder, base_name)
        if getattr(args, "export_dna", False):
            from .io_formats.dna_writer import write_dna_stn, write_dna_msr
            write_dna_stn(f"{base}.stn", net)
            write_dna_msr(f"{base}.msr", net)
            print(f"+ Exported stations and measurements to:\n"
                  f"  - {base}.stn\n  - {base}.msr")
        if getattr(args, "export_xml", False):
            from .io_formats.dynaml import (write_dynaml_stn,
                                            write_dynaml_msr,
                                            write_dynaml_combined)
            if getattr(args, "single_xml_file", False):
                write_dynaml_combined(f"{base}.xml", net)
                print(f"+ Exported combined DynaML: {base}.xml")
            else:
                write_dynaml_stn(f"{base}stn.xml", net)
                write_dynaml_msr(f"{base}msr.xml", net)
                print(f"+ Exported stations and measurements to:\n"
                      f"  - {base}stn.xml\n  - {base}msr.xml")
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
            kw = dict(super_blocks=getattr(args, "tpu_super_blocks", 0),
                      staged=bool(args.staged_adjustment))
            if _mesh_route(args):
                # multi-device: the blocks sharded over the ranks
                res = _adjust_on_devices(args, net, opts, seg_file, kw)
                if res is None:
                    return 0            # a rank other than 0 reports nothing
            else:
                res = adjust_tpu_blocked(net, opts, seg_file,
                                         device=args.device, **kw)
        else:
            from .adjust.phased import adjust_phased
            res = adjust_phased(
                net, opts, seg_file,
                stage_dir=stage_base if args.staged_adjustment else None,
                stage_name=args.network_name, block1=args.block1_phased,
                device=args.device)
    else:
        res = adjust_simultaneous(net, opts, device=args.device)
    elapsed = time.time() - t0
    _step("adjust")
    if os.environ.get("DTA_PROFILE") and (res.profile or {}).get("newton"):
        print("DTA_PROFILE device solves (n, Newton rounds, residual, "
              "route): " + "  ".join(
                  f"({r['n']}, {r['rounds']}, {r['residual']:.3e}, "
                  f"{r['route']})" for r in res.profile["newton"]))

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
    if getattr(args, "output_json", False):
        from .output.json_writer import write_adj_jsonl
        from .geodesy.conversions import geo_to_cart as _g2c
        import numpy as _np
        if getattr(res, "initial_xyz", None) is not None:
            _oxyz = res.initial_xyz
        else:
            ox, oy, oz = _g2c(net.lat, net.lon, net.height,
                              net.datum.ellipsoid)
            _oxyz = _np.stack([ox, oy, oz], axis=-1)
        n = write_adj_jsonl(f"{base}.adj.jsonl", net, res, _oxyz)
        print(f"+ Wrote {base}.adj.jsonl ({n} records)")
        from .output.json_writer import write_xyz_jsonl
        write_xyz_jsonl(f"{base}.xyz.jsonl", net, res)
        if args.output_pos_uncertainty:
            from .output.json_writer import write_apu_jsonl
            write_apu_jsonl(f"{base}.apu.jsonl", net, res,
                            opts.confidence_interval)
        if args.output_corrections_file:
            from .output.json_writer import write_cor_jsonl
            write_cor_jsonl(f"{base}.cor.jsonl", net, res, _oxyz)
    _step("write_json")
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
    if args.export_snx or getattr(args, "export_sinex_file", False):
        from .io_formats.sinex import write_sinex
        write_sinex(f"{base}.snx", net, res)
    export_xml_stn = (args.export_xml or
                      getattr(args, "export_xml_stn_file", False))
    export_xml_msr = (args.export_xml or
                      getattr(args, "export_xml_msr_file", False))
    if export_xml_stn or export_xml_msr:
        from .io_formats.dynaml import write_dynaml_stn, write_dynaml_msr
        if export_xml_stn:
            write_dynaml_stn(f"{base}.adjusted.stn.xml", net)
        if export_xml_msr:
            write_dynaml_msr(f"{base}.adjusted.msr.xml", net)
    _step("write_snx_xml")
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


def _cmd_dynadjust(args) -> int:
    """Orchestrator: run import → reftran → geoid → segment → adjust
    (the reference's stage order, dynadjust.cpp:288-427)."""
    cli_files = bool(args.files)
    if not getattr(args, "project_file", "") and args.network_name:
        # the reference loads <network>.dnaproj implicitly from -n
        # (dynadjust.cpp:250; dynadjust-name-01 CI test)
        cand = os.path.join(args.output_folder, f"{args.network_name}.dnaproj")
        if os.path.exists(cand):
            args.project_file = cand
    if getattr(args, "project_file", ""):
        from .io_formats.dnaproj import project_to_args
        loaded = project_to_args(args.project_file)
        for k, v in loaded.items():
            cur = getattr(args, k, None)
            if cur in (None, "", [], False, 0) or \
                    (k == "files" and not args.files):
                setattr(args, k, v)
        print(f"+ Loaded project file {args.project_file} "
              f"(network {args.network_name})")
    if not args.network_name:
        print("error: network name required (use -n or -p)",
              file=sys.stderr)
        return 1
    stage_flags = [args.run_import, args.run_reftran, args.run_geoid,
                   args.run_segment, args.run_adjust]
    explicit = any(stage_flags)
    if not explicit and not cli_files:
        # the reference requires at least one program switch
        # (dyna-no-programs CI test)
        print("- Error: no DynAdjust programs specified (use --import, "
              "--reftran, --geoid, --segment, --adjust)", file=sys.stderr)
        return 1
    if not args.files and (not explicit or args.run_import):
        print("error: no input files (use positional files or -p)",
              file=sys.stderr)
        return 1
    rank = getattr(args, "rank", None)
    if rank:
        # another rank of a distributed run (_run_as_rank): rank 0 alone
        # runs the stages before adjust, writing their files and the
        # log; this rank waits for its exit code, then joins the adjust
        # stage on the files rank 0 wrote
        rc = _rank0_value(0)
        run_adjust = args.run_adjust if explicit else True
        return rc or (_cmd_adjust(args) if run_adjust else 0)
    if getattr(args, "export_project", ""):
        from .io_formats.dnaproj import write_dnaproj
        import os as _os
        sections = {
            "general": [("network-name", args.network_name),
                        ("input-folder", "."),
                        ("output-folder", args.output_folder)],
            "import": ([("stn-msr-file", _os.path.basename(f))
                        for f in args.files] +
                       [("reference-frame", args.reference_frame)]),
            "reftran": [("reference-frame", args.reference_frame),
                        ("epoch", args.epoch)],
            "geoid": [("ntv2-file", args.grid),
                      ("interpolation-method",
                       "1" if args.interpolation_method == "bicubic"
                       else "0"),
                      ("convert-stn-hts",
                       "yes" if args.convert_stn_hts else "no")],
            "segment": [("min-inner-stns", str(args.min_inner_stns)),
                        ("max-block-stns", str(args.max_block_stns))],
            "adjust": [("adjustment-mode",
                        "phased-adjustment" if args.phased
                        else "simultaneous-adjustment"),
                       ("conf-interval", str(args.confidence_interval)),
                       ("iteration-threshold",
                        str(args.iteration_threshold)),
                       ("max-iterations", str(args.max_iterations)),
                       ("free-stn-sd", str(args.free_stn_sd)),
                       ("fixed-stn-sd", str(args.fixed_stn_sd))],
            "output": [("output-adj-msr",
                        "yes" if args.output_adj_msr else "no")],
        }
        write_dnaproj(args.export_project, sections)
        print(f"+ Wrote project file {args.export_project}")
    # pipeline log (dynadjust.log; dynadjust.cpp:254-286 — failed stage
    # short-circuits, each stage's status recorded)
    import datetime as _dt
    log_path = getattr(args, "dynadjust_log_file", "") or \
        os.path.join(args.output_folder, "dynadjust.log")
    log = open(log_path, "a")

    def _stage(name, fn, enabled=True):
        if not enabled:
            return 0
        t0 = time.time()
        log.write(f"{_dt.datetime.now():%Y-%m-%d %H:%M:%S}  {name:<10}"
                  f"started\n")
        log.flush()
        try:
            rc = fn(args)
        except Exception as e:
            log.write(f"{_dt.datetime.now():%Y-%m-%d %H:%M:%S}  "
                      f"{name:<10}EXCEPTION: {e}\n")
            log.close()
            raise
        status = "done" if rc == 0 else f"FAILED (exit {rc})"
        log.write(f"{_dt.datetime.now():%Y-%m-%d %H:%M:%S}  {name:<10}"
                  f"{status} ({time.time() - t0:.2f} s)\n")
        log.flush()
        return rc

    log.write(f"{_dt.datetime.now():%Y-%m-%d %H:%M:%S}  dynadjust "
              f"pipeline: network {args.network_name}\n")
    # with explicit program switches run exactly those stages; otherwise
    # (files given directly) run the full pipeline
    stages = [
        ("import", _cmd_import,
         args.run_import if explicit else True),
        ("reftran", _cmd_reftran,
         args.run_reftran if explicit else True),
        ("geoid", _cmd_geoid,
         args.run_geoid if explicit else bool(args.grid)),
        ("segment", _cmd_segment,
         args.run_segment if explicit else args.phased),
        ("adjust", _cmd_adjust,
         args.run_adjust if explicit else True),
    ]
    rc, shared = 0, 1
    try:
        for name, fn, enabled in stages[:-1]:
            rc = _stage(name, fn, enabled)
            if rc:
                break
        shared = rc
    finally:
        if rank == 0:
            # release the other ranks (with 1 when a stage raised)
            _rank0_value(shared)
    if not rc:
        rc = _stage(*stages[-1])
    log.close()
    return rc


# the reference's option-group captions (dnaoptions-interface.hpp:32-58);
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
                   help="with --phased --tpu: shard the adjustment over "
                        "this many ranks, one per device (local ranks on "
                        "cuda:0..N-1 over nccl, or CPU ranks over gloo "
                        "with --device cpu). Multi-host via "
                        "DTA_COORDINATOR/DTA_NUM_PROCESSES/DTA_PROCESS_ID")
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

    p = sub.add_parser("geoid", help="interpolate geoid model")
    p.add_argument("network_name", nargs="?", default="")
    p.add_argument("-g", "--grid", required=True)
    p.add_argument("--convert-stn-hts", action="store_true")
    p.add_argument("-m", "--interpolation-method", default="bicubic",
                   choices=["bilinear", "bicubic", "0", "1"],
                   help="0/bilinear or 1/bicubic (default)")
    p.add_argument("--export-dna-geo-file", "--export-dna-geo",
                   dest="export_dna_geo_file", action="store_true",
                   help="write a DNA .geo file of interpolated N values "
                        "and deflections")
    p.add_argument("--export-ntv2-gsb-file", default="",
                   help="re-export the grid as NTv2 binary (.gsb)")
    p.add_argument("--summary", "-u", action="store_true",
                   help="print a summary of the grid file")
    p.add_argument("--interactive", "-e", action="store_true",
                   help="interpolate at --latitude/--longitude and print")
    p.add_argument("--latitude", default="",
                   help="interpolant latitude (dd.mmssss, or decimal "
                        "degrees with --decimal-degrees)")
    p.add_argument("--longitude", default="",
                   help="interpolant longitude")
    p.add_argument("--decimal-degrees", action="store_true",
                   help="interactive coordinates are decimal degrees")
    p.add_argument("--dat-uncertainty-file", default="",
                   help="WINTER DAT uncertainty file for grid creation")
    p.add_argument("--grid-shift-type", default="SECONDS",
                   help="NTv2 units: seconds or radians")
    p.add_argument("--grid-version", default="1.0.0.0")
    p.add_argument("--system-from", default="GDA94")
    p.add_argument("--semi-major-from", type=float, default=6378137.0,
                   help="'from' ellipsoid semi-major for grid creation")
    p.add_argument("--semi-minor-from", type=float, default=6356752.314)
    p.add_argument("--semi-major-to", type=float, default=6378137.0)
    p.add_argument("--semi-minor-to", type=float, default=6356752.314)
    p.add_argument("--system-to", default="AHD_1971")
    p.add_argument("--sub-grid-name", default="AUSGEOID")
    p.add_argument("--creation-date", default="",
                   help="grid creation date (dd.mm.yyyy)")
    p.add_argument("--update-date", default="",
                   help="grid update date (dd.mm.yyyy)")
    p.add_argument("--create-ntv2", default="",
                   help="create an NTv2 .gsb from an AUSGeoid DAT file "
                        "(grid argument becomes the output path)")
    p.add_argument("-c", dest="create_ntv2_flag", action="store_true",
                   help="create NTv2 grid from the -d/--dat-file "
                        "(reference CREATE_NTV2_C)")
    p.add_argument("-d", "--dat-file", default="",
                   help="standard DAT file for -c grid creation")
    p.add_argument("-r", "--direction", type=int, default=0,
                   choices=[0, 1],
                   help="height conversion direction: 0 orthometric->"
                        "ellipsoid (default), 1 ellipsoid->orthometric")
    p.add_argument("--export-ascii-grid", default="",
                   help="export the grid to NTv2 ASCII at this path")
    p.add_argument("--export-ntv2-asc-file", "--export-ntv2-asc",
                   dest="export_ntv2_asc_flag", action="store_true",
                   help="export the grid to NTv2 ASCII next to it (.asc)")
    p.add_argument("--export-ntv2-gsb", dest="export_ntv2_gsb_flag",
                   action="store_true",
                   help="export the grid to NTv2 binary next to it (.gsb)")
    p.add_argument("-t", "--text-file", "--point-file",
                   dest="point_file", default="",
                   help="interpolate a DAT/CSV point file instead of a "
                        "network")
    _add_common(p)
    p.set_defaults(func=_cmd_geoid)

    p = sub.add_parser("reftran", help="transform reference frame")
    p.add_argument("network_name", nargs="?", default="")
    p.add_argument("-r", "--reference-frame", default="")
    p.add_argument("-e", "--epoch", default="")
    p.add_argument("-b", "--plate-boundary-file", default="",
                   help="tectonic plate boundaries (.dig) for the plate "
                        "motion model")
    p.add_argument("--plate-model-option", type=int, default=0,
                   help="0: single (Australian) plate (default); "
                        "1: interpolate from global plate boundaries "
                        "(-b/-m files)")
    p.add_argument("--override-input-ref-frame", action="store_true",
                   help="replace the input files' reference frame label "
                        "with -r without transforming")
    p.add_argument("-m", "--plate-pole-file", default="",
                   help="Euler pole parameters (.dat) for the plate "
                        "motion model")
    p.add_argument("--export-dna", "--export-dna-files",
                   dest="export_dna", action="store_true",
                   help="export the transformed network as DNA .stn/.msr")
    p.add_argument("--export-xml", "--export-xml-files",
                   dest="export_xml", action="store_true",
                   help="export the transformed network as DynaML "
                        "stn/msr files")
    p.add_argument("--single-xml-file", action="store_true",
                   help="with --export-xml: one combined DynaML file")
    _add_common(p)
    p.set_defaults(func=_cmd_reftran)


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

    p = sub.add_parser("dynadjust", help="run the full pipeline")
    p.add_argument("-n", "--network-name", default="")
    p.add_argument("files", nargs="*")
    # program switches (dynadjust.cpp:288-427; stage order import →
    # reftran → geoid → segment → adjust)
    p.add_argument("--import", dest="run_import", action="store_true",
                   help="run the import stage")
    p.add_argument("--reftran", dest="run_reftran", action="store_true",
                   help="run the reference frame transformation stage")
    p.add_argument("--geoid", dest="run_geoid", action="store_true",
                   help="run the geoid interpolation stage")
    p.add_argument("--segment", dest="run_segment", action="store_true",
                   help="run the segmentation stage")
    p.add_argument("--adjust", dest="run_adjust", action="store_true",
                   help="run the adjustment stage")
    p.add_argument("-p", "--project-file", default="",
                   help=".dnaproj project file supplying all settings "
                        "(CDnaProjectFile layout)")
    p.add_argument("--dynadjust-log-file", default="",
                   help="pipeline log path (default: "
                        "<output-folder>/dynadjust.log)")
    p.add_argument("--export-project", default="",
                   help="write the effective settings to a .dnaproj file")
    p.add_argument("-r", "--reference-frame", default="")
    p.add_argument("-e", "--epoch", default="")
    p.add_argument("-g", "--grid", default="")
    p.add_argument("--convert-stn-hts", action="store_true")
    p.add_argument("--interpolation-method", default="bicubic",
                   choices=["bilinear", "bicubic"])
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
    _add_adjust_args(p)
    _add_common(p, project_opt=False)
    p.set_defaults(func=_cmd_dynadjust)

    p = sub.add_parser("plot", help="plot network map / segmentation graph")
    p.add_argument("network_name", nargs="?", default="")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--segmentation-graph", "--graph-stn-blocks",
                   "--graph-msr-blocks", dest="segmentation_graph",
                   action="store_true",
                   help="per-block station/measurement graph")
    p.add_argument("--phased", action="store_true",
                   help="accepted for parity (block colouring is automatic "
                        "when a segmentation exists)")
    p.add_argument("--error-ellipses", action="store_true",
                   help="draw station error ellipses (requires a prior "
                        "adjustment)")
    p.add_argument("--positional-uncertainty", action="store_true",
                   help="draw 95%% positional uncertainty circles")
    p.add_argument("--correction-arrows", action="store_true",
                   help="draw correction arrows (initial -> adjusted)")
    p.add_argument("--compute-corrections", action="store_true",
                   help="accepted for parity; corrections are always "
                        "computed from the saved adjustment")
    p.add_argument("--scale-arrows", type=float, default=1.0,
                   help="correction arrow magnification")
    p.add_argument("--scale-ellipse-circles", type=float, default=1.0,
                   help="error ellipse / PU circle magnification")
    p.add_argument("--plot-msr-types", default="",
                   help="only plot these measurement type codes, e.g. GXY")
    p.add_argument("--omit-measurements", action="store_true")
    p.add_argument("--plot-ignored-msrs", action="store_true")
    p.add_argument("--msr-line-width", type=float, default=0.4)
    p.add_argument("--label-stations", action="store_true")
    p.add_argument("--label-constraints", action="store_true")
    p.add_argument("--label-corrections", action="store_true")
    p.add_argument("--label-font-size", type=float, default=6.0)
    p.add_argument("--block-number", type=int, default=0,
                   help="plot only this segmentation block (1-based)")
    p.add_argument("--phased-block-view", action="store_true",
                   help="write one map per segmentation block "
                        "(PLOT_BLOCKS, dnaplotwrapper.cpp:375)")
    p.add_argument("--omit-title-block", action="store_true")
    p.add_argument("--title", default="")
    p.add_argument("--org-unit-name", default="",
                   help="organisational unit in the title block "
                        "(TITLEBLOCK_NAME)")
    p.add_argument("--org-subunit-name", default="",
                   help="organisational sub-unit in the title block "
                        "(TITLEBLOCK_SUBNAME)")
    p.add_argument("--plate-boundary-file", default="",
                   help="tectonic plate boundaries (.dig) to overlay "
                        "(TECTONIC_PLATE_BDY_FILE)")
    p.add_argument("--alternate-name", action="store_true",
                   help="plot station descriptions as labels "
                        "(PLOT_ALT_NAME, dnaplot.cpp:2495)")
    p.add_argument("--centre-latitude", type=float, default=-999.0,
                   help="centre the plot on this latitude (dd.mmsssss)")
    p.add_argument("--centre-longitude", type=float, default=-999.0,
                   help="centre the plot on this longitude (ddd.mmsssss)")
    p.add_argument("--centre-station", default="",
                   help="centre the plot on this station")
    p.add_argument("--area-radius", type=float, default=5000.0,
                   help="window radius in metres around the centre "
                        "(default 5000, dnaoptions.hpp:617)")
    p.add_argument("--bounding-box", default="",
                   help="lat1,lon1,lat2,lon2 (dd.mmss) upper-left and "
                        "lower-right plot limits")
    p.add_argument("--map-projection", type=int, default=0,
                   help="map projection id (reference GMT projections; "
                        "matplotlib maps use a cos-latitude-scaled "
                        "equirectangular view)")
    p.add_argument("--export-png", action="store_true",
                   help="write PNG instead of PDF")
    p.add_argument("--supress-pdf-creation", action="store_true",
                   help="skip the map output (graph data only)")
    _add_common(p)

    def _plot_centre(a, net):
        """(lat_deg, lon_deg) window centre from --centre-station or
        --centre-latitude/--centre-longitude (dd.mmsssss packed DMS)."""
        import numpy as _np
        from .geodesy.conversions import dms_to_rad
        if a.centre_station:
            i = net.name_to_idx.get(a.centre_station)
            if i is None:
                raise SystemExit(f"- Error: centre station "
                                 f"'{a.centre_station}' is not in the "
                                 f"network")
            return (float(_np.degrees(net.lat[i])),
                    float(_np.degrees(net.lon[i])))
        if a.centre_latitude > -999.0 and a.centre_longitude > -999.0:
            return (float(_np.degrees(dms_to_rad(a.centre_latitude))),
                    float(_np.degrees(dms_to_rad(a.centre_longitude))))
        return None

    def _plot_bbox(s):
        """lat1,lon1,lat2,lon2 (dd.mmss) -> degrees tuple."""
        if not s:
            return None
        import numpy as _np
        from .geodesy.conversions import dms_to_rad
        parts = [float(v) for v in s.split(",")]
        if len(parts) != 4:
            raise SystemExit("- Error: bounding box must be "
                             "lat1,lon1,lat2,lon2")
        lat1, lon1, lat2, lon2 = (
            float(_np.degrees(dms_to_rad(v))) for v in parts)
        # upper-left then lower-right: lat1 must be north of lat2 and
        # lon1 west of lon2 (plot-box-ew / plot-box-ns CI tests)
        if lat1 <= lat2:
            raise SystemExit("- Error: bounding box latitudes must run "
                             "north to south (upper-left, lower-right)")
        if lon1 >= lon2:
            raise SystemExit("- Error: bounding box longitudes must run "
                             "west to east (upper-left, lower-right)")
        return (lat1, lon1, lat2, lon2)

    def _copy_net_with_adjusted(net, res):
        import copy
        out = copy.copy(net)
        out.lat = res.lat.copy()
        out.lon = res.lon.copy()
        out.height = res.height.copy()
        return out

    def _cmd_plot(a):
        import pickle
        from . import project
        net = project.load_network(getattr(a, 'input_folder', '') or
                                   a.output_folder, a.network_name)
        base = os.path.join(a.output_folder, a.network_name)
        in_base = os.path.join(getattr(a, "input_folder", "") or
                               a.output_folder, a.network_name)
        seg = None
        seg_file = f"{base}.seg.pkl"
        if not os.path.exists(seg_file):
            seg_file = f"{in_base}.seg.pkl"
        if os.path.exists(seg_file):
            from .segment import Segmentation
            seg = Segmentation.load(seg_file)
        from .output.plot import plot_network, plot_segmentation_graph
        ext = "png" if a.export_png else "pdf"
        if (a.phased or a.phased_block_view or a.block_number or
                a.segmentation_graph) and seg is None:
            print(f"- Error: no segmentation found for {a.network_name}; "
                  f"run segment first", file=sys.stderr)
            return 1
        if a.segmentation_graph and seg is not None:
            out = a.output or f"{base}.seg.{ext}"
            plot_segmentation_graph(out, seg)
            print(f"+ Wrote {out}")
            return 0
        if a.supress_pdf_creation:
            print("+ Map output suppressed (--supress-pdf-creation)")
            return 0
        res = None
        initial = None
        res_file = f"{base}.results.pkl"
        _needs_res = (a.error_ellipses or a.positional_uncertainty or
                      a.correction_arrows or a.label_corrections)
        if _needs_res and not os.path.exists(res_file) and \
                not os.path.exists(f"{in_base}.results.pkl"):
            print(f"- Error: no adjustment results found for "
                  f"{a.network_name}; run adjust first", file=sys.stderr)
            return 1
        if not os.path.exists(res_file):
            res_file = f"{in_base}.results.pkl"
        if os.path.exists(res_file):
            with open(res_file, "rb") as f:
                res = pickle.load(f)
            if a.correction_arrows or a.label_corrections:
                if getattr(res, "initial_xyz", None) is not None:
                    from .geodesy.conversions import cart_to_geo as _c2g
                    la0, lo0, _h0 = _c2g(res.initial_xyz[:, 0],
                                         res.initial_xyz[:, 1],
                                         res.initial_xyz[:, 2],
                                         net.datum.ellipsoid)
                    initial = (la0, lo0)
                else:
                    initial = (net.lat, net.lon)
                net = _copy_net_with_adjusted(net, res)
        if a.phased_block_view and seg is not None:
            outs = []
            for b in range(seg.block_count):
                out_b = f"{base}.block{b + 1}.{ext}"
                plot_network(
                    out_b, net, res=res, seg=seg,
                    show_ellipses=a.error_ellipses and res is not None,
                    msr_types=a.plot_msr_types,
                    omit_measurements=a.omit_measurements,
                    msr_line_width=a.msr_line_width,
                    label_stations=a.label_stations,
                    label_font_size=a.label_font_size,
                    block_number=b + 1,
                    omit_title_block=a.omit_title_block,
                    title=f"{a.title or a.network_name} block {b + 1}",
                    alternate_name=a.alternate_name)
                outs.append(out_b)
            print(f"+ Wrote {len(outs)} block maps "
                  f"({outs[0]} .. {outs[-1]})")
            if ext == "pdf":
                # aggregate per-block pages into one document (the
                # reference pdfunites its GMT block plots,
                # dnaplot.hpp:111 CreateGMTPlot aggregation)
                from .output.plot import aggregate_pdfs
                combined = f"{base}.blocks.pdf"
                aggregate_pdfs(combined, net, seg, res=res,
                               title=a.title or a.network_name)
                print(f"+ Wrote {combined}")
            return 0
        plates = None
        if a.plate_boundary_file:
            if not os.path.exists(a.plate_boundary_file):
                print(f"- Error: plate boundary file "
                      f"'{a.plate_boundary_file}' does not exist",
                      file=sys.stderr)
                return 1
            from .reftran.plates import read_plate_boundaries
            plates = read_plate_boundaries(a.plate_boundary_file)
        out = a.output or f"{base}.{ext}"
        plot_network(
            out, net, res=res, seg=seg,
            show_ellipses=a.error_ellipses and res is not None,
            show_pu=a.positional_uncertainty and res is not None,
            show_corrections=a.correction_arrows and initial is not None,
            initial_coords=initial,
            msr_types=a.plot_msr_types,
            omit_measurements=a.omit_measurements,
            plot_ignored=a.plot_ignored_msrs,
            msr_line_width=a.msr_line_width,
            label_stations=a.label_stations,
            label_constraints=a.label_constraints,
            label_corrections=a.label_corrections,
            label_font_size=a.label_font_size,
            block_number=a.block_number,
            omit_title_block=a.omit_title_block,
            title=a.title or None,
            ellipse_magnify=a.scale_ellipse_circles,
            arrow_magnify=a.scale_arrows,
            alternate_name=a.alternate_name,
            centre=_plot_centre(a, net),
            area_radius_m=a.area_radius,
            bounding_box=_plot_bbox(a.bounding_box),
            org_unit=a.org_unit_name, org_subunit=a.org_subunit_name,
            plate_boundaries=plates)
        print(f"+ Wrote {out}")
        return 0
    p.set_defaults(func=_cmd_plot)

    p = sub.add_parser("metadata",
                       help="dump network store metadata (binary-file "
                            "metadata utility analogue)")
    p.add_argument("network_name")
    p.add_argument("--output-folder", default=".")

    def _cmd_metadata(a):
        from . import project
        from collections import Counter
        from .io_formats.dna import GpsCluster, DirectionSet
        if a.network_name.endswith((".bst", ".bms")):
            # reference binary file: dump its binary_file_meta_t header
            # (the metadata utility's role, SURVEY §2.1)
            from .io_formats.binary import read_bst, read_bms
            reader = read_bst if a.network_name.endswith(".bst") else \
                read_bms
            _, meta = reader(a.network_name)
            PAD = 35
            print(f"{'File:':<{PAD}}{a.network_name}")
            for k in ("bin_count", "reduced", "modified_by", "epsg",
                      "epoch", "observation_epoch", "reftran", "geoid"):
                print(f"{k + ':':<{PAD}}{meta[k]}")
            for (fn, ep, e1, e2, ft, dt) in meta["input_files"]:
                print(f"{'input file:':<{PAD}}{fn} (epsg {ep}, "
                      f"epoch {e1}, type {ft}/{dt})")
            for fn in meta["source_files"]:
                print(f"{'source file:':<{PAD}}{fn}")
            return 0
        net = project.load_network(getattr(a, 'input_folder', '') or
                                   a.output_folder, a.network_name)
        PAD = 35
        print(f"{'Network name:':<{PAD}}{a.network_name}")
        print(f"{'Reference frame:':<{PAD}}{net.frame}")
        print(f"{'Epoch:':<{PAD}}{net.epoch}")
        print(f"{'Stations:':<{PAD}}{net.nstations}")
        print(f"{'Measurement records:':<{PAD}}{len(net.measurements)}")
        tally = Counter()
        rows = 0
        for rec in net.measurements:
            t = getattr(rec, "mtype", "?")
            if isinstance(rec, GpsCluster):
                tally[t] += len(rec.obs)
                rows += 3 * len(rec.obs)
            elif isinstance(rec, DirectionSet):
                tally["D"] += len(rec.directions) + 1
                rows += max(len(rec.directions), 0)
            else:
                tally[t] += 1
                rows += 1
        print(f"{'Measurement rows:':<{PAD}}{rows}")
        print(f"{'Tally:':<{PAD}}" + "  ".join(
            f"{t}:{n}" for t, n in sorted(tally.items())))
        print(f"{'Geoid applied:':<{PAD}}"
              f"{'Yes' if net.geoid_applied else 'No'}")
        print(f"{'Reftran applied:':<{PAD}}"
              f"{'Yes' if net.reftran_applied else 'No'}")
        consts = Counter(net.constraints)
        print(f"{'Constraints:':<{PAD}}" + "  ".join(
            f"{c}:{n}" for c, n in sorted(consts.items())))
        return 0
    p.set_defaults(func=_cmd_metadata)

    p = sub.add_parser("diff", help="tolerance-aware numeric file diff")
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("-t", "--tolerance", type=float, default=0.0)
    p.add_argument("--skip-headers", type=int, default=0)
    p.add_argument("--skip-to-marker", default="")
    p.add_argument("-v", "--verbose", action="store_true")

    def _cmd_diff(a):
        from .diff import main as diff_main
        argv2 = [a.file1, a.file2, "-t", str(a.tolerance),
                 "--skip-headers", str(a.skip_headers)]
        if a.skip_to_marker:
            argv2 += ["--skip-to-marker", a.skip_to_marker]
        if a.verbose:
            argv2.append("-v")
        return diff_main(argv2)
    p.set_defaults(func=_cmd_diff)

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
    if _refuse_missing_card(args) or _refuse_devices(args):
        return 1
    if hasattr(args, "network_name") and not args.network_name and \
            args.command in ("reftran", "segment", "adjust", "plot"):
        print("error: network name required (positional or via "
              "-p project file)", file=sys.stderr)
        return 1
    if _mesh_route(args) and os.environ.get("DTA_COORDINATOR"):
        return _run_as_rank(args)
    if getattr(args, "quiet", False):
        import contextlib
        import io as _io
        with contextlib.redirect_stdout(_io.StringIO()):
            return args.func(args)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
