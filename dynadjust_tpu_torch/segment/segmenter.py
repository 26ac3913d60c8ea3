"""Network segmentation into blocks of inner/junction stations.

Greedy frontier expansion: starting from a seed station, the block grows by
repeatedly converting the junction station with the fewest associated
measurements into an inner station and pulling in its measurements, until
the block size threshold is met.  Junction stations (the frontier) connect
consecutive blocks; measurement records are atomic (a cluster's
measurements land in exactly one block).

Algorithm parity: dnasegment.cpp SegmentNetwork :290-307,
BuildFirstBlock :376, BuildNextBlock :528 (thresholds :595-599),
SelectInner :460, SelectJunction :485, FinaliseBlock :612,
GetInnerMeasurements :702, AddtoCurrentMsrList :761,
FindCommonMeasurements :~840, MoveJunctiontoISL.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

from ..io_formats.dna import Measurement, GpsCluster, DirectionSet
from ..network.data import NetworkData


def record_stations(rec, net: NetworkData) -> list:
    """All (deduplicated) global station indices touched by a record."""
    idx = net.station_index
    out = []
    if isinstance(rec, GpsCluster):
        for ob in rec.obs:
            out.append(idx(ob.first))
            if ob.second:
                out.append(idx(ob.second))
    elif isinstance(rec, DirectionSet):
        out.append(idx(rec.first))
        out.append(idx(rec.ro))
        for (target, _, _, ign) in rec.directions:
            out.append(idx(target))
    elif isinstance(rec, Measurement):
        out.append(idx(rec.first))
        if rec.second:
            out.append(idx(rec.second))
        if rec.third:
            out.append(idx(rec.third))
    seen = set()
    ded = []
    for s in out:
        if s not in seen:
            seen.add(s)
            ded.append(s)
    return ded


@dataclass
class Segmentation:
    """Per-block station/measurement partition (the .seg analogue)."""
    inner_stations: list = field(default_factory=list)      # [block][stn idx]
    junction_stations: list = field(default_factory=list)
    measurements: list = field(default_factory=list)        # [block][rec idx]
    networks: list = field(default_factory=list)            # contiguous net id

    @property
    def block_count(self) -> int:
        return len(self.inner_stations)

    def parameter_stations(self, b: int) -> list:
        """Sorted union of inner + junction stations (the block's unknowns,
        ordered like the reference's parameterStationList)."""
        return sorted(set(self.inner_stations[b]) |
                      set(self.junction_stations[b]))

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "Segmentation":
        with open(path, "rb") as f:
            return pickle.load(f)


def segment_network(net: NetworkData, min_inner_stns: int = 150,
                    max_block_stns: int = 150,
                    starting_stns: str = "",
                    force_contiguous: bool = False,
                    search_level: int = 0) -> Segmentation:
    """force_contiguous: connect isolated sub-networks into one block
    chain by seeding each gap with the geographically nearest free
    station (--contiguous-blocks 1; SEG_FORCE_CONTIGUOUS).
    search_level: accepted for reference CLI parity — station selection
    here always searches globally for the lowest measurement count, which
    is the reference's deepest search level."""
    n = net.nstations
    # station -> list of record indices
    assoc = [[] for _ in range(n)]
    usable = []
    for ri, rec in enumerate(net.measurements):
        if getattr(rec, "ignore", False):
            continue
        stns = record_stations(rec, net)
        if not stns:
            continue
        usable.append(ri)
        for s in stns:
            assoc[s].append(ri)

    msr_count = [len(a) for a in assoc]
    avail_count = list(msr_count)
    msr_used = [False] * len(net.measurements)
    stn_free = [c > 0 for c in msr_count]

    free = [s for s in range(n) if stn_free[s]]
    free.sort(key=lambda s: (msr_count[s], s))

    seg = Segmentation()
    current_network = 0

    def consume_record(ri, cml):
        if msr_used[ri]:
            return
        msr_used[ri] = True
        cml.append(ri)
        for s in record_stations(net.measurements[ri], net):
            avail_count[s] -= 1

    def take_station(s, lst):
        stn_free[s] = False
        free.remove(s)
        lst.append(s)

    def get_inner_measurements(s, inner, junction, cml):
        """Pull all unused records touching s into the block; connected free
        stations become junctions."""
        for ri in assoc[s]:
            if msr_used[ri]:
                continue
            stns = record_stations(net.measurements[ri], net)
            consume_record(ri, cml)
            for t in stns:
                if stn_free[t] and t not in junction:
                    take_station(t, junction)

    def finalise(inner, junction, cml):
        # measurements fully within the junction set also belong here
        jset = set(junction)
        for s in sorted(jset):
            for ri in assoc[s]:
                if msr_used[ri]:
                    continue
                stns = record_stations(net.measurements[ri], net)
                if all(t in jset or t in inner or len(stns) == 1
                       for t in stns):
                    consume_record(ri, cml)
        # junctions with no remaining measurements become inners
        still = []
        for s in junction:
            if avail_count[s] == 0:
                inner.append(s)
            else:
                still.append(s)
        junction[:] = still
        seg.inner_stations.append(sorted(inner))
        seg.junction_stations.append(sorted(still))
        seg.measurements.append(sorted(set(cml)))
        seg.networks.append(current_network)

    # ----- first block -----------------------------------------------------
    # seed stations + their measurements only — the reference's
    # BuildFirstBlock (dnasegment.cpp:376) does not grow the first block
    # to the size thresholds
    inner, junction, cml = [], [], []
    seeds = [s.strip() for s in starting_stns.split(",") if s.strip()]
    if seeds:
        seed_idx = [net.station_index(s) for s in seeds]
    else:
        seed_idx = [free[0]] if free else []
    for s in seed_idx:
        if stn_free[s]:
            take_station(s, inner)
            get_inner_measurements(s, inner, junction, cml)
    finalise(inner, junction, cml)

    # ----- subsequent blocks ----------------------------------------------
    while free:
        # previous block's junctions become candidates for this block
        junction = list(seg.junction_stations[-1])
        inner, cml = [], []

        if not junction:
            if force_contiguous and seg.inner_stations:
                # bridge the gap: nearest free station to the previous
                # block keeps the chain contiguous (same network id)
                import numpy as _np
                prev = seg.inner_stations[-1] + seg.junction_stations[-1]
                pl = _np.array([[net.lat[g], net.lon[g]] for g in prev])
                best, bestd = None, None
                for t in free:
                    d = float(_np.min((pl[:, 0] - net.lat[t]) ** 2 +
                                      (pl[:, 1] - net.lon[t]) ** 2))
                    if bestd is None or d < bestd:
                        best, bestd = t, d
                s = best
            else:
                # non-contiguous network: new sub-network from free list
                current_network += 1
                free.sort(key=lambda s: (avail_count[s], s))
                s = free[0]
            take_station(s, junction)

        while True:
            if not free:
                break
            if not junction:
                break
            # select the junction with fewest associated measurements
            junction.sort(key=lambda s: (msr_count[s], s))
            s = junction.pop(0)
            inner.append(s)
            get_inner_measurements(s, inner, junction, cml)
            total = len(inner) + len(junction)
            if total >= max_block_stns:
                if len(inner) < min_inner_stns:
                    continue
                break
        finalise(inner, junction, cml)
        if not free:
            break

    return seg


def write_seg_file(path: str, net: NetworkData, seg: Segmentation,
                   min_inner_stns: int, max_block_stns: int,
                   starting_stns: str = "", cmdline: str = ""):
    """Text .seg report (WriteSegFile, include/io/seg_file.cpp:590):
    header, per-block summary table, and the ISL/JSL/CML name lists."""
    PAD = 35
    L = ["-" * 80, "DYNADJUST-TPU SEGMENTATION OUTPUT FILE", "-" * 80, ""]
    L.append(f"{'File name:':<{PAD}}{path}")
    L.append("")
    L.append(f"{'Command line arguments:':<{PAD}}{cmdline}")
    L.append("")
    L.append(f"{'Minimum inner stations':<{PAD}}{min_inner_stns}")
    L.append(f"{'Block size threshold':<{PAD}}{max_block_stns}")
    if starting_stns:
        L.append(f"{'Starting station(s)':<{PAD}}{starting_stns}")
    L.append("-" * 80)
    L.append("")
    L.append("SEGMENTATION SUMMARY")
    L.append("")
    L.append(f"{'No. blocks produced':<{PAD}}{seg.block_count}")
    hdr = (f"{'  Block':<10}{'Network ID':<12}{'Junction stns':<15}"
           f"{'Inner stns':<12}{'Measurements':<14}{'Total stns':<12}")
    L.append("-" * len(hdr))
    L.append(hdr)
    for b in range(seg.block_count):
        ni = len(seg.inner_stations[b])
        nj = len(seg.junction_stations[b])
        L.append(f"  {b + 1:<8}{seg.networks[b]:<12}{nj:<15}{ni:<12}"
                 f"{len(seg.measurements[b]):<14}{ni + nj:<12}")
    L.append("")
    for b in range(seg.block_count):
        L.append(f"Block {b + 1}")
        L.append("-" * 80)
        L.append(f"{'Junction stations':<{PAD}}"
                 f"{len(seg.junction_stations[b])}")
        for g in seg.junction_stations[b]:
            L.append(f"  {net.names[g]}")
        L.append(f"{'Inner stations':<{PAD}}{len(seg.inner_stations[b])}")
        for g in seg.inner_stations[b]:
            L.append(f"  {net.names[g]}")
        L.append(f"{'Measurements':<{PAD}}{len(seg.measurements[b])}")
        L.append("")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def verify_station_connections(net: NetworkData, seg: Segmentation) -> list:
    """Every parameter station of every block must be connected to at
    least one of the block's measurements (VerifyStationConnections,
    dnasegment.cpp:1426).  Returns problem strings."""
    problems = []
    for b in range(seg.block_count):
        touched = set()
        for ri in seg.measurements[b]:
            touched.update(record_stations(net.measurements[ri], net))
        for g in seg.inner_stations[b]:
            if g not in touched:
                problems.append(f"block {b + 1}: inner station "
                                f"{net.names[g]} has no measurements")
    return problems


def write_sap_file(path: str, net: NetworkData, seg: Segmentation):
    """Station appearance list: per station, the first block (forward
    order) and last block (reverse order) in which it appears — the
    text analogue of the reference's .sap (CreateStnAppearanceList /
    WriteStnAppearance, include/io/seg_file.hpp:66/85)."""
    first_fwd = {}
    first_rev = {}
    for b in range(seg.block_count):
        for g in (list(seg.inner_stations[b]) +
                  list(seg.junction_stations[b])):
            first_fwd.setdefault(g, b)
            first_rev[g] = b
    L = [f"{'Station':<20}{'First appearance (fwd)':>24}"
         f"{'First appearance (rev)':>24}"]
    L.append("-" * 68)
    for g in sorted(first_fwd, key=lambda i: net.names[i]):
        L.append(f"{net.names[g]:<20}{first_fwd[g] + 1:>24}"
                 f"{first_rev[g] + 1:>24}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")


def read_seg_block_names(path: str, block_no: int):
    """Station names (junction + inner) of one block from a text .seg
    file (the reverse of write_seg_file's block listings; lets
    `import --seg-file x.seg --import-block N` consume the text format
    the reference's tools exchange)."""
    names = []
    in_block = False
    mode = None
    for line in open(path, errors="replace"):
        s = line.rstrip("\n")
        if s.startswith(f"Block {block_no}") and not s.startswith(
                f"Block {block_no}0"):
            in_block = True
            continue
        if not in_block:
            continue
        if s.startswith("Junction stations"):
            mode = "j"
            continue
        if s.startswith("Inner stations"):
            mode = "i"
            continue
        if s.startswith("Measurements") or s.startswith("Block "):
            break
        if mode and s.startswith("  ") and s.strip() and \
                not s.startswith("---"):
            names.append(s.strip())
    return names
