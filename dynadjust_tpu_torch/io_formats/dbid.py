"""Measurement database-id (.dbid) file read/write.

Byte-compatible with the reference's serialisation
(dna_import::SerialiseDatabaseId / LoadDatabaseId,
DynAdjust dynadjust/dynadjust/dnaimport/dnainterop.cpp:5117,3976):

    UINT32 record_count
    record_count x { UINT32 msr_id; UINT32 cluster_id;
                     UINT16 is_msr_id_set; UINT16 is_cls_id_set }

One record per BINARY measurement row (m_dbidRecordCount ==
m_binaryRecordCount), with the same expansion the per-type
SerialiseDatabaseMap methods use (dnameasurement.cpp:264,493):

  * scalar measurement      -> 1 record
  * direction set           -> 1 (RO row) + 1 per direction (its own id)
  * GPS baseline/point      -> 3 records (X/Y/Z rows) + 3 per covariance
                               block, all carrying the obs's id

so .dbid rows align index-for-index with .bms measurement_t rows.
"""

from __future__ import annotations

import struct

import numpy as np

_REC = struct.Struct("<IIHH")


def _entry(msr_id, cluster_id):
    return (int(msr_id or 0), int(cluster_id or 0),
            1 if msr_id is not None else 0,
            1 if cluster_id is not None else 0)


def dbid_entries(net) -> list:
    """Per-binary-row (msr_id, cluster_id, is_msr_set, is_cls_set)
    tuples for the network's measurements, in .bms row order
    (mirrors binary.measurement_rows)."""
    from .dna import GpsCluster, Measurement, DirectionSet
    out = []
    for rec in net.measurements:
        if isinstance(rec, GpsCluster):
            cid = rec.db_cluster_id
            for ob in rec.obs:
                e = _entry(ob.msr_id, cid)
                out.extend([e] * 3)                       # X, Y, Z rows
                out.extend([e] * (3 * len(ob.covs)))      # covariance rows
        elif isinstance(rec, DirectionSet):
            cid = rec.db_cluster_id
            out.append(_entry(rec.msr_id, cid))           # RO row
            ids = rec.direction_ids or [None] * len(rec.directions)
            for i in range(len(rec.directions)):
                out.append(_entry(ids[i], cid))
        elif isinstance(rec, Measurement):
            out.append(_entry(rec.msr_id, None))
    return out


def write_dbid(path: str, net) -> None:
    entries = dbid_entries(net)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(entries)))
        for e in entries:
            f.write(_REC.pack(*e))


def read_dbid(path: str) -> list:
    """Read a .dbid file -> list of (msr_id, cluster_id, is_msr_set,
    is_cls_set) tuples, one per binary measurement row."""
    with open(path, "rb") as f:
        (count,) = struct.unpack("<I", f.read(4))
        data = f.read(count * _REC.size)
    if len(data) < count * _REC.size:
        raise ValueError(f"{path}: truncated .dbid "
                         f"({len(data)} bytes for {count} records)")
    return [_REC.unpack_from(data, i * _REC.size) for i in range(count)]


def apply_dbid(net, entries) -> None:
    """Push .dbid entries back onto the network's measurement records
    (the read direction: adjust --output-database-ids after loading
    binary files, LoadDatabaseId parity).  Row alignment follows
    dbid_entries / binary.measurement_rows; a count mismatch raises."""
    from .dna import GpsCluster, Measurement, DirectionSet

    def get(i):
        m, c, ms, cs = entries[i]
        return (m if ms else None), (c if cs else None)

    i = 0
    for rec in net.measurements:
        if isinstance(rec, GpsCluster):
            for ob in rec.obs:
                ob.msr_id, cid = get(i)
                if cid is not None:
                    rec.db_cluster_id = cid
                i += 3 + 3 * len(ob.covs)
        elif isinstance(rec, DirectionSet):
            rec.msr_id, cid = get(i)
            if cid is not None:
                rec.db_cluster_id = cid
            i += 1
            ids = []
            for _ in rec.directions:
                ids.append(get(i)[0])
                i += 1
            rec.direction_ids = (ids if any(x is not None for x in ids)
                                 else None)
        elif isinstance(rec, Measurement):
            rec.msr_id = get(i)[0]
            i += 1
    if i != len(entries):
        raise ValueError(f".dbid has {len(entries)} records but the "
                         f"network expands to {i} binary rows")
