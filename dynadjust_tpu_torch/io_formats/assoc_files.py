"""Station/measurement association exports: .asl, .aml, .map text files.

Parity reference: AslFile::WriteText (include/io/asl_file.cpp), the AML
text dump (aml_file.cpp) and DnaIoMap station map exports — the debug
views of the binary association files the reference builds at import
(--export-asl-file / --export-aml-file / --export-map-file).
"""

from __future__ import annotations

from ..network.screening import stations_of_record

_STATION = 20
_HEADER20 = 20


def build_associations(net):
    """Per-station association data: {station index: [record indices]}."""
    assoc: dict[int, list] = {i: [] for i in range(net.nstations)}
    for m, rec in enumerate(net.measurements):
        if getattr(rec, "ignore", False):
            continue
        for name in stations_of_record(rec):
            i = net.name_to_idx.get(name)
            if i is not None:
                assoc[i].append(m)
    return assoc


def export_asl(path: str, net) -> int:
    """Station association list: measurement count, AML start index,
    unused flag; sorted by descending measurement count (WriteText
    ordering)."""
    assoc = build_associations(net)
    aml_index = {}
    cum = 0
    for i in range(net.nstations):
        aml_index[i] = cum
        cum += len(assoc[i])
    order = sorted(range(net.nstations),
                   key=lambda i: (-len(assoc[i]), net.names[i]))
    L = [f"{f'{net.nstations} stations':<{_STATION}}"
         f"{'No. connected msrs':>{_HEADER20}}"
         f"{'AML index':>{_STATION}}{'Unused?':>{_STATION}}"]
    for i in order:
        n = len(assoc[i])
        L.append(f"{net.names[i]:<{_STATION}}{n:>{_HEADER20}}"
                 f"{aml_index[i]:>{_STATION}}"
                 f"{('*' if n == 0 else ''):>{_STATION}}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
    return net.nstations


def export_aml(path: str, net) -> int:
    """Flattened associated measurement list: for each station (file
    order) the measurement record indices connected to it."""
    assoc = build_associations(net)
    L = [f"{'AML index':>12}{'Msr record':>12}  Station"]
    k = 0
    for i in range(net.nstations):
        for m in assoc[i]:
            L.append(f"{k:>12}{m:>12}  {net.names[i]}")
            k += 1
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
    return k


def export_map(path: str, net) -> int:
    """Station name → index map (name-sorted)."""
    L = [f"{f'{net.nstations} stations':<{_STATION}}{'Index':>12}"]
    for name in sorted(net.names):
        L.append(f"{name:<{_STATION}}{net.name_to_idx[name]:>12}")
    with open(path, "w") as f:
        f.write("\n".join(L) + "\n")
    return net.nstations
