"""Tolerance-aware numeric diff of adjustment output files — the dnadiff
equivalent used for regression testing.

Parity reference: dnadiff/dnadiff.hpp:39-64 (CompareFiles with
--skip-headers N / --skip-to-marker M and numeric tolerance -t)."""

from __future__ import annotations

import re
import sys

_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def compare_files(path1: str, path2: str, tolerance: float = 0.0,
                  skip_headers: int = 0, skip_to_marker: str = "",
                  verbose: bool = False):
    """Compare two text files numerically.  Non-numeric tokens must match
    exactly; numeric tokens must agree within `tolerance`.

    Returns (equal, differences) where differences is a list of
    (line_no, text1, text2)."""
    l1 = open(path1, errors="replace").read().splitlines()
    l2 = open(path2, errors="replace").read().splitlines()

    def start_of(lines):
        if skip_to_marker:
            for i, ln in enumerate(lines):
                if skip_to_marker in ln:
                    return i
            return len(lines)
        return skip_headers

    s1, s2 = start_of(l1), start_of(l2)
    l1, l2 = l1[s1:], l2[s2:]
    diffs = []
    for i in range(max(len(l1), len(l2))):
        a = l1[i] if i < len(l1) else ""
        b = l2[i] if i < len(l2) else ""
        if a == b:
            continue
        if not _lines_equal(a, b, tolerance):
            diffs.append((i + 1, a, b))
    return not diffs, diffs


def _lines_equal(a: str, b: str, tol: float) -> bool:
    na = _NUM.findall(a)
    nb = _NUM.findall(b)
    if len(na) != len(nb):
        return False
    for x, y in zip(na, nb):
        try:
            if abs(float(x) - float(y)) > tol:
                return False
        except ValueError:
            if x != y:
                return False
    # non-numeric remainder must match
    ra = _NUM.sub("#", a).split()
    rb = _NUM.sub("#", b).split()
    return ra == rb


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="dnadiff",
                                description="tolerance-aware numeric diff")
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("-t", "--tolerance", type=float, default=0.0)
    p.add_argument("--skip-headers", type=int, default=0)
    p.add_argument("--skip-to-marker", default="")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    equal, diffs = compare_files(args.file1, args.file2, args.tolerance,
                                 args.skip_headers, args.skip_to_marker)
    if equal:
        print(f"Files match (tolerance {args.tolerance})")
        return 0
    print(f"{len(diffs)} differing lines (tolerance {args.tolerance})")
    for n, a, b in diffs[:20 if not args.verbose else None]:
        print(f"  line {n}:")
        print(f"  < {a}")
        print(f"  > {b}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
