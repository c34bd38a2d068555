"""compare_raw_files — byte-level file comparison tool.

Parity: tests/compare_raw_files.cpp (SURVEY.md §4 family 3): the
reference's non-regression suite diffs raw/binary outputs byte for byte
(used for RAW/RAWL decode baselines and codestream regression checks).
Exit code 0 = identical, 1 = different (first difference reported).

Usage:
  python -m grok_tpu_torch.cli.compare_raw_files -b base.raw -t test.raw
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_raw_files")
    p.add_argument("-b", "--base", required=True)
    p.add_argument("-t", "--test", required=True)
    args = p.parse_args(argv)

    with open(args.base, "rb") as f:
        a = f.read()
    with open(args.test, "rb") as f:
        b = f.read()
    if len(a) != len(b):
        print(f"size mismatch: {len(a)} vs {len(b)} bytes")
        return 1
    if a == b:
        print(f"identical ({len(a)} bytes)")
        return 0
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            print(f"first difference at byte {i}: {x:#04x} vs {y:#04x}")
            return 1
    return 1  # pragma: no cover


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
