"""compare_dump_files — diff two grk_dump outputs.

Parity: tests/compare_dump_files (SURVEY.md §4 family 3): the
reference's dump-diff tests compare `grk_dump` text output against a
stored baseline.  Exit code 0 = identical (modulo trailing whitespace),
1 = differing lines (printed unified-diff style).
"""

from __future__ import annotations

import argparse
import difflib
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_dump_files")
    p.add_argument("-b", "--base", required=True)
    p.add_argument("-t", "--test", required=True)
    args = p.parse_args(argv)
    with open(args.base) as f:
        base = [ln.rstrip() for ln in f]
    with open(args.test) as f:
        test = [ln.rstrip() for ln in f]
    if base == test:
        return 0
    for line in difflib.unified_diff(base, test, fromfile=args.base,
                                     tofile=args.test, lineterm=""):
        print(line)
    return 1


if __name__ == "__main__":
    sys.exit(main())
