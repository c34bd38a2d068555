"""compare_images — per-component MSE/PEAK comparison tool.

Parity: tests/compare_images (SURVEY.md §4 family 3): the reference's
conformance harness decodes a stream and compares against a baseline
image under per-component mean-squared-error and peak-absolute-error
tolerances.  Exit code 0 = within tolerance, 1 = mismatch.

Usage:
  python -m grok_tpu_torch.cli.compare_images -b base.png -t test.png \
      [-m MSE[,MSE...]] [-p PEAK[,PEAK...]]

Without tolerances the comparison is bit-exact.  PGX/RAW inputs are
supported through the same readers as the codec CLIs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import formats


def _load(path: str):
    img = formats.load_image(path)
    return [c.data.astype(np.int64) for c in img.comps]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_images")
    p.add_argument("-b", "--base", required=True)
    p.add_argument("-t", "--test", required=True)
    p.add_argument("-m", "--mse", default=None,
                   help="per-component MSE tolerances, comma-separated "
                        "(one value applies to all)")
    p.add_argument("-p", "--peak", default=None,
                   help="per-component peak-absolute-error tolerances")
    args = p.parse_args(argv)

    base = _load(args.base)
    test = _load(args.test)
    if len(base) != len(test):
        print(f"component count differs: {len(base)} vs {len(test)}")
        return 1
    n = len(base)

    def tol(spec, default):
        if spec is None:
            return [default] * n
        vals = [float(x) for x in spec.split(",")]
        if len(vals) == 1:
            return vals * n
        if len(vals) != n:
            print(f"tolerance count {len(vals)} != component count {n}")
            sys.exit(1)
        return vals

    mse_tol = tol(args.mse, 0.0)
    peak_tol = tol(args.peak, 0.0)
    rc = 0
    for i, (b, t) in enumerate(zip(base, test)):
        if b.shape != t.shape:
            print(f"comp {i}: shape differs {b.shape} vs {t.shape}")
            rc = 1
            continue
        d = b - t
        mse = float((d.astype(np.float64) ** 2).mean()) if d.size else 0.0
        peak = int(np.abs(d).max()) if d.size else 0
        ok = mse <= mse_tol[i] + 1e-12 and peak <= peak_tol[i]
        print(f"comp {i}: MSE {mse:.6g} (tol {mse_tol[i]:g})  "
              f"PEAK {peak} (tol {peak_tol[i]:g})  "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
