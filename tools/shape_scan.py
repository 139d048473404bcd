"""Count the flows the reference's kernels take and the port's do not.

Walks a grid of flows on the CPU and asks, for each, the port's mirror
of the JAX package's admission rule (``fused_coupling._reference_takes``:
d <= 32, affine or RQS with at most 32 bins, at most 8 MB of float32
conditioner weights; twice the weights for an RQS MAF) and the port's own
predicates: ``coupling_takes`` (B1/B3), ``fused_mutation.kernel_supports``
(B2) and ``maf_takes`` (B4). Prints, per kernel, how many flows the
reference takes, how many of them the port refuses, and up to ``--show``
of those refusals; the last line is the counts as one JSON object.

The grid: d 2-32; hidden layers of 1-3 equal widths from ``WIDTHS``;
RQS with the bins of ``BINS``, or affine (coupling flows only); 1-12
flow layers. ``--package-root DIR`` scans the ``aspire_tpu_torch`` of
another checkout (a parent's ``git archive``, say). Needs no JAX and no
card::

    python3 tools/shape_scan.py
    python3 tools/shape_scan.py --package-root ../parent --show 20
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

DIMS = range(2, 33)
WIDTHS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
DEPTHS = (1, 2, 3)
BINS = (4, 8, 12, 16, 20, 24, 28, 32)
LAYERS = range(1, 13)


def grid(dims=DIMS, widths=WIDTHS):
    """``(transformer, d, hidden, bins, layers)`` of every flow scanned
    (at ``dims`` and ``widths``, by default the whole grid's); bins None
    for an affine flow."""
    for d, width, depth, layers in itertools.product(dims, widths, DEPTHS,
                                                     LAYERS):
        hidden = (width,) * depth
        for bins in BINS:
            yield "rqs", d, hidden, bins, layers
        yield "affine", d, hidden, None, layers


def scan(show: int = 5, **where) -> dict:
    """The counts over :func:`grid` (``where``: its ``dims`` and
    ``widths``), and up to ``show`` refusals per kernel printed."""
    from aspire_tpu_torch.flows.architectures import MAF, Coupling
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    counts = {"coupling_flows": 0, "b1_b3_refused": 0, "b2_refused": 0,
              "rqs_mafs": 0, "b4_refused": 0}
    refused = {"b1_b3": [], "b2": [], "b4": []}
    for transformer, d, hidden, bins, layers in grid(**where):
        kw = dict(dims=d, n_layers=layers, n_hidden=hidden,
                  transformer=transformer, num_bins=bins or 8)
        arch = Coupling(**kw)
        if FC._reference_takes(arch):
            counts["coupling_flows"] += 1
            row = (transformer, d, hidden, bins, layers)
            if not FC.coupling_takes(arch):
                counts["b1_b3_refused"] += 1
                refused["b1_b3"].append(row)
            if not FM.kernel_supports(FM.ChainConfig(arch, "tpcn", 20)):
                counts["b2_refused"] += 1
                refused["b2"].append(row)
        if transformer != "rqs":
            continue
        maf = MAF(**kw)
        if (FC._reference_takes(maf)
                and 2 * FC.reference_weight_bytes(maf) <= FC.MAX_WEIGHT_BYTES):
            counts["rqs_mafs"] += 1
            if not FC.maf_takes(maf):
                counts["b4_refused"] += 1
                refused["b4"].append((d, hidden, bins, layers))
    for kernel, rows in refused.items():
        if show:
            print(f"{kernel} refuses {len(rows)}"
                  + (f", e.g. {rows[:show]}" if rows else ""))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", type=Path, default=None,
                    help="scan the aspire_tpu_torch of this checkout")
    ap.add_argument("--show", type=int, default=5,
                    help="refusals printed per kernel")
    args = ap.parse_args(argv)
    root = args.package_root or Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root.resolve()))
    counts = scan(args.show)
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
