"""Where a coupling instance's round trip misses the card rule, why.

``chip_smoke.coupling_outputs`` reads the round trip ``B3(z_p)`` (the
sampling kernel on the plain path's latents) against the input ``x``
itself. This probe repeats that check for a flow of ``phase_shapes`` and,
at every point beyond COUPLING_TOL, prints the errors against ``x`` of the
kernel's round trip, of the plain float32 path's own round trip and of the
float64 inverse of the same float32 latents (what no inverse of them can
beat), and the kernel's sampling error against that float64 inverse. From
the repository root, on the machine with the card:

    python3 tools/round_trip_probe.py "B1/B3 nsf-tpu (128,) d=4" [N]
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    name = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.N_COUPLING
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = chip_smoke.shapes_instances()[name][1]
    c = chip_smoke.coupling_outputs(
        torch.device("cuda"), (arch, 21, chip_smoke.SHAPES_SCALE), n, 1)
    x = c["x"].double()
    x_k, x_p, x_e = (t.double() for t in c["outputs"]["sampling x"])
    tol = (chip_smoke.COUPLING_TOL["atol"]
           + chip_smoke.COUPLING_TOL["rtol"] * x.abs())
    bad = (x_k - x).abs() > tol
    rows = [{"x": float(x[i, j]), "tol": float(tol[i, j]),
             "kernel_round_trip": float((x_k - x)[i, j]),
             "plain_round_trip": float((x_p - x)[i, j]),
             "float64_inverse_of_latent": float((x_e - x)[i, j]),
             "kernel_vs_float64_inverse": float((x_k - x_e)[i, j]),
             "plain_vs_float64_inverse": float((x_p - x_e)[i, j])}
            for i, j in bad.nonzero().tolist()]
    print(json.dumps({
        "flow": name, "n": n, "points_beyond_tol": len(rows),
        "plain_round_trip_max": float((x_p - x).abs().max()),
        "float64_inverse_round_trip_max": float((x_e - x).abs().max()),
        "kernel_round_trip_max": float((x_k - x).abs().max()),
        "points": rows[:20]}))


if __name__ == "__main__":
    main()
