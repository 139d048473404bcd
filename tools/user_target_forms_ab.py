"""B2 on a user's target with three forms of one source, in turns.

``chip_smoke.PolynomialRegression``'s CUDA source as written
(``REGRESSION_CUDA``: a division by sigma per data point), with the
division made a product by its reciprocal, formed once, and with that and
the 128-point loop unrolled by 4. Each form is built into its own instance
of the chain kernel (configuration 0), and B2 runs on the regression's
chain (``chip_smoke.regression_chain_setup``, n = 131072, 20 steps) in
turns with B2 on the built-in mixture (mixture, the forms, the forms
reversed, mixture): events (``chip_smoke.cuda_ms``), then the kernel alone
(``chip_smoke.kernel_ms``), the evaluation entry's time, each form's
ptxas line and its outputs against the source as written. From the
repository root, on the machine with the card:

    python3 tools/user_target_forms_ab.py
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aspire_tpu_torch.models import KernelSource  # noqa: E402
from aspire_tpu_torch.ops import _build  # noqa: E402
from aspire_tpu_torch.ops import fused_mutation as FM  # noqa: E402


def forms() -> dict:
    """The source as written and its two rewrites."""
    src = cs.REGRESSION_CUDA
    recip = src.replace(
        "  float q = 0.f;\n  for (int j",
        "  const float inv_sigma = 1.f / sigma;\n  float q = 0.f;\n  for (int j",
    ).replace("(c[M + j] - m) / sigma;", "(c[M + j] - m) * inv_sigma;")
    unroll = recip.replace("  for (int j = 0; j < M; ++j) {",
                           "#pragma unroll 4\n  for (int j = 0; j < M; ++j) {")
    if recip.count("inv_sigma") != 2 or unroll == recip:
        raise ValueError("REGRESSION_CUDA no longer has the expected form")
    return {"as_written": src, "reciprocal": recip,
            "reciprocal_unroll4": unroll}


def main() -> None:
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    _build.load_library()
    sources = {k: KernelSource("regression_" + k, v)
               for k, v in forms().items()}
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(lambda s: _build.build_user(s, 0), sources.values()))
    out = {}
    for k, s in sources.items():
        log = _build.user_library_path(s, 0).with_suffix(".log").read_text()
        out[k] = {"ms": [], "ptxas": [line.strip() for line in log.splitlines()
                                      if "spill" in line
                                      or "registers" in line][:2]}
    out = {"mixture": {"ms": []}, **out}
    cfg, params, z0, beta, step0, refs, target, dt, _, _ = (
        cs.regression_chain_setup(dev, cs.N_PIPELINE, cs.CHAIN_STEPS))
    mix = cs.chain_setup(dev, cs.N_PIPELINE, cs.CHAIN_STEPS)
    targets = {k: (FM.UserTarget(s, target[0].plain), target[1])
               for k, s in sources.items()}

    def call(k):
        if k == "mixture":
            c, p, z, b, s0, r, tg, d, _ = mix
            return lambda: FM.fused_mh_chain(c, p, z, b, (1, 2), s0, *r, tg,
                                             data_transform=d)
        return lambda: FM.fused_mh_chain(cfg, params, z0, beta, (1, 2),
                                         step0, *refs, targets[k],
                                         data_transform=dt)

    for k in ["mixture", *sources, *list(sources)[::-1], "mixture"]:
        out[k]["ms"].append(cs.cuda_ms(call(k)))
    ref = call("as_written")()
    for k in sources:
        o = call(k)()
        out[k]["max_abs_diff_vs_as_written"] = max(
            cs.max_err(a, b) for a, b in zip(o[:4], ref[:4]))
        out[k]["accepts_equal"] = bool(torch.equal(o[4], ref[4]))
        out[k]["eval_ms"] = cs.cuda_ms(lambda k=k: FM.user_target_eval(
            targets[k][0], targets[k][1], 0, z0))
    # The profiler last: after it has traced the card, launches cost the
    # host more.
    for k in out:
        out[k]["kernel_ms"] = cs.kernel_ms(call(k), "chain_kernel", reps=5)
    print(json.dumps({"user_target_forms": out}), flush=True)


if __name__ == "__main__":
    main()
