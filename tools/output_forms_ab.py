"""The d = 5 output layer's two forms on the card, in turns.

nsf-tpu at d = 5 (the funnel's validation row) computes each coupling
layer's output one active dim at a time (``MmaShape::BY_DIM`` in
``aspire_tpu_torch/csrc/coupling_mma.cuh``), 88 accumulator floats a
thread. This script builds a second copy of the coupling and chain
sources with ``BY_DIM`` false, so the output layer goes all at once (136
floats), into ``aspire_tpu_torch/_build/forms_all_at_once/``, and holds
both libraries on one card: each form's ptxas lines of the d = 5 kernels,
B1/B3 of a perturbed nsf-tpu at d = 5 against plain (``chip_smoke``'s
card rule) and B2 on the funnel row's chain against the plain chain, then
their times by events in turns (by dims, all at once, all at once, by
dims, by dims, all at once) at n = 131072. Both forms share one packed
layout, so the wrappers drive either library. From the repository root,
on the machine with the card:

    python3 tools/output_forms_ab.py
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aspire_tpu_torch.flows.architectures import nsf_tpu  # noqa: E402
from aspire_tpu_torch.ops import _build  # noqa: E402
from aspire_tpu_torch.ops import fused_coupling as FC  # noqa: E402
from aspire_tpu_torch.ops import fused_mutation as FM  # noqa: E402

BY_DIM = "static constexpr bool BY_DIM = !WIDE && 8 * (KS2 + NT) > 128;"


def build_all_at_once() -> tuple[Path, str]:
    """coupling.cu and chain.cu with BY_DIM false, as one library; its
    path and nvcc's report, while the library itself builds beside it."""
    work = _build.BUILD_DIR / "forms_all_at_once"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    header = work / "csrc" / "coupling_mma.cuh"
    text = header.read_text()
    if BY_DIM not in text:
        raise RuntimeError("MmaShape::BY_DIM's rule is not where expected")
    header.write_text(text.replace(BY_DIM,
                                   "static constexpr bool BY_DIM = false;"))
    nvcc = _build.find_nvcc()
    procs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(work / f"{name}.o"),
         str(work / "csrc" / f"{name}.cu")], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name in ("coupling", "chain")]
    _build.build()
    report = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(report[-4000:])
    lib = work / "libforms.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), str(work / "coupling.o"),
                    str(work / "chain.o")], check=True)
    return lib, report


def ptxas_d5(report: str) -> dict:
    """Registers, stack and spills of the d = 5 coupling and chain
    kernels in an ``-Xptxas -v`` report, by mangled name."""
    out, fn = {}, None
    for line in report.splitlines():
        m = (re.search(r"Compiling entry function '(\w+)'", line)
             or re.search(r"Function properties for (\w+)", line))
        if m:
            fn = m.group(1)
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m and fn and re.search(r"(coupling|chain)_kernelILi5E", fn):
                out.setdefault(fn, {})[key] = int(m.group(1))
    return out


def bind(path: Path) -> ctypes.CDLL:
    """The coupling and chain entries of a library at path, typed as
    ``_build.load_library`` types them."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    for name, args in (
            ("aspire_max_shared_bytes", []),
            ("aspire_coupling_layout", [I, P, I]),
            ("aspire_coupling", [P, P, P, P, I, I, F, I, I, P]),
            ("aspire_chain_tile", []), ("aspire_consts_layout", [I, P, I]),
            ("aspire_chain", [P] * 12 + [I] * 9 + [P] + [F] * 5 + [P, I, P]),
            ("aspire_chain_layout", [I, P, I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    return lib


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    lib_path, report = build_all_at_once()
    libs = {"by_dim": _build.load_library(), "all_at_once": bind(lib_path)}
    ptxas = {"by_dim": ptxas_d5(_build.build().with_suffix(".log")
                                .read_text()),
             "all_at_once": ptxas_d5(report)}
    cs.log(f"builds {time.perf_counter() - t0:.1f} s")

    def use(form):
        _build._lib = libs[form]
        for cached in (FC._coupling_library_layout, FM._chain_library_layout,
                       FM._consts_library_layout):
            cached.cache_clear()

    dev = torch.device("cuda")
    flow = (nsf_tpu(5), 5, 0.1)
    c = cs.coupling_outputs(dev, flow, cs.N_COUPLING, 1)
    arch, params, x, z = c["arch"], c["params"], c["x"], c["z"]
    w = FC.prepare_mma_params(arch, params)
    cfg, cparams, z0, beta, step0, refs, target, dt, _, _ = (
        cs.validate_chain_setup(dev, cs.N_PIPELINE, cs.CHAIN_STEPS, "funnel"))
    out = {form: {"B1": [], "B3": [], "B2": []} for form in libs}
    for form in libs:
        use(form)
        for what, v in cs.coupling_outputs(dev, flow, cs.N_COUPLING,
                                           1)["outputs"].items():
            cs.assert_kernel_close(*v, f"{form} {what}")
        out[form]["chain_max_abs_err"] = cs.assert_program_chain(
            cs.validate_chain_setup(dev, cs.N_CHAIN, cs.CHAIN_STEPS,
                                    "funnel"), form)
    for form in ("by_dim", "all_at_once", "all_at_once", "by_dim", "by_dim",
                 "all_at_once"):
        use(form)
        o = out[form]
        o["B1"].append(cs.cuda_ms(lambda: FC.launch_packed(
            arch, "forward", w, x)))
        o["B3"].append(cs.cuda_ms(lambda: FC.launch_packed(
            arch, "inverse", w, z)))
        o["B2"].append(cs.cuda_ms(lambda: FM.fused_mh_chain(
            cfg, cparams, z0, beta, (1, 2), step0, *refs, target,
            data_transform=dt), 10))
    use("by_dim")
    print(json.dumps({"ptxas_d5": ptxas, "ms_events_in_turns": out}),
          flush=True)


if __name__ == "__main__":
    main()
