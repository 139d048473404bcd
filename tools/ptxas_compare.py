"""Every kernel's ptxas lines in this checkout's build against another's.

Builds the kernel library of this checkout and of the checkout at PARENT
(each in a process of its own, from its root, so each builds its own
sources), and with ``--instances`` also every first-use instance of
PARENT's ``chip_smoke.phase_shapes`` and ``phase_user_target`` (by
instance name, each checkout building its own row of that name, all at
once), reads each build's ``-Xptxas -v`` report (the ``.log`` beside the
library) and prints, per kernel, registers, stack frame and spill stores
and loads in both, and whether each of PARENT's kernels compiles to the
same lines here. A kernel is named as ``c++filt`` names it, the TARGETS
argument this checkout's chain kernels take last dropped and a hidden-width
list ``aspire::Hidden<64, 64>`` written as its widths, so the two
checkouts' names match. From the repository root, on the machine with the
card's toolkit:

    python3 tools/ptxas_compare.py PARENT [--instances]
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
from aspire_tpu_torch.ops import _build
out = {"library": str(_build.build().with_suffix(".log")), "instances": {}}
if sys.argv[1] != "-":
    import torch
    import chip_smoke
    names = json.loads(sys.argv[1])
    rows = {k: (kind, row, None) for k, (kind, _, row)
            in chip_smoke.shapes_instances().items()}
    rows.update({k: (kind, row, src) for k, (kind, _, row, src)
                 in chip_smoke.user_instances(torch.device("cpu")).items()})
    with ThreadPoolExecutor(len(names) or 1) as pool:
        paths = pool.map(lambda k: _build.build_instance(*rows[k]), names)
        out["instances"] = {k: str(p.with_suffix(".log"))
                            for k, p in zip(names, paths)}
print(json.dumps(out))
"""
NAMES = """
import json, torch
import chip_smoke
print(json.dumps([*chip_smoke.shapes_instances(),
                  *chip_smoke.user_instances(torch.device("cpu"))]))
"""


def demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        return name
    return out or name


def kernel_name(fn: str) -> str:
    """The kernel's name with the TARGETS argument of this checkout's chain
    kernels dropped and hidden widths written as the parent wrote them."""
    name = re.sub(r"aspire::Hidden<([^<>]*)>", r"\1", demangle(fn))
    name = re.sub(r"(chain_kernel(?:_wide|_streamed)?<[^>]*?), [01]>",
                  r"\1>", name)
    return name.split("(")[0]


def parse(log: Path) -> dict:
    """Registers, stack frame and spills of every kernel in a ptxas
    report."""
    lines, fn = {}, None
    for line in log.read_text().splitlines():
        m = (re.search(r"Compiling entry function '(\w+)'", line)
             or re.search(r"Function properties for (\w+)", line))
        if m:
            fn = m.group(1)
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m and fn:
                lines.setdefault(fn, {})[key] = int(m.group(1))
    return {kernel_name(fn): v for fn, v in lines.items()}


def report(root: Path, names) -> dict:
    """The ptxas lines of every kernel the checkout at root builds: the
    library's, then each named instance's (``instance: kernel``)."""
    arg = "-" if names is None else json.dumps(names)
    text = subprocess.run([sys.executable, "-c", BUILD, arg], cwd=root,
                          check=True, capture_output=True,
                          text=True).stdout.splitlines()[-1]
    logs = json.loads(text)
    out = parse(Path(root, logs["library"]))
    for name, log in logs["instances"].items():
        out.update({f"{name}: {k}": v
                    for k, v in parse(Path(root, log)).items()})
    return out


def main() -> None:
    parent = Path(sys.argv[1]).resolve()
    names = None
    if "--instances" in sys.argv[2:]:
        names = json.loads(subprocess.run(
            [sys.executable, "-c", NAMES], cwd=parent, check=True,
            capture_output=True, text=True).stdout.splitlines()[-1])
    tables = {"change": report(ROOT, names), "parent": report(parent, names)}
    same = {k: tables["change"].get(k) == v
            for k, v in tables["parent"].items()}
    print(json.dumps({"ptxas": tables, "same_as_parent": same,
                      "all_parent_kernels_same": all(same.values())}))


if __name__ == "__main__":
    main()
