"""Every kernel's ptxas lines in this checkout's build against another's.

Builds the kernel library of this checkout and of the checkout at PARENT
(each in a process of its own, from its root, so each builds its own
sources), reads each build's ``-Xptxas -v`` report (the ``.log`` beside
the library) and prints, per kernel, registers, stack frame and spill
stores and loads in both, and whether each of PARENT's kernels compiles to
the same lines here. A kernel is named as ``c++filt`` names it, the
TARGETS argument this checkout's chain kernels take last dropped, so the
two checkouts' names match. From the repository root, on the machine with
the card's toolkit:

    python3 tools/ptxas_compare.py PARENT
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ("from aspire_tpu_torch.ops import _build; "
         "print(_build.build().with_suffix('.log'))")


def demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        return name
    return out or name


def report(root: Path) -> dict:
    """The ptxas lines of every kernel the checkout at root builds."""
    log = subprocess.run([sys.executable, "-c", BUILD], cwd=root, check=True,
                         capture_output=True, text=True).stdout.split()[-1]
    lines, fn = {}, None
    for line in Path(root, log).read_text().splitlines():
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
    named = {}
    for fn, v in lines.items():
        name = re.sub(r"(chain_kernel(?:_wide)?<[^>]*?), [01]>", r"\1>",
                      demangle(fn))
        named[name.split("(")[0]] = v
    return named


def main() -> None:
    tables = {"change": report(ROOT),
              "parent": report(Path(sys.argv[1]).resolve())}
    same = {k: tables["change"].get(k) == v
            for k, v in tables["parent"].items()}
    print(json.dumps({"ptxas": tables, "same_as_parent": same,
                      "all_parent_kernels_same": all(same.values())}))


if __name__ == "__main__":
    main()
