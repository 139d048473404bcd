"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources in ``aspire_tpu_torch/csrc`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
cached under ``aspire_tpu_torch/_build`` by a hash of the sources and
flags: one ``nvcc -c`` per source, all started together, then one link.
A flow shape outside the library's tables gets an instance of its own at
its first use: ``csrc/coupling.cu``, ``chain.cu`` or ``maf.cu`` compiled
for that one configuration row (:func:`build_instance`, cached beside the
library by a hash of the source, the flags and the row); so does a user's
target (``models/targets.py`` ``KernelSource``), in ``chain.cu`` with the
source in it (:func:`build_user`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]

_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32


def find_nvcc() -> str:
    for candidate in (
        os.environ.get("CUDA_HOME") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libaspire_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists.

    Every ``.cu`` file compiles in its own ``nvcc -c``, all at once, into a
    private directory; one ``nvcc -shared`` links the objects. The
    compiler's resource report (``-Xptxas -v``: registers, shared memory
    and spills of every kernel) is kept beside the library.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp, f"{src.stem}.o")) for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)], text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(srcs, objs)]
        steps = [(src.name, proc.communicate()[0], proc.returncode)
                 for src, proc in zip(srcs, procs)]
        lib = Path(tmp, out.name)
        if not any(rc for *_, rc in steps):
            link = subprocess.run([nvcc, "-shared", "-o", str(lib), *objs],
                                  capture_output=True, text=True)
            steps.append(("link", link.stdout + link.stderr, link.returncode))
        out.with_suffix(".log").write_text(
            "".join(f"== {name}\n{text}" for name, text, _ in steps))
        failed = [f"{name} ({rc}):\n{text[-4000:]}"
                  for name, text, rc in steps if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.aspire_max_shared_bytes.argtypes = []
    lib.aspire_max_shared_bytes.restype = _I
    lib.aspire_coupling_layout.argtypes = [_I, _P, _I]
    lib.aspire_coupling_layout.restype = _I
    lib.aspire_coupling.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P]
    lib.aspire_coupling.restype = _I
    lib.aspire_chain_tile.argtypes = []
    lib.aspire_chain_tile.restype = _I
    lib.aspire_consts_layout.argtypes = [_I, _P, _I]
    lib.aspire_consts_layout.restype = _I
    lib.aspire_chain.argtypes = (
        [_P] * 12 + [_I] * 9 + [_P] + [_F] * 5 + [_P, _I, _P]
    )
    lib.aspire_chain.restype = _I
    lib.aspire_chain_layout.argtypes = [_I, _P, _I]
    lib.aspire_chain_layout.restype = _I
    lib.aspire_chain_plan.argtypes = [_I, _P, _I]
    lib.aspire_chain_plan.restype = _I
    lib.aspire_maf_layer_floats.argtypes = [_I]
    lib.aspire_maf_layer_floats.restype = _I
    lib.aspire_maf_stage_floats.argtypes = [_I]
    lib.aspire_maf_stage_floats.restype = _I
    lib.aspire_maf_ksteps.argtypes = [_I, _P, _I]
    lib.aspire_maf_ksteps.restype = _I
    lib.aspire_maf.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _P]
    lib.aspire_maf.restype = _I
    lib.aspire_staged_config.argtypes = [_I, _P]
    lib.aspire_staged_config.restype = _I
    lib.aspire_staged.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _P]
    lib.aspire_staged.restype = _I
    lib.aspire_prng_uniforms.argtypes = [_P, ctypes.c_longlong, _U, _U, _P]
    lib.aspire_prng_uniforms.restype = _I
    _lib = lib
    return lib


def _row_value(v: str):
    """One value of a configuration row as ``csrc/common.cuh`` writes it:
    ``true``/``false``, an int, or hidden widths in parentheses (a
    tuple)."""
    v = v.strip()
    if v.startswith("("):
        return tuple(int(h) for h in v[1:-1].split(",") if h.strip())
    return v == "true" if v in ("true", "false") else int(v)


def config_rows(macro: str) -> list[tuple]:
    """The rows ``X(...)`` of ``macro`` in ``csrc/common.cuh``, each
    value read by :func:`_row_value` (the id first)."""
    text = (CSRC / "common.cuh").read_text()
    table = re.search(rf"#define {macro}\(X\)(.*?)(?:\n\n|\Z)", text,
                      re.S).group(1)
    return [tuple(_row_value(v) for v in re.findall(r"\s*(\([^()]*\)|[^,]+)",
                                                    row))
            for row in re.findall(r"X\(((?:[^()]|\([^()]*\))*)\)", table)]


def chain_config_row(config: int) -> tuple:
    """Chain configuration ``config``'s row of ``ASPIRE_CHAIN_CONFIGS`` in
    ``csrc/common.cuh``, its values after the id: ``(D, (H...), K, RQS,
    TARGETS)``."""
    for cid, *values in config_rows("ASPIRE_CHAIN_CONFIGS"):
        if cid == config:
            return tuple(values)
    raise ValueError(f"no chain configuration {config}")


#: the source each kind of instance compiles; a ``_streamed`` kind
#: defines ``ASPIRE_STREAMED``: the form that streams a flow's layers, for
#: a flow too deep for them to stay resident
INSTANCE_SOURCES = {"coupling": "coupling.cu", "chain": "chain.cu",
                    "chain_streamed": "chain.cu", "maf": "maf.cu",
                    "maf_streamed": "maf.cu"}
#: instances loaded in this process, by (kind, row, user source), and a
#: lock per instance, so threads asking for one build it once while
#: another instance builds beside it
_instances: dict[tuple, ctypes.CDLL] = {}
_instance_locks: dict[tuple, threading.Lock] = {}
_locks_lock = threading.Lock()


def _row_text(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, tuple):
        return "(" + ", ".join(str(int(h)) for h in v) + ")"
    return str(int(v))


def instance_row(row: tuple) -> str:
    """A configuration row as its source reads it: ``X(0, ...)``, id 0,
    the hidden widths in parentheses (``(64, 64)``, ``(128,)`` as
    ``(128)``, none as ``()``)."""
    return "X(0, " + ", ".join(_row_text(v) for v in row) + ")"


def instance_path(kind: str, row: tuple, user=None) -> Path:
    """Where :func:`build_instance` puts the instance of ``kind``
    (``INSTANCE_SOURCES``) for configuration ``row`` (its values after the
    id), with the user target ``user`` (a ``KernelSource``, the chain
    only): keyed by a hash of the kind's source and the headers, the
    flags, the row and the user source."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / INSTANCE_SOURCES[kind], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(instance_row(row).encode())
    if user is not None:
        digest.update(user.cuda.encode())
        name = "user_" + re.sub(r"\W", "_", user.name)[:32]
    else:
        name = f"{kind}_" + "_".join(
            "h" + "x".join(map(str, v)) if isinstance(v, tuple)
            else str(int(v)) for v in row)
    return BUILD_DIR / f"libaspire_{name}_{digest.hexdigest()[:16]}.so"


def build_instance(kind: str, row: tuple, user=None) -> Path:
    """Compile ``csrc/<kind's source>`` for the one configuration ``row``
    (with the user target ``user`` for the chain), unless that instance
    exists: one ``nvcc`` of a generated file that defines
    ``ASPIRE_INSTANCE_CONFIG`` (the row, id 0; and ``ASPIRE_USER_TARGET``,
    the user source's path), then includes the source. Written to a
    temporary file and moved into place, so processes building the same
    instance at once leave one whole library. The ptxas report is kept
    beside the library. Raises ``RuntimeError`` with nvcc's message when it
    fails."""
    out = instance_path(kind, row, user)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lines = []
        if user is not None:
            target = Path(tmp, "user_target.cuh")
            target.write_text(user.cuda)
            lines.append(f"#define ASPIRE_USER_TARGET \"{target}\"")
        if kind.endswith("_streamed"):
            lines.append("#define ASPIRE_STREAMED 1")
        lines += [f"#define ASPIRE_INSTANCE_CONFIG(X) {instance_row(row)}",
                  f"#include \"{CSRC / INSTANCE_SOURCES[kind]}\"", ""]
        unit = Path(tmp, f"instance_{kind}.cu")
        unit.write_text("\n".join(lines))
        lib = Path(tmp, out.name)
        run = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                              str(unit)], capture_output=True, text=True)
        text = run.stdout + run.stderr
        what = user.name if user is not None else instance_row(row)
        log = Path(tmp, "log")
        log.write_text(f"== {kind} {what}\n{text}")
        os.replace(log, out.with_suffix(".log"))
        if run.returncode:
            raise RuntimeError(f"nvcc failed on the {kind} instance {what!r} "
                               f"({run.returncode}):\n{text[-4000:]}")
        os.replace(lib, out)
    return out


def _bind_instance(kind: str, lib: ctypes.CDLL, user) -> None:
    """Set the argument and result types of an instance's C entries."""
    kind = kind.split("_")[0]
    if kind == "coupling":
        lib.aspire_coupling_layout.argtypes = [_I, _P, _I]
        lib.aspire_coupling_layout.restype = _I
        lib.aspire_coupling.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _I,
                                        _P]
        lib.aspire_coupling.restype = _I
    elif kind == "maf":
        for fn in (lib.aspire_maf_layer_floats, lib.aspire_maf_stage_floats):
            fn.argtypes, fn.restype = [_I], _I
        lib.aspire_maf_ksteps.argtypes = [_I, _P, _I]
        lib.aspire_maf_ksteps.restype = _I
        lib.aspire_maf.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _P]
        lib.aspire_maf.restype = _I
    else:
        lib.aspire_chain_tile.argtypes = []
        lib.aspire_chain_tile.restype = _I
        lib.aspire_consts_layout.argtypes = [_I, _P, _I]
        lib.aspire_consts_layout.restype = _I
        lib.aspire_chain_layout.argtypes = [_I, _P, _I]
        lib.aspire_chain_layout.restype = _I
        lib.aspire_chain_plan.argtypes = [_I, _P, _I]
        lib.aspire_chain_plan.restype = _I
        chain = [_P] * 12 + [_I] * 9 + [_P] + [_F] * 5 + [_P, _I, _P]
        if user is None:
            lib.aspire_chain.argtypes = chain
            lib.aspire_chain.restype = _I
        else:
            lib.aspire_chain_user.argtypes = chain + [_P]
            lib.aspire_chain_user.restype = _I
            lib.aspire_user_target.argtypes = [_P, _I, _I, _P, _P, _P, _P]
            lib.aspire_user_target.restype = _I


def load_instance(kind: str, row: tuple, user=None) -> ctypes.CDLL:
    """The instance of ``kind`` for configuration ``row`` (and the user
    target ``user``), built at its first use (:func:`build_instance`) and
    loaded once per process: threads asking for it at once build it once,
    and later calls hash no source. Its configuration id is 0."""
    key = (kind, tuple(row), user)
    lib = _instances.get(key)
    if lib is None:
        with _locks_lock:
            lock = _instance_locks.setdefault(key, threading.Lock())
        with lock:
            lib = _instances.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(build_instance(kind, row, user)))
                _bind_instance(kind, lib, user)
                _instances[key] = lib
    return lib


def user_library_path(source, row, kind: str = "chain") -> Path:
    """Where the chain instance (``kind``: ``"chain"``, or
    ``"chain_streamed"`` for a flow too deep to stay resident) of the user
    target ``source`` (a ``KernelSource``) for configuration ``row`` (its
    values, or a prebuilt chain configuration's id) is built
    (:func:`instance_path`)."""
    return instance_path(kind, _chain_row(row), source)


def build_user(source, row, kind: str = "chain") -> Path:
    """:func:`build_instance` of the chain with the user target ``source``
    at ``row`` (its values, or a prebuilt chain configuration's id): that
    instance compiles the user's target alone (id ``kUser``)."""
    return build_instance(kind, _chain_row(row), source)


def load_user_library(source, row, kind: str = "chain") -> ctypes.CDLL:
    """The chain instance of the user target ``source`` for ``row`` (its
    values, or a prebuilt chain configuration's id), built on first use
    (:func:`build_user`) and loaded once per process."""
    return load_instance(kind, _chain_row(row), source)


def _chain_row(row) -> tuple:
    """A user instance's row: ``row`` (or a prebuilt configuration's), its
    TARGETS column 1 as ``fused_mutation.chain_row`` gives it (the
    instance compiles the user's target alone, whatever the column)."""
    row = chain_config_row(row) if isinstance(row, int) else tuple(row)
    return (*row[:4], 1)


def check(code: int, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: configuration not compiled into the "
                         "kernel library")
    if code == -3:
        raise ValueError(f"{what}: target not compiled into this "
                         "configuration")
    if code == -4:
        raise ValueError(f"{what}: the flow's layers do not fit one block "
                         "and this library has no streamed form")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


class LaunchCounter:
    """A plain count of kernel launches, bumped by a wrapper right where
    it launches its kernel."""

    #: every counter made, in order: a CUDA graph counts the launches it
    #: captured (:func:`launch_counts` before and after the capture) and
    #: adds them on each replay (:func:`add_launches`), so a count stays
    #: the launches on the card
    made: list = []

    def __init__(self) -> None:
        self.count = 0
        LaunchCounter.made.append(self)

    def reset(self) -> None:
        self.count = 0


def launch_counts() -> tuple[int, ...]:
    """Every counter's count, in the order of ``LaunchCounter.made``."""
    return tuple(c.count for c in LaunchCounter.made)


def add_launches(counts) -> None:
    """Add ``counts`` (one per counter, as :func:`launch_counts`)."""
    for counter, k in zip(LaunchCounter.made, counts):
        counter.count += k
