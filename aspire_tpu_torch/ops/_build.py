"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources in ``aspire_tpu_torch/csrc`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
cached under ``aspire_tpu_torch/_build`` by a hash of the sources and
flags: one ``nvcc -c`` per source, all started together, then one link.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    lib.aspire_consts_floats.argtypes = [_I]
    lib.aspire_consts_floats.restype = _I
    lib.aspire_chain.argtypes = (
        [_P] * 12 + [_I] * 9 + [_P] + [_F] * 5 + [_P, _I, _P]
    )
    lib.aspire_chain.restype = _I
    lib.aspire_chain_layout.argtypes = [_I, _P, _I]
    lib.aspire_chain_layout.restype = _I
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


def check(code: int, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: configuration not compiled into the "
                         "kernel library")
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
