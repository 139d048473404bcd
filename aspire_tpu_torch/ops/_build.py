"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources in ``aspire_tpu_torch/csrc`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
cached under ``aspire_tpu_torch/_build`` by a hash of the sources and
flags: one ``nvcc -c`` per source, all started together, then one link.
A user's target (``models/targets.py`` ``KernelSource``) gets a library
of its own, ``csrc/chain.cu`` compiled for one chain configuration with
the source in it (:func:`build_user`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
#: user-target libraries loaded in this process, by (source, configuration)
_user_libs: dict[tuple, ctypes.CDLL] = {}
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


def chain_config_row(config: int) -> str:
    """Chain configuration ``config``'s row of ``ASPIRE_CHAIN_CONFIGS``
    in ``csrc/common.cuh``, as ``X(...)``."""
    text = (CSRC / "common.cuh").read_text()
    table = re.search(r"#define ASPIRE_CHAIN_CONFIGS\(X\)(.*?)(?:\n\n|\Z)",
                      text, re.S).group(1)
    for row in re.findall(r"X\(([^)]*)\)", table):
        if int(row.split(",")[0]) == config:
            return f"X({row.strip()})"
    raise ValueError(f"no chain configuration {config}")


def user_library_path(source, config: int) -> Path:
    """Where :func:`build_user` puts the instance of ``source`` (a
    ``KernelSource``) for chain configuration ``config``: keyed by a hash
    of the chain kernel's sources, the flags, the configuration and the
    user source."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / "chain.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(chain_config_row(config).encode())
    digest.update(source.cuda.encode())
    name = re.sub(r"\W", "_", source.name)[:32]
    return BUILD_DIR / f"libaspire_user_{name}_{digest.hexdigest()[:16]}.so"


def build_user(source, config: int) -> Path:
    """Compile ``csrc/chain.cu`` with the user target ``source`` (a
    ``KernelSource``) for chain configuration ``config`` alone, unless that
    instance exists: one ``nvcc`` of a generated file that defines
    ``ASPIRE_USER_TARGET`` (the source's path) and
    ``ASPIRE_USER_CHAIN_CONFIG`` (the configuration's row), then includes
    ``chain.cu``. The ptxas report is kept beside the library. Raises
    ``RuntimeError`` with nvcc's message when it fails."""
    out = user_library_path(source, config)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        target = Path(tmp, "user_target.cuh")
        target.write_text(source.cuda)
        unit = Path(tmp, "user_chain.cu")
        unit.write_text(
            f"#define ASPIRE_USER_TARGET \"{target}\"\n"
            f"#define ASPIRE_USER_CHAIN_CONFIG(X) "
            f"{chain_config_row(config)}\n"
            f"#include \"{CSRC / 'chain.cu'}\"\n")
        lib = Path(tmp, out.name)
        run = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                              str(unit)], capture_output=True, text=True)
        text = run.stdout + run.stderr
        out.with_suffix(".log").write_text(f"== {source.name}\n{text}")
        if run.returncode:
            raise RuntimeError(f"nvcc failed on the user target "
                               f"{source.name!r} ({run.returncode}):\n"
                               f"{text[-4000:]}")
        os.replace(lib, out)
    return out


def load_user_library(source, config: int) -> ctypes.CDLL:
    """The chain kernel instance of the user target ``source`` for chain
    configuration ``config``, built on first use (:func:`build_user`) and
    loaded once per process (later calls hash no source)."""
    lib = _user_libs.get((source, config))
    if lib is None:
        lib = ctypes.CDLL(str(build_user(source, config)))
        lib.aspire_chain_tile.argtypes = []
        lib.aspire_chain_tile.restype = _I
        lib.aspire_consts_layout.argtypes = [_I, _P, _I]
        lib.aspire_consts_layout.restype = _I
        lib.aspire_chain_layout.argtypes = [_I, _P, _I]
        lib.aspire_chain_layout.restype = _I
        lib.aspire_chain_user.argtypes = (
            [_P] * 12 + [_I] * 9 + [_P] + [_F] * 5 + [_P, _I, _P, _P])
        lib.aspire_chain_user.restype = _I
        lib.aspire_user_target.argtypes = [_P, _I, _I, _P, _P, _P, _P]
        lib.aspire_user_target.restype = _I
        _user_libs[source, config] = lib
    return lib


def check(code: int, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: configuration not compiled into the "
                         "kernel library")
    if code == -3:
        raise ValueError(f"{what}: target not compiled into this "
                         "configuration")
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
