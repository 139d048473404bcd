"""The coupling kernel's CUDA source (``csrc/coupling.cu``), run on the CPU.

As ``tests/test_torch_chain_emulated.py`` does for the chain kernel, and
with the same stand-in CUDA runtime (each CUDA thread a fiber on one OS
thread, barriers for ``__syncthreads``/``__syncwarp``, the warp's ``mma.sync``
m16n8k8 TF32 computed from its lanes' fragments, ``__shfl_sync``), the
unchanged source with the tensor-core pass it includes
(``csrc/coupling_mma.cuh``) is compiled as C++ at the configurations the
library compiles (8-bin splines and affine maps at d = 4, (64, 64)
hidden). Its ``cp.async`` weight copies land at the copying thread's
wait, their destination NaN until then (``PTX_STAND_INS``), so a weight
stream that reads a buffer before its wait, or overwrites one a warp
still reads, fails here as on the card. Checked, in both modes, at n = 512 and at a ragged
512 + 37, for the flows ``chip_smoke.phase_coupling`` checks on the card
(nsf-tpu(4), realnvp(4), and a 7-layer nsf(4) whose layers stream
through the two buffers more than once): the kernel against
``forward_plain``/``inverse_plain`` at the card check's tolerance
(``chip_smoke.COUPLING_TOL``, float64 arbitration) and against
``coupling_packed_plain``; and the kernel's layout table against the
Python packing. Skips where no ``g++`` with C++20 ``<barrier>`` is
installed.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import nsf_tpu, realnvp
from aspire_tpu_torch.ops import fused_coupling as FC
from test_torch_chain_emulated import CHAIN_RUNTIME
from test_torch_maf_emulated import (
    CSRC,
    RUNTIME,
    cxx20_compiler,
    emulated_source,
)

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include "coupling_emulated.cpp"
namespace aspire { float4 coupling_smem4[232448 / 16]; }
// Configuration CFG of ASPIRE_COUPLING_CONFIGS, one block after another.
template <int CFG, bool DENSITY>
void launch(const float* x, float* z, float* ld, const float* w, int n,
            int layers, int blocks) {
  for (int b = 0; b < blocks; ++b) {
    emu_run_block(b, blockDim.x, [&] {
      if constexpr (CFG == 0) {
        aspire::coupling_kernel<4, aspire::Hidden<64, 64>, 8, true, DENSITY>(
            x, z, ld, w, n, layers, 5.0f);
      } else if constexpr (CFG == 1) {
        aspire::coupling_kernel<4, aspire::Hidden<64, 64>, 1, false, DENSITY>(
            x, z, ld, w, n, layers, 5.0f);
      } else if constexpr (CFG == 2) {
        aspire::coupling_kernel_wide<32, aspire::Hidden<128, 128>, 8, true,
                                     DENSITY>(
            x, z, ld, w, n, layers, 5.0f);
      } else if constexpr (CFG == 3) {
        aspire::coupling_kernel<2, aspire::Hidden<64, 64>, 8, true, DENSITY>(
            x, z, ld, w, n, layers, 5.0f);
      } else {
        aspire::coupling_kernel<5, aspire::Hidden<64, 64>, 8, true, DENSITY>(
            x, z, ld, w, n, layers, 5.0f);
      }
    });
  }
}
int main(int argc, char** argv) {
  if (argc == 2) {  // the layout table of each configuration
    for (int cfg = 0; cfg < 5; ++cfg) {
      int v[16];
      const int count = aspire_coupling_layout(cfg, v, 16);
      for (int e = 0; e < count; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), cfg = atoi(argv[3]);
  const int density = atoi(argv[4]), warps = atoi(argv[5]);
  const int dims[] = {4, 4, 32, 2, 5};
  const int floats = atoi(argv[6]), d = dims[cfg];
  std::vector<float> x(d * n), w(floats), z(d * n, -1.f), ld(n, -1.f);
  FILE* f = fopen(argv[7], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size()) return 2;
  if (fread(w.data(), 4, w.size(), f) != w.size()) return 3;
  fclose(f);
  blockDim = {(unsigned)(32 * warps), 1, 1};
  const int blocks = (n + 32 * warps - 1) / (32 * warps);
  gridDim = {(unsigned)blocks, 1, 1};
  using L = void (*)(const float*, float*, float*, const float*, int, int,
                     int);
  const L runs[5][2] = {{launch<0, false>, launch<0, true>},
                        {launch<1, false>, launch<1, true>},
                        {launch<2, false>, launch<2, true>},
                        {launch<3, false>, launch<3, true>},
                        {launch<4, false>, launch<4, true>}};
  runs[cfg][density](x.data(), z.data(), ld.data(), w.data(), n, layers,
                     blocks);
  f = fopen(argv[8], "wb");
  fwrite(z.data(), 4, z.size(), f);
  fwrite(ld.data(), 4, ld.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = tmp_path_factory.mktemp("coupling_emulated")
    gxx = cxx20_compiler(root)
    (root / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME)
    shutil.copy(CSRC / "common.cuh", root / "common.cuh")
    (root / "coupling_emulated.cpp").write_text(
        emulated_source("coupling.cu"))
    (root / "harness.cpp").write_text(HARNESS)
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{root}", "-o",
         str(root / "harness"), str(root / "harness.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stdout + build.stderr[-4000:]
    return root / "harness"


def _run(harness, arch, mode: str, packed, x, warps: int):
    """The emulated kernel on x: (y, log_det)."""
    n, d = x.shape
    root = harness.parent
    tag = f"{arch.transformer}{d}_{arch.n_layers}_{mode}_{n}"
    inp, out = root / f"in_{tag}.bin", root / f"out_{tag}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, FC.config_id(arch), int(mode == "forward"),
            warps, packed.numel(), inp, out]
    subprocess.run([str(harness), *map(str, args)], check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    return res[:d * n].reshape(n, d), res[d * n:]


def test_coupling_layout_table_matches_python(harness):
    """The layout the kernel reads, as the C entry the wrapper checks at
    launch reports it, equals the Python packing's (``mma_layout``, then
    the most warps per block) for every configuration: the spline and the
    affine one at d = 4, config 5's wide one, and nsf-tpu at d = 2 and at
    d = 5 (the validation rows; padded halves)."""
    out = subprocess.run([str(harness), "layout"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    rows = [[int(v) for v in line.split()] for line in out.splitlines()]
    wide = chip_smoke.hierarchical_flow()
    flows = [nsf_tpu(4), realnvp(4), wide, nsf_tpu(2), nsf_tpu(5)]
    assert rows == [[*FC.mma_layout(a), FC.COUPLING_WARPS] for a in flows]
    assert [FC.config_id(a) for a in flows] == [0, 1, 2, 3, 4]
    assert FC.mma_wide(wide)


@pytest.mark.parametrize("n,warps", [(512, 8), (512 + 37, 2)])
@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("flow", sorted(chip_smoke.coupling_flows()))
def test_coupling_kernel_source_matches_plain(harness, flow, mode, n, warps):
    """The flows of ``chip_smoke.phase_coupling``, on full 8-warp blocks
    and a ragged n over 2-warp blocks (the launch's block sizes at
    n = 131072 and 8192), both directions."""
    arch, seed, scale = chip_smoke.coupling_flows()[flow]
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), seed,
                                             arch, scale)
    x = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, 4)).astype(np.float32))
    if mode == "forward":
        x = 2.0 * x
    packed = FC.prepare_mma_params(arch, params)
    y, ld = _run(harness, arch, mode, packed, x, warps)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated {flow} {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated {flow} {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


@pytest.mark.parametrize("n,warps", [(64, 2), (32 + 5, 1)])
@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_wide_coupling_kernel_source_matches_plain(harness, mode, n, warps):
    """The wide form (BASELINE config 5's d = 32, (128, 128), 8-bin flow,
    cut to 2 layers so the stand-in stays quick): its chunked weight
    stream, row tiles, groups of active dims and per-lane transformers, in
    both directions, on a full block of two warps and a ragged n, against
    the plain pass (card tolerance, float64 arbitration) and the packed
    reader."""
    arch, params = chip_smoke.perturbed_flow(
        torch.device("cpu"), 11, chip_smoke.hierarchical_flow(n_layers=2),
        0.05)
    x = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, 32)).astype(np.float32))
    if mode == "forward":
        x = 2.0 * x
    packed = FC.prepare_mma_params(arch, params)
    y, ld = _run(harness, arch, mode, packed, x, warps)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated wide {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated wide {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


@pytest.mark.parametrize("d,mode", [(2, "forward"), (5, "inverse")])
def test_validate_shapes_coupling_kernel_source_matches_plain(harness, d,
                                                              mode):
    """nsf-tpu at the validation rows' d = 2 (one dim a half; the density
    pass, B1) and d = 5 (halves padded to 3 dims, the output layer one
    active dim at a time; the sampling pass, B3), 512 particles on full
    8-warp blocks, against the plain pass (card tolerance, float64
    arbitration) and the packed reader. The density pass at d = 5 runs in
    the chain stand-in's flow density too; every direction at both d on
    the card."""
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 5,
                                             nsf_tpu(d), 0.1)
    x = torch.as_tensor(np.random.default_rng(d).normal(
        size=(512, d)).astype(np.float32))
    if mode == "forward":
        x = 2.0 * x
    packed = FC.prepare_mma_params(arch, params)
    y, ld = _run(harness, arch, mode, packed, x, 8)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated d={d} {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated d={d} {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)
