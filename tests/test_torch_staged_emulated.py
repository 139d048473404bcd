"""The staged coupling kernels' CUDA source (``csrc/staged_coupling.cu``),
run on the CPU.

As ``tests/test_torch_coupling_emulated.py`` does for the coupling kernel,
and with the same stand-in CUDA runtime (each CUDA thread a fiber on one
OS thread, barriers for ``__syncthreads``/``__syncwarp``, the warp's
``mma.sync`` m16n8k8 TF32 computed from its lanes' fragments), the
unchanged source with the tensor-core pass it includes
(``csrc/coupling_mma.cuh``) is compiled as C++; each group's named barrier
(``bar.sync 1 + q, 2S``) becomes a barrier of its own (``PTX_STAND_INS``).
Every configuration of ``ASPIRE_STAGED_CONFIGS`` runs on the tensor
cores: D1 (Q = 2), D2 (Q = 3, 4, 8) and D3 with and without
``rqs_micro``, on the dev scripts' flow (``chip_smoke.staged_flow``) at
n = 512 and a ragged 512 + 37, over two persistent blocks (D3: of two
warps) that each take several tiles. Each is held against its plain
schedule (``staged_plain``/``paired_plain``) at the card check's tolerance
(``chip_smoke.COUPLING_TOL``, float64 arbitration) and against the packed
reader of its weights (``coupling_packed_plain``); and each
configuration's row, as the C entry the wrapper checks at launch reports
it, against ``STAGED_CONFIGS`` and the Python layouts. Skips where no
``g++`` with C++20 ``<barrier>`` is installed.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import staged_coupling as SC
from test_torch_chain_emulated import CHAIN_RUNTIME
from test_torch_maf_emulated import (
    CSRC,
    RUNTIME,
    cxx20_compiler,
    emulated_source,
)

# Host calls of the launch code, which the harness bypasses.
STAGED_RUNTIME = r"""
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include "staged_emulated.cpp"
namespace aspire { float4 smem4[232448 / 16]; }
// One configuration on `blocks` persistent blocks, one after another: a
// tile of Q sub-tiles each (D1/D2), or two warps (D3).
template <int D, int H1, int H2, int K, int Q, int S, bool PAIRED,
          bool MICRO>
void launch(const float* x, float* z, float* ld, const float* w, int n,
            int layers, int blocks) {
  const int threads = PAIRED ? 64 : 2 * Q * S;
  blockDim = {(unsigned)threads, 1, 1};
  gridDim = {(unsigned)blocks, 1, 1};
  // Barrier 0 is __syncthreads'; group q's is 1 + q, of 2S threads.
  emu_named_threads.assign(Q + 1, 0);
  for (int g = 1; g <= Q; ++g) emu_named_threads[g] = 2 * S;
  for (int b = 0; b < blocks; ++b) {
    emu_run_block(b, threads, [&] {
      if constexpr (PAIRED) {
        aspire::paired_kernel<D, H1, H2, K, MICRO>(x, z, ld, w, n, layers,
                                                   5.0f);
      } else {
        aspire::staged_mma_kernel<D, H1, H2, K, Q, S>(x, z, ld, w, n,
                                                      layers, 5.0f);
      }
    });
  }
}
int main(int argc, char** argv) {
  if (argc == 2) {  // every configuration's row, then -1 past the last
    for (int cfg = 0;; ++cfg) {
      int v[10];
      if (aspire_staged_config(cfg, v) != 0) break;
      for (int e = 0; e < 10; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), cfg = atoi(argv[3]);
  const int blocks = atoi(argv[4]), floats = atoi(argv[5]);
  std::vector<float> x(4 * n), w(floats), z(4 * n, -1.f), ld(n, -1.f);
  FILE* f = fopen(argv[6], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size()) return 2;
  if (fread(w.data(), 4, w.size(), f) != w.size()) return 3;
  fclose(f);
#define RUN(ID, D, H1, H2, K, Q, S, PAIRED, MICRO)                       \
  if (cfg == ID) {                                                      \
    launch<D, H1, H2, K, Q, S, PAIRED, MICRO>(x.data(), z.data(),       \
                                              ld.data(), w.data(), n,   \
                                              layers, blocks);          \
  }
  ASPIRE_STAGED_CONFIGS(RUN)
#undef RUN
  f = fopen(argv[7], "wb");
  fwrite(z.data(), 4, z.size(), f);
  fwrite(ld.data(), 4, ld.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = tmp_path_factory.mktemp("staged_emulated")
    gxx = cxx20_compiler(root)
    (root / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME
                                         + STAGED_RUNTIME)
    shutil.copy(CSRC / "common.cuh", root / "common.cuh")
    (root / "staged_emulated.cpp").write_text(
        emulated_source("staged_coupling.cu"))
    (root / "harness.cpp").write_text(HARNESS)
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{root}", "-o",
         str(root / "harness"), str(root / "harness.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stdout + build.stderr[-4000:]
    return root / "harness"


@pytest.fixture(scope="module")
def flow():
    return chip_smoke.staged_flow(torch.device("cpu"))


def _run(harness, arch, cfg: int, weights, x, blocks: int = 2):
    """The emulated kernel of configuration ``cfg`` on x: (z, log_det)."""
    n = x.shape[0]
    root = harness.parent
    inp, out = root / f"in_{cfg}_{n}.bin", root / f"out_{cfg}_{n}.bin"
    np.concatenate([x.numpy().ravel(), weights.numpy()]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, cfg, blocks, weights.numel(), inp, out]
    subprocess.run([str(harness), *map(str, args)], check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    return res[:4 * n].reshape(n, 4), res[4 * n:]


def test_staged_config_rows_match_python(harness, flow):
    """The row the kernel library reports per configuration (the wrapper
    checks it at every launch) is ``STAGED_CONFIGS``' row, then the packed
    floats per layer, B1's for every variant, and the shared floats per
    sub-tile of the variant's buffers: coordinates, parameter rows and
    log-det sums for D1/D2, D3's 16 parameter rows."""
    arch, _ = flow
    out = subprocess.run([str(harness), "layout"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    rows = [[int(v) for v in line.split()] for line in out.splitlines()]
    want = []
    for cid, (d, hidden, k, q, s, paired, micro) in sorted(
            SC.STAGED_CONFIGS.items()):
        want.append([d, *hidden, k, q, s, int(paired), int(micro),
                     FC.mma_layout(arch)[0],
                     s * SC.buffer_floats(arch, paired)])
    assert rows == want
    assert [r[9] for r in rows if r[6]] == [16 * 52] * 2


@pytest.mark.parametrize("n", [512, 512 + 37])
@pytest.mark.parametrize("cfg", sorted(SC.STAGED_CONFIGS))
def test_staged_kernel_source_matches_plain(harness, flow, cfg, n):
    """Each configuration on the dev scripts' flow against its plain
    schedule, float64 deciding the points where they disagree, and against
    ``coupling_packed_plain`` of its packed weights (B1's: the reader runs
    the pass with ``rational_quadratic_spline``, which ``rqs_micro``
    equals but for rounding)."""
    arch, params = flow
    _, _, _, q, s, paired, micro = SC.STAGED_CONFIGS[cfg]
    x = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, 4)).astype(np.float32))
    params64, x64 = chip_smoke.as_float64(params), x.double()
    weights = FC.prepare_mma_params(arch, params)
    if paired:
        z_p, ld_p = SC.paired_plain(arch, params, x, s, micro)
        z_e, ld_e = SC.paired_plain(arch, params64, x64, s, micro)
    else:
        z_p, ld_p = SC.staged_plain(arch, params, x, q, s)
        z_e, ld_e = arch.forward_plain(params64, x64)
    z, ld = _run(harness, arch, cfg, weights, x)
    what = f"emulated staged config {cfg}"
    chip_smoke.assert_kernel_close(z, z_p, z_e, f"{what} z")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e, f"{what} log_det")
    z_r, ld_r = FC.coupling_packed_plain(arch, "forward", weights, x)
    torch.testing.assert_close(z, z_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)
