"""The chain kernel's CUDA source (``csrc/chain.cu``), run on the CPU.

As ``tests/test_torch_maf_emulated.py`` does for the MAF kernel, and with
its stand-in CUDA runtime (one ``std::thread`` per CUDA thread, barriers
for ``__syncthreads``/``__syncwarp``, the warp's ``mma.sync`` m16n8k8
TF32 computed from its lanes' fragments), the unchanged source is compiled
as C++ at the configuration the library compiles (nsf-tpu at d = 4) and
run on two 256-particle tiles for three steps. Added here for this kernel:
``__shfl_sync`` and ``erfinvf`` (Newton steps on ``erf`` in double).
Checked: the chain against ``chain_plain`` on the same injected noise,
with ``chip_smoke.py``'s accept-uniform nudge and chain tolerances; the
in-kernel Philox stream against the same stream injected, bit for bit;
the kernel's layout table against the Python packing. Skips where no
``g++`` with C++20 ``<barrier>`` is installed.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import nsf_tpu
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from test_torch_maf_emulated import (
    CSRC,
    RUNTIME,
    cxx20_compiler,
    emulated_source,
)

N, STEPS = 512, 3

CHAIN_RUNTIME = r"""
using std::isnan;
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w].f[l][0] = v;
  __syncwarp();
  const float r = emu_lanes[w].f[src & 31][0];
  __syncwarp();
  return r;
}
// erfinv to float precision: Winitzki's approximation, then Newton steps
// on erf in double.
inline float erfinvf(float y) {
  if (y <= -1.f) return -INFINITY;
  if (y >= 1.f) return INFINITY;
  const double l = std::log(1.0 - (double)y * y);
  const double b = 2.0 / (3.14159265358979323846 * 0.147) + 0.5 * l;
  double x = std::copysign(std::sqrt(std::sqrt(b * b - l / 0.147) - b), y);
  for (int i = 0; i < 4; ++i) {
    x -= (std::erf(x) - y) / (1.1283791670955126 * std::exp(-x * x));
  }
  return (float)x;
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <thread>
#include "chain_emulated.cpp"
namespace aspire { float4 smem4[232448 / 16]; }
using S = aspire::MmaShape<4, 64, 64, 8, true>;
using W = aspire::MmaShape<32, 128, 128, 8, true>;
// Configuration 0 (nsf-tpu at d = 4) or 2 (the wide form at d = 32).
template <int CFG>
void run_chain(const aspire::ChainArgs& a, int nt) {
  for (int b = 0; b < nt; ++b) {
    emu_block = std::make_unique<std::barrier<>>(256);
    emu_warp.clear();
    for (int i = 0; i < 8; ++i)
      emu_warp.push_back(std::make_unique<std::barrier<>>(32));
    emu_lanes.assign(8, EmuLanes{});
    std::vector<std::thread> threads;
    for (int t = 0; t < 256; ++t) {
      threads.emplace_back([&, b, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        if constexpr (CFG == 0) {
          aspire::chain_kernel<4, 64, 64, 8, true>(a);
        } else {
          aspire::chain_kernel_wide<32, 128, 128, 8, true>(a);
        }
      });
    }
    for (auto& t : threads) t.join();
  }
}
int main(int argc, char** argv) {
  if (argc == 2) {  // per configuration: the C entries, then MmaShape's own
    for (int cfg : {0, 2}) {
      int v[16];
      const int count = aspire_chain_layout(cfg, v, 16);
      for (int e = 0; e < count; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    printf("%d %d %d %d %d %d %d %d %d %d %d\n", S::SIZE, S::W1, S::B1,
           S::W2, S::B2, S::W3, S::B3, S::ROW, S::STAGE, S::RES, S::CHUNK);
    printf("%d %d %d %d %d %d %d %d %d %d %d\n", W::SIZE, W::W1, W::B1,
           W::W2, W::B2, W::W3, W::B3, W::ROW, W::STAGE, W::RES, W::CHUNK);
    printf("%d %d %d\n", aspire_chain_tile(), aspire_consts_floats(4),
           aspire_consts_floats(32));
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), steps = atoi(argv[3]);
  const int kernel = atoi(argv[4]), gm = atoi(argv[5]), go = atoi(argv[6]);
  const int rows = atoi(argv[7]), dt = atoi(argv[8]), target = atoi(argv[9]);
  const long long seed[2] = {strtoll(argv[10], nullptr, 10),
                             strtoll(argv[11], nullptr, 10)};
  const int injected = atoi(argv[12]);
  const float beta = atof(argv[13]), nu = atof(argv[14]);
  const float target_acc = atof(argv[15]), rate = atof(argv[16]);
  const float max_log_step = atof(argv[17]), tail = atof(argv[18]);
  const int cfg = atoi(argv[21]), d = cfg == 2 ? 32 : 4;
  const int nt = n / 256, cs = aspire_consts_floats(d);
  const int size = cfg == 2 ? W::SIZE : S::SIZE;
  std::vector<float> z0(d * n), w(layers * size), c(cs), step0(nt);
  std::vector<float> noise(injected ? (size_t)steps * rows * n : 0);
  std::vector<float> z(d * n), lq(n), lpi(n), ll(n), nacc(n);
  std::vector<float> stats(nt * (4 * d + 1)), scratch(3 * d * n, -7.f);
  FILE* f = fopen(argv[19], "rb");
  for (auto* v : {&z0, &w, &c, &step0, &noise}) {
    if (fread(v->data(), 4, v->size(), f) != v->size()) return 2;
  }
  fclose(f);
  aspire::ChainArgs a{z0.data(), w.data(), c.data(), step0.data(),
                      injected ? noise.data() : nullptr, z.data(), lq.data(),
                      lpi.data(), ll.data(), nacc.data(), stats.data(),
                      scratch.data(), n, layers, steps, kernel, gm, go, rows,
                      dt, target, nu, target_acc, rate, max_log_step,
                      tail, &beta, seed};
  blockDim = {256, 1, 1};
  gridDim = {(unsigned)nt, 1, 1};
  if (cfg == 2) {
    run_chain<2>(a, nt);
  } else {
    run_chain<0>(a, nt);
  }
  f = fopen(argv[20], "wb");
  for (auto* v : {&z, &lq, &lpi, &ll, &nacc, &stats}) {
    fwrite(v->data(), 4, v->size(), f);
  }
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain_emulated")
    gxx = cxx20_compiler(root)
    (root / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME)
    shutil.copy(CSRC / "common.cuh", root / "common.cuh")
    (root / "chain_emulated.cpp").write_text(emulated_source("chain.cu"))
    (root / "harness.cpp").write_text(HARNESS)
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{root}", "-o",
         str(root / "harness"), str(root / "harness.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stdout + build.stderr[-4000:]
    return root / "harness"


def _layout(harness) -> list[list[int]]:
    out = subprocess.run([str(harness), "layout"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [[int(v) for v in line.split()] for line in out.splitlines()]


def _setup(kernel: str):
    cfg, params, z0, beta, step0, refs, target, dt, gen = (
        chip_smoke.chain_setup(torch.device("cpu"), N, STEPS))
    if kernel != "tpcn":
        cfg = FM.ChainConfig(cfg.arch, kernel, STEPS, nu=cfg.nu)
    return cfg, params, z0, beta, step0, refs, target, dt, gen


def _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
         noise=None, seed=(0, 0)):
    """The emulated kernel: the wrapper's returns, ``(z, lq, lpi, ll,
    n_accept, step_sizes, stats)``."""
    arch = cfg.arch
    n, d = z0.shape
    consts = FM.chain_consts(_layout(harness)[4][1 if d == 4 else 2], d,
                             *refs, dt, target[1])
    inputs = [z0, FM.prepare_chain_params(arch, params), consts, step0]
    if noise is not None:
        inputs.append(noise)
    root = harness.parent
    tag = f"{d}_{cfg.kernel}_{seed[0]}_{noise is not None}"
    inp, out = root / f"in_{tag}.bin", root / f"out_{tag}.bin"
    np.concatenate([t.numpy().ravel() for t in inputs]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, cfg.n_steps, FM.KERNELS[cfg.kernel],
            cfg.gamma_m, cfg.gamma_odd, cfg.noise_rows,
            int(dt is not None), int(target[0]), seed[0], seed[1],
            int(noise is not None), beta, cfg.nu, cfg.target_acceptance,
            cfg.adaptation_rate, cfg.max_log_step, arch.tail_bound, inp, out,
            FC.config_id(arch)]
    subprocess.run([str(harness), *map(str, args)], check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, rest = res[:d * n].reshape(n, d), res[d * n:]
    lq, lpi, ll, nacc = rest[:4 * n].reshape(4, n)
    stats = rest[4 * n:].reshape(n // FM.TILE, 4 * d + 1)
    return z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats


def test_chain_layout_table_matches_python(harness):
    """The layout the kernel reads, as the C entry the wrapper checks at
    launch and MmaShape report it, equals the Python packing's
    (``chain_layout``): floats per layer, section offsets, the warp
    buffer's row stride and size; the tile and the constant block too."""
    library, wide_library, shape, wide_shape, (tile, consts, consts32) = (
        _layout(harness))
    want = list(FM.chain_layout(nsf_tpu(4)))
    assert library == shape == want
    assert wide_library == wide_shape == list(
        FM.chain_layout(chip_smoke.hierarchical_flow()))
    assert tile == FM.TILE == 256 and consts >= 2 * 4 * 4 + 5 * 4 + 2
    assert consts32 >= 2 * 32 * 32 + 5 * 32 + 2
    assert len(FM.prepare_chain_params(*chip_smoke.perturbed_flow(
        torch.device("cpu")))) == 3 * want[0]


@pytest.mark.parametrize("kernel", ["tpcn", "rwmh"])
def test_chain_kernel_source_matches_plain(harness, kernel):
    """Two tiles, three steps, the affine data transform and the mixture
    target, on injected noise nudged as ``chip_smoke.phase_chain`` nudges
    it: exact acceptance counts, and z, the densities, the step sizes and
    the statistics at the card check's tolerances."""
    cfg, params, z0, beta, step0, refs, target, dt, gen = _setup(kernel)
    noise = torch.rand((STEPS, cfg.noise_rows, N), generator=gen).clamp(
        1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=noise,
                           return_acc_probs=True)
    chip_smoke.nudge_accept_uniforms(noise, plain[-1])
    kern = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                noise=noise)
    chip_smoke.assert_chain_close(kern, plain)
    assert 0 < float(kern[4].sum()) < N * STEPS


def test_chain_kernel_source_philox_equals_injected_replay(harness):
    """The in-kernel Philox stream, counted by (particle in the tile, step,
    row group, tile), equals ``philox_uniforms`` injected: every output
    bit for bit."""
    cfg, params, z0, beta, step0, refs, target, dt, _ = _setup("tpcn")
    seed = (0x12345678, 0x9ABCDEF0)
    drawn = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                 seed=seed)
    injected = torch.stack([FM.philox_uniforms(seed, t, cfg.noise_rows, N,
                                               "cpu") for t in range(STEPS)])
    replay = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                  noise=injected)
    for a, b in zip(drawn, replay):
        assert torch.equal(a, b)


def _wide_setup():
    """One tile on BASELINE config 5's target and flow shape (d = 32,
    (128, 128), 8 bins), cut to 2 layers, tpCN at nu + d = 37 (gamma_m 18,
    gamma_odd 1), the affine data transform, 2 steps."""
    cfg, params, z0, beta, step0, refs, target, dt, gen = (
        chip_smoke.hierarchical_chain_setup(torch.device("cpu"), FM.TILE, 2,
                                            n_layers=2))
    return cfg, params, z0, beta, step0, refs, target, dt, gen


def test_wide_chain_kernel_source_matches_plain(harness):
    """The wide form on the hierarchical target: one tile, two steps, on
    injected noise nudged as ``chip_smoke.phase_chain`` nudges it, at the
    card check's tolerances; then its Philox stream against the same
    stream injected, bit for bit."""
    cfg, params, z0, beta, step0, refs, target, dt, gen = _wide_setup()
    assert (cfg.gamma_m, cfg.gamma_odd) == (18, 1)
    noise = torch.rand((cfg.n_steps, cfg.noise_rows, FM.TILE),
                       generator=gen).clamp(1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=noise,
                           return_acc_probs=True)
    chip_smoke.nudge_accept_uniforms(noise, plain[-1])
    kern = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                noise=noise)
    chip_smoke.assert_chain_close(kern, plain)
    assert 0 < float(kern[4].sum()) < FM.TILE * cfg.n_steps
    seed = (0x12345678, 0x9ABCDEF0)
    drawn = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                 seed=seed)
    injected = torch.stack([FM.philox_uniforms(seed, t, cfg.noise_rows,
                                               FM.TILE, "cpu")
                            for t in range(cfg.n_steps)])
    replay = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                  noise=injected)
    for a, b in zip(drawn, replay):
        assert torch.equal(a, b)
