"""The chain kernel's CUDA source (``csrc/chain.cu``), run on the CPU.

As ``tests/test_torch_maf_emulated.py`` does for the MAF kernel, and with
its stand-in CUDA runtime (each CUDA thread a fiber on one OS thread,
barriers for ``__syncthreads``/``__syncwarp``, the warp's ``mma.sync`` m16n8k8
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
#define __noinline__
using std::isnan;
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, ph = emu_warp[w].gen & 1;
  emu_shfl_post(v);
  __syncwarp();
  return emu_lanes[w].f[ph][src & 31][0];
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
#include "chain_emulated.cpp"
namespace aspire { float4 smem4[232448 / 16]; }
using S = aspire::MmaShape<4, aspire::Hidden<64, 64>, 8, true>;
using W = aspire::MmaShape<32, aspire::Hidden<128, 128>, 8, true>;
using S2 = aspire::MmaShape<2, aspire::Hidden<64, 64>, 8, true>;
using S5 = aspire::MmaShape<5, aspire::Hidden<64, 64>, 8, true>;
// Configuration 0 (nsf-tpu at d = 4), 2 (the wide form at d = 32), 3 or 4
// (nsf-tpu at d = 2 and d = 5, every in-kernel target), the instance that
// applies programs or the one without (launch_chain's choice).
template <int CFG, bool PROGS>
void run_chain(const aspire::ChainArgs& a, int nt) {
  for (int b = 0; b < nt; ++b) {
    emu_run_block(b, 256, [&] {
      if constexpr (CFG == 0) {
        aspire::chain_kernel<4, aspire::Hidden<64, 64>, 8, true, PROGS, 0>(a);
      } else if constexpr (CFG == 2) {
        aspire::chain_kernel_wide<32, aspire::Hidden<128, 128>, 8, true, PROGS,
                                  0>(a);
      } else if constexpr (CFG == 3) {
        aspire::chain_kernel<2, aspire::Hidden<64, 64>, 8, true, PROGS, 1>(a);
      } else {
        aspire::chain_kernel<5, aspire::Hidden<64, 64>, 8, true, PROGS, 1>(a);
      }
    });
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
    printf("%d\n", aspire_chain_tile());
    for (int d : {4, 32}) {
      int v[8];
      const int count = aspire_consts_layout(d, v, 8);
      for (int e = 0; e < count; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    return 0;
  }
  if (argc == 3) {  // configurations 3 and 4: the C entries, MmaShape's
    for (int cfg : {3, 4}) {
      int v[16];
      const int count = aspire_chain_layout(cfg, v, 16);
      for (int e = 0; e < count; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    printf("%d %d %d %d %d %d %d %d %d %d %d\n", S2::SIZE, S2::W1, S2::B1,
           S2::W2, S2::B2, S2::W3, S2::B3, S2::ROW, S2::STAGE, S2::RES,
           S2::CHUNK);
    printf("%d %d %d %d %d %d %d %d %d %d %d\n", S5::SIZE, S5::W1, S5::B1,
           S5::W2, S5::B2, S5::W3, S5::B3, S5::ROW, S5::STAGE, S5::RES,
           S5::CHUNK);
    for (int d : {2, 5}) {
      int v[8];
      const int count = aspire_consts_layout(d, v, 8);
      for (int e = 0; e < count; ++e) printf("%d ", v[e]);
      printf("\n");
    }
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), steps = atoi(argv[3]);
  const int kernel = atoi(argv[4]), gm = atoi(argv[5]), go = atoi(argv[6]);
  const int rows = atoi(argv[7]), target = atoi(argv[8]);
  const int programs = atoi(argv[21]);
  const long long seed[2] = {strtoll(argv[9], nullptr, 10),
                             strtoll(argv[10], nullptr, 10)};
  const int injected = atoi(argv[11]);
  const float beta = atof(argv[12]), nu = atof(argv[13]);
  const float target_acc = atof(argv[14]), rate = atof(argv[15]);
  const float max_log_step = atof(argv[16]), tail = atof(argv[17]);
  const int cfg = atoi(argv[20]);
  const int dims[] = {4, 0, 32, 2, 5};
  const int sizes[] = {S::SIZE, 0, W::SIZE, S2::SIZE, S5::SIZE};
  const int d = dims[cfg], size = sizes[cfg];
  int layout[8];
  const int nt = n / 256, cs = layout[aspire_consts_layout(d, layout, 8) - 1];
  std::vector<float> z0(d * n), w(layers * size), c(cs), step0(nt);
  std::vector<float> noise(injected ? (size_t)steps * rows * n : 0);
  std::vector<float> z(d * n), lq(n), lpi(n), ll(n), nacc(n);
  std::vector<float> stats(nt * (4 * d + 1)), scratch(3 * d * n, -7.f);
  FILE* f = fopen(argv[18], "rb");
  for (auto* v : {&z0, &w, &c, &step0, &noise}) {
    if (fread(v->data(), 4, v->size(), f) != v->size()) return 2;
  }
  fclose(f);
  aspire::ChainArgs a{z0.data(), w.data(), c.data(), step0.data(),
                      injected ? noise.data() : nullptr, z.data(), lq.data(),
                      lpi.data(), ll.data(), nacc.data(), stats.data(),
                      scratch.data(), n, layers, steps, kernel, gm, go, rows,
                      programs, target, nu, target_acc, rate, max_log_step,
                      tail, &beta, seed};
  blockDim = {256, 1, 1};
  gridDim = {(unsigned)nt, 1, 1};
  const bool progs = programs == aspire::kPrograms;
  if (cfg == 2) {
    progs ? run_chain<2, true>(a, nt) : run_chain<2, false>(a, nt);
  } else if (cfg == 3) {
    progs ? run_chain<3, true>(a, nt) : run_chain<3, false>(a, nt);
  } else if (cfg == 4) {
    progs ? run_chain<4, true>(a, nt) : run_chain<4, false>(a, nt);
  } else {
    progs ? run_chain<0, true>(a, nt) : run_chain<0, false>(a, nt);
  }
  f = fopen(argv[19], "wb");
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
         noise=None, seed=(0, 0), pc=None):
    """The emulated kernel: the wrapper's returns, ``(z, lq, lpi, ll,
    n_accept, step_sizes, stats)``."""
    arch = cfg.arch
    n, d = z0.shape
    consts = FM.chain_consts(d, *refs, FM.program_block(dt, d, "cpu"),
                             FM.program_block(pc, d, "cpu"), target[1])
    inputs = [z0, FM.prepare_chain_params(arch, params), consts, step0]
    if noise is not None:
        inputs.append(noise)
    root = harness.parent
    tag = f"{d}_{cfg.kernel}_{seed[0]}_{noise is not None}_{pc is not None}"
    inp, out = root / f"in_{tag}.bin", root / f"out_{tag}.bin"
    np.concatenate([t.numpy().ravel() for t in inputs]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, cfg.n_steps, FM.KERNELS[cfg.kernel],
            cfg.gamma_m, cfg.gamma_odd, cfg.noise_rows, int(target[0]),
            seed[0], seed[1],
            int(noise is not None), beta, cfg.nu, cfg.target_acceptance,
            cfg.adaptation_rate, cfg.max_log_step, arch.tail_bound, inp, out,
            FC.config_id(arch), FM.program_level(dt, pc)]
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
    buffer's row stride and size; the tile, and the constant block's
    offsets and size (``consts_layout``) at d = 4 and 32."""
    library, wide_library, shape, wide_shape, (tile,), consts, consts32 = (
        _layout(harness))
    want = list(FM.chain_layout(nsf_tpu(4)))
    assert library == shape == want
    assert wide_library == wide_shape == list(
        FM.chain_layout(chip_smoke.hierarchical_flow()))
    assert tile == FM.TILE == 256
    assert consts == list(FM.consts_layout(4))
    assert consts32 == list(FM.consts_layout(32))
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


def _program_case(harness, cfg, params, z0, beta, step0, refs, target, dt,
                  gen, pc):
    """The emulated kernel with programs dt and pc against the plain chain
    on injected, nudged noise (``chip_smoke.check_chain_program``'s
    check)."""
    n = z0.shape[0]
    noise = torch.rand((cfg.n_steps, cfg.noise_rows, n), generator=gen).clamp(
        1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, precond=pc, noise=noise,
                           return_acc_probs=True)
    chip_smoke.nudge_accept_uniforms(noise, plain[-1])
    kern = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                noise=noise, pc=pc)
    chip_smoke.assert_chain_close(kern, plain)
    assert 0 < float(kern[4].sum()) < n * cfg.n_steps


def test_chain_kernel_source_runs_the_programs(harness):
    """The narrow form with a periodic run's programs
    (``chip_smoke.bounded_programs``: a masked periodic preconditioning, a
    periodic + logit + affine data transform) on two tiles, three steps, at
    the card check's tolerances."""
    setup = chip_smoke.program_chain_setup(torch.device("cpu"), N, STEPS,
                                           "periodic")
    assert [op for op, _ in setup[7].ops] == ["periodic", "logit", "affine"]
    assert setup[-1].ops == (("periodic", True),)
    _program_case(harness, *setup)


def test_wide_chain_kernel_source_runs_the_programs(harness):
    """The wide form (config 5's shape cut to 2 layers, one tile, two
    steps) with the same programs, at the card check's tolerances."""
    setup = chip_smoke.program_chain_setup(
        torch.device("cpu"), FM.TILE, 2, "periodic",
        setup=lambda device, n, steps: chip_smoke.hierarchical_chain_setup(
            device, n, steps, n_layers=2))
    _program_case(harness, *setup)


def test_validate_shapes_chain_layout_table_matches_python(harness):
    """Configurations 3 and 4 (nsf-tpu at d = 2 and d = 5): the layout the
    C entry reports and MmaShape's own equal the Python packing's (d = 5:
    halves padded to 3 dims), and the constant
    block at d = 2 and 5 equals ``consts_layout``."""
    out = subprocess.run([str(harness), "layout", "validate"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    rows = [[int(v) for v in line.split()] for line in out.splitlines()]
    lib2, lib5, shape2, shape5, consts2, consts5 = rows
    assert lib2 == shape2 == list(FM.chain_layout(nsf_tpu(2)))
    assert lib5 == shape5 == list(FM.chain_layout(nsf_tpu(5)))
    assert consts2 == list(FM.consts_layout(2))
    assert consts5 == list(FM.consts_layout(5))


@pytest.mark.parametrize("row", ["rosenbrock", "funnel"])
def test_validate_shapes_chain_kernel_source_matches_plain(harness, row):
    """The validation rows' chains (``chip_smoke.validate_chain_setup``):
    Rosenbrock at d = 2 with its logit + affine data transform (the
    instance with programs), the funnel at d = 5 with the affine one (the
    instance without; the flow's halves padded), their in-kernel targets,
    two tiles, three steps, on injected nudged noise at the card check's
    tolerances."""
    setup = chip_smoke.validate_chain_setup(torch.device("cpu"), N, STEPS,
                                            row)
    level = FM.program_level(setup[7], setup[-1])
    assert level == (2 if row == "rosenbrock" else 1)
    _program_case(harness, *setup)
