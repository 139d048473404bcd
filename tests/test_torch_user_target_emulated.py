"""The chain kernel built with a user's target source, run on the CPU.

As ``tests/test_torch_chain_emulated.py`` runs ``csrc/chain.cu`` under the
stand-in CUDA runtime, this compiles it as ``ops/_build.py::build_user``
does: ``ASPIRE_USER_TARGET`` the user's source (``chip_smoke``'s
``PolynomialRegression``, 128 points), ``ASPIRE_INSTANCE_CONFIG`` the
row of configuration 0 (nsf-tpu at d = 4), the only one built. Checked:
one tile, two tpCN steps, the affine data transform, on injected noise
nudged as ``chip_smoke.phase_chain`` nudges it, against the plain chain
on the user's torch callables at the card check's tolerances
(``chip_smoke.assert_chain_close``); and the instance's layout tables.
About 6 s of one worker. Skips where no ``g++`` with C++20 is installed
on x86-64.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from test_torch_chain_emulated import CHAIN_RUNTIME
from test_torch_maf_emulated import (
    CSRC,
    RUNTIME,
    cxx20_compiler,
    emulated_source,
)

STEPS = 2

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include "chain_emulated.cpp"
namespace aspire { float4 smem4[232448 / 16]; }
template <bool PROGS>
void run_chain(const aspire::ChainArgs& a, int nt) {
  for (int b = 0; b < nt; ++b) {
    emu_run_block(b, 256, [&] {
      aspire::chain_kernel<4, aspire::Hidden<64, 64>, 8, true, PROGS, 0>(a);
    });
  }
}
int main(int argc, char** argv) {
  if (argc == 2) {  // the layout: its C entries for configuration 0
    int v[16];
    int count = aspire_chain_layout(0, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n%d\n", aspire_chain_layout(2, v, 16));
    count = aspire_consts_layout(4, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n");
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), steps = atoi(argv[3]);
  const int kernel = atoi(argv[4]), gm = atoi(argv[5]), go = atoi(argv[6]);
  const int rows = atoi(argv[7]), target = atoi(argv[8]);
  const int programs = atoi(argv[9]), user_floats = atoi(argv[10]);
  const float beta = atof(argv[11]), nu = atof(argv[12]);
  const float target_acc = atof(argv[13]), rate = atof(argv[14]);
  const float max_log_step = atof(argv[15]), tail = atof(argv[16]);
  using S = aspire::MmaShape<4, aspire::Hidden<64, 64>, 8, true>;
  int layout[8];
  const int nt = n / 256, cs = layout[aspire_consts_layout(4, layout, 8) - 1];
  std::vector<float> z0(4 * n), w(layers * S::SIZE), c(cs), step0(nt);
  std::vector<float> noise((size_t)steps * rows * n), user(user_floats);
  std::vector<float> z(4 * n), lq(n), lpi(n), ll(n), nacc(n);
  std::vector<float> stats(nt * 17);
  FILE* f = fopen(argv[17], "rb");
  for (auto* v : {&z0, &w, &c, &step0, &noise, &user}) {
    if (fread(v->data(), 4, v->size(), f) != v->size()) return 2;
  }
  fclose(f);
  const long long seed[2] = {0, 0};
  aspire::ChainArgs a{z0.data(), w.data(), c.data(), step0.data(),
                      noise.data(), z.data(), lq.data(), lpi.data(),
                      ll.data(), nacc.data(), stats.data(), nullptr, n,
                      layers, steps, kernel, gm, go, rows, programs, target,
                      nu, target_acc, rate, max_log_step, tail, &beta, seed};
  a.user_consts = user.data();
  blockDim = {256, 1, 1};
  gridDim = {(unsigned)nt, 1, 1};
  programs == aspire::kPrograms ? run_chain<true>(a, nt)
                                : run_chain<false>(a, nt);
  f = fopen(argv[18], "wb");
  for (auto* v : {&z, &lq, &lpi, &ll, &nacc, &stats}) {
    fwrite(v->data(), 4, v->size(), f);
  }
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = tmp_path_factory.mktemp("user_target_emulated")
    gxx = cxx20_compiler(root)
    (root / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME)
    shutil.copy(CSRC / "common.cuh", root / "common.cuh")
    (root / "user_target.cuh").write_text(chip_smoke.REGRESSION_CUDA)
    (root / "chain_emulated.cpp").write_text(
        f'#define ASPIRE_USER_TARGET "{root / "user_target.cuh"}"\n'
        f"#define ASPIRE_INSTANCE_CONFIG(X) "
        f"{_build.instance_row(_build.chain_config_row(0))}\n"
        + emulated_source("chain.cu"))
    (root / "harness.cpp").write_text(HARNESS)
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-w", f"-I{root}", "-o",
         str(root / "harness"), str(root / "harness.cpp")],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stdout + build.stderr[-4000:]
    return root / "harness"


def _run(harness, cfg, params, z0, beta, step0, refs, target, dt, noise):
    """The emulated user instance: the wrapper's returns, ``(z, lq, lpi,
    ll, n_accept, step_sizes, stats)``."""
    arch = cfg.arch
    n, d = z0.shape
    user, user_consts = target
    consts = FM.chain_consts(d, *refs, FM.program_block(dt, d, "cpu"),
                             FM.program_block(None, d, "cpu"),
                             user_consts[:0])
    inputs = [z0, FM.prepare_chain_params(arch, params), consts, step0,
              noise, user_consts]
    root = harness.parent
    inp, out = root / "in.bin", root / "out.bin"
    np.concatenate([t.numpy().ravel() for t in inputs]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, cfg.n_steps, FM.KERNELS[cfg.kernel],
            cfg.gamma_m, cfg.gamma_odd, cfg.noise_rows, FM.USER_TARGET,
            FM.program_level(dt, None), user_consts.numel(), beta, cfg.nu,
            cfg.target_acceptance, cfg.adaptation_rate, cfg.max_log_step,
            arch.tail_bound, inp, out]
    subprocess.run([str(harness), *map(str, args)], check=True, timeout=300)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, rest = res[:d * n].reshape(n, d), res[d * n:]
    lq, lpi, ll, nacc = rest[:4 * n].reshape(4, n)
    stats = rest[4 * n:].reshape(n // FM.TILE, 4 * d + 1)
    return z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats


def test_user_instance_layout_is_configuration_0_alone(harness):
    """The instance compiles configuration 0 alone: its layout table and
    constant block equal the Python packing's, and it reports no other
    configuration (-1 for configuration 2)."""
    out = subprocess.run([str(harness), "layout"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    arch = chip_smoke.perturbed_flow(torch.device("cpu"))[0]
    assert FC.config_id(arch) == 0
    assert [int(v) for v in out[0].split()] == list(FM.chain_layout(arch))
    assert int(out[1]) == -1
    assert [int(v) for v in out[2].split()] == list(FM.consts_layout(4))


def test_user_target_chain_source_matches_plain(harness):
    """One tile, two steps on the regression: exact acceptance counts, and
    z, the densities, the step sizes and the statistics against the plain
    chain on the user's torch callables at the card check's
    tolerances."""
    setup = chip_smoke.regression_chain_setup(torch.device("cpu"), FM.TILE,
                                              STEPS)
    cfg, params, z0, beta, step0, refs, target, dt, gen, _ = setup
    assert isinstance(target[0], FM.UserTarget)
    assert FM.program_level(dt, None) == 1
    noise = torch.rand((STEPS, cfg.noise_rows, FM.TILE),
                       generator=gen).clamp(1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=noise,
                           return_acc_probs=True)
    chip_smoke.nudge_accept_uniforms(noise, plain[-1])
    kern = _run(harness, cfg, params, z0, beta, step0, refs, target, dt,
                noise)
    chip_smoke.assert_chain_close(kern, plain)
    assert 0 < float(kern[4].sum()) < FM.TILE * STEPS
