"""The flow kernels' sources at shapes outside the prebuilt library, run on
the CPU, compiled as the instances built at first use are.

``ops/_build.py::build_instance`` compiles ``csrc/coupling.cu``,
``chain.cu`` or ``maf.cu`` with ``ASPIRE_INSTANCE_CONFIG(X)`` defined as
the flow's configuration row; here the unchanged source is compiled the
same way, as C++, under the stand-in CUDA runtime of
``tests/test_torch_maf_emulated.py`` (each CUDA thread a fiber, the
warp's ``mma.sync`` from its lanes' fragments, ``cp.async`` copies that
land at the copying thread's wait, their destination NaN until then), one
build per row, all started together. Checked against the plain passes at
the card check's tolerances (``chip_smoke.COUPLING_TOL`` with float64
arbitration; ``chip_smoke.assert_chain_close`` for the chain):

- the coupling kernel (B1/B3), both modes, at nsf-tpu's widths at d = 15
  (the wide form at an odd d: a padding slot in each half) and d = 32
  (the wide form, (64, 64), which the register rule alone gave the
  whole-layer form), each against the packed reader too;
- the chain kernel (B2) at d = 15 in the wide form on injected noise, and
  the whole-layer chain at d = 10 (the funnel's default d) whose layers do
  not all fit one block, so stream (``chain_kernel_streamed``);
- the MAF kernel's streamed form (B4) at d = 15, (64, 64), 8 bins,
  ragged;
- each instance's layout table against the Python packing.

About 20 s of one worker, most of it the builds. Skips where no ``g++``
with C++20 is installed on x86-64.
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import Coupling, maf_rqs, nsf_tpu
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

ROW = "ROW_D, ROW_HID, ROW_K, ROW_RQS"

COUPLING = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "instance.cpp"
namespace aspire { float4 coupling_smem4[232448 / 16]; }
using S = aspire::MmaShape<ROW_D, ROW_HID, ROW_K, ROW_RQS>;
template <bool DENSITY>
void launch(const float* x, float* z, float* ld, const float* w, int n,
            int layers, int blocks) {
  for (int b = 0; b < blocks; ++b) {
    emu_run_block(b, blockDim.x, [&] {
      if constexpr (S::WIDE) {
        aspire::coupling_kernel_wide<ROW_D, ROW_HID, ROW_K, ROW_RQS,
                                     DENSITY>(x, z, ld, w, n, layers, 5.0f);
      } else {
        aspire::coupling_kernel<ROW_D, ROW_HID, ROW_K, ROW_RQS,
                                DENSITY>(x, z, ld, w, n, layers, 5.0f);
      }
    });
  }
}
int main(int argc, char** argv) {
  if (argc == 2) {  // the instance's layout table and its form
    int v[16];
    const int count = aspire_coupling_layout(0, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n%d\n", (int)S::WIDE);
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]);
  const int density = atoi(argv[3]), warps = atoi(argv[4]);
  std::vector<float> x(ROW_D * n), w(layers * S::SIZE), z(ROW_D * n, -1.f);
  std::vector<float> ld(n, -1.f);
  FILE* f = fopen(argv[5], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size()) return 2;
  if (fread(w.data(), 4, w.size(), f) != w.size()) return 3;
  fclose(f);
  blockDim = {(unsigned)(32 * warps), 1, 1};
  const int blocks = (n + 32 * warps - 1) / (32 * warps);
  gridDim = {(unsigned)blocks, 1, 1};
  (density ? launch<true> : launch<false>)(x.data(), z.data(), ld.data(),
                                           w.data(), n, layers, blocks);
  f = fopen(argv[6], "wb");
  fwrite(z.data(), 4, z.size(), f);
  fwrite(ld.data(), 4, ld.size(), f);
  fclose(f);
  return 0;
}
"""

CHAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "instance.cpp"
namespace aspire { float4 smem4[232448 / 16]; }
using S = aspire::MmaShape<ROW_D, ROW_HID, ROW_K, ROW_RQS>;
// The instance's chain in the form launch_chain picks: wide, whole-layer
// resident, or (a streamed instance) whole-layer streamed.
template <bool PROGS>
void run_chain(const aspire::ChainArgs& a, int nt) {
  for (int b = 0; b < nt; ++b) {
    emu_run_block(b, 256, [&] {
      if constexpr (S::WIDE) {
        aspire::chain_kernel_wide<ROW_D, ROW_HID, ROW_K, ROW_RQS,
                                  PROGS, 1>(a);
      } else {
#ifdef ASPIRE_STREAMED
        aspire::chain_kernel_streamed<ROW_D, ROW_HID, ROW_K, ROW_RQS,
                                      PROGS, 1>(a);
#else
        aspire::chain_kernel<ROW_D, ROW_HID, ROW_K, ROW_RQS, PROGS,
                             1>(a);
#endif
      }
    });
  }
}
int main(int argc, char** argv) {
  constexpr int d = ROW_D;
  if (argc == 2) {  // the instance's layout table, then its constant block
    int v[16];
    int count = aspire_chain_layout(0, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n");
    count = aspire_consts_layout(d, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n");
    count = aspire_chain_plan(0, v, 16);
    for (int e = 0; e < count; ++e) printf("%d ", v[e]);
    printf("\n");
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]), steps = atoi(argv[3]);
  const int kernel = atoi(argv[4]), gm = atoi(argv[5]), go = atoi(argv[6]);
  const int rows = atoi(argv[7]), target = atoi(argv[8]);
  const float beta = atof(argv[9]), nu = atof(argv[10]);
  const float target_acc = atof(argv[11]), rate = atof(argv[12]);
  const float max_log_step = atof(argv[13]), tail = atof(argv[14]);
  const int programs = atoi(argv[17]);
  const long long seed[2] = {0, 0};
  int layout[8];
  const int nt = n / 256, cs = layout[aspire_consts_layout(d, layout, 8) - 1];
  std::vector<float> z0(d * n), w(layers * S::SIZE), c(cs), step0(nt);
  std::vector<float> noise((size_t)steps * rows * n);
  std::vector<float> z(d * n), lq(n), lpi(n), ll(n), nacc(n);
  // The wide chain's scratch at its plan's last level (ChainWidePlan):
  // the sums, the state arrays and the particle rows.
  std::vector<float> stats(nt * (4 * d + 1));
  std::vector<float> scratch((size_t)(6 * d + 1) * n, -7.f);
  FILE* f = fopen(argv[15], "rb");
  for (auto* v : {&z0, &w, &c, &step0, &noise}) {
    if (fread(v->data(), 4, v->size(), f) != v->size()) return 2;
  }
  fclose(f);
  aspire::ChainArgs a{z0.data(), w.data(), c.data(), step0.data(),
                      noise.data(), z.data(), lq.data(), lpi.data(),
                      ll.data(), nacc.data(), stats.data(), scratch.data(),
                      n, layers, steps, kernel, gm, go, rows, programs,
                      target, nu, target_acc, rate, max_log_step, tail,
                      &beta, seed};
  blockDim = {256, 1, 1};
  gridDim = {(unsigned)nt, 1, 1};
  if (programs == aspire::kPrograms) {
    run_chain<true>(a, nt);
  } else {
    run_chain<false>(a, nt);
  }
  f = fopen(argv[16], "wb");
  for (auto* v : {&z, &lq, &lpi, &ll, &nacc, &stats}) {
    fwrite(v->data(), 4, v->size(), f);
  }
  fclose(f);
  return 0;
}
"""

MAF = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "instance.cpp"
namespace aspire { float4 maf_smem4[232448 / 16]; }
using S = aspire::MafShape<ROW_D, ROW_HID, ROW_K>;
int main(int argc, char** argv) {
  if (argc == 2) {  // the instance's layout, then the streamed block's
    int ks[256];
    const int count = aspire_maf_ksteps(0, ks, 256);
    printf("%d %d", aspire_maf_layer_floats(0), aspire_maf_stage_floats(0));
    for (int e = 0; e < count; ++e) printf(" %d", ks[e]);
#ifdef ASPIRE_STREAMED
    int v[8];
    aspire_maf_stream_layout(0, v, 8);
    printf("\n%d %d %d %d %d %d\n", v[1], v[2],
           aspire::MafStream<ROW_D, ROW_HID, ROW_K>::NW, v[3], v[4], v[0]);
#else
    printf("\n");
#endif
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]);
  const int blocks = atoi(argv[3]), warps = atoi(argv[4]);
  std::vector<float> x(ROW_D * n), z(ROW_D * n, -1.f), ld(n, -1.f);
  std::vector<float> w(layers * S::SIZE);
  FILE* f = fopen(argv[5], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size()) return 2;
  if (fread(w.data(), 4, w.size(), f) != w.size()) return 3;
  fclose(f);
  blockDim = {(unsigned)(32 * warps), 1, 1};
  gridDim = {(unsigned)blocks, 1, 1};
  for (int b = 0; b < blocks; ++b) {
    emu_run_block(b, 32 * warps, [&] {
#ifdef ASPIRE_STREAMED
      if constexpr (aspire::maf_stream_level<ROW_D, ROW_HID, ROW_K>()) {
        aspire::maf_kernel_chunked<ROW_D, ROW_HID, ROW_K>(
            x.data(), z.data(), ld.data(), w.data(), n, layers, 5.0f);
      } else {
        aspire::maf_kernel_streamed<ROW_D, ROW_HID, ROW_K>(
            x.data(), z.data(), ld.data(), w.data(), n, layers, 5.0f);
      }
#else
      aspire::maf_kernel<ROW_D, ROW_HID, ROW_K>(
          x.data(), z.data(), ld.data(), w.data(), n, layers, 5.0f);
#endif
    });
  }
  f = fopen(argv[6], "wb");
  fwrite(z.data(), 4, z.size(), f);
  fwrite(ld.data(), 4, ld.size(), f);
  fclose(f);
  return 0;
}
"""

#: name -> (kind, harness, configuration row): the instances built at
#: first use (``_build.INSTANCE_SOURCES``; ``coupling_row``, ``chain_row``,
#: ``maf_row``)
BUILDS = {
    "coupling15": ("coupling", COUPLING, FC.coupling_row(nsf_tpu(15))),
    "coupling32": ("coupling", COUPLING, FC.coupling_row(nsf_tpu(32))),
    "chain15": ("chain", CHAIN, FM.chain_row(nsf_tpu(15))),
    "chain10": ("chain_streamed", CHAIN, FM.chain_row(nsf_tpu(10))),
    "maf15": ("maf_streamed", MAF, FC.maf_row(maf_rqs(15))),
    "maf6": ("maf_streamed", MAF,
             FC.maf_row(maf_rqs(6, n_hidden=(192, 192)))),
}

#: Hidden depths other than two: name -> (flow, the form it takes). Every
#: form at one and three hidden layers (B1/B3 whole-layer and wide; B2
#: resident, streamed and wide; B4 resident and streamed), no hidden layer
#: in B1/B3's form, B2's resident one and B4's resident one, and four
#: hidden layers in B1/B3's whole-layer form.
DEPTH_COUPLING = {
    "c1": (Coupling(dims=4, n_layers=2, n_hidden=(16,),
                    transformer="affine"), "whole-layer, 8 warps"),
    "c1wide": (nsf_tpu(15, n_hidden=(16,), n_layers=2), "wide, 8 warps"),
    "c3": (nsf_tpu(5, n_hidden=(16, 16, 16), n_layers=2),
           "whole-layer, 8 warps"),
    "c3wide": (nsf_tpu(15, n_hidden=(16, 16, 16), n_layers=2),
               "wide, 8 warps"),
    "c0": (nsf_tpu(5, n_hidden=(), n_layers=2), "linear, 8 warps"),
    "c4": (nsf_tpu(6, n_hidden=(16, 8, 16, 8), n_layers=2),
           "whole-layer, 8 warps"),
}
DEPTH_CHAIN = {
    "ch1": (nsf_tpu(4, n_hidden=(16,)), "whole-layer, resident"),
    "ch1s": (nsf_tpu(10, n_hidden=(64,), n_layers=4),
             "whole-layer, streamed"),
    "ch1wide": (nsf_tpu(15, n_hidden=(16,)), "wide"),
    "ch3": (nsf_tpu(4, n_hidden=(16, 16, 16)), "whole-layer, resident"),
    "ch3s": (nsf_tpu(8, n_hidden=(64, 64, 64), n_layers=4),
             "whole-layer, streamed"),
    "ch3wide": (nsf_tpu(15, n_hidden=(16, 16, 16)), "wide"),
    "ch0": (nsf_tpu(4, n_hidden=()), "whole-layer, resident"),
}
DEPTH_MAF = {
    "m1": (maf_rqs(4, n_hidden=(16,)), "resident"),
    "m1s": (maf_rqs(15, n_hidden=(64,)), "streamed"),
    "m3": (maf_rqs(4, n_hidden=(16, 16, 16)), "resident"),
    "m3s": (maf_rqs(15, n_hidden=(64, 64, 64)), "streamed"),
    "m0": (maf_rqs(5, n_hidden=()), "resident"),
}
BUILDS.update(
    {k: ("coupling", COUPLING, FC.coupling_row(a))
     for k, (a, _) in DEPTH_COUPLING.items()}
    | {k: ("chain" if FC.mma_wide(a) or FM.chain_resident(a)
           else "chain_streamed", CHAIN, FM.chain_row(a))
       for k, (a, _) in DEPTH_CHAIN.items()}
    | {k: ("maf" if form == "resident" else "maf_streamed", MAF,
           FC.maf_row(a)) for k, (a, form) in DEPTH_MAF.items()})


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes_emulated")
    gxx = cxx20_compiler(root)
    procs = {}
    for name, (kind, harness, row) in BUILDS.items():
        sub = root / name
        sub.mkdir()
        (sub / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME)
        shutil.copy(CSRC / "common.cuh", sub / "common.cuh")
        (sub / "instance.cpp").write_text(
            ("#define ASPIRE_STREAMED 1\n" if kind.endswith("_streamed")
             else "")
            + f"#define ASPIRE_INSTANCE_CONFIG(X) {_build.instance_row(row)}\n"
            + emulated_source(_build.INSTANCE_SOURCES[kind]))
        (sub / "harness.cpp").write_text(harness)
        values = [("true" if v else "false") if isinstance(v, bool) else
                  "aspire::Hidden<" + ",".join(map(str, v)) + ">"
                  if isinstance(v, tuple) else str(v) for v in row]
        defines = [f"-D{k}={v}" for k, v in zip(ROW.split(", "), values)]
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-w", *defines, f"-I{sub}", "-o",
             str(root / f"run_{name}"), str(sub / "harness.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, f"{name}: {out[-4000:]}"
    return root


def _lines(harness) -> list[list[int]]:
    out = subprocess.run([str(harness), "layout"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [[int(v) for v in line.split()] for line in out.splitlines()]


def _coupling(harnesses, name, arch, params, mode, x, warps):
    n, d = x.shape
    packed = FC.prepare_mma_params(arch, params)
    inp = harnesses / f"in_{name}_{mode}_{n}.bin"
    out = harnesses / f"out_{name}_{mode}_{n}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).astype(
        np.float32).tofile(inp)
    subprocess.run([str(harnesses / f"run_{name}"), str(n),
                    str(arch.n_layers), str(int(mode == "forward")),
                    str(warps), str(inp), str(out)], check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    return packed, res[:d * n].reshape(n, d), res[d * n:]


@pytest.mark.parametrize("name,arch", [
    ("coupling15", nsf_tpu(15)), ("coupling32", nsf_tpu(32))])
def test_instance_layout_tables_match_python(harnesses, name, arch):
    """A coupling instance's layout table (the C entry the wrapper checks
    at launch) equals the Python packing's, with the form the Python rule
    picks: the wide form at d = 15 and d = 32 (the chain's block of 8
    whole-layer warp buffers does not fit)."""
    table, (wide,) = _lines(harnesses / f"run_{name}")
    assert table == [*FC.mma_layout(arch), FC.coupling_warps(arch)]
    assert wide == FC.mma_wide(arch) == 1


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("name,arch,n,warps", [
    ("coupling15", nsf_tpu(15, n_layers=2), 64, 2),
    ("coupling32", nsf_tpu(32, n_layers=2), 32 + 5, 1)])
def test_instance_coupling_matches_plain(harnesses, name, arch, n, warps,
                                         mode):
    """B1 (density) and B3 (sampling) of the instance, cut to 2 layers so
    the stand-in stays quick: d = 15 on a full block of two warps, d = 32
    on a ragged one, against the plain pass (card tolerance, float64
    arbitration) and the packed reader."""
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 7, arch,
                                             0.05)
    x = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, arch.dims)).astype(np.float32))
    packed, y, ld = _coupling(harnesses, name, arch, params, mode, x, warps)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated {name} {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated {name} {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


def _chain_plan(arch) -> list[int]:
    """What the instance's ``aspire_chain_plan`` reports: the wide block's
    level and floats (``FM.chain_wide_plan``), ``[-1, 0]`` otherwise."""
    if not FC.mma_wide(arch):
        return [-1, 0]
    plan = FM.chain_wide_plan(arch)
    return [plan["level"], plan["floats"]]


def _chain(harnesses, name, setup):
    cfg, params, z0, beta, step0, refs, target, dt, gen = setup
    arch = cfg.arch
    n, d = z0.shape
    noise = torch.rand((cfg.n_steps, cfg.noise_rows, n),
                       generator=gen).clamp(1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=noise,
                           return_acc_probs=True)
    chip_smoke.nudge_accept_uniforms(noise, plain[-1])
    consts = FM.chain_consts(d, *refs, FM.program_block(dt, d, "cpu"),
                             FM.program_block(None, d, "cpu"), target[1])
    inputs = [z0, FM.prepare_chain_params(arch, params), consts, step0,
              noise]
    inp, out = harnesses / f"in_{name}.bin", harnesses / f"out_{name}.bin"
    np.concatenate([t.numpy().ravel() for t in inputs]).astype(
        np.float32).tofile(inp)
    args = [n, arch.n_layers, cfg.n_steps, FM.KERNELS[cfg.kernel],
            cfg.gamma_m, cfg.gamma_odd, cfg.noise_rows, int(target[0]), beta,
            cfg.nu, cfg.target_acceptance, cfg.adaptation_rate,
            cfg.max_log_step, arch.tail_bound, inp, out,
            FM.program_level(dt, None)]
    subprocess.run([str(harnesses / f"run_{name}"), *map(str, args)],
                   check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, rest = res[:d * n].reshape(n, d), res[d * n:]
    lq, lpi, ll, nacc = rest[:4 * n].reshape(4, n)
    stats = rest[4 * n:].reshape(n // FM.TILE, 4 * d + 1)
    kern = (z, lq, lpi, ll, nacc, stats[:, 0].clone(), stats)
    chip_smoke.assert_chain_close(kern, plain)
    assert 0 < float(nacc.sum()) < n * cfg.n_steps


def test_instance_chain_tables_match_python(harnesses):
    """The chain instances' layout tables and constant blocks equal the
    Python packing's: the wide form at d = 15, the whole-layer form at
    d = 10."""
    for name, arch in (("chain15", nsf_tpu(15)), ("chain10", nsf_tpu(10))):
        table, consts, plan = _lines(harnesses / f"run_{name}")
        assert table == list(FM.chain_layout(arch))
        assert consts == list(FM.consts_layout(arch.dims))
        assert plan == _chain_plan(arch)
    assert FC.mma_wide(nsf_tpu(15)) and not FC.mma_wide(nsf_tpu(10))
    assert FM.chain_form(nsf_tpu(10)) == "whole-layer, streamed"


def test_instance_wide_chain_at_odd_d_matches_plain(harnesses):
    """B2 in the wide form at d = 15 (nsf-tpu's widths cut to 2 layers):
    one tile, two tpCN steps on the mixture with the affine data
    transform, on injected noise nudged as ``chip_smoke.phase_chain``
    nudges it, at the card check's tolerances."""
    _chain(harnesses, "chain15", chip_smoke.shapes_chain_setup(
        torch.device("cpu"), FM.TILE, 2, nsf_tpu(15, n_layers=2)))


def test_instance_streamed_chain_matches_plain(harnesses):
    """B2's whole-layer form streaming its layers, its instance of its own
    (nsf-tpu at d = 10: three layers do not fit one block beside its 8
    warp buffers), one tile, two steps, as above."""
    arch = nsf_tpu(10)
    assert not FM.chain_resident(arch)
    _chain(harnesses, "chain10", chip_smoke.shapes_chain_setup(
        torch.device("cpu"), FM.TILE, 2, arch))


@pytest.mark.parametrize("name,arch", [
    ("maf15", maf_rqs(15, n_layers=2)),
    ("maf6", maf_rqs(6, n_layers=2, n_hidden=(192, 192)))])
def test_instance_streamed_maf_matches_plain(harnesses, name, arch):
    """B4's streamed form at maf_rqs(15) ((64, 64), 8 bins: W2 one chunk)
    and at d = 6 with (192, 192) (W2 in chunks of n-tiles, the first
    layer recomputed for each), 2 layers: its layout and block against
    the Python mirror, then 5 tiles (the last ragged) over 2 blocks of 2
    warps (one idle tile) against the plain pass (card tolerance, float64
    arbitration) and the packed reader."""
    d = arch.dims
    (layer, stage, *ksteps), block = _lines(harnesses / f"run_{name}")
    ks2, ks3 = FC.maf_ksteps(arch)
    assert [layer, stage, *ksteps] == [FC.maf_layer_floats(arch),
                                       FC.maf_stage_floats(arch), *ks2, *ks3]
    layout = FC.maf_stream_layout(arch)
    assert block == [layout[k] for k in ("slot", "head", "w2_chunks",
                                         "stage", "bufs", "level")]
    assert layout["w2_chunks"] == (1 if d == 15 else 7)
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 9, arch,
                                             0.05)
    n = 4 * 16 + 7
    x = 2.0 * torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, d)).astype(np.float32))
    packed = FC.prepare_maf_params(arch, params)
    inp = harnesses / f"in_{name}.bin"
    out = harnesses / f"out_{name}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).tofile(inp)
    subprocess.run([str(harnesses / f"run_{name}"), str(n),
                    str(arch.n_layers), "2", "2", str(inp), str(out)],
                   check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, ld = res[:d * n].reshape(n, d), res[d * n:]
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(z, z_p, z_e, f"emulated {name} z")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e, f"emulated {name} log_det")
    z_r, ld_r = FC.maf_packed_plain(arch, packed, x)
    torch.testing.assert_close(z, z_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


@pytest.mark.parametrize("name", DEPTH_COUPLING)
def test_depth_coupling_tables_and_forms(harnesses, name):
    """A coupling instance at another hidden depth: its layout table (the
    extra hidden products' offsets before the warps) equals the Python
    packing's, its form the Python rule's, the one named."""
    arch, form = DEPTH_COUPLING[name]
    table, (wide,) = _lines(harnesses / f"run_{name}")
    assert table == [*FC.mma_layout(arch), FC.coupling_warps(arch)]
    assert wide == FC.mma_wide(arch)
    assert FC.mma_form(arch) == form


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("name", DEPTH_COUPLING)
def test_depth_coupling_matches_plain(harnesses, name, mode):
    """B1 (density) and B3 (sampling) at one, three, four and no hidden
    layers, in the whole-layer and the wide form, on a ragged block of two
    warps, against the plain pass (card tolerance, float64 arbitration)
    and the packed reader."""
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 7,
                                             DEPTH_COUPLING[name][0], 0.05)
    n = 64 - 5
    x = torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, arch.dims)).astype(np.float32))
    packed, y, ld = _coupling(harnesses, name, arch, params, mode, x, 2)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated {name} {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated {name} {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


@pytest.mark.parametrize("name", DEPTH_CHAIN)
def test_depth_chain_matches_plain(harnesses, name):
    """B2 at one, three and no hidden layers in each of its forms (the
    whole-layer chain resident and streaming its layers, the wide chain):
    its layout table and constant block against the Python packing, then
    one tile, two tpCN steps on the mixture with the affine data transform
    on injected noise (three layers, or the flow's own depth where it has
    fewer) against the plain chain at the card check's tolerances."""
    arch, form = DEPTH_CHAIN[name]
    table, consts, plan = _lines(harnesses / f"run_{name}")
    assert table == list(FM.chain_layout(arch))
    assert consts == list(FM.consts_layout(arch.dims))
    assert plan == _chain_plan(arch)
    assert FM.chain_form(arch) == form
    run = dataclasses.replace(arch, n_layers=min(arch.n_layers, 3))
    _chain(harnesses, name, chip_smoke.shapes_chain_setup(
        torch.device("cpu"), FM.TILE, 2, run))


@pytest.mark.parametrize("name", DEPTH_MAF)
def test_depth_maf_matches_plain(harnesses, name):
    """B4 at one, three and no hidden layers, resident and streamed: its
    layout (the k-steps of every hidden product, then W3's) and the
    streamed block against the Python mirror, then 2 layers on 5 tiles
    (the last ragged) over 2 blocks of 2 warps against the plain pass
    (card tolerance, float64 arbitration) and the packed reader."""
    arch, form = DEPTH_MAF[name]
    assert FC.maf_form(arch) == form
    (layer, stage, *ksteps), *block = _lines(harnesses / f"run_{name}")
    assert [layer, stage, *ksteps] == [FC.maf_layer_floats(arch),
                                       FC.maf_stage_floats(arch),
                                       *sum(FC.maf_ksteps(arch), ())]
    if form == "streamed":
        (block,) = block
        layout = FC.maf_stream_layout(arch)
        assert block == [layout[k] for k in ("slot", "head", "w2_chunks",
                                             "stage", "bufs", "level")]
    arch, params = chip_smoke.perturbed_flow(
        torch.device("cpu"), 9, dataclasses.replace(arch, n_layers=2), 0.05)
    d, n = arch.dims, 4 * 16 + 7
    x = 2.0 * torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, d)).astype(np.float32))
    packed = FC.prepare_maf_params(arch, params)
    inp = harnesses / f"in_{name}.bin"
    out = harnesses / f"out_{name}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).tofile(inp)
    subprocess.run([str(harnesses / f"run_{name}"), str(n),
                    str(arch.n_layers), "2", "2", str(inp), str(out)],
                   check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, ld = res[:d * n].reshape(n, d), res[d * n:]
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(z, z_p, z_e, f"emulated {name} z")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e, f"emulated {name} log_det")
    z_r, ld_r = FC.maf_packed_plain(arch, packed, x)
    torch.testing.assert_close(z, z_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)
