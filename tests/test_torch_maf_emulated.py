"""The MAF kernel's CUDA source (``csrc/maf.cu``), run on the CPU.

The machine that runs the tests has no ``nvcc`` and no card, so the
kernel's lane-level logic (the mma fragment layouts, the accumulator
reused as the next product's operand, the masked blocks, the per-warp
buffers, the ragged last tile, the persistent tile loop) would otherwise
be checked only on the card. Here the unchanged source is compiled as
C++ with a small stand-in for the CUDA runtime: each CUDA thread a fiber
(a stack of its own) on the harness's one OS thread, switched at the
barriers for ``__syncthreads``/``__syncwarp`` (``emu_run_block``), and the
warp's ``mma.sync`` m16n8k8 TF32 computed from all 32 lanes' fragments
(operands cut to their top 19 bits, as the tensor core reads them). The
result is held against ``MAF.forward_plain`` at the card check's
tolerance (``chip_smoke.COUPLING_TOL`` with float64 arbitration) and
against ``maf_packed_plain``; the kernel's layout tables, as the compiled
source reports them, against the Python packing's. Skips where no ``g++``
with C++20 ``<barrier>`` is installed.
"""

import platform
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import maf_rqs
from aspire_tpu_torch.ops import fused_coupling as FC

CSRC = Path(__file__).resolve().parent.parent / "aspire_tpu_torch" / "csrc"

RUNTIME = r"""
#pragma once
#include <sys/mman.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct dim3s { unsigned x, y, z; };
// The running CUDA thread's indices: set by the block's scheduler
// (emu_run_block) each time it resumes a thread.
inline dim3s threadIdx, blockIdx;
inline dim3s blockDim, gridDim;
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float __uint_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u; std::memcpy(&u, &f, 4); return u;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
// A block's CUDA threads are fibers on the harness's one OS thread: each
// runs on a stack of its own until it waits at a barrier, then the
// scheduler resumes the next thread (in threadIdx order, wrapping) whose
// barrier has completed since it arrived; the last thread to arrive goes
// on at once. A wait that no thread can complete aborts (a deadlock on
// the card too). Barriers are __syncthreads (the block's), __syncwarp
// (its warp's 32 lanes) and bar.sync id (emu_named, emu_named_threads[id]
// threads each).
struct EmuBarrier { int count = 0, arrived = 0; unsigned gen = 0; };
// cp.async as the card orders it: a thread's copies land at its wait that
// covers them (wait_all, or wait_group N once N or fewer of its newer
// committed groups are left), and until then their destination reads as
// NaN; so a kernel that reads a chunk before its wait, or lets a copy
// overwrite a slot a warp still reads, computes on NaN here too.
struct EmuCopy { float* dst; const float* src; };
struct EmuCopies {
  std::vector<EmuCopy> open;
  std::vector<std::vector<EmuCopy>> groups;
};
struct EmuFiber {
  void* sp = nullptr;
  char* stack = nullptr;
  EmuBarrier* wait = nullptr;
  unsigned gen = 0;
  bool done = false;
  EmuCopies copies;
};
constexpr size_t kEmuStack = size_t(1) << 20;  // a guard page at its end
inline std::vector<EmuFiber> emu_fibers;
inline int emu_cur = -1;  // the running fiber, -1 outside a block
inline void* emu_main_sp;
inline std::function<void()> emu_body;
inline EmuCopies emu_main_copies;
inline EmuBarrier emu_block;
inline std::vector<EmuBarrier> emu_warp, emu_named;
inline std::vector<int> emu_named_threads;
struct EmuLanes { float f[2][32][6], d[2][32][4]; };
inline std::vector<EmuLanes> emu_lanes;
// emu_switch(from, to): save the callee-saved registers on this stack and
// its pointer at *from, then resume the stack `to` (x86-64 System V).
extern "C" void emu_switch(void** from, void* to);
asm(".text\n.globl emu_switch\n.type emu_switch, @function\n"
    "emu_switch:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n"
    "  pushq %r14\n  pushq %r15\n"
    "  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n"
    "  popq %rbx\n  popq %rbp\n  ret\n"
    ".size emu_switch, .-emu_switch\n");
[[noreturn]] inline void emu_fiber_main() {
  emu_body();
  emu_fibers[emu_cur].done = true;
  emu_switch(&emu_fibers[emu_cur].sp, emu_main_sp);
  std::abort();
}
inline EmuCopies& emu_copies() {
  return emu_cur < 0 ? emu_main_copies : emu_fibers[emu_cur].copies;
}
// Arrive at b and wait for its other threads; true for the last to arrive,
// which goes on at once.
inline bool emu_arrive(EmuBarrier& b) {
  if (++b.arrived == b.count) {
    b.arrived = 0;
    ++b.gen;
    return true;
  }
  EmuFiber& f = emu_fibers[emu_cur];
  f.wait = &b;
  f.gen = b.gen;
  emu_switch(&f.sp, emu_main_sp);
  f.wait = nullptr;
  return false;
}
inline bool emu_runnable(const EmuFiber& f) {
  return !f.done && (f.wait == nullptr || f.wait->gen != f.gen);
}
// Block `block` of `threads` CUDA threads (whole warps), each running
// `body`, to the end of the last.
inline void emu_run_block(unsigned block, int threads,
                          std::function<void()> body) {
  blockIdx = {block, 0, 0};
  emu_block = EmuBarrier{threads};
  emu_warp.assign(threads / 32, EmuBarrier{32});
  emu_lanes.assign(threads / 32, EmuLanes{});
  emu_named.assign(emu_named_threads.size(), EmuBarrier{});
  for (size_t i = 0; i < emu_named.size(); ++i)
    emu_named[i].count = emu_named_threads[i];
  emu_body = std::move(body);
  if ((int)emu_fibers.size() < threads) emu_fibers.resize(threads);
  for (int t = 0; t < threads; ++t) {
    EmuFiber& f = emu_fibers[t];
    if (f.stack == nullptr) {
      void* m = mmap(nullptr, kEmuStack, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
      if (m == MAP_FAILED) std::abort();
      f.stack = static_cast<char*>(m);
      mprotect(f.stack, 4096, PROT_NONE);
    }
    f.wait = nullptr;
    f.done = false;
    f.copies = EmuCopies{};
    // The first resume "returns" into emu_fiber_main with the stack
    // aligned as at a function's entry.
    void** sp = reinterpret_cast<void**>(
        reinterpret_cast<uintptr_t>(f.stack + kEmuStack) & ~uintptr_t(15));
    *--sp = nullptr;
    *--sp = reinterpret_cast<void*>(&emu_fiber_main);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;
    f.sp = sp;
  }
  int live = threads, t = threads - 1;
  while (live > 0) {
    int tried = 0;
    do {
      t = (t + 1) % threads;
    } while (!emu_runnable(emu_fibers[t]) && ++tried < threads);
    if (!emu_runnable(emu_fibers[t])) {
      fprintf(stderr, "emulated block %u: every live thread waits\n", block);
      std::abort();
    }
    emu_cur = t;
    threadIdx = {(unsigned)t, 0, 0};
    emu_switch(&emu_main_sp, emu_fibers[t].sp);
    if (emu_fibers[t].done) --live;
  }
  emu_cur = -1;
}
inline void __syncthreads() { emu_arrive(emu_block); }
inline void __syncwarp() { emu_arrive(emu_warp[threadIdx.x / 32]); }
inline void emu_bar_sync(int id, int threads) {
  if (emu_named_threads.at(id) != threads) std::abort();
  emu_arrive(emu_named[id]);
}
inline void emu_cp_async16(float* dst, const float* src) {
  for (int i = 0; i < 4; ++i) dst[i] = NAN;
  emu_copies().open.push_back({dst, src});
}
inline void emu_cp_async_commit() {
  EmuCopies& c = emu_copies();
  c.groups.push_back(std::move(c.open));
  c.open.clear();
}
inline void emu_cp_async_wait_group(size_t pending) {
  EmuCopies& c = emu_copies();
  while (c.groups.size() > pending) {
    for (const EmuCopy& e : c.groups.front()) std::memcpy(e.dst, e.src, 16);
    c.groups.erase(c.groups.begin());
  }
}
inline void emu_cp_async_wait_all() {
  emu_cp_async_commit();
  emu_cp_async_wait_group(0);
}
// A warp-wide exchange takes one barrier: the lanes write their part into
// the warp's buffer of the barrier's phase (its generation's parity), the
// last lane to arrive computes what the warp's op gives (emu_arrive returns
// true for it, before any lane resumes), and each lane then reads its
// result; a lane's next op writes the other phase's buffer, which no lane
// reads until every lane has arrived there.
inline void emu_shfl_post(float v) {
  const int w = threadIdx.x / 32;
  emu_lanes[w].f[emu_warp[w].gen & 1][threadIdx.x % 32][0] = v;
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x / 32, ph = emu_warp[w].gen & 1;
  emu_shfl_post(v);
  __syncwarp();
  return emu_lanes[w].f[ph][(threadIdx.x % 32) ^ mask][0];
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 over the warp.
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  EmuLanes& L = emu_lanes[w];
  const int ph = emu_warp[w].gen & 1;
  float* me = L.f[ph][l];
  for (int r = 0; r < 4; ++r) me[r] = __uint_as_float(a[r] & 0xFFFFE000u);
  me[4] = __uint_as_float(b0 & 0xFFFFE000u);
  me[5] = __uint_as_float(b1 & 0xFFFFE000u);
  for (int r = 0; r < 4; ++r) L.d[ph][l][r] = d[r];
  if (emu_arrive(emu_warp[w])) {
    auto A = [&](int row, int k) {
      return L.f[ph][(row % 8) * 4 + k % 4][(row < 8 ? 0 : 1) +
                                            (k < 4 ? 0 : 2)];
    };
    auto B = [&](int k, int col) {
      return L.f[ph][col * 4 + k % 4][k < 4 ? 4 : 5];
    };
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane / 4, t = lane % 4;
      const int rows[4] = {g, g, g + 8, g + 8};
      const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
      for (int r = 0; r < 4; ++r) {
        float acc = L.d[ph][lane][r];
        for (int k = 0; k < 8; ++k)
          acc = std::fma(A(rows[r], k), B(k, cols[r]), acc);
        L.d[ph][lane][r] = acc;
      }
    }
  }
  for (int r = 0; r < 4; ++r) d[r] = L.d[ph][l][r];
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int*) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <thread>
#include "maf_emulated.cpp"
namespace aspire { float4 maf_smem4[232448 / 16]; }
int main(int argc, char** argv) {
  if (argc == 2) {  // the layout: configuration 0's C entries, then H's
    int ks[256];
    const int count = aspire_maf_ksteps(0, ks, 256);
    printf("%d %d", aspire_maf_layer_floats(0), aspire_maf_stage_floats(0));
    for (int e = 0; e < count; ++e) printf(" %d", ks[e]);
    using B = aspire::MafShape<4, aspire::Hidden<H, H>, 8>;
    printf("\n%d %d", B::SIZE, B::STAGE);
    for (int j = 0; j < H / 8; ++j) printf(" %d", B::ks2(j));
    for (int i = 0; i < 4; ++i) printf(" %d", B::ks3(i));
    printf("\n");
    return 0;
  }
  const int n = atoi(argv[1]), layers = atoi(argv[2]);
  const int blocks = atoi(argv[3]), warps = atoi(argv[4]);
  using S = aspire::MafShape<4, aspire::Hidden<H, H>, 8>;
  std::vector<float> x(4 * n), z(4 * n, -1.f), ld(n, -1.f);
  std::vector<float> w(layers * S::SIZE);
  FILE* f = fopen(argv[5], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size()) return 2;
  if (fread(w.data(), 4, w.size(), f) != w.size()) return 3;
  fclose(f);
  blockDim = {(unsigned)(32 * warps), 1, 1};
  gridDim = {(unsigned)blocks, 1, 1};
  for (int b = 0; b < blocks; ++b) {
    emu_run_block(b, 32 * warps, [&] {
      aspire::maf_kernel<4, aspire::Hidden<H, H>, 8>(
          x.data(), z.data(), ld.data(), w.data(), n, layers, 5.0f);
    });
  }
  f = fopen(argv[6], "wb");
  fwrite(z.data(), 4, z.size(), f);
  fwrite(ld.data(), 4, ld.size(), f);
  fclose(f);
  return 0;
}
"""


SPLIT_PRODUCTS = """  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);"""

#: The source's inline PTX besides the mma, each function's stand-in
#: body: a cp.async copy lands at the thread's wait that covers it
#: (``emu_cp_async16``: its destination reads as NaN until then;
#: ``cp.async.commit_group``, ``wait_group N``, ``wait_all``); a named
#: barrier (bar.sync id, threads) as the runtime's barrier of that id.
PTX_STAND_INS = {
    "cp_async16": "emu_cp_async16(dst, src);",
    "cp_async_commit": "emu_cp_async_commit();",
    "cp_async_wait_group": "emu_cp_async_wait_group(N);",
    "cp_async_wait_all": "emu_cp_async_wait_all();",
    "named_barrier": "emu_bar_sync(id, threads);",
}


def _inline_headers(src: str) -> str:
    """``src`` with each csrc header it includes but ``common.cuh`` (which
    the harnesses copy) pasted in place, so its PTX is routed too."""
    def paste(match):
        if match[1] == "common.cuh":
            return match[0]
        return _inline_headers((CSRC / match[1]).read_text())
    return re.sub(r'#include "(\w+\.cuh)"', paste, src)


def emulated_source(name: str, single_pass: bool = False) -> str:
    """csrc/``name``, with the csrc headers it includes pasted in, its
    inline PTX routed to the emulation (the mma, and the cp.async copies
    of ``PTX_STAND_INS``), and the launch syntax (host code the harness
    bypasses) removed; with ``single_pass`` (maf.cu), each block takes one
    TF32 product (hi . hi) instead of the three of the split form."""
    src = _inline_headers((CSRC / name).read_text())
    if single_pass:
        assert src.count(SPLIT_PRODUCTS) == 1
        src = src.replace(SPLIT_PRODUCTS, "  mma_tf32(d, ah, bh0, bh1);")
    src, n_mma = re.subn(
        r"(void mma_tf32\(float \(&d\)\[4\], const uint32_t \(&a\)\[4\],"
        r"\s*uint32_t b0, uint32_t b1\)) \{.*?\n\}\n",
        r"\1 { emu_mma(d, a, b0, b1); }\n", src, flags=re.S)
    assert n_mma == 1, f"mma_tf32 not found in {name}"
    for fn, body in PTX_STAND_INS.items():
        src = re.sub(rf"(void {fn}\([^)]*\)) \{{.*?\n\}}\n",
                     rf"\1 {{ {body} }}\n", src, flags=re.S)
    assert not re.search(r"\basm\b", src), (
        f"{name} has inline PTX the emulation lacks")
    return re.sub(r"<<<[^>]*>>>", "", src)


def cxx20_compiler(root: Path) -> str:
    """A g++ that has C++20 (``<barrier>`` its probe) on x86-64 (the
    stand-in runtime's fiber switch), or skip the calling test."""
    if platform.machine() != "x86_64":
        pytest.skip("the stand-in runtime switches fibers in x86-64 "
                    "assembly")
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    probe = root / "barrier_probe.cpp"
    probe.write_text("#include <barrier>\nint main() { return 0; }\n")
    if subprocess.run([gxx, "-std=c++20", "-fsyntax-only", str(probe)],
                      capture_output=True).returncode:
        pytest.skip("needs a g++ with C++20 <barrier> for the stand-in "
                    "CUDA runtime")
    return gxx


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    root = tmp_path_factory.mktemp("maf_emulated")
    gxx = cxx20_compiler(root)
    builds = {"16": (16, False), "64": (64, False), "64_single": (64, True)}
    procs = {}
    for name, (h, single) in builds.items():
        sub = root / name
        sub.mkdir()
        (sub / "cuda_runtime.h").write_text(RUNTIME)
        shutil.copy(CSRC / "common.cuh", sub / "common.cuh")
        (sub / "maf_emulated.cpp").write_text(emulated_source("maf.cu",
                                                              single))
        (sub / "harness.cpp").write_text(HARNESS)
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-DH={h}",
             f"-I{sub}", "-o", str(root / f"harness{name}"),
             str(sub / "harness.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for h, proc in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out[-4000:]
    return root


def _run(root, build: str, arch, params, x, blocks: int, warps: int):
    """The emulated kernel on x: (z, log_det)."""
    n = x.shape[0]
    packed = FC.prepare_maf_params(arch, params)
    inp, out = root / f"in_{build}_{n}.bin", root / f"out_{build}_{n}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).tofile(inp)
    subprocess.run([str(root / f"harness{build}"), str(n),
                    str(arch.n_layers), str(blocks), str(warps), str(inp),
                    str(out)], check=True, timeout=300)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    return res[:4 * n].reshape(n, 4), res[4 * n:]


def _case(hidden: int, n_layers: int, n: int):
    arch, params = chip_smoke.perturbed_flow(
        torch.device("cpu"), seed=hidden + n_layers,
        arch=maf_rqs(4, n_layers=n_layers, n_hidden=(hidden, hidden)))
    x = 2.0 * torch.as_tensor(
        np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32))
    return arch, params, x


@pytest.mark.parametrize("hidden", [16, 64])
def test_kernel_layout_tables_match_python(harnesses, hidden):
    """The kernel's own layout, as MafShape/MafBlocks compute it and the C
    entries the wrapper checks at launch report it: floats per layer and
    per warp buffer, and the k-steps of every W2 n-tile and W3 dim, equal
    the Python packing's (``maf_layer_floats``, ``maf_stage_floats``,
    ``maf_ksteps``), for configuration 0 and for this build's widths."""
    lines = subprocess.run([str(harnesses / f"harness{hidden}"), "layout"],
                           check=True, capture_output=True, text=True,
                           timeout=60).stdout.splitlines()
    for line, arch in ((lines[0], maf_rqs(4)),
                       (lines[1], maf_rqs(4, n_hidden=(hidden, hidden)))):
        ks2, ks3 = FC.maf_ksteps(arch)
        want = [FC.maf_layer_floats(arch), FC.maf_stage_floats(arch),
                *ks2, *ks3]
        assert [int(v) for v in line.split()] == want


@pytest.mark.parametrize("hidden,n_layers,n,blocks,warps", [
    (64, 4, 100, 3, 2),   # maf_rqs(4): 7 tiles, the last ragged
    (64, 2, 16, 2, 2),    # one tile, idle warps
    (16, 3, 77, 2, 3),    # another shape of the same layout
])
def test_maf_kernel_source_matches_plain(harnesses, hidden, n_layers, n,
                                         blocks, warps):
    arch, params, x = _case(hidden, n_layers, n)
    z, ld = _run(harnesses, str(hidden), arch, params, x, blocks, warps)
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(z, z_p, z_e, "emulated MAF z")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e, "emulated MAF log_det")
    z_r, ld_r = FC.maf_packed_plain(arch, FC.prepare_maf_params(arch, params),
                                    x)
    torch.testing.assert_close(z, z_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


def test_single_pass_tf32_misses_the_card_tolerance(harnesses):
    """Why the kernel takes three TF32 products per block: with one (the
    operands rounded to TF32 alone), its maf_rqs(4) density pass misses
    the card check's tolerance against the float32 plain path, with no
    float64 arbitration to excuse it."""
    arch, params, x = _case(64, 4, 300)
    z, _ = _run(harnesses, "64_single", arch, params, x, 3, 2)
    z_p, _ = arch.forward_plain(params, x)
    z_e, _ = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    with pytest.raises(AssertionError, match="beyond tolerance"):
        chip_smoke.assert_kernel_close(z, z_p, z_e, "single-pass MAF z")


ORDER_PROBE = r"""
#include <cstdio>
#include "cuda_runtime.h"
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  emu_cp_async16(dst, src);
}
int main() {
  float src[12], dst[12];
  for (int i = 0; i < 12; ++i) src[i] = dst[i] = (float)i;
  cp_async16(dst, src + 8);  // group 0
  emu_cp_async_commit();
  cp_async16(dst + 4, src);  // group 1
  emu_cp_async_commit();
  cp_async16(dst + 8, src + 4);  // not committed
  printf("%d", std::isnan(dst[0]) && std::isnan(dst[4]) && std::isnan(dst[8]));
  emu_cp_async_wait_group(1);  // the newest committed group may pend
  printf(" %g %d", dst[0], (int)std::isnan(dst[4]));
  emu_cp_async_wait_all();
  printf(" %g %g\n", dst[4], dst[8]);
  return 0;
}
"""


def test_stand_in_copies_land_at_their_wait(tmp_path):
    """The stand-in runtime orders ``cp.async`` as the card does: a copy's
    destination reads as NaN until the copying thread's wait covers it,
    ``wait_group N`` leaving the newest N committed groups pending and
    ``wait_all`` none (so the emulated kernels fail where one reads a
    slot before its wait)."""
    gxx = cxx20_compiler(tmp_path)
    (tmp_path / "cuda_runtime.h").write_text(RUNTIME)
    (tmp_path / "probe.cpp").write_text(ORDER_PROBE)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", f"-I{tmp_path}", "-o",
                    str(tmp_path / "probe"), str(tmp_path / "probe.cpp")],
                   check=True)
    out = subprocess.run([str(tmp_path / "probe")], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.split()
    assert out == ["1", "8", "1", "0", "4"]
