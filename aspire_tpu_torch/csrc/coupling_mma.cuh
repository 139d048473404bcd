// The coupling-flow pass on the tensor cores, shared by the coupling-flow
// kernel (coupling.cu, B1/B3) and the whole-chain kernel (chain.cu, B2).
//
// A warp carries 32 particles, lane l holding particle l's coordinates.
// The conditioner has any number NH of hidden layers (MmaShape's Hidden
// list). Per coupling layer its products past the first, each hidden
// product h_j . WH_j and the output h_{NH-1} . W3, run as mma.sync m16n8k8
// TF32 over the warp's two 16-row tiles in split form (3xTF32: every
// operand a = hi + lo in two TF32 values, each product lo.hi + hi.lo +
// hi.hi), which keeps float32 accuracy; each weight fragment is read from
// shared memory once for both row tiles. The packed weights of those
// products are sums of two TF32 values (ops/fused_coupling.py::
// split_tf32_sum), so their split is exact, and are stored in the mma
// B-fragment order with the k order that makes one product's accumulator
// the next one's A fragment: the hidden layers never leave the warp's
// registers. W1 (the C conditioning inputs) stays on FP32 FMAs, its
// output h_0 made k-step by k-step straight into the first tensor product
// (the first hidden product, or with one hidden layer the output); the
// inputs reach the fragment rows by warp shuffles. The transformer
// parameters go from the accumulator fragments to their particle's thread
// through a per-warp shared buffer, and each thread runs the A
// transformers (rqs or affine of common.cuh) of its own particle. With no
// hidden layer the conditioner is one product on FP32 FMAs, each thread
// its own particle's (linear_layer).
//
// That whole-layer form keeps a layer's weights in shared memory and the
// warp's two row tiles of each product's input and output in registers.
// Where the output's accumulators would push a thread past 128 floats
// (MmaShape::BY_DIM: nsf-tpu at d = 5), it computes the output layer one
// active dim's parameter group at a time into the warp's buffer, then the
// transformers (the last hidden layer is dead by then, as in the one-pass
// output). At an odd D both halves take (D + 1) / 2 dims: the last slot of
// an odd layer's active half and of an even layer's conditioning half is
// dim D, a padding slot (zero weights, read as 0, never transformed).
// Where those do not fit (MmaShape::WIDE: BASELINE config 5's d = 32,
// (128, 128) flow needs 273 KB per layer and 512 accumulator floats per
// thread), the wide form (coupling_layer_wide) streams each layer through
// the block's shared memory in chunks, takes one 16-row tile at a time,
// computes the output layer by groups of two active dims and applies their
// transformers at once, the warp's particles kept in shared memory.

#pragma once

#include "common.cuh"

namespace aspire {

// Shared memory one block may hold on an H100 (227 KB, the opt-in
// maximum), in floats: the forms below are chosen against it.
constexpr int kMaxBlockFloats = 232448 / 4;
// Most warps in a block of the coupling kernel; the warps of the chain
// kernel's block (its 256-particle tile).
constexpr int kMaxCouplingWarps = 8;
constexpr int kChainBlockWarps = 8;
// The wide form's chunks of W2 and W3 aim at this many floats (16 KB).
constexpr int kChunkFloats = 4096;

// The chain kernel's constant block at D, in floats (chain.cu Consts<D>).
__host__ __device__ constexpr int chain_consts_floats(int d) {
  return round4(d + 2 * d * d + 2 * (8 * d + 3) + 2 * d + 2 + 1 + 2 + 2);
}

// The most k-steps (up to `most`, halving) that divide `steps` and keep a
// chunk of `floats_per_step` floats a k-step within kChunkFloats; 1 where
// none does.
__host__ __device__ constexpr int chunk_steps(int steps, int most,
                                              int floats_per_step) {
  for (int k = most; k > 1; k /= 2) {
    if (steps % k == 0 && k * floats_per_step <= kChunkFloats) return k;
  }
  return 1;
}

// Packed weight layout (built by ops/fused_coupling.py::prepare_mma_params),
// per coupling layer, every section starting on a multiple of 4 floats.
// Layer l transforms the A = (D + 1) / 2 active dims 2a + (l & 1),
// conditioned on the C = (D + 1) / 2 dims 2c + 1 - (l & 1) (at an odd D,
// the slot whose dim is D has zero weights). With NH hidden layers of
// widths H_0 .. H_{NH-1} (KS_i = H_i / 8):
//   W1  (H_0 x C)           W1[u*C + c] = w0[conditioning dim c][u]
//   b1  (H_0)
//   per hidden product j < NH - 1 (h_j -> h_{j+1}; W2 and b2 for j = 0):
//   WH_j  KS_j x KS_{j+1} fragments, k-step s, n-tile i at s * KS_{j+1} + i
//   BH_j  (H_{j+1})
//   W3  KS_{NH-1} x NT fragments  k-step s, n-tile m at index s * NT + m
//   b3  (A x G)             b3[a*G + q] = b_out[active dim a][q], q < P
// A fragment is 32 lanes x 2 floats: lane 4g + t holds W[8s + 2t][8j + g]
// and W[8s + 2t + 1][8j + g] (rows: input units; W3's columns: the active
// dims' P transformer parameters, 3K - 1 for a spline and 2 for an affine
// map, each dim's group zero-padded to G, a multiple of 8). Every hidden
// and W3 weight is the sum of two TF32 values. With no hidden layer (NH =
// 0) the conditioner is one product on FP32 FMAs, each thread its own
// particle's: W3 (A * G x CP), W3[(a*G + q)*CP + c], rows CP = C rounded up
// to 4 floats apart, then b3.
//
// The wide layout (MmaShape::WIDE) puts the sections a layer reads
// throughout first, then the streamed ones in the order the warps read
// them: W1 (rows CP = C rounded up to 4 floats apart, zero past C), b1,
// every BH_j, b3, then every WH_j (as above), then W3 by groups of GD = 2
// active dims, the fragment of group q, k-step s and the group's n-tile m
// at index (q * KS_{NH-1} + s) * NG + m (NG = GD * G / 8 n-tiles per
// group). At an odd A the last group's second slot is a padding slot (zero
// W3 columns and b3): the layout holds AS = 2 * GROUPS active slots.
//
// The form is the shape's, so the coupling kernel (B1/B3) and the chain
// kernel (B2) read one packing: the whole-layer form where its
// accumulators fit 128 floats a thread (below), two layers fit one block
// beside one warp's buffer (the coupling kernel streams layers through
// two buffers, with as many warps as fit, WARPS), and the chain kernel's
// block (8 warps, two layers: it streams them where its depth does not fit
// resident) fits; else the wide form. A conditioner with no hidden layer
// always takes the whole-layer form.
//
// MmaDims, MmaForm and MmaShape compute the shape in three steps, each
// complete before the next calls its functions in a constant expression.
template <int D_, class HID, int K_, bool RQS_>
struct MmaDims {
  static constexpr int NH = HID::N;  // hidden layers
  __host__ __device__ static constexpr int HW(int i) { return HID::width(i); }
  __host__ __device__ static constexpr int KS(int i) {
    return HID::width(i) / 8;
  }
  static constexpr int D = D_, K = K_;
  static constexpr bool RQS = RQS_;
  static constexpr int H1 = NH ? HID::width(0) : 0;       // first hidden
  static constexpr int HL = NH ? HID::width(NH - 1) : 0;  // last hidden
  // Active and conditioning dims of a layer, with the padding slot at an
  // odd D; DP floats hold a particle's coordinates and that slot.
  static constexpr int A = (D + 1) / 2;
  static constexpr int C = (D + 1) / 2;
  static constexpr int DP = 2 * A;
  static constexpr int P = RQS ? 3 * K - 1 : 2;
  static constexpr int G = (P + 7) / 8 * 8;
  static constexpr int KS1 = H1 / 8;  // k-steps of the first product
  static constexpr int KSL = HL / 8;  // k-steps of W3
  static constexpr int NTD = G / 8;   // n-tiles of one active dim's group
  __host__ __device__ static constexpr bool widths_ok() {
    for (int i = 0; i < NH; ++i) {
      if (HW(i) <= 0 || HW(i) % 8) return false;
    }
    return true;
  }
  // The whole-layer form's floats per layer.
  __host__ __device__ static constexpr int whole_size() {
    if (NH == 0) return round4(round4(A * G * round4(C)) + A * G);
    int s = round4(round4(H1 * C) + H1);
    for (int j = 0; j + 1 < NH; ++j) {
      s = round4(round4(s + 64 * KS(j) * KS(j + 1)) + HW(j + 1));
    }
    return round4(s + 64 * KSL * (A * G / 8) + A * G);
  }
  // The whole-layer form holds two row tiles' accumulators of a product's
  // input and output per thread (acc[2][KS][4]): h_j and h_{j+1} for each
  // hidden product past the first, h_{NH-1} and out[2][NT][4] for the
  // output (one hidden layer: out alone, h_0 coming from the FMAs k-step
  // by k-step). Past 128 floats the output goes one dim at a time (BY_DIM:
  // out[2][NTD][4]; 88 floats at d = 5, against 136), and where that, or a
  // hidden product, passes 128 too the shape takes the wide form.
  __host__ __device__ static constexpr bool regs_wide() {
    if (NH == 0) return false;
    if (NH == 1) return 8 * (A * G / 8) > 128;
    for (int j = 1; j + 1 < NH; ++j) {
      if (8 * (KS(j) + KS(j + 1)) > 128) return true;
    }
    return 8 * (KSL + NTD) > 128;
  }
};

template <int D_, class HID, int K_, bool RQS_>
struct MmaForm : MmaDims<D_, HID, K_, RQS_> {
  using B = MmaDims<D_, HID, K_, RQS_>;
  static constexpr int WHOLE_SIZE = B::whole_size();
  static constexpr int WHOLE_STAGE = B::NH ? 32 * (B::A * B::G + 4) : 0;
  // The wide form where the accumulators pass 128 floats a thread, two
  // whole layers do not fit a block beside one warp's buffer, or the chain
  // kernel's block of 8 warps and two layers does not fit.
  static constexpr bool WIDE =
      B::NH > 0 &&
      (B::regs_wide() || kMaxBlockFloats - 2 * WHOLE_SIZE < WHOLE_STAGE ||
       2 * WHOLE_SIZE + chain_consts_floats(B::D) + 2 * kChainBlockWarps +
               kChainBlockWarps * WHOLE_STAGE >
           kMaxBlockFloats);
  static constexpr bool BY_DIM =
      !WIDE && B::NH >= 2 && 8 * (B::KSL + B::A * B::G / 8) > 128;
  static constexpr int GD = 2;           // active dims per output group
  static constexpr int GROUPS = (B::A + GD - 1) / GD;
  static constexpr int AS = WIDE ? GD * GROUPS : B::A;  // active slots
  static constexpr int CP =
      WIDE || B::NH == 0 ? round4(B::C) : B::C;  // W1's row stride
  static constexpr int OUT = AS * B::G;
  static constexpr int NT = OUT / 8;        // n-tiles of W3
  static constexpr int NG = GD * B::G / 8;  // n-tiles per group
  static constexpr int W1 = B::NH ? 0 : -1;
  static constexpr int B1 = B::NH ? round4(B::H1 * CP) : -1;
  static constexpr int KW3 = B::NH ? chunk_steps(B::KSL, 8, 64 * NG) : 1;
  static constexpr int C3 = 64 * KW3 * NG;
  // Offsets of hidden product j's fragments (WH) and bias (BH).
  __host__ __device__ static constexpr int BH(int j) {
    if (WIDE) {
      int o = round4(B1 + B::H1);
      for (int i = 0; i < j; ++i) o = round4(o + B::HW(i + 1));
      return o;
    }
    return round4(WH(j) + 64 * B::KS(j) * B::KS(j + 1));
  }
  __host__ __device__ static constexpr int WH(int j) {
    if (WIDE) {
      int o = round4(round4(BH(B::NH - 2) + B::HL) + OUT);
      for (int i = 0; i < j; ++i) o += 64 * B::KS(i) * B::KS(i + 1);
      return o;
    }
    return j == 0 ? round4(B1 + B::H1) : round4(BH(j - 1) + B::HW(j));
  }
  __host__ __device__ static constexpr int b3_offset() {
    if (B::NH == 0) return round4(OUT * CP);
    const int last = B::NH == 1 ? round4(B1 + B::H1)
                                : round4(BH(B::NH - 2) + B::HL);
    return WIDE ? last : last + 64 * B::KSL * NT;
  }
  __host__ __device__ static constexpr int w3_offset() {
    if (B::NH == 0) return 0;
    if (!WIDE) {
      return B::NH == 1 ? round4(B1 + B::H1) : round4(BH(B::NH - 2) + B::HL);
    }
    return B::NH == 1 ? round4(b3_offset() + OUT)
                      : WH(B::NH - 2) + 64 * B::KS(B::NH - 2) * B::KSL;
  }
  // Wide streaming: hidden product j in chunks of KWH(j) k-steps (all its
  // n-tiles), as many as keep a chunk within kChunkFloats.
  __host__ __device__ static constexpr int KWH(int j) {
    return chunk_steps(B::KS(j), 4, 64 * B::KS(j + 1));
  }
  __host__ __device__ static constexpr int CH(int j) {
    return 64 * KWH(j) * B::KS(j + 1);
  }
  __host__ __device__ static constexpr int NCH(int j) {
    return B::KS(j) / KWH(j);
  }
  __host__ __device__ static constexpr int ncp() {
    int c = 0;
    for (int j = 0; j + 1 < B::NH; ++j) c += NCH(j);
    return c;
  }
  __host__ __device__ static constexpr int max_chunk() {
    int m = C3;
    for (int j = 0; j + 1 < B::NH; ++j) m = CH(j) > m ? CH(j) : m;
    return m;
  }
};

template <int D_, class HID, int K_, bool RQS_>
struct MmaShape : MmaForm<D_, HID, K_, RQS_> {
  using F = MmaForm<D_, HID, K_, RQS_>;
  static_assert(F::widths_ok(), "hidden widths must be /8");
  static constexpr int W2 = F::NH >= 2 ? F::WH(0) : -1;
  static constexpr int B2 = F::NH >= 2 ? F::BH(0) : -1;
  static constexpr int W3 = F::w3_offset();
  static constexpr int B3 = F::b3_offset();
  static constexpr int SIZE = F::WIDE ? W3 + 64 * F::KSL * F::NT
                                      : round4(B3 + F::OUT);  // per layer
  // A warp's buffer of transformer parameters: its 32 particles' OUT
  // floats (wide: one row tile's GD groups), rows ROW floats apart (the 4
  // extra floats put the 8 rows a quarter warp reads with float4 loads in
  // distinct banks). Wide: then the warp's 32 particles, FROW apart (read
  // and written one float at a time; at an odd D the row's last float is
  // the padding slot, 0), and with one hidden layer the row tile's
  // conditioning inputs (16 x CP), which the output groups read throughout.
  // No hidden layer: none (each thread computes its own parameters).
  static constexpr int ROW = (F::WIDE ? F::GD * F::G : F::OUT) + 4;
  static constexpr int FROW = F::D + 1;
  // Wide, one hidden layer: where the row tile's inputs sit in the warp's
  // buffer (after the group parameters and the particles).
  static constexpr int UB = 16 * ROW + 32 * FROW;
  static constexpr int STAGE =
      F::WIDE ? 16 * ROW + 32 * FROW + (F::NH == 1 ? 16 * F::CP : 0)
              : (F::NH ? 32 * ROW : 0);
  // Wide streaming: the resident part (W1 .. b3) of a layer, and its
  // hidden products and W3 in chunks (F::KWH) and of KW3 k-steps of one
  // group, as many as keep a chunk within kChunkFloats; a row tile reads
  // NCP + NC3 chunks, a layer CPL (40 at d = 32, (128, 128): 16 KB chunks;
  // 32 KB chunks, 20 a layer, ran B1 3.5% faster and B2 1.1% slower, and
  // leave no room for B1's second block: PERF.md).
  static constexpr int RES = F::WIDE ? (F::NH >= 2 ? W2 : W3) : 0;
  static constexpr int NCP = F::ncp();
  static constexpr int NC3 = F::NH ? F::GROUPS * (F::KSL / F::KW3) : 0;
  static constexpr int CPL = 2 * (NCP + NC3);
  static constexpr int CHUNK = F::WIDE ? F::max_chunk() : 0;
  // One resident part where two leave no warp beside the chunks (a layer's
  // part then loads once every warp is done with the last layer's: one
  // more barrier a layer, no copy ahead).
  static constexpr bool ONE_RES =
      F::WIDE && kMaxBlockFloats - 2 * (RES + CHUNK) < STAGE;
  static constexpr int RESB = (ONE_RES ? 1 : 2) * RES;  // resident slots
  // A coupling-kernel block: its weight buffers (two layers, or the
  // resident parts and two chunks) and as many warps as fit beside them,
  // at most kMaxCouplingWarps.
  static constexpr int BUFS = F::WIDE ? RESB + 2 * CHUNK : 2 * SIZE;
  static constexpr int FIT =
      STAGE ? (kMaxBlockFloats - BUFS) / STAGE
            : (BUFS <= kMaxBlockFloats ? kMaxCouplingWarps : 0);
  static constexpr int WARPS =
      FIT < kMaxCouplingWarps ? FIT : kMaxCouplingWarps;
};

// 16 bytes from global to shared memory, asynchronously (cp.async, L2
// only: every block reads the same weights).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's threads start copying `floats` (a multiple of 4) into dst.
__device__ __forceinline__ void copy_async(float* dst,
                                           const float* __restrict__ src,
                                           int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * blockDim.x) {
    cp_async16(dst + i, src + i);
  }
}

// x = hi + lo: hi is x rounded to the nearest TF32 value (ties away from
// zero, cvt.rna.tf32.f32 done in integer ops), lo is x - hi rounded the
// same way, which leaves an error below 2^-23 |x| (left to the tensor
// core, which reads lo's top 11 significant bits, it would be a one-sided
// error below 2^-21 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
  lo = (lo + 0x1000u) & 0xFFFFE000u;
}

// A packed weight is the sum of two TF32 values, so cutting it to TF32
// gives hi, and w - hi = lo exactly.
__device__ __forceinline__ void split_weight(float w, uint32_t& hi,
                                             uint32_t& lo) {
  hi = __float_as_uint(w) & 0xFFFFE000u;
  lo = __float_as_uint(w - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dot4(float4 w, float4 u, float a) {
  a = fmaf(w.x, u.x, a);
  a = fmaf(w.y, u.y, a);
  a = fmaf(w.z, u.z, a);
  return fmaf(w.w, u.w, a);
}

// A lane's B fragment of packed weights, split.
struct WeightFragment {
  uint32_t h0, h1, l0, l1;

  __device__ __forceinline__ explicit WeightFragment(const float* p) {
    const float2 b = *reinterpret_cast<const float2*>(p);
    split_weight(b.x, h0, l0);
    split_weight(b.y, h1, l1);
  }
};

// d += A . B in split TF32, the small terms first, each product summed
// into d by the tensor core. Its sum is cut, not rounded, to float32 (a
// one-sided error of up to an ulp of d per product), so the three
// products of a k-step cost d three such cuts.
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const WeightFragment& b) {
  mma_tf32(d, al, b.h0, b.h1);
  mma_tf32(d, ah, b.l0, b.l1);
  mma_tf32(d, ah, b.h0, b.h1);
}

// d += A . B for one k-step: the k-step's three products summed from zero
// and added to d in float32 (round to nearest), one cut per k-step at the
// scale of the k-step's own sum rather than of d. Summed into d in place,
// the cuts of a 64-wide product add up to an error of one sign, twice
// float32's in root mean square on the coupling flows checked (tests/
// test_torch_coupling_layout.py::test_kstep_sums_keep_the_card_tolerance
// models it). mma.sync returns the k-step's sum cut toward zero; its cut
// is left: adding back an ulp where the sum's last bit is set also raises
// half the 29% of sums the card returns exact (N(0, 1) TF32 values, NVIDIA
// H100 80GB HBM3 at 700 W), which moved the passes' mean errors past plain
// float32's the other way on the flows read (PERF.md; the model of tests/
// test_torch_staged_coupling.py::
// test_card_cut_model_flips_the_last_bits_sign).
__device__ __forceinline__ void mma_split_step(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const WeightFragment& b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(s, ah, al, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

// The A fragments of k-step s of a product whose input is a hidden layer
// held as accumulator fragments (acc[m][s]: n-tile s of row tile m). The
// accumulator of n-tile s, (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), is
// the A fragment of k-step s in the order (g, 2t), (g+8, 2t), (g, 2t+1),
// (g+8, 2t+1).
template <int T, int N>
struct AccFragment {
  const float (&acc)[T][N][4];

  __device__ __forceinline__ void operator()(int s, uint32_t (&ah)[T][4],
                                             uint32_t (&al)[T][4]) const {
#pragma unroll
    for (int m = 0; m < T; ++m) {
      split_tf32(acc[m][s][0], ah[m][0], al[m][0]);
      split_tf32(acc[m][s][2], ah[m][1], al[m][1]);
      split_tf32(acc[m][s][1], ah[m][2], al[m][2]);
      split_tf32(acc[m][s][3], ah[m][3], al[m][3]);
    }
  }
};

// The A fragments of k-step s of the first hidden layer, h_0 = relu(W1 u +
// b1) on FP32 FMAs, for T row tiles of 16 particles: units 8s + 2t + e, in
// each row tile's A-fragment order (g, e = 0), (g + 8, 0), (g, 1),
// (g + 8, 1). Lane 4g + t holds u[r][c], conditioning input c of row g + 8r
// (row tile r / 2). With PAIRED, row tile 1 reads the layer at w1.
template <class S, int T, bool PAIRED>
struct FirstFragment {
  const float* __restrict__ w;
  const float* __restrict__ w1;
  const float (&u)[2 * T][S::C];
  int t;

  __device__ __forceinline__ void operator()(int s, uint32_t (&hh)[T][4],
                                             uint32_t (&hl)[T][4]) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int unit = 8 * s + 2 * t + e;
      const float bias = w[S::B1 + unit];
      const float bias1 = PAIRED ? w1[S::B1 + unit] : bias;
#pragma unroll
      for (int r = 0; r < 2 * T; ++r) {
        const float* wr = PAIRED && r >= 2 ? w1 : w;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < S::C; ++c) {
          a = fmaf(wr[S::W1 + unit * S::C + c], u[r][c], a);
        }
        const int q = 2 * e + (r & 1);
        split_tf32(fmaxf(a + (PAIRED && r >= 2 ? bias1 : bias), 0.f),
                   hh[r >> 1][q], hl[r >> 1][q]);
      }
    }
  }
};

// acc[m][j] += A_s . B(s, j) over the k-steps s < KIN and n-tiles j < NOUT
// of one product, A from frag(s, ...), the B fragment of (s, j) at
// w + at + 64 * (s * NOUT + j), read once for both row tiles (PAIRED: row
// tile 1's at w1 + the same offset); k-step outer, so an input's
// accumulators free up as it goes.
template <int T, bool PAIRED, int KIN, int NOUT, class Frag>
__device__ __forceinline__ void product_mma(const float* __restrict__ w,
                                            const float* __restrict__ w1,
                                            int at, const Frag& frag,
                                            float (&acc)[T][NOUT][4],
                                            int lane) {
#pragma unroll
  for (int s = 0; s < KIN; ++s) {
    uint32_t ah[T][4], al[T][4];
    frag(s, ah, al);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      const int o = at + 64 * (s * NOUT + j) + 2 * lane;
      const WeightFragment b(w + o);
      mma_split_step(acc[0][j], ah[0], al[0], b);
      if constexpr (PAIRED) {
        const WeightFragment b1(w1 + o);
        mma_split_step(acc[1][j], ah[1], al[1], b1);
      } else if constexpr (T == 2) {
        mma_split_step(acc[1][j], ah[1], al[1], b);
      }
    }
  }
}

template <int T, int N>
__device__ __forceinline__ void zero_acc(float (&acc)[T][N][4]) {
#pragma unroll
  for (int m = 0; m < T; ++m) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    }
  }
}

// h = relu(acc + b) with the bias at w + at (PAIRED: row tile 1's at w1),
// kept as the accumulator fragments.
template <int T, bool PAIRED, int N>
__device__ __forceinline__ void bias_relu(const float* __restrict__ w,
                                          const float* __restrict__ w1,
                                          int at, float (&acc)[T][N][4],
                                          int t) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 bias0 =
        *reinterpret_cast<const float2*>(w + at + 8 * j + 2 * t);
    const float2 bias1 =
        PAIRED ? *reinterpret_cast<const float2*>(w1 + at + 8 * j + 2 * t)
               : bias0;
#pragma unroll
    for (int m = 0; m < T; ++m) {
      const float2 bias = PAIRED && m ? bias1 : bias0;
      acc[m][j][0] = fmaxf(acc[m][j][0] + bias.x, 0.f);
      acc[m][j][1] = fmaxf(acc[m][j][1] + bias.y, 0.f);
      acc[m][j][2] = fmaxf(acc[m][j][2] + bias.x, 0.f);
      acc[m][j][3] = fmaxf(acc[m][j][3] + bias.y, 0.f);
    }
  }
}

// The output layer's sums plus b3 to buf[p * ROW + q] for row p.
template <class S, int T, bool PAIRED>
__device__ __forceinline__ void store_output(const float* __restrict__ w,
                                             const float* __restrict__ w1,
                                             const float (&out)[T][S::NT][4],
                                             float* __restrict__ buf,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < S::NT; ++n) {
    const int q = 8 * n + 2 * t;
    const float2 bias0 = *reinterpret_cast<const float2*>(w + S::B3 + q);
    const float2 bias1 =
        PAIRED ? *reinterpret_cast<const float2*>(w1 + S::B3 + q) : bias0;
#pragma unroll
    for (int m = 0; m < T; ++m) {
      const float2 bias = PAIRED && m ? bias1 : bias0;
      const int row = 16 * m + g;
      *reinterpret_cast<float2*>(buf + row * S::ROW + q) =
          make_float2(out[m][n][0] + bias.x, out[m][n][1] + bias.y);
      *reinterpret_cast<float2*>(buf + (row + 8) * S::ROW + q) =
          make_float2(out[m][n][2] + bias.x, out[m][n][3] + bias.y);
    }
  }
}

// The output layer's columns of active dim a (its G parameters) for the
// warp's two row tiles, from the last hidden layer in acc, to
// buf[p * ROW + a * G + q] for row p: the products of the one-pass output
// layer for those columns, in its order, so they give its bits.
template <class S>
__device__ __forceinline__ void output_dim_mma(
    const float* __restrict__ w, const float (&acc)[2][S::KSL][4], int a,
    float* __restrict__ buf, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float out[2][S::NTD][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < S::NTD; ++n) {
      out[m][n][0] = out[m][n][1] = out[m][n][2] = out[m][n][3] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < S::KSL; ++s) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split_tf32(acc[m][s][0], ah[m][0], al[m][0]);
      split_tf32(acc[m][s][2], ah[m][1], al[m][1]);
      split_tf32(acc[m][s][1], ah[m][2], al[m][2]);
      split_tf32(acc[m][s][3], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int n = 0; n < S::NTD; ++n) {
      const WeightFragment b(
          w + S::W3 + 64 * (s * S::NT + a * S::NTD + n) + 2 * lane);
      mma_split_step(out[0][n], ah[0], al[0], b);
      mma_split_step(out[1][n], ah[1], al[1], b);
    }
  }
#pragma unroll
  for (int n = 0; n < S::NTD; ++n) {
    const int q = 8 * n + 2 * t;
    const float2 bias =
        *reinterpret_cast<const float2*>(w + S::B3 + a * S::G + q);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = 16 * m + g;
      *reinterpret_cast<float2*>(buf + row * S::ROW + a * S::G + q) =
          make_float2(out[m][n][0] + bias.x, out[m][n][1] + bias.y);
      *reinterpret_cast<float2*>(buf + (row + 8) * S::ROW + a * S::G + q) =
          make_float2(out[m][n][2] + bias.x, out[m][n][3] + bias.y);
    }
  }
}

// The conditioner from hidden layer I (its activations in acc) on: each
// further hidden product (h_I -> h_{I+1}, WH(I) and BH(I)), then the
// output layer (BY_DIM: one active dim's G columns at a time,
// output_dim_mma, the first `live` dims only).
template <class S, int I, int T, bool PAIRED>
__device__ __forceinline__ void conditioner_rest(
    const float* __restrict__ w, const float* __restrict__ w1,
    const float (&acc)[T][S::KS(I)][4], float* __restrict__ buf, int lane,
    int live) {
  if constexpr (I + 1 < S::NH) {
    float next[T][S::KS(I + 1)][4];
    zero_acc(next);
    product_mma<T, PAIRED, S::KS(I), S::KS(I + 1)>(
        w, w1, S::WH(I), AccFragment<T, S::KS(I)>{acc}, next, lane);
    bias_relu<T, PAIRED>(w, w1, S::BH(I), next, lane & 3);
    conditioner_rest<S, I + 1, T, PAIRED>(w, w1, next, buf, lane, live);
  } else if constexpr (S::BY_DIM) {
    static_assert(T == 2 && !PAIRED, "the output by dims takes two tiles");
#pragma unroll
    for (int a = 0; a < S::A; ++a) {
      if (a < live) output_dim_mma<S>(w, acc, a, buf, lane);
    }
  } else {
    // Output layer, k-step outer so the accumulators free up as it goes.
    float out[T][S::NT][4];
    zero_acc(out);
    product_mma<T, PAIRED, S::KSL, S::NT>(
        w, w1, S::W3, AccFragment<T, S::KSL>{acc}, out, lane);
    store_output<S, T, PAIRED>(w, w1, out, buf, lane);
  }
}

// The conditioner of one coupling layer for T row tiles of 16 particles
// (T = 2: a warp's 32), NH >= 1 hidden layers. Lane 4g + t brings u[r][c],
// conditioning input c of row g + 8r (row tile r / 2), and gets, as does
// every lane, the rows g + 8r of the fragments; the transformer parameters
// of row p's active dim a go to buf[p * ROW + a * G + q]. Every row tile
// runs the layer at w, whose B fragments each k-step reads once for all of
// them; with PAIRED (T = 2) row tile 1 runs another layer, at w1, and reads
// its own: two independent chains of products in one k-loop. h_0 comes
// from the FMAs k-step by k-step straight into the first tensor product
// (the first hidden product, or with one hidden layer the output layer),
// so it never sits in registers whole.
//
// BY_DIM (T = 2, not PAIRED): the output layer one active dim's G columns
// at a time (output_dim_mma), the first `live` dims only (a padding slot
// last is skipped).
template <class S, int T = 2, bool PAIRED = false>
__device__ __forceinline__ void conditioner_mma(
    const float* __restrict__ w, const float (&u)[2 * T][S::C],
    float* __restrict__ buf, int lane,
    const float* __restrict__ w1 = nullptr, int live = S::A) {
  static_assert(T == 1 || T == 2, "one or two row tiles");
  static_assert(!PAIRED || T == 2, "a pair is two row tiles");
  static_assert(S::NH >= 1, "a conditioner with hidden layers");
  const FirstFragment<S, T, PAIRED> first{w, w1, u, lane & 3};
  if constexpr (S::NH == 1) {
    float out[T][S::NT][4];
    zero_acc(out);
    product_mma<T, PAIRED, S::KS1, S::NT>(w, w1, S::W3, first, out, lane);
    store_output<S, T, PAIRED>(w, w1, out, buf, lane);
  } else {
    // Second hidden layer's accumulators: row tile m, n-tile j.
    float acc[T][S::KS(1)][4];
    zero_acc(acc);
    product_mma<T, PAIRED, S::KS1, S::KS(1)>(w, w1, S::W2, first, acc, lane);
    bias_relu<T, PAIRED>(w, w1, S::B2, acc, lane & 3);
    conditioner_rest<S, 1, T, PAIRED>(w, w1, acc, buf, lane, live);
  }
}

// The transformer of one active dim of a particle, from its parameters:
// rqs<K, DENSITY> (rqs_micro<K> with MICRO, density only) or
// affine<DENSITY>.
template <class S, bool DENSITY, bool MICRO = false>
__device__ __forceinline__ void transform_dim(float x,
                                              const float (&par)[S::P],
                                              float tb, float& y, float& e) {
  if constexpr (MICRO) {
    rqs_micro<S::K>(x, par, tb, y, e);
  } else if constexpr (S::RQS) {
    rqs<S::K, DENSITY>(x, par, tb, y, e);
  } else {
    affine<DENSITY>(x, par, y, e);
  }
}

// The transformers of lane l's particle f for a layer of parity `odd`,
// from row l of buf (conditioner_mma's output): its active dims 2a + odd
// (but the padding slot) through rqs<K, DENSITY> (rqs_micro<K> with MICRO,
// density only) or affine<DENSITY>. Returns their log-det sum.
template <class S, bool DENSITY, bool MICRO = false>
__device__ __forceinline__ float transformers_mma(
    const float* __restrict__ buf, int lane, bool odd, float tb,
    float (&f)[S::DP]) {
  static_assert(!MICRO || (DENSITY && S::RQS),
                "rqs_micro is a density spline");
  float ld = 0.f;
#pragma unroll
  for (int a = 0; a < S::A; ++a) {
    if constexpr (S::D % 2 == 1) {
      if (odd && a == S::A - 1) continue;  // the padding slot, dim D
    }
    const float4* src =
        reinterpret_cast<const float4*>(buf + lane * S::ROW + a * S::G);
    float par[S::P];
#pragma unroll
    for (int c = 0; c < (S::P + 3) / 4; ++c) {
      const float4 v = src[c];
      if (4 * c + 0 < S::P) par[4 * c + 0] = v.x;
      if (4 * c + 1 < S::P) par[4 * c + 1] = v.y;
      if (4 * c + 2 < S::P) par[4 * c + 2] = v.z;
      if (4 * c + 3 < S::P) par[4 * c + 3] = v.w;
    }
    float y, e;
    transform_dim<S, DENSITY, MICRO>(odd ? f[2 * a + 1] : f[2 * a], par, tb, y,
                                     e);
    if (odd) {
      f[2 * a + 1] = y;
    } else {
      f[2 * a] = y;
    }
    ld += e;
  }
  return ld;
}

// One coupling layer with no hidden layer, for the thread's own particle
// f: each active dim's parameters b3 + W3 u of its conditioning inputs u
// (W3's rows CP floats apart, read as float4s), then its transformer.
// Returns the layer's log-det.
template <class S, bool DENSITY>
__device__ __forceinline__ float linear_layer(const float* __restrict__ w,
                                              bool odd, float tb,
                                              float (&f)[S::DP]) {
  static_assert(S::CP % 4 == 0, "W3's rows are read as float4s");
  float4 u[S::CP / 4];
#pragma unroll
  for (int c = 0; c < S::CP / 4; ++c) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      v[e] = i < S::C ? (odd ? f[2 * i] : f[2 * i + 1]) : 0.f;
    }
    u[c] = make_float4(v[0], v[1], v[2], v[3]);
  }
  float ld = 0.f;
#pragma unroll
  for (int a = 0; a < S::A; ++a) {
    if constexpr (S::D % 2 == 1) {
      if (odd && a == S::A - 1) continue;  // the padding slot, dim D
    }
    float par[S::P];
#pragma unroll
    for (int q = 0; q < S::P; ++q) {
      const float4* wr =
          reinterpret_cast<const float4*>(w + S::W3 + (a * S::G + q) * S::CP);
      float acc = w[S::B3 + a * S::G + q];
#pragma unroll
      for (int c = 0; c < S::CP / 4; ++c) acc = dot4(wr[c], u[c], acc);
      par[q] = acc;
    }
    float y, e;
    transform_dim<S, DENSITY>(odd ? f[2 * a + 1] : f[2 * a], par, tb, y, e);
    if (odd) {
      f[2 * a + 1] = y;
    } else {
      f[2 * a] = y;
    }
    ld += e;
  }
  return ld;
}

// One coupling layer of the warp's 32 particles, lane l holding particle
// l in f, with the layer's packed weights at w. DENSITY (data -> latent)
// runs the transformers' inverse (rqs<K, true> / affine<true>), sampling
// their forward; the layer's log-det is added to log_det. All 32 lanes
// call it together, after a __syncwarp since the buffer's last reads.
// f[D], the padding slot at an odd D, holds 0. With no hidden layer each
// thread computes its own particle's parameters on FMAs (no buffer).
template <class S, bool DENSITY>
__device__ __forceinline__ void coupling_layer_mma(const float* __restrict__ w,
                                                   int layer, float tb,
                                                   float* __restrict__ buf,
                                                   int lane, float (&f)[S::DP],
                                                   float& log_det) {
  const bool odd = layer & 1;
  if constexpr (S::NH == 0) {
    log_det += linear_layer<S, DENSITY>(w, odd, tb, f);
  } else {
    float u[4][S::C];
#pragma unroll
    for (int c = 0; c < S::C; ++c) {
      const float v = odd ? f[2 * c] : f[2 * c + 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        u[r][c] = __shfl_sync(0xffffffffu, v, (lane >> 2) + 8 * r);
      }
    }
    if constexpr (S::BY_DIM) {
      conditioner_mma<S>(w, u, buf, lane, nullptr,
                         S::D % 2 && odd ? S::A - 1 : S::A);
    } else {
      conditioner_mma<S>(w, u, buf, lane);
    }
    __syncwarp();
    log_det += transformers_mma<S, DENSITY>(buf, lane, odd, tb, f);
    __syncwarp();
  }
}

// The flow density pass (data -> latent, layers in order) of the warp's
// 32 particles with every layer's packed weights at w.
template <class S>
__device__ __forceinline__ void flow_density(const float* __restrict__ w,
                                             int n_layers, float tb,
                                             float* __restrict__ buf,
                                             int lane, float (&f)[S::DP],
                                             float& log_det) {
  __syncwarp();
#pragma unroll 1
  for (int layer = 0; layer < n_layers; ++layer) {
    coupling_layer_mma<S, true>(w + layer * S::SIZE, layer, tb, buf, lane,
                                f, log_det);
  }
}

// The flow density pass of the warp's 32 particles with the layers
// streamed from global memory (src, every layer's packed weights) through
// two layer buffers at bufs (2 x SIZE floats), as the coupling kernel
// streams them: cp.async one layer ahead, one block barrier per layer. All
// of the block's threads call it together.
template <class S>
__device__ __forceinline__ void flow_density_streamed(
    const float* __restrict__ src, float* __restrict__ bufs, int n_layers,
    float tb, float* __restrict__ buf, int lane, float (&f)[S::DP],
    float& log_det) {
  __syncthreads();  // every warp is done with the last pass's buffers
  copy_async(bufs, src, S::SIZE);
#pragma unroll 1
  for (int layer = 0; layer < n_layers; ++layer) {
    cp_async_wait_all();
    __syncthreads();
    if (layer + 1 < n_layers) {
      copy_async(bufs + ((layer + 1) & 1) * S::SIZE,
                 src + (size_t)(layer + 1) * S::SIZE, S::SIZE);
    }
    coupling_layer_mma<S, true>(bufs + (layer & 1) * S::SIZE, layer, tb, buf,
                                lane, f, log_det);
  }
}

// ---------------------------------------------------------------------------
// The wide form (MmaShape::WIDE)
// ---------------------------------------------------------------------------

// A pass's weights streamed through the block's shared memory: two slots
// for a layer's resident part (RES floats: W1, b1, every hidden product's
// bias, b3; one with S::ONE_RES) and two for its chunks of the hidden
// products and W3 (CHUNK floats), in the order the warps read them (per
// layer and row tile: each hidden product's NCH chunks, then W3's NC3 by
// groups). Every thread of the block calls begin() and next() in the same
// order.
template <class S>
struct WideStream {
  float* res;                   // S::RESB floats
  float* ring;                  // 2 x S::CHUNK floats
  const float* w;  // every layer's packed weights
  int n_layers;
  bool density;  // layers in order (density) or reversed (sampling)
  int k;         // chunks handed out in this pass

  __device__ __forceinline__ int layer_of(int step) const {
    return density ? step : n_layers - 1 - step;
  }

  __device__ __forceinline__ const float* layer_src(int step) const {
    return w + (size_t)layer_of(step) * S::SIZE;
  }

  // Chunk j of the pass: its source, and its floats in `floats`.
  __device__ __forceinline__ const float* chunk_src(int j, int& floats) const {
    const float* base = layer_src(j / S::CPL);
    int i = (j % S::CPL) % (S::NCP + S::NC3);  // both row tiles
#pragma unroll
    for (int h = 0; h + 1 < S::NH; ++h) {
      if (i < S::NCH(h)) {
        floats = S::CH(h);
        return base + S::WH(h) + i * S::CH(h);
      }
      i -= S::NCH(h);
    }
    floats = S::C3;
    return base + S::W3 + i * S::C3;
  }

  // Start a pass: once every warp is done with the slots, copy the first
  // layer's resident part and first chunk.
  __device__ __forceinline__ void begin() {
    __syncthreads();
    k = 0;
    copy_async(res, layer_src(0), S::RES);
    int floats;
    const float* src = chunk_src(0, floats);
    copy_async(ring, src, floats);
  }

  // The next chunk, once it has landed; then start copying the chunk after
  // it, and at a layer's first chunk the next layer's resident part, into
  // the slots every warp is done with (the barrier says so). With one
  // resident slot, a layer's first chunk (but the pass's first) copies the
  // layer's part into it, every warp being done with the last layer's, and
  // waits for it.
  __device__ __forceinline__ const float* next() {
    cp_async_wait_all();
    __syncthreads();
    const int j = k++;
    if (j + 1 < n_layers * S::CPL) {
      int floats;
      const float* src = chunk_src(j + 1, floats);
      copy_async(ring + ((j + 1) & 1) * S::CHUNK, src, floats);
    }
    const int step = j / S::CPL;
    if constexpr (S::ONE_RES) {
      if (j % S::CPL == 0 && step > 0) {
        copy_async(res, layer_src(step), S::RES);
        cp_async_wait_all();
        __syncthreads();
      }
    } else if (j % S::CPL == 0 && step + 1 < n_layers) {
      copy_async(res + ((step + 1) & 1) * S::RES, layer_src(step + 1),
                 S::RES);
    }
    return ring + (j & 1) * S::CHUNK;
  }

  // Step `step`'s resident part: valid after the step's first next().
  __device__ __forceinline__ const float* resident(int step) const {
    if constexpr (S::ONE_RES) {
      return res;
    } else {
      return res + (step & 1) * S::RES;
    }
  }
};

// The first hidden layer's A fragments of k-step s for the wide form's one
// row tile: h_0 = relu(W1 u + b1) of rows g and g + 8 (their conditioning
// inputs at u0 and u1, CP floats each, read as float4s) for units
// 8s + 2t + e, in the A fragment order (g, e = 0), (g + 8, 0), (g, 1),
// (g + 8, 1).
template <class S>
__device__ __forceinline__ void wide_first_fragment(
    const float* __restrict__ res, const float4* u0, const float4* u1,
    int s, int t, uint32_t (&hh)[4], uint32_t (&hl)[4]) {
  const int unit = 8 * s + 2 * t;
  const float4* w0 =
      reinterpret_cast<const float4*>(res + S::W1 + unit * S::CP);
  const float4* w1 = w0 + S::CP / 4;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < S::CP / 4; ++c) {
    const float4 x0 = u0[c], x1 = u1[c], v0 = w0[c], v1 = w1[c];
    a[0] = dot4(v0, x0, a[0]);
    a[1] = dot4(v0, x1, a[1]);
    a[2] = dot4(v1, x0, a[2]);
    a[3] = dot4(v1, x1, a[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(fmaxf(a[i] + res[S::B1 + unit + (i >> 1)], 0.f), hh[i],
               hl[i]);
  }
}

// The wide form's output groups of row tile m: per group of GD = 2 active
// dims their 2G output columns (out[NG][4]) from W3's chunks, A from
// frag(s, ah, al) (the last hidden layer's accumulators, or with one
// hidden layer h_0 from the FMAs), to pb, and their transformers, lane l
// taking row l & 15 and the group's dim l >> 4: 32 transformers at once.
template <class S, bool DENSITY, class Frag>
__device__ __forceinline__ void wide_groups(WideStream<S>& ws, int m,
                                            int odd, const float* res,
                                            float tb, float* __restrict__ F,
                                            float* __restrict__ pb, int lane,
                                            float (&ldp)[2],
                                            const Frag& frag) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int q = 0; q < S::GROUPS; ++q) {
    float out[S::NG][4];
#pragma unroll
    for (int n = 0; n < S::NG; ++n) {
      out[n][0] = out[n][1] = out[n][2] = out[n][3] = 0.f;
    }
#pragma unroll
    for (int c3 = 0; c3 < S::KSL / S::KW3; ++c3) {
      const float* wc = ws.next();
#pragma unroll
      for (int sl = 0; sl < S::KW3; ++sl) {
        const int s = c3 * S::KW3 + sl;
        uint32_t ah[4], al[4];
        frag(s, ah, al);
#pragma unroll
        for (int n = 0; n < S::NG; ++n) {
          const WeightFragment b(wc + 64 * (sl * S::NG + n) + 2 * lane);
          mma_split_step(out[n], ah, al, b);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < S::NG; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(
          res + S::B3 + q * S::GD * S::G + col);
      *reinterpret_cast<float2*>(pb + g * S::ROW + col) =
          make_float2(out[n][0] + bias.x, out[n][1] + bias.y);
      *reinterpret_cast<float2*>(pb + (g + 8) * S::ROW + col) =
          make_float2(out[n][2] + bias.x, out[n][3] + bias.y);
    }
    __syncwarp();
    const int r = lane & 15, ad = lane >> 4;
    const float4* src =
        reinterpret_cast<const float4*>(pb + r * S::ROW + ad * S::G);
    float par[S::P];
#pragma unroll
    for (int c = 0; c < (S::P + 3) / 4; ++c) {
      const float4 v = src[c];
      if (4 * c + 0 < S::P) par[4 * c + 0] = v.x;
      if (4 * c + 1 < S::P) par[4 * c + 1] = v.y;
      if (4 * c + 2 < S::P) par[4 * c + 2] = v.z;
      if (4 * c + 3 < S::P) par[4 * c + 3] = v.w;
    }
    const int dim = 2 * (q * S::GD + ad) + odd;
    float* v = F + (16 * m + r) * S::FROW + dim;
    // A padding slot (dim D at an odd D, or the last group's second slot
    // at an odd A) keeps its value and adds nothing.
    constexpr bool kPadded = S::D % 2 == 1 || S::AS > S::A;
    const bool live = !kPadded || dim < S::D;
    const float value = live ? *v : 0.f;
    float y, e;
    if constexpr (S::RQS) {
      rqs<S::K, DENSITY>(value, par, tb, y, e);
    } else {
      affine<DENSITY>(value, par, y, e);
    }
    if (live) {
      *v = y;
    } else {
      e = 0.f;
    }
    // (selects, not ldp[m]: a register array takes no runtime index)
    ldp[0] += m == 0 ? e : 0.f;
    ldp[1] += m == 1 ? e : 0.f;
    __syncwarp();
  }
}

// The wide form from hidden layer I of row tile m (its activations in acc)
// on: each further hidden product from its chunks (h_{I+1} = relu(h_I .
// WH(I) + BH(I)), k-steps by chunks), then the output groups.
template <class S, int I, bool DENSITY>
__device__ __forceinline__ void wide_rest(WideStream<S>& ws, int m, int odd,
                                          const float* res, float tb,
                                          float* __restrict__ F,
                                          float* __restrict__ pb, int lane,
                                          float (&ldp)[2],
                                          const float (&acc)[1][S::KS(I)][4]) {
  if constexpr (I + 1 < S::NH) {
    constexpr int N = S::KS(I + 1);
    float next[1][N][4];
    zero_acc(next);
    const AccFragment<1, S::KS(I)> frag{acc};
#pragma unroll
    for (int c = 0; c < S::NCH(I); ++c) {
      const float* wc = ws.next();
#pragma unroll
      for (int sl = 0; sl < S::KWH(I); ++sl) {
        uint32_t ah[1][4], al[1][4];
        frag(c * S::KWH(I) + sl, ah, al);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const WeightFragment b(wc + 64 * (sl * N + j) + 2 * lane);
          mma_split_step(next[0][j], ah[0], al[0], b);
        }
      }
    }
    bias_relu<1, false>(res, nullptr, S::BH(I), next, lane & 3);
    wide_rest<S, I + 1, DENSITY>(ws, m, odd, res, tb, F, pb, lane, ldp,
                                 next);
  } else {
    __syncwarp();  // every lane's reads of the inputs in pb are done
    const AccFragment<1, S::KSL> frag{acc};
    wide_groups<S, DENSITY>(
        ws, m, odd, res, tb, F, pb, lane, ldp,
        [&](int s, uint32_t (&ah)[4], uint32_t (&al)[4]) {
          uint32_t h[1][4], l[1][4];
          frag(s, h, l);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = h[0][i];
            al[i] = l[0][i];
          }
        });
  }
}

// One coupling layer (pass step `step`) of the warp's 32 particles in the
// wide form. F holds particle p's coordinates at F[p * FROW + i]; pb is the
// warp's buffer of one row tile's group parameters (16 x ROW). Per row tile
// m (particles 16m .. 16m + 15): its conditioning inputs copied to ub (pb,
// which the groups do not need yet; with one hidden layer the region after
// F, since the groups read them) and read from there at each k-step; h_0
// on FP32 FMAs, then (two or more hidden layers) h_1 = relu(h_0 . W2 + b2)
// in registers (acc[KS(1)][4]) from W2's chunks, one k-step at a time (the
// loops over W2's k-steps are not unrolled, so no k-step's loads are
// hoisted into another's registers), each further hidden product
// (wide_rest); then the output groups (wide_groups), with one hidden layer
// h_0's k-steps recomputed for each group. The products summed by k-steps
// (mma_split_step). ldp[m]: the log-dets of the lane's (row, dim)
// transformers of row tile m.
template <class S, bool DENSITY>
__device__ __forceinline__ void coupling_layer_wide(
    WideStream<S>& ws, int step, float tb, float* __restrict__ F,
    float* __restrict__ pb, int lane, float (&ldp)[2]) {
  static_assert(S::GD == 2, "a lane per (row of a tile, dim of a group)");
  static_assert(S::CP % 4 == 0 && S::CP <= S::ROW,
                "the tile's inputs are read as float4s from pb");
  static_assert(S::NH >= 1, "the wide form has hidden layers");
  const int odd = ws.layer_of(step) & 1;
  const int g = lane >> 2, t = lane & 3;
  const float* res = ws.resident(step);
  float* ub = S::NH == 1 ? pb + S::UB : pb;
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    // The conditioning inputs of the tile's row r at ub[r * CP + c], 0
    // past C (the last group's transformers are done with pb: __syncwarp
    // below them).
    if constexpr (S::CP == S::C) {
      for (int e = lane; e < 16 * S::C; e += 32) {
        ub[e] = F[(16 * m + e / S::C) * S::FROW + 2 * (e % S::C) + 1 - odd];
      }
    } else {
      for (int e = lane; e < 16 * S::CP; e += 32) {
        const int c = e % S::CP;
        ub[e] = c < S::C
                    ? F[(16 * m + e / S::CP) * S::FROW + 2 * c + 1 - odd]
                    : 0.f;
      }
    }
    __syncwarp();
    const float4* u0 = reinterpret_cast<const float4*>(ub + g * S::CP);
    const float4* u1 = reinterpret_cast<const float4*>(ub + (g + 8) * S::CP);
    if constexpr (S::NH == 1) {
      wide_groups<S, DENSITY>(
          ws, m, odd, res, tb, F, pb, lane, ldp,
          [&](int s, uint32_t (&ah)[4], uint32_t (&al)[4]) {
            wide_first_fragment<S>(res, u0, u1, s, t, ah, al);
          });
    } else {
      constexpr int N = S::KS(1);
      float acc[1][N][4];
      zero_acc(acc);
#pragma unroll 1
      for (int c2 = 0; c2 < S::NCH(0); ++c2) {
        const float* wc = ws.next();
#pragma unroll 1
        for (int sl = 0; sl < S::KWH(0); ++sl) {
          uint32_t hh[4], hl[4];
          wide_first_fragment<S>(res, u0, u1, c2 * S::KWH(0) + sl, t, hh,
                                 hl);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const WeightFragment b(wc + 64 * (sl * N + j) + 2 * lane);
            mma_split_step(acc[0][j], hh, hl, b);
          }
        }
      }
      bias_relu<1, false>(res, nullptr, S::B2, acc, t);
      wide_rest<S, 1, DENSITY>(ws, m, odd, res, tb, F, pb, lane, ldp, acc);
    }
  }
}

// A whole pass in the wide form: the warp's 32 particles at F (row p for
// particle p, written by every lane before the call), every layer in the
// direction of `ws`, through the block's stream (all of the block's threads
// call it together). Adds lane l's particle's log-det to log_det; F then
// holds the pass's output.
template <class S, bool DENSITY>
__device__ __forceinline__ void flow_pass_wide(WideStream<S>& ws, float tb,
                                               float* __restrict__ F,
                                               float* __restrict__ pb,
                                               int lane, float& log_det) {
  __syncwarp();
  ws.begin();
  float ldp[2] = {0.f, 0.f};
#pragma unroll 1
  for (int step = 0; step < ws.n_layers; ++step) {
    coupling_layer_wide<S, DENSITY>(ws, step, tb, F, pb, lane, ldp);
  }
  // Particle r + 16m's log-det: its two lanes' (r and r + 16) sums.
  const float a0 = ldp[0] + __shfl_xor_sync(0xffffffffu, ldp[0], 16);
  const float a1 = ldp[1] + __shfl_xor_sync(0xffffffffu, ldp[1], 16);
  log_det += lane < 16 ? a0 : a1;
}

// The packed layout of shape S as the libraries report it: floats per
// layer, the offsets of W1, b1, W2, b2, W3 and b3 (-1 for a section the
// shape has not), the warp buffer's row stride and size, the wide form's
// resident part and chunk (0 for the whole-layer form), then the offsets
// of every further hidden product's fragments and bias (WH(j), BH(j) for
// 1 <= j < NH - 1), then (with `warps`) the most warps of a coupling block,
// into out (up to capacity entries). Returns their number.
template <class S>
int mma_layout_table(int* out, int capacity, bool warps) {
  int count = 0;
  auto put = [&](int v) {
    if (count < capacity) out[count] = v;
    ++count;
  };
  for (int v : {S::SIZE, S::W1, S::B1, S::W2, S::B2, S::W3, S::B3, S::ROW,
                S::STAGE, S::RES, S::CHUNK}) {
    put(v);
  }
  for (int j = 1; j + 1 < S::NH; ++j) {
    put(S::WH(j));
    put(S::BH(j));
  }
  if (warps) put(S::WARPS);
  return count;
}

}  // namespace aspire
