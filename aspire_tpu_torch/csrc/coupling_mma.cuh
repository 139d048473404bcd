// The coupling-flow pass on the tensor cores, shared by the coupling-flow
// kernel (coupling.cu, B1/B3) and the whole-chain kernel (chain.cu, B2).
//
// A warp carries 32 particles, lane l holding particle l's coordinates.
// Per coupling layer the conditioner's two wide products, h1 . W2 and
// h2 . W3, run as mma.sync m16n8k8 TF32 over the warp's two 16-row tiles
// in split form (3xTF32: every operand a = hi + lo in two TF32 values,
// each product lo.hi + hi.lo + hi.hi), which keeps float32 accuracy; each
// weight fragment is read from shared memory once for both row tiles. The
// packed W2 and W3 weights are sums of two TF32 values
// (ops/fused_coupling.py::split_tf32_sum), so their split is exact, and are
// stored in the mma B-fragment order with the k order that makes one
// product's accumulator the next one's A fragment: h1 and h2 never leave
// the warp's registers. W1 (the D/2 conditioning inputs) stays on FP32
// FMAs; the inputs reach the fragment rows by warp shuffles. The
// transformer parameters go from the accumulator fragments to their
// particle's thread through a per-warp shared buffer, and each thread runs
// the D/2 transformers (rqs or affine of common.cuh) of its own particle.

#pragma once

#include "common.cuh"

namespace aspire {

// Packed weight layout (built by ops/fused_coupling.py::prepare_mma_params),
// per coupling layer, every section starting on a multiple of 4 floats.
// Layer l transforms the A = D/2 active dims 2a + (l & 1), conditioned on
// the C = D/2 dims 2c + 1 - (l & 1):
//   W1  (H1 x C)            W1[u*C + c] = w0[conditioning dim c][u]
//   b1  (H1)
//   W2  KS1 x KS2 fragments k-step s, n-tile j at index s * KS2 + j
//   b2  (H2)
//   W3  KS2 x NT fragments  k-step s, n-tile m at index s * NT + m
//   b3  (A x G)             b3[a*G + q] = b2[active dim a][q], q < P
// A fragment is 32 lanes x 2 floats: lane 4g + t holds W[8s + 2t][8j + g]
// and W[8s + 2t + 1][8j + g] (rows: input units; W3's columns: the active
// dims' P transformer parameters, 3K - 1 for a spline and 2 for an affine
// map, each dim's group zero-padded to G, a multiple of 8). Every W2 and
// W3 weight is the sum of two TF32 values.
template <int D_, int H1_, int H2_, int K_, bool RQS_>
struct MmaShape {
  static_assert(D_ % 2 == 0, "the tensor-core pass takes an even dimension");
  static_assert(H1_ % 8 == 0 && H2_ % 8 == 0, "hidden widths must be /8");
  static constexpr int D = D_, H1 = H1_, H2 = H2_, K = K_;
  static constexpr bool RQS = RQS_;
  static constexpr int A = D / 2;
  static constexpr int C = D / 2;
  static constexpr int P = RQS ? 3 * K - 1 : 2;
  static constexpr int G = (P + 7) / 8 * 8;
  static constexpr int OUT = A * G;
  static constexpr int KS1 = H1 / 8;  // k-steps of W2
  static constexpr int KS2 = H2 / 8;  // n-tiles of W2, k-steps of W3
  static constexpr int NT = OUT / 8;  // n-tiles of W3
  static constexpr int W1 = 0;
  static constexpr int B1 = round4(W1 + H1 * C);
  static constexpr int W2 = round4(B1 + H1);
  static constexpr int B2 = W2 + 64 * KS1 * KS2;
  static constexpr int W3 = round4(B2 + H2);
  static constexpr int B3 = W3 + 64 * KS2 * NT;
  static constexpr int SIZE = round4(B3 + OUT);  // floats per layer
  // A warp's buffer of transformer parameters: its 32 particles' OUT
  // floats, rows ROW floats apart (the 4 extra floats put the 8 rows a
  // quarter warp reads with float4 loads in distinct banks).
  static constexpr int ROW = OUT + 4;
  static constexpr int STAGE = 32 * ROW;
};

// x = hi + lo: hi is x rounded to the nearest TF32 value (ties away from
// zero, cvt.rna.tf32.f32 done in integer ops). With ROUND_LO, lo is x - hi
// rounded the same way, which leaves an error below 2^-23 |x|; without,
// lo = x - hi exactly and the tensor core reads its top 11 significant
// bits, which leaves an error below 2^-21 |x|.
template <bool ROUND_LO>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
  if constexpr (ROUND_LO) lo = (lo + 0x1000u) & 0xFFFFE000u;
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

// d += A . B for one k-step in the pass's arithmetic. ROUNDED (the
// coupling kernel's): lo rounded to TF32 (split_tf32<true>), and the
// k-step's three products summed from zero and added to d in float32
// (round to nearest): one cut per k-step, at the scale of the k-step's own
// sum rather than of d. Otherwise (the chain kernel's): lo cut by the
// tensor core, every product summed into d. Over a 64-wide product the
// cuts of the second add up to an error of one sign, twice float32's in
// root mean square on the coupling flows checked (tests/
// test_torch_coupling_layout.py::test_kstep_sums_keep_the_card_tolerance
// models it).
template <bool ROUNDED>
__device__ __forceinline__ void mma_split_step(float (&d)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const WeightFragment& b) {
  if constexpr (ROUNDED) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    mma_split(s, ah, al, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += s[i];
  } else {
    mma_split(d, ah, al, b);
  }
}

// The conditioner of one coupling layer for the warp's 32 particles. Lane
// 4g + t brings u[r][c], conditioning input c of particle g + 8r (row tile
// r / 2), and gets, as does every lane, the rows g + 8r of the fragments;
// the transformer parameters of particle p's active dim a go to
// buf[p * ROW + a * G + q]. ROUNDED: see mma_split_step.
template <class S, bool ROUNDED>
__device__ __forceinline__ void conditioner_mma(const float* __restrict__ w,
                                                const float (&u)[4][S::C],
                                                float* __restrict__ buf,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
  // Second hidden layer's accumulators: row tile m, n-tile j.
  float acc[2][S::KS2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < S::KS2; ++j) {
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < S::KS1; ++s) {
    // First hidden layer, units 8s + 2t + e, in each row tile's A-fragment
    // order: (g, e = 0), (g + 8, 0), (g, 1), (g + 8, 1).
    uint32_t hh[2][4], hl[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int unit = 8 * s + 2 * t + e;
      const float bias = w[S::B1 + unit];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < S::C; ++c) {
          a = fmaf(w[S::W1 + unit * S::C + c], u[r][c], a);
        }
        const int q = 2 * e + (r & 1);
        split_tf32<ROUNDED>(fmaxf(a + bias, 0.f), hh[r >> 1][q],
                            hl[r >> 1][q]);
      }
    }
#pragma unroll
    for (int j = 0; j < S::KS2; ++j) {
      const WeightFragment b(w + S::W2 + 64 * (s * S::KS2 + j) + 2 * lane);
      mma_split_step<ROUNDED>(acc[0][j], hh[0], hl[0], b);
      mma_split_step<ROUNDED>(acc[1][j], hh[1], hl[1], b);
    }
  }
  // h2 = relu(acc + b2), kept as the accumulator fragments.
#pragma unroll
  for (int j = 0; j < S::KS2; ++j) {
    const float2 bias =
        *reinterpret_cast<const float2*>(w + S::B2 + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][j][0] = fmaxf(acc[m][j][0] + bias.x, 0.f);
      acc[m][j][1] = fmaxf(acc[m][j][1] + bias.y, 0.f);
      acc[m][j][2] = fmaxf(acc[m][j][2] + bias.x, 0.f);
      acc[m][j][3] = fmaxf(acc[m][j][3] + bias.y, 0.f);
    }
  }
  // Output layer, k-step outer so the accumulators free up as it goes.
  float out[2][S::NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
      out[m][n][0] = out[m][n][1] = out[m][n][2] = out[m][n][3] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < S::KS2; ++s) {
    // The accumulator of n-tile s, (g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1), is the A fragment of k-step s in the order (g, 2t),
    // (g+8, 2t), (g, 2t+1), (g+8, 2t+1).
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split_tf32<ROUNDED>(acc[m][s][0], ah[m][0], al[m][0]);
      split_tf32<ROUNDED>(acc[m][s][2], ah[m][1], al[m][1]);
      split_tf32<ROUNDED>(acc[m][s][1], ah[m][2], al[m][2]);
      split_tf32<ROUNDED>(acc[m][s][3], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
      const WeightFragment b(w + S::W3 + 64 * (s * S::NT + n) + 2 * lane);
      mma_split_step<ROUNDED>(out[0][n], ah[0], al[0], b);
      mma_split_step<ROUNDED>(out[1][n], ah[1], al[1], b);
    }
  }
#pragma unroll
  for (int n = 0; n < S::NT; ++n) {
    const int q = 8 * n + 2 * t;
    const float2 bias = *reinterpret_cast<const float2*>(w + S::B3 + q);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = 16 * m + g;
      *reinterpret_cast<float2*>(buf + row * S::ROW + q) =
          make_float2(out[m][n][0] + bias.x, out[m][n][1] + bias.y);
      *reinterpret_cast<float2*>(buf + (row + 8) * S::ROW + q) =
          make_float2(out[m][n][2] + bias.x, out[m][n][3] + bias.y);
    }
  }
}

// One coupling layer of the warp's 32 particles, lane l holding particle
// l in f, with the layer's packed weights at w. DENSITY (data -> latent)
// runs the transformers' inverse (rqs<K, true> / affine<true>), sampling
// their forward; the layer's log-det is added to log_det. All 32 lanes
// call it together, after a __syncwarp since the buffer's last reads.
// ROUNDED: see mma_split_step.
template <class S, bool DENSITY, bool ROUNDED>
__device__ __forceinline__ void coupling_layer_mma(const float* __restrict__ w,
                                                   int layer, float tb,
                                                   float* __restrict__ buf,
                                                   int lane, float (&f)[S::D],
                                                   float& log_det) {
  const bool odd = layer & 1;
  float u[4][S::C];
#pragma unroll
  for (int c = 0; c < S::C; ++c) {
    const float v = odd ? f[2 * c] : f[2 * c + 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      u[r][c] = __shfl_sync(0xffffffffu, v, (lane >> 2) + 8 * r);
    }
  }
  conditioner_mma<S, ROUNDED>(w, u, buf, lane);
  __syncwarp();
  float ld = 0.f;
#pragma unroll
  for (int a = 0; a < S::A; ++a) {
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
    if constexpr (S::RQS) {
      rqs<S::K, DENSITY>(odd ? f[2 * a + 1] : f[2 * a], par, tb, y, e);
    } else {
      affine<DENSITY>(odd ? f[2 * a + 1] : f[2 * a], par, y, e);
    }
    if (odd) {
      f[2 * a + 1] = y;
    } else {
      f[2 * a] = y;
    }
    ld += e;
  }
  log_det += ld;
  __syncwarp();
}

// The flow density pass (data -> latent, layers in order) of the warp's
// 32 particles with every layer's packed weights at w, in the chain
// kernel's arithmetic.
template <class S>
__device__ __forceinline__ void flow_density(const float* __restrict__ w,
                                             int n_layers, float tb,
                                             float* __restrict__ buf,
                                             int lane, float (&f)[S::D],
                                             float& log_det) {
  __syncwarp();
#pragma unroll 1
  for (int layer = 0; layer < n_layers; ++layer) {
    coupling_layer_mma<S, true, false>(w + layer * S::SIZE, layer, tb, buf,
                                       lane, f, log_det);
  }
}

}  // namespace aspire
