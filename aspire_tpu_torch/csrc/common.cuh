// Device functions shared by the CUDA kernels: the rational-quadratic
// spline and affine transformers of one value (the coupling-flow kernel
// coupling.cu and the whole-chain kernel chain.cu through
// coupling_mma.cuh, the MAF density kernel maf.cu, the tile-cooperative
// coupling kernels staged_coupling.cu), the per-particle packed layout of
// staged_coupling.cu's paired schedule (D3), and Philox4x32-10 (chain.cu,
// prng.cu).
//
// Replaces the per-tile helpers of the TPU kernels in
// aspire_tpu/ops/fused_coupling.py (_rqs_rows, _affine_rows). The TPU
// layout (features on sublanes, padded 8-row parameter groups, lane-half
// MXU/VPU pipelining) is not carried over: the transformers are the plain
// per-value formulas of aspire_tpu_torch/flows/bijectors.py.
//
// Per-particle packed weight layout of the paired staged coupling kernel
// (D3; built by ops/fused_coupling.py::prepare_params), per flow layer,
// every section starting on a multiple of 4 floats:
//   W1  (H1 x D)     W1[j*D + i]      = w0[i][j]
//   b1  (H1)
//   W2  (H2 x H1)    W2[k*H1 + j]     = w1[j][k]
//   b2  (H2)
//   W3  (H2 x OUTP)  W3[k*OUTP + o]   = w2[k][col(o)], active dims only
//   b3  (OUTP)
// where OUT = A*P columns hold the transformer parameters of the A =
// (D+1)/2 active dims (P per dim; a zero dummy group pads odd D) and
// OUTP rounds OUT up to 4.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aspire {

constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <int D, int H1, int H2, int K, bool RQS>
struct Shape {
  static_assert(H1 % 4 == 0 && H2 % 4 == 0, "hidden widths must be /4");
  static constexpr int P = RQS ? 3 * K - 1 : 2;
  static constexpr int A = (D + 1) / 2;
  static constexpr int OUT = A * P;
  static constexpr int OUTP = round4(OUT);
  static constexpr int W1 = 0;
  static constexpr int B1 = round4(W1 + H1 * D);
  static constexpr int W2 = round4(B1 + H1);
  static constexpr int B2 = round4(W2 + H2 * H1);
  static constexpr int W3 = round4(B2 + H2);
  static constexpr int B3 = round4(W3 + H2 * OUTP);
  static constexpr int SIZE = round4(B3 + OUTP);  // floats per layer
};

// Dim i is transformed (active) by layer `layer` iff its parity matches
// the layer's: the complement of the JAX package's conditioning mask
// ((i % 2) + layer) % 2 == 1. An active dim's parameter group is i / 2.
__device__ __forceinline__ bool is_active(int i, int layer) {
  return (i & 1) == (layer & 1);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Rational-quadratic spline of one value; raw = its 3K-1 parameters.
// INVERSE = data -> latent (the density direction of a coupling layer).
// Mirrors flows/bijectors.py::rational_quadratic_spline: the bin is the
// count-based index of the last left knot <= value, clipped to [0, K-1];
// values outside [-B, B] pass through with log-det 0; the inverse takes
// the stable root 2c / (-b - sqrt(max(disc, 0))).
template <int K, bool INVERSE>
__device__ __forceinline__ void rqs(float v, const float (&raw)[3 * K - 1],
                                    float tb, float& y, float& ld) {
  float mw = raw[0], mh = raw[K];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    mw = fmaxf(mw, raw[j]);
    mh = fmaxf(mh, raw[K + j]);
  }
  float ew[K], eh[K], sw = 0.f, sh = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ew[j] = expf(raw[j] - mw);
    eh[j] = expf(raw[K + j] - mh);
    sw += ew[j];
    sh += eh[j];
  }
  const float inside_w = 1.f - kMinBinWidth * K;
  const float inside_h = 1.f - kMinBinHeight * K;
  const bool inside = (v > -tb) && (v < tb);
  const float safe = fminf(fmaxf(v, -tb), tb);
  float cw = 0.f, ch = 0.f;
  float x_k = -tb, x_k1 = -tb, y_k = -tb, y_k1 = -tb;
  int k = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float lo_x = (j == 0) ? -tb : cw * (2.f * tb) - tb;
    const float lo_y = (j == 0) ? -tb : ch * (2.f * tb) - tb;
    cw += kMinBinWidth + inside_w * (ew[j] / sw);
    ch += kMinBinHeight + inside_h * (eh[j] / sh);
    const float lo = INVERSE ? lo_y : lo_x;
    if (safe >= lo) {
      k = j;
      x_k = lo_x;
      y_k = lo_y;
      x_k1 = cw * (2.f * tb) - tb;
      y_k1 = ch * (2.f * tb) - tb;
    }
  }
  float rl = 0.f, rr = 0.f;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (j == k - 1) rl = raw[2 * K + j];
    if (j == k) rr = raw[2 * K + j];
  }
  const float d_k = (k == 0) ? 1.f : kMinDerivative + softplus(rl);
  const float d_k1 = (k == K - 1) ? 1.f : kMinDerivative + softplus(rr);
  const float w = x_k1 - x_k;
  const float h = y_k1 - y_k;
  const float s = h / w;
  const float t = d_k1 + d_k - 2.f * s;
  float out, xi;
  if (INVERSE) {
    const float y_rel = safe - y_k;
    const float a = h * (s - d_k) + y_rel * t;
    const float b = h * d_k - y_rel * t;
    const float c = -s * y_rel;
    const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
    xi = (2.f * c) / (-b - sqrtf(disc));
    xi = fminf(fmaxf(xi, 0.f), 1.f);
    out = xi * w + x_k;
  } else {
    xi = fminf(fmaxf((safe - x_k) / w, 0.f), 1.f);
    const float xm = 1.f - xi;
    out = y_k + h * (s * xi * xi + d_k * xi * xm) /
                    (s + t * xi * xm);
  }
  const float xm = 1.f - xi;
  const float den = s + t * xi * xm;
  float l = 2.f * logf(s) +
            logf(d_k1 * xi * xi + 2.f * s * xi * xm + d_k * xm * xm) -
            2.f * logf(den);
  if (INVERSE) l = -l;
  y = inside ? out : v;
  ld = inside ? l : 0.f;
}

template <bool INVERSE>
__device__ __forceinline__ void affine(float v, const float (&raw)[2],
                                       float& y, float& ld) {
  const float shift = raw[0];
  const float log_scale = 3.f * tanhf(raw[1] / 3.f);
  if (INVERSE) {
    y = (v - shift) * expf(-log_scale);
    ld = -log_scale;
  } else {
    y = v * expf(log_scale) + shift;
    ld = log_scale;
  }
}

// Philox4x32-10 (Salmon et al. 2011, the Random123 constants): the
// chain kernel's proposal noise (chain.cu) and the uniforms kernel
// (prng.cu).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Cooperative copy of `n4` float4s from global to shared memory.
__device__ __forceinline__ void load_shared(float4* dst,
                                            const float4* __restrict__ src,
                                            int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
}

}  // namespace aspire

// Coupling-flow kernel configurations compiled into the library: (id, D,
// H1, H2, K, RQS), D even and hidden widths multiples of 8 (coupling_mma.cuh
// MmaShape). ops/fused_coupling.py::KERNEL_CONFIGS mirrors this list.
// Configuration 2 is BASELINE config 5's flow (nsf, 6 x (128, 128) at
// d = 32; depth is no part of a configuration).
#define ASPIRE_COUPLING_CONFIGS(X) \
  X(0, 4, 64, 64, 8, true)         \
  X(1, 4, 64, 64, 1, false)        \
  X(2, 32, 128, 128, 8, true)

// Configurations of the whole-chain kernel (a subset of the above).
#define ASPIRE_CHAIN_CONFIGS(X) \
  X(0, 4, 64, 64, 8, true)      \
  X(2, 32, 128, 128, 8, true)

// Configurations of the MAF-RQS density kernel (maf.cu, whose MafShape is
// the packed layout): (id, D, H1, H2, K), hidden widths multiples of 8.
// ops/fused_coupling.py::MAF_KERNEL_CONFIGS mirrors this list.
#define ASPIRE_MAF_CONFIGS(X) X(0, 4, 64, 64, 8)

// Configurations of the tile-cooperative coupling density pass
// (staged_coupling.cu): (id, D, H1, H2, K, Q, S, PAIRED, MICRO) with Q
// sub-tiles of S particles per block. S is the largest multiple of 16 whose
// Q sub-tile buffers fit beside 4 layers' weights in one block's shared
// memory, in the variant's layout (StagedLayout); for D1/D2 (not PAIRED)
// also with at most 512 threads (2QS) in the block, 128 registers each.
// ops/staged_coupling.py::STAGED_CONFIGS mirrors this list and ::sub_tile
// gives the same S.
#define ASPIRE_STAGED_CONFIGS(X)           \
  X(0, 4, 64, 64, 8, 2, 128, false, false) \
  X(1, 4, 64, 64, 8, 3, 80, false, false)  \
  X(2, 4, 64, 64, 8, 4, 64, false, false)  \
  X(3, 4, 64, 64, 8, 8, 32, false, false)  \
  X(4, 4, 64, 64, 8, 2, 64, true, false)   \
  X(5, 4, 64, 64, 8, 2, 64, true, true)
