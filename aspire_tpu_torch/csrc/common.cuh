// Device functions shared by the CUDA kernels: the rational-quadratic
// spline and affine transformers of one value (the coupling-flow kernel
// coupling.cu, the whole-chain kernel chain.cu and the tile-cooperative
// coupling kernels staged_coupling.cu through coupling_mma.cuh, and the MAF
// density kernel maf.cu), the dev prototypes' rqs_micro spline
// (staged_coupling.cu's D3), and Philox4x32-10 (chain.cu, prng.cu).
//
// Replaces the per-tile helpers of the TPU kernels in
// aspire_tpu/ops/fused_coupling.py (_rqs_rows, _affine_rows). The TPU
// layout (features on sublanes, padded 8-row parameter groups, lane-half
// MXU/VPU pipelining) is not carried over: the transformers are the plain
// per-value formulas of aspire_tpu_torch/flows/bijectors.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aspire {

constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The current device's multiprocessor count and largest opt-in dynamic
// shared memory per block, read once per device. A launch runs on the
// current device, which the Python wrappers make the card of the tensors
// the kernel reads, so one process may drive several cards.
struct DeviceLimits {
  int sms;
  int max_smem;
};

constexpr int kMaxDevices = 64;

inline DeviceLimits current_device_limits() {
  static DeviceLimits cache[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  DeviceLimits fresh = {0, 0};
  DeviceLimits* slot =
      device >= 0 && device < kMaxDevices ? &cache[device] : &fresh;
  if (slot->sms == 0) {
    int sms = 0, max_smem = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    slot->max_smem = max_smem;
    slot->sms = sms;
  }
  return *slot;
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

// benchmarks/dev/packed_ab.py::rqs_micro, density direction: the bin
// softmax without its max subtraction (exp(min(r, 60))) and the minimum
// width folded into the 2 * tail_bound scale. Not the same function as
// rqs<K, true> where every raw width or height of a row is below about
// -87 (exp leaves the normal float32 range) and, below about -104, exp
// underflows to 0 and the row normalises 0 / 0.
template <int K>
__device__ __forceinline__ void rqs_micro(float v,
                                          const float (&raw)[3 * K - 1],
                                          float tb, float& y, float& ld) {
  const float c0 = 2.f * tb * kMinBinWidth;
  const float c1 = 2.f * tb * (1.f - kMinBinWidth * K);
  float ew[K], eh[K], sw = 0.f, sh = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ew[j] = expf(fminf(raw[j], 60.f));
    eh[j] = expf(fminf(raw[K + j], 60.f));
    sw += ew[j];
    sh += eh[j];
  }
  const bool inside = (v > -tb) && (v < tb);
  const float safe = fminf(fmaxf(v, -tb), tb);
  float cx = 0.f, cy = 0.f;
  float x_k = 0.f, y_k = 0.f, w = 1.f, h = 1.f;
  int k = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ws = c0 + c1 * (ew[j] / sw);
    const float hs = c0 + c1 * (eh[j] / sh);
    cx += ws;
    cy += hs;
    const float x_lo = (cx - tb) - ws;
    const float y_lo = (cy - tb) - hs;
    if (j == 0 || safe >= y_lo) {
      k = j;
      x_k = x_lo;
      y_k = y_lo;
      w = ws;
      h = hs;
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
  const float s = h / w;
  const float t = d_k1 + d_k - 2.f * s;
  const float y_rel = safe - y_k;
  const float a = h * (s - d_k) + y_rel * t;
  const float b = h * d_k - y_rel * t;
  const float c = -s * y_rel;
  const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
  const float xi = fminf(fmaxf((2.f * c) / (-b - sqrtf(disc)), 0.f), 1.f);
  const float xm = 1.f - xi;
  const float den = s + t * xi * xm;
  const float l = 2.f * logf(s) +
                  logf(d_k1 * xi * xi + 2.f * s * xi * xm + d_k * xm * xm) -
                  2.f * logf(den);
  y = inside ? xi * w + x_k : v;
  ld = inside ? -l : 0.f;
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

// The hidden widths of a conditioner, in order: any number of them, each
// a multiple of 8 (ops/fused_coupling.py::kernel_hidden pads them).
namespace aspire {
template <int... WIDTHS>
struct Hidden {
  static constexpr int N = sizeof...(WIDTHS);
  __host__ __device__ static constexpr int width(int i) {
    constexpr int w[] = {WIDTHS..., 0};
    return w[i];
  }
};
}  // namespace aspire

// A configuration row's hidden widths, written in parentheses: (64, 64),
// (128,), () for none, as the type Hidden<...>.
#define ASPIRE_HIDDEN(...) aspire::Hidden<__VA_ARGS__>

// Coupling-flow kernel configurations compiled into the library: (id, D,
// (H...), K, RQS), hidden widths multiples of 8 (coupling_mma.cuh
// MmaShape; an odd D pads each half of a layer to (D + 1) / 2 dims).
// ops/fused_coupling.py::KERNEL_CONFIGS mirrors this list. Configuration 2
// is BASELINE config 5's flow (nsf, 6 x (128, 128) at d = 32; depth is no
// part of a configuration); 3 and 4 are nsf-tpu at d = 2 and d = 5, the
// JAX package's validation rows (Rosenbrock, Neal's funnel).
#define ASPIRE_COUPLING_CONFIGS(X) \
  X(0, 4, (64, 64), 8, true)       \
  X(1, 4, (64, 64), 1, false)      \
  X(2, 32, (128, 128), 8, true)    \
  X(3, 2, (64, 64), 8, true)       \
  X(4, 5, (64, 64), 8, true)

// Configurations of the whole-chain kernel (a subset of the above), with
// the in-kernel targets each compiles (TARGETS, chain.cu kLastTarget: 0
// for ids 1-3, 1 for ids 1-5). ops/fused_mutation.py::CHAIN_CONFIGS
// mirrors this list.
#define ASPIRE_CHAIN_CONFIGS(X)    \
  X(0, 4, (64, 64), 8, true, 0)    \
  X(2, 32, (128, 128), 8, true, 0) \
  X(3, 2, (64, 64), 8, true, 1)    \
  X(4, 5, (64, 64), 8, true, 1)

// Configurations of the MAF-RQS density kernel (maf.cu, whose MafShape is
// the packed layout): (id, D, (H...), K), hidden widths multiples of 8.
// ops/fused_coupling.py::MAF_KERNEL_CONFIGS mirrors this list.
#define ASPIRE_MAF_CONFIGS(X) X(0, 4, (64, 64), 8)

// Configurations of the tile-cooperative coupling density pass
// (staged_coupling.cu): (id, D, H1, H2, K, Q, S, PAIRED, MICRO), Q sub-tiles
// of S particles. D1/D2 (not PAIRED): a block's tile; S is the largest
// multiple of 16 whose Q sub-tile buffers fit beside 4 layers' weights in
// one block's shared memory with at most 512 threads (2QS) in the block,
// 128 registers each. D3 (PAIRED): a warp's tile, two 16-row tiles (Q = 2,
// S = 16). ops/staged_coupling.py::STAGED_CONFIGS mirrors this list and
// ::sub_tile gives the same S.
#define ASPIRE_STAGED_CONFIGS(X)           \
  X(0, 4, 64, 64, 8, 2, 128, false, false) \
  X(1, 4, 64, 64, 8, 3, 80, false, false)  \
  X(2, 4, 64, 64, 8, 4, 64, false, false)  \
  X(3, 4, 64, 64, 8, 8, 32, false, false)  \
  X(4, 4, 64, 64, 8, 2, 16, true, false)   \
  X(5, 4, 64, 64, 8, 2, 16, true, true)
