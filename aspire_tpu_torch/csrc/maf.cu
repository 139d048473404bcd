// MAF-RQS density pass (data -> latent) of the whole multi-layer flow in
// one launch.
//
// Replaces the TPU kernel aspire_tpu/ops/fused_coupling.py::_maf_kernel
// (called through _pallas_maf_forward). Computes MAF._forward_xla: per
// layer one MADE of the layer's input gives the spline parameters of ALL
// D dims, each dim takes the inverse rational-quadratic spline, and the
// dims are reversed after every layer (including the last).
//
// What bounds it on an H100: arithmetic. Per particle and layer the MADE
// costs H1*D + H1*H2 + H2*D*G fused multiply-adds with the masks
// premultiplied into dense weights (~10.5k for maf_rqs(4): 4 layers, (64,
// 64) hidden, 8 bins, so ~84 kFLOP per particle, twice the coupling pass
// because every dim is transformed), against 20 bytes of input and output.
// Device memory is idle; the FP32 pipes (no tensor cores in this simple
// design) set the time.
//
// Design: one thread owns one particle; every layer's packed weights
// (171,520 B for maf_rqs(4)) sit in dynamic shared memory, read as
// broadcasts (every thread of a warp reads the same weight). That leaves
// one 256-thread block per SM. To keep registers down, the first hidden
// layer is streamed unit by unit into the second's accumulators (only h2,
// H2 floats, is live with the input), then the output layer produces one
// dim's G spline parameters at a time and applies that dim's spline
// before the next dim, so at most H2 + G parameters are live. The dim
// loop reads and writes the particle's coordinates through compile-time
// selects, and the reversal is a register renaming.

#include "common.cuh"

namespace aspire {

constexpr int kMafThreads = 256;

// One MAF layer for one particle: z <- reverse(spline^-1(z; MADE(z))).
template <int D, int H1, int H2, int K>
__device__ __forceinline__ void maf_layer(const float* __restrict__ w,
                                          float tb, float (&z)[D],
                                          float& log_det) {
  using S = MafShape<D, H1, H2, K>;
  float h2[H2];
#pragma unroll
  for (int k = 0; k < H2; ++k) h2[k] = 0.f;
#pragma unroll 1
  for (int j = 0; j < H1; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) a = fmaf(w[S::W1 + j * D + i], z[i], a);
    const float h1 = fmaxf(a + w[S::B1 + j], 0.f);
    const float4* row = reinterpret_cast<const float4*>(w + S::W2 + j * H2);
#pragma unroll
    for (int k4 = 0; k4 < H2 / 4; ++k4) {
      const float4 v = row[k4];
      h2[4 * k4 + 0] = fmaf(v.x, h1, h2[4 * k4 + 0]);
      h2[4 * k4 + 1] = fmaf(v.y, h1, h2[4 * k4 + 1]);
      h2[4 * k4 + 2] = fmaf(v.z, h1, h2[4 * k4 + 2]);
      h2[4 * k4 + 3] = fmaf(v.w, h1, h2[4 * k4 + 3]);
    }
  }
#pragma unroll
  for (int k = 0; k < H2; ++k) h2[k] = fmaxf(h2[k] + w[S::B2 + k], 0.f);

  float y[D];
#pragma unroll
  for (int c = 0; c < D; ++c) y[c] = 0.f;
  float ld = 0.f;
#pragma unroll 1
  for (int i = 0; i < D; ++i) {
    float acc[S::G];
#pragma unroll
    for (int q = 0; q < S::G; ++q) acc[q] = 0.f;
    const float* w3 = w + S::W3 + i * H2 * S::G;
#pragma unroll
    for (int k = 0; k < H2; ++k) {
      const float4* col = reinterpret_cast<const float4*>(w3 + k * S::G);
#pragma unroll
      for (int q4 = 0; q4 < S::G / 4; ++q4) {
        const float4 v = col[q4];
        acc[4 * q4 + 0] = fmaf(v.x, h2[k], acc[4 * q4 + 0]);
        acc[4 * q4 + 1] = fmaf(v.y, h2[k], acc[4 * q4 + 1]);
        acc[4 * q4 + 2] = fmaf(v.z, h2[k], acc[4 * q4 + 2]);
        acc[4 * q4 + 3] = fmaf(v.w, h2[k], acc[4 * q4 + 3]);
      }
    }
    float raw[S::P];
#pragma unroll
    for (int q = 0; q < S::P; ++q) raw[q] = acc[q] + w[S::B3 + i * S::G + q];
    float v = z[0];
#pragma unroll
    for (int c = 1; c < D; ++c) {
      if (c == i) v = z[c];
    }
    float out, e;
    rqs<K, true>(v, raw, tb, out, e);
    ld += e;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      if (c == i) y[c] = out;
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) z[c] = y[D - 1 - c];
  log_det += ld;
}

// One block per SM (the weights take most of its shared memory), so the
// bounds say so: registers up to 255 cost no occupancy.
template <int D, int H1, int H2, int K>
__global__ void __launch_bounds__(kMafThreads, 1)
    maf_kernel(const float* __restrict__ x, float* __restrict__ z,
               float* __restrict__ log_det, const float* __restrict__ weights,
               int n, int n_layers, float tail_bound) {
  using S = MafShape<D, H1, H2, K>;
  extern __shared__ float4 maf_smem4[];
  load_shared(maf_smem4, reinterpret_cast<const float4*>(weights),
              n_layers * S::SIZE / 4);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = x[(size_t)p * D + i];
  float ld = 0.f;
  const float* w = reinterpret_cast<const float*>(maf_smem4);
#pragma unroll 1
  for (int layer = 0; layer < n_layers; ++layer) {
    maf_layer<D, H1, H2, K>(w + layer * S::SIZE, tail_bound, v, ld);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) z[(size_t)p * D + i] = v[i];
  log_det[p] = ld;
}

template <int D, int H1, int H2, int K>
int launch_maf(const float* x, float* z, float* ld, const float* w, int n,
               int n_layers, float tb, cudaStream_t stream) {
  using S = MafShape<D, H1, H2, K>;
  const size_t smem = sizeof(float) * (size_t)n_layers * S::SIZE;
  auto kernel = maf_kernel<D, H1, H2, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kMafThreads - 1) / kMafThreads;
  kernel<<<blocks, kMafThreads, smem, stream>>>(x, z, ld, w, n, n_layers,
                                                tb);
  return (int)cudaGetLastError();
}

}  // namespace aspire

extern "C" {

// Floats per layer of the packed MAF weight buffer for a configuration id.
int aspire_maf_layer_floats(int config) {
#define ASPIRE_MAF_SIZE_CASE(ID, D, H1, H2, K) \
  if (config == ID) return aspire::MafShape<D, H1, H2, K>::SIZE;
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_SIZE_CASE)
#undef ASPIRE_MAF_SIZE_CASE
  return -1;
}

// x, z: (n, D) row-major; log_det: (n,). Data -> latent only.
// Returns the launch's cudaError_t, or -1 for an unknown configuration.
int aspire_maf(const float* x, float* z, float* log_det,
               const float* weights, int n, int n_layers, float tail_bound,
               int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_MAF_CASE(ID, D, H1, H2, K)                                 \
  if (config == ID) {                                                    \
    return aspire::launch_maf<D, H1, H2, K>(x, z, log_det, weights, n,   \
                                            n_layers, tail_bound, s);    \
  }
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_CASE)
#undef ASPIRE_MAF_CASE
  return -1;
}

}  // extern "C"
