// Whole multi-layer coupling flow in one launch (density and sampling).
//
// Replaces the TPU kernel aspire_tpu/ops/fused_coupling.py::_coupling_kernel
// (called through _pallas_apply, modes "forward" and "inverse").
//
// What bounds it on an H100: arithmetic. Per particle and layer the
// conditioner costs about H1*D/2 + H1*H2 + H2*A*P fused multiply-adds
// (~7.1k for nsf-tpu at d = 4, three layers ~21k), against 20 bytes of
// input and output, so device memory is idle and the FP32 pipes (no tensor
// cores in this simple design) set the time. The design keeps every
// intermediate of the MLP and the spline in registers: one thread owns one
// particle, all layers' weights (~90 KB for nsf-tpu at d = 4) sit in
// dynamic shared memory for the whole block, and every thread of a warp
// reads the same weight at once, so each shared load is a broadcast. Only
// the transformer parameters of the active half are computed, and the
// second hidden layer is streamed into the output accumulators to keep
// register pressure down.

#include "common.cuh"

namespace aspire {

constexpr int kCouplingThreads = 256;

template <int D, int H1, int H2, int K, bool RQS, bool DENSITY>
__global__ void __launch_bounds__(kCouplingThreads)
    coupling_kernel(const float* __restrict__ x, float* __restrict__ z,
                    float* __restrict__ log_det,
                    const float* __restrict__ weights, int n, int n_layers,
                    float tail_bound) {
  using S = Shape<D, H1, H2, K, RQS>;
  extern __shared__ float4 smem4[];
  load_shared(smem4, reinterpret_cast<const float4*>(weights),
              n_layers * S::SIZE / 4);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = x[(size_t)p * D + i];
  float ld = 0.f;
  flow_pass<D, H1, H2, K, RQS, DENSITY>(reinterpret_cast<float*>(smem4),
                                        n_layers, tail_bound, v, ld);
#pragma unroll
  for (int i = 0; i < D; ++i) z[(size_t)p * D + i] = v[i];
  log_det[p] = ld;
}

template <int D, int H1, int H2, int K, bool RQS, bool DENSITY>
int launch_coupling(const float* x, float* z, float* ld, const float* w,
                    int n, int n_layers, float tb, cudaStream_t stream) {
  using S = Shape<D, H1, H2, K, RQS>;
  const size_t smem = sizeof(float) * (size_t)n_layers * S::SIZE;
  auto kernel = coupling_kernel<D, H1, H2, K, RQS, DENSITY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kCouplingThreads - 1) / kCouplingThreads;
  kernel<<<blocks, kCouplingThreads, smem, stream>>>(x, z, ld, w, n,
                                                      n_layers, tb);
  return (int)cudaGetLastError();
}

}  // namespace aspire

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int aspire_max_shared_bytes() {
  int device = 0, value = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return value;
}

// Floats per layer of the packed weight buffer for a configuration id.
int aspire_layer_floats(int config) {
#define ASPIRE_SIZE_CASE(ID, D, H1, H2, K, RQS) \
  if (config == ID) return aspire::Shape<D, H1, H2, K, RQS>::SIZE;
  ASPIRE_COUPLING_CONFIGS(ASPIRE_SIZE_CASE)
#undef ASPIRE_SIZE_CASE
  return -1;
}

// x, z: (n, D) row-major; log_det: (n,). density != 0 runs data -> latent.
// Returns the launch's cudaError_t, or -1 for an unknown configuration.
int aspire_coupling(const float* x, float* z, float* log_det,
                    const float* weights, int n, int n_layers,
                    float tail_bound, int config, int density,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_COUPLING_CASE(ID, D, H1, H2, K, RQS)                        \
  if (config == ID) {                                                     \
    return density ? aspire::launch_coupling<D, H1, H2, K, RQS, true>(    \
                         x, z, log_det, weights, n, n_layers, tail_bound, \
                         s)                                               \
                   : aspire::launch_coupling<D, H1, H2, K, RQS, false>(   \
                         x, z, log_det, weights, n, n_layers, tail_bound, \
                         s);                                              \
  }
  ASPIRE_COUPLING_CONFIGS(ASPIRE_COUPLING_CASE)
#undef ASPIRE_COUPLING_CASE
  return -1;
}

}  // extern "C"
