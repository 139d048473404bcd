// Uniforms in (0, 1] from Philox4x32-10 keyed by a seed pair.
//
// Replaces the TPU kernel benchmarks/dev/prng_probe.py::kernel (called
// through run), which seeds the TPU's on-core generator with a pair of
// int32 and turns each 32-bit word into u = (bits >> 8) * 2^-24 + 2^-25.
// The TPU's bits cannot be reproduced; here the words come from
// Philox4x32-10 (common.cuh, the chain kernel's generator): element e takes
// word e % 4 of the block for counter (e / 4 low word, e / 4 high word, 0,
// 0) under key (seed0, seed1). The conversion is the probe's, in the same
// float32 arithmetic, on unsigned words: the probe's words are int32, so
// its shift is arithmetic and its u lies in (-0.5, 0.5), not in the (0, 1)
// its comment intends. In float32 the largest word gives exactly 1.0.
//
// What bounds it on an H100: device memory. Each output float is written
// once and nothing is read; the ten Philox rounds (integer multiplies) per
// four outputs stay below the write time. The design: one thread per
// group of four elements, one 16-byte store per group, a grid-stride loop.

#include "common.cuh"

namespace aspire {

__device__ __forceinline__ float probe_uniform(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f +
         2.98023223876953125e-08f;
}

__global__ void prng_kernel(float* __restrict__ out, long long n, uint2 key) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 b = philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)(g >> 32), 0u, 0u), key);
    const float4 u = make_float4(probe_uniform(b.x), probe_uniform(b.y),
                                 probe_uniform(b.z), probe_uniform(b.w));
    const long long e = 4 * g;
    if (e + 3 < n) {
      reinterpret_cast<float4*>(out)[g] = u;
    } else {
      const float v[4] = {u.x, u.y, u.z, u.w};
      for (int r = 0; e + r < n; ++r) out[e + r] = v[r];
    }
  }
}

}  // namespace aspire

extern "C" {

// out: n float32 (16-byte aligned). Returns the launch's cudaError_t.
int aspire_prng_uniforms(float* out, long long n, uint32_t seed0,
                         uint32_t seed1, void* stream) {
  if (n <= 0) return 0;
  const int sms = aspire::current_device_limits().sms;
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  aspire::prng_kernel<<<(int)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      out, n, make_uint2(seed0, seed1));
  return (int)cudaGetLastError();
}

}  // extern "C"
