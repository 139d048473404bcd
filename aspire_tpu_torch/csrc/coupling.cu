// Whole multi-layer coupling flow in one launch (density and sampling).
//
// Replaces the TPU kernel aspire_tpu/ops/fused_coupling.py::_coupling_kernel
// (called through _pallas_apply, modes "forward" and "inverse").
//
// What bounds it on an H100: operations. Per particle and layer the
// conditioner costs about H_0*D/2 + the sum of H_j*H_{j+1} + H_last*A*P
// multiply-adds (~7.1k for nsf-tpu at d = 4, three layers ~21k) against
// 20 bytes of input and output, so device memory is idle.
//
// Design:
// - The tensor-core coupling pass of coupling_mma.cuh, shared with the
//   whole-chain kernel (chain.cu): a warp's 32 particles are two 16-row
//   tiles of mma.sync m16n8k8 for the conditioner's products past W1 (any
//   hidden depth) in split TF32 (float32 accuracy), W1 on FP32 FMAs (with
//   no hidden layer, the one product, each thread its own particle's),
//   and each thread runs
//   the transformers (spline or affine, inverse for the density pass,
//   forward for sampling) of its own particle.
// - Weights streamed one layer at a time. A block keeps two layer buffers
//   in shared memory: while its warps compute layer l from one, cp.async
//   copies the next layer of the pass (l + 1, or l - 1 when sampling) into
//   the other, and one barrier per layer hands the buffers over. So the
//   block's shared memory does not grow with depth (2 x 29,888 B of
//   weights and 8 warp buffers of 6,656 B for nsf-tpu at d = 4), and every
//   depth the per-particle design took still runs here.
// - One block per tile of up to 8 warps. A block takes 32 particles per
//   warp and as many warps as spread n over every SM (n = 8192: 2 warps),
//   at most 8; lanes past n compute on zeros and store nothing. Two blocks
//   share an SM: the launch bounds cap a thread at 128 registers (the
//   spline modes spill a few bytes), which ran 7-12% faster than one
//   block of 168-174 registers, and than 12 warps per block (PERF.md).
// - Shapes too wide for a whole layer in shared memory or for a layer's
//   accumulators in registers (MmaShape::WIDE: BASELINE config 5's d = 32,
//   6 x (128, 128), 8 bins, 761,856 tensor-core FLOP per particle and pass)
//   take coupling_kernel_wide: each layer streamed in chunks of W2 and W3
//   through two shared slots, one row tile and one group of two active
//   dims at a time (coupling_mma.cuh, coupling_layer_wide). Where two
//   layers' resident parts leave no warp beside the chunks (one coupling
//   layer of (1024, 1024) at d = 25, 24 bins: 2 x 19,440 floats), the
//   block holds one (MmaShape::ONE_RES) and loads the next layer's once
//   every warp is done with it.
// - Odd d (nsf-tpu at d = 5, the funnel's validation row) pads both halves
//   of a layer to (d + 1) / 2 dims with a zero-weight slot; its output
//   layer goes one active dim at a time (MmaShape::BY_DIM), which keeps a
//   thread's accumulators at 88 floats, and its block (150 KB of shared
//   memory) takes an SM alone, with 255 registers a thread
//   (CouplingBlocks).

#include "coupling_mma.cuh"

// An instance built for one shape at first use (ops/_build.py::
// build_instance) defines ASPIRE_INSTANCE_CONFIG(X) as its configuration
// row, the one it compiles.
#ifdef ASPIRE_INSTANCE_CONFIG
#undef ASPIRE_COUPLING_CONFIGS
#define ASPIRE_COUPLING_CONFIGS(X) ASPIRE_INSTANCE_CONFIG(X)
#endif

namespace aspire {

// The block's threads start copying one packed layer (S::SIZE floats, a
// multiple of 4) into dst.
template <class S>
__device__ __forceinline__ void copy_layer(float* dst,
                                           const float* __restrict__ src) {
  for (int i = 4 * threadIdx.x; i < S::SIZE; i += 4 * blockDim.x) {
    cp_async16(dst + i, src + i);
  }
}

// Blocks of the coupling kernel an SM holds at the most warps (S::WARPS):
// two where two fit its shared memory (228 KB, 1 KB reserved a block),
// capping a thread at 128 registers, else one, which leaves it 255 (nsf-tpu
// at d = 5, whose 128-register build spilled 1.2-2 KB).
template <class S>
struct CouplingBlocks {
  static constexpr int PER_SM =
      2 * (4 * (S::BUFS + S::WARPS * S::STAGE) + 1024) <= 233472 ? 2 : 1;
};

template <int D, class HID, int K, bool RQS, bool DENSITY>
__global__ void __launch_bounds__(
    32 * MmaShape<D, HID, K, RQS>::WARPS,
    CouplingBlocks<MmaShape<D, HID, K, RQS>>::PER_SM)
    coupling_kernel(const float* __restrict__ x, float* __restrict__ z,
                    float* __restrict__ log_det,
                    const float* __restrict__ weights, int n, int n_layers,
                    float tail_bound) {
  using S = MmaShape<D, HID, K, RQS>;
  extern __shared__ float4 coupling_smem4[];
  float* layers = reinterpret_cast<float*>(coupling_smem4);
  float* buf = layers + 2 * S::SIZE + (threadIdx.x >> 5) * S::STAGE;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n;
  // Step s of the pass runs layer s (density) or n_layers - 1 - s
  // (sampling), from buffer s & 1.
  copy_layer<S>(layers,
                weights + (size_t)(DENSITY ? 0 : n_layers - 1) * S::SIZE);
  float f[S::DP];
#pragma unroll
  for (int i = 0; i < D; ++i) f[i] = live ? x[(size_t)p * D + i] : 0.f;
  if constexpr (S::DP > D) f[D] = 0.f;  // the padding slot
  float ld = 0.f;
#pragma unroll 1
  for (int step = 0; step < n_layers; ++step) {
    // This step's layer has landed (each thread waits for its own copies,
    // the barrier for everyone's), and every warp is done with the last
    // step's buffer, which the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_layers) {
      const int next = DENSITY ? step + 1 : n_layers - 2 - step;
      copy_layer<S>(layers + ((step + 1) & 1) * S::SIZE,
                    weights + (size_t)next * S::SIZE);
    }
    coupling_layer_mma<S, DENSITY>(layers + (step & 1) * S::SIZE,
                                   DENSITY ? step : n_layers - 1 - step,
                                   tail_bound, buf, lane, f, ld);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < D; ++i) z[(size_t)p * D + i] = f[i];
    log_det[p] = ld;
  }
}

// The wide form (MmaShape::WIDE, coupling_layer_wide): each warp's 32
// particles in its shared buffer, each layer streamed through the block in
// chunks (WideStream), blocks of up to 8 warps, two per SM where they fit
// (114,688 B of shared memory each at d = 32, (128, 128); 128 registers, a
// few hundred bytes of spill): 9-10% faster than one block of 255
// registers (NVIDIA H100 80GB HBM3 at 700 W, PERF.md). At an odd D a
// particle's row keeps its padding slot, dim D, at 0.
template <int D, class HID, int K, bool RQS, bool DENSITY>
__global__ void __launch_bounds__(
    32 * MmaShape<D, HID, K, RQS>::WARPS,
    CouplingBlocks<MmaShape<D, HID, K, RQS>>::PER_SM)
    coupling_kernel_wide(const float* __restrict__ x, float* __restrict__ z,
                         float* __restrict__ log_det,
                         const float* __restrict__ weights, int n,
                         int n_layers, float tail_bound) {
  using S = MmaShape<D, HID, K, RQS>;
  extern __shared__ float4 coupling_smem4[];
  float* smem = reinterpret_cast<float*>(coupling_smem4);
  WideStream<S> ws{smem, smem + S::RESB, weights, n_layers, DENSITY, 0};
  const int lane = threadIdx.x & 31;
  float* pb = smem + S::RESB + 2 * S::CHUNK + (threadIdx.x >> 5) * S::STAGE;
  float* F = pb + 16 * S::ROW;
  // The warp's particles, read and written as one contiguous run.
  const size_t first = (size_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  const size_t end = (size_t)n * D;
  for (int k = lane; k < 32 * D; k += 32) {
    const size_t e = first * D + k;
    F[(k / D) * S::FROW + k % D] = e < end ? x[e] : 0.f;
  }
  if constexpr (D % 2 == 1) F[lane * S::FROW + D] = 0.f;
  float ld = 0.f;
  flow_pass_wide<S, DENSITY>(ws, tail_bound, F, pb, lane, ld);
  for (int k = lane; k < 32 * D; k += 32) {
    const size_t e = first * D + k;
    if (e < end) z[e] = F[(k / D) * S::FROW + k % D];
  }
  if (first + lane < (size_t)n) log_det[first + lane] = ld;
}

template <int D, class HID, int K, bool RQS, bool DENSITY>
int launch_coupling(const float* x, float* z, float* ld, const float* w,
                    int n, int n_layers, float tb, cudaStream_t stream) {
  using S = MmaShape<D, HID, K, RQS>;
  if (n <= 0 || n_layers <= 0) return 0;
  static_assert(S::WARPS >= 1, "no block of this shape fits an SM");
  const int sms = current_device_limits().sms;
  // Enough warps per block to give every SM a block, at most S::WARPS.
  int warps = ((n + 31) / 32 + sms - 1) / sms;
  warps = warps < 1 ? 1 : (warps > S::WARPS ? S::WARPS : warps);
  const int threads = 32 * warps;
  // Weight buffers: two whole layers, or (wide) two resident parts and two
  // chunks.
  const int smem = (int)sizeof(float) * (S::BUFS + warps * S::STAGE);
  const int max_smem = (int)sizeof(float) * (S::BUFS + S::WARPS * S::STAGE);
  void (*kernel)(const float*, float*, float*, const float*, int, int, float);
  if constexpr (S::WIDE) {
    kernel = coupling_kernel_wide<D, HID, K, RQS, DENSITY>;
  } else {
    kernel = coupling_kernel<D, HID, K, RQS, DENSITY>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(x, z, ld, w, n, n_layers, tb);
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

// The packed layout of coupling configuration `config`, as MmaShape
// computes it (mma_layout_table, with the most warps per block last), into
// out (up to capacity entries). Returns their number, or -1 for an unknown
// configuration.
int aspire_coupling_layout(int config, int* out, int capacity) {
#define ASPIRE_COUPLING_LAYOUT_CASE(ID, D, HID, K, RQS)                 \
  if (config == ID) {                                                  \
    return aspire::mma_layout_table<                                   \
        aspire::MmaShape<D, ASPIRE_HIDDEN HID, K, RQS>>(out, capacity, \
                                                        true);         \
  }
  ASPIRE_COUPLING_CONFIGS(ASPIRE_COUPLING_LAYOUT_CASE)
#undef ASPIRE_COUPLING_LAYOUT_CASE
  return -1;
}

// x, z: (n, D) row-major; log_det: (n,). density != 0 runs data -> latent.
// Returns the launch's cudaError_t, or -1 for an unknown configuration.
int aspire_coupling(const float* x, float* z, float* log_det,
                    const float* weights, int n, int n_layers,
                    float tail_bound, int config, int density,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_COUPLING_CASE(ID, D, HID, K, RQS)                          \
  if (config == ID) {                                                     \
    using H = ASPIRE_HIDDEN HID;                                          \
    return density ? aspire::launch_coupling<D, H, K, RQS, true>(         \
                         x, z, log_det, weights, n, n_layers, tail_bound, \
                         s)                                               \
                   : aspire::launch_coupling<D, H, K, RQS, false>(        \
                         x, z, log_det, weights, n, n_layers, tail_bound, \
                         s);                                              \
  }
  ASPIRE_COUPLING_CONFIGS(ASPIRE_COUPLING_CASE)
#undef ASPIRE_COUPLING_CASE
  return -1;
}

}  // extern "C"
