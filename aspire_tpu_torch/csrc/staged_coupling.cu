// The coupling-flow density pass (data -> latent) over tiles of particles,
// in the three schedules of the TPU prototypes in benchmarks/dev/.
//
// Replaces, by configuration (ASPIRE_STAGED_CONFIGS) of one entry point,
// aspire_staged:
//   Q = 2             benchmarks/dev/interleave_ab.py::_interleaved_kernel (D1)
//   Q = 2, 3, 4, 8    benchmarks/dev/quad_interleave_ab.py::_q_kernel (D2)
//   PAIRED            benchmarks/dev/packed_ab.py::_packed_kernel (D3);
//                     with MICRO, its rqs_micro spline (packed_ab.py:164)
//
// The function is the density mode of coupling.cu. The schedules are the
// prototypes':
// - D1/D2 (staged_mma_kernel): a block takes Q sub-tiles of S particles,
//   sub-tile q owned by its own group of 2S threads, which synchronises
//   only among itself (named barrier 1 + q). The groups run their layers
//   independently, so the warp schedulers interleave one group's
//   tensor-core products with another's spline (SFU and branch work): the
//   native form of the TPU's MXU/VPU overlap, with no lock-step stagger.
// - D3 (PAIRED, paired_kernel): two groups of particles one layer apart,
//   each dense level computing both groups' conditioners. The TPU kernel
//   fills its 128 x 128 matrix unit with block-diag(W_l, W_{l-1}); a warp's
//   mma.sync needs no fill, so here the pair lives in the warp: its 32
//   particles are two 16-row tiles, tile 0 (group A) at layer `stage` and
//   tile 1 (group B) at layer `stage - 1`, whose two chains of products
//   interleave in one k-loop (conditioner_mma's PAIRED form), with no zero
//   blocks.
//
// What bounds it on an H100: arithmetic. A 4-layer (64, 64) x 8-bin flow
// costs 57,344 FLOP per particle against 36 bytes of input and output, so
// device memory is idle. What the design does about it: every schedule
// runs the conditioner's two wide products, h1 . W2 and h2 . W3 (56,320 of
// those FLOP), on the tensor cores in the split-TF32 mma.sync m16n8k8 pass
// of coupling_mma.cuh (conditioner_mma: h1 on FP32 FMAs straight into the
// A fragments, h2 kept in the accumulators, each k-step's three products
// summed from zero then added in float32), from the coupling kernel B1's
// packed weights (prepare_mma_params), every layer's resident in shared
// memory for the block's whole life (a persistent grid of one block per SM
// walks over the tiles). Only the transformer parameters go through shared
// memory, to the spline threads. With no hidden layer in shared memory,
// registers bound a block at 512 threads, 128 registers each, 16 warps to
// hide the mma and spline latencies:
// - D1/D2: each warp of a group owns one 16-row tile of its sub-tile (S =
//   128, 80, 64, 32 at Q = 2, 3, 4, 8), and the group's splines run one
//   thread per (active dim, particle) pair;
// - D3: warps are independent (a __syncwarp between the phases, no block
//   barrier), each walks over tiles of 32 particles through the L + 1
//   stages of the pair, the one live tile alone at stage 0 and L, and each
//   lane runs its own particle's splines at its own layer (as B1 does).

#include "coupling_mma.cuh"

namespace aspire {

// D1/D2's per sub-tile shared buffers: the coordinates [D][S], the
// transformer parameters of each particle in a row of M::ROW floats (the
// coupling kernel's warp-buffer rows: the 4 extra floats put the 8 rows a
// quarter warp reads with float4 loads in distinct banks), and the
// per-thread log-det sums [2][S].
template <class M, int S>
struct MmaStagedBuffers {
  static constexpr int X = 0;
  static constexpr int OUT = X + M::D * S;
  static constexpr int LD = OUT + S * M::ROW;
  static constexpr int SIZE = LD + 2 * S;  // floats per sub-tile
};

// Barrier of one sub-tile's group: named barrier `id` over its `threads`.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// D1/D2's splines: thread t takes the (active dim a, particle p) pairs
// j = t, t + 2S, ... (a = j / S, p = j % S), so all of a thread's pairs
// belong to one particle; each pair's parameters are read from the
// particle's row of out as float4s. Returns their log-det sum.
template <class M, int S>
__device__ __forceinline__ float tile_splines(const float* __restrict__ out,
                                              float* __restrict__ xs, int t,
                                              int layer, float tb) {
  float sum = 0.f;
  for (int j = t; j < M::A * S; j += 2 * S) {
    const int a = j / S, p = j % S;
    const int i = 2 * a + (layer & 1);  // the a-th active dim
    const float4* src =
        reinterpret_cast<const float4*>(out + p * M::ROW + a * M::G);
    float raw[M::P];
#pragma unroll
    for (int c = 0; c < (M::P + 3) / 4; ++c) {
      const float4 v = src[c];
      if (4 * c + 0 < M::P) raw[4 * c + 0] = v.x;
      if (4 * c + 1 < M::P) raw[4 * c + 1] = v.y;
      if (4 * c + 2 < M::P) raw[4 * c + 2] = v.z;
      if (4 * c + 3 < M::P) raw[4 * c + 3] = v.w;
    }
    float y, e;
    rqs<M::K, true>(xs[i * S + p], raw, tb, y, e);
    xs[i * S + p] = y;
    sum += e;
  }
  return sum;
}

// D1 (Q = 2) and D2: Q sub-tiles of S particles per tile, each owned by a
// group of 2S threads = S/16 warps, warp k of a group the conditioner of
// rows 16k .. 16k + 15 of its sub-tile. Every layer's packed weights
// (prepare_mma_params) in shared memory, with per sub-tile buffers
// (MmaStagedBuffers).
template <int D, int H1, int H2, int K, int Q, int S>
__global__ void __launch_bounds__(2 * Q * S, 1)
    staged_mma_kernel(const float* __restrict__ x, float* __restrict__ z,
                      float* __restrict__ log_det,
                      const float* __restrict__ weights, int n, int n_layers,
                      float tb) {
  using M = MmaShape<D, H1, H2, K, true>;
  using Buf = MmaStagedBuffers<M, S>;
  constexpr int T = 2 * S;  // threads per sub-tile, a warp per 16 rows
  static_assert(S % 16 == 0, "sub-tiles are multiples of 16 particles");
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  load_shared(smem4, reinterpret_cast<const float4*>(weights),
              n_layers * M::SIZE / 4);
  __syncthreads();
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  const int lane = t & 31, r0 = 16 * (t >> 5);
  float* buf = w + n_layers * M::SIZE + g * Buf::SIZE;
  float* xs = buf + Buf::X;
  const int n_tiles = (n + Q * S - 1) / (Q * S);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * Q * S + g * S;
    // The sub-tile, zeros past n (the ragged last tile).
    for (int e = t; e < S * D; e += T) {
      const int p = e / D, i = e % D;
      xs[i * S + p] = base + p < n ? x[(size_t)(base + p) * D + i] : 0.f;
    }
    float part = 0.f;
    for (int layer = 0; layer < n_layers; ++layer) {
      named_barrier(g + 1, T);
      // The warp's rows r0 .. r0 + 15: conditioner_mma on one row tile,
      // its conditioning inputs (rows g and g + 8) from xs.
      const int odd = layer & 1;
      float u[2][M::C];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < M::C; ++c) {
          u[h][c] = xs[(2 * c + 1 - odd) * S + r0 + (lane >> 2) + 8 * h];
        }
      }
      conditioner_mma<M, 1>(w + layer * M::SIZE, u,
                            buf + Buf::OUT + r0 * M::ROW, lane);
      named_barrier(g + 1, T);
      part += tile_splines<M, S>(buf + Buf::OUT, xs, t, layer, tb);
    }
    buf[Buf::LD + t] = part;
    named_barrier(g + 1, T);
    if (t < S && base + t < n) {
      log_det[base + t] = buf[Buf::LD + t] + buf[Buf::LD + S + t];
    }
    for (int e = t; e < S * D; e += T) {
      const int p = e / D, i = e % D;
      if (base + p < n) z[(size_t)(base + p) * D + i] = xs[i * S + p];
    }
    named_barrier(g + 1, T);
  }
}

constexpr int kPairedWarps = 16;  // most warps per D3 block

// One stage of D3's schedule for the warp's 32 particles, lane l holding
// particle l in f: rows 0-15 (row tile 0, group A) run layer `stage`, rows
// 16-31 (row tile 1, group B) layer `stage - 1`, each from its layer's
// packed weights in w. Both tiles live: one paired conditioner_mma, the two
// tiles' chains of products interleaved in one k-loop; at stage 0 and
// n_layers the one live tile alone. Then each lane runs the transformers of
// its own particle at its own tile's layer. All 32 lanes call it together,
// after a __syncwarp since the buffer's last reads.
template <class M, bool MICRO>
__device__ __forceinline__ void paired_stage(const float* __restrict__ w,
                                             int stage, int n_layers,
                                             float tb, float* __restrict__ buf,
                                             int lane, float (&f)[M::D],
                                             float& log_det) {
  const int layer = stage - (lane >> 4);  // the lane's row tile's
  const bool odd = layer & 1;
  float v[M::C];  // the lane's conditioning inputs at that layer
#pragma unroll
  for (int c = 0; c < M::C; ++c) v[c] = odd ? f[2 * c] : f[2 * c + 1];
  const int g = lane >> 2;
  if (stage > 0 && stage < n_layers) {
    float u[4][M::C];
#pragma unroll
    for (int c = 0; c < M::C; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        u[r][c] = __shfl_sync(0xffffffffu, v[c], g + 8 * r);
      }
    }
    conditioner_mma<M, 2, true>(w + stage * M::SIZE, u, buf, lane,
                                w + (stage - 1) * M::SIZE);
  } else {
    const int m = stage == 0 ? 0 : 1;  // the live row tile
    float u[2][M::C];
#pragma unroll
    for (int c = 0; c < M::C; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        u[h][c] = __shfl_sync(0xffffffffu, v[c], 16 * m + g + 8 * h);
      }
    }
    conditioner_mma<M, 1>(w + (stage - m) * M::SIZE, u,
                          buf + 16 * m * M::ROW, lane);
  }
  __syncwarp();
  if (layer >= 0 && layer < n_layers) {
    log_det += transformers_mma<M, true, MICRO>(buf, lane, odd, tb, f);
  }
  __syncwarp();
}

// D3: a persistent block of up to kPairedWarps independent warps with
// every layer's packed weights (prepare_mma_params) in shared memory, and
// a buffer of 32 rows of transformer parameters per warp. A warp takes
// tiles of 32 particles (group A: the first 16, group B: the next 16)
// through the n_layers + 1 stages of the pair.
template <int D, int H1, int H2, int K, bool MICRO>
__global__ void __launch_bounds__(32 * kPairedWarps, 1)
    paired_kernel(const float* __restrict__ x, float* __restrict__ z,
                  float* __restrict__ log_det,
                  const float* __restrict__ weights, int n, int n_layers,
                  float tb) {
  using M = MmaShape<D, H1, H2, K, true>;
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  load_shared(smem4, reinterpret_cast<const float4*>(weights),
              n_layers * M::SIZE / 4);
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float* buf = w + n_layers * M::SIZE + (threadIdx.x >> 5) * 32 * M::ROW;
  const int stages = n_layers > 0 ? n_layers + 1 : 0;
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * warps) {
    const int p = 32 * tile + lane;
    const bool live = p < n;
    float f[D];
#pragma unroll
    for (int i = 0; i < D; ++i) f[i] = live ? x[(size_t)p * D + i] : 0.f;
    float ld = 0.f;
#pragma unroll 1
    for (int stage = 0; stage < stages; ++stage) {
      paired_stage<M, MICRO>(w, stage, n_layers, tb, buf, lane, f, ld);
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < D; ++i) z[(size_t)p * D + i] = f[i];
      log_det[p] = ld;
    }
  }
}

// Floats per packed layer (B1's packing, MmaShape, for every schedule) and
// per sub-tile buffer: D1/D2's MmaStagedBuffers, or D3's 16 rows of a
// warp's transformer parameters (its coordinates and log-dets stay in
// registers).
template <int D, int H1, int H2, int K, int S, bool PAIRED>
struct StagedLayout {
  using M = MmaShape<D, H1, H2, K, true>;
  static constexpr int LAYER = M::SIZE;
  static constexpr int BUFFER =
      PAIRED ? S * M::ROW : MmaStagedBuffers<M, S>::SIZE;
};

// A block takes the weights and Q sub-tile buffers: D1/D2 one tile of Q
// sub-tiles (2QS threads), D3 one of Q = 2 per warp, as many warps as fit
// (at most kPairedWarps). A persistent grid of as many blocks as fit on
// the SMs at once, or as the tiles need.
template <int D, int H1, int H2, int K, int Q, int S, bool PAIRED,
          bool MICRO>
int launch_staged(const float* x, float* z, float* ld, const float* w,
                  int n, int n_layers, float tb, cudaStream_t stream) {
  static_assert(!PAIRED || (Q == 2 && S == 16),
                "the paired schedule: two 16-row tiles per warp");
  static_assert(PAIRED || !MICRO, "rqs_micro is the paired schedule's");
  using L = StagedLayout<D, H1, H2, K, S, PAIRED>;
  const DeviceLimits limits = current_device_limits();
  const int sms = limits.sms, max_smem = limits.max_smem;
  int per_sm = 0;
  const long long weights = 4LL * n_layers * L::LAYER;
  const long long buffers = 4LL * Q * L::BUFFER;
  int warps = 2 * Q * S / 32, per_block = 1;  // tiles a block takes at once
  if constexpr (PAIRED) {
    const long long fit = (max_smem - weights) / buffers;
    warps = fit < kPairedWarps ? (int)fit : kPairedWarps;
    if (warps < 1) return (int)cudaErrorInvalidConfiguration;
    per_block = warps;
  }
  const size_t smem = weights + (size_t)per_block * buffers;
  const int threads = 32 * warps;
  void (*kernel)(const float*, float*, float*, const float*, int, int, float);
  if constexpr (PAIRED) {
    kernel = paired_kernel<D, H1, H2, K, MICRO>;
  } else {
    kernel = staged_mma_kernel<D, H1, H2, K, Q, S>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n + Q * S - 1) / (Q * S);
  const int want = (tiles + per_block - 1) / per_block;
  const int blocks = want < sms * per_sm ? want : sms * per_sm;
  if (blocks == 0) return 0;
  kernel<<<blocks, threads, smem, stream>>>(x, z, ld, w, n, n_layers, tb);
  return (int)cudaGetLastError();
}

}  // namespace aspire

extern "C" {

// The row (D, H1, H2, K, Q, S, PAIRED, MICRO) of a configuration id, then
// its packed floats per layer and its shared floats per sub-tile buffer;
// -1 for an unknown id.
int aspire_staged_config(int config, int* row) {
#define ASPIRE_STAGED_ROW(ID, D, H1, H2, K, Q, S, PAIRED, MICRO)       \
  if (config == ID) {                                                 \
    using L = aspire::StagedLayout<D, H1, H2, K, S, PAIRED>;          \
    const int v[10] = {D, H1, H2, K, Q, S, PAIRED, MICRO, L::LAYER,   \
                       L::BUFFER};                                    \
    for (int i = 0; i < 10; ++i) row[i] = v[i];                       \
    return 0;                                                         \
  }
  ASPIRE_STAGED_CONFIGS(ASPIRE_STAGED_ROW)
#undef ASPIRE_STAGED_ROW
  return -1;
}

// x, z: (n, D) row-major; log_det: (n,); the density pass in the schedule
// of configuration `config`. Returns the launch's cudaError_t, or -1 for an
// unknown id.
int aspire_staged(const float* x, float* z, float* log_det,
                  const float* weights, int n, int n_layers, float tail_bound,
                  int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_STAGED_CASE(ID, D, H1, H2, K, Q, S, PAIRED, MICRO)      \
  if (config == ID) {                                                 \
    return aspire::launch_staged<D, H1, H2, K, Q, S, PAIRED, MICRO>(  \
        x, z, log_det, weights, n, n_layers, tail_bound, s);          \
  }
  ASPIRE_STAGED_CONFIGS(ASPIRE_STAGED_CASE)
#undef ASPIRE_STAGED_CASE
  return -1;
}

}  // extern "C"
