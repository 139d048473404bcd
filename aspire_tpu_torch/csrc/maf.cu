// MAF-RQS density pass (data -> latent) of the whole multi-layer flow in
// one launch.
//
// Replaces the TPU kernel aspire_tpu/ops/fused_coupling.py::_maf_kernel
// (called through _pallas_maf_forward). Computes MAF._forward_xla: per
// layer one MADE of the layer's input gives the spline parameters of ALL
// D dims, each dim takes the inverse rational-quadratic spline, and the
// dims are reversed after every layer (including the last).
//
// What bounds it on an H100: instruction issue. Per particle and layer the
// MADE needs the products by the weights its masks keep (5,825 of 10,240
// for maf_rqs(4): 4 layers, (64, 64) hidden, 8 bins), against 20 bytes of
// input and output, so device memory is idle; the tensor cores take the
// products, and what is left to issue is the operand splits and the four
// splines per particle and layer (their IEEE divisions, exponentials and
// logarithms), about half of the time each (PERF.md).
//
// Design:
// - Tensor cores. The two wide products, h1 (16 x H1) . W2 and h2 (16 x
//   H2) . W3, run as mma.sync m16n8k8 TF32 over a tile of 16 particles per
//   warp, in split form (3xTF32): every operand is a = hi + lo in two TF32
//   values and each product takes lo.hi + hi.lo + hi.hi, which keeps
//   float32 accuracy (single-pass TF32 keeps about three decimal digits,
//   and the spline parameters pass through four splines). The packed
//   weights are stored as such sums already, so their split is exact and
//   takes two instructions; the activations are split as they are made.
//   W1 (K = D) stays FP32 FMAs.
// - Only what the masks keep. Hidden units are sorted by MADE degree when
//   the weights are packed (ops/fused_coupling.py::prepare_maf_params): a
//   permutation of hidden units does not change the function. Sorted, W2
//   is block triangular and dim i's W3 columns read only the hidden units
//   of degree <= i (the first 0, 22, 43, 64 of them for maf_rqs(4)), so an
//   8-wide n-tile multiplies only the k-steps below its highest degree,
//   and dim 0 takes no product at all: its parameters are its bias. A
//   first-layer unit multiplies only the inputs below its degree.
// - Registers carry the MADE. The packing stores each weight block in the
//   order of the mma's B fragment, with the k index of the fragment's
//   column c standing for hidden unit 2c (c < 4) or 2(c - 4) + 1 of the
//   8-unit k-step; with that order the accumulator fragment of one
//   product is the A fragment of the next, so h1 and h2 never leave the
//   warp's registers. The spline parameters go through a per-warp shared
//   buffer, where one lane takes one (particle, dim) pair at a time
//   (rqs<K, true> of common.cuh, the float32 arithmetic of the other
//   kernels).
// - A persistent grid. One block per SM holds every layer's packed weights
//   in shared memory, loaded once; its warps walk over the 16-particle
//   tiles independently (no block barrier after the load), with tiles
//   dealt warp-major over the blocks so a small batch (n = 8192: 512
//   tiles) still spreads over every SM.

#include <utility>

#include "common.cuh"

namespace aspire {

constexpr int kMafTile = 16;      // particles per warp tile: the mma's M
constexpr int kMafMaxWarps = 16;  // warps per block, as shared memory allows

// Packed MAF weight layout (built by ops/fused_coupling.py::
// prepare_maf_params), per flow layer, hidden units sorted by MADE degree
// (degree j % (D - 1) + 1 of unit j, stably sorted), every weight
// premultiplied by its mask, every W2 and W3 weight rounded to the sum of
// two TF32 values (split_tf32_sum):
//   W1  (H1 x D)        W1[u*D + i] = w0[i][unit u] * m0
//   b1  (H1)
//   W2  F2 fragments    n-tile j (units 8j..8j+7) for k-steps s < ks2(j)
//   b2  (H2)
//   W3  F3 fragments    dim i, k-step s < ks3(i), n-tile m < NT
//   b3  (D x G)         b3[i*G + q] = b2[i*P + q], q < P
// A fragment is 32 lanes x 2 floats: lane 4g + t holds W[8s + 2t][8j + g]
// and W[8s + 2t + 1][8j + g] (rows: sorted input units, columns: sorted
// output units or the D x G parameter columns). P = 3K - 1 spline
// parameters of a dim are padded to G = a multiple of 8. MafBlocks counts
// the kept blocks; MafShape, complete only once MafBlocks is, places the
// sections.
template <int D, int H1, int H2, int K>
struct MafBlocks {
  static_assert(H1 % 8 == 0 && H2 % 8 == 0, "hidden widths must be /8");
  static constexpr int P = 3 * K - 1;
  static constexpr int G = (P + 7) / 8 * 8;
  static constexpr int NT = G / 8;  // n-tiles per dim
  static constexpr int MD = D > 1 ? D - 1 : 1;  // highest hidden degree
  // Hidden units of degree <= d among h units (the sorted segment ends).
  __host__ __device__ static constexpr int ends(int h, int d) {
    int c = 0;
    for (int j = 0; j < h; ++j) c += (j % MD + 1 <= d) ? 1 : 0;
    return c;
  }
  // Degree of sorted hidden unit u among h units.
  __host__ __device__ static constexpr int degree(int h, int u) {
    int d = 1;
    while (d < MD && u >= ends(h, d)) ++d;
    return d;
  }
  // k-steps of W2 for n-tile j, of W3 for dim i.
  __host__ __device__ static constexpr int ks2(int j) {
    return (ends(H1, degree(H2, 8 * j + 7)) + 7) / 8;
  }
  __host__ __device__ static constexpr int ks3(int i) {
    return (ends(H2, i) + 7) / 8;
  }
  __host__ __device__ static constexpr int f2_before(int j) {
    int f = 0;
    for (int q = 0; q < j; ++q) f += ks2(q);
    return f;
  }
  __host__ __device__ static constexpr int f3_before(int i) {
    int f = 0;
    for (int q = 0; q < i; ++q) f += NT * ks3(q);
    return f;
  }
};

template <int D, int H1, int H2, int K>
struct MafShape : MafBlocks<D, H1, H2, K> {
  using B = MafBlocks<D, H1, H2, K>;
  static constexpr int F2 = B::f2_before(H2 / 8);
  static constexpr int F3 = B::f3_before(D);
  static constexpr int W1 = 0;
  static constexpr int B1 = round4(W1 + H1 * D);
  static constexpr int W2 = round4(B1 + H1);
  static constexpr int B2 = W2 + 64 * F2;
  static constexpr int W3 = round4(B2 + H2);
  static constexpr int B3 = W3 + 64 * F3;
  static constexpr int SIZE = round4(B3 + D * B::G);  // floats per layer
  // Per-warp shared buffer: the tile's coordinates (16 x D) and the
  // spline parameters of dims 1..D-1 ((D - 1) x 16 x G).
  static constexpr int STAGE = kMafTile * D + (D - 1) * kMafTile * B::G;
};

template <int... Is, class F>
__device__ __forceinline__ void static_for_impl(
    std::integer_sequence<int, Is...>, F&& f) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// f(std::integral_constant<int, 0>), ..., f(<N - 1>): compile-time indices
// for the per-block trip counts of the masked products.
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(std::make_integer_sequence<int, N>{}, f);
}

// x = hi + lo: hi is x rounded to the nearest TF32 value (ties away from
// zero, cvt.rna.tf32.f32 done in integer ops that issue at the full rate),
// lo = x - hi rounded the same way, which leaves an error below
// 2^-23 |x| (left to the tensor core, which reads lo's top 11 significant
// bits, a one-sided error below 2^-21 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
  lo = (lo + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A packed weight w is the sum of two TF32 values, its top 11 significant
// bits and a rest of at most 11 more (prepare_maf_params rounds it so), so
// cutting w to TF32 gives hi and w - hi = lo exactly: the split is free of
// rounding.
__device__ __forceinline__ void split_weight(float w, uint32_t& hi,
                                             uint32_t& lo) {
  hi = __float_as_uint(w) & 0xFFFFE000u;
  lo = __float_as_uint(w - __uint_as_float(hi));
}

// acc += A . B in split TF32 for one block (k-step), the small terms
// first; b is the lane's B fragment of packed weights. The block's three
// products are summed from zero (d) and added to acc in float32: the
// tensor core cuts (does not round) its sums, and summed into acc in place
// those cuts gave the pass a one-sided error (as coupling_mma.cuh's
// mma_split_step says).
__device__ __forceinline__ void mma_split(float (&acc)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float2 b) {
  uint32_t bh0, bl0, bh1, bl1;
  split_weight(b.x, bh0, bl0);
  split_weight(b.y, bh1, bl1);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// One MADE over the warp's tile (coordinates xs, [16][D]): the spline
// parameters of dims 1..D-1 into raw ([D - 1][16][G]). Lane 4g + t owns
// particles g and g + 8 of every fragment.
template <int D, int H1, int H2, int K>
__device__ __forceinline__ void maf_made(const float* __restrict__ w,
                                         const float* __restrict__ xs,
                                         float* __restrict__ raw, int lane) {
  using S = MafShape<D, H1, H2, K>;
  constexpr int MD = S::MD;
  const int g = lane >> 2, t = lane & 3;
  float xa[MD], xb[MD];
#pragma unroll
  for (int i = 0; i < MD; ++i) {
    xa[i] = xs[g * D + i];
    xb[i] = xs[(g + 8) * D + i];
  }
  // Second hidden layer's accumulators, one fragment per n-tile.
  float acc[H2 / 8][4];
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  static_for<H1 / 8>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    // First hidden layer, units 8s + 2t and 8s + 2t + 1, in A-fragment
    // order: (g, u0), (g + 8, u0), (g, u1), (g + 8, u1).
    float h[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int u = 8 * s + 2 * t + c;
      int deg = 1;
      static_for<MD - 1>([&](auto d_) {
        constexpr int e = S::ends(H1, decltype(d_)::value + 1);
        deg += u >= e ? 1 : 0;
      });
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int i = 0; i < MD; ++i) {
        if (i < deg) {
          const float wi = w[S::W1 + u * D + i];
          a = fmaf(wi, xa[i], a);
          b = fmaf(wi, xb[i], b);
        }
      }
      const float bias = w[S::B1 + u];
      h[2 * c] = fmaxf(a + bias, 0.f);
      h[2 * c + 1] = fmaxf(b + bias, 0.f);
    }
    uint32_t hh[4], hl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(h[r], hh[r], hl[r]);
    static_for<H2 / 8>([&](auto j_) {
      constexpr int j = decltype(j_)::value;
      if constexpr (s < S::ks2(j)) {
        constexpr int off = S::W2 + 64 * (S::f2_before(j) + s);
        mma_split(acc[j], hh, hl,
                  *reinterpret_cast<const float2*>(w + off + 2 * lane));
      }
    });
  });
  // h2 = relu(acc + b2), kept as the accumulator fragments.
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
    const float2 bias =
        *reinterpret_cast<const float2*>(w + S::B2 + 8 * j + 2 * t);
    acc[j][0] = fmaxf(acc[j][0] + bias.x, 0.f);
    acc[j][1] = fmaxf(acc[j][1] + bias.y, 0.f);
    acc[j][2] = fmaxf(acc[j][2] + bias.x, 0.f);
    acc[j][3] = fmaxf(acc[j][3] + bias.y, 0.f);
  }
  // Output layer, dims 1..D-1 (dim 0's parameters are its bias), k-step
  // outer so every dim's n-tiles are independent products in flight.
  constexpr int DO = D > 1 ? D - 1 : 1;
  float out[DO][S::NT][4];
#pragma unroll
  for (int i = 0; i < DO; ++i) {
#pragma unroll
    for (int m = 0; m < S::NT; ++m) {
      out[i][m][0] = out[i][m][1] = out[i][m][2] = out[i][m][3] = 0.f;
    }
  }
  static_for<S::ks3(D - 1)>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    // The accumulator of n-tile s, (g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1), is the A fragment of k-step s in the order (g, 2t),
    // (g+8, 2t), (g, 2t+1), (g+8, 2t+1).
    uint32_t ah[4], al[4];
    split_tf32(acc[s][0], ah[0], al[0]);
    split_tf32(acc[s][2], ah[1], al[1]);
    split_tf32(acc[s][1], ah[2], al[2]);
    split_tf32(acc[s][3], ah[3], al[3]);
    static_for<D - 1>([&](auto i_) {
      constexpr int i = decltype(i_)::value + 1;
      if constexpr (s < S::ks3(i)) {
        static_for<S::NT>([&](auto m_) {
          constexpr int m = decltype(m_)::value;
          constexpr int off =
              S::W3 + 64 * (S::f3_before(i) + s * S::NT + m);
          mma_split(out[i - 1][m], ah, al,
                    *reinterpret_cast<const float2*>(w + off + 2 * lane));
        });
      }
    });
  });
  static_for<D - 1>([&](auto i_) {
    constexpr int i = decltype(i_)::value + 1;
    float* r = raw + (i - 1) * kMafTile * S::G;
#pragma unroll
    for (int m = 0; m < S::NT; ++m) {
      const int q = 8 * m + 2 * t;
      const float2 bias =
          *reinterpret_cast<const float2*>(w + S::B3 + i * S::G + q);
      *reinterpret_cast<float2*>(r + g * S::G + q) =
          make_float2(out[i - 1][m][0] + bias.x, out[i - 1][m][1] + bias.y);
      *reinterpret_cast<float2*>(r + (g + 8) * S::G + q) =
          make_float2(out[i - 1][m][2] + bias.x, out[i - 1][m][3] + bias.y);
    }
  });
}

// The inverse spline of every (particle, dim) of the tile, then the
// reversal of dims, in place in xs. Lane l takes the pairs e = l, l + 32,
// ... (particle e % 16, dim e / 16), all of one particle. Returns the
// lane's log-det sum.
template <int D, int H1, int H2, int K>
__device__ __forceinline__ float maf_splines(const float* __restrict__ w,
                                             float* __restrict__ xs,
                                             const float* __restrict__ raw,
                                             int lane, float tb) {
  using S = MafShape<D, H1, H2, K>;
  constexpr int R = (kMafTile * D + 31) / 32;
  const int p = lane & (kMafTile - 1);
  float y[R];
  float ld = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = (lane >> 4) + 2 * r;
    if (i < D) {
      const float4* src = reinterpret_cast<const float4*>(
          i == 0 ? w + S::B3 : raw + ((i - 1) * kMafTile + p) * S::G);
      float par[S::P];
#pragma unroll
      for (int c = 0; c < S::G / 4; ++c) {
        const float4 v = src[c];
        if (4 * c + 0 < S::P) par[4 * c + 0] = v.x;
        if (4 * c + 1 < S::P) par[4 * c + 1] = v.y;
        if (4 * c + 2 < S::P) par[4 * c + 2] = v.z;
        if (4 * c + 3 < S::P) par[4 * c + 3] = v.w;
      }
      float e;
      rqs<K, true>(xs[p * D + i], par, tb, y[r], e);
      ld += e;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = (lane >> 4) + 2 * r;
    if (i < D) xs[p * D + (D - 1 - i)] = y[r];
  }
  __syncwarp();
  return ld;
}

template <int D, int H1, int H2, int K>
__global__ void __launch_bounds__(32 * kMafMaxWarps, 1)
    maf_kernel(const float* __restrict__ x, float* __restrict__ z,
               float* __restrict__ log_det, const float* __restrict__ weights,
               int n, int n_layers, float tail_bound) {
  using S = MafShape<D, H1, H2, K>;
  extern __shared__ float4 maf_smem4[];
  float* smem = reinterpret_cast<float*>(maf_smem4);
  load_shared(maf_smem4, reinterpret_cast<const float4*>(weights),
              n_layers * S::SIZE / 4);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* xs = smem + n_layers * S::SIZE + warp * S::STAGE;
  float* raw = xs + kMafTile * D;
  const int tiles = (n + kMafTile - 1) / kMafTile;
  for (int tile = warp * gridDim.x + blockIdx.x; tile < tiles;
       tile += warps * gridDim.x) {
    const int base = tile * kMafTile;
    // The tile's rows, zeros past n (the ragged last tile).
    for (int e = lane; e < kMafTile * D; e += 32) {
      xs[e] = base + e / D < n ? x[(size_t)base * D + e] : 0.f;
    }
    __syncwarp();
    float ld = 0.f;
#pragma unroll 1
    for (int layer = 0; layer < n_layers; ++layer) {
      const float* w = smem + layer * S::SIZE;
      maf_made<D, H1, H2, K>(w, xs, raw, lane);
      __syncwarp();
      ld += maf_splines<D, H1, H2, K>(w, xs, raw, lane, tail_bound);
    }
    // A particle's pairs are split over lanes p and p + 16.
    ld += __shfl_xor_sync(0xffffffffu, ld, 16);
    if (lane < kMafTile && base + lane < n) log_det[base + lane] = ld;
    for (int e = lane; e < kMafTile * D; e += 32) {
      if (base + e / D < n) z[(size_t)base * D + e] = xs[e];
    }
    __syncwarp();
  }
}

template <int D, int H1, int H2, int K>
int launch_maf(const float* x, float* z, float* ld, const float* w, int n,
               int n_layers, float tb, cudaStream_t stream) {
  using S = MafShape<D, H1, H2, K>;
  if (n <= 0) return 0;
  const DeviceLimits limits = current_device_limits();
  const int sms = limits.sms, max_smem = limits.max_smem;
  const long long weight_bytes = 4LL * n_layers * S::SIZE;
  const long long stage_bytes = 4LL * S::STAGE;
  long long warps = (max_smem - weight_bytes) / stage_bytes;
  if (warps > kMafMaxWarps) warps = kMafMaxWarps;
  if (warps < 1) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)(weight_bytes + warps * stage_bytes);
  auto kernel = maf_kernel<D, H1, H2, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kMafTile - 1) / kMafTile;
  const int blocks = tiles < sms ? tiles : sms;
  kernel<<<blocks, (int)(32 * warps), smem, stream>>>(x, z, ld, w, n,
                                                     n_layers, tb);
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

// Floats of one warp's shared buffer for a configuration id.
int aspire_maf_stage_floats(int config) {
#define ASPIRE_MAF_STAGE_CASE(ID, D, H1, H2, K) \
  if (config == ID) return aspire::MafShape<D, H1, H2, K>::STAGE;
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_STAGE_CASE)
#undef ASPIRE_MAF_STAGE_CASE
  return -1;
}

// The k-steps the kernel multiplies, as MafBlocks computes them: ks2(j) of
// W2's n-tiles j < H2 / 8, then ks3(i) of the dims i < D, into out (up to
// capacity entries). Returns their number, or -1 for an unknown
// configuration.
int aspire_maf_ksteps(int config, int* out, int capacity) {
#define ASPIRE_MAF_KSTEPS_CASE(ID, D, H1, H2, K)                      \
  if (config == ID) {                                                \
    using B = aspire::MafBlocks<D, H1, H2, K>;                       \
    const int count = H2 / 8 + D;                                    \
    for (int e = 0; e < count && e < capacity; ++e) {                \
      out[e] = e < H2 / 8 ? B::ks2(e) : B::ks3(e - H2 / 8);          \
    }                                                                \
    return count;                                                    \
  }
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_KSTEPS_CASE)
#undef ASPIRE_MAF_KSTEPS_CASE
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
