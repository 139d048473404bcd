// A whole k-step tpCN / pCN / RWMH Metropolis chain in one launch, its flow
// density on the tensor cores.
//
// Replaces the TPU kernel aspire_tpu/ops/fused_mutation.py::_chain_kernel
// (called through fused_mh_chain). One block is one adaptation tile of
// kTile = 256 particles, one thread per particle; the block runs the whole
// n_steps loop with each particle's chain state in registers, so a step
// touches no device memory except the optional injected noise.
//
// Per step and particle: draw the step's uniforms (Philox4x32-10 of
// common.cuh, keyed by the mutation seed and counted by (particle in the
// tile, step, row group, tile); or read them from an injected (n_steps,
// rows, n) array), turn d of them into inverse-CDF normals, build the tpCN
// Gamma variate from pair-products of exponentials, propose around the
// Gaussian reference while carrying the reference Mahalanobis distance r^2,
// run the affine data transform and the flow density, evaluate the target
// by its id, guard NaN -> -inf, and do the Metropolis select. Once per step
// a tile sum of the acceptance probabilities drives the tile's
// Robbins-Monro step size; at the end tile sums write the tile's AR(1) and
// mixing sums in the 4d+1 layout of fused_mutation.py::_stats_rows.
//
// What bounds it on an H100: operations. The flow density (nsf-tpu at
// d = 4: 3 coupling layers, each a 2 -> 64 -> 64 -> 46 conditioner and two
// 8-bin inverse splines) is ~21k multiply-adds per particle, 21 of them
// per chain; device memory is touched only at the start and the end.
//
// Design:
// - Tensor cores for the conditioner. A warp's 32 particles are two 16-row
//   tiles of mma.sync m16n8k8 TF32. The two wide products, h1 . W2 and
//   h2 . W3, run in split form (3xTF32: every operand a = hi + lo in two
//   TF32 values, each product lo.hi + hi.lo + hi.hi), which keeps float32
//   accuracy; each weight fragment is read from shared memory once for both
//   row tiles. The packed W2 and W3 weights are sums of two TF32 values
//   (ops/fused_coupling.py::split_tf32_sum), so their split is exact, and
//   are stored in the mma B-fragment order with the k order that makes one
//   product's accumulator the next one's A fragment: h1 and h2 never leave
//   the warp's registers. W1 (the D/2 conditioning inputs) stays on FP32
//   FMAs; the inputs reach the fragment rows by warp shuffles.
// - One particle per thread everywhere else. The spline parameters go from
//   the accumulator fragments to their particle's thread through a per-warp
//   shared buffer, and each thread runs the D/2 inverse splines of its own
//   particle (rqs<K, true> of common.cuh), so the coordinates, the log-det
//   and the chain state never leave its registers.
// - The block's 256 particles are both the adaptation tile (the step size
//   adapts on their mean acceptance probability) and the Philox tile (a
//   particle's counter holds threadIdx.x and blockIdx.x). The per-step tile
//   sum takes one barrier (two scratch rows, used in turn).

#include "common.cuh"

namespace aspire {

constexpr int kTile = 256;          // particles per block: one tile
constexpr int kWarps = kTile / 32;  // each warp: two 16-row mma tiles
enum ChainKernel { kTPCN = 0, kPCN = 1, kRWMH = 2 };
enum TargetId { kGaussianMixture = 1, kGaussian = 2 };

// Packed chain weight layout (built by ops/fused_mutation.py::
// prepare_chain_params), per coupling layer, every section starting on a
// multiple of 4 floats. Layer l transforms the A = D/2 active dims
// 2a + (l & 1), conditioned on the C = D/2 dims 2c + 1 - (l & 1):
//   W1  (H1 x C)            W1[u*C + c] = w0[conditioning dim c][u]
//   b1  (H1)
//   W2  KS1 x KS2 fragments k-step s, n-tile j at index s * KS2 + j
//   b2  (H2)
//   W3  KS2 x NT fragments  k-step s, n-tile m at index s * NT + m
//   b3  (A x G)             b3[a*G + q] = b2[active dim a][q], q < P
// A fragment is 32 lanes x 2 floats: lane 4g + t holds W[8s + 2t][8j + g]
// and W[8s + 2t + 1][8j + g] (rows: input units; W3's columns: the active
// dims' P = 3K - 1 spline parameters, each dim's group zero-padded to G, a
// multiple of 8). Every W2 and W3 weight is the sum of two TF32 values.
template <int D, int H1, int H2, int K>
struct ChainShape {
  static_assert(D % 2 == 0, "the chain kernel takes an even dimension");
  static_assert(H1 % 8 == 0 && H2 % 8 == 0, "hidden widths must be /8");
  static constexpr int A = D / 2;
  static constexpr int C = D / 2;
  static constexpr int P = 3 * K - 1;
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
  // A warp's buffer of spline parameters: its 32 particles' OUT floats,
  // rows ROW floats apart (the 4 extra floats put the 8 rows a quarter
  // warp reads with float4 loads in distinct banks).
  static constexpr int ROW = OUT + 4;
  static constexpr int STAGE = 32 * ROW;
};

// Constant block layout (floats): reference mean (D), chol (D x D), ichol
// (D x D), data-transform mean (D) and std (D), target constants.
template <int D>
struct Consts {
  static constexpr int MEAN = 0;
  static constexpr int CHOL = MEAN + D;
  static constexpr int ICHOL = CHOL + D * D;
  static constexpr int DT_MEAN = ICHOL + D * D;
  static constexpr int DT_STD = DT_MEAN + D;
  static constexpr int TARGET = DT_STD + D;
  static constexpr int SIZE = round4(TARGET + 2 * D + 2);
};

struct ChainArgs {
  const float* z0;
  const float* weights;
  const float* consts;
  const float* step0;
  const float* noise;
  float* z;
  float* lq;
  float* lpi;
  float* ll;
  float* nacc;
  float* stats;
  int n, n_layers, n_steps, kernel, gamma_m, gamma_odd, rows, dt_affine,
      target_id;
  float beta, nu, target_acc, adapt_rate, max_log_step, tail_bound;
  uint32_t seed0, seed1;
};

// The uniforms of one particle's step, in increasing row order.
struct NoiseStream {
  const float* noise;  // injected (n_steps, rows, n), or nullptr
  int n, rows, p, step;
  uint32_t local, tile;
  uint2 key;
  uint4 block;
  int group;

  __device__ __forceinline__ float get(int row) {
    if (noise != nullptr) {
      return noise[((size_t)step * rows + row) * n + p];
    }
    const int g = row >> 2;
    if (g != group) {
      block = philox4x32_10(
          make_uint4(local, (uint32_t)step, (uint32_t)g, tile), key);
      group = g;
    }
    const int r = row & 3;
    const uint32_t bits =
        r == 0 ? block.x : (r == 1 ? block.y : (r == 2 ? block.z : block.w));
    // 23 random mantissa bits: a uniform on the grid k * 2^-23 in [0, 1).
    return (float)(bits >> 9) * 1.1920928955078125e-07f;
  }
};

// Inverse-CDF normal with the half-ulp shift (never erfinv(-1)).
__device__ __forceinline__ float normal_from_uniform(float u) {
  return 1.41421356237309515f * erfinvf(2.f * (u + 5.9604644775390625e-08f) -
                                        1.f);
}

__device__ __forceinline__ float nan_to_neg_inf(float v) {
  return isnan(v) ? -INFINITY : v;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(-fabsf(a - b)));
}

// In-kernel targets (models/targets.py carries the ids and constants).
template <int D>
__device__ __forceinline__ void target_densities(int id, const float* c,
                                                 const float (&x)[D],
                                                 float& lpi, float& ll) {
  const float log2pi = 2.f * kHalfLog2Pi;
  if (id == kGaussianMixture) {
    // c = [mu1 (D), mu2 (D), var1, var2]
    float q1 = 0.f, q2 = 0.f, q0 = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float a = x[i] - c[i];
      const float b = x[i] - c[D + i];
      q1 += a * a;
      q2 += b * b;
      q0 += x[i] * x[i];
    }
    const float v1 = c[2 * D], v2 = c[2 * D + 1];
    const float c1 = -0.5f * q1 / v1 - 0.5f * D * log2pi - 0.5f * D * logf(v1);
    const float c2 = -0.5f * q2 / v2 - 0.5f * D * log2pi - 0.5f * D * logf(v2);
    ll = logaddexp(c1, c2) - 0.69314718055994531f;
    lpi = -0.5f * q0 - 0.5f * D * log2pi;
  } else {
    // c = [mu, sigma, lower, upper]
    const float mu = c[0], sigma = c[1], lower = c[2], upper = c[3];
    float acc = 0.f;
    bool inside = true;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float r = (x[i] - mu) / sigma;
      acc += -0.5f * r * r - 0.5f * logf(6.28318530717958648f * sigma * sigma);
      inside = inside && (x[i] >= lower) && (x[i] <= upper);
    }
    ll = acc;
    lpi = inside ? -D * logf(upper - lower) : -INFINITY;
  }
  lpi = nan_to_neg_inf(lpi);
  ll = nan_to_neg_inf(ll);
}

// Sum over the block's tile; every thread gets the same total. Calls use
// two scratch rows of kWarps floats in turn (`phase` counts the calls), so
// one barrier per sum suffices: a warp writes a row again only after all
// warps passed the next call's barrier, so after all of them read it.
__device__ __forceinline__ float tile_sum(float v, float* scratch,
                                          int& phase) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  float* row = scratch + (phase & 1) * kWarps;
  ++phase;
  if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += row[w];
  return total;
}

// x = hi + lo: hi is x rounded to the nearest TF32 value (ties away from
// zero, cvt.rna.tf32.f32 done in integer ops), lo = x - hi exactly; the
// tensor core reads lo's top 11 significant bits, which leaves an error
// below 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
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

// d += A . B in split TF32, the small terms first.
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const WeightFragment& b) {
  mma_tf32(d, al, b.h0, b.h1);
  mma_tf32(d, ah, b.l0, b.l1);
  mma_tf32(d, ah, b.h0, b.h1);
}

// The conditioner of one coupling layer for the warp's 32 particles. Lane
// 4g + t brings u[r][c], conditioning input c of particle g + 8r (row tile
// r / 2), and gets, as does every lane, the rows g + 8r of the fragments;
// the spline parameters of particle p's active dim a go to
// buf[p * ROW + a * G + q].
template <int D, int H1, int H2, int K>
__device__ __forceinline__ void conditioner_mma(const float* __restrict__ w,
                                                const float (&u)[4][D / 2],
                                                float* __restrict__ buf,
                                                int lane) {
  using S = ChainShape<D, H1, H2, K>;
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
        split_tf32(fmaxf(a + bias, 0.f), hh[r >> 1][q], hl[r >> 1][q]);
      }
    }
#pragma unroll
    for (int j = 0; j < S::KS2; ++j) {
      const WeightFragment b(w + S::W2 + 64 * (s * S::KS2 + j) + 2 * lane);
      mma_split(acc[0][j], hh[0], hl[0], b);
      mma_split(acc[1][j], hh[1], hl[1], b);
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
      split_tf32(acc[m][s][0], ah[m][0], al[m][0]);
      split_tf32(acc[m][s][2], ah[m][1], al[m][1]);
      split_tf32(acc[m][s][1], ah[m][2], al[m][2]);
      split_tf32(acc[m][s][3], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int n = 0; n < S::NT; ++n) {
      const WeightFragment b(w + S::W3 + 64 * (s * S::NT + n) + 2 * lane);
      mma_split(out[0][n], ah[0], al[0], b);
      mma_split(out[1][n], ah[1], al[1], b);
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

// The flow density pass (data -> latent, layers in order) of the warp's
// 32 particles, lane l holding particle l: f is transformed in place and
// the log-det added to log_det. All 32 lanes call it together.
template <int D, int H1, int H2, int K>
__device__ __forceinline__ void flow_density(const float* __restrict__ w,
                                             int n_layers, float tb,
                                             float* __restrict__ buf,
                                             int lane, float (&f)[D],
                                             float& log_det) {
  using S = ChainShape<D, H1, H2, K>;
  __syncwarp();
#pragma unroll 1
  for (int layer = 0; layer < n_layers; ++layer) {
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
    conditioner_mma<D, H1, H2, K>(w + layer * S::SIZE, u, buf, lane);
    __syncwarp();
    float ld = 0.f;
#pragma unroll
    for (int a = 0; a < S::A; ++a) {
      const float4* src =
          reinterpret_cast<const float4*>(buf + lane * S::ROW + a * S::G);
      float par[S::P];
#pragma unroll
      for (int c = 0; c < S::G / 4; ++c) {
        const float4 v = src[c];
        if (4 * c + 0 < S::P) par[4 * c + 0] = v.x;
        if (4 * c + 1 < S::P) par[4 * c + 1] = v.y;
        if (4 * c + 2 < S::P) par[4 * c + 2] = v.z;
        if (4 * c + 3 < S::P) par[4 * c + 3] = v.w;
      }
      float y, e;
      rqs<K, true>(odd ? f[2 * a + 1] : f[2 * a], par, tb, y, e);
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
}

template <int D, int H1, int H2, int K>
__device__ __forceinline__ void tempered(const ChainArgs& a,
                                         const float* __restrict__ w,
                                         const float* __restrict__ c,
                                         float* __restrict__ buf, int lane,
                                         float dt_lj, const float (&x)[D],
                                         float& lp, float& lq, float& lpi,
                                         float& ll) {
  float f[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    f[i] = a.dt_affine ? (x[i] - c[Consts<D>::DT_MEAN + i]) /
                             c[Consts<D>::DT_STD + i]
                       : x[i];
  }
  float ld = 0.f;
  flow_density<D, H1, H2, K>(w, a.n_layers, a.tail_bound, buf, lane, f, ld);
  float zz = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) zz += f[i] * f[i];
  lq = -0.5f * zz - D * kHalfLog2Pi + ld + dt_lj;
  target_densities<D>(a.target_id, c + Consts<D>::TARGET, x, lpi, ll);
  lp = nan_to_neg_inf((1.f - a.beta) * lq + a.beta * (ll + lpi));
}

template <int D>
__device__ __forceinline__ float mahal2(const float* __restrict__ c,
                                        const float (&x)[D]) {
  float r2 = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float y = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      y = fmaf(c[Consts<D>::ICHOL + i * D + j], x[j] - c[Consts<D>::MEAN + j],
               y);
    }
    r2 += y * y;
  }
  return r2;
}

template <int D, int H1, int H2, int K, bool RQS>
__global__ void __launch_bounds__(kTile, 1) chain_kernel(ChainArgs a) {
  static_assert(RQS, "the chain kernel's flow is a neural spline flow");
  using S = ChainShape<D, H1, H2, K>;
  using C = Consts<D>;
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const int wfloats = a.n_layers * S::SIZE;
  float* c = w + wfloats;
  float* scratch = c + C::SIZE;
  const int lane = threadIdx.x & 31;
  float* buf = scratch + 2 * kWarps + (threadIdx.x >> 5) * S::STAGE;
  load_shared(smem4, reinterpret_cast<const float4*>(a.weights), wfloats / 4);
  load_shared(reinterpret_cast<float4*>(c),
              reinterpret_cast<const float4*>(a.consts), C::SIZE / 4);
  __syncthreads();

  const int p = blockIdx.x * kTile + threadIdx.x;
  float dt_lj = 0.f;
  if (a.dt_affine) {
#pragma unroll
    for (int i = 0; i < D; ++i) dt_lj -= logf(fabsf(c[C::DT_STD + i]));
  }

  float x[D], x0[D], prev[D], s1[D], s2[D], c1[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x0[i] = x[i] = a.z0[(size_t)p * D + i];
    prev[i] = s1[i] = s2[i] = c1[i] = 0.f;
  }
  float lp, lq, lpi, ll;
  tempered<D, H1, H2, K>(a, w, c, buf, lane, dt_lj, x, lp, lq, lpi, ll);
  float r2 = (a.kernel == kRWMH) ? 0.f : mahal2<D>(c, x);
  float s = a.step0[blockIdx.x];
  float nacc = 0.f;
  const float alpha_g = 0.5f * (a.nu + D);
  int phase = 0;

  NoiseStream ns;
  ns.noise = a.noise;
  ns.n = a.n;
  ns.rows = a.rows;
  ns.p = p;
  ns.local = threadIdx.x;
  ns.tile = blockIdx.x;
  ns.key = make_uint2(a.seed0, a.seed1);

#pragma unroll 1
  for (int t = 0; t < a.n_steps; ++t) {
    ns.step = t;
    ns.group = -1;
    float xi[D];
#pragma unroll
    for (int i = 0; i < D; ++i) xi[i] = normal_from_uniform(ns.get(i));
    float lxi[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc = fmaf(c[C::CHOL + i * D + j], xi[j], acc);
      lxi[i] = acc;
    }
    float w_raw = 0.f;
    if (a.kernel == kTPCN) {
      int row = D;
      for (int j = 0; j + 1 < a.gamma_m; j += 2) {
        const float u1 = ns.get(row + j), u2 = ns.get(row + j + 1);
        w_raw -= logf((1.f - u1) * (1.f - u2));
      }
      if (a.gamma_m & 1) w_raw -= logf(1.f - ns.get(row + a.gamma_m - 1));
      row += a.gamma_m;
      if (a.gamma_odd) {
        const float g = normal_from_uniform(ns.get(row));
        w_raw += 0.5f * g * g;
      }
    }
    const float u_acc = ns.get(a.rows - 1);

    float xp[D];
    if (a.kernel == kRWMH) {
#pragma unroll
      for (int i = 0; i < D; ++i) xp[i] = x[i] + s * lxi[i];
    } else {
      const float s_c = fminf(s, 1.f);
      const float rot = sqrtf(fmaxf(1.f - s_c * s_c, 0.f));
      float scale = s_c;
      if (a.kernel == kTPCN) {
        const float wg = w_raw / (0.5f * (a.nu + r2));
        scale = s_c / sqrtf(wg);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float m = c[C::MEAN + i];
        xp[i] = m + rot * (x[i] - m) + scale * lxi[i];
      }
    }
    float r2n = r2, corr = 0.f;
    if (a.kernel != kRWMH) {
      r2n = mahal2<D>(c, xp);
      corr = (a.kernel == kPCN) ? 0.5f * (r2n - r2)
                                : alpha_g * logf((a.nu + r2n) / (a.nu + r2));
    }
    float lp_p, lq_p, lpi_p, ll_p;
    tempered<D, H1, H2, K>(a, w, c, buf, lane, dt_lj, xp, lp_p, lq_p, lpi_p,
                           ll_p);
    const float log_alpha = nan_to_neg_inf(lp_p - lp + corr);
    const float acc_p = expf(fminf(log_alpha, 0.f));
    const bool accept = u_acc < acc_p;
    if (accept) {
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = xp[i];
      lp = lp_p;
      lq = lq_p;
      lpi = lpi_p;
      ll = ll_p;
      r2 = r2n;
      nacc += 1.f;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float delta = x[i] - x0[i];
      s1[i] += delta;
      s2[i] += delta * delta;
      c1[i] += delta * prev[i];
      prev[i] = delta;
    }
    const float acc_mean = tile_sum(acc_p, scratch, phase) / kTile;
    s = expf(fminf(fmaxf(logf(s) + a.adapt_rate * (acc_mean - a.target_acc),
                         -10.f),
                   a.max_log_step));
  }

#pragma unroll
  for (int i = 0; i < D; ++i) a.z[(size_t)p * D + i] = x[i];
  a.lq[p] = lq;
  a.lpi[p] = lpi;
  a.ll[p] = ll;
  a.nacc[p] = nacc;

  // Per-tile stats: [step, rho_sum (D), within_sum (D), wm_sum (D),
  // wm_m2 (D)].
  const float m = (float)(a.n_steps + 1);
  float* row = a.stats + (size_t)blockIdx.x * (4 * D + 1);
  if (threadIdx.x == 0) row[0] = s;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float dev_mean = s1[i] / m;
    const float var = s2[i] / m - dev_mean * dev_mean;
    const float cov1 = c1[i] / (float)a.n_steps - dev_mean * dev_mean;
    const float rho = var > 1e-12f ? cov1 / fmaxf(var, 1e-12f) : 1.f;
    const float wm = x0[i] + dev_mean;
    const float rho_sum = tile_sum(rho, scratch, phase);
    const float within_sum = tile_sum(var, scratch, phase);
    const float wm_sum = tile_sum(wm, scratch, phase);
    const float dv = wm - wm_sum / kTile;
    const float wm_m2 = tile_sum(dv * dv, scratch, phase);
    if (threadIdx.x == 0) {
      row[1 + i] = rho_sum;
      row[1 + D + i] = within_sum;
      row[1 + 2 * D + i] = wm_sum;
      row[1 + 3 * D + i] = wm_m2;
    }
  }
}

template <int D, int H1, int H2, int K, bool RQS>
int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  using S = ChainShape<D, H1, H2, K>;
  const size_t smem =
      sizeof(float) * ((size_t)a.n_layers * S::SIZE + Consts<D>::SIZE +
                       2 * kWarps + kWarps * S::STAGE);
  auto kernel = chain_kernel<D, H1, H2, K, RQS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n / kTile, kTile, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace aspire

extern "C" {

int aspire_chain_tile() { return aspire::kTile; }

int aspire_consts_floats(int dims) {
  switch (dims) {
#define ASPIRE_CONSTS_CASE(ID, D, H1, H2, K, RQS) \
  case D:                                        \
    return aspire::Consts<D>::SIZE;
    ASPIRE_CHAIN_CONFIGS(ASPIRE_CONSTS_CASE)
#undef ASPIRE_CONSTS_CASE
  }
  return -1;
}

// The packed layout of chain configuration `config`, as ChainShape
// computes it: floats per layer, the offsets of W1, b1, W2, b2, W3 and b3,
// then the warp buffer's row stride and size, into out (up to capacity
// entries). Returns their number, or -1 for an unknown configuration.
int aspire_chain_layout(int config, int* out, int capacity) {
#define ASPIRE_CHAIN_LAYOUT_CASE(ID, D, H1, H2, K, RQS)                  \
  if (config == ID) {                                                   \
    using S = aspire::ChainShape<D, H1, H2, K>;                         \
    const int v[] = {S::SIZE, S::W1, S::B1, S::W2, S::B2,               \
                     S::W3,   S::B3, S::ROW, S::STAGE};                 \
    const int count = (int)(sizeof(v) / sizeof(v[0]));                  \
    for (int e = 0; e < count && e < capacity; ++e) out[e] = v[e];      \
    return count;                                                       \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_LAYOUT_CASE)
#undef ASPIRE_CHAIN_LAYOUT_CASE
  return -1;
}

// Returns the launch's cudaError_t; -1 for an unknown configuration and
// -2 when n is not a multiple of the tile.
int aspire_chain(const float* z0, const float* weights, const float* consts,
                 const float* step0, const float* noise, float* z, float* lq,
                 float* lpi, float* ll, float* nacc, float* stats, int n,
                 int n_layers, int n_steps, int kernel, int gamma_m,
                 int gamma_odd, int rows, int dt_affine, int target_id,
                 float beta, float nu, float target_acc, float adapt_rate,
                 float max_log_step, float tail_bound, unsigned seed0,
                 unsigned seed1, int config, void* stream) {
  if (n % aspire::kTile != 0) return -2;
  aspire::ChainArgs a{z0, weights, consts, step0, noise, z, lq, lpi, ll,
                      nacc, stats, n, n_layers, n_steps, kernel, gamma_m,
                      gamma_odd, rows, dt_affine, target_id, beta, nu,
                      target_acc, adapt_rate, max_log_step, tail_bound,
                      seed0, seed1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_CHAIN_CASE(ID, D, H1, H2, K, RQS) \
  if (config == ID) return aspire::launch_chain<D, H1, H2, K, RQS>(a, s);
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_CASE)
#undef ASPIRE_CHAIN_CASE
  return -1;
}

}  // extern "C"
