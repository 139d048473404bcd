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
// - The flow density is the tensor-core coupling pass of coupling_mma.cuh,
//   shared with the coupling-flow kernel (coupling.cu): a warp's 32
//   particles are two 16-row tiles of mma.sync m16n8k8 TF32 for the
//   conditioner's two wide products in split form (float32 accuracy), W1
//   on FP32 FMAs, and every thread runs the inverse splines of its own
//   particle, so the coordinates, the log-det and the chain state never
//   leave its registers. All layers' weights stay in shared memory.
// - The block's 256 particles are both the adaptation tile (the step size
//   adapts on their mean acceptance probability) and the Philox tile (a
//   particle's counter holds threadIdx.x and blockIdx.x). The per-step tile
//   sum takes one barrier (two scratch rows, used in turn).
// - Shapes whose layers the whole-layer pass cannot hold (MmaShape::WIDE:
//   BASELINE config 5's d = 32, 6 x (128, 128) flow, 1.6 MB of weights)
//   take chain_kernel_wide: the same chain with its state in shared memory
//   and the flow's layers streamed through the block per pass (the wide
//   form of coupling_mma.cuh, rounded k-step sums).

#include "coupling_mma.cuh"

namespace aspire {

constexpr int kTile = 256;          // particles per block: one tile
constexpr int kWarps = kTile / 32;  // each warp: two 16-row mma tiles
enum ChainKernel { kTPCN = 0, kPCN = 1, kRWMH = 2 };
enum TargetId { kGaussianMixture = 1, kGaussian = 2, kHierarchical = 3 };

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
  float* scratch;  // wide form: per-particle statistics, (3, D, n)
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

// In-kernel targets (models/targets.py carries the ids and constants); x
// is anything x[i] reads coordinate i of (a register array, or a Strided
// view of shared memory).
template <int D, class X>
__device__ __forceinline__ void target_densities(int id, const float* c,
                                                 const X& x, float& lpi,
                                                 float& ll) {
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
  } else if (id == kHierarchical) {
    // c = [y (D - 2)]; x = [m, s, theta (D - 2)]: y_i ~ N(theta_i, 1),
    // theta_i ~ N(m, e^s), m ~ N(0, 25), s ~ N(0, 1).
    const float m = x[0], s = x[1];
    const float scale = expf(s);
    const float log_scale = logf(scale);
    float lik = 0.f, lth = 0.f;
#pragma unroll 8
    for (int i = 0; i + 2 < D; ++i) {
      const float r = c[i] - x[i + 2];
      lik += -0.5f * r * r - kHalfLog2Pi;
      const float v = (x[i + 2] - m) / scale;
      lth += -0.5f * v * v - log_scale - kHalfLog2Pi;
    }
    const float mm = m / 5.f;
    ll = lik;
    // 0.5 log(2 pi 25) = 2.5283764456...
    lpi = (-0.5f * mm * mm - 2.52837644563877295f) +
          (-0.5f * s * s - kHalfLog2Pi) + lth;
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
  flow_density<MmaShape<D, H1, H2, K, true>>(w, a.n_layers, a.tail_bound,
                                             buf, lane, f, ld);
  float zz = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) zz += f[i] * f[i];
  lq = -0.5f * zz - D * kHalfLog2Pi + ld + dt_lj;
  target_densities<D>(a.target_id, c + Consts<D>::TARGET, x, lpi, ll);
  lp = nan_to_neg_inf((1.f - a.beta) * lq + a.beta * (ll + lpi));
}

template <int D, class X>
__device__ __forceinline__ float mahal2(const float* __restrict__ c,
                                        const X& x) {
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
  using S = MmaShape<D, H1, H2, K, true>;
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

// Coordinate i of a particle whose coordinates lie kTile floats apart in
// shared memory (the wide form's [D][kTile] arrays).
struct Strided {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return p[i * kTile];
  }
};

// The wide form's tempered density of the particle at xs (a Strided view):
// the data transform into the lane's row of the warp's buffer F, the flow's
// density pass (flow_pass_wide, every thread of the block together), the
// target.
template <class S, int D>
__device__ __forceinline__ void tempered_wide(
    const ChainArgs& a, WideStream<S>& ws, const float* __restrict__ c,
    float* __restrict__ F, float* __restrict__ pb, int lane, float dt_lj,
    Strided xs, float& lp, float& lq, float& lpi, float& ll) {
  float* f = F + lane * S::FROW;
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    f[i] = a.dt_affine ? (xs[i] - c[Consts<D>::DT_MEAN + i]) /
                             c[Consts<D>::DT_STD + i]
                       : xs[i];
  }
  float ld = 0.f;
  flow_pass_wide<S, true>(ws, a.tail_bound, F, pb, lane, ld);
  float zz = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; ++i) zz += f[i] * f[i];
  lq = -0.5f * zz - D * kHalfLog2Pi + ld + dt_lj;
  target_densities<D>(a.target_id, c + Consts<D>::TARGET, xs, lpi, ll);
  lp = nan_to_neg_inf((1.f - a.beta) * lq + a.beta * (ll + lpi));
}

// The chain in the wide form (MmaShape::WIDE: BASELINE config 5's d = 32,
// (128, 128) flow), the same algorithm, tile, Philox stream and arithmetic
// of the chain as chain_kernel. A thread's state does not fit its
// registers at this d, so the block keeps its particles' current state and
// proposal as [D][kTile] arrays in shared memory (32 KB each at d = 32), a
// particle's normals in its row of its warp's flow buffer while the flow
// is idle, and the running sums of the mixing statistics in global memory
// (a.scratch, (3, D, n), each thread's own, read and written coalesced);
// the previous step's deviation is x - x0 before the step's update. The
// flow's weights stream through the block per pass (WideStream). Shared
// memory: constants, two [D][kTile] arrays, the stream's slots and the
// warps' buffers: 189,136 B at d = 32, one block per SM.
template <int D, int H1, int H2, int K, bool RQS>
__global__ void __launch_bounds__(kTile, 1) chain_kernel_wide(ChainArgs a) {
  using S = MmaShape<D, H1, H2, K, true>;
  using C = Consts<D>;
  extern __shared__ float4 smem4[];
  float* c = reinterpret_cast<float*>(smem4);
  float* scratch = c + C::SIZE;
  float* X = scratch + 2 * kWarps;
  float* XP = X + D * kTile;
  float* res = XP + D * kTile;
  float* ring = res + 2 * S::RES;
  const int tid = threadIdx.x, lane = tid & 31;
  float* pb = ring + 2 * S::CHUNK + (tid >> 5) * S::STAGE;
  float* F = pb + 16 * S::ROW;
  float* xi = F + lane * S::FROW;
  WideStream<S> ws{res, ring, a.weights, a.n_layers, true, 0};
  load_shared(smem4, reinterpret_cast<const float4*>(a.consts), C::SIZE / 4);
  __syncthreads();

  const int p = blockIdx.x * kTile + tid;
  const size_t n = (size_t)a.n;
  float dt_lj = 0.f;
  if (a.dt_affine) {
#pragma unroll 8
    for (int i = 0; i < D; ++i) dt_lj -= logf(fabsf(c[C::DT_STD + i]));
  }
  const float* x0 = a.z0 + (size_t)p * D;
  float* s1 = a.scratch + p;
  float* s2 = s1 + D * n;
  float* c1 = s2 + D * n;
  for (int i = 0; i < D; ++i) {
    X[i * kTile + tid] = x0[i];
    s1[i * n] = s2[i * n] = c1[i * n] = 0.f;
  }
  const Strided x{X + tid}, xp{XP + tid};
  float lp, lq, lpi, ll;
  tempered_wide<S, D>(a, ws, c, F, pb, lane, dt_lj, x, lp, lq, lpi, ll);
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
  ns.local = tid;
  ns.tile = blockIdx.x;
  ns.key = make_uint2(a.seed0, a.seed1);

#pragma unroll 1
  for (int t = 0; t < a.n_steps; ++t) {
    ns.step = t;
    ns.group = -1;
    for (int i = 0; i < D; ++i) xi[i] = normal_from_uniform(ns.get(i));
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

    float rot = 1.f, scale = s;
    if (a.kernel != kRWMH) {
      const float s_c = fminf(s, 1.f);
      rot = sqrtf(fmaxf(1.f - s_c * s_c, 0.f));
      scale = s_c;
      if (a.kernel == kTPCN) {
        const float wg = w_raw / (0.5f * (a.nu + r2));
        scale = s_c / sqrtf(wg);
      }
    }
    for (int i = 0; i < D; ++i) {
      float lxi = 0.f;
#pragma unroll 8
      for (int j = 0; j < D; ++j) lxi = fmaf(c[C::CHOL + i * D + j], xi[j], lxi);
      if (a.kernel == kRWMH) {
        XP[i * kTile + tid] = x[i] + s * lxi;
      } else {
        const float m = c[C::MEAN + i];
        XP[i * kTile + tid] = m + rot * (x[i] - m) + scale * lxi;
      }
    }
    float r2n = r2, corr = 0.f;
    if (a.kernel != kRWMH) {
      r2n = mahal2<D>(c, xp);
      corr = (a.kernel == kPCN) ? 0.5f * (r2n - r2)
                                : alpha_g * logf((a.nu + r2n) / (a.nu + r2));
    }
    float lp_p, lq_p, lpi_p, ll_p;
    tempered_wide<S, D>(a, ws, c, F, pb, lane, dt_lj, xp, lp_p, lq_p, lpi_p,
                        ll_p);
    const float log_alpha = nan_to_neg_inf(lp_p - lp + corr);
    const float acc_p = expf(fminf(log_alpha, 0.f));
    const bool accept = u_acc < acc_p;
    if (accept) {
      lp = lp_p;
      lq = lq_p;
      lpi = lpi_p;
      ll = ll_p;
      r2 = r2n;
      nacc += 1.f;
    }
    for (int i = 0; i < D; ++i) {
      const float old = X[i * kTile + tid];
      const float now = accept ? XP[i * kTile + tid] : old;
      X[i * kTile + tid] = now;
      const float delta = now - x0[i];
      const float prev = old - x0[i];
      s1[i * n] += delta;
      s2[i * n] += delta * delta;
      c1[i * n] += delta * prev;
    }
    const float acc_mean = tile_sum(acc_p, scratch, phase) / kTile;
    s = expf(fminf(fmaxf(logf(s) + a.adapt_rate * (acc_mean - a.target_acc),
                         -10.f),
                   a.max_log_step));
  }

  for (int i = 0; i < D; ++i) a.z[(size_t)p * D + i] = X[i * kTile + tid];
  a.lq[p] = lq;
  a.lpi[p] = lpi;
  a.ll[p] = ll;
  a.nacc[p] = nacc;

  const float m = (float)(a.n_steps + 1);
  float* row = a.stats + (size_t)blockIdx.x * (4 * D + 1);
  if (tid == 0) row[0] = s;
  for (int i = 0; i < D; ++i) {
    const float dev_mean = s1[i * n] / m;
    const float var = s2[i * n] / m - dev_mean * dev_mean;
    const float cov1 = c1[i * n] / (float)a.n_steps - dev_mean * dev_mean;
    const float rho = var > 1e-12f ? cov1 / fmaxf(var, 1e-12f) : 1.f;
    const float wm = x0[i] + dev_mean;
    const float rho_sum = tile_sum(rho, scratch, phase);
    const float within_sum = tile_sum(var, scratch, phase);
    const float wm_sum = tile_sum(wm, scratch, phase);
    const float dv = wm - wm_sum / kTile;
    const float wm_m2 = tile_sum(dv * dv, scratch, phase);
    if (tid == 0) {
      row[1 + i] = rho_sum;
      row[1 + D + i] = within_sum;
      row[1 + 2 * D + i] = wm_sum;
      row[1 + 3 * D + i] = wm_m2;
    }
  }
}

template <int D, int H1, int H2, int K, bool RQS>
int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  using S = MmaShape<D, H1, H2, K, true>;
  // Every layer's weights, or (wide) two [D][kTile] arrays and the
  // stream's slots.
  const size_t state = S::WIDE ? 2 * D * kTile + 2 * (S::RES + S::CHUNK)
                               : (size_t)a.n_layers * S::SIZE;
  const size_t smem = sizeof(float) * (state + Consts<D>::SIZE + 2 * kWarps +
                                       kWarps * S::STAGE);
  void (*kernel)(ChainArgs);
  if constexpr (S::WIDE) {
    kernel = chain_kernel_wide<D, H1, H2, K, RQS>;
  } else {
    kernel = chain_kernel<D, H1, H2, K, RQS>;
  }
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

// The packed layout of chain configuration `config`, as MmaShape
// computes it: floats per layer, the offsets of W1, b1, W2, b2, W3 and b3,
// the warp buffer's row stride and size, then the wide form's resident
// part and chunk (0 for the whole-layer form), into out (up to capacity
// entries). Returns their number, or -1 for an unknown configuration.
int aspire_chain_layout(int config, int* out, int capacity) {
#define ASPIRE_CHAIN_LAYOUT_CASE(ID, D, H1, H2, K, RQS)                  \
  if (config == ID) {                                                   \
    using S = aspire::MmaShape<D, H1, H2, K, true>;                     \
    const int v[] = {S::SIZE, S::W1,  S::B1,    S::W2,                  \
                     S::B2,   S::W3,  S::B3,    S::ROW,                 \
                     S::STAGE, S::RES, S::CHUNK};                       \
    const int count = (int)(sizeof(v) / sizeof(v[0]));                  \
    for (int e = 0; e < count && e < capacity; ++e) out[e] = v[e];      \
    return count;                                                       \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_LAYOUT_CASE)
#undef ASPIRE_CHAIN_LAYOUT_CASE
  return -1;
}

// Returns the launch's cudaError_t; -1 for an unknown configuration and
// -2 when n is not a multiple of the tile. scratch: 3 * D * n floats for a
// wide configuration (MmaShape::WIDE), else unused.
int aspire_chain(const float* z0, const float* weights, const float* consts,
                 const float* step0, const float* noise, float* z, float* lq,
                 float* lpi, float* ll, float* nacc, float* stats,
                 float* scratch, int n,
                 int n_layers, int n_steps, int kernel, int gamma_m,
                 int gamma_odd, int rows, int dt_affine, int target_id,
                 float beta, float nu, float target_acc, float adapt_rate,
                 float max_log_step, float tail_bound, unsigned seed0,
                 unsigned seed1, int config, void* stream) {
  if (n % aspire::kTile != 0) return -2;
  aspire::ChainArgs a{z0, weights, consts, step0, noise, z, lq, lpi, ll,
                      nacc, stats, scratch, n, n_layers, n_steps, kernel, gamma_m,
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
