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
// map the proposal from the preconditioned space to data space (the
// preconditioning's inverse) and on to the flow's space (the flow's data
// transform), run the flow density, evaluate the target by its id, guard
// NaN -> -inf, and do the Metropolis select. Once per step
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
//   conditioner's products past W1 (any hidden depth) in split form
//   (float32 accuracy), W1 on FP32 FMAs, and every thread runs the inverse
//   splines of its own
//   particle, so the coordinates, the log-det and the chain state never
//   leave its registers. All layers' weights stay in shared memory.
// - The block's 256 particles are both the adaptation tile (the step size
//   adapts on their mean acceptance probability) and the Philox tile (a
//   particle's counter holds threadIdx.x and blockIdx.x). The per-step tile
//   sum takes one barrier (two scratch rows, used in turn).
// - The chain state is d floats a particle at any d; at an odd d (the
//   funnel's validation row, d = 5) only the flow pads a layer's halves
//   to (d + 1) / 2 dims (coupling_mma.cuh), the Philox rows, the programs
//   and the target run at the true d.
// - Shapes whose layers the whole-layer pass cannot hold (MmaShape::WIDE:
//   BASELINE config 5's d = 32, 6 x (128, 128) flow, 1.6 MB of weights)
//   take chain_kernel_wide: the same chain with its state in shared memory
//   and the flow's layers streamed through the block per pass (the wide
//   form of coupling_mma.cuh, rounded k-step sums). Where that block
//   passes 227 KB (config 5's flow at 20 bins: 237,056 B), ChainWidePlan
//   moves the chain state to global memory, then holds one resident part
//   of a layer, then moves the warps' particle rows to global memory too,
//   as far as the block needs; the tile, the Philox counters, the noise
//   rows and the arithmetic stay the same.
// - A user's own target (models/targets.py KernelSource) is built into an
//   instance of its own (ops/_build.py::build_user): the build defines
//   ASPIRE_USER_TARGET as the path of the source, which defines
//   user_target<D>(c, x, lpi, ll), and ASPIRE_INSTANCE_CONFIG(X) as the
//   flow's configuration row, the one it compiles.
//   That instance evaluates the user's target alone (id kUser), its
//   constants read from global memory through ChainArgs::user_consts
//   (any length: the constant block's target region holds 2D + 2
//   floats), and adds an entry that evaluates user_target alone over n
//   points (aspire_user_target). Without the define nothing of it is
//   compiled.

#include <type_traits>

#include "coupling_mma.cuh"

#ifdef ASPIRE_USER_TARGET
#include ASPIRE_USER_TARGET
#endif
// An instance built for one shape at first use (ops/_build.py::
// build_instance, a user's target's too) defines ASPIRE_INSTANCE_CONFIG(X)
// as its configuration row, the one it compiles; one built for a flow
// whose layers do not fit resident also defines ASPIRE_STREAMED and
// compiles the whole-layer chain that streams them
// (chain_kernel_streamed) in place of chain_kernel.
#ifdef ASPIRE_INSTANCE_CONFIG
#undef ASPIRE_CHAIN_CONFIGS
#define ASPIRE_CHAIN_CONFIGS(X) ASPIRE_INSTANCE_CONFIG(X)
#endif

namespace aspire {

constexpr int kTile = 256;          // particles per block: one tile
constexpr int kWarps = kTile / 32;  // each warp: two 16-row mma tiles
enum ChainKernel { kTPCN = 0, kPCN = 1, kRWMH = 2 };
enum TargetId {
  kGaussianMixture = 1,
  kGaussian = 2,
  kHierarchical = 3,
  kRosenbrock = 4,
  kFunnel = 5,
  kUser = 6  // a user's source: only in an instance built with it
};
// The last target id a configuration compiles (ASPIRE_CHAIN_CONFIGS'
// TARGETS column: all of them, or the first three, which keeps the d = 4
// and d = 32 kernels the code they had before ids 4 and 5).
constexpr int kLastTarget[2] = {kHierarchical, kFunnel};

// A transform program (fused_mutation.py's TDProgram, lowered by
// program_block): per dimension an op code (ProgOp: periodic wrap, logit or
// probit, 0 for none) and the ops' coefficients; then the ops present (the
// codes' union, kAffine for the affine map), the bounded op's eps and the
// log-widths of its dimensions summed. The ops are fixed for a launch and
// the same for every thread, so the branches on them do not diverge.
// Forward (data to the flow's space) runs periodic, bounded, affine;
// inverse the reverse, as CompositeTransform does.
template <int D>
struct Prog {
  static constexpr int CODE = 0;         // ProgOp bits per dimension
  static constexpr int P_LO = D;         // periodic: lower bound
  static constexpr int P_W = 2 * D;      //   width (upper - lower)
  static constexpr int B_LO = 3 * D;     // logit/probit: lower bound
  static constexpr int B_W = 4 * D;      //   width
  static constexpr int B_INV = 5 * D;    //   1 / width
  static constexpr int A_MEAN = 6 * D;   // affine: mean
  static constexpr int A_STD = 7 * D;    //   std
  static constexpr int FLAGS = 8 * D;    // ops present
  static constexpr int EPS = FLAGS + 1;  // the bounded op's clip
  static constexpr int LOG_W = FLAGS + 2;  // sum of its log-widths
  static constexpr int SIZE = FLAGS + 3;
};
enum ProgOp { kPeriodic = 1, kLogit = 2, kProbit = 4, kAffine = 8 };
constexpr int kBounded = kLogit | kProbit;
// What a launch's programs need (ChainArgs::programs): none, an affine
// data transform alone, or anything else. The first two run the kernel
// instance without programs (PROGS false): the affine map inline, its
// log-Jacobian once per thread, the target on the chain state, as the
// chain computed before it took programs; the last runs the instance that
// applies both programs (PROGS true).
enum ProgramLevel { kNoProgram = 0, kAffineData = 1, kPrograms = 2 };

// Constant block layout (floats): reference mean (D), chol (D x D), ichol
// (D x D), the data transform's program and the preconditioning's, target
// constants, then what the block writes itself (store_launch_scalars): the
// launch's beta and seed pair (the seed as two uint32 words) and the two
// programs' constant log-Jacobians (prog_const_log_j).
template <int D>
struct Consts {
  static constexpr int MEAN = 0;
  static constexpr int CHOL = MEAN + D;
  static constexpr int ICHOL = CHOL + D * D;
  static constexpr int DT = ICHOL + D * D;
  static constexpr int PC = DT + Prog<D>::SIZE;
  static constexpr int TARGET = PC + Prog<D>::SIZE;
  static constexpr int BETA = TARGET + 2 * D + 2;
  static constexpr int KEY = BETA + 1;
  static constexpr int LOG_J = KEY + 2;  // data transform's, then pc's
  static constexpr int SIZE = round4(LOG_J + 2);
  static_assert(SIZE == chain_consts_floats(D), "coupling_mma.cuh's count");
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
  int n, n_layers, n_steps, kernel, gamma_m, gamma_odd, rows, programs,
      target_id;
  float nu, target_acc, adapt_rate, max_log_step, tail_bound;
  // The launch's beta and seed pair (each read as its low 32 bits) in
  // device memory, so a launch captured in a CUDA graph reads each
  // replay's values.
  const float* beta_in;
  const long long* seed_in;
#ifdef ASPIRE_USER_TARGET
  const float* user_consts;  // the user target's constants
#endif
};

template <int D>
__device__ __forceinline__ int prog_flags(const float* __restrict__ p) {
  return (int)p[Prog<D>::FLAGS];
}

// x - lower mod width into [lower, lower + width): the floor modulo of
// jnp.mod (the sign of the divisor), not fmodf's truncated one alone.
__device__ __forceinline__ float periodic_wrap(float v, float lo, float w) {
  float r = fmodf(v - lo, w);
  if (r != 0.f && ((r < 0.f) != (w < 0.f))) r += w;
  return lo + r;
}

// The log-Jacobian of program p that does not depend on the point, once
// per block: forward (sign 1) the affine map's -sum log|std| (summed in the
// kernel's order of old) and the bounded op's -sum log(width); inverse
// (sign -1) the negation of each.
template <int D>
__device__ __forceinline__ float prog_const_log_j(const float* __restrict__ p,
                                                  float sign) {
  using P = Prog<D>;
  const int flags = prog_flags<D>(p);
  float lj = 0.f;
  if (flags & kAffine) {
    for (int i = 0; i < D; ++i) lj -= sign * logf(fabsf(p[P::A_STD + i]));
  }
  if (flags & kBounded) lj -= sign * p[P::LOG_W];
  return lj;
}

// Program p on the D coordinates at v, in place: forward (data to the
// flow's space: periodic, bounded, affine) or inverse (the reverse).
// Returns the log-Jacobian's terms that depend on the point (the bounded
// op's; prog_const_log_j has the rest). Forward, u = (v - lower) / width
// clipped to [eps, 1 - eps] and y = log u - log1p(-u) (logit) or
// sqrt(2) erfinv(2u - 1) (probit); inverse, x = width u + lower with
// u = sigmoid(v) (log-Jacobian log_sigmoid(v) + log_sigmoid(-v) =
// -|v| - 2 log1p(e^-|v|), no overflow at any |v|) or (1 + erf(v / sqrt 2))
// / 2 (-(log(2 pi) + v^2) / 2).
//
// Out of line, called only for a program with more than an affine map, so
// that the ops' branches stay out of the flow pass's register allocation.
template <int D, bool INVERSE>
__device__ __noinline__ float td_general(const float* __restrict__ p,
                                         float* __restrict__ v) {
  using P = Prog<D>;
  const int flags = prog_flags<D>(p);
  float lj = 0.f;
  for (int i = 0; i < D; ++i) {
    float x = v[i];
    const int code = (int)p[P::CODE + i];
    if (INVERSE && (flags & kAffine)) {
      x = x * p[P::A_STD + i] + p[P::A_MEAN + i];
    }
    if (!INVERSE && (code & kPeriodic)) {
      x = periodic_wrap(x, p[P::P_LO + i], p[P::P_W + i]);
    }
    if (code & kBounded) {
      const float lo = p[P::B_LO + i];
      if (!INVERSE) {
        const float eps = p[P::EPS];
        const float u = fminf(fmaxf((x - lo) * p[P::B_INV + i], eps),
                              1.f - eps);
        if (code & kLogit) {
          const float lu = logf(u), lv = log1pf(-u);
          x = lu - lv;
          lj -= lu + lv;
        } else {
          x = 1.41421356237309515f * erfinvf(2.f * u - 1.f);
          lj += kHalfLog2Pi + 0.5f * x * x;
        }
      } else {
        float u;
        if (code & kLogit) {
          const float e = expf(-fabsf(x));
          const float r = 1.f / (1.f + e);
          u = x >= 0.f ? r : e * r;
          lj -= fabsf(x) + 2.f * log1pf(e);
        } else {
          u = 0.5f * (1.f + erff(x * 0.70710678118654752f));
          lj -= kHalfLog2Pi + 0.5f * x * x;
        }
        x = p[P::B_W + i] * u + lo;
      }
    }
    if (INVERSE && (code & kPeriodic)) {
      x = periodic_wrap(x, p[P::P_LO + i], p[P::P_W + i]);
    }
    if (!INVERSE && (flags & kAffine)) {
      x = (x - p[P::A_MEAN + i]) / p[P::A_STD + i];
    }
    v[i] = x;
  }
  return lj;
}

// Program p on x (anything x[i] reads) into y (a register array or a row
// of shared memory; it may be x), forward or inverse; returns td_general's
// log-Jacobian. An identity or affine program forward takes the affine
// loop inline; any other goes through td_general on a copy in local
// memory, so that no register array's address escapes.
template <int D, bool INVERSE, class X, class Y>
__device__ __forceinline__ float td_apply(const float* __restrict__ p,
                                          const X& x, Y& y) {
  using P = Prog<D>;
  const int flags = prog_flags<D>(p);
  if (!INVERSE && !(flags & (kPeriodic | kBounded))) {
    const bool affine = flags & kAffine;
    constexpr int kAffineUnroll = D <= 8 ? D : 8;
#pragma unroll(kAffineUnroll)
    for (int i = 0; i < D; ++i) {
      y[i] = affine ? (x[i] - p[P::A_MEAN + i]) / p[P::A_STD + i] : x[i];
    }
    return 0.f;
  }
  float v[D];
  for (int i = 0; i < D; ++i) v[i] = x[i];
  const float lj = td_general<D, INVERSE>(p, v);
  for (int i = 0; i < D; ++i) y[i] = v[i];
  return lj;
}

// Thread 0 copies the launch's beta and seed pair into the block's
// constant block and computes the programs' constant log-Jacobians there,
// once per block, after the block has loaded its constants (the caller's
// barriers order the two). Every use then reads shared memory, as for the
// other constants, and holds no register across the chain.
template <int D, bool PROGS>
__device__ __forceinline__ void store_launch_scalars(const ChainArgs& a,
                                                     float* c) {
  using C = Consts<D>;
  uint32_t* key = reinterpret_cast<uint32_t*>(c + C::KEY);
  c[C::BETA] = *a.beta_in;
  key[0] = (uint32_t)a.seed_in[0];
  key[1] = (uint32_t)a.seed_in[1];
  if constexpr (PROGS) {
    c[C::LOG_J] = prog_const_log_j<D>(c + C::DT, 1.f);
    c[C::LOG_J + 1] = prog_const_log_j<D>(c + C::PC, -1.f);
  }
}

// The uniforms of one particle's step, in increasing row order.
struct NoiseStream {
  const float* noise;  // injected (n_steps, rows, n), or nullptr
  int n, rows, p, step;
  uint32_t local, tile;
  const uint32_t* key;  // the seed pair, in the block's constant block
  uint4 block;
  int group;

  __device__ __forceinline__ float get(int row) {
    if (noise != nullptr) {
      return noise[((size_t)step * rows + row) * n + p];
    }
    const int g = row >> 2;
    if (g != group) {
      block = philox4x32_10(
          make_uint4(local, (uint32_t)step, (uint32_t)g, tile),
          make_uint2(key[0], key[1]));
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

// The Gaussian target: c = [mu, sigma, lower, upper].
template <int D, class X>
__device__ __forceinline__ void gaussian_target(const float* c, const X& x,
                                                float& lpi, float& ll) {
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

// In-kernel targets (models/targets.py carries the ids and constants); x
// is anything x[i] reads coordinate i of (a register array, or a Strided
// view of shared memory). TARGETS (ASPIRE_CHAIN_CONFIGS): with 0 the ids
// up to kHierarchical, with 1 also kRosenbrock and kFunnel, whose
// arithmetic follows the torch version's order (its constant terms formed
// once: log 2 pi scale^2, log 2 pi prior_scale^2, d log width).
template <int D, int TARGETS, class X>
__device__ __forceinline__ void target_densities(int id, const float* c,
                                                 const X& x, float& lpi,
                                                 float& ll) {
#ifdef ASPIRE_USER_TARGET
  // The instance built with a user's source: its target alone (the launch
  // admits only kUser).
  ::user_target<D>(c, x, lpi, ll);
#else
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
  } else if constexpr (TARGETS == 1) {
    if (id == kRosenbrock) {
      // c = [lower, upper]: -sum 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2, on
      // the closed box.
      const float lower = c[0], upper = c[1];
      float acc = 0.f;
      bool inside = true;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (i + 1 < D) {
          const float r = x[i + 1] - x[i] * x[i];
          const float q = 1.f - x[i];
          acc += 100.f * (r * r) + q * q;
        }
        inside = inside && (x[i] >= lower) && (x[i] <= upper);
      }
      ll = -acc;
      lpi = inside ? -D * logf(upper - lower) : -INFINITY;
    } else if (id == kFunnel) {
      // c = [scale, prior_scale]; x = [v, rest]: v ~ N(0, scale^2),
      // rest ~ N(0, e^v); every coordinate ~ N(0, prior_scale^2) in the
      // prior. exp(-v) overflows below v ~ -88: -inf, or NaN -> -inf.
      const float scale = c[0], ps = c[1], v = x[0];
      float rest = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float r = x[i] / ps;
        q += r * r;
        if (i > 0) rest += x[i] * x[i];
      }
      const float a = v / scale;
      ll = (-0.5f * (a * a) -
            0.5f * logf(6.28318530717958648f * (scale * scale))) +
           (-0.5f * rest * expf(-v) - 0.5f * (D - 1) * (log2pi + v));
      lpi = -0.5f * q -
            D * (0.5f * logf(6.28318530717958648f * (ps * ps)));
    } else {
      gaussian_target<D>(c, x, lpi, ll);
    }
  } else {
    gaussian_target<D>(c, x, lpi, ll);
  }
#endif
  lpi = nan_to_neg_inf(lpi);
  ll = nan_to_neg_inf(ll);
}

// The target's constants: the constant block's target region, or the
// user target's own array.
template <int D>
__device__ __forceinline__ const float* target_consts(
    const ChainArgs& a, const float* __restrict__ c) {
#ifdef ASPIRE_USER_TARGET
  return a.user_consts;
#else
  return c + Consts<D>::TARGET;
#endif
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

// The tempered density of the chain state z (the preconditioned space):
// x = the preconditioning's inverse of z, the flow's density of x after the
// data transform (lq, in data space), the target at x, and
// lp = (1 - beta) lq + beta (ll + lpi) + the inverse's log-Jacobian. With
// PROGS, the data transform's terms that depend on x start the flow's
// log-det, and the programs' constant terms and ops are read from the
// constant block where they are used, so that no register holds them
// across the flow. Without, the data transform is the affine map or none
// (ChainArgs::programs), dt_lj its log-Jacobian, and x = z.
template <int D, class HID, int K, bool RQS, bool PROGS, int TARGETS,
          bool STREAM>
__device__ __forceinline__ void tempered(const ChainArgs& a,
                                         float* __restrict__ w,
                                         const float* __restrict__ c,
                                         float* __restrict__ buf, int lane,
                                         float dt_lj, const float (&z)[D],
                                         float& lp, float& lq, float& lpi,
                                         float& ll) {
  using C = Consts<D>;
  using P = Prog<D>;
  using S = MmaShape<D, HID, K, RQS>;
  float f[S::DP];  // and the flow's padding slot at an odd D, 0
  if constexpr (S::DP > D) f[D] = 0.f;
  float ld = 0.f;
  if constexpr (PROGS) {
#pragma unroll
    for (int i = 0; i < D; ++i) f[i] = z[i];
    if (prog_flags<D>(c + C::PC)) td_apply<D, true>(c + C::PC, f, f);
    ld = td_apply<D, false>(c + C::DT, f, f);
    dt_lj = c[C::LOG_J];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      f[i] = a.programs == kAffineData
                 ? (z[i] - c[C::DT + P::A_MEAN + i]) / c[C::DT + P::A_STD + i]
                 : z[i];
    }
  }
  if constexpr (STREAM) {
    flow_density_streamed<S>(a.weights, w, a.n_layers, a.tail_bound, buf,
                             lane, f, ld);
  } else {
    flow_density<S>(w, a.n_layers, a.tail_bound, buf, lane, f, ld);
  }
  float zz = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) zz += f[i] * f[i];
  lq = -0.5f * zz - D * kHalfLog2Pi + ld + dt_lj;
  const float beta = c[C::BETA];
  if constexpr (PROGS) {
    const bool precond = prog_flags<D>(c + C::PC) != 0;
    float x[D];
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = z[i];
    float pc_lj = 0.f;
    if (precond) pc_lj = c[C::LOG_J + 1] + td_apply<D, true>(c + C::PC, z, x);
    target_densities<D, TARGETS>(a.target_id, target_consts<D>(a, c), x,
                                  lpi, ll);
    lp = nan_to_neg_inf((1.f - beta) * lq + beta * (ll + lpi) + pc_lj);
  } else {
    target_densities<D, TARGETS>(a.target_id, target_consts<D>(a, c), z,
                                  lpi, ll);
    lp = nan_to_neg_inf((1.f - beta) * lq + beta * (ll + lpi));
  }
}

// The affine data transform's log-Jacobian, -sum log|std|, for the kernel
// instance without programs (0 for no data transform).
template <int D, int UNROLL>
__device__ __forceinline__ float affine_log_j(const ChainArgs& a,
                                              const float* __restrict__ c) {
  float dt_lj = 0.f;
  if (a.programs == kAffineData) {
#pragma unroll(UNROLL)
    for (int i = 0; i < D; ++i) {
      dt_lj -= logf(fabsf(c[Consts<D>::DT + Prog<D>::A_STD + i]));
    }
  }
  return dt_lj;
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

// The whole-layer chain (chain_kernel, and chain_kernel_streamed with
// STREAM): every layer's weights resident in shared memory, or (STREAM)
// two layer buffers the flow passes stream the layers through.
template <int D, class HID, int K, bool RQS, bool PROGS, int TARGETS,
          bool STREAM>
__device__ __forceinline__ void chain_body(const ChainArgs& a) {
  using S = MmaShape<D, HID, K, RQS>;
  using C = Consts<D>;
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  const int wfloats = STREAM ? 2 * S::SIZE : a.n_layers * S::SIZE;
  float* c = w + wfloats;
  float* scratch = c + C::SIZE;
  const int lane = threadIdx.x & 31;
  float* buf = scratch + 2 * kWarps + (threadIdx.x >> 5) * S::STAGE;
  if constexpr (!STREAM) {
    load_shared(smem4, reinterpret_cast<const float4*>(a.weights),
                wfloats / 4);
  }
  load_shared(reinterpret_cast<float4*>(c),
              reinterpret_cast<const float4*>(a.consts), C::SIZE / 4);
  __syncthreads();
  if (threadIdx.x == 0) store_launch_scalars<D, PROGS>(a, c);
  __syncthreads();

  const int p = blockIdx.x * kTile + threadIdx.x;
  const float dt_lj = PROGS ? 0.f : affine_log_j<D, D>(a, c);

  float x[D], x0[D], prev[D], s1[D], s2[D], c1[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x0[i] = x[i] = a.z0[(size_t)p * D + i];
    prev[i] = s1[i] = s2[i] = c1[i] = 0.f;
  }
  float lp, lq, lpi, ll;
  tempered<D, HID, K, RQS, PROGS, TARGETS, STREAM>(a, w, c, buf, lane,
                                                      dt_lj, x, lp, lq, lpi,
                                                      ll);
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
  ns.key = reinterpret_cast<const uint32_t*>(c + C::KEY);

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
    tempered<D, HID, K, RQS, PROGS, TARGETS, STREAM>(
        a, w, c, buf, lane, dt_lj, xp, lp_p, lq_p, lpi_p, ll_p);
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

template <int D, class HID, int K, bool RQS, bool PROGS, int TARGETS>
__global__ void __launch_bounds__(kTile, 1) chain_kernel(ChainArgs a) {
  chain_body<D, HID, K, RQS, PROGS, TARGETS, false>(a);
}

#ifdef ASPIRE_STREAMED
template <int D, class HID, int K, bool RQS, bool PROGS, int TARGETS>
__global__ void __launch_bounds__(kTile, 1)
    chain_kernel_streamed(ChainArgs a) {
  chain_body<D, HID, K, RQS, PROGS, TARGETS, true>(a);
}
#endif

// Coordinate i of a particle whose coordinates lie kTile floats apart in
// shared memory (the wide form's [D][kTile] arrays).
struct Strided {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return p[i * kTile];
  }
};

// The wide form's tempered density of the chain state at zs (a Strided
// view), as tempered's: the preconditioning's inverse and the data
// transform into the lane's row of the warp's buffer F, the flow's density
// pass (flow_pass_wide, every thread of the block together), then the
// target at the data-space point, which a preconditioned run writes into
// the row again once the pass has read it (no register holds it across
// the pass). Without PROGS, as tempered's.
template <class S, int D, bool PROGS, int TARGETS>
__device__ __forceinline__ void tempered_wide(
    const ChainArgs& a, WideStream<S>& ws, const float* __restrict__ c,
    float* __restrict__ F, float* __restrict__ pb, int lane, float dt_lj,
    Strided zs, float& lp, float& lq, float& lpi, float& ll) {
  using C = Consts<D>;
  using P = Prog<D>;
  float* f = F + lane * S::FROW;
  float ld = 0.f;
  if constexpr (PROGS) {
    if (prog_flags<D>(c + C::PC)) {
      td_apply<D, true>(c + C::PC, zs, f);
      ld = td_apply<D, false>(c + C::DT, f, f);
    } else {
      ld = td_apply<D, false>(c + C::DT, zs, f);
    }
    dt_lj = c[C::LOG_J];
  } else {
#pragma unroll 8
    for (int i = 0; i < D; ++i) {
      f[i] = a.programs == kAffineData
                 ? (zs[i] - c[C::DT + P::A_MEAN + i]) / c[C::DT + P::A_STD + i]
                 : zs[i];
    }
  }
  flow_pass_wide<S, true>(ws, a.tail_bound, F, pb, lane, ld);
  float zz = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; ++i) zz += f[i] * f[i];
  lq = -0.5f * zz - D * kHalfLog2Pi + ld + dt_lj;
  const float beta = c[C::BETA];
  if (PROGS && prog_flags<D>(c + C::PC)) {
    const float pc_lj = c[C::LOG_J + 1] + td_apply<D, true>(c + C::PC, zs, f);
    target_densities<D, TARGETS>(a.target_id, target_consts<D>(a, c), f,
                                  lpi, ll);
    lp = nan_to_neg_inf((1.f - beta) * lq + beta * (ll + lpi) + pc_lj);
  } else {
    target_densities<D, TARGETS>(a.target_id, target_consts<D>(a, c), zs,
                                  lpi, ll);
    lp = nan_to_neg_inf((1.f - beta) * lq + beta * (ll + lpi));
  }
}

// The wide chain's block, at LEVEL: the shape's stream (MmaShape) with
// the stream's plan changed as the level says. ChainWidePlan picks it.
template <class M, int LEVEL>
struct ChainWideAt : M {
  static constexpr bool ONE_RES = M::ONE_RES || LEVEL >= 2;
  static constexpr int RESB = (ONE_RES ? 1 : 2) * M::RES;
  // A warp's buffer in shared memory: the group parameters, the warp's
  // particle rows unless they are in global memory (LEVEL 3), then with
  // one hidden layer the row tile's inputs.
  static constexpr int UB = 16 * M::ROW + (LEVEL >= 3 ? 0 : 32 * M::FROW);
  static constexpr int STAGE = M::STAGE - (LEVEL >= 3 ? 32 * M::FROW : 0);
};

// The wide chain's block (chain_kernel_wide) at the first level whose block
// fits one SM (ops/fused_mutation.py::chain_wide_plan mirrors it): 0 the
// shape's stream (MmaShape) with the chain state, two [D][kTile] arrays, and
// the warps' particle rows in shared memory; 1 the state arrays in global
// memory (ChainArgs::scratch after the statistics' sums, per tile); 2 also
// one resident part of a layer (MmaShape::ONE_RES's stream); 3 also the
// particle rows in global memory (after the state, per warp).
template <int D, class M>
struct ChainWidePlan {
  __host__ __device__ static constexpr int floats(int level) {
    const bool one = M::ONE_RES || level >= 2;
    return Consts<D>::SIZE + 2 * kWarps + (level == 0 ? 2 * D * kTile : 0) +
           (one ? 1 : 2) * M::RES + 2 * M::CHUNK +
           kWarps * (M::STAGE - (level >= 3 ? 32 * M::FROW : 0));
  }
  static constexpr int LEVEL = floats(0) <= kMaxBlockFloats   ? 0
                               : floats(1) <= kMaxBlockFloats ? 1
                               : floats(2) <= kMaxBlockFloats ? 2
                                                              : 3;
  using S = std::conditional_t<LEVEL == 0, M, ChainWideAt<M, LEVEL>>;
};

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
// warps' buffers: 189,136 B at d = 32, one block per SM. A flow whose block
// does not fit takes a level of ChainWidePlan: its state arrays, and then
// its particle rows, in global memory after the sums (each read and written
// by the threads that own it, in the same order), one resident slot.
template <int D, class HID, int K, bool RQS, bool PROGS, int TARGETS>
__global__ void __launch_bounds__(kTile, 1) chain_kernel_wide(ChainArgs a) {
  using Plan = ChainWidePlan<D, MmaShape<D, HID, K, RQS>>;
  using S = typename Plan::S;
  using C = Consts<D>;
  extern __shared__ float4 smem4[];
  float* c = reinterpret_cast<float*>(smem4);
  float* scratch = c + C::SIZE;
  const int tid = threadIdx.x, lane = tid & 31;
  float *X, *XP, *res, *F;
  if constexpr (Plan::LEVEL == 0) {
    X = scratch + 2 * kWarps;
    XP = X + D * kTile;
    res = XP + D * kTile;
  } else {
    X = a.scratch + 3 * (size_t)D * a.n + (size_t)blockIdx.x * 2 * D * kTile;
    XP = X + D * kTile;
    res = scratch + 2 * kWarps;
  }
  float* ring = res + S::RESB;
  float* pb = ring + 2 * S::CHUNK + (tid >> 5) * S::STAGE;
  if constexpr (Plan::LEVEL >= 3) {
    F = a.scratch + 5 * (size_t)D * a.n +
        ((size_t)blockIdx.x * kWarps + (tid >> 5)) * 32 * S::FROW;
  } else {
    F = pb + 16 * S::ROW;
  }
  float* xi = F + lane * S::FROW;
  WideStream<S> ws{res, ring, a.weights, a.n_layers, true, 0};
  if constexpr (D % 2 == 1) F[lane * S::FROW + D] = 0.f;  // padding slot
  load_shared(smem4, reinterpret_cast<const float4*>(a.consts), C::SIZE / 4);
  __syncthreads();
  if (tid == 0) store_launch_scalars<D, PROGS>(a, c);
  __syncthreads();

  const int p = blockIdx.x * kTile + tid;
  const size_t n = (size_t)a.n;
  const float dt_lj = PROGS ? 0.f : affine_log_j<D, 8>(a, c);
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
  tempered_wide<S, D, PROGS, TARGETS>(a, ws, c, F, pb, lane, dt_lj, x, lp,
                                      lq, lpi, ll);
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
  ns.key = reinterpret_cast<const uint32_t*>(c + C::KEY);

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
    tempered_wide<S, D, PROGS, TARGETS>(a, ws, c, F, pb, lane, dt_lj, xp,
                                        lp_p, lq_p, lpi_p, ll_p);
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

template <int D, class HID, int K, bool RQS, int TARGETS>
int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  using S = MmaShape<D, HID, K, RQS>;
  // Every layer's weights, or (wide) the block ChainWidePlan picks.
  size_t smem = sizeof(float) * ((size_t)a.n_layers * S::SIZE +
                                 Consts<D>::SIZE + 2 * kWarps +
                                 kWarps * S::STAGE);
  if constexpr (S::WIDE) {
    using Plan = ChainWidePlan<D, S>;
    smem = sizeof(float) * Plan::floats(Plan::LEVEL);
  }
#ifdef ASPIRE_STREAMED
  // The streamed instance: the whole-layer form's two layer buffers.
  if constexpr (!S::WIDE) {
    smem = sizeof(float) * (2 * S::SIZE + Consts<D>::SIZE + 2 * kWarps +
                            kWarps * S::STAGE);
  }
#else
  // A flow too deep for its layers to stay resident takes the streamed
  // instance (-4 here).
  if (!S::WIDE && smem > (size_t)current_device_limits().max_smem) {
    return -4;
  }
#endif
#ifdef ASPIRE_USER_TARGET
  if (a.target_id != kUser) return -3;
#else
  if (a.target_id < 1 || a.target_id > kLastTarget[TARGETS]) return -3;
#endif
  const bool progs = a.programs == kPrograms;
  void (*kernel)(ChainArgs);
  if constexpr (S::WIDE) {
    kernel = progs ? chain_kernel_wide<D, HID, K, RQS, true, TARGETS>
                   : chain_kernel_wide<D, HID, K, RQS, false, TARGETS>;
  } else {
#ifdef ASPIRE_STREAMED
    kernel = progs ? chain_kernel_streamed<D, HID, K, RQS, true, TARGETS>
                   : chain_kernel_streamed<D, HID, K, RQS, false, TARGETS>;
#else
    kernel = progs ? chain_kernel<D, HID, K, RQS, true, TARGETS>
                   : chain_kernel<D, HID, K, RQS, false, TARGETS>;
#endif
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n / kTile, kTile, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef ASPIRE_USER_TARGET
// The user's target alone at n points x (n, D) of data space, one thread
// each, through target_densities as the chain evaluates it.
template <int D>
__global__ void user_target_kernel(const float* __restrict__ x, int n,
                                   const float* __restrict__ c,
                                   float* __restrict__ lpi,
                                   float* __restrict__ ll) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = x[(size_t)p * D + i];
  float a, b;
  target_densities<D, 0>(kUser, c, v, a, b);
  lpi[p] = a;
  ll[p] = b;
}
#endif

}  // namespace aspire

extern "C" {

int aspire_chain_tile() { return aspire::kTile; }

// The constant block at `dims`: the offsets of the data-transform
// program, the preconditioning program, the target constants, beta, the
// seed pair and the programs' constant log-Jacobians, then its size in
// floats, into out (up to capacity entries).
// Returns their number, or -1 for a d no chain configuration has.
int aspire_consts_layout(int dims, int* out, int capacity) {
#define ASPIRE_CONSTS_CASE(ID, D, HID, K, RQS, TARGETS)                       \
  if (dims == D) {                                                     \
    using C = aspire::Consts<D>;                                       \
    const int v[] = {C::DT,   C::PC,    C::TARGET, C::BETA,            \
                     C::KEY,  C::LOG_J, C::SIZE};                      \
    const int count = (int)(sizeof(v) / sizeof(v[0]));                 \
    for (int e = 0; e < count && e < capacity; ++e) out[e] = v[e];     \
    return count;                                                      \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CONSTS_CASE)
#undef ASPIRE_CONSTS_CASE
  return -1;
}

// The wide chain's block of configuration `config` (ChainWidePlan): its
// level and floats of shared memory, into out (up to capacity entries);
// (-1, 0) for the whole-layer form. Returns their number, or -1 for an
// unknown configuration.
int aspire_chain_plan(int config, int* out, int capacity) {
#define ASPIRE_CHAIN_PLAN_CASE(ID, D, HID, K, RQS, TARGETS)               \
  if (config == ID) {                                                  \
    using M = aspire::MmaShape<D, ASPIRE_HIDDEN HID, K, RQS>;          \
    using P = aspire::ChainWidePlan<D, M>;                             \
    const int v[] = {M::WIDE ? P::LEVEL : -1,                          \
                     M::WIDE ? P::floats(P::LEVEL) : 0};               \
    for (int e = 0; e < 2 && e < capacity; ++e) out[e] = v[e];         \
    return 2;                                                          \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_PLAN_CASE)
#undef ASPIRE_CHAIN_PLAN_CASE
  return -1;
}

// The packed layout of chain configuration `config`, as MmaShape
// computes it (mma_layout_table), into out (up to capacity entries).
// Returns their number, or -1 for an unknown configuration.
int aspire_chain_layout(int config, int* out, int capacity) {
#define ASPIRE_CHAIN_LAYOUT_CASE(ID, D, HID, K, RQS, TARGETS)           \
  if (config == ID) {                                                  \
    return aspire::mma_layout_table<                                   \
        aspire::MmaShape<D, ASPIRE_HIDDEN HID, K, RQS>>(out, capacity, \
                                                        false);        \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_LAYOUT_CASE)
#undef ASPIRE_CHAIN_LAYOUT_CASE
  return -1;
}

// Returns the launch's cudaError_t; -1 for an unknown configuration, -2
// when n is not a multiple of the tile, -3 for a target id the
// configuration does not compile (ASPIRE_CHAIN_CONFIGS' TARGETS; an
// instance built with a user's source compiles kUser alone, and its entry,
// aspire_chain_user, takes the user target's constants last) and -4 for a
// flow too deep for its layers to stay resident in a library without the
// streamed form (the prebuilt one, or a resident instance).
// scratch: for a wide configuration (MmaShape::WIDE) 3 * D * n floats,
// then at ChainWidePlan's level 1 or more 2 * D * n for the state arrays,
// at level 3 (D + 1) * n more for the particle rows; else unused. beta
// (one float) and seed (two 64-bit integers, each read as its low 32 bits)
// are device memory, read when the kernel runs.
#ifdef ASPIRE_USER_TARGET
int aspire_chain_user(
#else
int aspire_chain(
#endif
                 const float* z0, const float* weights, const float* consts,
                 const float* step0, const float* noise, float* z, float* lq,
                 float* lpi, float* ll, float* nacc, float* stats,
                 float* scratch, int n,
                 int n_layers, int n_steps, int kernel, int gamma_m,
                 int gamma_odd, int rows, int programs, int target_id,
                 const float* beta, float nu, float target_acc,
                 float adapt_rate, float max_log_step, float tail_bound,
                 const long long* seed, int config, void* stream
#ifdef ASPIRE_USER_TARGET
                 , const float* user_consts
#endif
                 ) {
  if (n % aspire::kTile != 0) return -2;
  aspire::ChainArgs a{z0, weights, consts, step0, noise, z, lq, lpi, ll,
                      nacc, stats, scratch, n, n_layers, n_steps, kernel, gamma_m,
                      gamma_odd, rows, programs, target_id, nu,
                      target_acc, adapt_rate, max_log_step, tail_bound,
                      beta, seed};
#ifdef ASPIRE_USER_TARGET
  a.user_consts = user_consts;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_CHAIN_CASE(ID, D, HID, K, RQS, TARGETS) \
  if (config == ID) {                                     \
    return aspire::launch_chain<D, ASPIRE_HIDDEN HID, K, RQS, TARGETS>(a, s); \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_CHAIN_CASE)
#undef ASPIRE_CHAIN_CASE
  return -1;
}

#ifdef ASPIRE_USER_TARGET
// The user's target at n points x (n, dims) of data space into lpi and ll
// (n each), with constants c. Returns the launch's cudaError_t, or -1 for a
// dims the instance does not compile.
int aspire_user_target(const float* x, int n, int dims, const float* c,
                       float* lpi, float* ll, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_USER_TARGET_CASE(ID, D, HID, K, RQS, TARGETS)       \
  if (dims == D) {                                                    \
    aspire::user_target_kernel<D><<<(n + 255) / 256, 256, 0, s>>>(    \
        x, n, c, lpi, ll);                                            \
    return (int)cudaGetLastError();                                   \
  }
  ASPIRE_CHAIN_CONFIGS(ASPIRE_USER_TARGET_CASE)
#undef ASPIRE_USER_TARGET_CASE
  return -1;
}
#endif

}  // extern "C"
