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
// - Tensor cores. The products past the first layer (with two hidden
//   layers h1 (16 x H1) . W2 and h2 (16 x H2) . W3; any depth takes each
//   hidden product in turn, and with none the inputs are W3's A
//   fragments), run as mma.sync m16n8k8 TF32 over a tile of 16 particles
//   per warp, in split form (3xTF32): every operand is a = hi + lo in two
//   TF32 values and each product takes lo.hi + hi.lo + hi.hi, which keeps
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

// - Every other shape (d <= 32, up to 32 bins, any hidden widths, /8 once
//   packed) gets an instance of its own, built at first use
//   (ops/_build.py::build_instance, which defines ASPIRE_INSTANCE_CONFIG(X)
//   as its configuration row). Where a flow's layers do not fit one block
//   beside a warp's buffer, its instance (ASPIRE_STREAMED) streams them
//   (maf_kernel_streamed, compiled in place of maf_kernel):
//   per layer its head (W1, b1, b2, b3) to a buffer of its own, then W2's
//   fragments by chunks of n-tiles (the first layer's k-steps recomputed
//   for each chunk) and W3's by two dims at a time through two shared
//   slots with cp.async, one block barrier each, the same packing and
//   split-TF32 products; each warp's 16 particles go through the layer
//   together, two dims' splines at a time (lane = row x dim). Where two
//   dims' W3 fragments leave no warp (maf-rqs 4 x (256, 256) at d = 4, 20
//   bins: 27,648 floats an item), the instance compiles the chunked form
//   (maf_kernel_chunked) in its place: W3 by k-steps too, and where the
//   head alone leaves no warp (a 768- or 1024-wide first layer from
//   d = 21), W1
//   streamed as well, h_0 made whole from its items.

#include <type_traits>
#include <utility>

#include "common.cuh"

#ifdef ASPIRE_INSTANCE_CONFIG
#undef ASPIRE_MAF_CONFIGS
#define ASPIRE_MAF_CONFIGS(X) ASPIRE_INSTANCE_CONFIG(X)
#endif

namespace aspire {

constexpr int kMafTile = 16;      // particles per warp tile: the mma's M
constexpr int kMafMaxWarps = 16;  // warps per block, as shared memory allows

// Packed MAF weight layout (built by ops/fused_coupling.py::
// prepare_maf_params), per flow layer, hidden units sorted by MADE degree
// (degree j % (D - 1) + 1 of unit j, stably sorted), every weight
// premultiplied by its mask, every hidden-product and W3 weight rounded to
// the sum of two TF32 values (split_tf32_sum). With NH hidden layers of
// widths H_0 .. H_{NH-1}:
//   W1  (H_0 x D)       W1[u*D + i] = w0[i][unit u] * m0
//   b1  (H_0)
//   per hidden product j < NH - 1 (h_j -> h_{j+1}; W2 and b2 for j = 0):
//   WH_j  FH(j) fragments  n-tile n (units 8n..8n+7 of h_{j+1}) for
//                         k-steps s < ksh(j, n)
//   BH_j  (H_{j+1})
//   W3  F3 fragments    dim i, k-step s < ks3(i), n-tile m < NT
//   b3  (D x G)         b3[i*G + q] = b_out[i*P + q], q < P
// A fragment is 32 lanes x 2 floats: lane 4g + t holds W[8s + 2t][8j + g]
// and W[8s + 2t + 1][8j + g] (rows: sorted input units, columns: sorted
// output units or the D x G parameter columns). P = 3K - 1 spline
// parameters of a dim are padded to G = a multiple of 8. With no hidden
// layer W3's rows are the inputs (dim i reads inputs < i) and the layer is
// W3 and b3 alone. MafBlocks counts the kept blocks and places the
// sections; MafShape, complete only once MafBlocks is, holds them.
template <int D, class HID, int K>
struct MafBlocks {
  static constexpr int NH = HID::N;  // hidden layers
  __host__ __device__ static constexpr int HW(int i) { return HID::width(i); }
  __host__ __device__ static constexpr int KS(int i) {
    return HID::width(i) / 8;
  }
  static constexpr int H1 = NH ? HID::width(0) : 0;       // first hidden
  static constexpr int HL = NH ? HID::width(NH - 1) : 0;  // last hidden
  static constexpr int P = 3 * K - 1;
  static constexpr int G = (P + 7) / 8 * 8;
  static constexpr int NT = G / 8;  // n-tiles per dim
  static constexpr int MD = D > 1 ? D - 1 : 1;  // highest hidden degree
  static constexpr int DIMS = D;
  __host__ __device__ static constexpr bool widths_ok() {
    for (int i = 0; i < NH; ++i) {
      if (HW(i) <= 0 || HW(i) % 8) return false;
    }
    return true;
  }
  // Hidden units of degree <= d among h units (the sorted segment ends):
  // unit j has degree j % MD + 1, so each whole run of MD units holds
  // min(d, MD) of them and the last, partial run min(h % MD, d). In closed
  // form, so that the streamed forms' tables at wide layers stay within
  // the compiler's constant-evaluation budget.
  __host__ __device__ static constexpr int ends(int h, int d) {
    if (d <= 0) return 0;
    return h / MD * (d < MD ? d : MD) + (h % MD < d ? h % MD : d);
  }
  // Degree of sorted hidden unit u among h units.
  __host__ __device__ static constexpr int degree(int h, int u) {
    int d = 1;
    while (d < MD && u >= ends(h, d)) ++d;
    return d;
  }
  // k-steps of hidden product j for n-tile n; of W2 (j = 0) for n-tile n;
  // of W3 for dim i (the last hidden layer's units of degree <= i, or with
  // no hidden layer the inputs below i).
  __host__ __device__ static constexpr int ksh(int j, int n) {
    return (ends(HW(j), degree(HW(j + 1), 8 * n + 7)) + 7) / 8;
  }
  __host__ __device__ static constexpr int ks2(int n) { return ksh(0, n); }
  __host__ __device__ static constexpr int ks3(int i) {
    return ((NH ? ends(HL, i) : (i < D ? i : D)) + 7) / 8;
  }
  __host__ __device__ static constexpr int fh_before(int j, int n) {
    int f = 0;
    for (int q = 0; q < n; ++q) f += ksh(j, q);
    return f;
  }
  __host__ __device__ static constexpr int f2_before(int n) {
    return fh_before(0, n);
  }
  __host__ __device__ static constexpr int FH(int j) {
    return fh_before(j, KS(j + 1));
  }
  __host__ __device__ static constexpr int f3_before(int i) {
    int f = 0;
    for (int q = 0; q < i; ++q) f += NT * ks3(q);
    return f;
  }
  static constexpr int W1 = NH ? 0 : -1;
  static constexpr int B1 = NH ? round4(H1 * D) : -1;
  // Offsets of hidden product j's fragments (WH) and bias (BH).
  __host__ __device__ static constexpr int WH(int j) {
    return j == 0 ? round4(B1 + H1) : round4(BH(j - 1) + HW(j));
  }
  __host__ __device__ static constexpr int BH(int j) {
    return WH(j) + 64 * FH(j);
  }
  __host__ __device__ static constexpr int w3_offset() {
    return NH == 0   ? 0
           : NH == 1 ? round4(B1 + H1)
                     : round4(BH(NH - 2) + HL);
  }
};

template <int D, class HID, int K>
struct MafShape : MafBlocks<D, HID, K> {
  using B = MafBlocks<D, HID, K>;
  static_assert(B::widths_ok(), "hidden widths must be /8");
  static constexpr int F2 = B::NH >= 2 ? B::FH(0) : 0;
  static constexpr int F3 = B::f3_before(D);
  static constexpr int W2 = B::NH >= 2 ? B::WH(0) : -1;
  static constexpr int B2 = B::NH >= 2 ? B::BH(0) : -1;
  static constexpr int W3 = B::w3_offset();
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

// The A fragment of k-step s of the first hidden layer (h_0 = relu(W1 x +
// b1), a unit of degree d reading the inputs below d) for the tile's rows
// g and g + 8 (their inputs xa, xb): units 8s + 2t and 8s + 2t + 1, in
// A-fragment order (g, u0), (g + 8, u0), (g, u1), (g + 8, u1). W1 and b1
// at w's offsets S::W1, S::B1 (the layer's, or a streamed head's).
template <class S>
__device__ __forceinline__ void maf_first_values(const float* __restrict__ w,
                                                 const float (&xa)[S::MD],
                                                 const float (&xb)[S::MD],
                                                 int s, int t, float (&h)[4]) {
  constexpr int MD = S::MD;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int u = 8 * s + 2 * t + c;
    int deg = 1;
    static_for<MD - 1>([&](auto d_) {
      constexpr int e = S::ends(S::H1, decltype(d_)::value + 1);
      deg += u >= e ? 1 : 0;
    });
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < MD; ++i) {
      if (i < deg) {
        const float wi = w[S::W1 + u * S::DIMS + i];
        a = fmaf(wi, xa[i], a);
        b = fmaf(wi, xb[i], b);
      }
    }
    const float bias = w[S::B1 + u];
    h[2 * c] = fmaxf(a + bias, 0.f);
    h[2 * c + 1] = fmaxf(b + bias, 0.f);
  }
}

template <class S>
struct MafFirstFragment {
  const float* __restrict__ w;
  const float (&xa)[S::MD];
  const float (&xb)[S::MD];
  int t;

  __device__ __forceinline__ void operator()(int s, uint32_t (&hh)[4],
                                             uint32_t (&hl)[4]) const {
    float h[4];
    maf_first_values<S>(w, xa, xb, s, t, h);
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(h[r], hh[r], hl[r]);
  }
};

// The A fragment of k-step s of a product whose input is a hidden layer
// held as accumulator fragments: the accumulator of n-tile s, (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1), is the A fragment of k-step s in the
// order (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1).
template <int N>
struct MafAccFragment {
  const float (&acc)[N][4];

  __device__ __forceinline__ void operator()(int s, uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) const {
    split_tf32(acc[s][0], ah[0], al[0]);
    split_tf32(acc[s][2], ah[1], al[1]);
    split_tf32(acc[s][1], ah[2], al[2]);
    split_tf32(acc[s][3], ah[3], al[3]);
  }
};

// The A fragment of k-step s of the inputs themselves (no hidden layer):
// x[row][8s + 2t + e] of the tile's rows g and g + 8 (xs, [16][D]), 0 past
// D.
template <int D>
struct MafInputFragment {
  const float* __restrict__ xs;
  int g, t;

  __device__ __forceinline__ void operator()(int s, uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) const {
    const int c = 8 * s + 2 * t;
    const float v[4] = {c < D ? xs[g * D + c] : 0.f,
                        c < D ? xs[(g + 8) * D + c] : 0.f,
                        c + 1 < D ? xs[g * D + c + 1] : 0.f,
                        c + 1 < D ? xs[(g + 8) * D + c + 1] : 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(v[r], ah[r], al[r]);
  }
};

// h_{j+1} += over the k-steps each n-tile reads (ksh(j, n), block
// triangular) of hidden product j, A from frag (h_j), the fragments at
// w + at (the product's, in fh_before order); k-step outer.
template <class S, int J, int KMAX, class Frag>
__device__ __forceinline__ void maf_hidden_product(
    const float* __restrict__ w, int at, const Frag& frag,
    float (&acc)[S::KS(J + 1)][4], int lane) {
  static_for<KMAX>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    uint32_t hh[4], hl[4];
    frag(s, hh, hl);
    static_for<S::KS(J + 1)>([&](auto j_) {
      constexpr int j = decltype(j_)::value;
      if constexpr (s < S::ksh(J, j)) {
        constexpr int off = 64 * (S::fh_before(J, j) + s);
        mma_split(acc[j], hh, hl,
                  *reinterpret_cast<const float2*>(w + at + off + 2 * lane));
      }
    });
  });
}

// h = relu(acc + b) for the first COUNT n-tiles, the bias at b, kept as
// the accumulator fragments.
template <int COUNT, int N>
__device__ __forceinline__ void maf_bias_relu(const float* __restrict__ b,
                                              float (&acc)[N][4], int t) {
#pragma unroll
  for (int j = 0; j < COUNT; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
    acc[j][0] = fmaxf(acc[j][0] + bias.x, 0.f);
    acc[j][1] = fmaxf(acc[j][1] + bias.y, 0.f);
    acc[j][2] = fmaxf(acc[j][2] + bias.x, 0.f);
    acc[j][3] = fmaxf(acc[j][3] + bias.y, 0.f);
  }
}

template <int N>
__device__ __forceinline__ void maf_zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
}

// The output layer of one MADE over the warp's tile, dims 1..D-1 (dim 0's
// parameters are its bias), A of k-step s from frag, k-step outer so every
// dim's n-tiles are independent products in flight; the spline parameters
// into raw ([D - 1][16][G]).
template <class S, class Frag>
__device__ __forceinline__ void maf_output(const float* __restrict__ w,
                                           const Frag& frag,
                                           float* __restrict__ raw,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int DO = S::DIMS > 1 ? S::DIMS - 1 : 1;
  float out[DO][S::NT][4];
#pragma unroll
  for (int i = 0; i < DO; ++i) {
#pragma unroll
    for (int m = 0; m < S::NT; ++m) {
      out[i][m][0] = out[i][m][1] = out[i][m][2] = out[i][m][3] = 0.f;
    }
  }
  static_for<S::ks3(S::DIMS - 1)>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    uint32_t ah[4], al[4];
    frag(s, ah, al);
    static_for<S::DIMS - 1>([&](auto i_) {
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
  static_for<S::DIMS - 1>([&](auto i_) {
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

// The MADE from hidden layer J (its activations in acc) on: each further
// hidden product, then the output layer.
template <class S, int J>
__device__ __forceinline__ void maf_made_rest(const float* __restrict__ w,
                                              const float (&acc)[S::KS(J)][4],
                                              float* __restrict__ raw,
                                              int lane) {
  if constexpr (J + 1 < S::NH) {
    float next[S::KS(J + 1)][4];
    maf_zero(next);
    maf_hidden_product<S, J, S::ksh(J, S::KS(J + 1) - 1)>(
        w, S::WH(J), MafAccFragment<S::KS(J)>{acc}, next, lane);
    maf_bias_relu<S::KS(J + 1)>(w + S::BH(J), next, lane & 3);
    maf_made_rest<S, J + 1>(w, next, raw, lane);
  } else {
    maf_output<S>(w, MafAccFragment<S::KS(J)>{acc}, raw, lane);
  }
}

// One MADE over the warp's tile (coordinates xs, [16][D]): the spline
// parameters of dims 1..D-1 into raw ([D - 1][16][G]). Lane 4g + t owns
// particles g and g + 8 of every fragment. h_0 comes from the FMAs k-step
// by k-step straight into the first tensor product (W2, or with one hidden
// layer W3); with no hidden layer the inputs are W3's A fragments.
template <int D, class HID, int K>
__device__ __forceinline__ void maf_made(const float* __restrict__ w,
                                         const float* __restrict__ xs,
                                         float* __restrict__ raw, int lane) {
  using S = MafShape<D, HID, K>;
  constexpr int MD = S::MD;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (S::NH == 0) {
    maf_output<S>(w, MafInputFragment<D>{xs, g, t}, raw, lane);
  } else {
    float xa[MD], xb[MD];
#pragma unroll
    for (int i = 0; i < MD; ++i) {
      xa[i] = xs[g * D + i];
      xb[i] = xs[(g + 8) * D + i];
    }
    const MafFirstFragment<S> first{w, xa, xb, t};
    if constexpr (S::NH == 1) {
      maf_output<S>(w, first, raw, lane);
    } else {
      // Second hidden layer's accumulators, one fragment per n-tile.
      float acc[S::KS(1)][4];
      maf_zero(acc);
      maf_hidden_product<S, 0, S::KS(0)>(w, S::W2, first, acc, lane);
      // h2 = relu(acc + b2), kept as the accumulator fragments.
      maf_bias_relu<S::KS(1)>(w + S::B2, acc, t);
      maf_made_rest<S, 1>(w, acc, raw, lane);
    }
  }
}

// The inverse spline of every (particle, dim) of the tile, then the
// reversal of dims, in place in xs. Lane l takes the pairs e = l, l + 32,
// ... (particle e % 16, dim e / 16), all of one particle. Returns the
// lane's log-det sum.
template <int D, class HID, int K>
__device__ __forceinline__ float maf_splines(const float* __restrict__ w,
                                             float* __restrict__ xs,
                                             const float* __restrict__ raw,
                                             int lane, float tb) {
  using S = MafShape<D, HID, K>;
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

template <int D, class HID, int K>
__global__ void __launch_bounds__(32 * kMafMaxWarps, 1)
    maf_kernel(const float* __restrict__ x, float* __restrict__ z,
               float* __restrict__ log_det, const float* __restrict__ weights,
               int n, int n_layers, float tail_bound) {
  using S = MafShape<D, HID, K>;
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
      maf_made<D, HID, K>(w, xs, raw, lane);
      __syncwarp();
      ld += maf_splines<D, HID, K>(w, xs, raw, lane, tail_bound);
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

#ifdef ASPIRE_STREAMED
// The streamed form's layout of the same packing (MafShape): per layer a
// head (W1 and b1, every hidden product's bias, b3) copied to a buffer of
// its own (HEAD floats, two: this layer's and the next), then items
// through two slots of SLOT floats: each hidden product's fragments by
// chunks of n-tiles (product j's chunk c: n-tiles wstart(j, c) ..
// wend(j, wstart(j, c)) - 1, at most kMafChunkFrags fragments unless one
// n-tile has more), then W3's by chunks of two dims (chunk q: dims 2q and
// 2q + 1, from chunk_start(q) floats past W3). A warp's buffer: its tile's
// coordinates in and out ([16][D] each; dims reversed as they are written
// out) and two dims' spline parameters ([16][PROW]).
constexpr int kMafChunkFrags = 64;

template <int D, class HID, int K>
struct MafStream : MafShape<D, HID, K> {
  using S = MafShape<D, HID, K>;
  __host__ __device__ static constexpr int wend(int p, int j) {
    int f = 0, e = j;
    while (e < S::KS(p + 1) &&
           (e == j || f + S::ksh(p, e) <= kMafChunkFrags)) {
      f += S::ksh(p, e);
      ++e;
    }
    return e;
  }
  __host__ __device__ static constexpr int wstart(int p, int c) {
    int j = 0;
    for (int i = 0; i < c; ++i) j = wend(p, j);
    return j;
  }
  __host__ __device__ static constexpr int wchunks(int p) {
    int c = 0;
    for (int j = 0; j < S::KS(p + 1); j = wend(p, j)) ++c;
    return c;
  }
  // Items of the hidden products before product p's first.
  __host__ __device__ static constexpr int item_base(int p) {
    int c = 0;
    for (int q = 0; q < p; ++q) c += wchunks(q);
    return c;
  }
  static constexpr int NW = item_base(S::NH > 1 ? S::NH - 1 : 0);
  // The hidden product of item i < NW.
  __host__ __device__ static constexpr int product_of(int i) {
    int p = 0;
    while (i >= item_base(p + 1)) ++p;
    return p;
  }
  static constexpr int NQ = (D + 1) / 2;
  __host__ __device__ static constexpr int chunk_start(int q) {
    return 64 * S::f3_before(2 * q < D ? 2 * q : D);
  }
  // Item i of a layer: its offset in the layer and its floats.
  __host__ __device__ static constexpr int item_offset(int i) {
    for (int p = 0; p + 1 < S::NH; ++p) {
      if (i < item_base(p + 1)) {
        return S::WH(p) + 64 * S::fh_before(p, wstart(p, i - item_base(p)));
      }
    }
    return S::W3 + chunk_start(i - NW);
  }
  __host__ __device__ static constexpr int item_floats(int i) {
    for (int p = 0; p + 1 < S::NH; ++p) {
      if (i < item_base(p + 1)) {
        const int j = wstart(p, i - item_base(p));
        return 64 * (S::fh_before(p, wend(p, j)) - S::fh_before(p, j));
      }
    }
    return chunk_start(i - NW + 1) - chunk_start(i - NW);
  }
  __host__ __device__ static constexpr int max_chunk() {
    int m = 0;
    for (int i = 0; i < NW + NQ; ++i) {
      m = item_floats(i) > m ? item_floats(i) : m;
    }
    return m;
  }
  static constexpr int SLOT = round4(max_chunk());
  // The head: W1 and b1 (as packed, up to the first streamed section),
  // then each hidden product's bias, then b3.
  static constexpr int FIRST = S::NH >= 2 ? S::W2 : S::W3;
  __host__ __device__ static constexpr int hbh(int p) {
    int o = FIRST;
    for (int q = 0; q < p; ++q) o += S::HW(q + 1);
    return o;
  }
  static constexpr int HB2 = FIRST;  // b2's place in the head
  static constexpr int HB3 = hbh(S::NH > 1 ? S::NH - 1 : 0);
  static constexpr int HEAD = round4(HB3 + D * S::G);
  static constexpr int PROW = 2 * S::G + 4;
  static constexpr int XS = round4(kMafTile * D);
  static constexpr int WSTAGE = 2 * XS + kMafTile * PROW;
  static constexpr int BUFS = 2 * SLOT + 2 * HEAD;
};

// 16 bytes from global to shared memory, asynchronously (cp.async, L2
// only: every block reads the same weights), as coupling_mma.cuh's.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Wait for every cp.async this thread started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's threads start copying `floats` (a multiple of 4) into dst.
__device__ __forceinline__ void copy_async(float* dst,
                                           const float* __restrict__ src,
                                           int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * blockDim.x) {
    cp_async16(dst + i, src + i);
  }
}

// The block starts copying layer w's head (W1, b1, each hidden product's
// bias, b3) into head.
template <class T>
__device__ __forceinline__ void copy_head(float* head,
                                          const float* __restrict__ w) {
  copy_async(head, w, T::FIRST);
  static_for<(T::NH > 1 ? T::NH - 1 : 0)>([&](auto p_) {
    constexpr int p = decltype(p_)::value;
    copy_async(head + T::hbh(p), w + T::BH(p), T::HW(p + 1));
  });
  copy_async(head + T::HB3, w + T::B3, T::HEAD - T::HB3);
}

// Hidden product P's chunk C (its n-tiles' fragments at w2) into acc:
// for P = 0 the first layer's k-steps recomputed from the head's W1 and b1
// and the tile's inputs (xa, xb: rows g and g + 8) for the k-steps the
// chunk's n-tiles read; else A from the last hidden layer (prev).
template <class T, int P, int C, class Frag, int N>
__device__ __forceinline__ void maf_product_chunk(
    const float* __restrict__ w2, const Frag& frag, float (&acc)[N][4],
    int lane) {
  constexpr int J0 = T::wstart(P, C), J1 = T::wend(P, J0);
  // Degrees are sorted, so the chunk's last n-tile reads the most k-steps.
  static_for<T::ksh(P, J1 - 1)>([&](auto s_) {
    constexpr int s = decltype(s_)::value;
    uint32_t hh[4], hl[4];
    frag(s, hh, hl);
    static_for<J1 - J0>([&](auto j_) {
      constexpr int j = J0 + decltype(j_)::value;
      if constexpr (s < T::ksh(P, j)) {
        constexpr int off =
            64 * (T::fh_before(P, j) - T::fh_before(P, J0) + s);
        mma_split(acc[j], hh, hl,
                  *reinterpret_cast<const float2*>(w2 + off + 2 * lane));
      }
    });
  });
}

// The spline parameters of dims 2Q and 2Q + 1 of the warp's tile, A of
// k-step s from frag (the last hidden layer, or the inputs), chunk Q's W3
// fragments at w3 and the layer's b3, to raw[row * PROW + (i - 2Q) * G +
// p]: maf_made's products for those dims, in its order (dim 0's
// parameters are its bias).
template <class T, int Q, class Frag>
__device__ __forceinline__ void maf_chunk_params(
    const float* __restrict__ w3, const float* __restrict__ b3,
    const Frag& frag, float* __restrict__ raw, int lane) {
  constexpr int D = T::DIMS;
  const int g = lane >> 2, t = lane & 3;
  static_for<2>([&](auto e_) {
    constexpr int i = 2 * Q + decltype(e_)::value;
    if constexpr (i < D) {
      float out[T::NT][4];
#pragma unroll
      for (int m = 0; m < T::NT; ++m) {
        out[m][0] = out[m][1] = out[m][2] = out[m][3] = 0.f;
      }
      static_for<T::ks3(i)>([&](auto s_) {
        constexpr int s = decltype(s_)::value;
        uint32_t ah[4], al[4];
        frag(s, ah, al);
        static_for<T::NT>([&](auto m_) {
          constexpr int m = decltype(m_)::value;
          constexpr int off =
              64 * (T::f3_before(i) - T::f3_before(2 * Q) + s * T::NT + m);
          mma_split(out[m], ah, al,
                    *reinterpret_cast<const float2*>(w3 + off + 2 * lane));
        });
      });
      float* r = raw + (i - 2 * Q) * T::G;
#pragma unroll
      for (int m = 0; m < T::NT; ++m) {
        const int q = 8 * m + 2 * t;
        const float2 bias =
            *reinterpret_cast<const float2*>(b3 + i * T::G + q);
        *reinterpret_cast<float2*>(r + g * T::PROW + q) =
            make_float2(out[m][0] + bias.x, out[m][1] + bias.y);
        *reinterpret_cast<float2*>(r + (g + 8) * T::PROW + q) =
            make_float2(out[m][2] + bias.x, out[m][3] + bias.y);
      }
    }
  });
}

// The largest hidden width in n-tiles (the streamed form's accumulator
// arrays, one per hidden layer, each used up to its own width).
template <class T>
__host__ __device__ constexpr int max_ks() {
  int m = 1;
  for (int i = 0; i < T::NH; ++i) m = T::KS(i) > m ? T::KS(i) : m;
  return m;
}

// The streamed form: a block of up to 16 warps takes a group of 16-particle
// tiles, one a warp (a tile past n computes on zeros and stores nothing),
// and runs them through the layers together, every layer's items streamed
// through the two slots (MafStream), one barrier an item; the blocks walk
// over the groups. With one hidden layer h_0 is computed whole (from the
// head's W1, b1) at the layer's first W3 item.
template <int D, class HID, int K>
__global__ void __launch_bounds__(32 * kMafMaxWarps, 1)
    maf_kernel_streamed(const float* __restrict__ x, float* __restrict__ z,
                        float* __restrict__ log_det,
                        const float* __restrict__ weights, int n,
                        int n_layers, float tail_bound) {
  using S = MafStream<D, HID, K>;
  constexpr int IPL = S::NW + S::NQ;  // ring items a layer
  constexpr int MD = S::MD;
  constexpr int NH = S::NH;
  extern __shared__ float4 maf_smem4[];
  float* slots = reinterpret_cast<float*>(maf_smem4);
  float* heads = slots + 2 * S::SLOT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* const stage = heads + 2 * S::HEAD + warp * S::WSTAGE;
  float* raw = stage + 2 * S::XS;
  const int tiles = (n + kMafTile - 1) / kMafTile;
  for (int first = blockIdx.x * warps; first < tiles;
       first += gridDim.x * warps) {
    const int base = (first + warp) * kMafTile;
    float* in = stage;
    float* out = stage + S::XS;
    for (int e = lane; e < kMafTile * D; e += 32) {
      in[e] = base + e / D < n ? x[(size_t)base * D + e] : 0.f;
    }
    float ld = 0.f;
    __syncthreads();  // every warp is done with the slots' last reads
    copy_head<S>(heads, weights);
    copy_async(slots, weights + S::item_offset(0), S::item_floats(0));
#pragma unroll 1
    for (int layer = 0; layer < n_layers; ++layer) {
      const float* wl = weights + (size_t)layer * S::SIZE;
      const float* head = heads + (layer & 1) * S::HEAD;
      const int parity = (layer * IPL) & 1;  // item 0's slot
      float xa[MD], xb[MD];
      // Hidden layer i's accumulators (i >= 1; i = 0 with one hidden
      // layer), each used up to its own width of n-tiles.
      float acc[NH > 0 ? NH : 1][max_ks<S>()][4];
      static_for<(NH > 1 ? NH - 1 : 0)>([&](auto p_) {
        constexpr int p = decltype(p_)::value + 1;
#pragma unroll
        for (int j = 0; j < S::KS(p); ++j) {
          acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
        }
      });
      // Item i of the layer has landed once its thread's copies have and
      // every thread passed the barrier; the barrier also says every warp
      // is done with the slot the next item overwrites (item i - 1's), and
      // at the last item with the head buffer the next layer's takes.
      static_for<IPL>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        cp_async_wait_all();
        __syncthreads();
        float* next = slots + ((parity + i + 1) & 1) * S::SLOT;
        if constexpr (i + 1 < IPL) {
          copy_async(next, wl + S::item_offset(i + 1), S::item_floats(i + 1));
        } else {
          if (layer + 1 < n_layers) {
            copy_head<S>(heads + ((layer + 1) & 1) * S::HEAD, wl + S::SIZE);
            copy_async(next, wl + S::SIZE + S::item_offset(0),
                       S::item_floats(0));
          }
        }
        const float* item = slots + ((parity + i) & 1) * S::SLOT;
        if constexpr (i == 0 && NH > 0) {
#pragma unroll
          for (int k = 0; k < MD; ++k) {
            xa[k] = in[g * D + k];
            xb[k] = in[(g + 8) * D + k];
          }
        }
        if constexpr (i < S::NW) {
          // Hidden product p's chunk c.
          constexpr int p = S::product_of(i);
          constexpr int c = i - S::item_base(p);
          if constexpr (p == 0) {
            maf_product_chunk<S, 0, c>(
                item, MafFirstFragment<S>{head, xa, xb, t}, acc[1], lane);
          } else {
            maf_product_chunk<S, p, c>(
                item, MafAccFragment<max_ks<S>()>{acc[p]}, acc[p + 1], lane);
          }
          if constexpr (c + 1 == S::wchunks(p)) {
            // h = relu(acc + b), kept as the accumulator fragments.
            maf_bias_relu<S::KS(p + 1)>(head + S::hbh(p), acc[p + 1], t);
          }
        } else {
          constexpr int q = i - S::NW;
          if constexpr (NH == 1 && q == 0) {
            // h_0 whole, in the accumulators' order.
#pragma unroll
            for (int s = 0; s < S::KS(0); ++s) {
              float h[4];
              maf_first_values<S>(head, xa, xb, s, t, h);
              acc[0][s][0] = h[0];
              acc[0][s][1] = h[2];
              acc[0][s][2] = h[1];
              acc[0][s][3] = h[3];
            }
          }
          if constexpr (NH == 0) {
            maf_chunk_params<S, q>(item, head + S::HB3,
                                   MafInputFragment<D>{in, g, t}, raw, lane);
          } else {
            maf_chunk_params<S, q>(item, head + S::HB3,
                                   MafAccFragment<max_ks<S>()>{acc[NH - 1]},
                                   raw, lane);
          }
          __syncwarp();
          const int r = lane & (kMafTile - 1), dim = 2 * q + (lane >> 4);
          if (dim < D) {
            const float4* src = reinterpret_cast<const float4*>(
                raw + r * S::PROW + (lane >> 4) * S::G);
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
            rqs<K, true>(in[r * D + dim], par, tail_bound, y, e);
            out[r * D + (D - 1 - dim)] = y;
            ld += e;
          }
          __syncwarp();
        }
      });
      float* done = in;
      in = out;
      out = done;
    }
    // A particle's dims are split over lanes r and r + 16.
    ld += __shfl_xor_sync(0xffffffffu, ld, 16);
    if (lane < kMafTile && base + lane < n) log_det[base + lane] = ld;
    for (int e = lane; e < kMafTile * D; e += 32) {
      if (base + e / D < n) z[(size_t)base * D + e] = in[e];
    }
    __syncwarp();
  }
}

// The chunked form (maf_kernel_chunked), for a flow whose streamed form
// leaves no warp beside its slots and heads: the streamed form's items, but
// each pair of dims' W3 fragments in chunks of KC3 k-steps (item (q, c):
// dim 2q's fragments of k-steps c KC3 .. (c + 1) KC3 - 1, then dim
// 2q + 1's, each as far as the dim reads), the pair's parameters summed
// over its chunks in the k order of the other forms (so their bits); at
// LEVEL 2, where that leaves no warp either, W1 streams too, by KW1
// k-steps of units at the layer's first items, h_0 made whole from them,
// and the head keeps the biases alone (b1, each hidden product's, b3). The
// level is the first whose block holds a warp
// (ops/fused_coupling.py::maf_stream_layout mirrors it).
constexpr int kMafBlockFloats = 232448 / 4;  // an H100 block's most
constexpr int kMafW1Floats = 4096;           // a W1 item's floats at most

template <int D, class HID, int K>
struct MafChunked : MafStream<D, HID, K> {
  using T = MafStream<D, HID, K>;
  static constexpr int KC3 =
      kMafChunkFrags / (2 * T::NT) > 1 ? kMafChunkFrags / (2 * T::NT) : 1;
  // k-steps of dim i in W3 chunk c (0 past D).
  __host__ __device__ static constexpr int cnt(int i, int c) {
    if (i >= D) return 0;
    const int e = T::ks3(i) - c * KC3;
    return e <= 0 ? 0 : (e < KC3 ? e : KC3);
  }
  // Chunks of pair q (one at least), the W3 items before pair q's first,
  // and the pair of W3 item j.
  __host__ __device__ static constexpr int nc3(int q) {
    const int hi = T::ks3(2 * q + 1 < D ? 2 * q + 1 : 2 * q);
    return hi > KC3 ? (hi + KC3 - 1) / KC3 : 1;
  }
  __host__ __device__ static constexpr int c3_before(int q) {
    int c = 0;
    for (int p = 0; p < q; ++p) c += nc3(p);
    return c;
  }
  __host__ __device__ static constexpr int pair_of(int j) {
    int q = 0;
    while (j >= c3_before(q + 1)) ++q;
    return q;
  }
  static constexpr int N3 = c3_before(T::NQ);
  static constexpr int KW1 =
      T::NH && kMafW1Floats / (8 * D) > 1 ? kMafW1Floats / (8 * D) : 1;
  static constexpr int NW1 = T::NH ? (T::KS(0) + KW1 - 1) / KW1 : 0;
  __host__ __device__ static constexpr int items_max() {
    int m = 0;
    for (int i = 0; i < T::NW; ++i) {
      m = T::item_floats(i) > m ? T::item_floats(i) : m;
    }
    for (int q = 0; q < T::NQ; ++q) {
      for (int c = 0; c < nc3(q); ++c) {
        const int f = 64 * T::NT * (cnt(2 * q, c) + cnt(2 * q + 1, c));
        m = f > m ? f : m;
      }
    }
    return m;
  }
  __host__ __device__ static constexpr int slot(int level) {
    const int w1 = level == 2 ? 8 * D * (KW1 < T::KS(0) ? KW1 : T::KS(0)) : 0;
    return round4(items_max() > w1 ? items_max() : w1);
  }
  __host__ __device__ static constexpr int head(int level) {
    int biases = D * T::G;
    for (int p = 0; p < T::NH; ++p) biases += T::HW(p);
    return level == 2 ? round4(biases) : T::HEAD;
  }
  __host__ __device__ static constexpr bool fits(int level) {
    return 2 * slot(level) + 2 * head(level) + T::WSTAGE <= kMafBlockFloats;
  }
  static constexpr int LEVEL = fits(1) ? 1 : 2;
  static constexpr int SLOT = slot(LEVEL);
  static constexpr int HEAD = head(LEVEL);
  static constexpr int BUFS = 2 * SLOT + 2 * HEAD;
  static constexpr int NI1 = LEVEL == 2 ? NW1 : 0;  // W1 items a layer
  static constexpr int IPL = NI1 + T::NW + N3;      // items a layer
  // The head's sections: b1 (HB1), each hidden product's bias, b3 (HB3).
  static constexpr int HB1 = LEVEL == 2 ? 0 : T::B1;
  __host__ __device__ static constexpr int hbh(int p) {
    return LEVEL == 2 ? T::HW(0) + (T::hbh(p) - T::FIRST) : T::hbh(p);
  }
  static constexpr int HB3 = hbh(T::NH > 1 ? T::NH - 1 : 0);
};

// The streamed instance's form: 0 the streamed form (maf_kernel_streamed)
// where its block holds a warp, else the chunked form's level.
template <int D, class HID, int K>
__host__ __device__ constexpr int maf_stream_level() {
  using T = MafStream<D, HID, K>;
  return T::BUFS + T::WSTAGE <= kMafBlockFloats ? 0
                                                : MafChunked<D, HID, K>::LEVEL;
}

// The block starts copying the chunked form's layer head (b1, each hidden
// product's bias, b3; at level 1 the streamed form's head) into head.
template <class U>
__device__ __forceinline__ void copy_chunked_head(float* head,
                                                  const float* __restrict__ w) {
  if constexpr (U::LEVEL == 2) {
    copy_async(head, w + U::B1, U::HW(0));
    static_for<(U::NH > 1 ? U::NH - 1 : 0)>([&](auto p_) {
      constexpr int p = decltype(p_)::value;
      copy_async(head + U::hbh(p), w + U::BH(p), U::HW(p + 1));
    });
    copy_async(head + U::HB3, w + U::B3, U::HEAD - U::HB3);
  } else {
    copy_head<typename U::T>(head, w);
  }
}

// The block starts copying item I of the chunked form's layer w into dst:
// W1's rows of k-steps I KW1 .. (I + 1) KW1 - 1, a hidden product's chunk,
// or a W3 chunk (its two dims' runs of fragments one after the other).
template <class U, int I>
__device__ __forceinline__ void copy_chunked_item(
    float* dst, const float* __restrict__ w) {
  constexpr int D = U::DIMS;
  if constexpr (I < U::NI1) {
    constexpr int s0 = I * U::KW1;
    constexpr int s1 = s0 + U::KW1 < U::KS(0) ? s0 + U::KW1 : U::KS(0);
    copy_async(dst, w + U::W1 + 8 * s0 * D, 8 * (s1 - s0) * D);
  } else if constexpr (I < U::NI1 + U::NW) {
    copy_async(dst, w + U::item_offset(I - U::NI1),
               U::item_floats(I - U::NI1));
  } else {
    constexpr int j = I - U::NI1 - U::NW;
    constexpr int q = U::pair_of(j), c = j - U::c3_before(q);
    constexpr int a = U::cnt(2 * q, c), b = U::cnt(2 * q + 1, c);
    copy_async(dst, w + U::W3 + 64 * (U::f3_before(2 * q) + c * U::KC3 * U::NT),
               64 * U::NT * a);
    if constexpr (b > 0) {
      copy_async(dst + 64 * U::NT * a,
                 w + U::W3 +
                     64 * (U::f3_before(2 * q + 1) + c * U::KC3 * U::NT),
                 64 * U::NT * b);
    }
  }
}

// maf_first_values with W1's rows of k-steps s0 on at w1 (a W1 item) and
// b1 at b1: units 8s + 2t and 8s + 2t + 1 of rows g and g + 8.
template <class S>
__device__ __forceinline__ void maf_first_rows(
    const float* __restrict__ w1, int s0, const float* __restrict__ b1,
    const float (&xa)[S::MD], const float (&xb)[S::MD], int s, int t,
    float (&h)[4]) {
  constexpr int MD = S::MD;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int u = 8 * s + 2 * t + c;
    int deg = 1;
    static_for<MD - 1>([&](auto d_) {
      constexpr int e = S::ends(S::H1, decltype(d_)::value + 1);
      deg += u >= e ? 1 : 0;
    });
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < MD; ++i) {
      if (i < deg) {
        const float wi = w1[(u - 8 * s0) * S::DIMS + i];
        a = fmaf(wi, xa[i], a);
        b = fmaf(wi, xb[i], b);
      }
    }
    const float bias = b1[u];
    h[2 * c] = fmaxf(a + bias, 0.f);
    h[2 * c + 1] = fmaxf(b + bias, 0.f);
  }
}

// W3 chunk C of pair Q (its two dims' runs at w3) into the pair's sums o3,
// A of k-step s from frag, k-step outer: the products of maf_chunk_params
// for those k-steps, in its order for each sum.
template <class U, int Q, int C, class Frag>
__device__ __forceinline__ void maf_chunk_products(
    const float* __restrict__ w3, const Frag& frag,
    float (&o3)[2][U::NT][4], int lane) {
  static_for<(U::cnt(2 * Q, C) > U::cnt(2 * Q + 1, C)
                   ? U::cnt(2 * Q, C)
                   : U::cnt(2 * Q + 1, C))>([&](auto s_) {
    constexpr int sl = decltype(s_)::value;
    uint32_t ah[4], al[4];
    frag(C * U::KC3 + sl, ah, al);
    static_for<2>([&](auto e_) {
      constexpr int e = decltype(e_)::value;
      if constexpr (sl < U::cnt(2 * Q + e, C)) {
        constexpr int base = 64 * U::NT * (e ? U::cnt(2 * Q, C) : 0);
        static_for<U::NT>([&](auto m_) {
          constexpr int m = decltype(m_)::value;
          mma_split(o3[e][m], ah, al,
                    *reinterpret_cast<const float2*>(
                        w3 + base + 64 * (sl * U::NT + m) + 2 * lane));
        });
      }
    });
  });
}

// The chunked form: maf_kernel_streamed's walk over the tiles and layers,
// with MafChunked's items; a pair of dims' parameters are summed over its
// W3 chunks, then its splines run as the streamed form's do.
template <int D, class HID, int K>
__global__ void __launch_bounds__(32 * kMafMaxWarps, 1)
    maf_kernel_chunked(const float* __restrict__ x, float* __restrict__ z,
                       float* __restrict__ log_det,
                       const float* __restrict__ weights, int n,
                       int n_layers, float tail_bound) {
  using U = MafChunked<D, HID, K>;
  constexpr int IPL = U::IPL;
  constexpr int MD = U::MD;
  constexpr int NH = U::NH;
  extern __shared__ float4 maf_smem4[];
  float* slots = reinterpret_cast<float*>(maf_smem4);
  float* heads = slots + 2 * U::SLOT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* const stage = heads + 2 * U::HEAD + warp * U::WSTAGE;
  float* raw = stage + 2 * U::XS;
  const int tiles = (n + kMafTile - 1) / kMafTile;
  for (int first = blockIdx.x * warps; first < tiles;
       first += gridDim.x * warps) {
    const int base = (first + warp) * kMafTile;
    float* in = stage;
    float* out = stage + U::XS;
    for (int e = lane; e < kMafTile * D; e += 32) {
      in[e] = base + e / D < n ? x[(size_t)base * D + e] : 0.f;
    }
    float ld = 0.f;
    __syncthreads();  // every warp is done with the slots' last reads
    copy_chunked_head<U>(heads, weights);
    copy_chunked_item<U, 0>(slots, weights);
#pragma unroll 1
    for (int layer = 0; layer < n_layers; ++layer) {
      const float* wl = weights + (size_t)layer * U::SIZE;
      const float* head = heads + (layer & 1) * U::HEAD;
      const int parity = (layer * IPL) & 1;  // item 0's slot
      float xa[MD], xb[MD];
      // Hidden layer i's accumulators (h_0 too where it is made whole),
      // each used up to its own width of n-tiles; the pair's sums.
      float acc[NH > 0 ? NH : 1][max_ks<U>()][4];
      float o3[2][U::NT][4];
      static_for<(NH > 1 ? NH - 1 : 0)>([&](auto p_) {
        constexpr int p = decltype(p_)::value + 1;
#pragma unroll
        for (int j = 0; j < U::KS(p); ++j) {
          acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
        }
      });
      // As the streamed form's: item i has landed once its thread's copies
      // have and every thread passed the barrier, which also says every
      // warp is done with the slot the next item overwrites and, at the
      // last item, with the head buffer the next layer's takes.
      static_for<IPL>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        cp_async_wait_all();
        __syncthreads();
        float* next = slots + ((parity + i + 1) & 1) * U::SLOT;
        if constexpr (i + 1 < IPL) {
          copy_chunked_item<U, i + 1>(next, wl);
        } else {
          if (layer + 1 < n_layers) {
            copy_chunked_head<U>(heads + ((layer + 1) & 1) * U::HEAD,
                                 wl + U::SIZE);
            copy_chunked_item<U, 0>(next, wl + U::SIZE);
          }
        }
        const float* item = slots + ((parity + i) & 1) * U::SLOT;
        if constexpr (i == 0 && NH > 0) {
#pragma unroll
          for (int k = 0; k < MD; ++k) {
            xa[k] = in[g * D + k];
            xb[k] = in[(g + 8) * D + k];
          }
        }
        if constexpr (i < U::NI1) {
          // h_0's k-steps of this W1 item, whole, in the accumulators'
          // order.
          constexpr int s0 = i * U::KW1;
          constexpr int s1 = s0 + U::KW1 < U::KS(0) ? s0 + U::KW1 : U::KS(0);
          static_for<s1 - s0>([&](auto s_) {
            constexpr int s = s0 + decltype(s_)::value;
            float h[4];
            maf_first_rows<U>(item, s0, head + U::HB1, xa, xb, s, t, h);
            acc[0][s][0] = h[0];
            acc[0][s][1] = h[2];
            acc[0][s][2] = h[1];
            acc[0][s][3] = h[3];
          });
        } else if constexpr (i < U::NI1 + U::NW) {
          // Hidden product p's chunk c.
          constexpr int w = i - U::NI1;
          constexpr int p = U::product_of(w);
          constexpr int c = w - U::item_base(p);
          if constexpr (p == 0 && U::LEVEL == 1) {
            maf_product_chunk<U, 0, c>(
                item, MafFirstFragment<U>{head, xa, xb, t}, acc[1], lane);
          } else {
            maf_product_chunk<U, p, c>(
                item, MafAccFragment<max_ks<U>()>{acc[p]}, acc[p + 1], lane);
          }
          if constexpr (c + 1 == U::wchunks(p)) {
            // h = relu(acc + b), kept as the accumulator fragments.
            maf_bias_relu<U::KS(p + 1)>(head + U::hbh(p), acc[p + 1], t);
          }
        } else {
          constexpr int j = i - U::NI1 - U::NW;
          constexpr int q = U::pair_of(j), c = j - U::c3_before(q);
          if constexpr (NH == 1 && U::LEVEL == 1 && j == 0) {
            // h_0 whole, in the accumulators' order.
#pragma unroll
            for (int s = 0; s < U::KS(0); ++s) {
              float h[4];
              maf_first_values<U>(head, xa, xb, s, t, h);
              acc[0][s][0] = h[0];
              acc[0][s][1] = h[2];
              acc[0][s][2] = h[1];
              acc[0][s][3] = h[3];
            }
          }
          if constexpr (c == 0) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int m = 0; m < U::NT; ++m) {
                o3[e][m][0] = o3[e][m][1] = o3[e][m][2] = o3[e][m][3] = 0.f;
              }
            }
          }
          if constexpr (NH == 0) {
            maf_chunk_products<U, q, c>(item, MafInputFragment<D>{in, g, t},
                                        o3, lane);
          } else {
            maf_chunk_products<U, q, c>(
                item, MafAccFragment<max_ks<U>()>{acc[NH - 1]}, o3, lane);
          }
          if constexpr (c + 1 == U::nc3(q)) {
            // The pair's parameters plus b3 to raw, then its splines.
            static_for<2>([&](auto e_) {
              constexpr int e = decltype(e_)::value;
              constexpr int dim = 2 * q + e;
              if constexpr (dim < D) {
                float* r = raw + e * U::G;
#pragma unroll
                for (int m = 0; m < U::NT; ++m) {
                  const int col = 8 * m + 2 * t;
                  const float2 bias = *reinterpret_cast<const float2*>(
                      head + U::HB3 + dim * U::G + col);
                  *reinterpret_cast<float2*>(r + g * U::PROW + col) =
                      make_float2(o3[e][m][0] + bias.x, o3[e][m][1] + bias.y);
                  *reinterpret_cast<float2*>(r + (g + 8) * U::PROW + col) =
                      make_float2(o3[e][m][2] + bias.x, o3[e][m][3] + bias.y);
                }
              }
            });
            __syncwarp();
            const int r = lane & (kMafTile - 1), dim = 2 * q + (lane >> 4);
            if (dim < D) {
              const float4* src = reinterpret_cast<const float4*>(
                  raw + r * U::PROW + (lane >> 4) * U::G);
              float par[U::P];
#pragma unroll
              for (int c4 = 0; c4 < U::G / 4; ++c4) {
                const float4 v = src[c4];
                if (4 * c4 + 0 < U::P) par[4 * c4 + 0] = v.x;
                if (4 * c4 + 1 < U::P) par[4 * c4 + 1] = v.y;
                if (4 * c4 + 2 < U::P) par[4 * c4 + 2] = v.z;
                if (4 * c4 + 3 < U::P) par[4 * c4 + 3] = v.w;
              }
              float y, e;
              rqs<K, true>(in[r * D + dim], par, tail_bound, y, e);
              out[r * D + (D - 1 - dim)] = y;
              ld += e;
            }
            __syncwarp();
          }
        }
      });
      float* done = in;
      in = out;
      out = done;
    }
    // A particle's dims are split over lanes r and r + 16.
    ld += __shfl_xor_sync(0xffffffffu, ld, 16);
    if (lane < kMafTile && base + lane < n) log_det[base + lane] = ld;
    for (int e = lane; e < kMafTile * D; e += 32) {
      if (base + e / D < n) z[(size_t)base * D + e] = in[e];
    }
    __syncwarp();
  }
}
#endif

template <int D, class HID, int K>
int launch_maf(const float* x, float* z, float* ld, const float* w, int n,
               int n_layers, float tb, cudaStream_t stream) {
  using S = MafShape<D, HID, K>;
  if (n <= 0) return 0;
  const DeviceLimits limits = current_device_limits();
  const int sms = limits.sms, max_smem = limits.max_smem;
  const long long weight_bytes = 4LL * n_layers * S::SIZE;
  const long long stage_bytes = 4LL * S::STAGE;
#ifdef ASPIRE_STREAMED
  // The streamed instance, for a flow whose layers do not fit resident: the
  // streamed form, or the chunked one where its block holds no warp.
  {
    constexpr bool chunked = maf_stream_level<D, HID, K>() > 0;
    using T = std::conditional_t<chunked, MafChunked<D, HID, K>,
                                 MafStream<D, HID, K>>;
    long long fit = (max_smem - 4LL * T::BUFS) / (4LL * T::WSTAGE);
    const int warps = (int)(fit > kMafMaxWarps ? kMafMaxWarps : fit);
    if (warps < 1) return (int)cudaErrorInvalidConfiguration;
    const int smem = 4 * (T::BUFS + warps * T::WSTAGE);
    void (*kernel)(const float*, float*, float*, const float*, int, int,
                   float);
    if constexpr (chunked) {
      kernel = maf_kernel_chunked<D, HID, K>;
    } else {
      kernel = maf_kernel_streamed<D, HID, K>;
    }
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int groups = ((n + kMafTile - 1) / kMafTile + warps - 1) / warps;
    kernel<<<groups < sms ? groups : sms, 32 * warps, smem, stream>>>(
        x, z, ld, w, n, n_layers, tb);
    return (int)cudaGetLastError();
  }
#else
  long long warps = (max_smem - weight_bytes) / stage_bytes;
  if (warps > kMafMaxWarps) warps = kMafMaxWarps;
  if (warps < 1) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)(weight_bytes + warps * stage_bytes);
  auto kernel = maf_kernel<D, HID, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kMafTile - 1) / kMafTile;
  const int blocks = tiles < sms ? tiles : sms;
  kernel<<<blocks, (int)(32 * warps), smem, stream>>>(x, z, ld, w, n,
                                                     n_layers, tb);
  return (int)cudaGetLastError();
#endif
}

// The k-step table of aspire_maf_ksteps.
template <class B>
int maf_ksteps_table(int* out, int capacity) {
  int count = 0;
  for (int p = 0; p + 1 < B::NH; ++p) {
    for (int j = 0; j < B::KS(p + 1); ++j, ++count) {
      if (count < capacity) out[count] = B::ksh(p, j);
    }
  }
  for (int i = 0; i < B::DIMS; ++i, ++count) {
    if (count < capacity) out[count] = B::ks3(i);
  }
  return count;
}

}  // namespace aspire

extern "C" {

// Floats per layer of the packed MAF weight buffer for a configuration id.
int aspire_maf_layer_floats(int config) {
#define ASPIRE_MAF_SIZE_CASE(ID, D, HID, K) \
  if (config == ID) return aspire::MafShape<D, ASPIRE_HIDDEN HID, K>::SIZE;
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_SIZE_CASE)
#undef ASPIRE_MAF_SIZE_CASE
  return -1;
}

// Floats of one warp's shared buffer for a configuration id.
int aspire_maf_stage_floats(int config) {
#define ASPIRE_MAF_STAGE_CASE(ID, D, HID, K) \
  if (config == ID) return aspire::MafShape<D, ASPIRE_HIDDEN HID, K>::STAGE;
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_STAGE_CASE)
#undef ASPIRE_MAF_STAGE_CASE
  return -1;
}

// The k-steps the kernel multiplies, as MafBlocks computes them: ksh(p, j)
// of each hidden product p's n-tiles j < H_{p+1} / 8 (W2's for p = 0), then
// ks3(i) of the dims i < D, into out (up to capacity entries). Returns
// their number, or -1 for an unknown configuration.
int aspire_maf_ksteps(int config, int* out, int capacity) {
#define ASPIRE_MAF_KSTEPS_CASE(ID, D, HID, K)                             \
  if (config == ID) {                                                    \
    return aspire::maf_ksteps_table<                                     \
        aspire::MafBlocks<D, ASPIRE_HIDDEN HID, K>>(out, capacity);      \
  }
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_KSTEPS_CASE)
#undef ASPIRE_MAF_KSTEPS_CASE
  return -1;
}

#ifdef ASPIRE_STREAMED
// The streamed instance's block for a configuration id: its form (0 the
// streamed form, 1 or 2 the chunked form's level), the floats of a slot,
// of a head, of a warp's buffer and of the slots and heads, into out (up
// to capacity entries). Returns their number, or -1 for an unknown
// configuration.
int aspire_maf_stream_layout(int config, int* out, int capacity) {
#define ASPIRE_MAF_STREAM_CASE(ID, D, HID, K)                              \
  if (config == ID) {                                                     \
    using H = ASPIRE_HIDDEN HID;                                          \
    constexpr int level = aspire::maf_stream_level<D, H, K>();            \
    using T = std::conditional_t<level != 0, aspire::MafChunked<D, H, K>, \
                                 aspire::MafStream<D, H, K>>;             \
    const int v[] = {level, T::SLOT, T::HEAD, T::WSTAGE, T::BUFS};        \
    for (int e = 0; e < 5 && e < capacity; ++e) out[e] = v[e];            \
    return 5;                                                             \
  }
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_STREAM_CASE)
#undef ASPIRE_MAF_STREAM_CASE
  return -1;
}
#endif

// x, z: (n, D) row-major; log_det: (n,). Data -> latent only.
// Returns the launch's cudaError_t, or -1 for an unknown configuration.
int aspire_maf(const float* x, float* z, float* log_det,
               const float* weights, int n, int n_layers, float tail_bound,
               int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ASPIRE_MAF_CASE(ID, D, HID, K)                                    \
  if (config == ID) {                                                    \
    return aspire::launch_maf<D, ASPIRE_HIDDEN HID, K>(                  \
        x, z, log_det, weights, n, n_layers, tail_bound, s);             \
  }
  ASPIRE_MAF_CONFIGS(ASPIRE_MAF_CASE)
#undef ASPIRE_MAF_CASE
  return -1;
}

}  // extern "C"
