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
// The function is the density mode of coupling.cu. The form is the
// prototypes': a block takes Q sub-tiles of S particles; a layer's
// conditioner is a product over a sub-tile held in shared memory, then the
// spline runs per particle and active dim, one thread per (active dim,
// particle) pair.
//
// - D1/D2 (staged_mma_kernel): sub-tile q is owned by its own group of 2S
//   threads, which synchronises only among itself (named barrier 1 + q).
//   The groups run their layers independently, so the warp schedulers
//   interleave one group's tensor-core products with another's spline
//   (SFU and branch work): the native form of the TPU's MXU/VPU overlap,
//   with no lock-step stagger.
// - D3 (PAIRED, paired_kernel): two sub-tiles one layer apart in lock
//   step. Per dense level one 128-row pass over the block (rows 0..63
//   sub-tile A with layer l's weights, rows 64..127 sub-tile B with layer
//   l-1's) computes both sub-tiles' outputs; the TPU's block-diagonal zero
//   blocks, a fill for its 128 x 128 matrix unit, are not stored.
//
// What bounds it on an H100: arithmetic. A 4-layer (64, 64) x 8-bin flow
// costs 57,344 FLOP per particle against 36 bytes of input and output, so
// device memory is idle. What the design does about it: every layer's
// weights stay in shared memory for the block's whole life (a persistent
// grid of one block per SM walks over the tiles), and
// - D1/D2 run the conditioner's two wide products, h1 . W2 and h2 . W3
//   (56,320 of those FLOP), on the tensor cores: each warp of a group owns
//   one 16-row tile of its sub-tile and runs the split-TF32 mma.sync
//   m16n8k8 pass of coupling_mma.cuh on it (each k-step's three products
//   summed from zero, the tensor core's cut undone on average, then added
//   in float32), h1 computed on FP32 FMAs straight into the A fragments
//   and h2 kept in the accumulators, from the packed weights of the
//   coupling kernel B1 (prepare_mma_params); only the transformer
//   parameters go through shared memory, to the spline threads. With no
//   hidden layer in shared memory, registers bound the sub-tile: a block
//   takes up to 512 threads (S = 128, 80, 64, 32 at Q = 2, 3, 4, 8), 128
//   registers each, 16 warps to hide the mma and spline latencies;
// - D3 stays on the FP32 pipe: each thread keeps a register tile of RO
//   outputs x 4 particles, so one float4 of activations and RO/2 or RO/4
//   vector loads of weights feed 4 * RO FMAs, and only the active half's
//   spline parameters are computed.

#include "coupling_mma.cuh"

namespace aspire {

// D3's per sub-tile shared buffers, each [rows][S]: the coordinates, both
// hidden layers, the spline parameters and the per-thread log-det sums.
template <int D, int H1, int H2, int K, int S>
struct StagedBuffers {
  using Sh = Shape<D, H1, H2, K, true>;
  static constexpr int X = 0;
  static constexpr int H1S = X + D * S;
  static constexpr int H2S = H1S + H1 * S;
  static constexpr int OUT = H2S + H2 * S;
  static constexpr int LD = OUT + Sh::OUTP * S;
  static constexpr int SIZE = LD + 2 * S;  // floats per sub-tile
};

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

template <int RO>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&w)[RO]) {
  if constexpr (RO % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RO; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + r);
      w[r] = v.x;
      w[r + 1] = v.y;
      w[r + 2] = v.z;
      w[r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RO; r += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + r);
      w[r] = v.x;
      w[r + 1] = v.y;
    }
  }
}

// One dense level over a sub-tile by its 2S threads:
// out[o][p] = act(sum_k W[k][o] in[k][p] + b[o]) for o < NOUT, p < S.
// W is input-major (NIN x NOUT); thread t owns outputs og*RO .. og*RO+RO-1
// of particles 4*pg .. 4*pg+3. MASKED skips the inputs the layer
// transforms (the conditioner sees only the conditioning half).
template <int NIN, int NOUT, int S, bool RELU, bool MASKED>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ b,
                                      const float* __restrict__ in,
                                      float* __restrict__ out, int t,
                                      int layer) {
  constexpr int PG = S / 4;
  constexpr int OG = 8;  // 2S threads over S/4 particle groups
  static_assert(S % 16 == 0, "sub-tiles are multiples of 16 particles");
  static_assert(NOUT % (2 * OG) == 0, "outputs per thread must be even");
  constexpr int RO = NOUT / OG;
  const int pg = t % PG, og = t / PG;
  const float* wcol = W + og * RO;
  float acc[RO][4];
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < NIN; ++k) {
    if (MASKED && is_active(k, layer)) continue;
    const float4 v = *reinterpret_cast<const float4*>(in + k * S + 4 * pg);
    float w[RO];
    load_row<RO>(wcol + k * NOUT, w);
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      acc[r][0] = fmaf(w[r], v.x, acc[r][0]);
      acc[r][1] = fmaf(w[r], v.y, acc[r][1]);
      acc[r][2] = fmaf(w[r], v.z, acc[r][2]);
      acc[r][3] = fmaf(w[r], v.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const float bias = b[og * RO + r];
    float4 o = make_float4(acc[r][0] + bias, acc[r][1] + bias,
                           acc[r][2] + bias, acc[r][3] + bias);
    if (RELU) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f);
      o.w = fmaxf(o.w, 0.f);
    }
    *reinterpret_cast<float4*>(out + (og * RO + r) * S + 4 * pg) = o;
  }
}

// benchmarks/dev/packed_ab.py::rqs_micro, density direction: the bin
// softmax without its max subtraction (exp(min(r, 60))) and the minimum
// width folded into the 2 * tail_bound scale. Not the same function as
// rqs<K, true> where every raw width or height of a row is below about
// -87 (exp leaves the normal float32 range) and, below about -104, exp
// underflows to 0 and the row normalises 0 / 0.
template <int K>
__device__ __forceinline__ void rqs_micro(float v,
                                          const float (&raw)[3 * K - 1],
                                          float tb, float& y, float& ld) {
  const float c0 = 2.f * tb * kMinBinWidth;
  const float c1 = 2.f * tb * (1.f - kMinBinWidth * K);
  float ew[K], eh[K], sw = 0.f, sh = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ew[j] = expf(fminf(raw[j], 60.f));
    eh[j] = expf(fminf(raw[K + j], 60.f));
    sw += ew[j];
    sh += eh[j];
  }
  const bool inside = (v > -tb) && (v < tb);
  const float safe = fminf(fmaxf(v, -tb), tb);
  float cx = 0.f, cy = 0.f;
  float x_k = 0.f, y_k = 0.f, w = 1.f, h = 1.f;
  int k = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ws = c0 + c1 * (ew[j] / sw);
    const float hs = c0 + c1 * (eh[j] / sh);
    cx += ws;
    cy += hs;
    const float x_lo = (cx - tb) - ws;
    const float y_lo = (cy - tb) - hs;
    if (j == 0 || safe >= y_lo) {
      k = j;
      x_k = x_lo;
      y_k = y_lo;
      w = ws;
      h = hs;
    }
  }
  float rl = 0.f, rr = 0.f;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    if (j == k - 1) rl = raw[2 * K + j];
    if (j == k) rr = raw[2 * K + j];
  }
  const float d_k = (k == 0) ? 1.f : kMinDerivative + softplus(rl);
  const float d_k1 = (k == K - 1) ? 1.f : kMinDerivative + softplus(rr);
  const float s = h / w;
  const float t = d_k1 + d_k - 2.f * s;
  const float y_rel = safe - y_k;
  const float a = h * (s - d_k) + y_rel * t;
  const float b = h * d_k - y_rel * t;
  const float c = -s * y_rel;
  const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
  const float xi = fminf(fmaxf((2.f * c) / (-b - sqrtf(disc)), 0.f), 1.f);
  const float xm = 1.f - xi;
  const float den = s + t * xi * xm;
  const float l = 2.f * logf(s) +
                  logf(d_k1 * xi * xi + 2.f * s * xi * xm + d_k * xm * xm) -
                  2.f * logf(den);
  y = inside ? xi * w + x_k : v;
  ld = inside ? -l : 0.f;
}

// The spline of every active dim of the sub-tile: thread t takes the
// (slot a, particle p) pairs j = t, t + 2S, ... with p = t % S, so all of a
// thread's pairs belong to one particle. Returns their log-det sum.
template <int D, int H1, int H2, int K, int S, bool MICRO>
__device__ __forceinline__ float spline_phase(const float* __restrict__ out,
                                              float* __restrict__ xs, int t,
                                              int layer, float tb) {
  using Sh = Shape<D, H1, H2, K, true>;
  float sum = 0.f;
  for (int j = t; j < Sh::A * S; j += 2 * S) {
    const int a = j / S, p = j % S;
    const int i = 2 * a + (layer & 1);  // the a-th active dim
    if (i >= D) continue;               // odd D: the dummy group
    float raw[Sh::P];
#pragma unroll
    for (int q = 0; q < Sh::P; ++q) raw[q] = out[(a * Sh::P + q) * S + p];
    float y, e;
    if constexpr (MICRO) {
      rqs_micro<K>(xs[i * S + p], raw, tb, y, e);
    } else {
      rqs<K, true>(xs[i * S + p], raw, tb, y, e);
    }
    xs[i * S + p] = y;
    sum += e;
  }
  return sum;
}

// All layers' packed weights (ops/fused_coupling.py::prepare_params) into
// shared memory, W1 and W2 transposed to input-major so a thread's RO
// consecutive outputs are one vector load.
template <int D, int H1, int H2, int K>
__device__ __forceinline__ void load_staged_weights(
    float* __restrict__ dst, const float* __restrict__ src, int n_layers) {
  using Sh = Shape<D, H1, H2, K, true>;
  const int total = n_layers * Sh::SIZE;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int layer = e / Sh::SIZE, r = e % Sh::SIZE;
    int to = r;
    if (r >= Sh::W1 && r < Sh::W1 + H1 * D) {  // (H1 x D) -> (D x H1)
      const int q = r - Sh::W1;
      to = Sh::W1 + (q % D) * H1 + q / D;
    } else if (r >= Sh::W2 && r < Sh::W2 + H2 * H1) {  // (H2 x H1) -> (H1 x H2)
      const int q = r - Sh::W2;
      to = Sh::W2 + (q % H1) * H2 + q / H1;
    }
    dst[layer * Sh::SIZE + to] = src[e];
  }
}

// D1/D2's conditioner of layer `layer` for rows r0 .. r0 + 15 of a
// sub-tile (xs: its coordinates, [D][S]), by one warp, from the packed
// layer w of the coupling kernel B1 (coupling_mma.cuh MmaShape): the pass
// of conditioner_mma on one row tile. h1 on FP32 FMAs straight into the A
// fragments, h1 . W2 and h2 . W3 as split-TF32 mma.sync m16n8k8 summed by
// k-steps with the last bit's correction (mma_split_step<true>), h2 kept
// in the accumulator fragments.
// The transformer parameters of row p's active dim a go to
// out[p * ROW + a * G + q].
template <class M, int S>
__device__ __forceinline__ void tile_conditioner(const float* __restrict__ w,
                                                 const float* __restrict__ xs,
                                                 float* __restrict__ out,
                                                 int layer, int r0,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int odd = layer & 1;
  // The conditioning inputs of rows g and g + 8 of the tile.
  float u[2][M::C];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < M::C; ++c) {
      u[h][c] = xs[(2 * c + 1 - odd) * S + r0 + g + 8 * h];
    }
  }
  float acc[M::KS2][4];
#pragma unroll
  for (int j = 0; j < M::KS2; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < M::KS1; ++s) {
    // First hidden layer, units 8s + 2t + e of rows g + 8h, in the A
    // fragment order (g, e = 0), (g + 8, 0), (g, 1), (g + 8, 1).
    uint32_t hh[4], hl[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int unit = 8 * s + 2 * t + e;
      const float bias = w[M::B1 + unit];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < M::C; ++c) {
          a = fmaf(w[M::W1 + unit * M::C + c], u[h][c], a);
        }
        split_tf32(fmaxf(a + bias, 0.f), hh[2 * e + h], hl[2 * e + h]);
      }
    }
#pragma unroll
    for (int j = 0; j < M::KS2; ++j) {
      const WeightFragment b(w + M::W2 + 64 * (s * M::KS2 + j) + 2 * lane);
      mma_split_step<true>(acc[j], hh, hl, b);
    }
  }
  // h2 = relu(acc + b2), kept as the accumulator fragments.
#pragma unroll
  for (int j = 0; j < M::KS2; ++j) {
    const float2 bias =
        *reinterpret_cast<const float2*>(w + M::B2 + 8 * j + 2 * t);
    acc[j][0] = fmaxf(acc[j][0] + bias.x, 0.f);
    acc[j][1] = fmaxf(acc[j][1] + bias.y, 0.f);
    acc[j][2] = fmaxf(acc[j][2] + bias.x, 0.f);
    acc[j][3] = fmaxf(acc[j][3] + bias.y, 0.f);
  }
  float o[M::NT][4];
#pragma unroll
  for (int n = 0; n < M::NT; ++n) {
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < M::KS2; ++s) {
    // h2's n-tile s is the A fragment of k-step s (as in conditioner_mma).
    uint32_t ah[4], al[4];
    split_tf32(acc[s][0], ah[0], al[0]);
    split_tf32(acc[s][2], ah[1], al[1]);
    split_tf32(acc[s][1], ah[2], al[2]);
    split_tf32(acc[s][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < M::NT; ++n) {
      const WeightFragment b(w + M::W3 + 64 * (s * M::NT + n) + 2 * lane);
      mma_split_step<true>(o[n], ah, al, b);
    }
  }
#pragma unroll
  for (int n = 0; n < M::NT; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 bias = *reinterpret_cast<const float2*>(w + M::B3 + col);
    *reinterpret_cast<float2*>(out + (r0 + g) * M::ROW + col) =
        make_float2(o[n][0] + bias.x, o[n][1] + bias.y);
    *reinterpret_cast<float2*>(out + (r0 + g + 8) * M::ROW + col) =
        make_float2(o[n][2] + bias.x, o[n][3] + bias.y);
  }
}

// D1/D2's splines: as spline_phase, thread t taking the (active dim a,
// particle p) pairs j = t, t + 2S, ... (a = j / S, p = j % S), each pair's
// parameters read from the particle's row of out as float4s.
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
// (prepare_mma_params) in shared memory.
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
      tile_conditioner<M, S>(w + layer * M::SIZE, xs, buf + Buf::OUT, layer,
                             r0, lane);
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

// D3: two sub-tiles of S particles per tile, one layer apart, the whole
// block in lock step; every layer's per-particle packed weights
// (prepare_params) in shared memory.
template <int D, int H1, int H2, int K, int S, bool MICRO>
__global__ void __launch_bounds__(4 * S, 1)
    paired_kernel(const float* __restrict__ x, float* __restrict__ z,
                  float* __restrict__ log_det,
                  const float* __restrict__ weights, int n, int n_layers,
                  float tb) {
  using Sh = Shape<D, H1, H2, K, true>;
  using Buf = StagedBuffers<D, H1, H2, K, S>;
  constexpr int Q = 2, T = 2 * S;  // sub-tiles, threads per sub-tile
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  load_staged_weights<D, H1, H2, K>(w, weights, n_layers);
  __syncthreads();
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  float* buf = w + n_layers * Sh::SIZE + g * Buf::SIZE;
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
    for (int stage = 0; stage < n_layers + Q - 1; ++stage) {
      const int layer = stage - g;
      const bool live = layer >= 0 && layer < n_layers;
      const float* wl = w + (live ? layer : 0) * Sh::SIZE;
      __syncthreads();
      if (live) {
        dense<D, H1, S, true, true>(wl + Sh::W1, wl + Sh::B1, xs,
                                    buf + Buf::H1S, t, layer);
      }
      __syncthreads();
      if (live) {
        dense<H1, H2, S, true, false>(wl + Sh::W2, wl + Sh::B2,
                                      buf + Buf::H1S, buf + Buf::H2S, t,
                                      layer);
      }
      __syncthreads();
      if (live) {
        dense<H2, Sh::OUTP, S, false, false>(wl + Sh::W3, wl + Sh::B3,
                                             buf + Buf::H2S, buf + Buf::OUT,
                                             t, layer);
      }
      __syncthreads();
      if (live) {
        part += spline_phase<D, H1, H2, K, S, MICRO>(buf + Buf::OUT, xs, t,
                                                     layer, tb);
      }
    }
    buf[Buf::LD + t] = part;
    __syncthreads();
    if (t < S && base + t < n) {
      log_det[base + t] = buf[Buf::LD + t] + buf[Buf::LD + S + t];
    }
    for (int e = t; e < S * D; e += T) {
      const int p = e / D, i = e % D;
      if (base + p < n) z[(size_t)(base + p) * D + i] = xs[i * S + p];
    }
    __syncthreads();
  }
}

// Floats per packed layer and per sub-tile buffer of a schedule: D3's
// per-particle layout (Shape, StagedBuffers), or D1/D2's tensor-core one
// (MmaShape, the coupling kernel's packing; MmaStagedBuffers).
template <int D, int H1, int H2, int K, int S, bool PAIRED>
struct StagedLayout {
  using M = MmaShape<D, H1, H2, K, true>;
  static constexpr int LAYER =
      PAIRED ? Shape<D, H1, H2, K, true>::SIZE : M::SIZE;
  static constexpr int BUFFER = PAIRED ? StagedBuffers<D, H1, H2, K, S>::SIZE
                                       : MmaStagedBuffers<M, S>::SIZE;
};

template <int D, int H1, int H2, int K, int Q, int S, bool PAIRED,
          bool MICRO>
int launch_staged(const float* x, float* z, float* ld, const float* w,
                  int n, int n_layers, float tb, cudaStream_t stream) {
  static_assert(!PAIRED || Q == 2, "the paired schedule takes two sub-tiles");
  static_assert(PAIRED || !MICRO, "rqs_micro is the paired schedule's");
  using L = StagedLayout<D, H1, H2, K, S, PAIRED>;
  const size_t smem =
      sizeof(float) * ((size_t)n_layers * L::LAYER + (size_t)Q * L::BUFFER);
  const int threads = 2 * Q * S;
  void (*kernel)(const float*, float*, float*, const float*, int, int, float);
  if constexpr (PAIRED) {
    kernel = paired_kernel<D, H1, H2, K, S, MICRO>;
  } else {
    kernel = staged_mma_kernel<D, H1, H2, K, Q, S>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (n + Q * S - 1) / (Q * S);
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
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
