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
// conditioner is a product W (out x in) . X (in x S) over a sub-tile held
// in shared memory (h1, h2 and the spline parameters are [units][S]
// arrays), then the spline runs per particle and active dim.
//
// - D1/D2: sub-tile q is owned by its own group of 2S threads, which
//   synchronises only among itself (named barrier 1 + q). The groups run
//   their layers independently, so the warp schedulers interleave one
//   group's FMA products with another's spline (SFU and branch work): the
//   native form of the TPU's MXU/VPU overlap, with no lock-step stagger.
// - D3 (PAIRED): two sub-tiles one layer apart in lock step. Per dense
//   level one 128-row pass over the block (rows 0..63 sub-tile A with
//   layer l's weights, rows 64..127 sub-tile B with layer l-1's) computes
//   both sub-tiles' outputs; the TPU's block-diagonal zero blocks, a fill
//   for its 128 x 128 matrix unit, are not stored.
//
// What bounds it on an H100: FP32 arithmetic. A 4-layer (64, 64) x 8-bin
// flow costs 57,344 FLOP per particle against 36 bytes of input and
// output, so device memory is idle and the FP32 pipes set the time (no
// tensor cores in this simple design). What the design does about it:
// every layer's weights stay in shared memory for the block's whole life
// (a persistent grid of one block per SM walks over the tiles), each
// thread keeps a register tile of RO outputs x 4 particles, so one float4
// of activations and RO/2 or RO/4 vector loads of weights feed 4 * RO
// FMAs, and only the active half's spline parameters are computed.

#include "common.cuh"

namespace aspire {

// Per sub-tile shared buffers, each [rows][S]: the coordinates, both
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

// Barrier of one sub-tile's group (named barrier 1 + g over its threads),
// or of the whole block when the schedule is paired.
template <bool PAIRED>
__device__ __forceinline__ void group_sync(int g, int threads) {
  if constexpr (PAIRED) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(threads) : "memory");
  }
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

template <int D, int H1, int H2, int K, int Q, int S, bool PAIRED,
          bool MICRO>
__global__ void __launch_bounds__(2 * Q * S, 1)
    staged_kernel(const float* __restrict__ x, float* __restrict__ z,
                  float* __restrict__ log_det,
                  const float* __restrict__ weights, int n, int n_layers,
                  float tb) {
  using Sh = Shape<D, H1, H2, K, true>;
  using Buf = StagedBuffers<D, H1, H2, K, S>;
  constexpr int T = 2 * S;  // threads per sub-tile
  static_assert(!PAIRED || Q == 2, "the paired schedule takes two sub-tiles");
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);
  load_staged_weights<D, H1, H2, K>(w, weights, n_layers);
  __syncthreads();
  const int g = threadIdx.x / T, t = threadIdx.x % T;
  float* buf = w + n_layers * Sh::SIZE + g * Buf::SIZE;
  float* xs = buf + Buf::X;
  const int n_tiles = (n + Q * S - 1) / (Q * S);
  const int stages = PAIRED ? n_layers + Q - 1 : n_layers;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * Q * S + g * S;
    // The sub-tile, zeros past n (the ragged last tile).
    for (int e = t; e < S * D; e += T) {
      const int p = e / D, i = e % D;
      xs[i * S + p] = base + p < n ? x[(size_t)(base + p) * D + i] : 0.f;
    }
    float part = 0.f;
    for (int stage = 0; stage < stages; ++stage) {
      const int layer = PAIRED ? stage - g : stage;
      const bool live = layer >= 0 && layer < n_layers;
      const float* wl = w + (live ? layer : 0) * Sh::SIZE;
      group_sync<PAIRED>(g, T);
      if (live) {
        dense<D, H1, S, true, true>(wl + Sh::W1, wl + Sh::B1, xs,
                                    buf + Buf::H1S, t, layer);
      }
      group_sync<PAIRED>(g, T);
      if (live) {
        dense<H1, H2, S, true, false>(wl + Sh::W2, wl + Sh::B2,
                                      buf + Buf::H1S, buf + Buf::H2S, t,
                                      layer);
      }
      group_sync<PAIRED>(g, T);
      if (live) {
        dense<H2, Sh::OUTP, S, false, false>(wl + Sh::W3, wl + Sh::B3,
                                             buf + Buf::H2S, buf + Buf::OUT,
                                             t, layer);
      }
      group_sync<PAIRED>(g, T);
      if (live) {
        part += spline_phase<D, H1, H2, K, S, MICRO>(buf + Buf::OUT, xs, t,
                                                     layer, tb);
      }
    }
    buf[Buf::LD + t] = part;
    group_sync<PAIRED>(g, T);
    if (t < S && base + t < n) {
      log_det[base + t] = buf[Buf::LD + t] + buf[Buf::LD + S + t];
    }
    for (int e = t; e < S * D; e += T) {
      const int p = e / D, i = e % D;
      if (base + p < n) z[(size_t)(base + p) * D + i] = xs[i * S + p];
    }
    group_sync<PAIRED>(g, T);
  }
}

template <int D, int H1, int H2, int K, int Q, int S, bool PAIRED,
          bool MICRO>
int launch_staged(const float* x, float* z, float* ld, const float* w,
                  int n, int n_layers, float tb, cudaStream_t stream) {
  using Sh = Shape<D, H1, H2, K, true>;
  using Buf = StagedBuffers<D, H1, H2, K, S>;
  const size_t smem =
      sizeof(float) * ((size_t)n_layers * Sh::SIZE + (size_t)Q * Buf::SIZE);
  const int threads = 2 * Q * S;
  auto kernel = staged_kernel<D, H1, H2, K, Q, S, PAIRED, MICRO>;
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

// The row (D, H1, H2, K, Q, S, PAIRED, MICRO) of a configuration id, and
// its packed floats per layer; -1 for an unknown id.
int aspire_staged_config(int config, int* row) {
#define ASPIRE_STAGED_ROW(ID, D, H1, H2, K, Q, S, PAIRED, MICRO)  \
  if (config == ID) {                                            \
    const int v[9] = {D, H1, H2, K, Q, S, PAIRED, MICRO,         \
                      aspire::Shape<D, H1, H2, K, true>::SIZE};  \
    for (int i = 0; i < 9; ++i) row[i] = v[i];                   \
    return 0;                                                    \
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
