// How mma.sync m16n8k8 TF32 rounds its FP32 sum, the question behind
// aspire_tpu_torch/csrc/coupling_mma.cuh's mma_split_step (which leaves the
// cut: tests/test_torch_staged_coupling.py models it from these shares).
// A program of its own, for an sm_90a card; from the root
// of the repository:
//   mkdir -p aspire_tpu_torch/_build && nvcc -gencode arch=compute_90a,code=sm_90a -O2 \
//        -o aspire_tpu_torch/_build/mma_probe tools/mma_rounding_probe.cu
//   aspire_tpu_torch/_build/mma_probe
// For five kinds of TF32 inputs, 4096 warps of one mma.sync each against
// the exact sum in double: the error in ulps of the exact sum, signed so
// that a negative value is toward zero, and the shares of results that are
// exact, equal to the exact sum rounded to nearest (RN) and cut toward
// zero (RZ).
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <random>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp per tile: A (16 x 8 row-major), B (8 x 8, B[k][n]), C (16 x 8).
__global__ void tiles(const float* A, const float* B, const float* C,
                      float* D, int n_tiles) {
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + tile * 128;
  const float* b = B + tile * 64;
  const float* c = C + tile * 128;
  uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                    __float_as_uint(a[g * 8 + t + 4]), __float_as_uint(a[(g + 8) * 8 + t + 4])};
  const uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  float d[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                c[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32(d, af, b0, b1);
  float* o = D + tile * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}

static float tf32(float x) {  // round to nearest TF32 (ties away)
  uint32_t u; memcpy(&u, &x, 4); u = (u + 0x1000u) & 0xFFFFE000u; memcpy(&x, &u, 4); return x;
}

int main() {
  const int n_tiles = 4096;
  std::mt19937_64 rng(1);
  std::normal_distribution<double> nd(0, 1);
  std::uniform_real_distribution<double> ud(-1, 1);
  const char* names[] = {"same scale, C=0", "spread 2^+-6, C=0", "spread 2^+-6, C=mixed",
                         "positive only, C=0", "cancelling pairs, C=0"};
  for (int kind = 0; kind < 5; ++kind) {
    std::vector<float> A(n_tiles * 128), B(n_tiles * 64), C(n_tiles * 128, 0.f), D(n_tiles * 128);
    for (auto& v : A) {
      double x = nd(rng);
      if (kind == 1 || kind == 2) x *= std::exp2(std::floor(12 * ud(rng) / 2));
      if (kind == 3) x = std::fabs(x);
      v = tf32((float)x);
    }
    for (auto& v : B) { double x = nd(rng); if (kind == 3) x = std::fabs(x); v = tf32((float)x); }
    if (kind == 4) for (int i = 0; i < n_tiles * 128; i += 2) A[i + 1] = -A[i] * (1 + 1e-3f);
    if (kind == 2) for (auto& v : C) v = (float)(nd(rng) * 4);
    float *dA, *dB, *dC, *dD;
    cudaMalloc(&dA, A.size() * 4); cudaMalloc(&dB, B.size() * 4); cudaMalloc(&dC, C.size() * 4); cudaMalloc(&dD, D.size() * 4);
    cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dC, C.data(), C.size() * 4, cudaMemcpyHostToDevice);
    tiles<<<n_tiles / 8, 256>>>(dA, dB, dC, dD, n_tiles);
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) { printf("error %d\n", (int)err); return 1; }
    cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
    double sum = 0, sum2 = 0; long exact = 0, toward = 0, away = 0, over1 = 0, rn_match = 0, rz_match = 0, cnt = 0;
    for (int tile = 0; tile < n_tiles; ++tile)
      for (int i = 0; i < 16; ++i)
        for (int j = 0; j < 8; ++j) {
          double e = C[tile * 128 + i * 8 + j];
          for (int k = 0; k < 8; ++k) e += (double)A[tile * 128 + i * 8 + k] * (double)B[tile * 64 + k * 8 + j];
          const float d = D[tile * 128 + i * 8 + j];
          if (e == 0) continue;
          const double ulp = std::ldexp(1.0, std::ilogb(e) - 23);
          const double r = (d - e) / ulp * (e > 0 ? 1 : -1);
          ++cnt; sum += r; sum2 += r * r;
          if (d == e) ++exact; else if (r < 0) ++toward; else ++away;
          if (std::fabs(r) >= 1) ++over1;
          const float rn = (float)e;  // round to nearest
          float rz = rn; if (std::fabs((double)rn) > std::fabs(e)) rz = std::nextafter(rn, 0.f);
          rn_match += d == rn; rz_match += d == rz;
        }
    printf("%-24s n=%ld mean %+.4f ulp rms %.4f exact %.4f toward0 %.4f away %.4f |err|>=1 %.4f ==RN %.4f ==RZ %.4f\n",
           names[kind], cnt, sum / cnt, std::sqrt(sum2 / cnt), (double)exact / cnt,
           (double)toward / cnt, (double)away / cnt, (double)over1 / cnt, (double)rn_match / cnt, (double)rz_match / cnt);
  }
  return 0;
}
