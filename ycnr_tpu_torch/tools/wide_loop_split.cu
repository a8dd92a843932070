// Where the loop of fused_gram's mma.sync wide body (w 129-256: 8 warps,
// cp.async into a 3-stage ring, ldmatrix + mma.sync m16n8k16, two block
// barriers a stage; the body before the wgmma one) spends its cycles, on
// long lists whose A is negligible (264 entities x 16,384 slots, random
// rows of a 26,745-row bf16 table, int64 indices) at w 192 and 256. A
// standalone program, kept beside the port for the record of PERF.md; the
// body it measures is the one that ycnr_tpu_torch/csrc/fused_gram.cu
// replaced.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o wide_loop_split ycnr_tpu_torch/tools/wide_loop_split.cu
//   ./wide_loop_split
//
// Each warp adds clock64() deltas into four counters a stage: the copy
// issue and the next stage's index fetch; the wait for the stage (cp.async
// wait_group + the first block barrier); the 16-slot steps (ldmatrix and
// mma.sync); the second block barrier. Two more builds of the steps split
// them: without the mma.sync (ldmatrix only, fragments folded into a
// register so they are loaded) and without the ldmatrix (the mma chain on
// fragments held in registers). Per line: ms of the kernel (CUDA events,
// median of 5), ns a slot, and the mean cycles a stage of the warps that
// multiply, by counter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr int kStageSlots = 64;
constexpr int kSteps = kStageSlots / 16;
constexpr int kStages = 3;
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;

template <int T>
struct WideCfg {
  static constexpr int kW16 = 16 * T;
  static constexpr int kRow = kW16 + 8;
  static constexpr int kQ = (kStageSlots * 2 * T + kWideThreads - 1) /
                            kWideThreads;
  static constexpr int kStageBytes = kStages * kStageSlots * kRow * 2;
  static constexpr int kRatOff = (kStageBytes + 15) / 16 * 16;
  static constexpr int kSmem = kRatOff + kStages * kStageSlots * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ long long clk() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
  return c;
}

enum Mode { kFull = 0, kNoMma = 1, kNoLdsm = 2 };

// That body's loop (the vec path, the trash row read like any other), with
// counters; out[block] keeps the accumulators live.
template <int T, int MODE, bool CLK>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_loop(const __nv_bfloat16* __restrict__ table,
          const long long* __restrict__ idx, float* __restrict__ out, int R,
          int w, long long* __restrict__ counters) {
  using C = WideCfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* rows = reinterpret_cast<unsigned short*>(smem);
  const unsigned short* tb = reinterpret_cast<const unsigned short*>(table);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rb = T - 1 - warp;
  const int ra = warp;
  const bool has_b = warp <= rb;
  const bool has_a = warp < rb;
  const long long* ie = idx + static_cast<long long>(blockIdx.x) * R;
  const int cpr = w / 8;
  const int nst = (R + kStageSlots - 1) / kStageSlots;
  long long c_issue = 0, c_wait = 0, c_step = 0, c_sync = 0;

  long long nidx[C::kQ];
  auto fetch = [&](int st) {
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
#pragma unroll
    for (int k = 0; k < C::kQ; ++k) {
      const int s = (t + k * kWideThreads) / cpr;
      nidx[k] = s < ns ? ie[s0 + s] : 0;
    }
  };
  auto issue = [&](int st) {
    const int buf = st % kStages;
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
    unsigned short* dst = rows + buf * kStageSlots * C::kRow;
#pragma unroll
    for (int k = 0; k < C::kQ; ++k) {
      const int q = t + k * kWideThreads;
      if (q < kStageSlots * cpr) {
        const int s = q / cpr;
        const int c = q - s * cpr;
        const unsigned short* src = tb;
        int bytes = 0;
        if (s < ns) {
          src = tb + nidx[k] * w + 8 * c;
          bytes = 16;
        }
        cp_async16(dst + s * C::kRow + 8 * c, src, bytes);
      }
    }
  };

  float acc[T + 1][2][4];
#pragma unroll
  for (int i = 0; i <= T; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][h][k] = 0.0f;
  uint32_t fold = 0;

  fetch(0);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) {
      if (p > 0) fetch(p);
      issue(p);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (kStages - 1 < nst) fetch(kStages - 1);
  const int lrow = (lane & 7) + 8 * ((lane >> 4) & 1);
  const int lcol = 8 * ((lane >> 3) & 1);
  uint32_t cf[4] = {0x3f803f80u ^ lane, 0x3f803f80u, 0x3f803f80u,
                    0x3f803f80u};
  for (int st = 0; st < nst; ++st) {
    long long c0 = CLK ? clk() : 0;
    if (st + kStages - 1 < nst) {
      issue(st + kStages - 1);
      if (st + kStages < nst) fetch(st + kStages);
    }
    long long c1 = CLK ? clk() : 0;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    long long c2 = CLK ? clk() : 0;
    const int buf = st % kStages;
    const int ns = min(kStageSlots, R - st * kStageSlots);
    const unsigned short* src = rows + buf * kStageSlots * C::kRow;
    if (has_b) {
      for (int kc = 0; kc < kSteps; ++kc) {
        const int k0 = 16 * kc;
        if (k0 >= ns) break;
        const unsigned short* base = src + (k0 + lrow) * C::kRow + lcol;
        uint32_t fb[4], fa[4] = {0u, 0u, 0u, 0u};
        if (MODE == kNoLdsm) {
#pragma unroll
          for (int k = 0; k < 4; ++k) fb[k] = fa[k] = cf[k];
        } else {
          ldsm_x4_trans(base + 16 * rb, fb);
          if (has_a) ldsm_x4_trans(base + 16 * ra, fa);
        }
#pragma unroll
        for (int tj = 0; tj < T; ++tj) {
          if (tj <= rb) {
            uint32_t f[4];
            if (MODE == kNoLdsm) {
#pragma unroll
              for (int k = 0; k < 4; ++k) f[k] = cf[k] + tj;
            } else if (tj == rb) {
#pragma unroll
              for (int k = 0; k < 4; ++k) f[k] = fb[k];
            } else if (has_a && tj == ra) {
#pragma unroll
              for (int k = 0; k < 4; ++k) f[k] = fa[k];
            } else {
              ldsm_x4_trans(base + 16 * tj, f);
            }
            if (MODE == kNoMma) {
              fold ^= f[0] ^ f[1] ^ f[2] ^ f[3] ^ fb[0] ^ fa[1];
            } else {
              mma_bf16(acc[tj][0], fb, f[0], f[2]);
              mma_bf16(acc[tj][1], fb, f[1], f[3]);
              if (has_a && tj <= ra) {
                mma_bf16(acc[T - tj][0], fa, f[0], f[2]);
                mma_bf16(acc[T - tj][1], fa, f[1], f[3]);
              }
            }
          }
        }
      }
    }
    long long c3 = CLK ? clk() : 0;
    __syncthreads();
    long long c4 = CLK ? clk() : 0;
    c_issue += c1 - c0;
    c_wait += c2 - c1;
    c_step += c3 - c2;
    c_sync += c4 - c3;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float s = static_cast<float>(fold);
#pragma unroll
  for (int i = 0; i <= T; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) s += acc[i][h][k];
  out[blockIdx.x * kWideThreads + t] = s;
  if (CLK && lane == 0 && has_b) {
    long long* c = counters + 4 * (blockIdx.x * kWideWarps + warp);
    c[0] = c_issue;
    c[1] = c_wait;
    c[2] = c_step;
    c[3] = c_sync;
  }
}

template <int T, int MODE, bool CLK>
void run(const char* what, const __nv_bfloat16* table, const long long* idx,
         float* out, long long* counters, int ne, int R, int w) {
  using C = WideCfg<T>;
  auto kern = wide_loop<T, MODE, CLK>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::kSmem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  std::vector<float> ms;
  for (int rep = 0; rep < 6; ++rep) {
    cudaEventRecord(a);
    kern<<<ne, kWideThreads, C::kSmem>>>(table, idx, out, R, w, counters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float m = 0;
    cudaEventElapsedTime(&m, a, b);
    if (rep > 0) ms.push_back(m);
  }
  std::sort(ms.begin(), ms.end());
  const double med = ms[ms.size() / 2];
  const cudaError_t err = cudaGetLastError();
  printf("w=%d %-28s %s: %.3f ms, %.3f ns a slot", w, what,
         cudaGetErrorString(err), med, med * 1e6 / (double(ne) * R));
  if (CLK) {
    std::vector<long long> c(4LL * ne * kWideWarps, 0);
    cudaMemcpy(c.data(), counters, c.size() * 8, cudaMemcpyDeviceToHost);
    double sum[4] = {0, 0, 0, 0};
    long long n = 0;
    for (long long i = 0; i < ne * kWideWarps; ++i) {
      if (c[4 * i + 2] == 0) continue;  // warps without tiles
      for (int k = 0; k < 4; ++k) sum[k] += c[4 * i + k];
      ++n;
    }
    const double st = n * double((R + kStageSlots - 1) / kStageSlots);
    printf("; cycles a stage: issue+fetch %.0f, wait %.0f, steps %.0f, "
           "barrier %.0f", sum[0] / st, sum[1] / st, sum[2] / st,
           sum[3] / st);
  }
  printf("\n");
  cudaEventDestroy(a);
  cudaEventDestroy(b);
}

template <int T>
void width(int n_rows, int ne, int R) {
  const int w = 16 * T;
  std::mt19937_64 rng(w);
  std::normal_distribution<float> nd(0.0f, 0.1f);
  std::vector<__nv_bfloat16> tab(static_cast<size_t>(n_rows) * w);
  for (size_t i = 0; i < tab.size(); ++i) {
    tab[i] = __float2bfloat16(i / w == size_t(n_rows - 1) ? 0.0f : nd(rng));
  }
  std::vector<long long> ix(static_cast<size_t>(ne) * R);
  for (auto& v : ix) v = static_cast<long long>(rng() % (n_rows - 1));
  __nv_bfloat16* dt;
  long long *di, *dc;
  float* dout;
  cudaMalloc(&dt, tab.size() * 2);
  cudaMalloc(&di, ix.size() * 8);
  cudaMalloc(&dc, 4LL * ne * kWideWarps * 8);
  cudaMalloc(&dout, static_cast<size_t>(ne) * kWideThreads * 4);
  cudaMemcpy(dt, tab.data(), tab.size() * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(di, ix.data(), ix.size() * 8, cudaMemcpyHostToDevice);
  run<T, kFull, false>("loop", dt, di, dout, dc, ne, R, w);
  run<T, kFull, true>("loop, counted", dt, di, dout, dc, ne, R, w);
  run<T, kNoMma, true>("ldmatrix only, counted", dt, di, dout, dc, ne, R, w);
  run<T, kNoLdsm, true>("mma only, counted", dt, di, dout, dc, ne, R, w);
  cudaFree(dt);
  cudaFree(di);
  cudaFree(dc);
  cudaFree(dout);
}

}  // namespace

int main() {
  cudaDeviceProp p;
  cudaGetDeviceProperties(&p, 0);
  printf("%s, %d SMs; the mma.sync wide loop, 264 x 16,384 slots\n", p.name,
         p.multiProcessorCount);
  width<12>(26'745, 264, 16'384);
  width<16>(26'745, 264, 16'384);
  return 0;
}
