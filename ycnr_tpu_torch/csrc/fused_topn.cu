// K2: fused masked scorer for bulk top-n serving.
//
// Replaces the TPU kernel ycnr_tpu/ops/pallas_topn.py:_fused_scores
// (kernel body _score_block_kernel). One thread block scores one tile of
// kTileUsers users against one 128-item segment:
//
//   s[u, j]      = sum_k rows[u, k] * V[j, k] + bi[j]   (bf16 in, f32 sum)
//   s[u, j]      = NEG_INF where bit (j & 31) of word (j >> 5) of u's rated
//                  bitfield is set (the build_rated_bits layout, read as is:
//                  kernel slot j is catalog item j, so the TPU kernel's item
//                  permutation has no counterpart here)
//   segmax[u, s] = max_j s[u, j] over the segment, from the f32 scores
//   s3[u, s, :]  = s[u, :] stored as bf16 or f32
//
// The dot product runs in k order, one fmaf per term. A product of two
// bf16 values is exact in f32, so the sum equals a sequential
// acc = acc + r * v in f32 bit for bit; the plain PyTorch version in
// ops/fused_topn.py sums in the same order and the two agree exactly.
//
// What bounds it on Hopper: the f32 scores never reach device memory, only
// segmax (4 B per user and segment) and s3 (2 or 4 B per score) leave the
// kernel, so a serving pass writes ~2 bytes per (user, item) against 2k
// FMA of CUDA-core work (k = 64: 128 FMA). At that ratio the CUDA cores,
// not the bytes, are the limit; mma.sync / wgmma on the tensor cores and
// fusing the segment select are later work. The V segment and the user
// rows are staged once per block in shared memory as f32 (V with a padded
// stride so each thread walks its own row without bank conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSegLen = 128;     // items per segment == threads per block
constexpr int kTileUsers = 32;   // users per block
constexpr int kMaxK = 256;
constexpr float kNegInf = -3.0e38f;  // eval/recommend.NEG_INF, finite

template <bool kBf16Out>
__global__ void __launch_bounds__(kSegLen)
fused_scores_kernel(const __nv_bfloat16* __restrict__ rows,
                    const __nv_bfloat16* __restrict__ V,
                    const float* __restrict__ bi,
                    const unsigned int* __restrict__ bits,
                    float* __restrict__ segmax, void* __restrict__ s3,
                    int n_users, int k, int n_seg) {
  extern __shared__ float smem[];
  const int ldv = k + 1;
  float* vs = smem;                          // [kSegLen][k + 1]
  float* rs = vs + kSegLen * ldv;            // [kTileUsers][k]
  float* red = rs + kTileUsers * k;          // [kSegLen / 32][kTileUsers]

  const int t = threadIdx.x;
  const int seg = blockIdx.x;
  const int u0 = blockIdx.y * kTileUsers;
  const int n_words = 4 * n_seg;

  const __nv_bfloat16* vseg = V + size_t(seg) * kSegLen * k;
  for (int idx = t; idx < kSegLen * k; idx += kSegLen) {
    vs[(idx / k) * ldv + idx % k] = __bfloat162float(vseg[idx]);
  }
  for (int idx = t; idx < kTileUsers * k; idx += kSegLen) {
    const int u = u0 + idx / k;
    rs[idx] = u < n_users ? __bfloat162float(rows[size_t(u) * k + idx % k])
                          : 0.0f;
  }
  __syncthreads();

  float acc[kTileUsers];
#pragma unroll
  for (int u = 0; u < kTileUsers; ++u) acc[u] = 0.0f;
  const float* vrow = vs + t * ldv;
  for (int kk = 0; kk < k; ++kk) {
    const float v = vrow[kk];
#pragma unroll
    for (int u = 0; u < kTileUsers; ++u) {
      acc[u] = fmaf(rs[u * k + kk], v, acc[u]);
    }
  }

  const int item = seg * kSegLen + t;
  const float bias = bi[item];
  const int word = seg * 4 + (t >> 5);
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int u = 0; u < kTileUsers; ++u) {
    const int user = u0 + u;
    float s = acc[u] + bias;
    if (user < n_users) {
      const unsigned int w = bits[size_t(user) * n_words + word];
      if ((w >> lane) & 1u) s = kNegInf;
      const size_t out = (size_t(user) * n_seg + seg) * kSegLen + t;
      if (kBf16Out) {
        static_cast<__nv_bfloat16*>(s3)[out] = __float2bfloat16_rn(s);
      } else {
        static_cast<float*>(s3)[out] = s;
      }
    }
    float m = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) red[warp * kTileUsers + u] = m;
  }
  __syncthreads();
  if (t < kTileUsers && u0 + t < n_users) {
    float m = red[t];
#pragma unroll
    for (int w = 1; w < kSegLen / 32; ++w) {
      m = fmaxf(m, red[w * kTileUsers + t]);
    }
    segmax[size_t(u0 + t) * n_seg + seg] = m;
  }
}

}  // namespace

extern "C" int ycnr_fused_scores(const void* rows, const void* V,
                                 const float* bi, const int* bits,
                                 float* segmax, void* s3, int n_users, int k,
                                 int n_seg, int score_bf16,
                                 cudaStream_t stream) {
  if (n_users < 1 || k < 1 || k > kMaxK || n_seg < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t(kSegLen) * (k + 1) +
                                       size_t(kTileUsers) * k +
                                       size_t(kSegLen / 32) * kTileUsers);
  const dim3 grid(n_seg, (n_users + kTileUsers - 1) / kTileUsers);
  const auto* r = static_cast<const __nv_bfloat16*>(rows);
  const auto* v = static_cast<const __nv_bfloat16*>(V);
  const auto* w = reinterpret_cast<const unsigned int*>(bits);
  cudaError_t e = cudaSuccess;
  if (score_bf16) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fused_scores_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    }
    if (e != cudaSuccess) return e;
    fused_scores_kernel<true><<<grid, kSegLen, smem, stream>>>(
        r, v, bi, w, segmax, s3, n_users, k, n_seg);
  } else {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fused_scores_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    }
    if (e != cudaSuccess) return e;
    fused_scores_kernel<false><<<grid, kSegLen, smem, stream>>>(
        r, v, bi, w, segmax, s3, n_users, k, n_seg);
  }
  return cudaGetLastError();
}
