// K2: fused masked scorer for bulk top-n serving.
//
// Replaces the TPU kernel ycnr_tpu/ops/pallas_topn.py:_fused_scores
// (kernel body _score_block_kernel). For user rows [U_B, k] bf16, the item
// table V [M, k] bf16 (M = 128 S), biases bi [M] f32 and the packed rated
// bits [U_B, 4 S]:
//
//   s[u, j]      = sum_k rows[u, k] * V[j, k] + bi[j]   (bf16 in, f32 sum)
//   s[u, j]      = NEG_INF where bit (j & 31) of word (j >> 5) of u's rated
//                  bitfield is set (the build_rated_bits layout, read as is:
//                  kernel slot j is catalog item j, so the TPU kernel's item
//                  permutation has no counterpart here)
//   segmax[u, s] = max_j s[u, j] over segment s, from the f32 scores
//   s3[u, s, :]  = s[u, :] stored as bf16 or f32
//
// What bounds it on Hopper: the bytes of s3. At k = 64 a 128 x 128 tile is
// 2.1 MFLOP against 32 KB of bf16 scores written, 64 FLOP a byte where the
// card's tensor cores give 295, so the product has to hide under the store
// and the design spends its effort on the epilogue.
//
// The product runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulators) fed by ldmatrix, as csrc/fused_gram.cu does, and not
// with wgmma: at this intensity a fifth of the tensor cores' peak hides
// the product under the store, mma.sync reaches that with both operands
// read from shared memory, and its accumulator layout (a thread holds two
// users' values of every 8-item tile) is what the epilogue below is
// written for.
//
// A block owns a tile of kTU users (128 with 8 warps; 64 with 4 above
// k = 128, where a stage of V is larger) and a run of consecutive
// segments that the wrapper sizes so that a call gives every SM a few
// blocks (ops/fused_topn.partition). The user rows are copied to shared
// memory once. V segments (128 rows) and their biases stream through a
// ring of kStages stages with 16-byte cp.async, one block barrier a
// segment; V is never widened to f32. Rows are padded by 16 bytes in
// shared memory, so the eight rows of an ldmatrix fall on different bank
// groups; k is padded to a multiple of 16 with zeros. A warp multiplies
// its 16 users by the segment's 128 items: 64 accumulators a thread.
//   Epilogue, on the accumulator fragments: add the staged bias; test
// the rated bits, which a thread reads for its two users as one 16-byte
// load each (segment s's four words start at a 16-byte boundary of the
// user's row), started before the product so that their latency hides
// under it; take the maximum over the thread's 32 values of a user and,
// with two shuffles, over the four lanes that share the user; write
// segmax. The scores leave through a per-warp staging buffer, eight users
// at a time: fragments in (row stride padded, free of bank conflicts),
// 16-byte chunks out, so a user's segment (256 contiguous bytes in bf16)
// leaves in 16-byte streaming stores, neighbouring lanes on neighbouring
// addresses. Users past n_users write nothing.
//
// Inputs whose rows are not whole 16-byte chunks (k not a multiple of 8,
// or unaligned views) are staged with plain loads instead of cp.async.
//
// Numbers: the tensor cores sum the 16 products of a step in an order and
// with a rounding they do not promise, so the scores are not bit-equal to
// the plain version's k-order sum; ops/fused_topn.py states the bound.
// The masking, the maxima and the rounding to bf16 are exact operations
// on whatever the sum gave, so a rated or padding column is exactly
// NEG_INF and segmax is exactly the maximum of the stored f32 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegLen = 128;  // items per segment
constexpr int kMaxK = 256;
constexpr float kNegInf = -3.0e38f;  // eval/recommend.NEG_INF, finite
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy past L1; bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (m16k16, row) * b (k16n8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared-memory plan, shared by the kernel and its launcher.
template <int TU, int NS, bool kBf16Out>
struct Plan {
  static constexpr int kWarps = TU / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kOutSize = kBf16Out ? 2 : 4;
  // staged scores of 8 users: a row of 128 scores plus 16 (bf16) or 32
  // (f32) bytes, so the fragment stores of a warp hit 32 different banks
  static constexpr int kOutRow = kSegLen * kOutSize + (kBf16Out ? 16 : 32);
  static constexpr int kOutWarp = 8 * kOutRow;
  int row;    // bytes of a staged row of V or of the user rows
  int users;  // offset of the user rows [TU][row]
  int ring;   // offset of the V ring [NS][128][row]
  int bias;   // offset of the bias ring [NS][128] f32
  int out;    // offset of the per-warp score staging
  int total;
  __host__ __device__ explicit Plan(int k) {
    const int kpad = (k + 15) / 16 * 16;
    row = 2 * kpad + 16;
    users = 0;
    ring = users + TU * row;
    bias = ring + NS * kSegLen * row;
    out = bias + NS * kSegLen * 4;
    total = out + kWarps * kOutWarp;
  }
};

template <int TU, int NS, bool kBf16Out>
__global__ void __launch_bounds__(Plan<TU, NS, kBf16Out>::kThreads,
                                  TU == 128 ? 2 : 1)
fused_scores_kernel(const __nv_bfloat16* __restrict__ rows,
                    const __nv_bfloat16* __restrict__ V,
                    const float* __restrict__ bi,
                    const unsigned int* __restrict__ bits,
                    float* __restrict__ segmax, void* __restrict__ s3,
                    int n_users, int k, int n_seg, int run_len, int vec,
                    int bits_vec) {
  using P = Plan<TU, NS, kBf16Out>;
  extern __shared__ __align__(16) unsigned char smem[];
  const P plan(k);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int u0 = blockIdx.x * TU;
  const int seg0 = blockIdx.y * run_len;
  const int nrun = min(run_len, n_seg - seg0);
  const int kt = (k + 15) / 16;  // 16-wide steps of the product
  const int kpad = 16 * kt;
  const int cpr = k / 8;  // 16-byte chunks per row (vec)
  const unsigned short* rows_u = reinterpret_cast<const unsigned short*>(rows);
  const unsigned short* V_u = reinterpret_cast<const unsigned short*>(V);

  // Copy `n` rows of k bf16 from src (rows past `valid` are zero) to dst.
  auto stage_rows = [&](unsigned char* dst, const unsigned short* src, int n,
                        int valid) {
    if (vec) {
      for (int q = t; q < n * cpr; q += P::kThreads) {
        const int r = q / cpr;
        const int c = q - r * cpr;
        const bool live = r < valid;
        cp_async16(dst + r * plan.row + 16 * c,
                   live ? src + size_t(r) * k + 8 * c : src, live ? 16 : 0);
      }
    } else {
      for (int q = t; q < n * kpad; q += P::kThreads) {
        const int r = q / kpad;
        const int c = q - r * kpad;
        reinterpret_cast<unsigned short*>(dst + r * plan.row)[c] =
            (r < valid && c < k) ? src[size_t(r) * k + c] : 0;
      }
    }
  };
  // Segment i of the run: V rows and biases into ring stage i % NS.
  auto fetch = [&](int i) {
    const int buf = i % NS;
    const int seg = seg0 + i;
    stage_rows(smem + plan.ring + buf * kSegLen * plan.row,
               V_u + size_t(seg) * kSegLen * k, kSegLen, kSegLen);
    float* bs = reinterpret_cast<float*>(smem + plan.bias) + buf * kSegLen;
    const float* bsrc = bi + size_t(seg) * kSegLen;
    if (vec) {
      if (t < kSegLen / 4) cp_async16(bs + 4 * t, bsrc + 4 * t, 16);
    } else {
      for (int q = t; q < kSegLen; q += P::kThreads) bs[q] = bsrc[q];
    }
  };

  if (vec && k < kpad) {  // columns [k, kpad) of every staged row: 0
    const int pc = kpad - k;
    const int nrows = TU + NS * kSegLen;  // the user rows, then the ring
    for (int q = t; q < nrows * pc; q += P::kThreads) {
      reinterpret_cast<unsigned short*>(smem + (q / pc) * plan.row)[k + q % pc]
          = 0;
    }
  }
  stage_rows(smem + plan.users, rows_u + size_t(u0) * k, TU,
             min(TU, n_users - u0));
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < nrun) fetch(p);
    cp_async_commit();
  }

  // this warp's 16 users; this thread's two of them, g and g + 8
  const int g = lane >> 2;
  const int l3 = lane & 3;
  const int ua = u0 + 16 * warp + g;
  const int ub = ua + 8;
  const int n_words = 4 * n_seg;
  // ldmatrix addresses: A from the user rows, B from a V stage
  const unsigned char* a_ptr = smem + plan.users +
                               (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   plan.row + 16 * (lane >> 4);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * plan.row +
                    16 * ((lane >> 3) & 1);
  unsigned char* obuf = smem + plan.out + warp * P::kOutWarp;

  for (int i = 0; i < nrun; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage i has landed; stage i - 1 is free again
    if (i + NS - 1 < nrun) fetch(i + NS - 1);
    cp_async_commit();
    const int seg = seg0 + i;

    // the rated bits of (user, segment), in flight during the product
    uint4 wa = make_uint4(0, 0, 0, 0), wb = wa;
    if (bits_vec) {
      if (ua < n_users) {
        wa = *reinterpret_cast<const uint4*>(bits + size_t(ua) * n_words +
                                             4 * seg);
      }
      if (ub < n_users) {
        wb = *reinterpret_cast<const uint4*>(bits + size_t(ub) * n_words +
                                             4 * seg);
      }
    } else {
      if (ua < n_users) {
        const unsigned int* p = bits + size_t(ua) * n_words + 4 * seg;
        wa = make_uint4(p[0], p[1], p[2], p[3]);
      }
      if (ub < n_users) {
        const unsigned int* p = bits + size_t(ub) * n_words + 4 * seg;
        wb = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }

    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    const unsigned char* vb =
        smem + plan.ring + (i % NS) * kSegLen * plan.row + b_off;
    for (int ks = 0; ks < kt; ++ks) {
      uint32_t a[4];
      ldsm_x4(a_ptr + 32 * ks, a);
#pragma unroll
      for (int tp = 0; tp < 8; ++tp) {  // two 8-item tiles per load
        uint32_t b[4];
        ldsm_x4(vb + 16 * tp * plan.row + 32 * ks, b);
        mma_bf16(acc[2 * tp], a, b[0], b[1]);
        mma_bf16(acc[2 * tp + 1], a, b[2], b[3]);
      }
    }

    // bias, mask, maxima: tile j holds items 8 j + 2 l3 + {0, 1}, i.e.
    // bits 8 (j & 3) + 2 l3 + {0, 1} of word j >> 2
    const float* bs =
        reinterpret_cast<const float*>(smem + plan.bias) + (i % NS) * kSegLen;
    const unsigned int wwa[4] = {wa.x, wa.y, wa.z, wa.w};
    const unsigned int wwb[4] = {wb.x, wb.y, wb.z, wb.w};
    float ma = kNegInf, mb = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * l3);
      const unsigned int ra = wwa[j >> 2] >> (8 * (j & 3) + 2 * l3);
      const unsigned int rb = wwb[j >> 2] >> (8 * (j & 3) + 2 * l3);
      acc[j][0] = (ra & 1u) ? kNegInf : acc[j][0] + bb.x;
      acc[j][1] = (ra & 2u) ? kNegInf : acc[j][1] + bb.y;
      acc[j][2] = (rb & 1u) ? kNegInf : acc[j][2] + bb.x;
      acc[j][3] = (rb & 2u) ? kNegInf : acc[j][3] + bb.y;
      ma = fmaxf(ma, fmaxf(acc[j][0], acc[j][1]));
      mb = fmaxf(mb, fmaxf(acc[j][2], acc[j][3]));
    }
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 1));
    mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 1));
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 2));
    if (l3 == 0) {
      if (ua < n_users) segmax[size_t(ua) * n_seg + seg] = ma;
      if (ub < n_users) segmax[size_t(ub) * n_seg + seg] = mb;
    }

    // the scores, eight users at a time, through the warp's staging
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __syncwarp();  // the last half's readers are done
      unsigned char* orow = obuf + g * P::kOutRow;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float x = acc[j][2 * h], y = acc[j][2 * h + 1];
        if (kBf16Out) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 2 * (8 * j + 2 * l3)) =
              __floats2bfloat162_rn(x, y);
        } else {
          *reinterpret_cast<float2*>(orow + 4 * (8 * j + 2 * l3)) =
              make_float2(x, y);
        }
      }
      __syncwarp();
      constexpr int kChunks = kSegLen * P::kOutSize / 16;  // per user
      const int ubase = u0 + 16 * warp + 8 * h;
#pragma unroll
      for (int q = lane; q < 8 * kChunks; q += 32) {
        const int r = q / kChunks;
        const int c = q % kChunks;
        if (ubase + r < n_users) {
          const float4 v =
              *reinterpret_cast<const float4*>(obuf + r * P::kOutRow + 16 * c);
          unsigned char* dst =
              static_cast<unsigned char*>(s3) +
              (size_t(ubase + r) * n_seg + seg) * (kSegLen * P::kOutSize) +
              16 * c;
          __stcs(reinterpret_cast<float4*>(dst), v);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int TU, int NS, bool kBf16Out>
int launch(const void* rows, const void* V, const float* bi, const int* bits,
           float* segmax, void* s3, int n_users, int k, int n_seg,
           int run_len, cudaStream_t stream) {
  using P = Plan<TU, NS, kBf16Out>;
  const P plan(k);
  if (plan.total > 232448) return cudaErrorInvalidValue;
  auto kern = fused_scores_kernel<TU, NS, kBf16Out>;
  if (plan.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.total);
    if (e != cudaSuccess) return e;
  }
  auto al16 = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = k % 8 == 0 && al16(rows) && al16(V) && al16(bi);
  const int bits_vec = al16(bits);
  const dim3 grid((n_users + TU - 1) / TU, (n_seg + run_len - 1) / run_len);
  kern<<<grid, P::kThreads, plan.total, stream>>>(
      static_cast<const __nv_bfloat16*>(rows),
      static_cast<const __nv_bfloat16*>(V), bi,
      reinterpret_cast<const unsigned int*>(bits), segmax, s3, n_users, k,
      n_seg, run_len, vec, bits_vec);
  return cudaGetLastError();
}

}  // namespace

// A block takes `tile_users` users (128 up to k = 128, else 64; the caller
// passes what ops/fused_topn.partition chose and this checks it) and
// `run_len` consecutive segments.
extern "C" int ycnr_fused_scores(const void* rows, const void* V,
                                 const float* bi, const int* bits,
                                 float* segmax, void* s3, int n_users, int k,
                                 int n_seg, int score_bf16, int tile_users,
                                 int run_len, cudaStream_t stream) {
  if (n_users < 1 || k < 1 || k > kMaxK || n_seg < 1 || run_len < 1 ||
      tile_users != (k <= 128 ? 128 : 64) ||
      (n_seg + run_len - 1) / run_len > 65535) {
    return cudaErrorInvalidValue;
  }
  if (k <= 128) {
    return score_bf16 ? launch<128, 3, true>(rows, V, bi, bits, segmax, s3,
                                             n_users, k, n_seg, run_len,
                                             stream)
                      : launch<128, 3, false>(rows, V, bi, bits, segmax, s3,
                                              n_users, k, n_seg, run_len,
                                              stream);
  }
  return score_bf16 ? launch<64, 2, true>(rows, V, bi, bits, segmax, s3,
                                          n_users, k, n_seg, run_len, stream)
                    : launch<64, 2, false>(rows, V, bi, bits, segmax, s3,
                                           n_users, k, n_seg, run_len, stream);
}
