// Fused gather -> Gram: per entity e of a block,
//
//   A[e] = sum_r F[idx[e, r]] F[idx[e, r]]^T      [w, w] f32
//   b[e] = sum_r rat[e, r] F[idx[e, r]]            [w]    f32
//
// from a bf16 factor table F [n, w] (w <= 128), without writing the
// gathered rows to device memory.
//
// Replaces the TPU kernel tools/probe_gather.py:pallas_fused_gram (T4),
// which gathers a [tile_ne, R] slot tile's rows into VMEM scratch and runs
// the batched Gram on the MXU, at a fixed R = 32. Here R is any length:
// the bucketed ALS epoch (models/bucketed_phase.py) calls it with rungs
// from 32 slots up to the heaviest entity's thousands.
//
// What bounds it on Hopper: the CUDA cores. An entity costs R * w * w FMA
// (w = 64: 4,096 per slot) against R * (2w + 6) bytes of reads (the rows
// from the L2-resident table, plus index and rating), so the gathered
// rows never cost a device-memory round trip and the f32 widening copy of
// the two-step path is gone. Tensor-core products (mma.sync / wgmma with
// bf16 in and f32 out), TMA staging and exploiting the symmetry of A are
// later work.
//
// Design: one block of 256 threads per entity (the wrapper splits very
// long rating lists over several blocks when a call has too few entities
// to fill the card, and sums the parts). The block streams its slots in
// tiles of kSlots rows, gathered into shared memory as bf16 with 16-byte
// loads. The threads form a 16 x 16 grid over A; thread (ty, tx) owns the
// T x T sub-tile of rows ty*T.. and columns tx*T.. (T = ceil(w / 16)) in
// f32 registers, and the threads with ty == 0 also own b's columns tx*T...
// Every sum is an fmaf chain in slot order. A product of two bf16 values
// is exact in f32, so A[i][j] and A[j][i] are the same sums of the same
// values in the same order: A comes out bit-symmetric, and a padding slot
// (the all-zero trash row, rating 0) adds exactly nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;   // kGrid x kGrid threads over A
constexpr int kSlots = 32;  // rating slots staged per tile
constexpr int kMaxW = 128;

// bf16 -> f32 is a 16-bit shift; two values share one 32-bit word.
__device__ __forceinline__ void unpack2(unsigned int x, float* out) {
  out[0] = __uint_as_float(x << 16);
  out[1] = __uint_as_float(x & 0xffff0000u);
}

// T consecutive bf16 values of a shared-memory row as f32.
template <int T>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&out)[T]) {
  if constexpr (T % 8 == 0) {
#pragma unroll
    for (int k = 0; k < T / 8; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      unpack2(v.x, out + 8 * k);
      unpack2(v.y, out + 8 * k + 2);
      unpack2(v.z, out + 8 * k + 4);
      unpack2(v.w, out + 8 * k + 6);
    }
  } else if constexpr (T % 4 == 0) {
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[k];
      unpack2(v.x, out + 4 * k);
      unpack2(v.y, out + 4 * k + 2);
    }
  } else if constexpr (T % 2 == 0) {
#pragma unroll
    for (int k = 0; k < T / 2; ++k) {
      unpack2(reinterpret_cast<const unsigned int*>(p)[k], out + 2 * k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < T; ++k) out[k] = __bfloat162float(p[k]);
  }
}

template <int T, typename Idx>
__global__ void __launch_bounds__(kThreads)
fused_gram_kernel(const __nv_bfloat16* __restrict__ table,
                  const Idx* __restrict__ idx,
                  const __nv_bfloat16* __restrict__ rat,
                  float* __restrict__ A, float* __restrict__ b, int R, int w,
                  long long n_rows) {
  constexpr int kW = kGrid * T;   // staged row width (bf16), w padded
  constexpr int kChunks = kW / 8; // 16-byte chunks per staged row
  __shared__ __align__(16) __nv_bfloat16 rows[kSlots][kW];
  __shared__ long long s_idx[kSlots];
  __shared__ float s_rat[kSlots];

  const int t = threadIdx.x;
  const int ty = t / kGrid;
  const int tx = t % kGrid;
  const long long e = blockIdx.x;
  const Idx* ie = idx + e * R;
  const __nv_bfloat16* re = rat + e * R;
  const bool vec = (w % 8) == 0;  // rows are whole 16-byte chunks

  float acc[T][T];
  float accb[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    accb[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.0f;
  }

  for (int s0 = 0; s0 < R; s0 += kSlots) {
    const int ns = min(kSlots, R - s0);
    if (t < ns) {
      const long long r = static_cast<long long>(ie[s0 + t]);
      if (r < 0 || r >= n_rows) __trap();
      s_idx[t] = r;
      s_rat[t] = __bfloat162float(re[s0 + t]);
    }
    __syncthreads();
    for (int q = t; q < ns * kChunks; q += kThreads) {
      const int s = q / kChunks;
      const int c = q - s * kChunks;
      const __nv_bfloat16* src = table + s_idx[s] * w;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (vec) {
        if (8 * c < w) v = reinterpret_cast<const uint4*>(src)[c];
      } else {
        unsigned short h[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int col = 8 * c + k;
          h[k] = col < w ? __bfloat16_as_ushort(src[col]) : 0;
        }
        v = make_uint4(h[0] | (unsigned(h[1]) << 16),
                       h[2] | (unsigned(h[3]) << 16),
                       h[4] | (unsigned(h[5]) << 16),
                       h[6] | (unsigned(h[7]) << 16));
      }
      reinterpret_cast<uint4*>(&rows[s][0])[c] = v;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      float a[T];
      float c[T];
      load_row<T>(&rows[s][ty * T], a);
      load_row<T>(&rows[s][tx * T], c);
#pragma unroll
      for (int i = 0; i < T; ++i) {
#pragma unroll
        for (int j = 0; j < T; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
      if (ty == 0) {
        const float rv = s_rat[s];
#pragma unroll
        for (int j = 0; j < T; ++j) accb[j] = fmaf(rv, c[j], accb[j]);
      }
    }
    __syncthreads();
  }

  float* Ae = A + e * w * w;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int row = ty * T + i;
    if (row < w) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int col = tx * T + j;
        if (col < w) Ae[row * w + col] = acc[i][j];
      }
    }
  }
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int col = tx * T + j;
      if (col < w) b[e * w + col] = accb[j];
    }
  }
}

template <int T>
int launch(const void* table, const void* idx, const void* rat, float* A,
           float* b, long long ne, int R, int w, long long n_rows, int idx64,
           cudaStream_t stream) {
  const auto* tb = static_cast<const __nv_bfloat16*>(table);
  const auto* rt = static_cast<const __nv_bfloat16*>(rat);
  const unsigned grid = static_cast<unsigned>(ne);
  if (idx64) {
    fused_gram_kernel<T, long long><<<grid, kThreads, 0, stream>>>(
        tb, static_cast<const long long*>(idx), rt, A, b, R, w, n_rows);
  } else {
    fused_gram_kernel<T, int><<<grid, kThreads, 0, stream>>>(
        tb, static_cast<const int*>(idx), rt, A, b, R, w, n_rows);
  }
  return cudaGetLastError();
}

}  // namespace

// table [n_rows, w] bf16, idx [ne, R] int32 or int64 (idx64), rat [ne, R]
// bf16 -> A [ne, w, w] f32, b [ne, w] f32.
extern "C" int ycnr_fused_gram(const void* table, const void* idx,
                               const void* rat, float* A, float* b,
                               long long ne, int R, int w, long long n_rows,
                               int idx64, cudaStream_t stream) {
  if (ne < 1 || ne > 0x7fffffffLL || R < 1 || w < 1 || w > kMaxW ||
      n_rows < 1) {
    return cudaErrorInvalidValue;
  }
  if (w % 8 == 0 && reinterpret_cast<unsigned long long>(table) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  switch ((w + kGrid - 1) / kGrid) {
    case 1: return launch<1>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 2: return launch<2>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 3: return launch<3>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 4: return launch<4>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 5: return launch<5>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 6: return launch<6>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    case 7: return launch<7>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                             stream);
    default: return launch<8>(table, idx, rat, A, b, ne, R, w, n_rows, idx64,
                              stream);
  }
}
