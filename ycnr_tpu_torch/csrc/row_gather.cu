// Indexed row gather: out[r, :] = table[idx[r], :], and its 2-D-index form
// out[i, j] = table[idx2[i, j], j] (take-along-axis over rows).
//
// Replaces the five TPU gathers of the JAX package's probes, which compute
// the one function table[idx] five ways for the TPU's memory system:
// tools/probe_gather.py:pallas_loop_gather (T1, per-row VMEM copy loop),
// :pallas_take_gather (T2, whole-tile jnp.take), :pallas_taa_gather (T3,
// take_along_axis with row-broadcast 2-D indices: ycnr_take_along_rows
// below), tools/bench_pallas_gather.py:pallas_vmem_gather (T5, both
// bodies) and :pallas_hbm_dma_gather (T6, per-row DMA with the table left
// in HBM). On the device path it is the gather of the epoch
// (ycnr_tpu/ops/gram.py:128, models/bucketed_phase.py) and of fold-in
// (ycnr_tpu/serve/fold_in.py:42).
//
// What bounds it on Hopper: bytes. A gather reads and writes each row
// once, with no arithmetic; the factor tables of the ALS epoch (3.4-35 MB)
// sit in the 50 MB L2, so the write of the gathered rows to device memory
// and the latency of the scattered row reads are the cost. The TPU kernels
// needed the table resident in VMEM, or one DMA descriptor per row; here
// the hardware caches do that, and the design only has to keep enough
// independent 16-byte loads in flight: a row is cut into 16-byte vectors
// (narrower where the row width or the alignment forbids), neighbouring
// threads copy neighbouring vectors of a row, and every thread issues up
// to kVecPerThread loads before its first store. A block stages its own
// indices in shared memory once (the TPU kernels' scalar prefetch).
//
// An index outside [0, n_rows) stops the kernel with a trap (the launch
// then reports an error), as PyTorch's own indexing stops on a device-side
// assert; nothing is read out of bounds.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // 16-byte loads in flight per thread
constexpr int kTakeRuns = 2;      // take_along_rows: runs per thread
constexpr long long kTakeMaxBlocks = 132LL * 64;

template <typename Vec, typename Idx>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const Vec* __restrict__ table, const Idx* __restrict__ idx,
                  Vec* __restrict__ out, long long m, long long n_rows,
                  int vpr, int rows_per_block) {
  extern __shared__ long long s_idx[];  // [rows_per_block]
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nr = static_cast<int>(
      min(static_cast<long long>(rows_per_block), m - r0));
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const long long r = static_cast<long long>(idx[r0 + i]);
    if (r < 0 || r >= n_rows) __trap();
    s_idx[i] = r;
  }
  __syncthreads();
  const int total = nr * vpr;
  const Vec* src = table;
  Vec* dst = out + r0 * vpr;
  for (int base = threadIdx.x; base < total;
       base += kThreads * kVecPerThread) {
    Vec v[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int q = base + u * kThreads;
      if (q < total) {
        const int r = q / vpr;
        v[u] = src[s_idx[r] * vpr + (q - r * vpr)];
      }
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int q = base + u * kThreads;
      if (q < total) dst[q] = v[u];
    }
  }
}

template <typename Vec, typename Idx>
int launch_rows(const void* table, const void* idx, void* out, long long m,
                long long n_rows, int row_bytes, cudaStream_t stream) {
  const int vpr = row_bytes / static_cast<int>(sizeof(Vec));
  const int rows_per_block = std::max(1, kThreads * kVecPerThread / vpr);
  const long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_gather_kernel<Vec, Idx>
      <<<static_cast<unsigned>(blocks), kThreads,
         sizeof(long long) * rows_per_block, stream>>>(
          static_cast<const Vec*>(table), static_cast<const Idx*>(idx),
          static_cast<Vec*>(out), m, n_rows, vpr, rows_per_block);
  return cudaGetLastError();
}

template <typename Idx>
int dispatch_rows(const void* table, const void* idx, void* out, long long m,
                  long long n_rows, int row_bytes, cudaStream_t stream) {
  // the widest vector that divides the row and both base addresses
  const unsigned long long a =
      reinterpret_cast<unsigned long long>(table) |
      reinterpret_cast<unsigned long long>(out) |
      static_cast<unsigned long long>(row_bytes);
  if (a % 16 == 0)
    return launch_rows<uint4, Idx>(table, idx, out, m, n_rows, row_bytes,
                                   stream);
  if (a % 8 == 0)
    return launch_rows<uint2, Idx>(table, idx, out, m, n_rows, row_bytes,
                                   stream);
  if (a % 4 == 0)
    return launch_rows<unsigned int, Idx>(table, idx, out, m, n_rows,
                                          row_bytes, stream);
  if (a % 2 == 0)
    return launch_rows<unsigned short, Idx>(table, idx, out, m, n_rows,
                                            row_bytes, stream);
  return launch_rows<unsigned char, Idx>(table, idx, out, m, n_rows,
                                         row_bytes, stream);
}

// T3's form, out[i, j] = table[idx2[i, j], j], over the flat [m * c]
// output. With int64 indices and 2-byte elements the index bytes are 80%
// of the traffic, so the bound is m * c * (index + element bytes) and the
// design moves those bytes in 16-byte pieces: each thread makes a run of
// 16 bytes of output (V = 8 bf16 or 4 f32 consecutive flat elements),
// reads the run's V indices with 16-byte vector loads, and stores the run
// with one 16-byte store. When the run's indices are all equal and its
// columns are consecutive and 16-byte aligned in one table row (the
// row-broadcast indices T3 uses), the table read is one 16-byte load too;
// otherwise one load per element. Every thread keeps kTakeRuns runs
// in flight before its first store. The last m * c % V elements are a
// scalar edge (block 0). Needs 16-byte aligned bases; the scalar kernel
// below takes the rest.
template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
take_along_rows_vec_kernel(const T* __restrict__ table,
                           const Idx* __restrict__ idx2, T* __restrict__ out,
                           long long total, int c, int w, long long n_rows) {
  constexpr int V = 16 / sizeof(T);                   // elements per run
  constexpr int kIdxVecs = V * sizeof(Idx) / 16;      // index loads per run
  const long long nruns = total / V;
  const uint4* iv = reinterpret_cast<const uint4*>(idx2);
  // a block takes kTakeRuns * kThreads consecutive runs, thread j the
  // runs j, j + kThreads, ...: all in flight before the first store
  const long long step = static_cast<long long>(gridDim.x) * kThreads *
                         kTakeRuns;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads *
                            kTakeRuns + threadIdx.x;
       base < nruns; base += step) {
    uint4 raw[kTakeRuns][kIdxVecs];
#pragma unroll
    for (int u = 0; u < kTakeRuns; ++u) {
      const long long q = base + u * kThreads;
      if (q < nruns) {
#pragma unroll
        for (int k = 0; k < kIdxVecs; ++k) raw[u][k] = iv[q * kIdxVecs + k];
      }
    }
    uint4 v[kTakeRuns];
#pragma unroll
    for (int u = 0; u < kTakeRuns; ++u) {
      const long long q = base + u * kThreads;
      if (q < nruns) {
        const Idx* ix = reinterpret_cast<const Idx*>(raw[u]);
        bool same = true;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (static_cast<unsigned long long>(ix[k]) >=
              static_cast<unsigned long long>(n_rows)) {
            __trap();
          }
          same = same && ix[k] == ix[0];
        }
        const long long e0 = q * V;
        const int j0 = static_cast<int>(e0 % c);
        const long long a0 = static_cast<long long>(ix[0]) * w + j0;
        if (same && j0 + V <= c && a0 % V == 0) {
          v[u] = *reinterpret_cast<const uint4*>(table + a0);
        } else {
          union {
            uint4 vec;
            T x[V];
          } pk;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            int j = j0 + k;
            while (j >= c) j -= c;
            pk.x[k] = table[static_cast<long long>(ix[k]) * w + j];
          }
          v[u] = pk.vec;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTakeRuns; ++u) {
      const long long q = base + u * kThreads;
      if (q < nruns) reinterpret_cast<uint4*>(out)[q] = v[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < total - nruns * V) {
    const long long q = nruns * V + threadIdx.x;
    const long long r = static_cast<long long>(idx2[q]);
    if (r < 0 || r >= n_rows) __trap();
    out[q] = table[r * w + (q % c)];
  }
}

// The scalar form, for bases that are not 16-byte aligned: one thread per
// output element.
template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
take_along_rows_kernel(const T* __restrict__ table,
                       const Idx* __restrict__ idx2, T* __restrict__ out,
                       long long total, int c, int w, long long n_rows) {
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       q < total; q += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = static_cast<long long>(idx2[q]);
    if (r < 0 || r >= n_rows) __trap();
    out[q] = table[r * w + (q % c)];
  }
}

template <typename T, typename Idx>
int launch_take(const void* table, const void* idx2, void* out,
                long long total, int c, int w, long long n_rows,
                cudaStream_t stream) {
  const auto* tb = static_cast<const T*>(table);
  const auto* ix = static_cast<const Idx*>(idx2);
  auto* o = static_cast<T*>(out);
  const unsigned long long a = reinterpret_cast<unsigned long long>(table) |
                               reinterpret_cast<unsigned long long>(idx2) |
                               reinterpret_cast<unsigned long long>(out);
  if (a % 16 == 0) {
    const long long per_block = static_cast<long long>(kThreads) * kTakeRuns;
    const long long runs = total / (16 / sizeof(T));
    const unsigned blocks = static_cast<unsigned>(std::max(
        1LL, std::min((runs + per_block - 1) / per_block, kTakeMaxBlocks)));
    take_along_rows_vec_kernel<T, Idx><<<blocks, kThreads, 0, stream>>>(
        tb, ix, o, total, c, w, n_rows);
  } else {
    const unsigned blocks = static_cast<unsigned>(
        std::min((total + kThreads - 1) / kThreads, 132LL * 64));
    take_along_rows_kernel<T, Idx><<<blocks, kThreads, 0, stream>>>(
        tb, ix, o, total, c, w, n_rows);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch_take(const void* table, const void* idx2, void* out,
                  long long total, int c, int w, long long n_rows, int idx64,
                  cudaStream_t stream) {
  return idx64 ? launch_take<T, long long>(table, idx2, out, total, c, w,
                                           n_rows, stream)
               : launch_take<T, int>(table, idx2, out, total, c, w, n_rows,
                                     stream);
}

}  // namespace

// table [n_rows, row_bytes] (any element type), idx [m] int32 or int64
// (idx64), out [m, row_bytes].
extern "C" int ycnr_row_gather(const void* table, const void* idx, void* out,
                               long long m, long long n_rows, int row_bytes,
                               int idx64, cudaStream_t stream) {
  if (m < 1 || n_rows < 1 || row_bytes < 1) return cudaErrorInvalidValue;
  return idx64 ? dispatch_rows<long long>(table, idx, out, m, n_rows,
                                          row_bytes, stream)
               : dispatch_rows<int>(table, idx, out, m, n_rows, row_bytes,
                                    stream);
}

// table [n_rows, w] of elem_bytes (2 or 4) elements, idx2 [m, c] with
// c <= w, out [m, c]: out[i, j] = table[idx2[i, j], j].
extern "C" int ycnr_take_along_rows(const void* table, const void* idx2,
                                    void* out, long long m, int c, int w,
                                    long long n_rows, int elem_bytes,
                                    int idx64, cudaStream_t stream) {
  if (m < 1 || c < 1 || c > w || n_rows < 1) return cudaErrorInvalidValue;
  const long long total = m * c;
  if (elem_bytes == 2)
    return dispatch_take<unsigned short>(table, idx2, out, total, c, w,
                                         n_rows, idx64, stream);
  if (elem_bytes == 4)
    return dispatch_take<unsigned int>(table, idx2, out, total, c, w, n_rows,
                                       idx64, stream);
  return cudaErrorInvalidValue;
}
