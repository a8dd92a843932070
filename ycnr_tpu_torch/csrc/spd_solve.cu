// K1: batched guarded SPD solve x = A^-1 b.
//
// Replaces the TPU kernel ycnr_tpu/ops/pallas_solve.py:pallas_spd_solve
// (and the six variants it dispatches to): a right-looking factorization
// without pivoting, columns in order, then forward and back substitution.
// Callers have already added the ridge and the empty-slot guard and
// symmetrized A (ops/fused_gram, ops/gram.guarded_batched_solve), so a
// padding system is I x = 0 and solves to exactly 0: every update
// subtracts a product with a zero factor.
//
// What bounds it on Hopper: bytes. A system at n = 64 is 16 KB of A read
// once against n^3/3 = 87k FMA, 5 FLOP a byte where the card's f32 pipes
// give 20; the least time is that of reading A. What stood in the way of
// that bound was neither: a block per system spent its time in 4n block
// barriers and in shared-memory loads and stores around every FMA.
//
// n <= 64 (the main path: rank 64), spd_solve_warp_kernel. One warp per
// system, no block barrier, the matrix in registers. Lane l owns columns
// l and l + 32 of the padded N x N matrix (N = 16, 32 or 64; identity
// padding): all N rows of each, plus one more row that holds b, so the
// forward substitution is just one more row of the elimination. Every
// loop is unrolled and every register index static.
//   Step j of the elimination needs row j of the trailing matrix in every
// lane. A is symmetric and stays so, so lane c finds its entry of that row
// in its own column (a[c][j]) and the lanes store the row to a per-warp
// slot of shared memory with one 4-byte store each, read it back with
// 16-byte broadcast loads and update their columns right of j over the
// whole square, a[c][r] -= row[r] * (a[c][j] / d_j): an LDL^T elimination,
// the same updates in the same order as the Cholesky it replaces with the
// square root left out. Holding only the triangle would save a sixth of
// the FMAs, but then column j exists in one lane only and that lane stores
// it alone, 17 dependent stores inside a divergent branch at the head of
// every step's latency chain: timed on the card (H100 80GB HBM3, 700 W,
// n 64, B 20,000), 0.45 ms for the triangle against 0.30 ms for the
// square. Step j hands row j + 1 on as soon as it is updated (three slots
// in turn, one __syncwarp a step), so that its trip through shared memory
// runs under the rest of step j's updates.
//   The back substitution runs from the same registers: the entries of
// column c below the diagonal are row c of the factor by symmetry, x_r
// goes round by one shuffle and every lane folds it into its own
// columns' sums.
//   A arrives by 16-byte cp.async into a per-warp staging buffer (4-byte
// copies where n * n is not a multiple of 4). Lane c reads its column as
// A[r][c]: at each r the lanes read consecutive words, without padding or
// bank conflicts. Once the columns are in registers the buffer is free,
// and the copy of the warp's next system (warps walk the batch with a
// stride of the grid's warps) runs under this system's factorization, as
// does the load of its b.
//   Per system at n = 64: ~3,600 FMA and ~600 16-byte shared loads a warp;
// 225 registers a thread without spills, so 8 warps an SM, 67 KB of shared
// memory a block of 4 warps. What holds it now is the chain of a step
// (reciprocal, row j + 1, store, load: ~230 cycles) with two warps a
// scheduler to hide it.
//
// 64 < n <= 128, spd_solve_block_kernel: one block of 128 threads per
// system with A in padded shared memory and a barrier per step (Cholesky
// with rsqrt pivots). The main path (rank 64) does not reach it.
//
// 128 < n <= 256, spd_solve_packed_kernel: one block of 256 threads per
// system. A full n x n f32 square is 256 KB at n = 256, above the 227 KB a
// block may use, so the block keeps only the lower triangle, packed column
// by column (packed_index): n (n + 1) / 2 floats, 129 KB at n = 256 and
// 74 KB at n = 192. Column c of the triangle is row c of A from the
// diagonal on (A is symmetric), one contiguous run in both places, so A
// arrives by 4-byte cp.async without a transpose. The factorization is a
// right-looking Cholesky in panels of 8 columns. A panel is factored
// left-looking, thread t holding row t of it in registers: column j needs
// the pivot, row j's entries of the panel's earlier columns and one block
// barrier. Then the trailing triangle loses the panel's rank-8 product in
// blocks of 32 rows: a lane keeps its row's 8 values in registers, and the
// 8 values of a column (a row of the panel copy, 32 bytes) reach every lane
// at once, so an element costs one shared load and one store for 8 FMAs,
// and a panel one barrier. Then the forward and back substitutions, thread
// t holding row t, one barrier a step. A padding system I x = 0 solves to
// exactly 0.
//   What holds it: barriers and latency, not device memory: n + n / 8
// barriers to factor and 2n to substitute, one block an SM at n = 256 and
// two at n = 192. Timed on the card (H100 80GB HBM3, 700 W, B 20,000):
// 11.7 ms at n = 192 and 33.4 ms at n = 256, against 26.4 and 76.7 ms for
// a first body that updated the trailing triangle one column at a time
// (two shared loads and a store an FMA, 2n barriers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockMaxN = 128;  // spd_solve_block_kernel: a thread a row
constexpr int kPackedThreads = 256;
constexpr int kPackedWarps = kPackedThreads / 32;
constexpr int kMaxN = kPackedThreads;  // spd_solve_packed_kernel: the same
constexpr int kPanel = 8;  // spd_solve_packed_kernel: columns a panel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
struct WarpCfg {
  static constexpr int kNC = (N + 31) / 32;  // columns per lane
  static constexpr int kCol = 32 * kNC;      // a row slot: a word per column
  static constexpr int kWarpFloats = N * N + 3 * kCol;
  static constexpr int kSmem = kWarps * kWarpFloats * 4;
  // resident blocks per SM the register and shared-memory budgets allow
  static constexpr int kBlocks = N == 64 ? 2 : 8;
};

template <int N>
__global__ void __launch_bounds__(kThreads, WarpCfg<N>::kBlocks)
spd_solve_warp_kernel(const float* __restrict__ A,
                      const float* __restrict__ b, float* __restrict__ x,
                      int batch, int n, int vec) {
  using C = WarpCfg<N>;
  constexpr int NC = C::kNC;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = smem + warp * C::kWarpFloats;  // A of one system, [n][n]
  float* slots = stage + N * N;                 // three row slots in turn
  const int stride = gridDim.x * kWarps;
  const int nn = n * n;

  auto fetch = [&](long long s) {
    const float* src = A + s * nn;
    if (vec) {
      for (int i = lane; i < nn / 4; i += 32) {
        cp_async16(stage + 4 * i, src + 4 * i);
      }
    } else {
      for (int i = lane; i < nn; i += 32) cp_async4(stage + i, src + i);
    }
  };
  auto load_b = [&](long long s, float (&v)[NC]) {
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = lane + 32 * q;
      v[q] = c < n ? b[s * n + c] : 0.0f;
    }
  };

  long long sys = blockIdx.x * kWarps + warp;
  float nb[NC];
  if (sys < batch) {
    fetch(sys);
    load_b(sys, nb);
  }
  while (sys < batch) {
    cp_async_commit_wait_all();
    __syncwarp();
    // a[q][r] = A[r][c] for column c = lane + 32 q; a[q][N] = b[c]
    float a[NC][N + 1];
    if (n == N) {  // every offset a constant
#pragma unroll
      for (int q = 0; q < NC; ++q) {
#pragma unroll
        for (int r = 0; r < N; ++r) a[q][r] = stage[r * N + lane + 32 * q];
      }
    } else {  // identity padding
      const float* p = stage + lane;
#pragma unroll
      for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int c = lane + 32 * q;
          a[q][r] = r == c ? 1.0f : 0.0f;
          if (r < n && c < n) a[q][r] = p[32 * q];
        }
        p += n;
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) a[q][N] = nb[q];
    __syncwarp();
    const long long next = sys + stride;
    if (next < batch) {  // runs under this system's factorization
      fetch(next);
      load_b(next, nb);
    }

    // Row 0 goes round first; then step j hands row j + 1 on as soon as
    // it is updated, and updates the rest while that travels.
    float dinv[NC];  // 1 / d of this lane's columns, kept at their steps
    float m[NC];     // row j of this lane's columns right of j, over d_j
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      dinv[q] = 0.0f;
      slots[lane + 32 * q] = a[q][0];
    }
    __syncwarp();
    float invd = __frcp_rn(slots[0]);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = lane + 32 * q;
      m[q] = (c > 0 && c < N) ? a[q][0] * invd : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int qj = j >> 5;
      const int qn = (j + 1) >> 5;
      const float* cb = slots + (j % 3) * C::kCol;
      float* nx = slots + ((j + 1) % 3) * C::kCol;
      if (lane == (j & 31)) dinv[qj] = invd;
      // the forward substitution's row: z_j from the owner of column j
      const float z = __shfl_sync(kFull, a[qj][N], j & 31);
      float dn = 1.0f;
      if (j + 1 < N) {
        const float l = cb[j + 1];
#pragma unroll
        for (int q = qj; q < NC; ++q) {
          a[q][j + 1] = fmaf(-l, m[q], a[q][j + 1]);
        }
#pragma unroll
        for (int q = qn; q < NC; ++q) nx[lane + 32 * q] = a[q][j + 1];
        __syncwarp();
        dn = nx[j + 1];
      }
#pragma unroll
      for (int r4 = (j + 2) & ~3; r4 < N; r4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cb + r4);
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r4 + u;
          if (r >= j + 2) {
#pragma unroll
            for (int q = qj; q < NC; ++q) {
              a[q][r] = fmaf(-l[u], m[q], a[q][r]);
            }
          }
        }
      }
#pragma unroll
      for (int q = qj; q < NC; ++q) a[q][N] = fmaf(-z, m[q], a[q][N]);
      if (j + 1 < N) {
        invd = __frcp_rn(dn);
#pragma unroll
        for (int q = qn; q < NC; ++q) {
          const int c = lane + 32 * q;
          m[q] = (c > j + 1 && c < N) ? a[q][j + 1] * invd : 0.0f;
        }
      }
    }

    // Back substitution: x_c = (z_c - sum_{r > c} a[c][r] x_r) / d_c.
    float acc[NC], xs[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      acc[q] = a[q][N];
      xs[q] = 0.0f;
    }
#pragma unroll
    for (int r = N - 1; r >= 0; --r) {
      const int qr = r >> 5;
      const float xr = __shfl_sync(kFull, acc[qr] * dinv[qr], r & 31);
      if (lane == (r & 31)) xs[qr] = xr;
#pragma unroll
      for (int q = 0; q <= qr; ++q) {
        if (lane + 32 * q < r) acc[q] = fmaf(-a[q][r], xr, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = lane + 32 * q;
      if (c < n) x[sys * n + c] = xs[q];
    }
    sys = next;
  }
}

__global__ void __launch_bounds__(kThreads)
spd_solve_block_kernel(const float* __restrict__ A,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n) {
  extern __shared__ float smem[];
  const int lda = n + 1;
  float* S = smem;                 // [n][lda]: working copy, then L^T rows
  float* col = S + n * lda;        // scaled column j of the factor
  float* invd = col + n;           // 1 / L[j][j]
  float* y = invd + n;             // broadcast slot for the substitutions

  const int t = threadIdx.x;
  const long long sys = blockIdx.x;
  const float* Ab = A + sys * n * n;

  for (int idx = t; idx < n * n; idx += kThreads) {
    S[(idx / n) * lda + idx % n] = Ab[idx];
  }
  __syncthreads();

  // Trailing-update ownership: thread t owns column c = t % n over the rows
  // r0, r0 + rstep, ... (threads past rstep * n idle in the update).
  const int rstep = kThreads / n;
  const int c = t % n;
  const int r0 = t / n;

  for (int j = 0; j < n; ++j) {
    // Row j equals column j (S stays symmetric). Every thread reads the
    // pivot; only entries right of the diagonal are written, so the pivot
    // is never overwritten while another warp still reads it.
    const float inv = rsqrtf(S[j * lda + j]);
    if (t == j) invd[j] = inv;
    if (t > j && t < n) {
      const float v = S[j * lda + t] * inv;
      col[t] = v;
      S[j * lda + t] = v;  // L[t][j], stored as row j of L^T
    }
    __syncthreads();
    if (r0 < rstep && c > j) {
      const float lc = col[c];
      for (int r = j + 1 + r0; r < n; r += rstep) {
        S[r * lda + c] -= col[r] * lc;
      }
    }
    __syncthreads();
  }

  // Forward substitution L y = b, one row per thread, column order.
  float acc = (t < n) ? b[sys * n + t] : 0.0f;
  for (int j = 0; j < n; ++j) {
    if (t == j) {
      acc *= invd[j];
      y[j] = acc;
    }
    __syncthreads();
    if (t > j && t < n) acc -= S[j * lda + t] * y[j];
  }
  __syncthreads();
  // Back substitution L^T x = y. L[j][t] for t < j sits at row t, column j.
  for (int j = n - 1; j >= 0; --j) {
    if (t == j) {
      acc *= invd[j];
      col[j] = acc;
    }
    __syncthreads();
    if (t < j) acc -= S[t * lda + j] * col[j];
  }
  if (t < n) x[sys * n + t] = acc;
}

// Offset of entry (r, c), r >= c, of an n x n lower triangle packed column
// by column: column c holds rows c .. n - 1 and starts at c (2n - c + 1) / 2.
__device__ __forceinline__ int packed_index(int r, int c, int n) {
  return c * (2 * n - c + 1) / 2 + (r - c);
}

// Shared memory of spd_solve_packed_kernel, in floats: the packed triangle
// (rounded up to 16 bytes), the panel's columns row by row, 1 / L[j][j].
__host__ __device__ __forceinline__ int packed_tri_floats(int n) {
  return (n * (n + 1) / 2 + 3) & ~3;
}

__global__ void __launch_bounds__(kPackedThreads)
spd_solve_packed_kernel(const float* __restrict__ A,
                        const float* __restrict__ b, float* __restrict__ x,
                        int n) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                        // packed lower triangle of A, then L
  float* Lp = smem + packed_tri_floats(n);  // [n][kPanel]: L[r][j0 + q]
  float* invd = Lp + n * kPanel;          // 1 / L[j][j]
  float* y = Lp;                          // the substitutions' slots, after

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long sys = blockIdx.x;
  const float* Ab = A + sys * n * n;

  for (int c = 0; c < n; ++c) {
    const int len = n - c;
    float* dst = S + packed_index(c, c, n);
    const float* src = Ab + c * n + c;
    for (int i = t; i < len; i += kPackedThreads) cp_async4(dst + i, src + i);
  }
  cp_async_commit_wait_all();
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int pw = n - j0 < kPanel ? n - j0 : kPanel;
    // The panel, columns j0 .. j0 + pw - 1, left-looking: thread t holds
    // row t of it in registers; column j needs L[j][j0 .. j - 1] (Lp, from
    // the earlier columns) and one barrier.
    float lt[kPanel];
#pragma unroll
    for (int q = 0; q < kPanel; ++q) {
      lt[q] = 0.0f;
      if (q < pw) {  // the same for every thread
        const int j = j0 + q;
        const float* lj = Lp + j * kPanel;
        float d = S[packed_index(j, j, n)];
#pragma unroll
        for (int p = 0; p < q; ++p) d = fmaf(-lj[p], lj[p], d);
        const float inv = rsqrtf(d);
        if (t == j) invd[j] = inv;
        if (t > j && t < n) {
          float v = S[packed_index(t, j, n)];
#pragma unroll
          for (int p = 0; p < q; ++p) v = fmaf(-lt[p], lj[p], v);
          v *= inv;
          lt[q] = v;
          S[packed_index(t, j, n)] = v;  // L[t][j]
          Lp[t * kPanel + q] = v;
        }
        __syncthreads();
      }
    }
    // The trailing triangle minus the panel's rank-8 product, in blocks of
    // 32 rows: lane l holds row r0 + l's eight L values in registers, warp
    // w takes the columns c0 + w, c0 + w + 8, ... (two at a time), whose
    // eight values every lane reads at once. (After the last, narrower
    // panel nothing is left to update.)
    const int c0 = j0 + kPanel;
    if (pw == kPanel && c0 < n) {
      for (int r0 = c0; r0 < n; r0 += 32) {
        const int r = r0 + lane;
        float lr[kPanel];
        if (r < n) {
          const float* lp = Lp + r * kPanel;
          const float4 u = *reinterpret_cast<const float4*>(lp);
          const float4 v = *reinterpret_cast<const float4*>(lp + 4);
          lr[0] = u.x; lr[1] = u.y; lr[2] = u.z; lr[3] = u.w;
          lr[4] = v.x; lr[5] = v.y; lr[6] = v.z; lr[7] = v.w;
        } else {
#pragma unroll
          for (int p = 0; p < kPanel; ++p) lr[p] = 0.0f;
        }
        const int cend = r0 + 32 < n ? r0 + 32 : n;  // columns c <= r
        for (int c = c0 + warp; c < cend; c += 2 * kPackedWarps) {
          const int c2 = c + kPackedWarps;
          const int cc[2] = {c, c2 < cend ? c2 : c};
          float lc[2][kPanel], old[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 u =
                *reinterpret_cast<const float4*>(Lp + cc[k] * kPanel);
            const float4 v =
                *reinterpret_cast<const float4*>(Lp + cc[k] * kPanel + 4);
            lc[k][0] = u.x; lc[k][1] = u.y; lc[k][2] = u.z; lc[k][3] = u.w;
            lc[k][4] = v.x; lc[k][5] = v.y; lc[k][6] = v.z; lc[k][7] = v.w;
            old[k] = (r < n && r >= cc[k]) ? S[packed_index(r, cc[k], n)]
                                           : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (k == 1 && c2 >= cend) break;
            float acc = lr[0] * lc[k][0];
#pragma unroll
            for (int p = 1; p < kPanel; ++p) {
              acc = fmaf(lr[p], lc[k][p], acc);
            }
            if (r < n && r >= cc[k]) {
              S[packed_index(r, cc[k], n)] = old[k] - acc;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // Forward substitution L z = b, thread t holding row t, column order.
  float acc = t < n ? b[sys * n + t] : 0.0f;
  for (int j = 0; j < n; ++j) {
    if (t == j) {
      acc *= invd[j];
      y[j] = acc;
    }
    __syncthreads();
    if (t > j && t < n) acc = fmaf(-S[packed_index(t, j, n)], y[j], acc);
  }
  __syncthreads();
  // Back substitution L^T x = z: x_j folds into every row t < j through
  // L[j][t].
  for (int j = n - 1; j >= 0; --j) {
    if (t == j) {
      acc *= invd[j];
      y[j] = acc;
    }
    __syncthreads();
    if (t < j) acc = fmaf(-S[packed_index(j, t, n)], y[j], acc);
  }
  if (t < n) x[sys * n + t] = acc;
}

template <int N>
int launch_warp(const float* A, const float* b, float* x, int batch, int n,
                cudaStream_t stream) {
  using C = WarpCfg<N>;
  auto kern = spd_solve_warp_kernel<N>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // one system a warp until the card is full, then warps walk the batch
  const int want = (batch + kWarps - 1) / kWarps;
  const int grid = want < sms * C::kBlocks ? want : sms * C::kBlocks;
  const int vec = (n * n) % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(A) % 16 == 0;
  kern<<<grid, kThreads, C::kSmem, stream>>>(A, b, x, batch, n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ycnr_spd_solve(const float* A, const float* b, float* x,
                              int batch, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return cudaErrorInvalidValue;
  if (n <= 16) return launch_warp<16>(A, b, x, batch, n, stream);
  if (n <= 32) return launch_warp<32>(A, b, x, batch, n, stream);
  if (n <= 64) return launch_warp<64>(A, b, x, batch, n, stream);
  if (n <= kBlockMaxN) {
    const size_t smem =
        sizeof(float) * (size_t(n) * (n + 1) + 3 * size_t(n));
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          spd_solve_block_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return e;
    }
    spd_solve_block_kernel<<<batch, kThreads, smem, stream>>>(A, b, x, n);
    return cudaGetLastError();
  }
  const size_t smem =
      sizeof(float) * (size_t(packed_tri_floats(n)) + (kPanel + 1) * n);
  cudaError_t e = cudaFuncSetAttribute(
      spd_solve_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  spd_solve_packed_kernel<<<batch, kPackedThreads, smem, stream>>>(A, b, x,
                                                                   n);
  return cudaGetLastError();
}
