// K1: batched guarded SPD solve x = A^-1 b, one thread block per system.
//
// Replaces the TPU kernel ycnr_tpu/ops/pallas_solve.py:pallas_spd_solve
// (and the six variants it dispatches to): right-looking Cholesky
// A = L L^T with rsqrt pivots and no pivoting, then forward (L y = b) and
// back (L^T x = y) substitution. Callers have already added the ridge and
// the empty-slot guard and symmetrized A (ops/gram.guarded_batched_solve),
// so a padding system is I x = 0 and solves to exactly 0: every update
// subtracts a product with a zero right-hand side.
//
// What bounds it on Hopper: about n^3/3 FMA per system (the trailing
// updates below run over the full square, which keeps A symmetric so a
// column can be read as a row), all from shared memory, against n^2 * 4
// bytes of device-memory traffic (16 KB at n = 64). The work is
// latency-bound by the 3n block barriers of the column loop, not by bytes
// or FLOPs. This first design keeps one system per block so the card
// fills itself with many small blocks (13 resident per SM at n = 64) that
// hide each other's barrier latency; batching systems per block, wgmma and
// TMA are later work.
//
// Shared memory: A with a padded leading dimension n + 1, so that both
// row and column walks are free of bank conflicts, plus three n-vectors.
// n = 128 needs 67.5 KB, above the 48 KB default, so the launcher raises
// the dynamic shared-memory limit first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 128;

__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x, int n) {
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

}  // namespace

extern "C" int ycnr_spd_solve(const float* A, const float* b, float* x,
                              int batch, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t(n) * (n + 1) + 3 * size_t(n));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
  }
  spd_solve_kernel<<<batch, kThreads, smem, stream>>>(A, b, x, n);
  return cudaGetLastError();
}
