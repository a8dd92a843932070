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
// 64 < n <= 256, spd_solve_tiled_kernel: one block a system. It replaces
// both of the TPU kernel's wide variants (pallas_solve.py:355 dispatches n
// <= 128 to static_hbm, larger n to panel).
//   What bounds it: operations. A is symmetric (the callers symmetrize
// it), so the least a solve reads is its lower triangle, n (n + 1) / 2
// floats, against n^3 / 3 + 2 n^2 flops: 21 flops a byte at n = 128 and
// 43 at n = 256, above the 20 at which the f32 pipes, not the memory,
// are the limit. At B = 20,000 that is 0.218 / 0.726 / 1.709 ms at n =
// 128 / 192 / 256 (bytes: 0.203 / 0.452 / 0.798). The FMAs run on the
// CUDA cores in f32: TF32 would break the float64 contract the solve is
// held to, and 3xTF32 loses about 2 bits a product against it.
//   Storage: the padded matrix (N = NT T, identity on the diagonal past n,
// zeros elsewhere; b padded with 0, so the padding solves to exactly 0)
// as its lower T x T tiles only, tile (i, j), i >= j, at i (i + 1) / 2 + j,
// each contiguous with rows kTileLd = T + 4 floats apart, so that the 16-
// byte rows of 8 lanes fall in 8 different bank quads. With b, z and x,
// 1 / L[j][j] and three pivot slots, T = 32 takes 48 KB a block at n =
// 128 (4 blocks an SM), 99 KB at 192 (2), 169 KB at 256 (1).
//   Loading: each tile comes straight from A's rows by 16-byte cp.async
// (4-byte copies where n % 4 or A's base forbids 16), only the lower
// tiles, n (n + T) / 2 floats; the warp that first works on a tile copies
// it, in three groups (the first diagonal tile, the first panel, the
// first trailing update), and waits only for its own before using it, so
// the later tiles arrive while the first diagonal tile is factored.
//   Factorization: right-looking, a tile column a step. (a) T lanes of
// warp 0 factor the diagonal tile in registers, a row a lane, in the warp
// body's LDL^T scheme (the pivot column handed on through three shared
// slots, one __syncwarp a column, no block barrier, MUFU reciprocals),
// carrying b's tile as the forward substitution, and write L_kk^T into
// the tile's upper half, 1 / L[j][j] and z_k. (b) A row a lane, the tiles
// below it become L_ik = A_ik L_kk^-T (a forward substitution with L_kk
// from broadcast 16-byte loads), stored transposed in place, and b's tile
// i loses L_ik z_k; the next free lane group solves the identity the same
// way, L_kk^-1 into the tile's lower half. (c) Warps 1 .. NT - 1 take
// whole tiles of the trailing update A_ij -= L_ik L_jk^T, a lane a 4 x 8
// block in registers fed by three 16-byte loads for 32 FMAs (an update a
// column at a time takes two loads and a store an FMA). Warp 0 solves panel tile (k+1,
// k) in (b), which is all that the next diagonal tile needs, so it
// arrives on a named barrier and at once updates and factors tile (k+1,
// k+1) while the others finish their panels and update: the chain of
// diagonal factorizations is the block's critical path, and at n = 256 no
// other block shares the SM to hide it. One block barrier and one named
// barrier a step.
//   Back substitution by tiles: the lanes of tile slot j hold y_j; x_i =
// L_ii^-T y_i is one product with the stored inverse, then the tiles
// above fold x_i in: one block barrier a tile. 3 NT barriers a system in
// all: 24 at n = 256, where a barrier a column and a substitution row
// would take ~800.
//   NT warps a block (8 at n = 256): a tile slot a warp in (b) and in the
// back substitution.
//   Timed on the card (NVIDIA H100 80GB HBM3, 700 W; ycnr_tpu_torch/
// tools/bench_solve_score.py, B = 20,000, one call): T = 32 takes 0.90 /
// 1.44 / 3.56 / 8.55 ms at n = 96 / 128 / 192 / 256; a build of this body
// at T = 16 (a tile a half warp, a 2 x 4 block a lane; not kept) took
// 0.68 / 1.32 / 4.57 / 14.75: 8-24% faster up to n = 128 and 28-72%
// slower above (twice the tile columns, so twice the chain of barriers
// and panels), so T = 32 at every n. The thread count follows from the
// slots (NT warps) and was not timed against another. What holds it (a
// build with clock64() counters around each phase, not kept; n = 256, one
// block an SM): 117k cycles a system, of which warp 0's chain takes 95k
// (the 8 diagonal factorizations 43k, its 8 panel tiles 29k, 7
// diagonal-tile updates 23k) while the other warps wait 14k at barriers;
// at n = 128 four blocks share an SM, each 104k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // spd_solve_warp_kernel
constexpr int kWarps = kThreads / 32;
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

// ---------------------------------------------------------------------------
// spd_solve_tiled_kernel (64 < n <= 256): the note at the top.

constexpr int kTile = 32;  // T: tiles are T x T, lane q holds tile row q
constexpr int kTileLd = kTile + 4;  // floats from a tile row to the next
constexpr int kMaxN = 256;

template <int NT>
struct TiledCfg {
  static constexpr int kN = NT * kTile;  // the padded size
  static constexpr int kWarps = NT;  // a tile slot a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTiles = NT * (NT + 1) / 2;  // the lower tiles
  static constexpr int kTileFloats = kTile * kTileLd;
  // the tiles; b (then z, then y), 1 / L[j][j] and x; three pivot slots
  static constexpr int kSmem =
      4 * (kTiles * kTileFloats + 3 * kN + 3 * kTile);
  // blocks an SM the shared memory allows (228 KB an SM, 1 KB of it
  // reserved a block), at most 16 warps an SM: ~93 registers a thread
  // without spills (ptxas -v)
  static constexpr int kSmemBlocks = 233472 / (kSmem + 1024);
  static constexpr int kBlocks =
      kSmemBlocks < 16 / kWarps ? kSmemBlocks : 16 / kWarps;
};

// K floats from or to 16-byte aligned shared memory by 16-byte accesses
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&v)[K]) {
  static_assert(K % 4 == 0, "whole 16-byte words");
#pragma unroll
  for (int t = 0; t < K; t += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + t);
    v[t] = w.x; v[t + 1] = w.y; v[t + 2] = w.z; v[t + 3] = w.w;
  }
}

template <int K>
__device__ __forceinline__ void sts(float* p, const float (&v)[K]) {
  static_assert(K % 4 == 0, "whole 16-byte words");
#pragma unroll
  for (int t = 0; t < K; t += 4) {
    *reinterpret_cast<float4*>(p + t) =
        make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A named barrier besides __syncthreads' 0: warp 0 arrives, the others
// wait.
constexpr int kPanelsDone = 1;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int NT>
__global__ void __launch_bounds__(TiledCfg<NT>::kThreads,
                                  TiledCfg<NT>::kBlocks)
spd_solve_tiled_kernel(const float* __restrict__ A,
                       const float* __restrict__ b, float* __restrict__ x,
                       int n, int vec) {
  using C = TiledCfg<NT>;
  constexpr int T = kTile, LD = kTileLd, W = C::kWarps;
  constexpr int RM = 4, CM = 8;  // a lane's block of a tile update
  extern __shared__ __align__(16) float smem[];
  float* const bs = smem + C::kTiles * C::kTileFloats;  // b -> z -> y
  float* const invl = bs + C::kN;                       // 1 / L[j][j]
  float* const xs = invl + C::kN;                       // x
  float* const slots = xs + C::kN;  // (a)'s pivot columns, three in turn
  const int lane = threadIdx.x & 31;
  const int q = lane;                 // the tile row this lane holds
  const int warp = threadIdx.x >> 5;  // its tile slot
  const long long sys = blockIdx.x;
  const float* As = A + sys * n * n;

  auto tile = [&](int i, int j) {
    return smem + (i * (i + 1) / 2 + j) * C::kTileFloats;
  };

  // Tile (i, j) of the padded A by one warp: cp.async from A's rows,
  // identity past n.
  auto load_tile = [&](int i, int j) {
    float* dst = tile(i, j);
    if (vec) {
      constexpr int CH = T / 4;  // 16-byte chunks a tile row
      for (int e = lane; e < T * CH; e += 32) {
        const int r = e / CH, c = 4 * (e % CH);
        const int gr = i * T + r, gc = j * T + c;
        float* d = dst + r * LD + c;
        if (gr < n && gc < n) {
          cp_async16(d, As + static_cast<long long>(gr) * n + gc);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v) d[v] = gr == gc + v ? 1.0f : 0.0f;
        }
      }
    } else {
      for (int e = lane; e < T * T; e += 32) {
        const int r = e / T, c = e % T;
        const int gr = i * T + r, gc = j * T + c;
        float* d = dst + r * LD + c;
        if (gr < n && gc < n) {
          cp_async4(d, As + static_cast<long long>(gr) * n + gc);
        } else {
          *d = gr == gc ? 1.0f : 0.0f;
        }
      }
    }
  };

  // The warp's tiles of step k's trailing update: round robin over warps
  // 1 .. W - 1. Tile (k+1, k+1) is warp 0's, which then factors it: the
  // chain of diagonal factorizations is the block's critical path.
  auto for_my_tiles = [&](int k, auto&& f) {
    int u = 0;
    for (int j = k + 1; j < NT; ++j) {
      for (int i = j; i < NT; ++i) {
        if (i == k + 1 && j == k + 1) continue;
        if (1 + u++ % (W - 1) == warp) f(i, j);
      }
    }
  };

  // (c) A_ij -= L_ik L_jk^T by one warp: a lane's RM x CM block in
  // registers; L_ik and L_jk are stored transposed, so a step p reads RM
  // and CM consecutive floats.
  auto update_tile = [&](int i, int j, int k) {
    float* ct = tile(i, j);
    const float* pi = tile(i, k);
    const float* pj = tile(j, k);
    const int r0 = (lane >> 2) * RM, c0 = (lane & 3) * CM;
    float acc[RM][CM];
#pragma unroll
    for (int u = 0; u < RM; ++u) lds(ct + (r0 + u) * LD + c0, acc[u]);
#pragma unroll
    for (int p = 0; p < T; ++p) {
      float lr[RM], lc[CM];
      lds(pi + p * LD + r0, lr);
      lds(pj + p * LD + c0, lc);
#pragma unroll
      for (int u = 0; u < RM; ++u) {
#pragma unroll
        for (int v = 0; v < CM; ++v) {
          acc[u][v] = fmaf(-lr[u], lc[v], acc[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RM; ++u) sts(ct + (r0 + u) * LD + c0, acc[u]);
  };

  // (a) Diagonal tile kk by warp 0, lane q holding row q of its lower
  // half: the warp body's LDL^T elimination by rows (column j's entries
  // a[q][j] go round through a shared slot; each lane updates its row
  // right of j), column j + 1 handed on before the rest of step j. b's
  // tile rides along: z_j = b_j / L[j][j]. Writes L_kk^T into the tile's
  // strict upper half, 1 / L[j][j] and z.
  auto factor = [&](int kk) {
    float* dt = tile(kk, kk);
    float a[T];
    lds(dt + q * LD, a);
    float bq = bs[kk * T + q];
    slots[q] = a[0];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float* cj = slots + (j % 3) * T;
      float* cn = slots + ((j + 1) % 3) * T;
      const float d = cj[j];
      const float m = a[j] * __fdividef(1.0f, d);  // L[q][j] / L[j][j]
      const float bj = __shfl_sync(kFull, bq, j);
      if (j + 1 < T) {
        if (q > j) a[j + 1] = fmaf(-cj[j + 1], m, a[j + 1]);
        cn[q] = a[j + 1];
        __syncwarp();
      }
      // the rest of the row, c > j + 1: entries past the diagonal (c > q)
      // and rows already done (q <= j) take updates that nothing reads
#pragma unroll
      for (int c4 = (j + 2) & ~3; c4 < T; c4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cj + c4);
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (c4 + t >= j + 2) a[c4 + t] = fmaf(-l[t], m, a[c4 + t]);
        }
      }
      if (q > j) bq = fmaf(-bj, m, bq);
      const float s = rsqrtf(d);  // 1 / L[j][j]
      if (q > j) dt[j * LD + q] = a[j] * s;  // L[q][j]
      if (q == j) {
        invl[kk * T + j] = s;
        bs[kk * T + j] = bj * s;
      }
    }
  };

  // (b) The tiles below diagonal tile k, a row a lane: x L_kk^T = a by
  // forward substitution, stored transposed in place, and b's tile i
  // loses L_ik z_k. The warp after the last tile's solves the identity:
  // L_kk^-1, kept in the diagonal tile's lower half.
  auto panel = [&](int k) {
    const int last = NT - 1 - k;  // the identity's slot
    if (warp > last) return;
    const bool ident = warp == last;
    const int i = k + 1 + warp;
    float* pt = ident ? tile(k, k) : tile(i, k);
    const float* lt = tile(k, k);
    float a[T];
    if (!ident) {
      lds(pt + q * LD, a);
    } else {
#pragma unroll
      for (int c = 0; c < T; ++c) a[c] = c == q ? 1.0f : 0.0f;
    }
    __syncwarp();  // every row read before any is stored transposed
#pragma unroll
    for (int j = 0; j < T; ++j) {
      a[j] *= invl[k * T + j];
#pragma unroll
      for (int c4 = (j + 1) & ~3; c4 < T; c4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(lt + j * LD + c4);
        const float l[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = c4 + t;
          if (c > j) a[c] = fmaf(-a[j], l[t], a[c]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < T; ++p) {
      if (!ident || p >= q) pt[p * LD + q] = a[p];
    }
    if (!ident) {
      float z[T];
      lds(bs + k * T, z);
      float acc = bs[i * T + q];
#pragma unroll
      for (int p = 0; p < T; ++p) acc = fmaf(-a[p], z[p], acc);
      bs[i * T + q] = acc;
    }
  };

  // Copies in three groups: the first diagonal tile and b (warp 0), this
  // warp's tiles of the first panel, its tiles of the first update.
  if (warp == 0) {
    load_tile(0, 0);
    for (int c = lane; c < C::kN; c += 32) {
      bs[c] = c < n ? b[sys * n + c] : 0.0f;
    }
  }
  cp_async_commit();
  if (warp < NT - 1) load_tile(warp + 1, 0);
  cp_async_commit();
  if (warp == 0) load_tile(1, 1);
  for_my_tiles(0, load_tile);
  cp_async_commit();

  if (warp == 0) {
    cp_async_wait<2>();
    __syncwarp();
    factor(0);
  }
  for (int k = 0; k < NT; ++k) {
    __syncthreads();  // L_kk^T, 1 / L[j][j], z_k; step k - 1's updates
    if (k == 0) {
      cp_async_wait<1>();
      __syncwarp();
    }
    panel(k);
    if (k + 1 == NT) {
      __syncthreads();  // the last L_kk^-1
      break;
    }
    if (k == 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
    if (warp == 0) {
      // The next diagonal tile needs only this warp's panel tile (k+1, k):
      // it is updated and factored while the others finish their panels.
      bar_arrive(kPanelsDone, C::kThreads);
      __syncwarp();  // its panel tile, stored transposed by other lanes
      update_tile(k + 1, k + 1, k);
      __syncwarp();
      factor(k + 1);
    } else {
      bar_sync(kPanelsDone, C::kThreads);  // every panel
      for_my_tiles(k, [&](int i, int j) { update_tile(i, j, k); });
    }
  }

  // Back substitution L^T x = z by tiles: the lanes of warp j hold y_j;
  // x_i = L_ii^-T y_i, then every tile j < i loses L_ij^T x_i.
  float y = bs[warp * T + q];
  for (int i = NT - 1; i >= 0; --i) {
    if (warp == i) {
      bs[i * T + q] = y;
      __syncwarp();
      const float* inv = tile(i, i);  // L_ii^-1 [p][q], p >= q
      float yv[T];
      lds(bs + i * T, yv);
      float xq = 0.0f;
#pragma unroll
      for (int p = 0; p < T; ++p) {
        if (p >= q) xq = fmaf(inv[p * LD + q], yv[p], xq);
      }
      xs[i * T + q] = xq;
      if (i * T + q < n) x[sys * n + i * T + q] = xq;
    }
    __syncthreads();  // x_i
    if (warp < i) {
      float l[T], xv[T];
      lds(tile(i, warp) + q * LD, l);  // L_ij[r][q] for r = 0 .. T - 1
      lds(xs + i * T, xv);
#pragma unroll
      for (int r = 0; r < T; ++r) y = fmaf(-l[r], xv[r], y);
    }
  }
}

template <int NT>
int launch_tiled(const float* A, const float* b, float* x, int batch, int n,
                 cudaStream_t stream) {
  using C = TiledCfg<NT>;
  auto kern = spd_solve_tiled_kernel<NT>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
  }
  const int vec = n % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(A) % 16 == 0;
  kern<<<batch, C::kThreads, C::kSmem, stream>>>(A, b, x, n, vec);
  return cudaGetLastError();
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

// launch_tiled<NT> for the nt = ceil(n / T) that n needs
template <int NT>
int dispatch_tiled(int nt, const float* A, const float* b, float* x,
                   int batch, int n, cudaStream_t stream) {
  if constexpr (NT * kTile > kMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (nt == NT) return launch_tiled<NT>(A, b, x, batch, n, stream);
    return dispatch_tiled<NT + 1>(nt, A, b, x, batch, n, stream);
  }
}

}  // namespace

extern "C" int ycnr_spd_solve(const float* A, const float* b, float* x,
                              int batch, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return cudaErrorInvalidValue;
  if (n <= 16) return launch_warp<16>(A, b, x, batch, n, stream);
  if (n <= 32) return launch_warp<32>(A, b, x, batch, n, stream);
  if (n <= 64) return launch_warp<64>(A, b, x, batch, n, stream);
  return dispatch_tiled<3>((n + kTile - 1) / kTile, A, b, x, batch, n,
                           stream);
}
