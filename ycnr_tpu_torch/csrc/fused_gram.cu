// Fused gather -> Gram with the ridge: per entity e of a block,
//
//   A[e] = sum_r F[idx[e, r]] F[idx[e, r]]^T + reg[e] I   [w, w] f32
//   b[e] = sum_r rat[e, r] F[idx[e, r]]                  [w]    f32
//
// from a bf16 factor table F [n, w] (w <= 256), without writing the
// gathered rows to device memory. reg is optional (null: no ridge). Two
// bodies: fused_gram_kernel for w <= 128 (below) and fused_gram_wide_kernel
// for 128 < w <= 256 (after it, with its own note).
//
// Replaces the TPU kernel tools/probe_gather.py:pallas_fused_gram (T4),
// which gathers a [tile_ne, R] slot tile's rows into VMEM scratch and runs
// the batched Gram on the MXU, at a fixed R = 32. Here R is any length:
// the bucketed ALS epoch (models/bucketed_phase.py) calls it with rungs
// from 56 slots up to the heaviest entity's 129,872.
//
// What bounds it on Hopper: bytes. At w = 64 an entity writes 16 KB of A
// whatever its R, and a slot costs 128 B of (L2-resident) row reads plus
// its index and rating, against 64 * 64 * 2 FLOP that the bf16 tensor
// cores do at ~1 PFLOP/s. So the design keeps the gather's loads in flight
// and spends nothing on the products: rows are staged in shared memory
// with 16-byte cp.async copies (cached in L1 as well) into a ring of
// kStages stages of kStageSlots slots, the next stages loading while this
// one multiplies (Hopper's TMA cannot gather arbitrary rows), with each
// stage's indices read into registers one stage ahead; the products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
// The layouts point every padding slot (~40% of them) at the table's last
// row, the all-zero trash row: read by every block, that one line was the
// kernel's hot spot, so a block that finds the row zero zero-fills those
// slots without reading it.
//
// The staged slot-major rows F [slots, w] are read with ldmatrix.trans:
// one x4 load gives the m16k16 A fragment of F^T for a 16-column tile,
// and the same four registers are the two k16n8 B fragments of F for
// that tile, so each 16-slot step loads each tile once. Only the lower
// 16 x 16 tiles (ti >= tj) are multiplied (10 of 16 at w = 64); the
// epilogue mirrors them, so A is bit-symmetric by construction and not by
// any assumption about the tensor core's summation order. b is one more
// n = 8 product per row tile whose B column 0 holds the slot ratings.
//
// Work split: a block of 4 warps per (entity, part). The wrapper cuts the
// rating lists of a call with too few entities to fill the card into
// parts of at least 256 slots, sums the parts' A and b and adds the ridge
// after. At w <= 64 each warp takes one 16-slot step of every stage and
// keeps all lower tiles (80 f32 accumulators a thread at w = 64); the
// warps' partials go to shared memory and the epilogue sums them in warp
// order. At w > 64 the tiles are dealt to the warps instead and every
// warp takes every step. Either way the order of every sum is fixed, so
// runs give equal bits. Padding slots and slots past R add exactly 0; a
// padding entity comes out as A = reg I, b = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageSlots = 64;  // slots per stage: one 16-slot step per warp
constexpr int kSteps = kStageSlots / 16;
constexpr int kStages = 3;
constexpr int kNarrowW = 128;  // fused_gram_kernel's widest rows
constexpr int kMaxW = 256;     // fused_gram_wide_kernel's

template <int T>  // T = 16-column tiles per side of A
struct Cfg {
  static constexpr int kW16 = 16 * T;   // w rounded up to whole tiles
  static constexpr int kTiles = T * (T + 1) / 2;
  static constexpr int kTG = T <= 4 ? 1 : kWarps;  // tile groups
  static constexpr int kSG = kWarps / kTG;          // slot groups
  static constexpr int kMT = (kTiles + kTG - 1) / kTG;  // tiles per warp
  // staged row stride in bf16: 16 bytes of padding keep the eight rows of
  // one ldmatrix on eight different bank groups
  static constexpr int kRow = kW16 + 8;
  static constexpr int kS = kW16 + 1;  // f32 stride of the staged Gram
  static constexpr int kPart = kW16 * kS + kW16;  // one partial A and b
  static constexpr int kQ = T;  // row copies per thread and stage (vec)
  static constexpr int kStageBytes = kStages * kStageSlots * kRow * 2;
  static constexpr int kGramBytes = kSG * kPart * 4;
  // the Gram staging reuses the ring once the last stage is consumed
  static constexpr int kRatOff =
      ((kStageBytes > kGramBytes ? kStageBytes : kGramBytes) + 15) / 16 * 16;
  static constexpr int kSmem = kRatOff + kStages * kStageSlots * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, cached in L1 too (popular rows are read
// by many blocks of an SM); bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

template <int T, typename Idx>
__global__ void __launch_bounds__(kThreads)
fused_gram_kernel(const __nv_bfloat16* __restrict__ table,
                  const Idx* __restrict__ idx,
                  const __nv_bfloat16* __restrict__ rat,
                  const float* __restrict__ reg, float* __restrict__ A,
                  float* __restrict__ b, int R_all, int parts, int R_part,
                  int w, long long n_rows, int vec) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  // [kStages][kStageSlots][kRow] bf16 staged rows, slot-major
  unsigned short* rows = reinterpret_cast<unsigned short*>(smem);
  // after the last stage: one partial per slot group, each the lower
  // tiles of A [kW16][kS] then b [kW16]
  float* S = reinterpret_cast<float*>(smem);
  // [kStages][kStageSlots] bf16 ratings
  unsigned short* s_rat = reinterpret_cast<unsigned short*>(smem + C::kRatOff);
  const unsigned short* tb = reinterpret_cast<const unsigned short*>(table);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tg = warp % C::kTG;
  const int sg = warp / C::kTG;
  // block = (entity, part): part p holds slots [p R_part, (p + 1) R_part)
  const long long e = blockIdx.x / parts;
  const int p0 = (blockIdx.x % parts) * R_part;
  const int R = min(R_part, R_all - p0);
  const Idx* ie = idx + e * R_all + p0;
  const unsigned short* re =
      reinterpret_cast<const unsigned short*>(rat) + e * R_all + p0;
  const int cpr = w / 8;  // 16-byte chunks per row (vec)
  const int nst = (R + kStageSlots - 1) / kStageSlots;

  if (vec && w < C::kW16) {  // columns [w, kW16) of every staged row: 0
    const int pc = C::kW16 - w;
    for (int q = t; q < kStages * kStageSlots * pc; q += kThreads) {
      rows[(q / pc) * C::kRow + w + q % pc] = 0;
    }
  }

  const long long zrow = n_rows - 1;  // the padding slots' row
  bool zero_last = true;              // and whether it is all zero (below)
  // The indices and ratings of the next stage to issue, loaded into
  // registers one iteration ahead, so no global load latency sits between
  // one stage and the next (vec).
  long long nidx[C::kQ];
  unsigned short nrat = 0;
  auto fetch = [&](int st) {
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
#pragma unroll
    for (int k = 0; k < C::kQ; ++k) {
      const int s = (t + k * kThreads) / cpr;
      nidx[k] = s < ns ? static_cast<long long>(ie[s0 + s]) : 0;
    }
    nrat = t < ns ? re[s0 + t] : 0;
  };
  // Stage st's rows and ratings into ring buffer st % kStages.
  auto issue = [&](int st) {
    const int buf = st % kStages;
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
    unsigned short* dst = rows + buf * kStageSlots * C::kRow;
    if (vec) {
      if (t < kStageSlots) s_rat[buf * kStageSlots + t] = nrat;
#pragma unroll
      for (int k = 0; k < C::kQ; ++k) {
        const int q = t + k * kThreads;
        if (q < kStageSlots * cpr) {
          const int s = q / cpr;
          const int c = q - s * cpr;
          const unsigned short* src = tb;
          int bytes = 0;
          if (s < ns) {
            const long long r = nidx[k];
            if (r < 0 || r >= n_rows) __trap();
            if (r != zrow || !zero_last) {
              src = tb + r * w + 8 * c;
              bytes = 16;
            }
          }
          cp_async16(dst + s * C::kRow + 8 * c, src, bytes);
        }
      }
    } else {  // rows not whole 16-byte chunks: plain loads
      if (t < kStageSlots) {
        s_rat[buf * kStageSlots + t] = t < ns ? re[s0 + t] : 0;
      }
      for (int q = t; q < kStageSlots * C::kW16; q += kThreads) {
        const int s = q / C::kW16;
        const int col = q - s * C::kW16;
        unsigned short v = 0;
        if (s < ns && col < w) {
          const long long r = static_cast<long long>(ie[s0 + s]);
          if (r < 0 || r >= n_rows) __trap();
          v = tb[r * w + col];
        }
        dst[s * C::kRow + col] = v;
      }
    }
  };

  float acc[C::kMT][2][4];
  float accb[T][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][h][k] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) accb[i][k] = 0.0f;
  }

  // The layouts point every padding slot at the table's last row, which
  // the factor tables keep at zero: up to ~40% of all slots read that one
  // row, a hot spot in L2. If the row is +-0 throughout, such slots are
  // zero-filled without a read (the sums are the same bits); otherwise it
  // is read like any other row. Checked while the first indices load.
  if (vec) fetch(0);
  for (int c = t; c < w; c += kThreads) {
    zero_last = zero_last && (tb[zrow * w + c] & 0x7fff) == 0;
  }
  zero_last = __syncthreads_and(zero_last);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) {
      if (vec && p > 0) fetch(p);
      issue(p);
    }
    cp_async_commit();
  }
  if (vec && kStages - 1 < nst) fetch(kStages - 1);
  // this lane's ldmatrix row: slot (lane & 7) + 8 * bit 4, column 8 * bit 3
  const int lrow = (lane & 7) + 8 * ((lane >> 4) & 1);
  const int lcol = 8 * ((lane >> 3) & 1);
  for (int st = 0; st < nst; ++st) {
    if (st + kStages - 1 < nst) {
      issue(st + kStages - 1);
      if (vec && st + kStages < nst) fetch(st + kStages);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int buf = st % kStages;
    const int ns = min(kStageSlots, R - st * kStageSlots);
    const unsigned short* src = rows + buf * kStageSlots * C::kRow;
    const uint32_t* rat2 =
        reinterpret_cast<const uint32_t*>(s_rat + buf * kStageSlots);
    for (int kc = sg; kc < kSteps; kc += C::kSG) {
      const int k0 = 16 * kc;
      if (k0 >= ns) break;
      uint32_t fr[T][4];  // F^T tile ti as m16k16 A fragments
      const unsigned short* base = src + (k0 + lrow) * C::kRow + lcol;
#pragma unroll
      for (int ti = 0; ti < T; ++ti) ldsm_x4_trans(base + 16 * ti, fr[ti]);
#pragma unroll
      for (int ti = 0; ti < T; ++ti) {
#pragma unroll
        for (int tj = 0; tj <= ti; ++tj) {
          const int tt = ti * (ti + 1) / 2 + tj;
          if (tt % C::kTG == tg) {
            // F tile tj as k16n8 B fragments: the same registers
            mma_bf16(acc[tt / C::kTG][0], fr[ti], fr[tj][0], fr[tj][2]);
            mma_bf16(acc[tt / C::kTG][1], fr[ti], fr[tj][1], fr[tj][3]);
          }
        }
      }
      // b: B column 0 (lanes 0-3) holds the ratings of slots k0..k0+15
      const uint32_t rb0 = lane < 4 ? rat2[k0 / 2 + lane] : 0u;
      const uint32_t rb1 = lane < 4 ? rat2[k0 / 2 + 4 + lane] : 0u;
#pragma unroll
      for (int ti = 0; ti < T; ++ti) {
        if ((ti * (ti + 1) / 2 + ti) % C::kTG == tg) {
          mma_bf16(accb[ti], fr[ti], rb0, rb1);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each slot group's partial -> its own buffer (lower tiles and b).
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  float* P = S + sg * C::kPart;
#pragma unroll
  for (int ti = 0; ti < T; ++ti) {
#pragma unroll
    for (int tj = 0; tj <= ti; ++tj) {
      const int tt = ti * (ti + 1) / 2 + tj;
      if (tt % C::kTG == tg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* d = P + (16 * ti + g) * C::kS + 16 * tj + 8 * h + c2;
          const float* a = acc[tt / C::kTG][h];
          d[0] = a[0];
          d[1] = a[1];
          d[8 * C::kS] = a[2];
          d[8 * C::kS + 1] = a[3];
        }
      }
    }
    if ((ti * (ti + 1) / 2 + ti) % C::kTG == tg && (lane & 3) == 0) {
      P[C::kW16 * C::kS + 16 * ti + g] = accb[ti][0];
      P[C::kW16 * C::kS + 16 * ti + g + 8] = accb[ti][2];
    }
  }
  __syncthreads();

  // Epilogue: the partials summed in slot-group order, the lower triangle
  // mirrored, the ridge added on the diagonal.
  auto gram = [&](int i, int j) {  // i >= j
    float v = S[i * C::kS + j];
#pragma unroll
    for (int p = 1; p < C::kSG; ++p) v += S[p * C::kPart + i * C::kS + j];
    return v;
  };
  float* Ae = A + static_cast<long long>(blockIdx.x) * w * w;
  const float rg = reg != nullptr ? reg[e] : 0.0f;
  if ((w & 3) == 0) {  // 16-byte stores
    for (int q = 4 * t; q < w * w; q += 4 * kThreads) {
      const int i = q / w;
      const int j = q - i * w;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u;
        v[u] = i >= jj ? gram(i, jj) : gram(jj, i);
        if (i == jj) v[u] += rg;
      }
      *reinterpret_cast<float4*>(Ae + q) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int q = t; q < w * w; q += kThreads) {
      const int i = q / w;
      const int j = q - i * w;
      float v = i >= j ? gram(i, j) : gram(j, i);
      if (i == j) v += rg;
      Ae[q] = v;
    }
  }
  for (int i = t; i < w; i += kThreads) {
    float v = S[C::kW16 * C::kS + i];
#pragma unroll
    for (int p = 1; p < C::kSG; ++p) v += S[p * C::kPart + C::kW16 * C::kS + i];
    b[static_cast<long long>(blockIdx.x) * w + i] = v;
  }
}

template <int T, typename Idx>
int launch_t(const void* table, const void* idx, const void* rat,
             const float* reg, float* A, float* b, long long ne, int R,
             int parts, int R_part, int w, long long n_rows, int vec,
             cudaStream_t stream) {
  using C = Cfg<T>;
  static_assert(C::kSmem <= 232448, "shared memory");
  auto kern = fused_gram_kernel<T, Idx>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(ne * parts), kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(table), static_cast<const Idx*>(idx),
      static_cast<const __nv_bfloat16*>(rat), reg, A, b, R, parts, R_part, w,
      n_rows, vec);
  return cudaGetLastError();
}

template <int T>
int launch(const void* table, const void* idx, const void* rat,
           const float* reg, float* A, float* b, long long ne, int R,
           int parts, int R_part, int w, long long n_rows, int idx64, int vec,
           cudaStream_t stream) {
  return idx64 ? launch_t<T, long long>(table, idx, rat, reg, A, b, ne, R,
                                        parts, R_part, w, n_rows, vec, stream)
               : launch_t<T, int>(table, idx, rat, reg, A, b, ne, R, parts,
                                  R_part, w, n_rows, vec, stream);
}

// ---------------------------------------------------------------------
// The wide body, 128 < w <= 256 (T = 9..16 tiles of 16 columns a side).
//
// What bounds it: the bytes of A. An entity writes 4 w^2 bytes of A
// (147,456 at w 192, 262,144 at w 256: 44 / 78 ns at 3.35 TB/s) whatever
// its R, against w (w + 1) FLOP of bf16 products a slot (37,056 / 65,792:
// 37 / 67 ps at 989 TFLOP/s). So A outweighs the products of up to
// ~1,190 slots an entity, and the main path's user phase averages 223
// (30.9M slots, 138,696 entities): at w 192 its bound is A's 20.4 GB, 6.1
// ms. The design keeps the narrow body's staging (16-byte cp.async rows
// into a ring of kStages x kStageSlots slots, indices one stage ahead,
// the trash row zero-filled unread, ldmatrix.x4.trans fragments, mma.sync
// m16n8k16 bf16 -> f32) and changes what a warp keeps, because growing
// Cfg<T> does not fit the card: at T = 16 the 136 lower tiles over 4 warps
// are 272 f32 accumulators a thread (the limit is 255), and staging the
// whole Gram needs 256 x 257 x 4 B = 263 KB of shared memory (a block has
// 227 KB).
//
// Work split: a block of 8 warps per (entity, part). Warp v keeps the
// tile rows v and T-1-v: T + 1 lower tiles (136 accumulators a thread at
// T = 16), or the middle row alone when T is odd; warps v > (T-1)/2 only
// stage rows (2 of 8 at T = 12). Every warp takes every 16-slot step of
// the same ring (101 KB at w 256). Per step a warp loads the fragments
// of tile columns 0..T-1-v once each (its two rows' among them): a column
// fragment feeds both rows' tiles.
//
// Epilogue: no shared staging of the whole Gram. Each warp writes its
// tiles into A through 1 KB of shared memory of its own, as rows of 16
// floats (16-byte stores in place of the fragments' scattered 4-byte
// ones): a tile and its transpose from the same values, a diagonal tile's
// upper half from its lower half, so A is bit-symmetric by construction;
// the ridge goes on as the diagonal is written. b is the extra n = 8
// product of each row, by the warp that keeps the row.
//
// The staging repeats the narrow body's code rather than sharing it, so
// that the w <= 128 body stays as it was.
//
// Every entry of A and b is one warp's chain of ceil(R / 16) mma steps in
// slot order (no adds across warps), so runs give equal bits and the
// wrapper's error bound (ops/fused_gram.py) holds as for the narrow body.
// Splitting the tiles over several blocks of one entity was the other way
// to fit; it reads every gathered row once per block, this reads it once.
// 138-198 registers a thread (T = 9..16, no spills) hold one block an SM;
// the wrapper sizes its list splits for that.

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;

template <int T>  // T = 16-column tiles per side of A, 9..16
struct WideCfg {
  static_assert(T > kNarrowW / 16 && T <= kMaxW / 16, "wide body width");
  static_assert((T + 1) / 2 <= kWideWarps, "a row pair per warp");
  static constexpr int kW16 = 16 * T;
  static constexpr int kRow = kW16 + 8;  // as Cfg<T>::kRow
  // 16-byte row copies per thread and stage (vec)
  static constexpr int kQ = (kStageSlots * 2 * T + kWideThreads - 1) /
                            kWideThreads;
  static constexpr int kStageBytes = kStages * kStageSlots * kRow * 2;
  static constexpr int kDiag = 16 * 17;  // a warp's diagonal tile, f32
  static_assert(kWideWarps * kDiag * 4 <= kStageBytes, "diagonal staging");
  static constexpr int kRatOff = (kStageBytes + 15) / 16 * 16;
  static constexpr int kSmem = kRatOff + kStages * kStageSlots * 2;
};

__device__ __forceinline__ void copy4(uint32_t (&d)[4],
                                      const uint32_t (&s)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = s[k];
}

template <int T, typename Idx>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_gram_wide_kernel(const __nv_bfloat16* __restrict__ table,
                       const Idx* __restrict__ idx,
                       const __nv_bfloat16* __restrict__ rat,
                       const float* __restrict__ reg, float* __restrict__ A,
                       float* __restrict__ b, int R_all, int parts,
                       int R_part, int w, long long n_rows, int vec) {
  using C = WideCfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  // [kStages][kStageSlots][kRow] bf16 staged rows, slot-major; after the
  // last stage, [kWideWarps][16][17] f32 diagonal tiles
  unsigned short* rows = reinterpret_cast<unsigned short*>(smem);
  unsigned short* s_rat = reinterpret_cast<unsigned short*>(smem + C::kRatOff);
  const unsigned short* tb = reinterpret_cast<const unsigned short*>(table);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // this warp's tile rows: rb = T-1-warp (all warps <= (T-1)/2) and ra =
  // warp (when it is another row); tile (rb, tj) in acc[tj], (ra, tj) in
  // acc[T - tj]
  const int rb = T - 1 - warp;
  const int ra = warp;
  const bool has_b = warp <= rb;
  const bool has_a = warp < rb;
  const long long e = blockIdx.x / parts;
  const int p0 = (blockIdx.x % parts) * R_part;
  const int R = min(R_part, R_all - p0);
  const Idx* ie = idx + e * R_all + p0;
  const unsigned short* re =
      reinterpret_cast<const unsigned short*>(rat) + e * R_all + p0;
  const int cpr = w / 8;  // 16-byte chunks per row (vec)
  const int nst = (R + kStageSlots - 1) / kStageSlots;

  if (vec && w < C::kW16) {  // columns [w, kW16) of every staged row: 0
    const int pc = C::kW16 - w;
    for (int q = t; q < kStages * kStageSlots * pc; q += kWideThreads) {
      rows[(q / pc) * C::kRow + w + q % pc] = 0;
    }
  }

  const long long zrow = n_rows - 1;  // the padding slots' row
  bool zero_last = true;              // and whether it is all zero
  Idx nidx[C::kQ];  // the next stage's indices, one iteration ahead (vec)
  unsigned short nrat = 0;
  auto fetch = [&](int st) {
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
#pragma unroll
    for (int k = 0; k < C::kQ; ++k) {
      const int s = (t + k * kWideThreads) / cpr;
      nidx[k] = s < ns ? ie[s0 + s] : Idx(0);
    }
    nrat = t < ns ? re[s0 + t] : 0;
  };
  auto issue = [&](int st) {
    const int buf = st % kStages;
    const int s0 = st * kStageSlots;
    const int ns = min(kStageSlots, R - s0);
    unsigned short* dst = rows + buf * kStageSlots * C::kRow;
    if (vec) {
      if (t < kStageSlots) s_rat[buf * kStageSlots + t] = nrat;
#pragma unroll
      for (int k = 0; k < C::kQ; ++k) {
        const int q = t + k * kWideThreads;
        if (q < kStageSlots * cpr) {
          const int s = q / cpr;
          const int c = q - s * cpr;
          const unsigned short* src = tb;
          int bytes = 0;
          if (s < ns) {
            const long long r = static_cast<long long>(nidx[k]);
            if (r < 0 || r >= n_rows) __trap();
            if (r != zrow || !zero_last) {
              src = tb + r * w + 8 * c;
              bytes = 16;
            }
          }
          cp_async16(dst + s * C::kRow + 8 * c, src, bytes);
        }
      }
    } else {  // rows not whole 16-byte chunks: plain loads
      if (t < kStageSlots) {
        s_rat[buf * kStageSlots + t] = t < ns ? re[s0 + t] : 0;
      }
      for (int q = t; q < kStageSlots * C::kW16; q += kWideThreads) {
        const int s = q / C::kW16;
        const int col = q - s * C::kW16;
        unsigned short v = 0;
        if (s < ns && col < w) {
          const long long r = static_cast<long long>(ie[s0 + s]);
          if (r < 0 || r >= n_rows) __trap();
          v = tb[r * w + col];
        }
        dst[s * C::kRow + col] = v;
      }
    }
  };

  float acc[T + 1][2][4];
  float accb[2][4];  // b's rows rb, ra
#pragma unroll
  for (int i = 0; i <= T; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][h][k] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) accb[i][k] = 0.0f;
  }

  // the trash row: read unless it is +-0 throughout (as the narrow body)
  if (vec) fetch(0);
  for (int c = t; c < w; c += kWideThreads) {
    zero_last = zero_last && (tb[zrow * w + c] & 0x7fff) == 0;
  }
  zero_last = __syncthreads_and(zero_last);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) {
      if (vec && p > 0) fetch(p);
      issue(p);
    }
    cp_async_commit();
  }
  if (vec && kStages - 1 < nst) fetch(kStages - 1);
  const int lrow = (lane & 7) + 8 * ((lane >> 4) & 1);
  const int lcol = 8 * ((lane >> 3) & 1);
  for (int st = 0; st < nst; ++st) {
    if (st + kStages - 1 < nst) {
      issue(st + kStages - 1);
      if (vec && st + kStages < nst) fetch(st + kStages);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int buf = st % kStages;
    const int ns = min(kStageSlots, R - st * kStageSlots);
    const unsigned short* src = rows + buf * kStageSlots * C::kRow;
    const uint32_t* rat2 =
        reinterpret_cast<const uint32_t*>(s_rat + buf * kStageSlots);
    if (has_b) {
      for (int kc = 0; kc < kSteps; ++kc) {
        const int k0 = 16 * kc;
        if (k0 >= ns) break;
        const unsigned short* base = src + (k0 + lrow) * C::kRow + lcol;
        uint32_t fb[4], fa[4] = {0u, 0u, 0u, 0u};  // rows rb, ra
        ldsm_x4_trans(base + 16 * rb, fb);
        if (has_a) ldsm_x4_trans(base + 16 * ra, fa);
#pragma unroll
        for (int tj = 0; tj < T; ++tj) {
          if (tj <= rb) {
            uint32_t f[4];  // F tile tj as k16n8 B fragments
            if (tj == rb) {
              copy4(f, fb);
            } else if (has_a && tj == ra) {
              copy4(f, fa);
            } else {
              ldsm_x4_trans(base + 16 * tj, f);
            }
            mma_bf16(acc[tj][0], fb, f[0], f[2]);
            mma_bf16(acc[tj][1], fb, f[1], f[3]);
            if (has_a && tj <= ra) {
              mma_bf16(acc[T - tj][0], fa, f[0], f[2]);
              mma_bf16(acc[T - tj][1], fa, f[1], f[3]);
            }
          }
        }
        // b: B column 0 (lanes 0-3) holds the ratings of slots k0..k0+15
        const uint32_t rb0 = lane < 4 ? rat2[k0 / 2 + lane] : 0u;
        const uint32_t rb1 = lane < 4 ? rat2[k0 / 2 + 4 + lane] : 0u;
        mma_bf16(accb[0], fb, rb0, rb1);
        if (has_a) mma_bf16(accb[1], fa, rb0, rb1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: diagonal tiles go there

  // Epilogue: each tile of this warp goes from its fragments (thread (g,
  // c2) holds entries (g, c2 + {0, 1}) and (g + 8, c2 + {0, 1}) of each
  // 16 x 8 half) into the warp's 16 x 17 buffer, and from there into A as
  // rows of 16 floats: the lower tile (i, j) and its transpose (j, i) from
  // the same values; on a diagonal tile the upper half takes the lower
  // half's and the ridge goes on the diagonal. 16-byte stores when w % 4
  // == 0, else 4-byte ones.
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  float* Ae = A + static_cast<long long>(blockIdx.x) * w * w;
  float* be = b + static_cast<long long>(blockIdx.x) * w;
  const float rg = reg != nullptr ? reg[e] : 0.0f;
  const bool st4 = (w & 3) == 0;
  float* D = reinterpret_cast<float*>(smem) + warp * C::kDiag;
  // out[r][c0..c0+3] = tile entries (r, c0..c0+3), lower half mirrored on
  // a diagonal tile, or the transpose's when `tr`, into A at (i0, j0)
  auto put = [&](int i0, int j0, bool diag, bool tr) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (lane >> 2) + 8 * u;
      const int c0 = 4 * (lane & 3);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q;
        v[q] = (tr || (diag && r < c)) ? D[c * 17 + r] : D[r * 17 + c];
        if (diag && r == c) v[q] += rg;
      }
      const int i = i0 + r;
      const int j = j0 + c0;
      if (i >= w || j >= w) continue;
      float* dst = Ae + static_cast<long long>(i) * w + j;
      if (st4) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < w) dst[q] = v[q];
        }
      }
    }
  };
  if (has_b) {
#pragma unroll
    for (int m = 0; m <= T; ++m) {
      // acc[m]: tile (rb, m) for m <= rb, else (ra, T - m)
      if (m > rb && !has_a) continue;
      const int ti = m <= rb ? rb : ra;
      const int tj = m <= rb ? m : T - m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          D[(g + 8 * (k >> 1)) * 17 + 8 * h + c2 + (k & 1)] = acc[m][h][k];
        }
      }
      __syncwarp();
      put(16 * ti, 16 * tj, ti == tj, false);
      if (ti != tj) put(16 * tj, 16 * ti, false, true);
      __syncwarp();
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !has_a) break;
        const int row = u == 0 ? rb : ra;
        if (16 * row + g < w) be[16 * row + g] = accb[u][0];
        if (16 * row + g + 8 < w) be[16 * row + g + 8] = accb[u][2];
      }
    }
  }
}

template <int T, typename Idx>
int launch_wide_t(const void* table, const void* idx, const void* rat,
                  const float* reg, float* A, float* b, long long ne, int R,
                  int parts, int R_part, int w, long long n_rows, int vec,
                  cudaStream_t stream) {
  using C = WideCfg<T>;
  static_assert(C::kSmem <= 232448, "shared memory");
  auto kern = fused_gram_wide_kernel<T, Idx>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(ne * parts), kWideThreads, C::kSmem,
         stream>>>(static_cast<const __nv_bfloat16*>(table),
                   static_cast<const Idx*>(idx),
                   static_cast<const __nv_bfloat16*>(rat), reg, A, b, R,
                   parts, R_part, w, n_rows, vec);
  return cudaGetLastError();
}

template <int T>
int launch_wide(const void* table, const void* idx, const void* rat,
                const float* reg, float* A, float* b, long long ne, int R,
                int parts, int R_part, int w, long long n_rows, int idx64,
                int vec, cudaStream_t stream) {
  return idx64 ? launch_wide_t<T, long long>(table, idx, rat, reg, A, b, ne,
                                             R, parts, R_part, w, n_rows,
                                             vec, stream)
               : launch_wide_t<T, int>(table, idx, rat, reg, A, b, ne, R,
                                       parts, R_part, w, n_rows, vec, stream);
}

}  // namespace

// table [n_rows, w] bf16, idx [ne, R] int32 or int64 (idx64), rat [ne, R]
// bf16, reg [ne] f32 or null. Each entity's slots are cut into `parts`
// parts of R_part slots (the last may be shorter; 1 part: the whole list)
// -> A [ne * parts, w, w] f32, b [ne * parts, w] f32, one per (entity,
// part), with the ridge on every part (pass it with one part only).
// w <= 128 runs fused_gram_kernel, 128 < w <= 256 fused_gram_wide_kernel.
extern "C" int ycnr_fused_gram(const void* table, const void* idx,
                               const void* rat, const float* reg, float* A,
                               float* b, long long ne, int R, int parts,
                               int R_part, int w, long long n_rows, int idx64,
                               cudaStream_t stream) {
  if (ne < 1 || R < 1 || parts < 1 || R_part < 1 ||
      static_cast<long long>(parts - 1) * R_part >= R ||
      static_cast<long long>(parts) * R_part < R ||
      ne * parts > 0x7fffffffLL || w < 1 || w > kMaxW || n_rows < 1) {
    return cudaErrorInvalidValue;
  }
  // whole 16-byte rows for cp.async; otherwise plain loads
  const int vec =
      w % 8 == 0 && reinterpret_cast<unsigned long long>(table) % 16 == 0;
  switch ((w + 15) / 16) {
#define YCNR_GRAM_CASE(T)                                                   \
  case T:                                                                   \
    return launch<T>(table, idx, rat, reg, A, b, ne, R, parts, R_part, w,   \
                     n_rows, idx64, vec, stream);
    YCNR_GRAM_CASE(1)
    YCNR_GRAM_CASE(2)
    YCNR_GRAM_CASE(3)
    YCNR_GRAM_CASE(4)
    YCNR_GRAM_CASE(5)
    YCNR_GRAM_CASE(6)
    YCNR_GRAM_CASE(7)
    YCNR_GRAM_CASE(8)
#undef YCNR_GRAM_CASE
#define YCNR_GRAM_WIDE_CASE(T)                                              \
  case T:                                                                   \
    return launch_wide<T>(table, idx, rat, reg, A, b, ne, R, parts, R_part, \
                          w, n_rows, idx64, vec, stream);
    YCNR_GRAM_WIDE_CASE(9)
    YCNR_GRAM_WIDE_CASE(10)
    YCNR_GRAM_WIDE_CASE(11)
    YCNR_GRAM_WIDE_CASE(12)
    YCNR_GRAM_WIDE_CASE(13)
    YCNR_GRAM_WIDE_CASE(14)
    YCNR_GRAM_WIDE_CASE(15)
    default:
      return launch_wide<16>(table, idx, rat, reg, A, b, ne, R, parts,
                             R_part, w, n_rows, idx64, vec, stream);
#undef YCNR_GRAM_WIDE_CASE
  }
}
