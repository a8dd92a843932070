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
// The wide body, 128 < w <= 256: wgmma on a warp-specialised mbarrier ring.
// It replaces the TPU kernel tools/probe_gather.py:pallas_fused_gram (T4)
// at these widths.
//
// What bounds it. An entity writes 4 w^2 bytes of A (147,456 at w 192,
// 262,144 at w 256: 44 / 78 ns at 3.35 TB/s) whatever its R, against w (w
// + 1) FLOP of bf16 products a slot (37,056 / 65,792: 37 / 67 ps at 989
// TFLOP/s). So A's bytes bound short lists, up to ~1,190 slots an entity;
// the main path's user phase averages 223 (30.9M slots, 138,696
// entities), a bound of 6.4 / 11.2 ms at w 192 / 256. The products bound
// long lists: the item phase's rungs reach 129,872 slots.
//
// The mma.sync body this one replaced (8 warps, ldmatrix fragments, the
// copies issued by the multiplying warps, two block barriers a 64-slot
// stage) spent ~83% of its loop's cycles in the 16-slot steps, the
// fragment reloads first (ycnr_tpu_torch/tools/wide_loop_split.cu): 0.70 /
// 0.93 ns a slot on long lists at w 192 / 256 on an H100, 5-7% of the
// products' bound. This body takes the fragments out of the loop (wgmma
// reads both operands from shared memory) and the copies out of the
// multiplying warps. Its loop is held by the producer's cp.async issue
// (~0.22 ns a slot at both widths, H100), not by the products.
//
// The design, for Hopper:
//  - Products on wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, both
//    operands from shared memory, both the same staged tile: A is F^T and
//    B is F, each MN-major ("transposed"), so no fragment passes through
//    a register. The lower Gram is cut into 64 x 64 blocks (T64 =
//    ceil(w / 64) a side: 3 at w 129-192, 4 at 193-256), dealt to two
//    consumer warpgroups as runs of adjacent blocks in one block row, one
//    wgmma a run and 16-slot step (Deal below): at T64 = 4 {(0,0),
//    (3,0..3)} and {(1,0..1), (2,0..2)}, N = 64 + 256 and 128 + 192, 160
//    f32 accumulators a thread; at T64 = 3 {(0,0), (2,0..1)} and {(1,0..1),
//    (2,2)}. Diagonal blocks are computed whole. b is one more m64n8k16 a
//    row block whose B holds the slot ratings in column 0. Padded columns
//    (past w) are staged as zeros once and never written again.
//  - Staging on a warp-specialised ring of kStages stages of 64 slots (5
//    at T64 = 4, 33 KB a stage; 7 at T64 = 3). One producer warpgroup
//    (setmaxnreg down to kProducerRegs; the consumers up to kConsumerRegs)
//    gathers each stage's rows with 16-byte cp.async straight into the
//    128-byte-swizzled layout that the wgmma descriptors read: 8 slots x 64
//    columns a 1 KB atom, chunk c of slot s at ((c ^ s) & 7) in its row.
//    Hopper's TMA cannot gather rows, and a 1-D bulk copy a row writes no
//    swizzle, so the rows go through cp.async. Completion goes to the
//    stage's full mbarrier (cp.async.mbarrier.arrive.noinc, plus a plain
//    arrive for the ratings, which are stored directly); the consumers
//    wait on it, issue their wgmmas, and when those are done (wait_group
//    1, a stage later) arrive on its empty mbarrier. No block barrier is
//    left in the loop. The producer reads each stage's indices with
//    coalesced loads one stage ahead (a lane an index), checks their range
//    with one vote a stage, works out the row offsets once in 16 lanes and
//    issues the copies in an unrolled, branch-free loop: its instructions
//    a stage are what bound the loop, so they are kept few. It keeps the
//    trash row unread when it is zero (its slots are zero-filled). With w
//    % 8 != 0 or a table off a 16-byte boundary it writes the same layout
//    with plain loads, so the consumers are unchanged. The roles are made
//    warp-uniform with a shuffle and every stage runs all four steps (the
//    slots past R are zero rows with zero ratings): ptxas serializes the
//    wgmmas on a path it takes for divergent (note C7520).
//  - Persistent blocks: a grid of the SM count (one block an SM) walks
//    the (entity, part) items in a fixed stride, and the producer stages
//    the next item's first stages while the consumers write A, so A's
//    write overlaps the next item's gather.
//  - Epilogue: each lower 64 x 64 block goes from the accumulators into a
//    64 x 65 f32 buffer of its warpgroup and from there into A as rows of
//    four floats (16-byte stores when w % 4 == 0): the block and its
//    transpose from the same values, a diagonal block's upper half from
//    its lower half, the ridge added as the diagonal is written. A is
//    bit-symmetric by construction.
//
// Every entry of A and b is one warpgroup's chain of wgmma steps in slot
// order (ceil(R / 16) that carry products, the rest of the last stage adds
// exact zeros), with no adds across warpgroups, so the bits do not
// depend on which block took an item, and equal runs give equal bits. The
// wrapper's error bound (ops/fused_gram.py) holds as for an mma.sync step.

constexpr int kWgThreads = 128;               // a warpgroup
constexpr int kWideThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kWideSlots = 64;                // slots a stage
constexpr int kAtom = 1024;    // 8 slots x 64 columns bf16, 128-byte swizzle
constexpr int kRatTile = 256;  // a 16-slot step's ratings as a K-major B
constexpr int kEpiS = 65;      // f32 row stride of a staged 64 x 64 block
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducerRegs * kWgThreads + 2 * kConsumerRegs * kWgThreads <=
                  65536,
              "register file");

template <int T64>  // 64-column blocks a side of A: 3 or 4
struct WideCfg {
  static_assert(T64 == 3 || T64 == 4, "wide body width");
  static constexpr int kStages = T64 == 3 ? 7 : 5;
  static constexpr int kRows = 8 * T64 * kAtom;  // a stage's 64 rows
  static constexpr int kStage = kRows + (kWideSlots / 16) * kRatTile;
  static_assert(kStage % kAtom == 0, "atoms on 1 KB boundaries");
  static constexpr int kEpi = 64 * kEpiS * 4;
  static constexpr int kEpiOff = kStages * kStage;
  static constexpr int kBarOff = kEpiOff + 2 * kEpi;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + kAtom;
};

// The lower 64 x 64 blocks of consumer warpgroup G: runs (row r, first
// column c, blocks n) of adjacent blocks in one block row, one wgmma a run
// and step; nb row blocks of b (rows b0, b1).
template <int T64, int G>
struct Deal;
template <>
struct Deal<4, 0> {
  static constexpr int r0 = 0, c0 = 0, n0 = 1, r1 = 3, c1 = 0, n1 = 4;
  static constexpr int nb = 2, b0 = 0, b1 = 3;
};
template <>
struct Deal<4, 1> {
  static constexpr int r0 = 1, c0 = 0, n0 = 2, r1 = 2, c1 = 0, n1 = 3;
  static constexpr int nb = 2, b0 = 1, b1 = 2;
};
template <>
struct Deal<3, 0> {
  static constexpr int r0 = 0, c0 = 0, n0 = 1, r1 = 2, c1 = 0, n1 = 2;
  static constexpr int nb = 2, b0 = 0, b1 = 2;
};
template <>
struct Deal<3, 1> {
  static constexpr int r0 = 1, c0 = 0, n0 = 2, r1 = 2, c1 = 2, n1 = 1;
  static constexpr int nb = 1, b0 = 1, b1 = 1;
};

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets, layout (1: 128-byte swizzle, 0: none)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// d (m64nN, f32) += F^T (m64k16) F (k16nN), both MN-major in shared memory
__device__ __forceinline__ void wgmma_gram(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_gram(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_gram(float (&d)[96], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_gram(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rat(float (&d)[4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrives on bar when this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// a consumer warpgroup's named barrier (id 1 + G, its 128 threads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kWgThreads) : "memory");
}

// (item, e, first slot, R) of item `it`: item = e * parts + part
__device__ __forceinline__ int item_slots(int it, int parts, int R_part,
                                          int R_all, int& e, int& p0) {
  e = it / parts;
  p0 = (it - e * parts) * R_part;
  return min(R_part, R_all - p0);
}

// Block (bi, bj) of A from the warpgroup's staged 64 x 64 buffer S, and
// unless it is diagonal its transpose (bj, bi) from the same values; on a
// diagonal block the upper half takes the lower half's values and the
// ridge goes on as the diagonal is written. Rows of four floats.
__device__ __forceinline__ void store_block(const float* S, float* Ae, int w,
                                            int bi, int bj, float rg, int t) {
  const bool diag = bi == bj;
  const bool st4 = (w & 3) == 0;
  const int i0 = 64 * bi, j0 = 64 * bj;
  auto put = [&](float* dst, const float (&x)[4], int room) {
    if (st4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < room) dst[q] = x[q];
      }
    }
  };
#pragma unroll 2
  for (int v = t; v < 64 * 16; v += kWgThreads) {
    const int r = v >> 4;
    const int c = (v & 15) * 4;
    float x[4];
    if (i0 + r < w && j0 + c < w) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cc = c + q;
        x[q] = diag && r < cc ? S[cc * kEpiS + r] : S[r * kEpiS + cc];
        if (diag && r == cc) x[q] += rg;
      }
      put(Ae + static_cast<long long>(i0 + r) * w + j0 + c, x, w - j0 - c);
    }
    if (!diag && j0 + r < w && i0 + c < w) {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = S[(c + q) * kEpiS + r];
      put(Ae + static_cast<long long>(j0 + r) * w + i0 + c, x, w - i0 - c);
    }
  }
}

// A run's blocks, one at a time, through the warpgroup's buffer S into A:
// block q's accumulators 32 q + 4 c8 + {0, 1} sit at (row, 64 q + 8 c8 +
// c2 + {0, 1}), + {2, 3} at row + 8 (the wgmma m64nN fragment)
template <int BAR, int N>
__device__ __forceinline__ void run_out(const float (&acc)[N], float* S,
                                        float* Ae, int w, int r, int c0,
                                        float rg, int t) {
  const int lane = t & 31;
  const int row = 16 * (t >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < N / 32; ++q) {
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      float* d = S + row * kEpiS + 8 * c8 + c2;
      d[0] = acc[32 * q + 4 * c8];
      d[1] = acc[32 * q + 4 * c8 + 1];
      d[8 * kEpiS] = acc[32 * q + 4 * c8 + 2];
      d[8 * kEpiS + 1] = acc[32 * q + 4 * c8 + 3];
    }
    wg_sync(BAR);
    store_block(S, Ae, w, r, c0 + q, rg, t);
    wg_sync(BAR);
  }
}

// Consumer warpgroup G: every item's stages through its runs' wgmmas, then
// its blocks of A and rows of b.
template <int T64, int G, int N0, int N1>
__device__ __forceinline__ void wide_consume(
    unsigned char* smem, uint32_t base, const float* __restrict__ reg,
    float* __restrict__ A, float* __restrict__ b, int items, int R_all,
    int parts, int R_part, int w) {
  using C = WideCfg<T64>;
  using D = Deal<T64, G>;
  const int t = threadIdx.x - kWgThreads * (1 + G);
  const int lane = t & 31;
  const int row = 16 * (t >> 5) + (lane >> 2);  // accumulator row (and +8)
  const int c2 = 2 * (lane & 3);                // accumulator column pair
  const uint32_t full0 = base + C::kBarOff;
  const uint32_t empty0 = full0 + 8 * C::kStages;
  float* S = reinterpret_cast<float*>(smem + C::kEpiOff + G * C::kEpi);
  float acc0[N0 / 2], acc1[N1 / 2], accb0[4], accb1[4];
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int e, p0;
    const int R = item_slots(it, parts, R_part, R_all, e, p0);
    const int nst = (R + kWideSlots - 1) / kWideSlots;
    zero_acc(acc0);
    zero_acc(acc1);
    zero_acc(accb0);
    zero_acc(accb1);
    int pending = -1;  // the stage whose wgmmas may still read it
    for (int st = 0; st < nst; ++st) {
      mbar_wait(full0 + 8 * stage, phase);
      // the rows landed through the generic proxy; wgmma reads through
      // the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgmma_fence();
      const uint32_t sb = base + stage * C::kStage;
      // every step, the slots past R included (zero rows; see the note)
#pragma unroll
      for (int ks = 0; ks < kWideSlots / 16; ++ks) {
        const uint32_t kb = sb + 2 * ks * T64 * kAtom;  // slots 16 ks..
        auto desc = [&](int blk) {
          return gmma_desc(kb + blk * kAtom, kAtom, T64 * kAtom, 1);
        };
        wgmma_gram(acc0, desc(D::r0), desc(D::c0));
        wgmma_gram(acc1, desc(D::r1), desc(D::c1));
        const uint64_t rd =
            gmma_desc(sb + C::kRows + ks * kRatTile, 128, 256, 0);
        wgmma_rat(accb0, desc(D::b0), rd);
        if (D::nb > 1) wgmma_rat(accb1, desc(D::b1), rd);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc0);
      fence_acc(acc1);
      fence_acc(accb0);
      fence_acc(accb1);
      if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
      pending = stage;
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    fence_acc(accb0);
    fence_acc(accb1);
    if (lane == 0) mbar_arrive(empty0 + 8 * pending);

    float* Ae = A + static_cast<long long>(it) * w * w;
    const float rg = reg != nullptr ? reg[e] : 0.0f;
    run_out<1 + G>(acc0, S, Ae, w, D::r0, D::c0, rg, t);
    run_out<1 + G>(acc1, S, Ae, w, D::r1, D::c1, rg, t);
    // b: column 0 of the m64n8 products (lanes with c2 == 0)
    float* be = b + static_cast<long long>(it) * w;
    if (c2 == 0) {
      if (64 * D::b0 + row < w) be[64 * D::b0 + row] = accb0[0];
      if (64 * D::b0 + row + 8 < w) be[64 * D::b0 + row + 8] = accb0[2];
      if (D::nb > 1) {
        if (64 * D::b1 + row < w) be[64 * D::b1 + row] = accb1[0];
        if (64 * D::b1 + row + 8 < w) be[64 * D::b1 + row + 8] = accb1[2];
      }
    }
  }
}

template <int T64, typename Idx>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_gram_wide_kernel(const __nv_bfloat16* __restrict__ table,
                       const Idx* __restrict__ idx,
                       const __nv_bfloat16* __restrict__ rat,
                       const float* __restrict__ reg, float* __restrict__ A,
                       float* __restrict__ b, int items, int R_all, int parts,
                       int R_part, int w, long long n_rows, int vec) {
  using C = WideCfg<T64>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: atoms on 1 KB boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtom - 1) & ~static_cast<uint32_t>(kAtom - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + C::kBarOff;
  const uint32_t empty0 = full0 + 8 * C::kStages;

  // the ring zeroed once: the padded columns and the rating tiles' other
  // rows are never written again
  for (int q = threadIdx.x; q < C::kStages * C::kStage / 16;
       q += kWideThreads) {
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 2 * kWgThreads);  // copies + plain stores
      mbar_init(empty0 + 8 * s, 2 * kWgThreads / 32);  // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it (see the note)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (role > 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    using D0 = Deal<T64, 0>;
    using D1 = Deal<T64, 1>;
    if (role == 1) {
      wide_consume<T64, 0, 64 * D0::n0, 64 * D0::n1>(
          smem, base, reg, A, b, items, R_all, parts, R_part, w);
    } else {
      wide_consume<T64, 1, 64 * D1::n0, 64 * D1::n1>(
          smem, base, reg, A, b, items, R_all, parts, R_part, w);
    }
    return;
  }

  // The producer warpgroup. Warp pw stages slots 16 pw .. 16 pw + 15 of
  // every stage, lane l the 16-byte chunk l of each row.
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int pw = t >> 5;
  const unsigned short* tb = reinterpret_cast<const unsigned short*>(table);
  const unsigned short* rt = reinterpret_cast<const unsigned short*>(rat);
  const long long zrow = n_rows - 1;  // the padding slots' row
  // The layouts point every padding slot at the table's last row, which
  // the factor tables keep at zero: if it is +-0 throughout, its slots are
  // zero-filled without a read (the same bits), else read like any row.
  bool zl = true;
  for (int c = lane; c < w; c += 32) {
    zl = zl && (tb[zrow * w + c] & 0x7fff) == 0;
  }
  const bool zero_last = __all_sync(0xffffffffu, zl);
  const int chunks = (w + 7) / 8;  // 16-byte chunks a row

  // A stage's position: its item, its index in the item, the item's slots
  // and the flat offset of the item's first slot in idx and rat (one
  // division an item, not a stage).
  struct Cursor {
    int it, st, R;
    long long base;
  };
  auto enter = [&](Cursor& c, int item) {
    c.it = item;
    c.st = 0;
    if (item < items) {
      int e, p0;
      c.R = item_slots(item, parts, R_part, R_all, e, p0);
      c.base = static_cast<long long>(e) * R_all + p0;
    }
  };
  auto step = [&](Cursor& c) {
    if (++c.st * kWideSlots >= c.R) enter(c, c.it + gridDim.x);
  };
  // this lane's index (lanes < 16: slot 16 pw + lane) and rating (t < 64:
  // slot t) of the stage at c, loaded a stage ahead
  auto fetch = [&](const Cursor& c, Idx& ix, unsigned short& ra) {
    const int ns = min(kWideSlots, c.R - c.st * kWideSlots);
    const long long off = c.base + c.st * kWideSlots;
    const int s = 16 * pw + (lane & 15);
    ix = lane < 16 && s < ns ? idx[off + s] : Idx(0);
    ra = t < ns ? rt[off + t] : static_cast<unsigned short>(0);
    return ns;
  };
  Cursor cur_c, nxt_c;
  enter(cur_c, blockIdx.x);
  Idx cur = 0;
  unsigned short cur_rat = 0;
  int cur_ns = fetch(cur_c, cur, cur_rat);
  nxt_c = cur_c;
  step(nxt_c);
  int stage = 0;
  uint32_t phase = 1;  // the first pass finds every stage empty
  while (cur_c.it < items) {
    Idx nxt = 0;
    unsigned short nxt_rat = 0;
    int nxt_ns = 0;
    if (nxt_c.it < items) nxt_ns = fetch(nxt_c, nxt, nxt_rat);

    // lanes < 16: their slot's row offset in the table, or -1 for a row of
    // zeros (past R, or the zero trash row); one range vote a stage
    const bool live = lane < 16 && 16 * pw + lane < cur_ns;
    const long long r = static_cast<long long>(cur);
    if (__any_sync(0xffffffffu, live && (r < 0 || r >= n_rows))) __trap();
    const long long ro = live && (r != zrow || !zero_last) ? r * w : -1;

    mbar_wait(empty0 + 8 * stage, phase);
    const uint32_t sb = base + stage * C::kStage;
    const uint32_t chunk = (lane & 7) << 4;
    const bool mine = lane < chunks;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int s = 16 * pw + i;
      const long long ri = __shfl_sync(0xffffffffu, ro, i);
      const uint32_t dst = sb + ((s >> 3) * T64 + (lane >> 3)) * kAtom +
                           (s & 7) * 128 + (chunk ^ ((s & 7) << 4));
      if (vec) {
        if (mine) {
          cp_async16_to(dst, ri >= 0 ? tb + ri + 8 * lane : tb,
                        ri >= 0 ? 16 : 0);
        }
      } else if (mine) {  // rows not whole 16-byte chunks: plain loads
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * lane + 2 * j;
          const uint32_t lo = ri >= 0 && col < w ? tb[ri + col] : 0u;
          const uint32_t hi = ri >= 0 && col + 1 < w ? tb[ri + col + 1] : 0u;
          v[j] = lo | (hi << 16);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                     "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
      }
    }
    if (t < kWideSlots) {  // slot t's rating: row 0 of its step's B tile
      const uint32_t dst = sb + C::kRows + (t >> 4) * kRatTile +
                           ((t >> 3) & 1) * 128 + (t & 7) * 2;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(cur_rat)
                   : "memory");
    }
    mbar_arrive_copies(full0 + 8 * stage);
    mbar_arrive(full0 + 8 * stage);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
    cur_c = nxt_c;
    step(nxt_c);
    cur = nxt;
    cur_rat = nxt_rat;
    cur_ns = nxt_ns;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int T64, typename Idx>
int launch_wide_t(const void* table, const void* idx, const void* rat,
                  const float* reg, float* A, float* b, long long ne, int R,
                  int parts, int R_part, int w, long long n_rows, int vec,
                  cudaStream_t stream) {
  using C = WideCfg<T64>;
  static_assert(C::kSmem <= 232448, "shared memory");
  auto kern = fused_gram_wide_kernel<T64, Idx>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  // persistent: the blocks that fit on the card at once walk the items
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kWideThreads, C::kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = ne * parts;
  const long long grid = items < static_cast<long long>(sms) * per_sm
                             ? items
                             : static_cast<long long>(sms) * per_sm;
  kern<<<static_cast<unsigned>(grid), kWideThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(table), static_cast<const Idx*>(idx),
      static_cast<const __nv_bfloat16*>(rat), reg, A, b,
      static_cast<int>(items), R, parts, R_part, w, n_rows, vec);
  return cudaGetLastError();
}

template <int T64>
int launch_wide(const void* table, const void* idx, const void* rat,
                const float* reg, float* A, float* b, long long ne, int R,
                int parts, int R_part, int w, long long n_rows, int idx64,
                int vec, cudaStream_t stream) {
  return idx64 ? launch_wide_t<T64, long long>(table, idx, rat, reg, A, b, ne,
                                               R, parts, R_part, w, n_rows,
                                               vec, stream)
               : launch_wide_t<T64, int>(table, idx, rat, reg, A, b, ne, R,
                                         parts, R_part, w, n_rows, vec,
                                         stream);
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
  if (w > kNarrowW) {
    return w <= 192 ? launch_wide<3>(table, idx, rat, reg, A, b, ne, R, parts,
                                     R_part, w, n_rows, idx64, vec, stream)
                    : launch_wide<4>(table, idx, rat, reg, A, b, ne, R, parts,
                                     R_part, w, n_rows, idx64, vec, stream);
  }
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
    default:
      return launch<8>(table, idx, rat, reg, A, b, ne, R, parts, R_part, w,
                       n_rows, idx64, vec, stream);
#undef YCNR_GRAM_CASE
  }
}
