// The pipelined FP32-FMA tile of block_corr.cu, the Gramians of
// gram_tile.cuh (gram_corr.cu, gram_corr_sym_acc.cu's float32 form),
// block_residual_update.cu, gaussian_kernel_block.cu, gaussian_resid_block.cu,
// cosine_features.cu and conv_featurize.cu: the port's one FP32-FMA tile.
//
// One block of 256 threads (16 x 16) owns an output tile of 16 MI rows x
// 16 NJ columns: out[i][j] = sum over the reduction index r of
// P[i0 + i, r] * Q[j0 + j, r]. Each thread keeps MI x NJ outputs in
// registers (8 x 8 for a 128 x 128 tile, 8 x 10 for 128 rows x 160 label
// columns, 8 x 7 for conv_featurize's 112 filters, 8 x 1 for
// gaussian_resid_block's 16-wide label pass). Each
// operand is one of two kinds:
//   - row-major (the reduction runs along its rows): P[i, r] is M[r][i],
//     as the window in F_w^T R and A in A^T A;
//   - K-major (the reduction runs along its contiguous columns): P[i, r]
//     is M[i][r], as the window in F_w dW and both X and Y in X Y^T.
// The reduction goes through shared memory BK at a time, in a ring of
// STAGES stages filled with cp.async (or register stores, below): while
// the block multiplies stage s, the copies of stages s + 1 ... s + STAGES
// - 1 are in flight, and one __syncthreads a stage both publishes stage s
// and frees the slot that the next copy refills.
//
// Operands are copied as they are stored: bf16 stays bf16 in shared memory
// and is widened to float when a thread reads it (a shift), so products and
// sums stay float32 ("f32 means f32": no TF32, no tensor cores). An operand
// whose base pointer, row stride and extent along its contiguous axis are
// whole 16-byte chunks is copied in 16-byte cp.async.cg chunks (VEC);
// otherwise element by element: float32 through 4-byte cp.async.ca,
// bfloat16 (2-byte aligned only) through registers. A row-major operand
// whose base and row stride are whole chunks but whose width is not (the
// sparse fold's d1 = 16385) takes the 16-byte copies too, the chunk that
// holds its last column copied in part (PART): a per-thread byte count that
// the whole-chunk instances do without (it cost them 2.5-4.5% at the
// Gramian shapes on an H100). Copies past the last row or column
// zero-fill, so ragged edges add nothing.
//
// A K-major operand goes through registers (KStager): each thread loads
// its 16-byte chunks (or elements) of a stage along k one stage ahead and,
// once the stage's slot is free, stores them transposed into a row-major
// stage, so the FMA loop reads both kinds the same way. cp.async cannot
// transpose; a stage copied as stored (rows of BK contiguous elements)
// would have the FMA loop read along k, where a warp's 16 tx threads read
// rows 4 apart and, with BK = 16 floats a row, hit one bank group unless
// every 4 rows carry a 16-byte pad. That form was built and measured slower
// than this one for both kernels that take a K-major operand, and spilled
// (PERF.md, PR 9). Here a warp loads one chunk column of 32 consecutive
// rows and stores each of its values to 32 consecutive words of one stage
// row: no bank conflicts, and the reads are those of a row-major stage.
//
// Every output is one fmaf chain over the reduction index in increasing
// order, whatever BK, STAGES, the operand kinds or the thread map:
// acc = fmaf(p, q, acc) for r = rbeg, rbeg + 1, ... (the zero entries past
// rend leave it as it is). So a Gramian computed here has the bits of one
// summed row by row, from zero, in any other tiling. With FLUSH > 0 the
// chain restarts every FLUSH stages: the loop hands acc to a flush functor
// after each such chunk of stages (and after the last stage) and zeroes it,
// with the ring's copies still in flight (gram_tile.cuh's row chunks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace kt_pipe {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 128;       // output tile rows at 8 a thread (16 threads x 8)

// Label tiles, for a Q that is R or dW (k label columns): one tile holds
// all of them up to KT_WIDE (10 a thread), so k = 147 masks 8% of its
// FMAs; k <= KT_NARROW takes a 32-wide tile (2 a thread), and k > 160
// further 160-wide tiles.
constexpr int KT_NARROW = 32;
constexpr int KT_WIDE = 160;

// fn(std::integral_constant<int, NJ>) for the label tile of k columns,
// 16 * NJ wide.
template <typename Fn>
inline auto with_label_tile(int k, Fn&& fn) {
  return k <= KT_NARROW ? fn(std::integral_constant<int, KT_NARROW / 16>{})
                        : fn(std::integral_constant<int, KT_WIDE / 16>{});
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copies the first `bytes` (0 ... 16) of the 16-byte chunk at src and
// zero-fills the rest of dst's.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four (two, one) consecutive shared-memory elements, widened to float.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

template <typename TE>
__device__ __forceinline__ TE zero() {
  if constexpr (sizeof(TE) == 4)
    return 0.f;
  else
    return __ushort_as_bfloat16(0);
}

template <typename TE>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(TE));
}

// Host: whether a row-major operand M (base pointer, row stride ld) can be
// copied by Stager in 16-byte chunks: every chunk then starts on a 16-byte
// boundary inside its row (PART where the width is not whole chunks).
template <typename TE>
inline bool rows_vec_ok(const TE* base, long long ld) {
  return reinterpret_cast<std::uintptr_t>(base) % 16 == 0 && ld % vec_elems<TE>() == 0;
}

// Host: whether a tile of M (base pointer, row stride ld, cols columns) can
// be copied in 16-byte chunks that lie wholly inside or wholly past the
// columns.
template <typename TE>
inline bool vec_ok(const TE* base, long long ld, long long cols) {
  return rows_vec_ok(base, ld) && cols % vec_elems<TE>() == 0;
}

// The copies one thread makes of a row-major operand M (row stride ld),
// tile columns [c0, c0 + W) of rows [rbeg, rend), one BK-row stage at a
// time, in stage order, into a row-major BK x W tile of TE in shared
// memory; zero at rows >= rend and columns >= cols. Addresses are set up
// once: a stage's copy is a pointer step and a row test.
//
// VEC, 16-byte chunks: CPR chunks a row, so THREADS / CPR rows a pass; a
// thread copies the same chunk column of rows kk0, kk0 + RPP, ... and a
// warp consecutive chunks of one row. PART: the chunk that holds the last
// column reads the bytes inside the columns and zero-fills the rest
// (cp.async's src-size), so cols need not be whole chunks.
// Element-wise: TPR = THREADS / BK threads a row, so a thread copies one row
// kk0 of every stage, columns tc, tc + TPR, ..., and a warp TPR consecutive
// elements of each of two rows (4-byte cp.async for float32, registers for
// bf16).
template <typename TE, int BK, int W, bool VEC, bool PART = false>
struct Stager;

template <typename TE, int BK, int W, bool PART>
struct Stager<TE, BK, W, true, PART> {
  static constexpr int EPC = vec_elems<TE>();
  static constexpr int CPR = W / EPC;       // chunks a row
  static constexpr int RPP = THREADS / CPR;  // rows a pass
  static constexpr int PASSES = BK > RPP ? BK / RPP : 1;  // (threads past row BK idle)
  static_assert(W % EPC == 0 && THREADS % CPR == 0 && (BK % RPP == 0 || RPP % BK == 0),
                "a stage must be whole passes of whole 16-byte chunks");
  const TE* p;     // this thread's chunk in its first row of the next stage
  long long ld;
  int left;        // rows left from that row on
  int soff;        // its offset in the shared tile
  bool col_ok;
  int bytes;       // PART: of its chunk inside the columns, 16 but at the last column

  __device__ __forceinline__ Stager(const TE* M, long long ld_, long long rbeg, long long rend,
                                    long long c0, long long cols) {
    const int kk0 = threadIdx.x / CPR;
    const int c = (threadIdx.x % CPR) * EPC;
    p = M + (rbeg + kk0) * ld_ + c0 + c;
    ld = ld_;
    left = static_cast<int>(rend - rbeg) - kk0;
    soff = kk0 * W + c;
    col_ok = c0 + c < cols && kk0 < BK;
    if constexpr (PART) {
      const long long in_cols = cols - c0 - c;
      bytes = static_cast<int>(in_cols < EPC ? in_cols : EPC) * static_cast<int>(sizeof(TE));
    }
  }
  __device__ __forceinline__ void copy(TE* S) {
#pragma unroll
    for (int m = 0; m < PASSES; ++m)
      if (RPP <= BK || col_ok)
        cp_async16(S + soff + m * RPP * W, p + m * RPP * ld,
                   col_ok && m * RPP < left ? (PART ? bytes : 16) : 0);
    p += BK * ld;
    left -= BK;
  }
};

template <typename TE, int BK, int W, bool PART>
struct Stager<TE, BK, W, false, PART> {
  static constexpr int TPR = THREADS / BK;  // threads a row
  static_assert(THREADS % BK == 0 && W % TPR == 0, "a stage row must be whole thread rows");
  const TE* p;     // this thread's first element in its row of the next stage
  long long ld;
  int left;        // rows left from that row on
  int soff;        // its offset in the shared tile
  int col_lim;     // its element e lies inside the columns when e * TPR < col_lim

  __device__ __forceinline__ Stager(const TE* M, long long ld_, long long rbeg, long long rend,
                                    long long c0, long long cols) {
    const int kk0 = threadIdx.x / TPR;
    const int tc = threadIdx.x % TPR;
    p = M + (rbeg + kk0) * ld_ + c0 + tc;
    ld = ld_;
    left = static_cast<int>(rend - rbeg) - kk0;
    soff = kk0 * W + tc;
    const long long lim = cols - c0 - tc;
    col_lim = static_cast<int>(lim < W ? lim : W);
  }
  __device__ __forceinline__ void copy(TE* S) {
    const bool row_ok = left > 0;
#pragma unroll
    for (int e = 0; e < W / TPR; ++e) {
      const bool ok = row_ok && e * TPR < col_lim;
      if constexpr (sizeof(TE) == 4)
        cp_async4(S + soff + e * TPR, p + e * TPR, ok);
      else
        S[soff + e * TPR] = ok ? p[e * TPR] : __ushort_as_bfloat16(0);
    }
    p += BK * ld;
    left -= BK;
  }
  // Round the float32 elements this thread copied into S to bf16, in place:
  // a bf16 operand's partner, as the TPU's bf16 matrix unit sees it. Runs
  // after the thread's copies of S landed and before the barrier that
  // publishes them.
  __device__ __forceinline__ void round_own(float* S) const {
#pragma unroll
    for (int e = 0; e < W / TPR; ++e) S[soff + e * TPR] = round_bf16(S[soff + e * TPR]);
  }
};

// The loads and stores one thread makes of a K-major operand M (row-major,
// row stride ld) through registers: rows [r0, r0 + W) of its reduction
// columns [kbeg, kend), each BK-column stage stored transposed into a
// row-major BK x W stage (element (k, row) at k * W + row, Stager's
// layout), so the FMA loop reads it as a row-major operand; zero at rows
// >= rows and columns >= kend. A thread keeps one row: load (16-byte chunk,
// or element) e = t + q THREADS of a stage is row e % W, column e / W, so
// a warp loads one column of 32 consecutive rows and stores each value to
// 32 consecutive words of one stage row, free of bank conflicts.
// VEC, 16-byte chunks: each stage is loaded one copy ahead: copy(S) stores
// the stage loaded before (by the constructor or the previous copy) into
// S, then loads the next, whose loads are in flight while the block
// multiplies. Element-wise (a ragged or unaligned operand): copy(S) loads
// its stage and stores it at once, holding no registers across the FMA
// loop (a stage held would be 8 loads a thread at BK = 16, and spilled).
template <typename TE, int BK, int W, bool VEC>
struct KStager {
  static constexpr int EPL = VEC ? vec_elems<TE>() : 1;   // elements a load
  static constexpr int LPR = BK / EPL;                     // loads a stage row
  static constexpr int SPAN = THREADS / W;                 // a thread's load columns apart
  static constexpr int N = (W * LPR + THREADS - 1) / THREADS;  // loads a thread
  static_assert(THREADS % W == 0 && BK % EPL == 0, "a stage must be whole loads of whole rows");
  using Load = std::conditional_t<VEC, uint4, TE>;
  const TE* p;     // this thread's first load in its row, next stage
  int row;         // its row in the tile
  int c0;          // its first load column
  int kleft;       // reduction columns left from that load on; < 0 past its row
  Load v[VEC ? N : 1];  // (VEC) the stage loaded and not yet stored

  __device__ __forceinline__ KStager(const TE* M, long long ld, long long kbeg, long long kend,
                                     long long r0, long long rows) {
    row = threadIdx.x % W;
    c0 = threadIdx.x / W;
    p = M + (r0 + row) * ld + kbeg + c0 * EPL;
    kleft = r0 + row < rows ? static_cast<int>(kend - kbeg) - c0 * EPL : -(1 << 30);
    if constexpr (VEC) load();
  }
  __device__ __forceinline__ bool valid(int q) const {
    return c0 + q * SPAN < LPR && q * SPAN * EPL < kleft;
  }
  __device__ __forceinline__ void load() {
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = valid(q) ? __ldg(reinterpret_cast<const uint4*>(p + q * SPAN * EPL))
                      : make_uint4(0, 0, 0, 0);
    p += BK;
    kleft -= BK;
  }
  __device__ __forceinline__ void copy(TE* S) {
    if constexpr (!VEC) {
#pragma unroll
      for (int q = 0; q < N; ++q)
        if (c0 + q * SPAN < LPR) S[(c0 + q * SPAN) * W + row] = valid(q) ? p[q * SPAN] : zero<TE>();
      p += BK;
      kleft -= BK;
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        if (c0 + q * SPAN >= LPR) break;
        TE* dst = S + (c0 + q * SPAN) * EPL * W + row;
        const unsigned u[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          if constexpr (sizeof(TE) == 4)
            dst[e * W] = __uint_as_float(u[e]);
          else
            dst[e * W] = __ushort_as_bfloat16(
                static_cast<unsigned short>(u[e / 2] >> (16 * (e % 2))));
        }
      }
      load();
    }
  }
};

// An operand's copies: K-major (K) or row-major (PART: Stager's).
template <typename TE, int BK, int W, bool VEC, bool K, bool PART = false>
using Operand = std::conditional_t<K, KStager<TE, BK, W, VEC>, Stager<TE, BK, W, VEC, PART>>;

// Tile-local row of a thread's i-th output row (MI a thread: 2 neighbours,
// or groups of four, 64 apart) and column of its j-th output column (NJ a
// thread: groups of four, 64 apart, then NJ % 4 = 1 or 2 more past the
// last group; NJ % 4 = 3 as a pair, then one more 32 columns on, so a
// thread reads them as one 8-byte and one 4-byte word).
template <int MI>
__device__ __forceinline__ int out_row(int i) {
  const int ty = threadIdx.x / 16;
  return MI == 2 ? ty * 2 + i : (i / 4) * 64 + ty * 4 + i % 4;
}
template <int NJ>
__device__ __forceinline__ int out_col(int j) {
  constexpr int Q4 = NJ / 4;
  constexpr int REM = NJ % 4;
  const int tx = threadIdx.x % 16;
  if (j < 4 * Q4) return (j / 4) * 64 + tx * 4 + j % 4;
  if (REM == 3 && j == 4 * Q4 + 2) return Q4 * 64 + 32 + tx;
  return Q4 * 64 + tx * (REM == 3 ? 2 : REM) + (j - 4 * Q4);
}

// acc[i][j] += sum over the BK rows kk of X[kk][out_row<MI>(i)] * Y[kk][out_col<NJ>(j)].
template <int BK, int MI, int NJ, typename TP, typename TQ>
__device__ __forceinline__ void fma_stage(const TP* X, const TQ* Y, float (&acc)[MI][NJ]) {
  static_assert(MI == 2 || MI == 4 || MI == 8, "MI must be 2, 4 or 8");
  constexpr int XT = 16 * MI;
  constexpr int KT = 16 * NJ;
  constexpr int Q4 = NJ / 4;
  constexpr int REM = NJ % 4;
  static_assert(NJ > 0, "NJ must be positive");
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[MI];
    if constexpr (MI == 2) {
      const float2 v = ld2(X + kk * XT + ty * 2);
      a[0] = v.x;
      a[1] = v.y;
    }
#pragma unroll
    for (int q = 0; q < MI / 4; ++q) {
      const float4 v = ld4(X + kk * XT + q * 64 + ty * 4);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    float b[NJ];
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      const float4 v = ld4(Y + kk * KT + q * 64 + tx * 4);
      b[4 * q] = v.x;
      b[4 * q + 1] = v.y;
      b[4 * q + 2] = v.z;
      b[4 * q + 3] = v.w;
    }
    if constexpr (REM == 1) b[4 * Q4] = ld1(Y + kk * KT + Q4 * 64 + tx);
    if constexpr (REM >= 2) {
      const float2 v = ld2(Y + kk * KT + Q4 * 64 + tx * 2);
      b[4 * Q4] = v.x;
      b[4 * Q4 + 1] = v.y;
    }
    if constexpr (REM == 3) b[4 * Q4 + 2] = ld1(Y + kk * KT + Q4 * 64 + 32 + tx);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// mainloop's flush functor when no chain restarts.
struct NoFlush {
  template <typename Acc>
  __device__ __forceinline__ void operator()(const Acc&) const {}
};

// Shared memory of one block: STAGES stages of a BK x 16 MI P tile and a
// BK x 16 NJ Q tile.
template <typename TP, typename TQ, int BK, int STAGES, int MI, int NJ>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * BK * 16 *
         (MI * static_cast<int>(sizeof(TP)) + NJ * static_cast<int>(sizeof(TQ)));
}

// acc[i][j] = sum over r in [rbeg, rend) of P(i0 + out_row<MI>(i), r) *
// Q(j0 + out_col<NJ>(j), r): for a row-major operand M(i, r) = M[r][i],
// for a K-major one (KP, KQ) M[i][r]; indices i past pcols (j past qcols)
// read as zero. round_q rounds Q's values to bf16 as they arrive (float32
// row-major Q staged element-wise only). PP, PQ: a row-major VEC operand's
// last 16-byte chunk copied in part (Stager's PART). FLUSH (a power of two,
// or 0 for none): after every FLUSH stages and after the last, flush(acc)
// is called with the chunk's sums and acc is zeroed; with no stage at all it
// is not called.
template <int BK, int STAGES, int MI, int NJ, bool VP, bool VQ, bool KP = false,
          bool KQ = false, bool PP = false, bool PQ = false, int FLUSH = 0, typename TP,
          typename TQ, typename Flush = NoFlush>
__device__ __forceinline__ void mainloop(unsigned char* smem, const TP* __restrict__ P,
                                         long long ldp, long long i0, long long pcols,
                                         const TQ* __restrict__ Q, long long ldq,
                                         long long j0, long long qcols, long long rbeg,
                                         long long rend, bool round_q,
                                         float (&acc)[MI][NJ], Flush flush = Flush{}) {
  static_assert(STAGES >= 2, "the ring needs two stages at least");
  static_assert((FLUSH & (FLUSH - 1)) == 0, "FLUSH must be a power of two");
  constexpr int XT = 16 * MI;
  constexpr int KT = 16 * NJ;
  TP* Xs = reinterpret_cast<TP*>(smem);
  TQ* Ys = reinterpret_cast<TQ*>(smem + STAGES * BK * XT * sizeof(TP));
  const int nst = rend > rbeg ? static_cast<int>((rend - rbeg + BK - 1) / BK) : 0;
  Operand<TP, BK, XT, VP, KP, PP> xs(P, ldp, rbeg, rend, i0, pcols);
  Operand<TQ, BK, KT, VQ, KQ, PQ> ys(Q, ldq, rbeg, rend, j0, qcols);

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) {
      xs.copy(Xs + s * BK * XT);
      ys.copy(Ys + s * BK * KT);
    }
    cp_async_commit();
  }
  int slot = 0;       // stage s's slot, s % STAGES
  int fill = STAGES - 1;  // the slot of stage s + STAGES - 1
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    if constexpr (!VQ && !KQ && sizeof(TQ) == 4) {
      if (round_q) ys.round_own(reinterpret_cast<float*>(Ys + slot * BK * KT));
    }
    // Stage s is complete for every thread, and every thread is done with
    // stage s - 1, whose slot the next copy refills.
    __syncthreads();
    if (s + STAGES - 1 < nst) {
      xs.copy(Xs + fill * BK * XT);
      ys.copy(Ys + fill * BK * KT);
    }
    cp_async_commit();
    fma_stage<BK, MI, NJ>(Xs + slot * BK * XT, Ys + slot * BK * KT, acc);
    if constexpr (FLUSH > 0) {
      if (((s + 1) & (FLUSH - 1)) == 0 || s + 1 == nst) {
        flush(acc);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  }
  cp_async_wait<0>();
}

// Store a thread's outputs of the tile at (i0, j0) into the row-major
// (rows, cols) matrix out, inside its edges.
template <int MI, int NJ>
__device__ __forceinline__ void store_tile(float* __restrict__ out, long long rows,
                                           long long cols, long long i0, long long j0,
                                           const float (&acc)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long r = i0 + out_row<MI>(i);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < cols) out[r * cols + c] = acc[i][j];
    }
  }
}

}  // namespace kt_pipe
