// The bf16 Gramian on the tensor cores: F^T F of a row-major bf16 F (n, d)
// over its upper-triangle 128 x 128 tiles, TMA loads into wgmma, with one
// of two epilogues:
//   - ACC (STORE = false): gout = G + sums on the upper tiles only, nothing
//     mirrored, the strictly-lower tiles of gout never written; gout may be
//     G itself. With k > 0 it also writes cout = C + F^T R, R rounded to
//     bf16 (the correlation rides on the diagonal tiles, below); cout may be
//     C. gram_corr_sym_acc.cu's bf16 form (the sparse fold's step) and, with
//     k = 0, gram_corr.cu's gram_sym_acc (the streamed fold's step);
//   - STORE (STORE = true): out = sums, no correlation, and out is the whole
//     symmetric Gramian: an entry (r, c) with r <= c is written where it
//     was summed and, for r < c, at (c, r) too, from the same register, so
//     out is exactly symmetric and nothing is read back from it.
//     gram_corr.cu's block_gram_sym, whose tensor map starts at the window
//     (F + col_start, b columns at F's row stride).
// One mainloop, one set of STAGES, PROMOTE and GH, so the three wrappers
// give each other's bits: gram_sym_acc's Gramian is gram_corr_sym_acc's
// (the correlation touches neither the wgmmas nor their sums), and
// block_gram_sym's is gram_sym_acc's on G = 0 (0 + x = x exactly) with its
// upper triangle mirrored.
//
// Every 128 x 128 upper-triangle tile is one block of two consumer
// warpgroups and a producer warp. One producer thread keeps a ring of
// STAGES shared-memory stages full with TMA loads of 64 rows x 64 columns
// (128-byte swizzle; two boxes for each operand's 128 columns; mbarriers
// tell the consumers that a stage has landed and the producer that it has
// been read), and the two consumer warpgroups each run wgmma.m64n128k16
// (f32 accumulators in registers) on 64 rows of the tile. F is (n, d)
// row-major, so both operands are MN-major in shared memory (the reduction
// index, F's row, is the strided one): wgmma takes that transposed form
// from shared memory for 16-bit types. A diagonal tile's two operands are
// the same columns: it loads them once. TMA fills out-of-bounds elements
// with zeros, which masks ragged rows and the last, narrow column tile in
// the sums; a 64-column box that lies wholly past d is not loaded (the
// stale stage contents it leaves reach only masked outputs), and nothing
// past the map's d columns is read. The tensor map needs a 16-byte-aligned
// base and a row stride that is a multiple of 16 bytes: the wrappers copy
// an operand that has neither into rows of such a stride first
// (cuda_ops.py's _tma_layout_ok).
//
// Traffic. Every block loops over all n rows, so each wave of resident
// blocks reads its tiles' columns of F again. Blocks are numbered in groups
// of GH tile rows, and within a group column by column, so the ~132 blocks
// of a wave cover about GH + 132 / GH column tiles and read the same 64-row
// band at about the same time: L2 serves the other readers.
//
// Precision. The tensor cores' adds into an f32 accumulator do not round to
// nearest: summed on them alone, a 65,536-row tile drifted to 2.9e-4 of
// the sums' scale (one H100; cuBLAS's bf16 addmm drifts to 1.7e-4 there).
// So each warpgroup lets the wgmmas sum PROMOTE stages (128 rows) into one
// register tile and adds that into a second by FP32 adds: 1.4e-5 of scale,
// as the FP32 kernel's 2.0e-5. The two tiles take 128 registers a thread;
// a 128 x 256 tile would need 256 and does not fit, so N = 128. STAGES,
// PROMOTE and GH are the fastest of the values that
// scripts/torch_gram_variants.py measures.
//
// The sums have one fixed order (rows in order, no split over rows, no
// atomics), so every run gives the same bits, and in place gives the bits
// of a fresh buffer: each gout (and cout) entry is read and then written by
// the same thread.
//
// Correlation (ACC, k > 0). As in the TPU kernel
// (keystone_tpu/ops/pallas_ops.py:867-878), it rides on the diagonal
// tiles, whose staged F tile holds the tile's columns: each of the 256
// consumer threads owns one of the 128 columns and KG = 4 of the KP = 8
// label columns of a pass, reads its column from the swizzled stage and the
// pass's 64 x 8 R stage (rounded to bf16, staged by the consumers
// themselves) and sums on the CUDA cores. The Amazon fit has k = 2: one
// pass, fused with the Gramian. For k > 8 the diagonal block streams its F
// columns again for each further 8 label columns, with no wgmma.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kt_wgmma {

constexpr int KG = 4;       // label columns per thread and pass
constexpr int KP = 2 * KG;  // label columns per pass: two threads per F column

constexpr int TILE = 128;                // output tile, both dimensions
constexpr int BR = 64;                   // rows of F per stage
constexpr int BOX = 64;                  // columns of one TMA box (128 bytes of bf16)
constexpr int BOX_BYTES = BR * BOX * 2;  // 8 KB
constexpr int OPND_BYTES = 2 * BOX_BYTES;  // one operand's 128 columns: 16 KB
constexpr int STAGES = 4;
constexpr int PROMOTE = 2;               // stages summed on the tensor cores per FP32 add
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int TC_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int GH = 8;                    // tile rows per group of the block order
// The consumers hold PROMOTE stages before releasing them: more would stall
// the producer for good.
static_assert(PROMOTE <= STAGES, "PROMOTE stages must fit in the ring");
// Dynamic shared memory: the A and B rings, two R stages, the barriers,
// and slack to align the rings to the 1024-byte period of the swizzle.
constexpr int RS_FLOATS = BR * KP;
constexpr int SMEM_BYTES =
    2 * STAGES * OPND_BYTES + 2 * RS_FLOATS * 4 + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed. The spin is
// inside the asm, so the compiler sees no divergent loop around it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 64 x 64 box of F at (column x, row y) into shared memory at dst,
// completing on the barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma matrix descriptor of an MN-major operand in the 128-byte swizzle:
// the MN index runs along a 128-byte row (64 bf16) and K down the rows;
// one swizzle atom is 8 K rows (1024 bytes). The leading byte offset steps
// from one 64-wide MN atom to the next (the next TMA box, 8 KB on), the
// stride byte offset from one 8-row K group to the next (1 KB on); both
// in 16-byte units.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(BOX_BYTES >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

#define KT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define KT_F16(i) KT_F4(i), KT_F4(i + 4), KT_F4(i + 8), KT_F4(i + 12)

// d (64 x 128 f32 in the wgmma fragment) = A (64 x 16) B (16 x 128), plus
// d itself where accumulate is nonzero; both operands MN-major
// ("transposed") in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : KT_F16(0), KT_F16(16), KT_F16(32), KT_F16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef KT_F16
#undef KT_F4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Block p's upper-triangle tile (ti <= tj): tile rows go in groups of GH;
// inside a group, column by column (tj ascending), each column's tiles by
// row. So consecutive blocks share their columns of F.
__device__ __forceinline__ void tile_of(int p, int nt, int& ti, int& tj) {
  int g0 = 0;
  for (;;) {
    const int h = min(GH, nt - g0);
    const int count = h * (h + 1) / 2 + h * (nt - g0 - h);
    if (p < count) break;
    p -= count;
    g0 += GH;
  }
  const int h = min(GH, nt - g0);
  const int tri = h * (h + 1) / 2;
  if (p < tri) {  // the group's first h columns: column c holds c + 1 tiles
    int c = 0;
    while (p > c) {
      p -= c + 1;
      ++c;
    }
    tj = g0 + c;
    ti = g0 + p;
  } else {
    p -= tri;
    tj = g0 + h + p / h;
    ti = g0 + p % h;
  }
}

// Element (row r, column c) of a staged 64 x 128 operand: column c lies in
// box c / 64, whose row r holds its 16-byte chunks in the 128-byte swizzle
// (chunk q at position q ^ (r % 8)).
__device__ __forceinline__ float staged(const unsigned char* tile, int r, int c) {
  const int cc = c % BOX;
  const int off = (c / BOX) * BOX_BYTES + r * 128 + (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
  const uint32_t bits = *reinterpret_cast<const unsigned short*>(tile + off);
  return __uint_as_float(bits << 16);
}

// One block an upper tile of the d x d Gramian of the map's F (n, d). ACC
// reads G (and, for k > 0, R and C); STORE reads none of them.
template <bool STORE>
__global__ void __launch_bounds__(TC_THREADS, 1)
gram_kernel(const __grid_constant__ CUtensorMap fmap, const float* __restrict__ R,
            const float* G, const float* C, float* gout, float* cout, int n, int d, int k,
            long long ldr, long long ldg, long long ldc, long long ldgo, long long ldco,
            int nt) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sa = base;                          // STAGES x 16 KB
  unsigned char* sb = base + STAGES * OPND_BYTES;    // STAGES x 16 KB
  float* rs = reinterpret_cast<float*>(base + 2 * STAGES * OPND_BYTES);  // 2 x 64 x 8
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + 2 * RS_FLOATS);
  uint64_t* empty = full + STAGES;

  int ti, tj;
  tile_of(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;  // uniform over the block
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;
  const int nkb = (n + BR - 1) / BR;
  const int passes = diag ? max(1, (k + KP - 1) / KP) : 1;
  const int total = nkb * passes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, made warp-uniform for the compiler (a shuffle from lane
  // 0): wgmma must not sit on a path it sees as divergent, or it
  // serializes them.
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (w == CONSUMERS / 128) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x != CONSUMERS) return;
    const int abox = i0 + BOX < d ? 2 : 1;  // a box wholly past d is not loaded
    const int bbox = diag ? 0 : (j0 + BOX < d ? 2 : 1);
    const uint32_t bytes = (abox + bbox) * BOX_BYTES;
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, bytes);
      const int r0 = (it % nkb) * BR;
      const uint32_t a = smem_u32(sa + s * OPND_BYTES);
      const uint32_t b = smem_u32(sb + s * OPND_BYTES);
      for (int x = 0; x < abox; ++x) tma_load(a + x * BOX_BYTES, &fmap, bar, i0 + x * BOX, r0);
      for (int x = 0; x < bbox; ++x) tma_load(b + x * BOX_BYTES, &fmap, bar, j0 + x * BOX, r0);
    }
    return;
  }

  // Consumers: warpgroup w owns rows [64 w, 64 w + 64) of the tile.
  const int t = threadIdx.x;
  float acc[64];   // the tile's sums, added in FP32 on the CUDA cores
  float part[64];  // PROMOTE stages' products, summed by the tensor cores
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  fence_acc(part);
  // Correlation: this thread's F column and its KG label columns of a pass.
  const int cc = t % TILE;
  const int g = t / TILE;
  float cacc[KG] = {0.f, 0.f, 0.f, 0.f};

  // Iteration it's correlation step on a diagonal tile: stage R's rows of
  // the stage (label pass it / nkb) and add this thread's column's products;
  // at a pass's last stage, write C + F^T R for its labels.
  auto corr_step = [&](int it, const unsigned char* a_tile) {
    const int pass = it / nkb;
    const long long r0 = (long long)(it % nkb) * BR;
    float* rst = rs + (it & 1) * RS_FLOATS;
    for (int e = t; e < RS_FLOATS; e += CONSUMERS) {
      const long long gr = r0 + e / KP;
      const int gj = pass * KP + e % KP;
      const float v = (gr < n && gj < k) ? R[gr * ldr + gj] : 0.f;
      rst[e] = __bfloat162float(__float2bfloat16(v));
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll 8
    for (int r = 0; r < BR; ++r) {
      const float f = staged(a_tile, r, cc);
#pragma unroll
      for (int q = 0; q < KG; ++q) cacc[q] = fmaf(f, rst[r * KP + g * KG + q], cacc[q]);
    }
    if (it % nkb == nkb - 1) {
      const int r = i0 + cc;
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        const int j = pass * KP + g * KG + q;
        if (r < d && j < k) cout[(long long)r * ldco + j] = C[(long long)r * ldc + j] + cacc[q];
        cacc[q] = 0.f;
      }
    }
  };

  // The Gramian, with the first label pass on diagonal tiles. The wgmmas
  // sum PROMOTE stages into `part` (see Precision above); then `part` is
  // added into `acc` by one FP32 add an entry, and those stages are
  // released.
  const bool corr = !STORE && diag && k > 0;
  int pending = 0;  // the first iteration whose stage is not yet released
  for (int it = 0; it < nkb; ++it) {
    const int s = it % STAGES;
    mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
    const unsigned char* a_tile = sa + s * OPND_BYTES;
    const uint32_t a = smem_u32(a_tile + w * BOX_BYTES);
    const uint32_t b = diag ? smem_u32(a_tile) : smem_u32(sb + s * OPND_BYTES);
    const int first = it % PROMOTE == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)  // 16 rows = 2 K groups = 2 KB on
      wgmma_m64n128k16(part, mn_major_desc(a + kk * 2048), mn_major_desc(b + kk * 2048),
                       !(first && kk == 0));
    wgmma_commit();
    if (corr) corr_step(it, a_tile);
    if (it % PROMOTE == PROMOTE - 1 || it == nkb - 1) {
      wgmma_wait<0>();
      fence_acc(part);
      for (; pending <= it; ++pending) mbar_arrive(smem_u32(&empty[pending % STAGES]));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }

  if constexpr (!STORE) {
    // Further label passes (diagonal tiles, k > KP): F again, no Gramian.
    for (int it = nkb; it < total; ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
      corr_step(it, sa + s * OPND_BYTES);
      mbar_arrive(smem_u32(&empty[s]));
    }

    if (diag && nkb == 0) {  // no rows: cout = C
      const int r = i0 + cc;
      for (int pass = 0; pass < passes; ++pass)
#pragma unroll
        for (int q = 0; q < KG; ++q) {
          const int j = pass * KP + g * KG + q;
          if (r < d && j < k) cout[(long long)r * ldco + j] = C[(long long)r * ldc + j];
        }
    }
  }

  // The epilogue on this warpgroup's 64 x 128 part of the tile. Fragment:
  // warp wi of the warpgroup holds rows 16 wi + lane / 4 (+ 8), and each
  // 8-column chunk j columns 8 j + 2 (lane % 4) (+ 1), in acc[4 j .. 4 j + 3].
  const int lane = t % 32;
  const int row0 = i0 + w * 64 + ((t % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= d) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j0 + 8 * j + 2 * (lane % 4) + e;
        if (c >= d) continue;
        const float v = acc[4 * j + 2 * h + e];
        if constexpr (STORE) {
          if (r > c) continue;  // on a diagonal tile, the mirror of (c, r)
          gout[(long long)r * ldgo + c] = v;
          if (r < c) gout[(long long)c * ldgo + r] = v;
        } else {
          gout[(long long)r * ldgo + c] = G[(long long)r * ldg + c] + v;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, found through the runtime
// (so the library needs no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Returned when the tensor map of F cannot be made.
constexpr int TENSOR_MAP_FAILED = -1;

// The upper tiles of a d-wide Gramian: one block each.
inline int blocks(int d) {
  const int nt = (d + TILE - 1) / TILE;
  return nt * (nt + 1) / 2;
}

// The kernel instance with its dynamic shared memory allowed.
template <bool STORE>
cudaError_t instance() {
  return cudaFuncSetAttribute(gram_kernel<STORE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

// F (n, d) bf16 row-major at row stride ldf elements, its base 16-byte
// aligned and ldf a multiple of 8; the rest as gram_kernel's. Launches on
// `stream` and returns the launch's cudaError_t (0 = success), or
// TENSOR_MAP_FAILED.
template <bool STORE>
int launch(const void* F, long long ldf, int n, int d, const float* R, int k, long long ldr,
           const float* G, long long ldg, const float* C, long long ldc, float* gout,
           long long ldgo, float* cout, long long ldco, cudaStream_t stream) {
  CUtensorMap fmap = {};
  if (n > 0) {  // no rows: nothing is loaded and the map is never read
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return TENSOR_MAP_FAILED;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldf) * 2};
    const cuuint32_t box[2] = {BOX, BR};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&fmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(F), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return TENSOR_MAP_FAILED;
  }
  const cudaError_t attr = instance<STORE>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nt = (d + TILE - 1) / TILE;
  gram_kernel<STORE><<<blocks(d), TC_THREADS, SMEM_BYTES, stream>>>(
      fmap, R, G, C, gout, cout, n, d, k, ldr, ldg, ldc, ldgo, ldco, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kt_wgmma
