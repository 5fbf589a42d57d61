// The FP32-FMA register tile shared by the port's GEMM-shaped kernels
// (gram_corr_sym.cu, block_gram_sym.cu, block_corr.cu,
// block_residual_update.cu).
//
// One block of 256 threads owns a 128 x 128 output tile. Each step stages
// BK = 8 reduction rows of both operands in shared memory as float, then
// every thread (16 x 16 of them) accumulates its 8 x 8 outputs in
// registers, feeding 16 FMAs from each float4 shared-memory load. bf16
// operands are widened to float on their way into shared memory; products
// and sums stay float32 ("f32 means f32": no TF32, no tensor cores).
//
// Shared rows are padded to LDS = T + 4 floats: the row stays 16-byte
// aligned for the float4 loads, and the transposed staging (stage_cols)
// stores without bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kt {

constexpr int T = 128;        // output tile width (both dimensions)
constexpr int BK = 8;         // reduction steps per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = T + 4;    // padded shared-memory row, in floats

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Stage rows [r0, r0 + BK) x columns [c0, c0 + T) of a row-major matrix M
// (rows < rows, columns < cols, row stride ld) into S[row - r0][col - c0],
// zero past the edges. Element e of the 1024 is (row e / T, column e % T):
// a warp reads 32 consecutive elements of one row. `round` rounds each
// value to bf16 first (a bf16 operand's partner, as the TPU's bf16 matrix
// unit sees it).
template <typename TM>
__device__ __forceinline__ void stage_rows(float (*S)[LDS], const TM* __restrict__ M,
                                           long long r0, long long c0, long long rows,
                                           long long cols, long long ld,
                                           bool round = false) {
#pragma unroll
  for (int i = 0; i < (T * BK) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int kk = e / T;
    const int c = e % T;
    const long long gr = r0 + kk;
    const long long gc = c0 + c;
    const float v = (gr < rows && gc < cols) ? to_float(M[gr * ld + gc]) : 0.f;
    S[kk][c] = round ? round_bf16(v) : v;
  }
}

// Stage rows [r0, r0 + T) x columns [c0, c0 + BK) of M transposed, into
// S[col - c0][row - r0]. Element e is (row e / BK, column e % BK): eight
// neighbouring threads read BK consecutive elements of one row.
template <typename TM>
__device__ __forceinline__ void stage_cols(float (*S)[LDS], const TM* __restrict__ M,
                                           long long r0, long long c0, long long rows,
                                           long long cols, long long ld) {
#pragma unroll
  for (int i = 0; i < (T * BK) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / BK;
    const int kk = e % BK;
    const long long gr = r0 + r;
    const long long gc = c0 + kk;
    S[kk][r] = (gr < rows && gc < cols) ? to_float(M[gr * ld + gc]) : 0.f;
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Tile-local row of this thread's i-th output row, and column of its j-th
// output column: two groups of four, 64 apart.
__device__ __forceinline__ int tile_row(int i) {
  const int ty = threadIdx.x / 16;
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int j) {
  const int tx = threadIdx.x % 16;
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[i][j] += sum over kk of X[kk][tile_row(i)] * Y[kk][tile_col(j)].
__device__ __forceinline__ void fma_stage(float (*X)[LDS], float (*Y)[LDS],
                                          float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&X[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&X[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Y[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Y[kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

}  // namespace kt
