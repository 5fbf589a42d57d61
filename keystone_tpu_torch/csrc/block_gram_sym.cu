// Symmetric Gramian of a column window of a flat feature matrix:
// G = F[:, s:s+b]^T F[:, s:s+b], read in place through F's row stride (no
// copy of the window), computing only the upper-triangle tiles and writing
// each off-diagonal tile to its mirror position as well.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:block_gram_sym
// (_gram_sym_kernel), the first-epoch Gramian of every block in the flat
// block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_fused_flat_kernel, strided_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (F 65536 x 16384, one
// 4096-wide window): the upper triangle costs n*b*(b+1) = 1.10e12 FLOP of
// float32 FMA (no TF32: "f32 means f32"), 16.4 ms at the card's 67 TFLOP/s
// non-tensor float32 peak. The bytes it must move (the window's 1.07 GB
// read once, 67 MB of Gramian written) take 0.34 ms at 3.35 TB/s. So the
// kernel is bound by float32 operations.
//
// Design: gram_corr_sym.cu's Gramian tiles with a column offset and no
// correlation. The TPU kernel scalar-prefetches the window's first column
// tile and walks the upper-triangle tile pairs in order on one core,
// summing over row tiles along its sequential grid axis. Here every
// 128 x 128 upper-triangle tile is one CUDA block that loops over all n
// rows itself (528 blocks for a 4096-wide window), so nothing carries
// between blocks and no atomics are needed. The window start s enters as a
// pointer offset and the window's right edge as the column mask, so the
// kernel never reads outside the window. bf16 F is widened to float32 on
// its way into shared memory (fma_tile.cuh).

#include "fma_tile.cuh"

namespace {

using namespace kt;

// Block p is the p-th upper-triangle tile pair (ti <= tj), row-major.
template <typename TF>
__global__ void __launch_bounds__(THREADS)
block_gram_sym_kernel(const TF* __restrict__ F, float* __restrict__ G, int n, int b,
                      long long ldf, int nt) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];

  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const long long i0 = (long long)ti * T;
  const long long j0 = (long long)tj * T;

  float acc[8][8];
  zero(acc);
  for (long long r0 = 0; r0 < n; r0 += BK) {
    stage_rows<TF>(Xs, F, r0, i0, n, b, ldf);
    stage_rows<TF>(Ys, F, r0, j0, n, b, ldf);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + tile_row(i);
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c >= b) continue;
      G[r * b + c] = acc[i][j];
      // A diagonal tile is computed whole; its two halves agree bit for
      // bit (fmaf(a, b, s) == fmaf(b, a, s) in the same order).
      if (ti != tj) G[c * b + r] = acc[i][j];
    }
  }
}

template <typename TF>
int launch(const void* F, float* G, int n, int col_start, int b, long long ldf,
           cudaStream_t stream) {
  const int nt = (b + T - 1) / T;
  const int npairs = nt * (nt + 1) / 2;
  block_gram_sym_kernel<TF><<<npairs, THREADS, 0, stream>>>(
      static_cast<const TF*>(F) + col_start, G, n, b, ldf, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// the window is columns [col_start, col_start + b), inside F. Writes G
// (b, b) float32, contiguous; b > 0 (the caller handles empty outputs).
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_block_gram_sym(const void* F, float* G, int n, int col_start, int b,
                                 long long ldf, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? launch<__nv_bfloat16>(F, G, n, col_start, b, ldf, s)
                : launch<float>(F, G, n, col_start, b, ldf, s);
}
