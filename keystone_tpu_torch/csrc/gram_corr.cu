// One-launch Gramian + correlation: (A^T A, A^T R), with every tile of
// A^T A computed and written (the dense form; gram_corr_sym.cu computes the
// upper-triangle tiles only and mirrors them).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr
// (_gram_corr_kernel), the Gramian + correlation of a first-epoch block
// update in the block coordinate descent solvers when they are asked for
// the dense form (keystone_tpu/parallel/linalg.py:_bcd_block_update with
// sym=False).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one 4096-wide block,
// n = 65536 rows, k = 147 label columns): every Gramian tile costs
// 2*n*d*d = 2.20e12 FLOP and the correlation 2*n*d*k = 7.9e10, 2.28e12
// FLOP of float32 FMA in all (no TF32: "f32 means f32"), which take
// 34.0 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (A's 1.07 GB and R read once, 67 MB of Gramian written) take
// 0.35 ms at 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design: gram_corr_sym.cu's, with the lower tiles computed rather than
// mirrored. Every output tile is one CUDA block of 256 threads that loops
// over all n rows itself, so nothing carries between blocks and no atomics
// are needed; the TPU kernel's sequential row-tile grid axis becomes that
// loop. Blocks [0, nt * nt) are the Gramian tiles (ti, tj), row-major;
// blocks [nt * nt, nt * nt + nt * nr) are the correlation tiles (row tile
// ti of A^T x column tile rc of R), each as much work as a Gramian tile
// (the TPU kernel lets the j == 0 column of Gramian tiles carry them). The
// register tile is fma_tile.cuh's: 8 x 8 outputs a thread, 16 FMAs from
// each float4 shared-memory load. bf16 A is widened to float32 on its way
// into shared memory; R stays float32 in the product. Ragged edges of n, d
// and k are masked in the kernel, not padded. The two triangles are
// computed by different blocks from the same operands in the same order,
// and fmaf(a, b, s) == fmaf(b, a, s), so the Gramian comes out exactly
// symmetric.

#include "fma_tile.cuh"

namespace {

using namespace kt;

template <typename TA>
__global__ void __launch_bounds__(THREADS)
gram_corr_kernel(const TA* __restrict__ A, const float* __restrict__ R,
                 float* __restrict__ G, float* __restrict__ C, int n, int d, int k,
                 long long lda, long long ldr, int nt, int ntiles) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];

  const int p = blockIdx.x;
  const bool corr = p >= ntiles;
  int ti, tj;
  if (corr) {
    const int q = p - ntiles;
    const int nr = (k + T - 1) / T;
    ti = q / nr;
    tj = q % nr;
  } else {
    ti = p / nt;
    tj = p % nt;
  }
  const long long i0 = (long long)ti * T;
  const long long j0 = (long long)tj * T;

  float acc[8][8];
  zero(acc);
  for (long long r0 = 0; r0 < n; r0 += BK) {
    stage_rows<TA>(Xs, A, r0, i0, n, d, lda);
    if (corr)
      stage_rows<float>(Ys, R, r0, j0, n, k, ldr);
    else
      stage_rows<TA>(Ys, A, r0, j0, n, d, lda);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

  const long long ncols = corr ? k : d;
  float* out = corr ? C : G;
  const long long ldo = corr ? k : d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + tile_row(i);
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c >= ncols) continue;
      out[r * ldo + c] = acc[i][j];
    }
  }
}

template <typename TA>
int launch(const void* A, const float* R, float* G, float* C, int n, int d, int k,
           long long lda, long long ldr, cudaStream_t stream) {
  const int nt = (d + T - 1) / T;
  const int nr = (k + T - 1) / T;
  const int ntiles = nt * nt;
  gram_corr_kernel<TA><<<ntiles + nt * nr, THREADS, 0, stream>>>(
      static_cast<const TA*>(A), R, G, C, n, d, k, lda, ldr, nt, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (n, d) row-major with row stride lda, float32 (a_bf16 = 0) or bfloat16;
// R (n, k) float32 with row stride ldr. Writes G (d, d) and C (d, k), both
// float32 and contiguous; d > 0 (the caller handles empty outputs). Launches
// on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_gram_corr(const void* A, const float* R, float* G, float* C, int n,
                            int d, int k, long long lda, long long ldr, int a_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? launch<__nv_bfloat16>(A, R, G, C, n, d, k, lda, ldr, s)
                : launch<float>(A, R, G, C, n, d, k, lda, ldr, s);
}
