// One-launch Gramian + correlation: (A^T A, A^T R), computing only the
// upper-triangle tiles of A^T A (the BLAS syrk saving) and writing each
// off-diagonal tile to its mirror position as well.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr_sym
// (_gram_corr_sym_kernel), the Gramian + correlation of every first-epoch
// block update in the stacked block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_block_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one 4096-wide block,
// n = 65536 rows, k = 147 label columns): the upper triangle costs
// n*d*(d+1) = 1.10e12 FLOP and the correlation 2*n*d*k = 7.9e10, 1.18e12
// FLOP of float32 FMA in all (no TF32: "f32 means f32"), which take
// 17.6 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (A's 1.07 GB and R read once, 67 MB of Gramian written) take
// 0.35 ms at 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design. The TPU kernel walks the upper-triangle tile pairs in a grid
// that runs in order on one core and sums over row tiles along its
// sequential last grid axis. Here every output tile is one CUDA block that
// loops over all n rows itself, so nothing carries between blocks and no
// atomics are needed. The TPU's 512-wide tiles would give only 36 pairs
// for a 4096-wide block, far too few for 132 SMs; 128-wide tiles give 528
// pairs. The TPU kernel lets the diagonal pairs carry the correlation,
// which here would make 32 of 528 blocks do up to twice the work of the
// rest; instead the correlation tiles (row tile i of A^T x column tile of
// R) are blocks of their own in the same launch, each as much work as a
// Gramian tile. The 147-wide R takes two 128-wide column tiles, the second
// masked past column 147. Each thread keeps 8 x 8 outputs in registers and
// feeds 16 FMAs from each float4 shared-memory load, as in
// cosine_features.cu. bf16 A is widened to float32 on its way into shared
// memory; R stays float32 in the product (the TPU kernel rounds R to the
// operand dtype for its bf16 matrix unit; the FMA path has no such need).
// Ragged edges of n, d and k are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 128;  // output tile width (both dimensions)
constexpr int BK = 8;   // rows of A per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [r0, r0 + BK) of the column window [c0, c0 + T) of a row-major
// matrix M (rows < rows, columns < cols, row stride ld) into S[BK][T].
// Element e of the 1024 is (row e / T, column e % T): a warp reads 128
// contiguous bytes of one row.
template <typename TM>
__device__ __forceinline__ void stage(float (*S)[T], const TM* __restrict__ M,
                                      long long r0, long long c0, long long rows,
                                      long long cols, long long ld) {
#pragma unroll
  for (int i = 0; i < (T * BK) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int kk = e / T;
    const int c = e % T;
    const long long gr = r0 + kk;
    const long long gc = c0 + c;
    S[kk][c] = (gr < rows && gc < cols) ? to_float(M[gr * ld + gc]) : 0.f;
  }
}

// Blocks [0, npairs) are the Gramian tile pairs (ti <= tj), row-major over
// the upper triangle; blocks [npairs, npairs + nt * nr) are the correlation
// tiles (ti, rc), rc over the nr column tiles of R.
template <typename TA>
__global__ void __launch_bounds__(THREADS)
gram_corr_sym_kernel(const TA* __restrict__ A, const float* __restrict__ R,
                     float* __restrict__ G, float* __restrict__ C, int n, int d,
                     int k, long long lda, long long ldr, int nt, int npairs) {
  __shared__ __align__(16) float Xs[BK][T];
  __shared__ __align__(16) float Ys[BK][T];

  const int p = blockIdx.x;
  const bool corr = p >= npairs;
  int ti, tj;
  if (corr) {
    const int q = p - npairs;
    const int nr = (k + T - 1) / T;
    ti = q / nr;
    tj = q % nr;
  } else {
    ti = 0;
    int rem = p;
    while (rem >= nt - ti) {
      rem -= nt - ti;
      ++ti;
    }
    tj = ti + rem;
  }
  const long long i0 = (long long)ti * T;
  const long long j0 = (long long)tj * T;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long r0 = 0; r0 < n; r0 += BK) {
    stage<TA>(Xs, A, r0, i0, n, d, lda);
    if (corr)
      stage<float>(Ys, R, r0, j0, n, k, ldr);
    else
      stage<TA>(Ys, A, r0, j0, n, d, lda);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ys[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long ncols = corr ? k : d;
  float* out = corr ? C : G;
  const long long ldo = corr ? k : d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= ncols) continue;
      out[r * ldo + c] = acc[i][j];
      // Off-diagonal Gramian tiles also fill their mirror tile. (A diagonal
      // tile is computed whole; its two halves agree bit for bit, since
      // fmaf(a, b, s) == fmaf(b, a, s) in the same order.)
      if (!corr && ti != tj) G[c * d + r] = acc[i][j];
    }
  }
}

template <typename TA>
int launch(const void* A, const float* R, float* G, float* C, int n, int d, int k,
           long long lda, long long ldr, cudaStream_t stream) {
  const int nt = (d + T - 1) / T;
  const int nr = (k + T - 1) / T;
  const int npairs = nt * (nt + 1) / 2;
  gram_corr_sym_kernel<TA><<<npairs + nt * nr, THREADS, 0, stream>>>(
      static_cast<const TA*>(A), R, G, C, n, d, k, lda, ldr, nt, npairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (n, d) row-major with row stride lda, float32 (a_bf16 = 0) or bfloat16;
// R (n, k) float32 with row stride ldr. Writes G (d, d) and C (d, k), both
// float32 and contiguous; d > 0 (the caller handles empty outputs). Launches
// on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_gram_corr_sym(const void* A, const float* R, float* G, float* C,
                                int n, int d, int k, long long lda, long long ldr,
                                int a_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? launch<__nv_bfloat16>(A, R, G, C, n, d, k, lda, ldr, s)
                : launch<float>(A, R, G, C, n, d, k, lda, ldr, s);
}
