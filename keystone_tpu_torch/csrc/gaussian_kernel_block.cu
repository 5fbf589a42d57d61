// Gaussian kernel block: K[i][j] = exp(-gamma * max(xn_i + yn_j - 2 X_i . Y_j, 0)).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gaussian_kernel_block
// (_gaussian_kernel_kernel): the cross term X Y^T accumulates over the
// feature axis and the norm broadcast, clamp and exp run on the finished
// tile, so the squared distances never reach device memory. Kernel ridge
// regression (keystone_tpu/ops/learning/kernel.py) calls it for every
// diagonal block of its pre-pass and for every train-block column of the
// apply (KernelBlockLinearMapper).
//
// Bound on an H100 SXM at the CIFAR apply's shape (X 50,000 x 1,800 rows,
// Y 512 x 1,800 rows of one train block): 2*m*n*d = 9.22e10 FLOP of
// float32 FMA ("f32 means f32": no TF32), 1.376 ms at the card's
// 67 TFLOP/s non-tensor float32 peak. The bytes it must move (X 360 MB,
// Y 3.7 MB, norms, the 102 MB output) take 0.139 ms at 3.35 TB/s. So the
// kernel is bound by float32 operations, and it spends its effort on the
// FMA inner loop: the 128 x 128 register tile of csrc/fma_tile.cuh.
//
// Design. X Y^T contracts over the feature axis of two row-major operands
// (an "NT" product), not the row stream of A^T B the other tile users
// read. Both operands are therefore staged with stage_cols, which reads
// eight consecutive features of each of 128 rows and stores them
// transposed, so fma_stage sees the same [k][row] layout as for A^T B; no
// operand is transposed in device memory. bf16 operands are widened to
// float32 on their way into shared memory and accumulate in float32.
// Ragged m, n and d are masked in the kernel (loads outside read zero,
// stores outside are skipped). The epilogue keeps the reference's clamp
// max(sq, 0) exactly: on a diagonal block rounding leaves sq slightly
// negative or positive near 0, and the Cholesky of K_bb + lambda I needs
// the diagonal at 1.

#include "fma_tile.cuh"

namespace {

using namespace kt;

template <typename TIn>
__global__ void __launch_bounds__(THREADS)
gaussian_kernel_block_kernel(const TIn* __restrict__ X, const TIn* __restrict__ Y,
                             const float* __restrict__ xn, const float* __restrict__ yn,
                             float* __restrict__ out, int m, int n, int d, long long ldx,
                             long long ldy, long long ldo, float gamma) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];

  const long long i0 = (long long)blockIdx.x * T;
  const long long j0 = (long long)blockIdx.y * T;

  float acc[8][8];
  zero(acc);
  for (int k0 = 0; k0 < d; k0 += BK) {
    stage_cols<TIn>(Xs, X, i0, k0, m, d, ldx);
    stage_cols<TIn>(Ys, Y, j0, k0, n, d, ldy);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + tile_row(i);
    if (r >= m) continue;
    const float xr = xn[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c < n) {
        const float sq = xr + yn[c] - 2.0f * acc[i][j];
        out[r * ldo + c] = expf(-gamma * fmaxf(sq, 0.0f));
      }
    }
  }
}

template <typename TIn>
int launch(const void* X, const void* Y, const float* xn, const float* yn, float* out,
           int m, int n, int d, long long ldx, long long ldy, long long ldo, float gamma,
           cudaStream_t stream) {
  const dim3 grid((m + T - 1) / T, (n + T - 1) / T);
  gaussian_kernel_block_kernel<TIn><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(X), static_cast<const TIn*>(Y), xn, yn, out, m, n, d, ldx,
      ldy, ldo, gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (m, d) and Y (n, d) row-major with row strides ldx, ldy, both float32
// (in_bf16 = 0) or both bfloat16; xn (m,) and yn (n,) float32 squared row
// norms; out (m, n) float32 with row stride ldo. m, n > 0 (the caller
// handles empty outputs). Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int kt_gaussian_kernel_block(const void* X, const void* Y, const float* xn,
                                        const float* yn, float* out, int m, int n, int d,
                                        long long ldx, long long ldy, long long ldo,
                                        float gamma, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch<__nv_bfloat16>(X, Y, xn, yn, out, m, n, d, ldx, ldy, ldo, gamma, s)
             : launch<float>(X, Y, xn, yn, out, m, n, d, ldx, ldy, ldo, gamma, s);
}
