// Gauss-Seidel residual update through a column window of a flat feature
// matrix: out = R - F[:, s:s+b] dW, the window read in place through F's
// row stride (no copy of the window).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:block_residual_update
// (_block_resid_kernel), the residual update after every block solve of the
// flat block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_fused_flat_kernel, strided_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (F 65536 x 16384, one
// 4096-wide window, dW 4096 x 147, R 65536 x 147): 2*n*b*k = 7.89e10 FLOP
// of float32 FMA (no TF32: "f32 means f32"), 1.18 ms at the card's
// 67 TFLOP/s non-tensor float32 peak. The bytes it must move (the window's
// 1.07 GB, dW and R read once, the new residual written) take 0.34 ms at
// 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design. The TPU kernel keeps an R tile resident while its sequential grid
// axis walks the window's column tiles. Here each CUDA block owns a
// 128-row x 128-column tile of the output (512 row tiles x 2 column tiles
// at the slice's shapes) and loops over the whole b-wide window itself,
// BK columns a step: F's rows are staged transposed (eight neighbouring
// threads read eight consecutive columns of one row), dW's rows as they
// are. The product is summed whole in registers and subtracted from R once,
// as the plain version computes R - (F_w @ dW). k = 147 is masked past its
// edge in the second column tile. dW arrives in F's dtype (the solver
// rounds it as the reference does); bf16 F and dW are widened to float32
// on their way into shared memory (fma_tile.cuh).

#include "fma_tile.cuh"

namespace {

using namespace kt;

// blockIdx.x = tm * nkt + tj: row tile tm of the output, column tile tj.
template <typename TF>
__global__ void __launch_bounds__(THREADS)
block_residual_update_kernel(const TF* __restrict__ F, const TF* __restrict__ dW,
                             const float* __restrict__ R, float* __restrict__ out,
                             int n, int b, int k, long long ldf, long long ldw,
                             long long ldr, long long ldo, int nkt) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];

  const long long m0 = (long long)(blockIdx.x / nkt) * T;
  const long long j0 = (long long)(blockIdx.x % nkt) * T;

  float acc[8][8];
  zero(acc);
  for (long long c0 = 0; c0 < b; c0 += BK) {
    stage_cols<TF>(Xs, F, m0, c0, n, b, ldf);
    stage_rows<TF>(Ys, dW, c0, j0, b, k, ldw);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + tile_row(i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c < k) out[r * ldo + c] = R[r * ldr + c] - acc[i][j];
    }
  }
}

template <typename TF>
int launch(const void* F, const void* dW, const float* R, float* out, int n,
           int col_start, int b, int k, long long ldf, long long ldw, long long ldr,
           long long ldo, cudaStream_t stream) {
  const long long nmt = ((long long)n + T - 1) / T;
  const int nkt = (k + T - 1) / T;
  block_residual_update_kernel<TF><<<static_cast<unsigned>(nmt * nkt), THREADS, 0, stream>>>(
      static_cast<const TF*>(F) + col_start, static_cast<const TF*>(dW), R, out, n, b, k,
      ldf, ldw, ldr, ldo, nkt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// the window is columns [col_start, col_start + b), inside F. dW (b, k) in
// F's dtype with row stride ldw; R (n, k) float32 with row stride ldr.
// Writes out (n, k) float32 with row stride ldo; n > 0 and k > 0 (the
// caller handles empty outputs). Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int kt_block_residual_update(const void* F, const void* dW, const float* R,
                                        float* out, int n, int col_start, int b, int k,
                                        long long ldf, long long ldw, long long ldr,
                                        long long ldo, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? launch<__nv_bfloat16>(F, dW, R, out, n, col_start, b, k, ldf, ldw, ldr,
                                        ldo, s)
                : launch<float>(F, dW, R, out, n, col_start, b, k, ldf, ldw, ldr, ldo, s);
}
