// Correlation of a column window of a flat feature matrix with the
// residual: C = F[:, s:s+b]^T R, the window read in place through F's row
// stride (no copy of the window).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:block_corr
// (_block_corr_kernel), the per-block correlation of every epoch of the
// flat block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_fused_flat_kernel, strided_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (F 65536 x 16384, one
// 4096-wide window, R 65536 x 147): 2*n*b*k = 7.89e10 FLOP of float32 FMA
// (no TF32: "f32 means f32"), 1.18 ms at the card's 67 TFLOP/s non-tensor
// float32 peak. The bytes it must move (the window's 1.07 GB and R's
// 39 MB read once, 2.4 MB written) take 0.33 ms at 3.35 TB/s. So the kernel
// is bound by float32 operations.
//
// Design. The output is small (4096 x 147): its 128 x 128 tiles alone
// give 32 x 2 = 64 blocks for 132 SMs, each summing 65,536 rows. So the row
// reduction is split into `splits` chunks of rows (the TPU kernel sums all
// row tiles along its sequential grid axis on one core): block (tile, z)
// sums chunk z of one output tile into a partial buffer P[z], and a second
// kernel in the same call adds the partials in the order z = 0, 1, ... No
// float atomics: a run gives the same bits every time. With one chunk the
// first kernel writes C directly. The 147-wide R takes two 128-wide column
// tiles, the second masked past column 147. For bf16 F each R value is
// rounded to bf16 as it is staged, as the TPU kernel rounds R to its bf16
// matrix unit's operand type; products and sums stay float32.

#include "fma_tile.cuh"

namespace {

using namespace kt;

// blockIdx.x: output tile (ti, tj), ti over the window's column tiles, tj
// over R's; blockIdx.y: the row chunk [y * chunk, (y + 1) * chunk). Writes
// the chunk's sum to P + y * b * k (row-major (b, k)).
template <typename TF>
__global__ void __launch_bounds__(THREADS)
block_corr_kernel(const TF* __restrict__ F, const float* __restrict__ R,
                  float* __restrict__ P, int n, int b, int k, long long ldf,
                  long long ldr, int nkt, long long chunk, int round_r) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];

  const int ti = blockIdx.x / nkt;
  const int tj = blockIdx.x % nkt;
  const long long i0 = (long long)ti * T;
  const long long j0 = (long long)tj * T;
  const long long rbeg = (long long)blockIdx.y * chunk;
  const long long rend = rbeg + chunk < n ? rbeg + chunk : n;

  float acc[8][8];
  zero(acc);
  for (long long r0 = rbeg; r0 < rend; r0 += BK) {
    stage_rows<TF>(Xs, F, r0, i0, rend, b, ldf);
    stage_rows<float>(Ys, R, r0, j0, rend, k, ldr, round_r != 0);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

  float* out = P + (long long)blockIdx.y * b * k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + tile_row(i);
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c < k) out[r * k + c] = acc[i][j];
    }
  }
}

// C[e] = P[0][e] + P[1][e] + ... in that order, for the count entries.
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ P, float* __restrict__ C,
                    long long count, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += P[z * count + e];
    C[e] = s;
  }
}

template <typename TF>
int launch(const void* F, const float* R, float* P, float* C, int n, int col_start,
           int b, int k, long long ldf, long long ldr, int splits, cudaStream_t stream) {
  const int nbt = (b + T - 1) / T;
  const int nkt = (k + T - 1) / T;
  // Chunks of whole BK-row stages; the last chunk may be short or empty.
  long long chunk = ((long long)n + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  const dim3 grid(nbt * nkt, splits);
  block_corr_kernel<TF><<<grid, THREADS, 0, stream>>>(
      static_cast<const TF*>(F) + col_start, R, splits > 1 ? P : C, n, b, k, ldf, ldr,
      nkt, chunk, static_cast<int>(sizeof(TF) == 2));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = (long long)b * k;
  const long long want = (count + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials_kernel<<<blocks, THREADS, 0, stream>>>(P, C, count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// the window is columns [col_start, col_start + b), inside F. R (n, k)
// float32 with row stride ldr. P: scratch of splits * b * k floats (unused,
// and may be null, when splits == 1). Writes C (b, k) float32, contiguous;
// b > 0 and k > 0 (the caller handles empty outputs). Launches on `stream`
// and returns the launches' cudaError_t (0 = success).
extern "C" int kt_block_corr(const void* F, const float* R, float* P, float* C, int n,
                             int col_start, int b, int k, long long ldf, long long ldr,
                             int splits, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16
             ? launch<__nv_bfloat16>(F, R, P, C, n, col_start, b, k, ldf, ldr, splits, s)
             : launch<float>(F, R, P, C, n, col_start, b, k, ldf, ldr, splits, s);
}
