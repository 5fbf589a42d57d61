// Accumulating symmetric Gramian: out = G + F^T F on the upper-triangle
// 128 x 128 tiles only. The strictly-lower tiles of out are not written
// (undefined unless out is G itself, when they keep G's values); the
// caller mirrors once after its last accumulation.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_sym_acc
// (_gram_sym_acc_kernel), the per-tile Gramian fold of the streamed
// least-squares fit (keystone_tpu/parallel/streaming.py:_tile_update): the
// running Gramian rides through as an operand, so a tile's contribution
// never exists as a (d, d) buffer of its own.
//
// Bound on an H100 SXM at the streamed TIMIT fit's tile (n = 32768 rows of
// d = 16384 features, pick_tile_rows(16384)): the upper triangle costs
// n*d*(d+1) = 8.80e12 FLOP of float32 FMA (no TF32: "f32 means f32"),
// 131.3 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (F's 2.15 GB read once, G's 1.07 GB read and written once)
// take 1.28 ms at 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design: fma_tile.cuh's 128 x 128 upper Gramian tiles over the whole
// width with G riding through. The TPU kernel walks the upper-triangle tile pairs in
// order on one core, copying G's tile into the output at the first row
// tile and adding each row tile's product along its sequential grid axis.
// Here every 128 x 128 upper-triangle tile is one CUDA block that loops
// over all n rows itself (8,256 blocks at d = 16384), keeps its sum in
// registers and adds G's tile once in the epilogue, so nothing carries
// between blocks and no atomics are needed. A tile of G is read and a tile
// of out written by its own block only, after the loop, so out may be G
// itself: the fold accumulates in place instead of writing a new 1.07 GB
// buffer per tile. No mirroring: the fold mirrors once at its end. Ragged
// n and d are masked in the staging loads and the epilogue, so F needs no
// padding rows. bf16 F is widened to float32 on its way into shared memory
// (fma_tile.cuh).

#include "fma_tile.cuh"

namespace {

using namespace kt;

// Block p is the p-th upper-triangle tile pair (ti <= tj), row-major. G and
// out may alias: no __restrict__ on them.
template <typename TF>
__global__ void __launch_bounds__(THREADS)
gram_sym_acc_kernel(const TF* __restrict__ F, const float* G, float* out, int n, int d,
                    long long ldf, long long ldg, long long ldo, int nt) {
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
    stage_rows<TF>(Xs, F, r0, i0, n, d, ldf);
    stage_rows<TF>(Ys, F, r0, j0, n, d, ldf);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + tile_row(i);
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + tile_col(j);
      if (c >= d) continue;
      out[r * ldo + c] = G[r * ldg + c] + acc[i][j];
    }
  }
}

template <typename TF>
int launch(const void* F, const float* G, float* out, int n, int d, long long ldf,
           long long ldg, long long ldo, cudaStream_t stream) {
  const int nt = (d + T - 1) / T;
  const int npairs = nt * (nt + 1) / 2;
  gram_sym_acc_kernel<TF><<<npairs, THREADS, 0, stream>>>(
      static_cast<const TF*>(F), G, out, n, d, ldf, ldg, ldo, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16.
// G and out (d, d) float32, row strides ldg and ldo; out may be G. d > 0
// (the caller handles empty outputs). Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int kt_gram_sym_acc(const void* F, const float* G, float* out, int n, int d,
                               long long ldf, long long ldg, long long ldo, int f_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? launch<__nv_bfloat16>(F, G, out, n, d, ldf, ldg, ldo, s)
                : launch<float>(F, G, out, n, d, ldf, ldg, ldo, s);
}
