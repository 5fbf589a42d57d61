// Accumulating symmetric Gramian + correlation in one pass over F:
//   gout = G + F^T F on the upper-triangle 128 x 128 tiles only,
//   cout = C + F^T R, fully valid,
// with R rounded to F's compute dtype first (bf16 when F is bf16). The
// strictly-lower tiles of gout are not written (undefined unless gout is G
// itself, when they keep G's values); the caller mirrors once after its
// last accumulation.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr_sym_acc
// (_gram_corr_sym_acc_kernel), the chunk step of the sparse gram fold
// (keystone_tpu/ops/sparse.py:sparse_gram_fold): every densified chunk of
// every SparseLBFGSwithL2(solver="gram") fit folds through it.
//
// Bound on an H100 SXM at the Amazon chunk (c = 65536 rows of d1 = 16385
// columns: 16384 features and the intercept lane, k = 2 labels): the upper
// triangle costs c*d1*(d1+1) = 1.76e13 FLOP and the correlation 2*c*d1*k =
// 4.3e9. As written (float32 FMA, bf16 F widened to float32) that is
// 263 ms at the card's 67 TFLOP/s non-tensor float32 peak; for bf16 F the
// least time the card could take is 17.8 ms at the 989 TFLOP/s bf16
// tensor-core peak. The bytes it must move (bf16 F's 2.15 GB read once,
// G's 1.07 GB read and written once) take 1.3 ms at 3.35 TB/s. So the
// kernel is bound by operations; wgmma on bf16 F is the later step that
// closes most of the gap to the tensor-core bound.
//
// Design: gram_sym_acc.cu's upper-triangle tiles with G riding through.
// Every 128 x 128 upper-triangle tile is one CUDA block that loops over
// all c rows itself, keeps its sum in registers (fma_tile.cuh) and adds
// G's tile once in the epilogue, so nothing carries between blocks, no
// atomics are needed, and gout may be G itself (the fold accumulates in
// place). The TPU kernel lets the diagonal pairs carry the correlation
// because F's column tile i is already resident there; so here only the
// diagonal blocks (ti == tj) also contract their staged F tile with R:
// the correlation costs one small R stream and no extra read of F. k is
// not lane-padded to 128 as on the TPU (k = 2 here): each of the block's
// 256 threads owns one of the tile's 128 F columns and KG = 4 of the next
// KP = 8 label columns, with the 8 x 8 R stage in shared memory. Those
// four sums live in shared memory too, not in registers: the Gramian tile
// needs 128 registers a thread, and with the sums in registers the float32
// kernel took 130, which leaves room for one block an SM instead of two
// (809 ms against 580 ms at the Amazon chunk, float32 F, measured in turns
// on one H100). For k > 8 the diagonal block makes one more pass over F's
// tile per further 8 label columns (the Amazon fit has k = 2: one pass,
// fused). A row of C is read and written by one thread of its own
// diagonal block, so cout may be C itself. Ragged c, d and k are masked in
// the staging loads and the epilogue, so F needs no padding rows or
// columns.

#include "fma_tile.cuh"

namespace {

using namespace kt;

constexpr int KG = 4;       // label columns per thread and pass
constexpr int KP = 2 * KG;  // label columns per pass: two threads per F column

// Stage rows [r0, r0 + BK) x label columns [j0, j0 + KP) of R (float32,
// n x k, row stride ldr) into Rs, zero past the edges, rounded to bf16
// when F is bf16 (the reference rounds R to F's compute dtype).
__device__ __forceinline__ void stage_labels(float (*Rs)[KP], const float* __restrict__ R,
                                             long long r0, int j0, long long n, int k,
                                             long long ldr, bool round) {
  if (threadIdx.x < BK * KP) {
    const int kk = threadIdx.x / KP;
    const int j = threadIdx.x % KP;
    const long long gr = r0 + kk;
    const int gj = j0 + j;
    const float v = (gr < n && gj < k) ? R[gr * ldr + gj] : 0.f;
    Rs[kk][j] = round ? round_bf16(v) : v;
  }
}

// Cs[q][t] += sum over kk of X[kk][c] * Rs[kk][g * KG + q], for this
// thread t's F column c = t % T and label group g = t / T. Each thread
// touches only its own Cs entries: no barrier needed around them.
__device__ __forceinline__ void corr_stage(float (*X)[LDS], float (*Rs)[KP],
                                           float (*Cs)[THREADS]) {
  const int t = threadIdx.x;
  const int c = t % T;
  const int g = t / T;
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    float s = Cs[q][t];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) s = fmaf(X[kk][c], Rs[kk][g * KG + q], s);
    Cs[q][t] = s;
  }
}

__device__ __forceinline__ void zero_corr(float (*Cs)[THREADS]) {
#pragma unroll
  for (int q = 0; q < KG; ++q) Cs[q][threadIdx.x] = 0.f;
}

// cout[i0 + c, j0 + g * KG + q] = C[...] + Cs[q][t], inside (d, k).
__device__ __forceinline__ void write_corr(float (*Cs)[THREADS], const float* C, float* cout,
                                           long long i0, int j0, int d, int k, long long ldc,
                                           long long ldco) {
  const long long r = i0 + threadIdx.x % T;
  if (r >= d) return;
  const int jb = j0 + (threadIdx.x / T) * KG;
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    const int j = jb + q;
    if (j < k) cout[r * ldco + j] = C[r * ldc + j] + Cs[q][threadIdx.x];
  }
}

// Block p is the p-th upper-triangle tile pair (ti <= tj), row-major. G and
// gout may alias, and C and cout: no __restrict__ on them.
template <typename TF>
__global__ void __launch_bounds__(THREADS, 2)
gram_corr_sym_acc_kernel(const TF* __restrict__ F, const float* __restrict__ R,
                         const float* G, const float* C, float* gout, float* cout, int n,
                         int d, int k, long long ldf, long long ldr, long long ldg,
                         long long ldc, long long ldgo, long long ldco, int nt) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];
  __shared__ float Rs[BK][KP];
  __shared__ float Cs[KG][THREADS];

  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;  // uniform over the block: safe around barriers
  const bool round = sizeof(TF) == 2;
  const long long i0 = (long long)ti * T;
  const long long j0 = (long long)tj * T;

  float acc[8][8];
  zero(acc);
  if (diag) zero_corr(Cs);
  for (long long r0 = 0; r0 < n; r0 += BK) {
    stage_rows<TF>(Xs, F, r0, i0, n, d, ldf);
    stage_rows<TF>(Ys, F, r0, j0, n, d, ldf);
    if (diag) stage_labels(Rs, R, r0, 0, n, k, ldr, round);
    __syncthreads();
    fma_stage(Xs, Ys, acc);
    if (diag) corr_stage(Xs, Rs, Cs);
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
      gout[r * ldgo + c] = G[r * ldg + c] + acc[i][j];
    }
  }
  if (!diag) return;
  write_corr(Cs, C, cout, i0, 0, d, k, ldc, ldco);

  // Label columns past the first KP: one more pass over F's tile each.
  for (int lj = KP; lj < k; lj += KP) {
    zero_corr(Cs);
    for (long long r0 = 0; r0 < n; r0 += BK) {
      stage_rows<TF>(Xs, F, r0, i0, n, d, ldf);
      stage_labels(Rs, R, r0, lj, n, k, ldr, round);
      __syncthreads();
      corr_stage(Xs, Rs, Cs);
      __syncthreads();
    }
    write_corr(Cs, C, cout, i0, lj, d, k, ldc, ldco);
  }
}

template <typename TF>
int launch(const void* F, const float* R, const float* G, const float* C, float* gout,
           float* cout, int n, int d, int k, long long ldf, long long ldr, long long ldg,
           long long ldc, long long ldgo, long long ldco, cudaStream_t stream) {
  const int nt = (d + T - 1) / T;
  const int npairs = nt * (nt + 1) / 2;
  gram_corr_sym_acc_kernel<TF><<<npairs, THREADS, 0, stream>>>(
      static_cast<const TF*>(F), R, G, C, gout, cout, n, d, k, ldf, ldr, ldg, ldc, ldgo,
      ldco, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// R (n, k) float32, row stride ldr. G and gout (d, d) float32, row strides
// ldg and ldgo, gout may be G; C and cout (d, k) float32, row strides ldc
// and ldco, cout may be C. d > 0 (the caller handles empty outputs).
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_gram_corr_sym_acc(const void* F, const float* R, const float* G,
                                    const float* C, float* gout, float* cout, int n, int d,
                                    int k, long long ldf, long long ldr, long long ldg,
                                    long long ldc, long long ldgo, long long ldco, int f_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? launch<__nv_bfloat16>(F, R, G, C, gout, cout, n, d, k, ldf, ldr, ldg, ldc,
                                        ldgo, ldco, s)
                : launch<float>(F, R, G, C, gout, cout, n, d, k, ldf, ldr, ldg, ldc, ldgo,
                                ldco, s);
}
