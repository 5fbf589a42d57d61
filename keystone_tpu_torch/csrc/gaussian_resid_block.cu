// Fused Gaussian kernel block and residual contraction: out = K(X, Y)^T W,
// K[i][j] = exp(-gamma * max(xn_i + yn_j - 2 X_i . Y_j, 0)), K never stored.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gaussian_resid_block
// (_gaussian_resid_kernel): every Gauss-Seidel step of the kernel ridge
// regression sweep (keystone_tpu/ops/learning/kernel.py:_krr_fit_fused)
// needs the residual K(train, block)^T W of the dual model W against one
// block of train rows, and the (m, n) kernel block between them is only
// ever contracted.
//
// Bound on an H100 SXM at the CIFAR sweep's shape (X 50,000 x 1,800 train
// rows, Y 512 x 1,800 rows of one block, W 50,000 x 10): 2*m*n*d + 2*m*n*k
// = 9.27e10 FLOP of float32 FMA ("f32 means f32": no TF32), 1.383 ms at
// the card's 67 TFLOP/s non-tensor float32 peak. The bytes it must move
// (X 360 MB, Y, norms, W 2 MB, the 20 KB output) take 0.109 ms at
// 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design. The TPU kernel carries the (n, k) sum in its output tile along
// its sequential grid axis over train-row tiles. Here the output has only
// ceil(512 / 128) = 4 column tiles for 132 SMs, so the m train rows are
// split into `splits` chunks of whole 128-row tiles (a number fixed by the
// shapes and the SM count): block (tj, z) walks the row tiles of chunk z.
// For each row tile it builds the 128 x 128 K tile with the FP32-FMA
// register tile of csrc/fma_tile.cuh (both operands staged with stage_cols:
// X Y^T is an "NT" product), applies the epilogue, parks the tile in
// shared memory, and at once contracts it with the tile's W rows, 32
// label columns at a time, into the chunk's (n, k) partial sum P[z] (each
// entry owned by one thread of one block, so it accumulates in place). A
// second kernel adds the partials in the order z = 0, 1, ...: no float
// atomics, the same bits every run. With one chunk the first kernel writes
// the output directly. Rows past m are masked (their K entries and W rows
// read as zero), never read; the reference pads and relies on W's ghost
// rows being zero, and the port's solver keeps that invariant too. K and
// W tiles take 82 KB of dynamic shared memory, above the 48 KB default,
// so the launch raises the kernel's limit first.

#include "fma_tile.cuh"

namespace {

using namespace kt;

constexpr int KC = 32;  // label columns of W staged per contraction pass

template <typename TIn>
__global__ void __launch_bounds__(THREADS)
gaussian_resid_block_kernel(const TIn* __restrict__ X, const TIn* __restrict__ Y,
                            const float* __restrict__ xn, const float* __restrict__ yn,
                            const float* __restrict__ W, float* __restrict__ P, int m,
                            int n, int d, int k, long long ldx, long long ldy,
                            long long ldw, long long chunk, float gamma) {
  __shared__ __align__(16) float Xs[BK][LDS];
  __shared__ __align__(16) float Ys[BK][LDS];
  extern __shared__ __align__(16) float dyn[];
  float (*Ks)[LDS] = reinterpret_cast<float (*)[LDS]>(dyn);  // [T][LDS]
  float (*Ws)[KC] = reinterpret_cast<float (*)[KC]>(dyn + T * LDS);  // [T][KC]

  const long long j0 = (long long)blockIdx.x * T;
  const long long rbeg = (long long)blockIdx.y * chunk;
  const long long rend = rbeg + chunk < m ? rbeg + chunk : m;
  float* out = P + (long long)blockIdx.y * n * k;
  // Contraction role of this thread: output row j0 + jj, label columns
  // c0 + cg, c0 + cg + 2, ... (a warp shares cg, so W reads broadcast).
  const int jj = threadIdx.x % T;
  const int cg = threadIdx.x / T;
  const long long orow = j0 + jj;

  for (long long i0 = rbeg; i0 < rend; i0 += T) {
    float acc[8][8];
    zero(acc);
    for (int k0 = 0; k0 < d; k0 += BK) {
      stage_cols<TIn>(Xs, X, i0, k0, rend, d, ldx);
      stage_cols<TIn>(Ys, Y, j0, k0, n, d, ldy);
      __syncthreads();
      fma_stage(Xs, Ys, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = i0 + tile_row(i);
      const float xr = r < rend ? xn[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = j0 + tile_col(j);
        float v = 0.f;
        if (r < rend && c < n) {
          const float sq = xr + yn[c] - 2.0f * acc[i][j];
          v = expf(-gamma * fmaxf(sq, 0.0f));
        }
        Ks[tile_row(i)][tile_col(j)] = v;
      }
    }
    for (int c0 = 0; c0 < k; c0 += KC) {
      for (int e = threadIdx.x; e < T * KC; e += THREADS) {
        const int rr = e / KC;
        const int cc = e % KC;
        const long long gr = i0 + rr;
        const int gc = c0 + cc;
        Ws[rr][cc] = (gr < rend && gc < k) ? W[gr * ldw + gc] : 0.f;
      }
      __syncthreads();
      if (orow < n) {
        for (int cc = cg; cc < KC && c0 + cc < k; cc += THREADS / T) {
          float s = 0.f;
#pragma unroll 8
          for (int rr = 0; rr < T; ++rr) s = fmaf(Ks[rr][jj], Ws[rr][cc], s);
          float* dst = out + orow * k + c0 + cc;
          *dst = i0 == rbeg ? s : *dst + s;
        }
      }
      __syncthreads();
    }
  }
}

// C[e] = P[0][e] + P[1][e] + ... in that order, for the count entries.
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ P, float* __restrict__ C, long long count,
                    int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += P[z * count + e];
    C[e] = s;
  }
}

template <typename TIn>
int launch(const void* X, const void* Y, const float* xn, const float* yn, const float* W,
           float* P, float* C, int m, int n, int d, int k, long long ldx, long long ldy,
           long long ldw, int splits, float gamma, cudaStream_t stream) {
  // Chunks of whole row tiles, none empty: the first kernel writes every
  // entry of every partial it is given.
  const long long tiles = (m + T - 1) / T;
  const long long per_chunk = (tiles + splits - 1) / splits;
  const int used = static_cast<int>((tiles + per_chunk - 1) / per_chunk);
  const size_t smem = sizeof(float) * (T * LDS + T * KC);
  cudaError_t err = cudaFuncSetAttribute(gaussian_resid_block_kernel<TIn>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + T - 1) / T, used);
  gaussian_resid_block_kernel<TIn><<<grid, THREADS, smem, stream>>>(
      static_cast<const TIn*>(X), static_cast<const TIn*>(Y), xn, yn, W,
      used > 1 ? P : C, m, n, d, k, ldx, ldy, ldw, per_chunk * T, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return static_cast<int>(err);
  const long long count = (long long)n * k;
  const long long want = (count + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials_kernel<<<blocks, THREADS, 0, stream>>>(P, C, count, used);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (m, d) and Y (n, d) row-major with row strides ldx, ldy, both float32
// (in_bf16 = 0) or both bfloat16; xn (m,), yn (n,) float32 squared row
// norms; W (m, k) float32 with row stride ldw. P: scratch of splits * n * k
// floats (unused, and may be null, when splits == 1). Writes C (n, k)
// float32, contiguous. m, n, k > 0 (the caller handles empty operands).
// Launches on `stream` and returns the launches' cudaError_t (0 = success).
extern "C" int kt_gaussian_resid_block(const void* X, const void* Y, const float* xn,
                                       const float* yn, const float* W, float* P, float* C,
                                       int m, int n, int d, int k, long long ldx,
                                       long long ldy, long long ldw, int splits, float gamma,
                                       int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(X, Y, xn, yn, W, P, C, m, n, d, k, ldx, ldy, ldw,
                                         splits, gamma, s)
                 : launch<float>(X, Y, xn, yn, W, P, C, m, n, d, k, ldx, ldy, ldw, splits,
                                 gamma, s);
}
