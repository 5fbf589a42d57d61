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
// kernel is bound by float32 operations. A diagonal block (512 x 512 x
// 1,800) is bound the same way, at 0.014 ms.
//
// Design (fma_pipe.cuh's pipelined tile). X Y^T contracts over the feature
// axis of two row-major operands (an "NT" product), so both are K-major
// operands of the tile. Each goes through registers (fma_pipe.cuh's
// KStager): a thread loads its 16-byte chunks of the next 128 rows x 8
// features along the rows, a stage ahead, and stores them transposed into
// a row-major stage of a 3-stage ring, so the FMA loop is the one a
// row-major operand gets; no operand is transposed in device memory. That
// measured faster than copying K-major stages as stored by cp.async, and 8
// features a stage and 3 stages faster than 16 or 32 and 2 or 4
// (scripts/torch_fma_variants.py). 16-byte loads when the base, row stride
// and d are 16-byte aligned (d = 1,800: 7,200-byte rows), element by element
// otherwise. A block owns a 128 x 128 output tile, 8 x 8 a thread (128 x 256
// tiles at one block an SM measured slower). bf16 operands are widened to
// float32 as they are read and accumulate in float32. Ragged m, n and d are
// masked (loads past the edges read zero, stores outside are skipped).
//
// Grid. The train apply (50,000 x 512) is 391 x 4 = 1,564 tiles, 5.9 waves
// of the 264 resident blocks (2 an SM on 132 SMs), the test apply (12,500
// x 512) 392 tiles, 1.48 waves; a diagonal block (512 x 512) is 16 tiles,
// 6% of one wave. So where the tiles alone make less than a wave, the
// feature axis is split into chunks of whole stages, as few as bring the
// (tile, chunk) grid within 5% of a whole number of waves
// (ops/cuda_ops.py:gaussian_splits, each chunk at least 64 features):
// 16 x 16 = 256 blocks, 0.97 of a wave, at the diagonal (17 chunks, 1.03
// waves, measured slower: the 8 blocks past the wave run alone); 9 x 28 =
// 252 at the ragged 336-row one; no chunks at either apply (2 at the test
// apply measured slower). With chunks, block
// (tile, z) writes chunk z's sums to a partial buffer P[z], and a second
// kernel in the same call adds the partials in the order z = 0, 1, ... and
// applies the epilogue (gaussian.cuh's gauss, shared with
// gaussian_resid_block.cu): no float atomics, the same bits every run.

#include "fma_pipe.cuh"
#include "gaussian.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 8;      // features a stage
constexpr int STAGES = 3;  // stages in the ring
constexpr int MINB = 2;    // blocks an SM the registers are capped for (128 a thread)
constexpr int NJ = 8;      // output columns a thread (16 NJ a tile; gaussian_splits counts 128)
constexpr int TN = 16 * NJ;

template <typename TIn>
constexpr int smem_of() {
  return smem_bytes<TIn, TIn, BK, STAGES, 8, NJ>();
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): output rows [128 x, +128) x
// columns [128 y, +128), feature chunk z of `splits` (stages
// [z * nst / splits, (z + 1) * nst / splits) of the nst BK-feature (8)
// stages). One chunk: the epilogue into out; more: the chunk's sums into
// P + z * m * n (row-major (m, n)).
template <typename TIn, bool VEC>
__global__ void __launch_bounds__(THREADS, MINB)
gauss_kernel(const TIn* __restrict__ X, const TIn* __restrict__ Y, const float* __restrict__ xn,
             const float* __restrict__ yn, float* __restrict__ out, float* __restrict__ P,
             int m, int n, int d, long long ldx, long long ldy, long long ldo, float gamma,
             int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = (long long)blockIdx.x * TM;
  const long long j0 = (long long)blockIdx.y * TN;
  const long long nst = (d + BK - 1) / BK;
  const long long kbeg = blockIdx.z * nst / splits * BK;
  const long long kend_s = (blockIdx.z + 1) * nst / splits * BK;
  const long long kend = kend_s < d ? kend_s : d;
  float acc[8][NJ];
  // Both operands K-major.
  mainloop<BK, STAGES, 8, NJ, VEC, VEC, true, true>(smem, X, ldx, i0, m, Y, ldy, j0, n, kbeg,
                                                    kend, false, acc);
  if (splits > 1) {
    store_tile<8, NJ>(P + (long long)blockIdx.z * m * n, m, n, i0, j0, acc);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + out_row<8>(i);
    if (r >= m) continue;
    const float xr = xn[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < n) out[r * ldo + c] = gauss(xr, yn[c], acc[i][j], gamma);
    }
  }
}

// out[r][c] = the epilogue of P[0][r][c] + P[1][r][c] + ... in that order.
__global__ void __launch_bounds__(THREADS)
sum_epilogue_kernel(const float* __restrict__ P, const float* __restrict__ xn,
                    const float* __restrict__ yn, float* __restrict__ out, int m, int n,
                    long long ldo, float gamma, int splits) {
  const long long count = (long long)m * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += P[z * count + e];
    const long long r = e / n;
    const long long c = e - r * n;
    out[r * ldo + c] = gauss(xn[r], yn[c], s, gamma);
  }
}

template <typename TIn, bool VEC>
cudaError_t launch_vec(const TIn* X, const TIn* Y, const float* xn, const float* yn, float* out,
                       float* P, int m, int n, int d, long long ldx, long long ldy, long long ldo,
                       float gamma, int splits, cudaStream_t stream) {
  auto kernel = gauss_kernel<TIn, VEC>;
  constexpr int smem = smem_of<TIn>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);
  kernel<<<grid, THREADS, smem, stream>>>(X, Y, xn, yn, out, P, m, n, d, ldx, ldy, ldo, gamma,
                                          splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long want = ((long long)m * n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_epilogue_kernel<<<blocks, THREADS, 0, stream>>>(P, xn, yn, out, m, n, ldo, gamma, splits);
  return cudaGetLastError();
}

template <typename TIn>
int launch(const void* Xv, const void* Yv, const float* xn, const float* yn, float* out,
           float* P, int m, int n, int d, long long ldx, long long ldy, long long ldo,
           float gamma, int splits, cudaStream_t stream) {
  const TIn* X = static_cast<const TIn*>(Xv);
  const TIn* Y = static_cast<const TIn*>(Yv);
  return static_cast<int>(
      vec_ok(X, ldx, d) && vec_ok(Y, ldy, d)
          ? launch_vec<TIn, true>(X, Y, xn, yn, out, P, m, n, d, ldx, ldy, ldo, gamma, splits,
                                  stream)
          : launch_vec<TIn, false>(X, Y, xn, yn, out, P, m, n, d, ldx, ldy, ldo, gamma, splits,
                                   stream));
}

// The aligned instance's resident blocks an SM, registers and local
// (spilled) bytes a thread, into out[0..2].
template <typename TIn>
int config(int* out) {
  auto kernel = gauss_kernel<TIn, true>;
  constexpr int smem = smem_of<TIn>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

// X (m, d) and Y (n, d) row-major with row strides ldx, ldy, both float32
// (in_bf16 = 0) or both bfloat16; xn (m,) and yn (n,) float32 squared row
// norms; out (m, n) float32 with row stride ldo. splits: the feature
// chunks (1: none); P: scratch of splits * m * n floats (unused, and may
// be null, when splits == 1). m, n > 0 (the caller handles empty outputs).
// Launches on `stream` and returns the launches' cudaError_t (0 = success).
extern "C" int kt_gaussian_kernel_block(const void* X, const void* Y, const float* xn,
                                        const float* yn, float* out, float* P, int m, int n,
                                        int d, long long ldx, long long ldy, long long ldo,
                                        float gamma, int splits, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(X, Y, xn, yn, out, P, m, n, d, ldx, ldy, ldo, gamma,
                                         splits, s)
                 : launch<float>(X, Y, xn, yn, out, P, m, n, d, ldx, ldy, ldo, gamma, splits,
                                 s);
}

// The kernel that kt_gaussian_kernel_block launches (its aligned form) on
// the current device: out[0] its resident blocks an SM, out[1] its
// registers a thread, out[2] its local (spilled) bytes a thread. Returns
// the cudaError_t.
extern "C" int kt_gaussian_kernel_block_config(int in_bf16, int* out) {
  return in_bf16 ? config<__nv_bfloat16>(out) : config<float>(out);
}
