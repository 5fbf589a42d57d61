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
// = 9.27e10 FLOP of float32 FMA ("f32 means f32": no TF32), 1.385 ms at
// the card's 67 TFLOP/s non-tensor float32 peak. The bytes it must move
// (X 360 MB, Y, norms, W 2 MB, the 20 KB output) take 0.109 ms at
// 3.35 TB/s. So the kernel is bound by float32 operations, and 99.4% of
// them are gaussian_kernel_block's X Y^T.
//
// Design (fma_pipe.cuh's pipelined tile, as gaussian_kernel_block.cu). The TPU
// kernel carries the (n, k) sum in its output tile along its sequential grid
// axis over train-row tiles. Here block (tj, z) owns the 128 output rows (Y
// rows) of column tile tj and walks the 128-row tiles of X in row chunk z. For
// each row tile it builds the 128 x 128 K tile with gaussian_kernel_block's
// mainloop (X and Y both K-major, loaded into registers a stage ahead and
// stored transposed into a 3-stage ring of 8 features; 16-byte loads where the
// bases, row strides and d allow, element by element otherwise), applies the
// epilogue (gaussian.cuh's gauss) and parks the tile in shared memory, in the
// ring's bytes once every thread is done with them. Then it contracts the tile
// with the row tile's W rows: the K tile is the row-major P of fma_pipe.cuh's
// fma_stage over its 128 rows (fully unrolled; steps of 32 or 64 rows spilled
// and ran slower), W's rows the Q of a 16-wide label pass, 8 output rows x 1
// label column a thread. CIFAR's k = 10 takes one pass (37.5% of its FMAs on
// zero columns; 69% in a 32-wide one), larger k further 16-wide passes over the
// parked tile. With one pass (k <= 16) the chunk's (n, k) partial stays in 8
// registers a thread across the row tiles and is written once a block (HOLD);
// with more, each pass adds into it where it lies in device memory. At k <= 16
// that form spilled 72 bytes and ran 26% slower, and 32-wide passes (16
// registers held) 4% slower (scripts/torch_fma_variants.py times the
// alternatives; PERF.md gives the numbers). Either way every partial entry is
// one fmaf chain over the chunk's rows in order. The row chunks are whole row
// tiles, chunk z the tiles [z T / splits, (z + 1) T / splits) of the T = ceil(m
// / 128), none empty; splits is the fewest that bring the (column tile, chunk)
// grid within 5% of whole waves of the kernel's resident blocks, counted in row
// tiles, since the longest chunk sets a wave's time
// (ops/cuda_ops.py:gaussian_resid_splits): 66 chunks of 5-6 tiles x 4 column
// tiles = 264 blocks, one wave of 2 an SM on 132 SMs, at the CIFAR sweep. A
// second kernel adds the chunks' partials in the order z = 0, 1, ...: no float
// atomics, the same bits every run. With one chunk the first kernel writes the
// output directly. Rows past m are masked (their K entries and W rows read as
// zero), never read; the reference pads and relies on W's ghost rows being
// zero, and the port's solver keeps that invariant too. Shared memory: the K
// tile (64 KB, over the ring's 24 KB) and one W tile (8 KB), 72 KB, so two
// blocks fit an SM.

#include "fma_pipe.cuh"
#include "gaussian.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 8;       // features a stage
constexpr int STAGES = 3;   // stages in the ring
constexpr int MINB = 2;     // blocks an SM the registers are capped for (128 a thread)
constexpr int TN = TM;      // output rows (Y rows) a block, 8 a thread
constexpr int KT = 16;      // label columns a contraction pass, 1 a thread
constexpr int NJL = KT / 16;

// The ring, or the K tile in its bytes once the mainloop is done.
template <typename TIn>
__host__ __device__ constexpr int ktile_bytes() {
  constexpr int ring = smem_bytes<TIn, TIn, BK, STAGES, 8, 8>();
  constexpr int ktile = TM * TN * static_cast<int>(sizeof(float));
  return ring > ktile ? ring : ktile;
}

// Then one W tile: the row tile's 128 rows x KT label columns.
template <typename TIn>
constexpr int smem_of() {
  return ktile_bytes<TIn>() + TM * KT * static_cast<int>(sizeof(float));
}

// Store a thread's partial (rows j0 + out_row<8>(i), label columns c0 +
// out_col<NJL>(j)) into the row-major (n, k) matrix dst, or load it from
// there.
__device__ __forceinline__ void partial_io(float* dst, bool load, int n, int k, long long j0,
                                           int c0, float (&part)[8][NJL]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = j0 + out_row<8>(i);
#pragma unroll
    for (int j = 0; j < NJL; ++j) {
      const int c = c0 + out_col<NJL>(j);
      if (r < n && c < k) {
        if (load)
          part[i][j] = dst[r * k + c];
        else
          dst[r * k + c] = part[i][j];
      }
    }
  }
}

// Block (blockIdx.x, blockIdx.y): output rows [128 x, +128) (Y's rows),
// row chunk y of `splits` (X's row tiles [y T / splits, (y + 1) T /
// splits) of T = ceil(m / 128)). Writes the chunk's (n, k) sums to out + y
// n k (out is the output itself when splits == 1). HOLD: k <= KT, and the
// partial of the one label tile stays in registers across the row tiles.
template <typename TIn, bool VEC, bool HOLD>
__global__ void __launch_bounds__(THREADS, MINB)
resid_kernel(const TIn* __restrict__ X, const TIn* __restrict__ Y, const float* __restrict__ xn,
             const float* __restrict__ yn, const float* __restrict__ W, float* __restrict__ out,
             int m, int n, int d, int k, long long ldx, long long ldy, long long ldw,
             float gamma, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [TM][TN]: X rows (the reduction) x Y rows
  float* Ws = reinterpret_cast<float*>(smem + ktile_bytes<TIn>());  // [TM][KT]
  const long long j0 = (long long)blockIdx.x * TN;
  // 32-bit row-tile counters (64-bit ones measured 2% slower).
  const int tiles = (m + TM - 1) / TM;
  const int t0 = static_cast<int>((long long)blockIdx.y * tiles / splits);
  const int t1 = static_cast<int>(((long long)blockIdx.y + 1) * tiles / splits);
  float* dst = out + (long long)blockIdx.y * n * k;
  const int tx = threadIdx.x % 16;
  float part[8][NJL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJL; ++j) part[i][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const long long i0 = (long long)t * TM;
    const long long iend = i0 + TM < m ? i0 + TM : m;
    float acc[8][8];
    // X Y^T of the tile, both operands K-major (gaussian_kernel_block's).
    mainloop<BK, STAGES, 8, 8, VEC, VEC, true, true>(smem, X, ldx, i0, m, Y, ldy, j0, n, 0, d,
                                                      false, acc);
    // Every thread is done with the ring, whose bytes take the K tile.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = out_row<8>(i);
      const long long r = i0 + rr;
      const float xr = r < m ? xn[r] : 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long c = j0 + out_col<8>(4 * q + e);
          v[e] = r < m && c < n ? gauss(xr, yn[c], acc[i][4 * q + e], gamma) : 0.f;
        }
        *reinterpret_cast<float4*>(Ks + rr * TN + q * 64 + tx * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int c0 = 0; c0 < k; c0 += KT) {
      if constexpr (!HOLD) {
        if (t == t0) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < NJL; ++j) part[i][j] = 0.f;
        } else {
          partial_io(dst, true, n, k, j0, c0, part);
        }
      }
      Stager<float, TM, KT, false> ws(W, ldw, i0, iend, c0, k);
      ws.copy(Ws);
      cp_async_commit();
      cp_async_wait<0>();
      // The K tile (at the first pass) and this W tile are complete.
      __syncthreads();
      fma_stage<TM, 8, NJL>(Ks, Ws, part);
      // Every thread is done with the W tile (and, after the last pass, with
      // the K tile, whose bytes the next row tile's ring takes).
      __syncthreads();
      if constexpr (!HOLD) partial_io(dst, false, n, k, j0, c0, part);
    }
  }
  if constexpr (HOLD) partial_io(dst, false, n, k, j0, 0, part);
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

template <typename TIn, bool VEC>
auto kernel_of(int k) {
  return k <= KT ? resid_kernel<TIn, VEC, true> : resid_kernel<TIn, VEC, false>;
}

template <typename TIn, bool VEC>
cudaError_t launch_vec(const TIn* X, const TIn* Y, const float* xn, const float* yn,
                       const float* W, float* P, float* C, int m, int n, int d, int k,
                       long long ldx, long long ldy, long long ldw, int splits, float gamma,
                       cudaStream_t stream) {
  auto kernel = kernel_of<TIn, VEC>(k);
  constexpr int smem = smem_of<TIn>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TN - 1) / TN, splits);
  kernel<<<grid, THREADS, smem, stream>>>(X, Y, xn, yn, W, splits > 1 ? P : C, m, n, d, k, ldx,
                                          ldy, ldw, gamma, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = (long long)n * k;
  const long long want = (count + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials_kernel<<<blocks, THREADS, 0, stream>>>(P, C, count, splits);
  return cudaGetLastError();
}

template <typename TIn>
int launch(const void* Xv, const void* Yv, const float* xn, const float* yn, const float* W,
           float* P, float* C, int m, int n, int d, int k, long long ldx, long long ldy,
           long long ldw, int splits, float gamma, cudaStream_t stream) {
  const TIn* X = static_cast<const TIn*>(Xv);
  const TIn* Y = static_cast<const TIn*>(Yv);
  // Chunks of whole row tiles, none empty: the first kernel writes every
  // entry of every partial it is given.
  const long long tiles = ((long long)m + TM - 1) / TM;
  splits = static_cast<int>(splits < tiles ? splits : tiles);
  return static_cast<int>(
      vec_ok(X, ldx, d) && vec_ok(Y, ldy, d)
          ? launch_vec<TIn, true>(X, Y, xn, yn, W, P, C, m, n, d, k, ldx, ldy, ldw, splits, gamma,
                                  stream)
          : launch_vec<TIn, false>(X, Y, xn, yn, W, P, C, m, n, d, k, ldx, ldy, ldw, splits,
                                   gamma, stream));
}

// For k label columns and the 16-byte (vec) or element-wise instance: the
// label-tile width, resident blocks an SM, registers and local (spilled)
// bytes a thread, and dynamic shared memory bytes a block, into out[0..4].
template <typename TIn>
int config(int k, bool vec, int* out) {
  auto kernel = vec ? kernel_of<TIn, true>(k) : kernel_of<TIn, false>(k);
  constexpr int smem = smem_of<TIn>();
  out[0] = KT;
  out[4] = smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace
// X (m, d) and Y (n, d) row-major with row strides ldx, ldy, both float32
// (in_bf16 = 0) or both bfloat16; xn (m,), yn (n,) float32 squared row
// norms; W (m, k) float32 with row stride ldw. splits: the row chunks (at
// most ceil(m / 128) are used); P: scratch of splits * n * k floats
// (unused, and may be null, when splits == 1). Writes C (n, k) float32,
// contiguous. m, n, k > 0 (the caller handles empty operands). Launches on
// `stream` and returns the launches' cudaError_t (0 = success).
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

// The kernel that kt_gaussian_resid_block launches for k label columns, its
// 16-byte (vec = 1) or element-wise form, on the current device: out[0] its
// label-tile width, out[1] its resident blocks an SM, out[2] its registers
// a thread, out[3] its local (spilled) bytes a thread, out[4] its dynamic
// shared memory a block. Returns the cudaError_t.
extern "C" int kt_gaussian_resid_block_config(int k, int in_bf16, int vec, int* out) {
  return in_bf16 ? config<__nv_bfloat16>(k, vec != 0, out) : config<float>(k, vec != 0, out);
}
