// A float32 product out = X W whose row i has the same bits however many
// rows share the call: row i's outputs depend on row i of X and on W alone.
//
// Replaces no TPU kernel. The TPU package leaves a linear model's product
// to XLA (keystone_tpu/ops/learning/linear.py LinearMapper,
// block.py BlockLinearMapper). On the card that product went to cuBLAS,
// which picks its algorithm, and with it the order of every sum, by the
// row count: a served request padded to a bucket of 2 rows and the same
// row in a 256-row batch apply parted by 3.6e-7, so an exported plan broke
// its own contract that every padding bucket serves the same bits (ROADMAP
// C.8). This kernel is the exported plan's product, and the fused batch
// apply's (both reach it through the mappers' device_fn), so served rows
// equal a batch apply of the same plan bit for bit.
//
// The arithmetic, fixed by k alone. The reduction index runs in chunks of
// KC = 256 (the last one shorter). Each output's chunk sum is one fmaf
// chain from zero over the chunk's indices in increasing order
// (fma_pipe.cuh's tile, whatever the thread map), and the chunk sums are
// added in chunk order, the first one as it is: out = ((p0 + p1) + p2) +
// ... Nothing of that depends on the row count. What does depend on it is
// only the schedule, which changes no bit: the tile shape (32 x 32 for m
// <= 64, 128 x 32 or 128 x 160 above), and the row panels (the wrapper's
// panel_rows bounds the scratch of chunk sums, and panels run one after
// another). No atomics; split counts never follow the tile count.
//
// Bound on an H100 SXM. At TIMIT's bucket 2 (2 x 16384 x 147) the bytes
// bound it: W's 9.6 MB read once take 2.9 us at 3.35 TB/s. cuBLAS reaches
// small-m speed by splitting k, which is what moves the bits; here the
// fixed chunks do that job: 64 chunks x 5 column tiles = 320 blocks read W
// in parallel. At a 65,536-row batch apply the float32 FMAs bound it:
// 3.16e11 FLOP, 4.7 ms at 67 TFLOP/s. The chunk sums then cost a round
// trip through device memory (64 partial (rows, n) slabs written and read
// once, ~15% of the bound at n = 147): the price of fixing the sum order.
// X is the K-major operand (its rows are output rows, the reduction runs
// along its contiguous columns), through fma_pipe.cuh's KStager in 16-byte
// chunks where X's base and row stride and k are 16-byte multiples,
// element by element otherwise; W is the row-major one, in 16-byte
// cp.async chunks where its rows are whole chunks and the tile is 32
// columns wide, element by element otherwise (147 columns are not).
// 2-stage ring of 16-index stages, as block_residual_update.cu, whose tile
// (window K-major, dW row-major) this is.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int KC = 256;    // the fixed reduction chunk
constexpr int BK = 16;     // reduction indices a stage
constexpr int STAGES = 2;  // stages in the cp.async ring
constexpr int MINB = 2;    // blocks an SM the registers are capped for (128 a thread)
constexpr int NARROW_ROWS = 64;  // row counts up to this take 32 x 32 tiles

// blockIdx.x = ti * ntj + tj: output rows [16 MI ti, 16 MI ti + 16 MI) of
// the panel x columns [16 NJ tj, ...); blockIdx.y = the chunk c. Writes
// chunk c's sums to Out + c * chunk_stride (row stride ldo).
template <int MI, int NJ, bool VX, bool VW>
__global__ void __launch_bounds__(THREADS, MINB)
chunk_kernel(const float* __restrict__ X, const float* __restrict__ W, float* __restrict__ Out,
             int m, int n, int k, long long ldx, long long ldw, long long ldo,
             long long chunk_stride, int ntj) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = (long long)(blockIdx.x / ntj) * 16 * MI;
  const long long j0 = (long long)(blockIdx.x % ntj) * 16 * NJ;
  const long long kbeg = (long long)blockIdx.y * KC;
  const long long kend = kbeg + KC < k ? kbeg + KC : k;
  float acc[MI][NJ];
  // X K-major, W row-major.
  mainloop<BK, STAGES, MI, NJ, VX, VW, true>(smem, X, ldx, i0, m, W, ldw, j0, n, kbeg, kend,
                                             false, acc);
  float* out = Out + (long long)blockIdx.y * chunk_stride;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long r = i0 + out_row<MI>(i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < n) out[r * ldo + c] = acc[i][j];
    }
  }
}

// out[r][c] = P[0][r][c] + P[1][r][c] + ... in chunk order, the first
// chunk's sum as it is, for the panel's rows x n entries (P row stride n).
__global__ void __launch_bounds__(THREADS)
sum_chunks_kernel(const float* __restrict__ P, float* __restrict__ out, int rows, int n,
                  int chunks, long long chunk_stride, long long ldo) {
  const long long count = (long long)rows * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float s = P[e];
    for (int z = 1; z < chunks; ++z) s = __fadd_rn(s, P[z * chunk_stride + e]);
    out[(e / n) * ldo + e % n] = s;
  }
}

template <int MI, int NJ, bool VX, bool VW>
cudaError_t launch_panels(const float* X, const float* W, float* P, float* out, int m, int n,
                          int k, long long ldx, long long ldw, long long ldo, int panel_rows,
                          cudaStream_t stream) {
  auto kernel = chunk_kernel<MI, NJ, VX, VW>;
  constexpr int smem = smem_bytes<float, float, BK, STAGES, MI, NJ>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (k + KC - 1) / KC;
  const int ntj = (n + 16 * NJ - 1) / (16 * NJ);
  for (int r0 = 0; r0 < m; r0 += panel_rows) {
    const int rows = m - r0 < panel_rows ? m - r0 : panel_rows;
    const dim3 grid((rows + 16 * MI - 1) / (16 * MI) * ntj, chunks);
    const float* Xp = X + (long long)r0 * ldx;
    float* outp = out + (long long)r0 * ldo;
    if (chunks == 1) {
      kernel<<<grid, THREADS, smem, stream>>>(Xp, W, outp, rows, n, k, ldx, ldw, ldo, 0, ntj);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      continue;
    }
    const long long chunk_stride = (long long)rows * n;
    kernel<<<grid, THREADS, smem, stream>>>(Xp, W, P, rows, n, k, ldx, ldw, n, chunk_stride,
                                            ntj);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long want = (chunk_stride + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    sum_chunks_kernel<<<blocks, THREADS, 0, stream>>>(P, outp, rows, n, chunks, chunk_stride,
                                                      ldo);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// fn(std::integral_constant<int, MI>, std::integral_constant<int, NJ>) for
// the tile of an m x n output.
template <typename Fn>
inline auto with_tile(int m, int n, Fn&& fn) {
  using I2 = std::integral_constant<int, 2>;
  using I8 = std::integral_constant<int, 8>;
  if (m <= NARROW_ROWS) return fn(I2{}, I2{});
  return with_label_tile(n, [&](auto nj) { return fn(I8{}, nj); });
}

template <int MI, int NJ>
cudaError_t launch_tile(const float* X, const float* W, float* P, float* out, int m, int n,
                        int k, long long ldx, long long ldw, long long ldo, int panel_rows,
                        cudaStream_t stream) {
  const bool vx = vec_ok(X, ldx, k);
  // W in 16-byte chunks where its rows are whole chunks and a stage row of
  // the tile is whole passes of the block's threads (32 columns: 8 chunks
  // a row; 160 columns make 40, which 256 threads do not divide).
  if constexpr (THREADS % (16 * NJ / 4) == 0) {
    if (vec_ok(W, ldw, n))
      return vx ? launch_panels<MI, NJ, true, true>(X, W, P, out, m, n, k, ldx, ldw, ldo,
                                                    panel_rows, stream)
                : launch_panels<MI, NJ, false, true>(X, W, P, out, m, n, k, ldx, ldw, ldo,
                                                     panel_rows, stream);
  }
  return vx ? launch_panels<MI, NJ, true, false>(X, W, P, out, m, n, k, ldx, ldw, ldo,
                                                 panel_rows, stream)
            : launch_panels<MI, NJ, false, false>(X, W, P, out, m, n, k, ldx, ldw, ldo,
                                                  panel_rows, stream);
}

// The aligned-X, element-wise-W instance's tile rows and columns, resident
// blocks an SM, registers and local (spilled) bytes a thread, into
// out[0..4].
template <int MI, int NJ>
cudaError_t config_tile(int* out) {
  auto kernel = chunk_kernel<MI, NJ, true, false>;
  constexpr int smem = smem_bytes<float, float, BK, STAGES, MI, NJ>();
  out[0] = 16 * MI;
  out[1] = 16 * NJ;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

// X (m, k) float32 with row stride ldx; W (k, n) float32 with row stride
// ldw; out (m, n) float32 with row stride ldo; m, n, k > 0 (the caller
// handles empty operands). P: scratch of ceil(k / 256) * min(m,
// panel_rows) * n floats (unused, and may be null, when k <= 256); rows run
// in panels of panel_rows. Launches on `stream` and returns the launches'
// cudaError_t (0 = success).
extern "C" int kt_row_stable_matmul(const float* X, const float* W, float* P, float* out, int m,
                                    int n, int k, long long ldx, long long ldw, long long ldo,
                                    int panel_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_tile(m, n, [&](auto mi, auto nj) {
    return launch_tile<decltype(mi)::value, decltype(nj)::value>(X, W, P, out, m, n, k, ldx,
                                                                 ldw, ldo, panel_rows, s);
  }));
}

// The tile kt_row_stable_matmul takes for an m x n output on the current
// device: out[0] its rows, out[1] its columns, out[2] its resident blocks
// an SM, out[3] its registers a thread, out[4] its local (spilled) bytes a
// thread. Returns the cudaError_t.
extern "C" int kt_row_stable_matmul_config(int m, int n, int* out) {
  return static_cast<int>(with_tile(m, n, [&](auto mi, auto nj) {
    return config_tile<decltype(mi)::value, decltype(nj)::value>(out);
  }));
}
