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
// Design (fma_pipe.cuh's pipelined tile). A block owns 128 window columns
// x one label tile that holds all of R's columns up to KT_WIDE = 160 (10 a
// thread), so a 147-wide R is one tile with 8% of its FMAs masked, and
// each window tile is staged once a row stage; k <= 32 takes a 32-wide
// tile (2 a thread), and k > 160 further 160-wide tiles. The output
// (4096 x 147) gives only 32 such tiles for 132 SMs, so the row sum is
// split into chunks (the TPU kernel sums all row tiles along its sequential
// grid axis on one core): block (tile, z) sums chunk z into a partial
// buffer P[z], and a second kernel in the same call adds the partials in
// the order z = 0, 1, ... No float atomics: a run gives the same bits every
// time. The wrapper picks the chunk count (ops/cuda_ops.py:corr_splits)
// from the kernel's resident blocks an SM (kt_block_corr_config) so that
// the grid fills whole waves: at the TIMIT shapes, 2 blocks an SM on 132
// SMs give 8 chunks of 8,192 rows, 32 x 8 = 256 blocks, 0.97 of one wave
// of 264 (1 block an SM would give 4 chunks, 128 blocks, 0.97 of 132).
// Rows stream through a 2-stage cp.async ring of 16-row stages (the fastest
// of 2, 3 and 4 stages and 8, 16 and 32 rows: scripts/
// torch_fma_variants.py); the window
// in 16-byte chunks when it is 16-byte aligned (F's base, row stride and
// the window's start and width), element by element otherwise; R's rows
// (588 bytes at k = 147: not 16-byte aligned) element by element through
// 4-byte cp.async. For bf16 F each R value is rounded to bf16 as it lands
// in shared memory, as the TPU kernel rounds R to its bf16 matrix unit's
// operand type; F is widened as it is read; products and sums stay
// float32.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 16;         // rows a stage
constexpr int STAGES = 2;      // stages in the cp.async ring
constexpr int MINB = 2;        // blocks an SM the registers are capped for (128 a thread)

// blockIdx.x: output tile (ti, tj), ti over the window's 128-column tiles,
// tj over R's KT-column tiles (KT = 16 * NJ); blockIdx.y: the row chunk
// [y * chunk, (y + 1) * chunk). Writes the chunk's sum to Out + y * b * k
// (row-major (b, k)).
template <typename TF, int NJ, bool VF>
__global__ void __launch_bounds__(THREADS, MINB)
corr_kernel(const TF* __restrict__ Fw, const float* __restrict__ R, float* __restrict__ Out,
            int n, int b, int k, long long ldf, long long ldr, int nkt, long long chunk,
            int round_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = (long long)(blockIdx.x / nkt) * TM;
  const long long j0 = (long long)(blockIdx.x % nkt) * 16 * NJ;
  const long long rbeg = (long long)blockIdx.y * chunk;
  const long long rend = rbeg + chunk < n ? rbeg + chunk : n;
  float acc[8][NJ];
  mainloop<BK, STAGES, 8, NJ, VF, false>(smem, Fw, ldf, i0, b, R, ldr, j0, k, rbeg, rend,
                                         round_r != 0, acc);
  store_tile<8, NJ>(Out + (long long)blockIdx.y * b * k, b, k, i0, j0, acc);
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

// With splits > 1 the chunks' partial sums go to P (splits * b * k floats)
// and a second kernel adds them into C; with one chunk the first kernel
// writes C.
template <typename TF, int NJ, bool VF>
cudaError_t launch_corr(const TF* Fw, const float* R, float* P, float* C, int n, int b,
                        int k, long long ldf, long long ldr, int splits, cudaStream_t stream) {
  auto kernel = corr_kernel<TF, NJ, VF>;
  constexpr int smem = smem_bytes<TF, float, BK, STAGES, 8, NJ>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nkt = (k + 16 * NJ - 1) / (16 * NJ);
  // Chunks of whole BK-row stages; the last chunk may be short or empty.
  long long chunk = ((long long)n + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  if (chunk == 0) chunk = BK;
  const dim3 grid((b + TM - 1) / TM * nkt, splits);
  kernel<<<grid, THREADS, smem, stream>>>(Fw, R, splits > 1 ? P : C, n, b, k, ldf, ldr, nkt,
                                          chunk, static_cast<int>(sizeof(TF) == 2));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = (long long)b * k;
  const long long want = (count + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials_kernel<<<blocks, THREADS, 0, stream>>>(P, C, count, splits);
  return cudaGetLastError();
}

template <typename TF, int NJ>
int launch_tile(const void* F, const float* R, float* P, float* C, int n, int col_start,
                int b, int k, long long ldf, long long ldr, int splits, cudaStream_t stream) {
  const TF* Fw = static_cast<const TF*>(F) + col_start;
  return static_cast<int>(
      vec_ok(Fw, ldf, b)
          ? launch_corr<TF, NJ, true>(Fw, R, P, C, n, b, k, ldf, ldr, splits, stream)
          : launch_corr<TF, NJ, false>(Fw, R, P, C, n, b, k, ldf, ldr, splits, stream));
}

template <typename TF>
int launch(const void* F, const float* R, float* P, float* C, int n, int col_start, int b,
           int k, long long ldf, long long ldr, int splits, cudaStream_t stream) {
  return with_label_tile(k, [&](auto nj) {
    return launch_tile<TF, decltype(nj)::value>(F, R, P, C, n, col_start, b, k, ldf, ldr,
                                                splits, stream);
  });
}

// The aligned instance's resident blocks an SM, registers and local
// (spilled) bytes a thread, into out[0..2].
template <typename TF, int NJ>
cudaError_t occupancy(int* out) {
  auto kernel = corr_kernel<TF, NJ, true>;
  constexpr int smem = smem_bytes<TF, float, BK, STAGES, 8, NJ>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return err;
}

template <typename TF>
int config(int k, int* out) {
  return with_label_tile(k, [&](auto nj) {
    out[0] = 16 * decltype(nj)::value;
    return static_cast<int>(occupancy<TF, decltype(nj)::value>(out + 1));
  });
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

// The kernel that kt_block_corr launches for k label columns (its aligned
// form) on the current device: out[0] its label-tile width, out[1] its
// resident blocks an SM, out[2] its registers a thread, out[3] its local
// (spilled) bytes a thread. Returns the cudaError_t.
extern "C" int kt_block_corr_config(int k, int f_bf16, int* out) {
  return f_bf16 ? config<__nv_bfloat16>(k, out) : config<float>(k, out);
}
