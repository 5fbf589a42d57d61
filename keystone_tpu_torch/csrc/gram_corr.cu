// One-launch Gramian + correlation: (A^T A, A^T R), the whole (d, d)
// Gramian returned (the dense form), computed from its upper-triangle tiles.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr
// (_gram_corr_kernel), the Gramian + correlation of a first-epoch block
// update in the block coordinate descent solvers when they are asked for
// the dense form (keystone_tpu/parallel/linalg.py:_bcd_block_update with
// sym=False).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one 4096-wide block,
// n = 65536 rows, k = 147 label columns): the function needs the upper
// triangle, n*d*(d+1) = 1.10e12 FLOP, and the correlation 2*n*d*k = 7.9e10,
// 1.18e12 FLOP of float32 FMA in all (no TF32: "f32 means f32"), which take
// 17.6 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (A's 1.07 GB and R read once, 67 MB of Gramian written) take
// 0.35 ms at 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design (fma_pipe.cuh's pipelined tile). Every output tile is one block of
// one launch that loops over all n rows itself, so nothing carries between
// blocks and no atomics are needed; the TPU kernel's sequential row-tile
// grid axis becomes that loop, and every output entry is one fmaf chain
// over rows 0 ... n-1 in order. So the Gramian is exactly symmetric and
// has the bits of gram_corr_sym.cu's mirrored one, and the correlation the
// bits of gram_corr_sym's correlation: the sym=False block update gives
// the sym=True one's bits.
//   - Blocks [0, ncorr): the correlation, 64 columns of A (4 a thread) x a
//     label tile that holds all of R's columns up to 160 (k = 147: 8%
//     masked; k <= 32: 32 wide), block_corr.cu's label-tile rule. 64 blocks
//     at d = 4096, each 0.625 of a Gramian block's work.
//   - Blocks [ncorr, ...): one block per upper Gramian tile (ti <= tj) of
//     128 x 128 (8 x 8 outputs a thread), 528 at d = 4096 (the dense TPU
//     kernel computes all 1,024), writing its tile and, off the diagonal,
//     the tile's transpose into the mirror position.
// At the TIMIT shapes 592 blocks are 2.24 waves of the 264 resident (2
// blocks an SM on 132 SMs). The 528 Gramian tiles alone are exactly 2
// waves, so the correlation's work always spills into a third round; the
// correlation blocks come first, and the narrower they are, the sooner
// the Gramian tiles they delay start. 64 blocks of 64 columns measured
// fastest (scripts/torch_fma_variants.py: 32 of 128 columns and 128 of 32
// were slower). Splitting the correlation's rows into chunks would fill
// the waves better, but changes its sums' order: the bits of
// gram_corr_sym's correlation, which the sym=False update relies on,
// need one chain over all rows.
// Rows stream through a 3-stage cp.async ring of 32-row stages for the
// Gramian (the fastest of 8, 16 and 32 rows and 2, 3 and 4 stages:
// scripts/torch_fma_variants.py) and block_corr.cu's 16-row stages for the
// correlation, in 16-byte chunks when A's
// base and row stride and d are 16-byte aligned, else element by element;
// bf16 A is widened to float32 as it is read from shared memory; R stays
// float32 in the product (the TPU kernel rounds R to the operand dtype for
// its bf16 matrix unit; the FMA path has no such need). Ragged edges of n,
// d and k are masked.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 32;         // rows a stage of the Gramian
constexpr int STAGES = 3;      // stages in the cp.async ring
constexpr int MINB = 2;        // blocks an SM the registers are capped for (128 a thread)
constexpr int CORR_BK = 16;    // rows a stage of the correlation (block_corr.cu's)
constexpr int CORR_MI = 4;     // columns of A a thread of a correlation block (x 16 a block)

template <typename TA, int NJ>
constexpr int smem_of() {
  constexpr int gram = smem_bytes<TA, TA, BK, STAGES, 8, 8>();
  constexpr int corr = smem_bytes<TA, float, CORR_BK, STAGES, CORR_MI, NJ>();
  return gram > corr ? gram : corr;
}

// NJ: the correlation's label tile, 16 * NJ columns; nkt of them, and ncorr
// correlation blocks in all.
template <typename TA, int NJ, bool VA>
__global__ void __launch_bounds__(THREADS, MINB)
gram_corr_kernel(const TA* __restrict__ A, const float* __restrict__ R,
                 float* __restrict__ G, float* __restrict__ C, int n, int d, int k,
                 long long lda, long long ldr, int nt, int ncorr, int nkt) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < ncorr) {
    const long long i0 = (long long)(blockIdx.x / nkt) * 16 * CORR_MI;
    const long long j0 = (long long)(blockIdx.x % nkt) * 16 * NJ;
    float acc[CORR_MI][NJ];
    mainloop<CORR_BK, STAGES, CORR_MI, NJ, VA, false>(smem, A, lda, i0, d, R, ldr, j0, k, 0, n,
                                                      false, acc);
    store_tile<CORR_MI, NJ>(C, d, k, i0, j0, acc);
    return;
  }
  int ti = 0;
  int rem = blockIdx.x - ncorr;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const long long i0 = (long long)ti * TM;
  const long long j0 = (long long)tj * TM;
  float acc[8][8];
  mainloop<BK, STAGES, 8, 8, VA, VA>(smem, A, lda, i0, d, A, lda, j0, d, 0, n, false, acc);
  store_tile<8, 8>(G, d, d, i0, j0, acc);
  if (ti == tj) return;  // a diagonal tile is computed whole
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + out_row<8>(i);
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + out_col<8>(j);
      if (c < d) G[c * d + r] = acc[i][j];  // the mirror tile
    }
  }
}

// The kernel instance for these operands, its shared memory, and its label
// tile's width.
template <typename TA>
struct Instance {
  void (*kernel)(const TA*, const float*, float*, float*, int, int, int, long long, long long,
                 int, int, int);
  int smem;
  int ktile;
};

template <typename TA, int NJ>
Instance<TA> instance_nj(bool vec) {
  return {vec ? gram_corr_kernel<TA, NJ, true> : gram_corr_kernel<TA, NJ, false>,
          smem_of<TA, NJ>(), 16 * NJ};
}

template <typename TA>
cudaError_t instance(const TA* A, int d, int k, long long lda, Instance<TA>* out) {
  const bool vec = vec_ok(A, lda, d);
  *out = with_label_tile(k, [&](auto nj) { return instance_nj<TA, decltype(nj)::value>(vec); });
  return cudaFuncSetAttribute(out->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              out->smem);
}

// The correlation's blocks: 16 * CORR_MI columns of A x ktile label columns.
inline int corr_blocks(int d, int k, int ktile) {
  return (d + 16 * CORR_MI - 1) / (16 * CORR_MI) * ((k + ktile - 1) / ktile);
}

// The grid of one call: out[0] Gramian blocks, out[1] correlation blocks,
// out[2] the label tile's width, out[3..5] the kernel's resident blocks an
// SM, registers and local (spilled) bytes a thread, out[6] the SM count,
// out[7] the columns of A a correlation block.
template <typename TA>
cudaError_t plan(const TA* A, int d, int k, long long lda, int* out) {
  Instance<TA> inst;
  cudaError_t err = instance(A, d, k, lda, &inst);
  if (err != cudaSuccess) return err;
  const int nt = (d + TM - 1) / TM;
  out[0] = nt * (nt + 1) / 2;
  out[1] = corr_blocks(d, k, inst.ktile);
  out[2] = inst.ktile;
  out[7] = 16 * CORR_MI;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], inst.kernel, THREADS,
                                                      inst.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, inst.kernel);
  if (err != cudaSuccess) return err;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[6], cudaDevAttrMultiProcessorCount, dev);
}

template <typename TA>
int launch(const void* Av, const float* R, float* G, float* C, int n, int d, int k,
           long long lda, long long ldr, cudaStream_t stream) {
  const TA* A = static_cast<const TA*>(Av);
  Instance<TA> inst;
  const cudaError_t err = instance(A, d, k, lda, &inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d + TM - 1) / TM;
  const int ncorr = corr_blocks(d, k, inst.ktile);
  inst.kernel<<<ncorr + nt * (nt + 1) / 2, THREADS, inst.smem, stream>>>(
      A, R, G, C, n, d, k, lda, ldr, nt, ncorr, (k + inst.ktile - 1) / inst.ktile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (n, d) row-major with row stride lda, float32 (a_bf16 = 0) or bfloat16;
// R (n, k) float32 with row stride ldr. Writes G (d, d) and C (d, k), both
// float32 and contiguous; d > 0 (the caller handles empty outputs). Launches
// on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_gram_corr(const void* A, const float* R, float* G, float* C, int n,
                            int d, int k, long long lda, long long ldr, int a_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? launch<__nv_bfloat16>(A, R, G, C, n, d, k, lda, ldr, s)
                : launch<float>(A, R, G, C, n, d, k, lda, ldr, s);
}

// The grid kt_gram_corr launches for these operands on the current device
// (the layout of `plan` above: 8 ints). Returns the cudaError_t.
extern "C" int kt_gram_corr_config(const void* A, int d, int k, long long lda, int a_bf16,
                                   int* out) {
  return static_cast<int>(
      a_bf16 ? plan(static_cast<const __nv_bfloat16*>(A), d, k, lda, out)
             : plan(static_cast<const float*>(A), d, k, lda, out));
}
