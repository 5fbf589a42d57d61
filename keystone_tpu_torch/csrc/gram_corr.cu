// The three Gramian kernels of the block solvers, on fma_pipe.cuh's
// pipelined tile:
//   - kt_gram_corr, (A^T A, A^T R) in one launch, the whole (d, d) Gramian
//     returned, computed from its upper-triangle tiles and mirrored. The
//     gram_corr_sym and gram_corr wrappers both launch it.
//   - kt_block_gram_sym, the Gramian of a column window F[:, s:s+b], read
//     in place through F's row stride: the same upper-triangle tiles with
//     no correlation.
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr_sym
// (_gram_corr_sym_kernel), the Gramian + correlation of every first-epoch
// block update in the stacked block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_block_update).
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_corr
// (_gram_corr_kernel), the same pair in the dense form the block update
// takes with sym=False (the TPU kernel computes every Gramian tile).
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:block_gram_sym
// (_gram_sym_kernel), the first-epoch Gramian of every block in the flat
// block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_fused_flat_kernel, strided_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one 4096-wide block,
// n = 65536 rows, k = 147 label columns): the function needs the upper
// triangle, n*d*(d+1) = 1.10e12 FLOP, and the correlation 2*n*d*k = 7.9e10,
// 1.18e12 FLOP of float32 FMA in all (no TF32: "f32 means f32"), which take
// 17.6 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (A's 1.07 GB and R read once, 67 MB of Gramian written) take
// 0.35 ms at 3.35 TB/s. So the kernel is bound by float32 operations. The
// window Gramian alone (F 65536 x 16384, a 4096-wide window) needs the
// 1.10e12 FLOP, 16.4 ms, against 0.34 ms of bytes.
//
// Design (fma_pipe.cuh's pipelined tile). Every output tile is one block of
// one launch that loops over all n rows itself, so nothing carries between
// blocks and no atomics are needed; the TPU kernels' sequential row-tile
// grid axis becomes that loop, and every output entry is one fmaf chain
// over rows 0 ... n-1 in order. So the Gramian is exactly symmetric, the
// sym=False block update gives the sym=True one's bits, and a window read
// in place gives the bits of its copy.
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
// the waves better, but changes its sums' order: the bits of the sym=True
// correlation, which the sym=False update relies on, need one chain over
// all rows. The window Gramian launches the Gramian tiles alone
// (gram_kernel, no correlation branch): 528 blocks, 2.00 waves. The
// window's start enters as a pointer offset and its right edge as the
// column mask, so nothing outside the window is read.
// Rows stream through a 3-stage cp.async ring of 32-row stages for the
// Gramian (the fastest of 8, 16 and 32 rows and 2, 3 and 4 stages:
// scripts/torch_fma_variants.py) and block_corr.cu's 16-row stages for the
// correlation, in 16-byte chunks when A's (the window's) base and row
// stride and d (b) are 16-byte aligned, else element by element; bf16 A is
// widened to float32 as it is read from shared memory; R stays float32 in
// the product (the TPU kernel rounds R to the operand dtype for its bf16
// matrix unit; the FMA path has no such need). Ragged edges of n, d and k
// are masked.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 32;         // rows a stage of the Gramian
constexpr int STAGES = 3;      // stages in the cp.async ring
constexpr int MINB = 2;        // blocks an SM the registers are capped for (128 a thread)
constexpr int CORR_BK = 16;    // rows a stage of the correlation (block_corr.cu's)
constexpr int CORR_MI = 4;     // columns of A a thread of a correlation block (x 16 a block)

template <typename TA>
constexpr int gram_smem() {
  return smem_bytes<TA, TA, BK, STAGES, 8, 8>();
}

template <typename TA, int NJ>
constexpr int smem_of() {
  constexpr int corr = smem_bytes<TA, float, CORR_BK, STAGES, CORR_MI, NJ>();
  return gram_smem<TA>() > corr ? gram_smem<TA>() : corr;
}

// Upper Gramian tile p (ti <= tj, row-major over the upper triangle of nt
// x nt tiles) of A's d columns over all n rows, stored into G (d, d) with,
// off the diagonal, its mirror tile.
template <typename TA, bool VA>
__device__ __forceinline__ void gram_tile(unsigned char* smem, const TA* __restrict__ A,
                                          float* __restrict__ G, int n, int d, long long lda,
                                          int nt, int p) {
  int ti = 0;
  int rem = p;
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
  gram_tile<TA, VA>(smem, A, G, n, d, lda, nt, blockIdx.x - ncorr);
}

// The Gramian tiles alone: block p is upper tile p.
template <typename TA, bool VA>
__global__ void __launch_bounds__(THREADS, MINB)
gram_kernel(const TA* __restrict__ A, float* __restrict__ G, int n, int d, long long lda,
            int nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  gram_tile<TA, VA>(smem, A, G, n, d, lda, nt, blockIdx.x);
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

// A kernel's resources on the current device: out[0] its resident blocks
// an SM, out[1..2] registers and local (spilled) bytes a thread, out[3] the
// SM count.
template <typename Kernel>
cudaError_t resources(Kernel kernel, int smem, int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
}

// The grid of one call: out[0] Gramian blocks, out[1] correlation blocks,
// out[2] the label tile's width, out[3..6] the kernel's resources, out[7]
// the columns of A a correlation block.
template <typename TA>
cudaError_t plan(const TA* A, int d, int k, long long lda, int* out) {
  Instance<TA> inst;
  const cudaError_t err = instance(A, d, k, lda, &inst);
  if (err != cudaSuccess) return err;
  const int nt = (d + TM - 1) / TM;
  out[0] = nt * (nt + 1) / 2;
  out[1] = corr_blocks(d, k, inst.ktile);
  out[2] = inst.ktile;
  out[7] = 16 * CORR_MI;
  return resources(inst.kernel, inst.smem, out + 3);
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

template <typename TA>
using GramKernel = void (*)(const TA*, float*, int, int, long long, int);

// The window Gramian's kernel for the window W (base pointer, row stride
// ldf, b columns): the 16-byte instance where the window's rows are whole
// 16-byte chunks (vec), else the element-wise one.
template <typename TA>
cudaError_t gram_instance(const TA* W, int b, long long ldf, GramKernel<TA>* kernel, bool* vec) {
  *vec = vec_ok(W, ldf, b);
  *kernel = *vec ? gram_kernel<TA, true> : gram_kernel<TA, false>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              gram_smem<TA>());
}

// The window Gramian's grid: out[0] blocks, out[1] whether the 16-byte
// path is taken, out[2..5] the kernel's resources.
template <typename TA>
cudaError_t gram_plan(const TA* W, int b, long long ldf, int* out) {
  GramKernel<TA> kernel;
  bool vec;
  const cudaError_t err = gram_instance(W, b, ldf, &kernel, &vec);
  if (err != cudaSuccess) return err;
  const int nt = (b + TM - 1) / TM;
  out[0] = nt * (nt + 1) / 2;
  out[1] = vec;
  return resources(kernel, gram_smem<TA>(), out + 2);
}

template <typename TA>
int launch_gram(const TA* W, float* G, int n, int b, long long ldf, cudaStream_t stream) {
  GramKernel<TA> kernel;
  bool vec;
  const cudaError_t err = gram_instance(W, b, ldf, &kernel, &vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (b + TM - 1) / TM;
  kernel<<<nt * (nt + 1) / 2, THREADS, gram_smem<TA>(), stream>>>(W, G, n, b, ldf, nt);
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

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// the window is columns [col_start, col_start + b), inside F. Writes G
// (b, b) float32, contiguous; b > 0 (the caller handles empty outputs).
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_block_gram_sym(const void* F, float* G, int n, int col_start, int b,
                                 long long ldf, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16
             ? launch_gram(static_cast<const __nv_bfloat16*>(F) + col_start, G, n, b, ldf, s)
             : launch_gram(static_cast<const float*>(F) + col_start, G, n, b, ldf, s);
}

// The grid kt_block_gram_sym launches for this window on the current
// device (the layout of `gram_plan` above: 6 ints). Returns the
// cudaError_t.
extern "C" int kt_block_gram_sym_config(const void* F, int col_start, int b, long long ldf,
                                        int f_bf16, int* out) {
  return static_cast<int>(
      f_bf16 ? gram_plan(static_cast<const __nv_bfloat16*>(F) + col_start, b, ldf, out)
             : gram_plan(static_cast<const float*>(F) + col_start, b, ldf, out));
}
