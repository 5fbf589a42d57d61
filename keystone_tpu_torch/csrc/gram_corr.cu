// The four Gramian kernels of the block solvers and the streamed fold:
//   - kt_gram_corr, (A^T A, A^T R) in one launch, the whole (d, d) Gramian
//     returned, computed from its upper-triangle tiles and mirrored. The
//     gram_corr_sym and gram_corr wrappers both launch it. float32 and
//     bf16 A on gram_tile.cuh's Gramian tile (fma_pipe.cuh's pipelined
//     FP32 tile, bf16 widened as it leaves shared memory).
//   - kt_block_gram_sym, the Gramian of a column window F[:, s:s+b], read
//     in place through F's row stride: the same upper-triangle tiles with
//     no correlation, mirrored. float32 F on gram_tile.cuh's tile; bf16 F
//     on the tensor cores (gram_wgmma.cuh's STORE epilogue, its tensor map
//     based at the window: F + s, b columns at F's row stride).
//   - kt_gram_sym_acc, out = G + F^T F on the upper-triangle tiles only,
//     in place when out is G: the same tiles with the accumulating epilogue.
//     float32 F on gram_tile.cuh's tile; bf16 F on the tensor cores
//     (gram_wgmma.cuh's ACC epilogue with no labels: gram_corr_sym_acc.cu's
//     bf16 kernel, so its Gramian has gram_corr_sym_acc's bits).
// Bits. float32: block_gram_sym on a window has the bits of gram_corr_sym
// on a copy of it, and gram_sym_acc those of G + gram_corr_sym's Gramian
// (gram_tile.cuh). bf16: block_gram_sym has the bits of gram_sym_acc on
// G = 0 and the window, mirrored from its upper triangle; bf16
// gram_corr_sym stays on the FMA tile, so its bits are not these.
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
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:gram_sym_acc
// (_gram_sym_acc_kernel), the per-tile Gramian fold of the streamed
// least-squares fit (keystone_tpu/parallel/streaming.py:_tile_update): the
// running Gramian rides through as an operand, so a tile's contribution
// never exists as a (d, d) buffer of its own. The TPU kernel copies G's
// tile into the output at its first row tile and adds each row tile's
// product along its sequential grid axis; here a block sums its tile over
// each chunk of 2,048 rows in registers and adds each chunk's sums into its
// output tile, the first to G's tile (gram_tile.cuh), and the fold mirrors
// once at its end.
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one 4096-wide block,
// n = 65536 rows, k = 147 label columns): the function needs the upper
// triangle, n*d*(d+1) = 1.10e12 FLOP, and the correlation 2*n*d*k = 7.9e10,
// 1.18e12 FLOP of float32 FMA in all (no TF32: "f32 means f32"), which take
// 17.6 ms at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it
// must move (A's 1.07 GB and R read once, 67 MB of Gramian written) take
// 0.35 ms at 3.35 TB/s. So the kernel is bound by float32 operations. The
// window Gramian alone (F 65536 x 16384, a 4096-wide window) needs the
// 1.10e12 FLOP, 16.4 ms, against 0.34 ms of bytes. The streamed fold's
// tile (n = 32768 rows of d = 16384 features) costs n*d*(d+1) = 8.80e12
// FLOP, 131.3 ms, against 1.28 ms for F's 2.15 GB read once and G's 1.07 GB
// read and written once: bound by operations too. bf16 F moves half F's
// bytes and runs at the 989 TFLOP/s bf16 tensor-core peak: the window
// Gramian's bound is 1.112 ms (1.10e12 FLOP) against 0.18 ms of bytes (the
// window's 0.54 GB read, the 67 MB Gramian written), the streamed tile's
// 8.894 ms against 0.96 ms; both still bound by operations.
//
// Grids. At the TIMIT shapes gram_corr launches 64 correlation blocks of
// 64 columns (0.625 of a Gramian block's work each) and then the 528 upper
// tiles: 592 blocks, 2.24 waves of the 264 resident (2 blocks an SM on 132
// SMs). The 528 Gramian tiles alone are exactly 2 waves, so the
// correlation's work always spills into a third round; the correlation
// blocks come first, and the narrower they are, the sooner the Gramian
// tiles they delay start. 64 blocks of 64 columns measured fastest
// (scripts/torch_fma_variants.py: 32 of 128 columns and 128 of 32 were
// slower). The window Gramian launches the Gramian tiles alone: 528
// blocks, 2.00 waves; the window's start enters as a pointer offset and its
// right edge as the column mask. The streamed fold's tile launches 8,256
// tiles, 31.3 waves. BK 32 and 3 stages are the fastest of 8, 16 and 32
// rows and 2, 3 and 4 stages (scripts/torch_fma_variants.py). On the
// tensor cores a block holds one SM: the window Gramian's 528 tiles are 4
// waves of 132, the streamed tile's 8,256 62.5.

#include "gram_tile.cuh"
#include "gram_wgmma.cuh"

namespace {

using kt_gram::Out;

template <typename TA>
int launch(const void* A, const float* R, float* G, float* C, int n, int d, int k,
           long long lda, long long ldr, cudaStream_t stream) {
  return kt_gram::launch<TA, false>(static_cast<const TA*>(A), R, Out{nullptr, 0, G, d},
                                    Out{nullptr, 0, C, k}, n, d, k, lda, ldr, stream);
}

// The Gramian-alone grid of float32 F (base W, row stride ldf, b columns,
// gram_tile.cuh's `gram_plan` in out[0..5]) or of bf16 F (the tensor-core
// kernel: out[0] blocks, out[1] 0, out[2..5] its resources); out[6] whether
// it is the tensor-core kernel.
template <bool ACC>
int gram_config(const void* W, int b, long long ldf, int f_bf16, int* out) {
  out[6] = f_bf16;
  if (!f_bf16) return static_cast<int>(
      kt_gram::gram_plan<ACC>(static_cast<const float*>(W), b, ldf, out));
  const cudaError_t err = kt_wgmma::instance<!ACC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kt_wgmma::blocks(b);
  out[1] = 0;
  return static_cast<int>(kt_gram::resources(kt_wgmma::gram_kernel<!ACC>, kt_wgmma::SMEM_BYTES,
                                             out + 2, kt_wgmma::TC_THREADS));
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
// (the layout of gram_tile.cuh's `plan`: 9 ints). Returns the cudaError_t.
extern "C" int kt_gram_corr_config(const void* A, int d, int k, long long lda, int a_bf16,
                                   int* out) {
  return static_cast<int>(
      a_bf16 ? kt_gram::plan<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(A), d, k,
                                                   lda, out)
             : kt_gram::plan<float, false>(static_cast<const float*>(A), d, k, lda, out));
}

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16
// (then the window's base 16-byte aligned and ldf a multiple of 8); the
// window is columns [col_start, col_start + b), inside F. Writes G (b, b)
// float32, contiguous; b > 0 (the caller handles empty outputs). Launches
// on `stream` and returns the launch's cudaError_t (0 = success), or -1
// when the window's tensor map cannot be made.
extern "C" int kt_block_gram_sym(const void* F, float* G, int n, int col_start, int b,
                                 long long ldf, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_bf16)
    return kt_wgmma::launch<true>(static_cast<const __nv_bfloat16*>(F) + col_start, ldf, n, b,
                                  nullptr, 0, 0, nullptr, 0, nullptr, 0, G, b, nullptr, 0, s);
  return kt_gram::launch_gram<false>(static_cast<const float*>(F) + col_start,
                                     Out{nullptr, 0, G, b}, n, b, ldf, s);
}

// The grid kt_block_gram_sym launches for this window on the current
// device (gram_config's 7 ints). Returns the cudaError_t.
extern "C" int kt_block_gram_sym_config(const void* F, int col_start, int b, long long ldf,
                                        int f_bf16, int* out) {
  const int elem = f_bf16 ? 2 : 4;
  return gram_config<false>(static_cast<const char*>(F) + (long long)col_start * elem, b, ldf,
                            f_bf16, out);
}

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16
// (then 16-byte aligned, with ldf a multiple of 8). G and out (d, d)
// float32, row strides ldg and ldo; out may be G. Writes out = G + F^T F on
// the upper-triangle 128 x 128 tiles; the strictly-lower tiles of out are
// not written. d > 0 (the caller handles empty outputs). Launches on
// `stream` and returns the launch's cudaError_t (0 = success), or -1 when
// F's tensor map cannot be made.
extern "C" int kt_gram_sym_acc(const void* F, const float* G, float* out, int n, int d,
                               long long ldf, long long ldg, long long ldo, int f_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_bf16)
    return kt_wgmma::launch<false>(F, ldf, n, d, nullptr, 0, 0, G, ldg, nullptr, 0, out, ldo,
                                   nullptr, 0, s);
  return kt_gram::launch_gram<true>(static_cast<const float*>(F), Out{G, ldg, out, ldo}, n, d,
                                    ldf, s);
}

// The grid kt_gram_sym_acc launches for F (d columns, row stride ldf) on
// the current device (gram_config's 7 ints). Returns the cudaError_t.
extern "C" int kt_gram_sym_acc_config(const void* F, int d, long long ldf, int f_bf16,
                                      int* out) {
  return gram_config<true>(F, d, ldf, f_bf16, out);
}
