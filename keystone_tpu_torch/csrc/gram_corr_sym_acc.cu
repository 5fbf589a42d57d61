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
// 4.3e9. With bf16 F the least time the card could take is 17.8 ms at the
// 989 TFLOP/s bf16 tensor-core peak; with float32 F, 263 ms at the 67
// TFLOP/s float32 peak outside the tensor cores (float32 means float32: no
// TF32). The bytes the function must move (bf16 F's 2.15 GB read once, G's
// 1.07 GB read and written once) take 1.3 ms at 3.35 TB/s. So both forms
// are bound by operations, and bf16 F only reaches its bound on the tensor
// cores.
//
// bf16 F: the TMA + wgmma Gramian of gram_wgmma.cuh with its accumulating
// epilogue, the correlation riding on its diagonal tiles (the header says
// how). It is gram_sym_acc's kernel too (gram_corr.cu, k = 0), so for bf16
// F the Gramian has gram_sym_acc's bits. The tensor map needs a
// 16-byte-aligned base and a row stride that is a multiple of 16 bytes: the
// wrapper checks that (the sparse fold pads its bf16 slab's rows to 64
// elements) and never copies F.
//
// float32 F: gram_tile.cuh's Gramian kernel (fma_pipe.cuh's pipelined FP32
// tile, the kernel of gram_corr.cu) with its accumulating epilogue: the
// correlation's blocks first (64 columns of F x a label tile sized to k:
// 32 wide at the Amazon fit's k = 2, 257 blocks, each about an eighth of a
// Gramian block's work), then one block an upper Gramian tile (8,385 at
// d1 = 16385, 31.8 waves of 264), each entry G's (C's) entry plus fmaf
// chains over row chunks of 2,048 (C's of 256), the chunks' sums added in
// order (gram_tile.cuh). It copies F in 16-byte
// chunks when F's base and row stride are 16-byte aligned (the sparse fold
// pads its float32 slab's rows to 4 elements for that; the chunk at the
// ragged right edge is copied in part), else element by element. R is not
// rounded: a float32 F's partner stays float32.

#include "gram_tile.cuh"
#include "gram_wgmma.cuh"

namespace {

int launch_f32(const void* F, const float* R, const float* G, const float* C, float* gout,
               float* cout, int n, int d, int k, long long ldf, long long ldr, long long ldg,
               long long ldc, long long ldgo, long long ldco, cudaStream_t stream) {
  return kt_gram::launch<float, true>(static_cast<const float*>(F), R,
                                      kt_gram::Out{G, ldg, gout, ldgo},
                                      kt_gram::Out{C, ldc, cout, ldco}, n, d, k, ldf, ldr, stream);
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16
// (then 16-byte aligned, with ldf a multiple of 8); R (n, k) float32, row
// stride ldr. G and gout (d, d) float32, row strides ldg and ldgo, gout may
// be G; C and cout (d, k) float32, row strides ldc and ldco, cout may be C.
// d > 0 (the caller handles empty outputs). Launches on `stream` and
// returns the launch's cudaError_t (0 = success), or -1 when F's tensor map
// cannot be made.
extern "C" int kt_gram_corr_sym_acc(const void* F, const float* R, const float* G,
                                    const float* C, float* gout, float* cout, int n, int d,
                                    int k, long long ldf, long long ldr, long long ldg,
                                    long long ldc, long long ldgo, long long ldco, int f_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? kt_wgmma::launch<false>(F, ldf, n, d, R, k, ldr, G, ldg, C, ldc, gout, ldgo,
                                          cout, ldco, s)
                : launch_f32(F, R, G, C, gout, cout, n, d, k, ldf, ldr, ldg, ldc, ldgo, ldco, s);
}

// The grid kt_gram_corr_sym_acc launches for float32 F (d columns, row
// stride ldf) and k label columns on the current device (the layout of
// gram_tile.cuh's `plan`: 9 ints). Returns the cudaError_t.
extern "C" int kt_gram_corr_sym_acc_config(const void* F, int d, int k, long long ldf,
                                           int* out) {
  return static_cast<int>(
      kt_gram::plan<float, true>(static_cast<const float*>(F), d, k, ldf, out));
}
