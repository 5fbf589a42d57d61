// Gauss-Seidel residual update through a column window of a flat feature
// matrix: out = R - F[:, s:s+b] dW, the window read in place through F's
// row stride (no copy of the window).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:block_residual_update
// (_block_resid_kernel), the residual update after every block solve of the
// flat block coordinate descent solver
// (keystone_tpu/parallel/linalg.py:_bcd_fused_flat_kernel, strided_update).
//
// Bound on an H100 SXM at the TIMIT slice's shapes (F 65536 x 16384, one
// 4096-wide window, dW 4096 x 147, R 65536 x 147): 2*n*b*k = 7.89e10 FLOP
// of float32 FMA (no TF32: "f32 means f32"), 1.18 ms at the card's
// 67 TFLOP/s non-tensor float32 peak. The bytes it must move (the window's
// 1.07 GB, dW and R read once, the new residual written) take 0.34 ms at
// 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design (fma_pipe.cuh's pipelined tile). The TPU kernel keeps an R tile
// resident while its sequential grid axis walks the window's column tiles;
// here a block owns 128 rows of the output x one label tile that holds all
// of R's columns up to 160 (10 a thread; block_corr.cu's label tiles,
// with_label_tile), and loops over the whole b-wide window itself, so each
// window tile is staged once and k = 147 masks 8% of its FMAs (two
// 128-wide tiles masked 42.6%); k <= 32 takes a 32-wide tile, k > 160
// further 160-wide tiles. The window is the K-major operand (its rows are
// output rows, the reduction runs along its contiguous columns) and goes
// through registers (fma_pipe.cuh's KStager): a thread loads its 16-byte
// chunks of the next 128 rows x 16 columns, a stage ahead, and stores them
// transposed into a row-major stage (element by element where F's base,
// row stride or the window's start or width is not 16-byte aligned; at the
// TIMIT shapes it is: column 8192, stride 16384). That measured faster
// than copying K-major stages as stored by cp.async, and leaves the
// 16-byte instances without spills (the element-wise one for a float32
// window and a 160-wide label tile spills 48 bytes). dW is the row-major
// operand, copied element by element by cp.async (its 588-byte rows at k =
// 147 are not 16-byte aligned). Both go through a 2-stage ring of
// 16-column stages (scripts/torch_fma_variants.py: 3 stages ran 2% faster
// but spilled 8 bytes, 4 no faster; 8 and 32 columns slower). The b-wide
// sum is not split: at the TIMIT shapes 512 row tiles x 1 label tile = 512
// blocks are 1.94 waves of the 264 resident (2 blocks an SM on 132 SMs),
// so each output is one fmaf chain over the window's columns in order,
// summed whole in registers and subtracted from R once, as the plain
// version computes R - (F_w @ dW): the same bits every run, and no partial
// buffer. dW arrives in F's dtype (the solver rounds it as the reference
// does); bf16 F and dW are widened to float32 as they are read from shared
// memory.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 16;     // window columns (dW rows) a stage
constexpr int STAGES = 2;  // stages in the cp.async ring
constexpr int MINB = 2;    // blocks an SM the registers are capped for (128 a thread)

// blockIdx.x = tm * nkt + tj: output rows [128 tm, 128 tm + 128) x label
// tile tj (KT = 16 * NJ columns).
template <typename TF, int NJ, bool VF>
__global__ void __launch_bounds__(THREADS, MINB)
resid_kernel(const TF* __restrict__ Fw, const TF* __restrict__ dW, const float* __restrict__ R,
             float* __restrict__ out, int n, int b, int k, long long ldf, long long ldw,
             long long ldr, long long ldo, int nkt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = (long long)(blockIdx.x / nkt) * TM;
  const long long j0 = (long long)(blockIdx.x % nkt) * 16 * NJ;
  float acc[8][NJ];
  // The window K-major, dW row-major.
  mainloop<BK, STAGES, 8, NJ, VF, false, true>(smem, Fw, ldf, i0, n, dW, ldw, j0, k, 0, b, false,
                                               acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + out_row<8>(i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < k) out[r * ldo + c] = R[r * ldr + c] - acc[i][j];
    }
  }
}

template <typename TF, int NJ>
constexpr int smem_of() {
  return smem_bytes<TF, TF, BK, STAGES, 8, NJ>();
}

template <typename TF, int NJ, bool VF>
cudaError_t launch_tile(const TF* Fw, const TF* dW, const float* R, float* out, int n, int b,
                        int k, long long ldf, long long ldw, long long ldr, long long ldo,
                        cudaStream_t stream) {
  auto kernel = resid_kernel<TF, NJ, VF>;
  constexpr int smem = smem_of<TF, NJ>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nkt = (k + 16 * NJ - 1) / (16 * NJ);
  const long long blocks = ((long long)n + TM - 1) / TM * nkt;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(Fw, dW, R, out, n, b, k, ldf,
                                                                   ldw, ldr, ldo, nkt);
  return cudaGetLastError();
}

template <typename TF>
int launch(const void* F, const void* dW, const float* R, float* out, int n, int col_start,
           int b, int k, long long ldf, long long ldw, long long ldr, long long ldo,
           cudaStream_t stream) {
  const TF* Fw = static_cast<const TF*>(F) + col_start;
  const TF* W = static_cast<const TF*>(dW);
  const bool vec = vec_ok(Fw, ldf, b);
  return static_cast<int>(with_label_tile(k, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return vec ? launch_tile<TF, NJ, true>(Fw, W, R, out, n, b, k, ldf, ldw, ldr, ldo, stream)
               : launch_tile<TF, NJ, false>(Fw, W, R, out, n, b, k, ldf, ldw, ldr, ldo, stream);
  }));
}

// The aligned instance's label-tile width, resident blocks an SM,
// registers and local (spilled) bytes a thread, into out[0..3].
template <typename TF>
int config(int k, int* out) {
  return static_cast<int>(with_label_tile(k, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    auto kernel = resid_kernel<TF, NJ, true>;
    constexpr int smem = smem_of<TF, NJ>();
    out[0] = 16 * NJ;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    return err;
  }));
}

}  // namespace

// F (n, d) row-major with row stride ldf, float32 (f_bf16 = 0) or bfloat16;
// the window is columns [col_start, col_start + b), inside F. dW (b, k) in
// F's dtype with row stride ldw; R (n, k) float32 with row stride ldr.
// Writes out (n, k) float32 with row stride ldo; n > 0 and k > 0 (the
// caller handles empty outputs). Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int kt_block_residual_update(const void* F, const void* dW, const float* R,
                                        float* out, int n, int col_start, int b, int k,
                                        long long ldf, long long ldw, long long ldr,
                                        long long ldo, int f_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_bf16 ? launch<__nv_bfloat16>(F, dW, R, out, n, col_start, b, k, ldf, ldw, ldr,
                                        ldo, s)
                : launch<float>(F, dW, R, out, n, col_start, b, k, ldf, ldw, ldr, ldo, s);
}

// The kernel that kt_block_residual_update launches for k label columns
// (its aligned form) on the current device: out[0] its label-tile width,
// out[1] its resident blocks an SM, out[2] its registers a thread, out[3]
// its local (spilled) bytes a thread. Returns the cudaError_t.
extern "C" int kt_block_residual_update_config(int k, int f_bf16, int* out) {
  return f_bf16 ? config<__nv_bfloat16>(k, out) : config<float>(k, out);
}
