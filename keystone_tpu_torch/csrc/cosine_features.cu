// Fused cosine random features: out = cos(X W^T + b).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:cosine_features
// (_cosine_kernel + _fast_cos): a K-innermost tiled GEMM whose epilogue
// adds the phase b and evaluates the range-reduced even minimax cosine, so
// the (m, n) pre-activation never reaches device memory.
//
// Bound on an H100 SXM at the TIMIT slice's shapes (one branch: X 65536 x
// 440, W 4096 x 440): 2*m*n*d = 2.36e11 FLOP, all of it float32 FMA because
// f32 operands must not be rounded to TF32 ("f32 means f32"); at the
// card's 67 TFLOP/s non-tensor float32 peak that is 3.59 ms. The bytes it
// must move (X and W read once, the 1.07 GB output written once) take
// 0.36 ms at 3.35 TB/s. So the kernel is bound by float32 operations.
//
// Design (fma_pipe.cuh's pipelined tile, as gaussian_kernel_block.cu). X W^T
// contracts over the input axis of two row-major operands (an "NT" product), so
// both are K-major operands of the tile: a thread loads its 16-byte chunks of
// the next 128 rows x 16 inputs a stage ahead into registers and stores them
// transposed into a row-major stage of a 3-stage ring (fma_pipe.cuh's KStager;
// element by element where a base, a row stride or d is not 16-byte aligned),
// one barrier a stage. d = 440 is 27.5 such stages; 16 inputs a stage ran 3%
// faster than 8, and 3 stages as fast as 2 or 4
// (scripts/torch_fma_variants.py). A block owns a 128 x 128 output tile, 8 x 8
// a thread, at 2 blocks an SM (1 ran 17% slower); the 16,384 tiles of a TIMIT
// branch are 62 waves of the 264 resident blocks (132 SMs), so the input axis
// is never split. bf16 operands stay bf16 in shared memory and are widened to
// float32 as they are read; every output is one fmaf chain over the inputs in
// order, as in the first form of this kernel, so every output kind keeps that
// form's bits. The epilogue's cosine is fast_cos below, bit for bit the
// reference's arithmetic. Outputs are stored element by element: a 16-byte
// float4 store of each 4-column group timed within 1% of it (5.610 against
// 5.631 ms in one call, PERF.md), as the 1.07 GB output takes 0.32 ms of a
// 5.6 ms call, so the kernel keeps the one store path. Ragged
// edges of m, n and d are masked in the kernel (loads outside the matrices read
// as zero, stores outside are skipped); the operands are never padded in
// memory.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int BK = 16;     // inputs a stage
constexpr int STAGES = 3;  // stages in the ring
constexpr int MINB = 2;    // blocks an SM the registers are capped for (128 a thread)
constexpr int TN = TM;     // output columns a block, 8 a thread

template <typename TIn>
constexpr int smem_of() {
  return smem_bytes<TIn, TIn, BK, STAGES, 8, 8>();
}

// Same arithmetic as keystone_tpu/ops/pallas_ops.py:_fast_cos: reduce to
// [-pi, pi] with one f32 constant, then the degree-12 even polynomial
// (max abs error 3.8e-7 for |x| up to about 10) in Horner form.
__device__ __forceinline__ float fast_cos(float x) {
  const float kInvTwoPi = 0.15915494309189535f;
  const float kTwoPi = 6.283185307179586f;
  const float q = floorf(x * kInvTwoPi + 0.5f);
  const float r = x - q * kTwoPi;
  const float r2 = r * r;
  float acc = 1.724826627109e-09f;
  acc = acc * r2 + -2.707995836252e-07f;
  acc = acc * r2 + 2.476998508524e-05f;
  acc = acc * r2 + -1.388780871411e-03f;
  acc = acc * r2 + 4.166649038026e-02f;
  acc = acc * r2 + -4.999998919802e-01f;
  acc = acc * r2 + 9.999999892578e-01f;
  return acc;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Block (blockIdx.x, blockIdx.y): output rows [128 x, +128) x columns
// [128 y, +128).
template <typename TIn, typename TOut, bool VEC>
__global__ void __launch_bounds__(THREADS, MINB)
cos_kernel(const TIn* __restrict__ X, const TIn* __restrict__ W, const float* __restrict__ b,
           TOut* __restrict__ out, int m, int n, int d, long long ldx, long long ldw,
           long long ldo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = (long long)blockIdx.x * TM;
  const long long j0 = (long long)blockIdx.y * TN;
  float acc[8][8];
  // Both operands K-major.
  mainloop<BK, STAGES, 8, 8, VEC, VEC, true, true>(smem, X, ldx, i0, m, W, ldw, j0, n, 0, d,
                                                    false, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = i0 + out_row<8>(i);
    if (r >= m) continue;
    TOut* row = out + r * ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = j0 + out_col<8>(j);
      if (c < n) store(row + c, fast_cos(acc[i][j] + b[c]));
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* Xv, const void* Wv, const float* b, void* out, int m, int n, int d,
           long long ldx, long long ldw, long long ldo, cudaStream_t stream) {
  const TIn* X = static_cast<const TIn*>(Xv);
  const TIn* W = static_cast<const TIn*>(Wv);
  auto kernel = vec_ok(X, ldx, d) && vec_ok(W, ldw, d) ? cos_kernel<TIn, TOut, true>
                                                       : cos_kernel<TIn, TOut, false>;
  constexpr int smem = smem_of<TIn>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
  kernel<<<grid, THREADS, smem, stream>>>(X, W, b, static_cast<TOut*>(out), m, n, d, ldx, ldw,
                                          ldo);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte (vec) or element-wise instance's resident blocks an SM,
// registers and local (spilled) bytes a thread, into out[0..2].
template <typename TIn, typename TOut>
int config(bool vec, int* out) {
  auto kernel = vec ? cos_kernel<TIn, TOut, true> : cos_kernel<TIn, TOut, false>;
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

// X (m, d) and W (n, d) row-major with row strides ldx, ldw, both float32
// (in_bf16 = 0) or both bfloat16 (in_bf16 = 1); b (n,) float32; out (m, n)
// row-major with row stride ldo, float32 (out_bf16 = 0) or bfloat16;
// m, n > 0 (the caller handles empty outputs).
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_cosine_features(const void* X, const void* W, const float* b, void* out,
                                  int m, int n, int d, long long ldx, long long ldw,
                                  long long ldo, int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(X, W, b, out, m, n, d, ldx, ldw, ldo, s)
               : launch<__nv_bfloat16, float>(X, W, b, out, m, n, d, ldx, ldw, ldo, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(X, W, b, out, m, n, d, ldx, ldw, ldo, s)
                  : launch<float, float>(X, W, b, out, m, n, d, ldx, ldw, ldo, s);
}

// The kernel that kt_cosine_features launches for these operand and output
// types, its 16-byte (vec = 1) or element-wise form, on the current device:
// out[0] its resident blocks an SM, out[1] its registers a thread, out[2]
// its local (spilled) bytes a thread. Returns the cudaError_t.
extern "C" int kt_cosine_features_config(int in_bf16, int out_bf16, int vec, int* out) {
  const bool v = vec != 0;
  if (in_bf16)
    return out_bf16 ? config<__nv_bfloat16, __nv_bfloat16>(v, out)
                    : config<__nv_bfloat16, float>(v, out);
  return out_bf16 ? config<float, __nv_bfloat16>(v, out) : config<float, float>(v, out);
}
