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
// card's 67 TFLOP/s non-tensor float32 peak that is 3.5 ms. The bytes it
// must move (X and W read once, the 1.07 GB output written once) take
// 0.36 ms at 3.35 TB/s. So the kernel is bound by float32 operations, and
// the design spends its effort on the FMA inner loop: each thread keeps an
// 8x8 block of outputs in registers and reads its operands from shared
// memory as float4, 16 FMAs per shared-memory load. bf16 operands are
// widened to float32 on their way into shared memory and accumulate in
// float32 like f32 operands; their bound is the bf16 tensor-core rate,
// which this simple kernel does not reach (wgmma/TMA are later work).
//
// Tiles: 128 x 128 outputs per block of 256 threads, K in steps of 8.
// Ragged edges of m, n and d are masked in the kernel (loads outside the
// matrices read as zero, stores outside are skipped); the operands are
// never padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int PAD = 4;  // keeps the transposed shared-memory stores conflict-free
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// blockIdx.x walks row tiles of X (m may be large), blockIdx.y column tiles
// of W. Thread (tx, ty) of the 16 x 16 grid owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
cosine_features_kernel(const TIn* __restrict__ X, const TIn* __restrict__ W,
                       const float* __restrict__ b, TOut* __restrict__ out,
                       int m, int n, int d, long long ldx, long long ldw,
                       long long ldo) {
  __shared__ __align__(16) float Xs[BK][BM + PAD];
  __shared__ __align__(16) float Ws[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // 128 x 8 elements of each operand, 4 per thread; element e is
    // (row e / 8, k e % 8), so a warp reads 4 rows x 32 contiguous bytes.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const long long gr = row0 + r;
      const long long gc = col0 + r;
      Xs[kk][r] = (gr < m && gk < d) ? to_float(X[gr * ldx + gk]) : 0.f;
      Ws[kk][r] = (gc < n && gk < d) ? to_float(W[gc * ldw + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < n) store(&out[r * ldo + c], fast_cos(acc[i][j] + b[c]));
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* X, const void* W, const float* b, void* out, int m, int n,
           int d, long long ldx, long long ldw, long long ldo, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cosine_features_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(X), static_cast<const TIn*>(W), b,
      static_cast<TOut*>(out), m, n, d, ldx, ldw, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (m, d) and W (n, d) row-major with row strides ldx, ldw, both float32
// (in_bf16 = 0) or both bfloat16 (in_bf16 = 1); b (n,) float32; out (m, n)
// row-major with row stride ldo, float32 (out_bf16 = 0) or bfloat16;
// m, n > 0 (the caller handles empty outputs). Launches on `stream` and
// returns the launch's cudaError_t (0 = success).
extern "C" int kt_cosine_features(const void* X, const void* W, const float* b,
                                  void* out, int m, int n, int d, long long ldx,
                                  long long ldw, long long ldo, int in_bf16,
                                  int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(X, W, b, out, m, n, d, ldx, ldw, ldo, s)
                    : launch<__nv_bfloat16, float>(X, W, b, out, m, n, d, ldx, ldw, ldo, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(X, W, b, out, m, n, d, ldx, ldw, ldo, s)
                  : launch<float, float>(X, W, b, out, m, n, d, ldx, ldw, ldo, s);
}
