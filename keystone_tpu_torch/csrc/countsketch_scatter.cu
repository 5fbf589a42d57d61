// One row chunk's CountSketch, S A, added into an (m, d1) accumulator:
//   out[b, j] += sum over rows i with bucket_i = b of
//                sign_i * sum over slots t with idx[i, t] = j of val[i, t].
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_ops.py:countsketch_scatter
// (_countsketch_kernel), the chunk step of the Iterative Hessian Sketch's
// streamed fold (keystone_tpu/ops/learning/sketch.py, IterativeHessianSketch
// _fit_sparse).
//
// Bound on an H100 SXM at the Amazon chunk of the sketched tier (c = 65,536
// rows of s = 83 slots, the 82 features and the intercept lane; m = 32,770
// buckets; d1 = 16,385 columns): the work is c * s = 5.4e6 adds, nothing
// for the arithmetic units. The bytes it must move are the operands read
// once (idx and val 4 bytes a slot, bucket and sign 4 bytes a row: 44 MB)
// and each output entry a lane touches read and written once (about 5.4e6
// distinct entries, 43 MB), 87 MB in all: 0.026 ms at 3.35 TB/s. Into a
// fresh buffer the m * d1 * 4 = 2.15 GB of zeros it starts from are
// written too: 0.67 ms. So the kernel is bound by bytes, and its accesses
// to the accumulator are random: each touched entry is its own 32-byte
// sector.
//
// Design. The TPU kernel builds a one-hot (tm x tc) sketch tile and a
// densified (tc x tn) chunk tile in fast memory and contracts them on the
// matrix unit: m * c * d1 = 3.5e13 multiply-adds a chunk to do 5.4e6
// useful adds, about 1 s at the card's FP32 peak. Here the kernel does only
// the adds. The wrapper orders the chunk's rows by bucket, stably (an
// argsort and a search for each bucket's first row: index preparation, not
// the product), and each thread owns one bucket: it walks that bucket's
// rows in increasing row order and each row's slots in slot order, adding
// sign * val into its own output row. No two threads write one entry, so
// no atomics are needed, and every entry gets its contributions in (row,
// slot) order: the order of a sequential flattened scatter on the CPU,
// which is the plain version on a CPU tensor. The adds are made without
// contraction (__fadd_rn of __fmul_rn), as the CPU makes them, so the
// kernel gives the bits of that plain version. A slot whose idx lies
// outside [0, d1) adds nothing; rows whose bucket lies outside [0, m) sort
// past starts[m], where no thread reads them. Nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
countsketch_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                           const float* __restrict__ sign, const int* __restrict__ order,
                           const int* __restrict__ starts, float* __restrict__ out, int m,
                           int s, int d1, long long ldi, long long ldv, long long ldo) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= m) return;
  float* row = out + (long long)b * ldo;
  const int end = starts[b + 1];
  for (int p = starts[b]; p < end; ++p) {
    const long long i = order[p];
    const float sg = sign[i];
    const int* ri = idx + i * ldi;
    const float* rv = val + i * ldv;
    for (int t = 0; t < s; ++t) {
      const int j = ri[t];
      if (j >= 0 && j < d1) row[j] = __fadd_rn(row[j], __fmul_rn(sg, rv[t]));
    }
  }
}

}  // namespace

// idx (c, s) int32 and val (c, s) float32 with row strides ldi, ldv; sign
// (c,) float32; order (c,) int32, the rows ordered by bucket and then by
// row, those whose bucket lies outside [0, m) last; starts (m + 1,) int32,
// the position in `order` of each bucket's first row (starts[m] = the
// number of live rows); out (m, d1) float32 with row stride ldo, added into
// in place. m > 0. Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int kt_countsketch_scatter(const int* idx, const float* val, const float* sign,
                                      const int* order, const int* starts, float* out, int m,
                                      int s, int d1, long long ldi, long long ldv,
                                      long long ldo, void* stream) {
  const int blocks = (m + THREADS - 1) / THREADS;
  countsketch_scatter_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, val, sign, order, starts, out, m, s, d1, ldi, ldv, ldo);
  return static_cast<int>(cudaGetLastError());
}
