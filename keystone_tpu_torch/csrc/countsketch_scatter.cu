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
// sector of a 2.15 GB matrix that L2 cannot hold, read from device memory
// and written back (5.4e6 sectors each way: 0.34 GB, 0.1 ms at 3.35 TB/s
// before DRAM's loss on scattered accesses). A flattened index_add_ pays
// the same sector traffic through its L2 atomics.
//
// Design. The TPU kernel builds a one-hot (tm x tc) sketch tile and a
// densified (tc x tn) chunk tile in fast memory and contracts them on the
// matrix unit: m * c * d1 = 3.5e13 multiply-adds a chunk to do 5.4e6
// useful adds, about 1 s at the card's FP32 peak. Here the kernels do only
// the adds.
//
// Index preparation (kt_countsketch_prepare, three small kernels): a
// histogram of the live buckets, one block's exclusive scan of it into
// `starts`, and a placement of each live row into its bucket's segment of
// `order` by an atomic counter. A row whose bucket lies outside [0, m) is
// not placed. The placement is not stable: within a bucket the rows come
// in any order.
//
// The scatter: one warp owns one bucket's output row, so no two warps
// write one entry and no atomics are needed. The warp takes the bucket's
// rows in increasing row order (each step, a warp-wide minimum over the
// bucket's segment of the next row above the last one: any bucket size,
// one load a lane and step for the usual handful of rows), and each row's
// slots in passes of 32: lane l takes slot t0 + l, so the reads of idx and
// val are coalesced and a warp has up to 32 read-modify-writes in flight.
// Lanes with the same column in one pass find each other with
// __match_any_sync; the lowest of them reads the entry once, adds the
// group's terms one rounded add at a time in lane (= slot) order and writes
// once. __syncwarp between passes makes each pass see the last one's
// writes. So every entry receives its contributions in (row, slot) order
// and each add is __fadd_rn(entry, __fmul_rn(sign, val)) without
// contraction: the order and the arithmetic of a sequential flattened
// scatter on the CPU, which is the plain version on a CPU tensor. The
// kernel gives that plain version's bits. A slot whose idx lies outside
// [0, d1) adds nothing. Nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // buckets a block of the scatter
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ long long bucket_of(const void* bucket, int is64, int i) {
  return is64 ? static_cast<const long long*>(bucket)[i]
              : static_cast<long long>(static_cast<const int*>(bucket)[i]);
}

__global__ void histogram_kernel(const void* __restrict__ bucket, int is64, int c, int m,
                                 int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const long long b = bucket_of(bucket, is64, i);
  if (b >= 0 && b < m) atomicAdd(&counts[b], 1);
}

// starts[b] = counts[0] + ... + counts[b - 1] for b <= m: one block walks
// the counts in tiles of 1024, carrying the running sum.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ counts, int* __restrict__ starts, int m) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ int carry;
  const int lane = threadIdx.x % 32;
  const int wid = threadIdx.x / 32;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < m; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < m ? counts[i] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the warps' sums
      int s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = carry + (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
    if (i < m) starts[i] = before;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == SCAN_THREADS - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) starts[m] = carry;
}

// Each live row into its bucket's segment of order; counts end at zero.
__global__ void place_kernel(const void* __restrict__ bucket, int is64, int c, int m,
                             const int* __restrict__ starts, int* __restrict__ counts,
                             int* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const long long b = bucket_of(bucket, is64, i);
  if (b >= 0 && b < m) order[starts[b] + atomicSub(&counts[b], 1) - 1] = i;
}

__global__ void __launch_bounds__(WARPS * 32)
countsketch_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                           const float* __restrict__ sign, const int* __restrict__ order,
                           const int* __restrict__ starts, float* __restrict__ out, int m,
                           int s, int d1, long long ldi, long long ldv, long long ldo) {
  __shared__ float terms[WARPS][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= m) return;  // uniform over the warp
  float* row = out + (long long)b * ldo;
  const int begin = starts[b];
  const int end = starts[b + 1];
  int last = -1;
  for (int step = begin; step < end; ++step) {
    // The bucket's next row: the smallest row id above the last one.
    int next = INT32_MAX;
    for (int p = begin + lane; p < end; p += 32) {
      const int r = order[p];
      if (r > last && r < next) next = r;
    }
    next = __reduce_min_sync(FULL, next);
    last = next;
    const long long i = next;
    const float sg = sign[i];
    for (int t0 = 0; t0 < s; t0 += 32) {
      const int t = t0 + lane;
      int j = -1;
      float term = 0.f;
      if (t < s) {
        j = idx[i * ldi + t];
        if (j >= 0 && j < d1)
          term = __fmul_rn(sg, val[i * ldv + t]);
        else
          j = -1;
      }
      const unsigned group = __match_any_sync(FULL, j);
      terms[warp][lane] = term;
      __syncwarp();
      if (j >= 0 && lane == __ffs(group) - 1) {
        float x = row[j];
        for (unsigned g = group; g != 0; g &= g - 1) x = __fadd_rn(x, terms[warp][__ffs(g) - 1]);
        row[j] = x;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// bucket (c,) int32 (bucket64 = 0) or int64; order (c,), starts (m + 1,)
// and counts (m,) int32 scratch. Fills starts (the position in order of
// each bucket's first row; starts[m] = the number of live rows) and order
// (the live rows grouped by bucket, in any order within a bucket); counts
// is zeroed first and left zero. m > 0. Launches on `stream` and returns
// the last launch's cudaError_t (0 = success).
extern "C" int kt_countsketch_prepare(const void* bucket, int bucket64, int c, int m, int* order,
                                      int* starts, int* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(m), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (c + 255) / 256;
  if (c > 0) histogram_kernel<<<blocks, 256, 0, st>>>(bucket, bucket64, c, m, counts);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(counts, starts, m);
  if (c > 0) place_kernel<<<blocks, 256, 0, st>>>(bucket, bucket64, c, m, starts, counts, order);
  return static_cast<int>(cudaGetLastError());
}

// idx (c, s) int32 and val (c, s) float32 with row strides ldi, ldv; sign
// (c,) float32; order and starts from kt_countsketch_prepare; out (m, d1)
// float32 with row stride ldo, added into in place. m > 0. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int kt_countsketch_scatter(const int* idx, const float* val, const float* sign,
                                      const int* order, const int* starts, float* out, int m,
                                      int s, int d1, long long ldi, long long ldv,
                                      long long ldo, void* stream) {
  const int blocks = (m + WARPS - 1) / WARPS;
  countsketch_scatter_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, val, sign, order, starts, out, m, s, d1, ldi, ldv, ldo);
  return static_cast<int>(cudaGetLastError());
}
