// Fused convolutional featurizer: im2col, per-patch normalisation,
// whitening-mean subtraction and the filter product, with the patch matrix
// kept out of device memory.
//
//   out[i, x, y, f] = sum_e P~[i, x, y, e] * F[f, e],
//   P~ = (P - mean(P)) / sqrt(var(P) + var_constant) - mu   (normalize on)
//   P~ = P - mu                                              (normalize off)
//
// where P[i, x, y, :] is the p x p x C patch of image i at (x, y),
// flattened row-major over (px, py, c), mean and var are taken over that
// patch row (var with the (d - 1) denominator), and mu are the whitening
// means (zero when absent).
//
// Replaces the TPU kernel keystone_tpu/ops/pallas_images.py:conv_featurize
// (_conv_featurize_kernel), the featurizer of the CIFAR random-patch
// pipelines (keystone_tpu/ops/images/conv.py:Convolver._convolve).
//
// Bound on an H100 SXM at one row chunk of the CIFAR route (2,382 images of
// 32 x 32 x 3, 100 filters of 6 x 6 x 3, so 27 x 27 output pixels, d = 108
// and P = 1,736,478 patch rows): 2 P d k + 5 P d = 3.84e10 FLOP of float32
// (the product, then the patch statistics and scaling), 0.574 ms at the
// card's 67 TFLOP/s non-tensor float32 peak. The bytes it must move (29 MB
// of images in, 695 MB of features out) take 0.216 ms at 3.35 TB/s. So the
// kernel is bound by float32 operations; the output write is the next
// limit.
//
// Design. The output is a row-major (P, k) matrix, P = n x' y' patch rows;
// a block of 256 threads owns tiles of 128 consecutive rows, which may
// start in one image and end in the next. The grid is persistent (as many
// blocks as are resident, each walking tiles blockIdx.x, + gridDim.x, ...;
// 13,567 tiles over 264 blocks at the chunk above, so the last round is
// 99% full), and each block stages the filters once: transposed, in
// filter tiles of 16 NJ columns sized from k (32 for k <= 32, 112 for
// k <= 112, so k = 100 masks 10.7% of the FMAs; 128-wide tiles above: a
// 128-wide tile at k = 100 ran 11% slower), zero past k. For each pixel
// tile the block
//   1. gathers the patch rows into a row-major [d][128] stage in shared
//      memory by 4-byte cp.async: each thread owns one pixel, whose base
//      offset i X Y C + (x Y + y) C it works out once a tile, and reads
//      images[base + off[e]] for its share of e, off[e] = (px Y + py) C + c
//      from a d-long table built once a block: no division per element
//      (plain loads through registers ran 14% slower);
//   2. takes each pixel's mean and deviation, one thread a pixel, the sums
//      in e order (the first form's arithmetic, so its bits);
//   3. normalises and centres the stage in place, dividing as the first
//      form does (a reciprocal scale ran 5% faster but moves the bits);
//   4. multiplies it by each filter tile with fma_pipe.cuh's FP32 tile
//      (fma_stage, 8 pixels x NJ filters a thread, every output one fmaf
//      chain over e from 0, as the first form), the whole d from shared
//      memory, no ring, 36 patch elements an unrolled step;
//   5. stores the tile: a thread's 4-column groups as 16-byte stores where
//      k is a multiple of 4 (a warp writes 256 contiguous bytes of each of
//      two rows; element stores ran 4.5% slower), element by element
//      otherwise.
// At CIFAR a block holds 55.3 KB of patches, 48.4 KB of filters and 1.9 KB
// of statistics, means and offsets (105.6 KB), so two blocks are resident
// an SM at <= 128 registers a thread: while one gathers and normalises,
// the other multiplies. A second patch stage, the next tile's gather in
// flight during the product, fits only one block an SM and ran 26%
// slower. The product and stores alone take 72% of the kernel's time, the
// gather 17%, the statistics and division 11% (scripts/torch_fma_variants.py
// on an H100 SXM, PERF.md). The wrapper's guard (cuda_images.conv_featurize_ok)
// refuses shapes whose working set exceeds the 227 KB a block may use.

#include "fma_pipe.cuh"

namespace {

using namespace kt_pipe;

constexpr int MINB = 2;       // blocks an SM the registers are capped for (128 a thread)
constexpr int BUFS = 1;       // patch stages: 2 gathers the next tile during the product
// Patch elements an unrolled step of the product: 36 for the 32- and
// 112-wide filter tiles (4, 12, 18, 54 and 108 ran 2-16% slower at the
// CIFAR chunk); the 128-wide tile's 8 x 8 outputs spill 24 bytes at 36,
// none at 12.
constexpr int KSTEP = 36;
constexpr int KSTEP_WIDE = 12;
constexpr int FT_NARROW = 32;  // k <= FT_NARROW: one 32-wide filter tile
constexpr int FT_MID = 112;    // k <= FT_MID: one FT_MID-wide tile; above, 128-wide tiles
constexpr int FT_WIDE = 128;
constexpr bool VEC_STORES = true;  // 16-byte stores where k is a multiple of 4

// fn(std::integral_constant<int, NJ>) for the filter tile of k columns.
template <typename Fn>
inline auto with_filter_tile(int k, Fn&& fn) {
  if (k <= FT_NARROW) return fn(std::integral_constant<int, FT_NARROW / 16>{});
  if (k <= FT_MID) return fn(std::integral_constant<int, FT_MID / 16>{});
  return fn(std::integral_constant<int, FT_WIDE / 16>{});
}

// Shared memory of one block, in bytes (cuda_images._smem_bytes computes
// the same sum): BUFS patch stages, the filter tiles, the means, the
// tile's per-pixel mean and deviation, the offset table.
__host__ __device__ constexpr long long smem_of(int d, int k, int kt) {
  return 4LL * (BUFS * d * TM + (long long)(k + kt - 1) / kt * kt * d + 2 * d + 2 * TM);
}

// Stores a thread's 4 (2) consecutive outputs at p.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int NJ, bool VST>
__global__ void __launch_bounds__(THREADS, MINB)
conv_featurize_kernel(const float* __restrict__ images, const float* __restrict__ filters,
                      const float* __restrict__ means, float* __restrict__ out, int n, int X,
                      int Y, int C, int p, int k, int normalize, float var_constant) {
  constexpr int KT = 16 * NJ;
  constexpr int Q4 = NJ / 4;
  constexpr int REM = NJ % 4;
  constexpr int EPT = THREADS / TM;  // threads a pixel in the gather and the normalisation
  constexpr int STEP = KT == FT_WIDE ? KSTEP_WIDE : KSTEP;
  extern __shared__ __align__(16) float smem[];
  const int d = p * p * C;
  const int yo = Y - p + 1;
  const int npix = (X - p + 1) * yo;
  const long long rows = (long long)n * npix;
  const long long tiles = (rows + TM - 1) / TM;
  const int ftiles = (k + KT - 1) / KT;
  float* Ps = smem;                     // BUFS x [d][TM], a tile's patch rows
  float* Ft = Ps + BUFS * d * TM;       // ftiles x [d][KT], filters transposed
  float* mu = Ft + ftiles * d * KT;     // [d]
  float* mean_s = mu + d;               // [TM]
  float* sd_s = mean_s + TM;            // [TM]
  int* off = reinterpret_cast<int*>(sd_s + TM);  // [d]

  for (int e = threadIdx.x; e < ftiles * d * KT; e += THREADS) {
    const int t = e / (d * KT);
    const int r = e - t * d * KT;
    const int f = t * KT + r % KT;
    Ft[e] = f < k ? filters[(long long)f * d + r / KT] : 0.f;
  }
  for (int e = threadIdx.x; e < d; e += THREADS) {
    mu[e] = means ? means[e] : 0.f;
    const int px = e / (p * C);
    const int rem = e - px * p * C;
    off[e] = (px * Y + rem / C) * C + rem % C;
  }
  __syncthreads();

  const int pix = threadIdx.x % TM;  // this thread's pixel of a tile
  const int e0 = threadIdx.x / TM;   // its first patch element, then every EPT-th

  // Start the cp.async copies of this thread's patch elements of tile t
  // into stage S (zero past the last row) and commit them as one group.
  auto gather = [&](long long t, float* S) {
    const long long row = t * TM + pix;
    const bool live = t < tiles && row < rows;
    const float* src = images;
    if (live) {
      const long long i = row / npix;
      const int q = static_cast<int>(row - i * npix);
      const int ox = q / yo;
      src += (i * X * Y + (long long)ox * Y + (q - ox * yo)) * C;
    }
#pragma unroll 4
    for (int e = e0; e < d; e += EPT) cp_async4(S + e * TM + pix, src + off[e], live);
    cp_async_commit();
  };

  long long tile = blockIdx.x;
  int buf = 0;
  gather(tile, Ps);
  for (; tile < tiles; tile += gridDim.x) {
    float* S = Ps + buf * d * TM;
    cp_async_wait<0>();
    __syncthreads();  // the stage landed for every thread
    if constexpr (BUFS == 2) gather(tile + gridDim.x, Ps + (buf ^ 1) * d * TM);
    if (normalize && threadIdx.x < TM) {
      const int t = threadIdx.x;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s += S[e * TM + t];
      const float mean = s / d;
      float ss = 0.f;
      for (int e = 0; e < d; ++e) {
        const float cv = S[e * TM + t] - mean;
        ss = fmaf(cv, cv, ss);
      }
      mean_s[t] = mean;
      sd_s[t] = sqrtf(ss / (d - 1.0f) + var_constant);
    }
    __syncthreads();
    if (normalize) {
      const float mean = mean_s[pix];
      const float sd = sd_s[pix];
      for (int e = e0; e < d; e += EPT) S[e * TM + pix] = (S[e * TM + pix] - mean) / sd - mu[e];
    } else {
      for (int e = e0; e < d; e += EPT) S[e * TM + pix] = S[e * TM + pix] - mu[e];
    }
    __syncthreads();  // the stage is normalised

    const long long r0 = tile * TM;
    for (int ft = 0; ft < ftiles; ++ft) {
      const float* Fs = Ft + ft * d * KT;
      float acc[8][NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      int e = 0;
      for (; e + STEP <= d; e += STEP) fma_stage<STEP, 8, NJ>(S + e * TM, Fs + e * KT, acc);
      for (; e < d; ++e) fma_stage<1, 8, NJ>(S + e * TM, Fs + e * KT, acc);

      const int c0 = ft * KT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = r0 + out_row<8>(i);
        if (r >= rows) continue;
        float* orow = out + r * k + c0;
        if constexpr (VST) {
          // k % 4 == 0: a 4-column group (a pair) lies wholly inside k or
          // wholly past it.
#pragma unroll
          for (int q = 0; q < Q4; ++q) {
            const int c = out_col<NJ>(4 * q);
            if (c0 + c < k)
              store4(orow + c, acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                     acc[i][4 * q + 3]);
          }
          if constexpr (REM >= 2) {
            const int c = out_col<NJ>(4 * Q4);
            if (c0 + c < k) store2(orow + c, acc[i][4 * Q4], acc[i][4 * Q4 + 1]);
          }
          if constexpr (REM == 1 || REM == 3) {
            const int c = out_col<NJ>(NJ - 1);
            if (c0 + c < k) orow[c] = acc[i][NJ - 1];
          }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = out_col<NJ>(j);
            if (c0 + c < k) orow[c] = acc[i][j];
          }
        }
      }
    }
    if constexpr (BUFS == 1) {
      __syncthreads();  // every thread is done with the stage
      gather(tile + gridDim.x, Ps);
    } else {
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
}

// The launch of the kernel instance for NJ, VST on the current device:
// its shared memory (the kernel's limit raised to it), its resident blocks
// an SM and its persistent grid, the resident blocks or fewer where there
// are fewer tiles.
struct Plan {
  int smem, blocks_per_sm, grid;
};
template <int NJ, bool VST>
cudaError_t plan(int n, int X, int Y, int C, int p, int k, Plan* out) {
  auto kernel = conv_featurize_kernel<NJ, VST>;
  out->smem = static_cast<int>(smem_of(p * p * C, k, 16 * NJ));
  out->blocks_per_sm = 0;
  int device = 0, sms = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out->smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out->blocks_per_sm, kernel, THREADS,
                                                        out->smem);
  const long long tiles = ((long long)n * (X - p + 1) * (Y - p + 1) + TM - 1) / TM;
  const long long resident = (long long)sms * (out->blocks_per_sm > 0 ? out->blocks_per_sm : 1);
  out->grid = static_cast<int>(tiles < resident ? tiles : resident);
  return err;
}

// fn(std::integral_constant<int, NJ>, std::bool_constant<VST>) for the
// instance that k takes.
template <typename Fn>
inline auto with_instance(int k, Fn&& fn) {
  return with_filter_tile(k, [&](auto nj) {
    return VEC_STORES && k % 4 == 0 ? fn(nj, std::true_type{}) : fn(nj, std::false_type{});
  });
}

}  // namespace

// images (n, X, Y, C), filters (k, p * p * C) and means (p * p * C,) (or
// null for none) float32, contiguous; out (n, X - p + 1, Y - p + 1, k)
// float32, contiguous and 16-byte aligned. n, k > 0 and X, Y >= p (the
// caller handles empty outputs). Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int kt_conv_featurize(const float* images, const float* filters, const float* means,
                                 float* out, int n, int X, int Y, int C, int p, int k,
                                 int normalize, float var_constant, void* stream) {
  return with_instance(k, [&](auto nj, auto vst) {
    constexpr int NJ = decltype(nj)::value;
    constexpr bool VST = decltype(vst)::value;
    Plan pl;
    const cudaError_t err = plan<NJ, VST>(n, X, Y, C, p, k, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = conv_featurize_kernel<NJ, VST>;
    kernel<<<pl.grid, THREADS, pl.smem, static_cast<cudaStream_t>(stream)>>>(
        images, filters, means, out, n, X, Y, C, p, k, normalize, var_constant);
    return static_cast<int>(cudaGetLastError());
  });
}

// The launch kt_conv_featurize makes for these shapes on the current
// device: out[0] its blocks, out[1] the kernel's resident blocks an SM,
// out[2] its registers a thread, out[3] its local (spilled) bytes a thread,
// out[4] the filter tile's width, out[5] the block's shared memory in
// bytes, out[6] whether it stores 16 bytes at a time. Returns the
// cudaError_t.
extern "C" int kt_conv_featurize_config(int n, int X, int Y, int C, int p, int k, int* out) {
  return with_instance(k, [&](auto nj, auto vst) {
    constexpr int NJ = decltype(nj)::value;
    constexpr bool VST = decltype(vst)::value;
    Plan pl;
    cudaFuncAttributes attr;
    cudaError_t err = plan<NJ, VST>(n, X, Y, C, p, k, &pl);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, conv_featurize_kernel<NJ, VST>);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = pl.grid;
    out[1] = pl.blocks_per_sm;
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    out[4] = 16 * NJ;
    out[5] = pl.smem;
    out[6] = VST ? 1 : 0;
    return 0;
  });
}
