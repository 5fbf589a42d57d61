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
// Bound on an H100 SXM at the CIFAR slice's shapes (50,000 images of
// 32 x 32 x 3, 100 filters of 6 x 6 x 3, so 27 x 27 output pixels and
// d = 108): 2 * n * 729 * 108 * 100 = 7.87e11 FLOP of float32 FMA, 11.75 ms
// at the card's 67 TFLOP/s non-tensor float32 peak. The bytes it must move
// (0.61 GB of images in, 14.58 GB of features out) take 4.5 ms at
// 3.35 TB/s. So the kernel is bound by float32 operations; the output
// write is the next limit.
//
// Design. A block of 256 threads walks whole images (image blockIdx.x,
// then + gridDim.x, ...), so the filter bank is staged in shared memory
// once per block: the image (X * Y * C floats), the filters transposed
// (d x kp, kp = k rounded up to 128 and zero-padded), the means and one
// tile of 64 patch rows, transposed to [e][pixel]. For CIFAR that is 96 KB,
// above the 48 KB default, so the launch raises the kernel's limit first;
// the wrapper's guard (conv_featurize_ok) refuses shapes that need more
// than the 227 KB a block may have. For each tile of 64 output pixels the
// threads copy the patches out of the image (im2col in shared memory),
// one thread per pixel takes its mean and variance, every value is
// normalised and centred in place, and then each thread accumulates 4
// pixels x 8 filters in registers over the d patch values, reading one
// float4 of patch values and two float4 of filters per 32 FMAs. The output
// is written once, 8 consecutive filters per thread. Ragged pixel tiles
// and filter counts are masked on the store.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 64;    // output pixels per tile
constexpr int FC = 128;   // filters per register pass (16 threads x 8)

__global__ void __launch_bounds__(THREADS)
conv_featurize_kernel(const float* __restrict__ images, const float* __restrict__ filters,
                      const float* __restrict__ means, float* __restrict__ out, int n,
                      int X, int Y, int C, int p, int k, int kp, int normalize,
                      float var_constant) {
  extern __shared__ __align__(16) float smem[];
  const int d = p * p * C;
  const int xo = X - p + 1;
  const int yo = Y - p + 1;
  const int npix = xo * yo;
  const int img_len = X * Y * C;
  float* Ps = smem;                  // [d][PT], the tile's patch rows transposed
  float* Ft = Ps + d * PT;           // [d][kp], filters transposed
  float* img = Ft + d * kp;          // [X][Y][C]
  float* mu = img + img_len;         // [d]
  float* mean_s = mu + d;            // [PT]
  float* sd_s = mean_s + PT;         // [PT]

  for (int e = threadIdx.x; e < d * kp; e += THREADS) {
    const int dd = e / kp;
    const int f = e % kp;
    Ft[e] = f < k ? filters[(long long)f * d + dd] : 0.f;
  }
  for (int e = threadIdx.x; e < d; e += THREADS) mu[e] = means ? means[e] : 0.f;

  const int pg = threadIdx.x / 16;  // pixels pg * 4 + r, r < 4
  const int fl = threadIdx.x % 16;  // filters fc + fl * 8 + q, q < 8

  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    __syncthreads();  // the previous image's last tile is done with img
    const float* src = images + i * img_len;
    for (int e = threadIdx.x; e < img_len; e += THREADS) img[e] = src[e];
    float* dst = out + i * (long long)npix * k;

    for (int t0 = 0; t0 < npix; t0 += PT) {
      __syncthreads();  // img staged; the previous tile's product is done with Ps
      for (int e = threadIdx.x; e < d * PT; e += THREADS) {
        const int dd = e / PT;
        const int pix = t0 + e % PT;
        float v = 0.f;
        if (pix < npix) {
          const int ox = pix / yo;
          const int oy = pix % yo;
          const int px = dd / (p * C);
          const int rem = dd % (p * C);
          const int py = rem / C;
          const int c = rem % C;
          v = img[((ox + px) * Y + (oy + py)) * C + c];
        }
        Ps[e] = v;
      }
      __syncthreads();
      if (normalize && threadIdx.x < PT) {
        const int t = threadIdx.x;
        float s = 0.f;
        for (int dd = 0; dd < d; ++dd) s += Ps[dd * PT + t];
        const float mean = s / d;
        float ss = 0.f;
        for (int dd = 0; dd < d; ++dd) {
          const float cv = Ps[dd * PT + t] - mean;
          ss = fmaf(cv, cv, ss);
        }
        mean_s[t] = mean;
        sd_s[t] = sqrtf(ss / (d - 1.0f) + var_constant);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < d * PT; e += THREADS) {
        const int dd = e / PT;
        const int t = e % PT;
        Ps[e] = normalize ? (Ps[e] - mean_s[t]) / sd_s[t] - mu[dd] : Ps[e] - mu[dd];
      }
      __syncthreads();

      for (int fc = 0; fc < k; fc += FC) {
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
        const float* fcol = Ft + fc + fl * 8;
        for (int dd = 0; dd < d; ++dd) {
          const float4 a = *reinterpret_cast<const float4*>(Ps + dd * PT + pg * 4);
          const float4 b0 = *reinterpret_cast<const float4*>(fcol + dd * kp);
          const float4 b1 = *reinterpret_cast<const float4*>(fcol + dd * kp + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pix = t0 + pg * 4 + r;
          if (pix >= npix) continue;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int f = fc + fl * 8 + q;
            if (f < k) dst[(long long)pix * k + f] = acc[r][q];
          }
        }
      }
    }
  }
}

// Shared memory, in bytes, that one block needs for these shapes; the
// wrapper's guard (cuda_images._conv_smem_bytes) computes the same sum.
long long smem_bytes(int X, int Y, int C, int p, int k) {
  const long long d = (long long)p * p * C;
  const long long kp = (k + FC - 1) / FC * FC;
  return 4 * (d * PT + d * kp + (long long)X * Y * C + d + 2 * PT);
}

}  // namespace

// images (n, X, Y, C), filters (k, p * p * C) and means (p * p * C,) (or
// null for none) float32, contiguous; out (n, X - p + 1, Y - p + 1, k)
// float32, contiguous. n, k > 0 and X, Y >= p (the caller handles empty
// outputs). Launches on `stream` and returns the launch's cudaError_t
// (0 = success).
extern "C" int kt_conv_featurize(const float* images, const float* filters, const float* means,
                                 float* out, int n, int X, int Y, int C, int p, int k,
                                 int normalize, float var_constant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = (k + FC - 1) / FC * FC;
  const size_t smem = static_cast<size_t>(smem_bytes(X, Y, C, p, k));
  cudaError_t err = cudaFuncSetAttribute(
      conv_featurize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two resident blocks per SM at CIFAR's 96 KB; each walks n / grid images.
  const int grid = n < 2 * sms ? n : 2 * sms;
  conv_featurize_kernel<<<grid, THREADS, smem, s>>>(images, filters, means, out, n, X, Y, C,
                                                    p, k, kp, normalize, var_constant);
  return static_cast<int>(cudaGetLastError());
}
