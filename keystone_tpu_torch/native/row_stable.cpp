// Row-stable float32 products on the host.
//
// ks_matmul_fma_chain_f32: out = X @ W, X (m, k) and W (k, n) float32. The
// reduction indices go in chunks of kc; each chunk's products are summed as
// one fused multiply-add chain in index order from 0 (std::fma rounds once
// a step, whatever the contraction flag), and the chunk sums are added in
// chunk order, each add rounded on its own (built with -ffp-contract=off).
// That is csrc/row_stable_matmul.cu's order (chunks of 256, an fmaf chain
// each, then sum_chunks_kernel); with kc >= k it is one chain, the order of
// csrc/cosine_features.cu. A row's bits depend on that row and W alone: not
// on the row count, the row's position or the number of threads. Rows are
// split over threads; a block of kCols output columns of W stays in cache
// while every row of the thread passes through it.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr long kCols = 32;

#if defined(__x86_64__) && defined(__GNUC__)
// Clones whose ISA has FMA, so std::fma vectorizes (the default clone calls
// libm's fmaf: the same result, slower).
#define KS_FMA_CLONES __attribute__((target_clones("avx512f", "arch=haswell", "default")))
#else
#define KS_FMA_CLONES
#endif

// Rows [r0, r1) of out = X @ W.
KS_FMA_CLONES
void rows_fma_chain(const float* X, long k, long ldx, const float* W, long n,
                    long ldw, float* out, long ldo, long kc, long r0, long r1) {
  std::vector<float> wt(k * kCols);
  for (long c0 = 0; c0 < n; c0 += kCols) {
    const long nc = std::min(kCols, n - c0);
    std::fill(wt.begin(), wt.end(), 0.0f);
    for (long i = 0; i < k; ++i)
      for (long j = 0; j < nc; ++j) wt[i * kCols + j] = W[i * ldw + c0 + j];
    for (long r = r0; r < r1; ++r) {
      const float* x = X + r * ldx;
      float s[kCols];
      for (long lo = 0; lo < k; lo += kc) {
        const long hi = std::min(k, lo + kc);
        float acc[kCols] = {0.0f};
        for (long i = lo; i < hi; ++i) {
          const float xi = x[i];
          const float* w = wt.data() + i * kCols;
          for (long j = 0; j < kCols; ++j) acc[j] = std::fma(xi, w[j], acc[j]);
        }
        if (lo == 0) {
          for (long j = 0; j < kCols; ++j) s[j] = acc[j];
        } else {
          for (long j = 0; j < kCols; ++j) s[j] = s[j] + acc[j];
        }
      }
      float* o = out + r * ldo + c0;
      for (long j = 0; j < nc; ++j) o[j] = s[j];
    }
  }
}

}  // namespace

extern "C" {

// out (m, n) = X (m, k) @ W (k, n), row strides ldx, ldw, ldo (elements),
// in chunks of kc reduction indices, rows split over `threads` threads.
void ks_matmul_fma_chain_f32(const float* X, long m, long k, long ldx,
                             const float* W, long n, long ldw, float* out,
                             long ldo, long kc, long threads) {
  if (m <= 0 || n <= 0) return;
  if (k <= 0) {
    for (long r = 0; r < m; ++r) std::memset(out + r * ldo, 0, n * sizeof(float));
    return;
  }
  kc = std::max(1L, std::min(kc, k));
  const long t = std::max(1L, std::min(threads, m));
  const long per = (m + t - 1) / t;
  std::vector<std::thread> workers;
  for (long i = 1; i < t; ++i) {
    const long r0 = i * per, r1 = std::min(m, r0 + per);
    if (r0 >= r1) break;
    workers.emplace_back(rows_fma_chain, X, k, ldx, W, n, ldw, out, ldo, kc, r0, r1);
  }
  // The first share on the calling thread.
  rows_fma_chain(X, k, ldx, W, n, ldw, out, ldo, kc, 0, std::min(m, per));
  for (auto& w : workers) w.join();
}

}  // extern "C"
