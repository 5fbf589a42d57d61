// The Gramian kernels on fma_pipe.cuh's pipelined tile: A^T A of a
// row-major A (n, d) over its upper-triangle 128 x 128 tiles, with or
// without the correlation A^T R, and with one of two epilogues:
//   - STORE (ACC = false): the sums into out, and off the diagonal into the
//     mirror tile too, so out is the whole symmetric Gramian (gram_corr.cu's
//     gram_corr and gram_corr_sym, float32 or bf16 A, and block_gram_sym
//     with float32 F);
//   - ACC (ACC = true): out = in + sums on the upper tiles only, nothing
//     mirrored, the strictly-lower tiles of out never written; in and out
//     may be the same buffer (gram_corr.cu's gram_sym_acc with float32 F,
//     the streamed fold's step, and gram_corr_sym_acc.cu's float32 form,
//     the sparse fold's step), and so may the correlation's.
// A bf16 Gramian alone (block_gram_sym, gram_sym_acc) and gram_corr_sym_acc
// with bf16 F run on the tensor cores instead (gram_wgmma.cuh): the
// Gramian-alone kernel here is float32 only.
//
// Every output tile is one block of one launch that loops over all n rows
// itself, so nothing carries between blocks and no atomics are needed; the
// TPU kernels' sequential row-tile grid axis becomes that loop. The rows go
// in chunks, CHUNK (2,048) for the Gramian and CORR_CHUNK (256) for the
// correlation: each chunk's sums are one fmaf chain over its rows in order,
// from zero (fma_pipe.cuh), and the block adds them, in chunk order, to a
// running total that it keeps in its own output tile in device memory: the
// total starts as 0 (STORE) or in (ACC; nothing to do in place)
// and each chunk adds its sums, out = out + s_c (0 + s_0 = s_0 exactly).
// Each entry of the total is read and written by the thread that owns it,
// and STORE writes the mirror tile once, after the last chunk. The ring runs
// on across chunks: fma_pipe.cuh's mainloop hands each chunk's sums to the
// epilogue (its FLUSH) with the next stages' copies in flight, so a chunk
// costs one pass over the tile in device memory. A Gramian entry is then a
// chain of at most 2,048 products and one of ceil(n / 2,048) chunk sums (288
// at 589,824 rows, 1,075 at 2.2e6): one chain over all n rows was 2.8x
// (Gramian) and 7.4x (correlation) further from float64 sums than cuBLAS's
// at 589,824 rows on an H100, and chunks of 8,192 / 1,024 were still 3.1x
// and 2.1x as far on VOCSIFTFisher's centred Fisher-vector blocks (5,011
// rows, one chunk: a chain of 5,011); at 2,048 / 256 they are 0.87x and
// 0.52x, the ridge weights of each block 0.60x cuBLAS's distance
// (scripts/torch_gram_chunks.py; 1,024 / 256 read 0.54x and 0.41x but
// cost 6% on gram_sym_acc, 2,048 / 256 1%). The bits differ from a single
// chain's wherever n > 2,048 (256 for the correlation). The
// correlation's chunks are shorter because its entries cancel (centred
// features against centred labels), so a chain's rounding is a larger share
// of them; its tile is small (4 x NJ a thread), so a flush costs little.
// Still the Gramian is exactly symmetric, all these forms give each other's
// bits (ACC on in = 0 gives STORE's), in place gives the bits of a new
// buffer, and a window read in place gives the bits of its copy.
//   - Blocks [0, ncorr): the correlation, 64 columns of A (4 a thread) x a
//     label tile that holds all of R's columns up to 160 (k = 147: 8%
//     masked; k <= 32: 32 wide; k > 160: further 160-wide tiles),
//     block_corr.cu's label-tile rule. Splitting the correlation's rows
//     into chunks would fill waves better, but changes its sums' order.
//   - Blocks [ncorr, ...): one block an upper Gramian tile (ti <= tj),
//     row-major over the upper triangle, 128 x 128 (8 x 8 outputs a
//     thread). gram_kernel launches these alone, for float32 A.
// Rows stream through a 3-stage cp.async ring of 32-row stages for the
// Gramian and of 16-row stages for the correlation, in 16-byte chunks when
// A's base and row stride are 16-byte aligned (VA; PA, the instance that
// copies the chunk at a ragged right edge in part, where d is not whole
// chunks), else element by element; bf16 A is widened to
// float32 as it is read from shared memory; R stays float32 in the
// product. Ragged edges of n, d and k are masked, and nothing outside A's
// d columns is read.

#pragma once

#include "fma_pipe.cuh"

namespace kt_gram {

using namespace kt_pipe;

constexpr int BK = 32;       // rows a stage of the Gramian
constexpr int STAGES = 3;    // stages in the cp.async ring
constexpr int MINB = 2;      // blocks an SM the registers are capped for (128 a thread)
constexpr int CORR_BK = 16;  // rows a stage of the correlation (block_corr.cu's)
constexpr int CORR_MI = 4;   // columns of A a thread of a correlation block (x 16 a block)
constexpr int CHUNK = 2048;      // Gramian rows summed from zero before they join the total
constexpr int CORR_CHUNK = 256;  // the correlation's
static_assert(CHUNK % BK == 0 && CORR_CHUNK % CORR_BK == 0, "a chunk must be whole stages");

template <typename TA>
constexpr int gram_smem() {
  return smem_bytes<TA, TA, BK, STAGES, 8, 8>();
}

template <typename TA, int NJ>
constexpr int smem_of() {
  constexpr int corr = smem_bytes<TA, float, CORR_BK, STAGES, CORR_MI, NJ>();
  return gram_smem<TA>() > corr ? gram_smem<TA>() : corr;
}

// Where a product goes: out, and for ACC the matrix in it is added to (row
// strides ldo and ldi). STORE writes a contiguous (rows, cols) out. in and
// out may alias: no __restrict__.
struct Out {
  const float* in;
  long long ldi;
  float* out;
  long long ldo;
};

// The running total of a thread's outputs of the tile at (i0, j0) inside
// (rows, cols), before the first chunk: out = 0, or for ACC out = in (nothing
// to do in place).
template <bool ACC, int MI, int NJ>
__device__ __forceinline__ void init_tile(const Out& o, long long rows, long long cols,
                                          long long i0, long long j0) {
  if (ACC && o.in == o.out && o.ldi == o.ldo) return;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long r = i0 + out_row<MI>(i);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < cols) o.out[r * o.ldo + c] = ACC ? o.in[r * o.ldi + c] : 0.f;
    }
  }
}

// Add one chunk's sums into the running total: out += acc, each entry read
// and then written by this thread. mainloop calls this from inside its row
// loop, so the operands pass through an empty asm first: addresses the
// compiler hoisted out of that loop would hold registers across it (they
// spilled 48-536 bytes a thread at the 128-register cap).
template <int MI, int NJ>
__device__ __forceinline__ void add_tile(const Out& o, long long rows, long long cols,
                                         long long i0, long long j0,
                                         const float (&acc)[MI][NJ]) {
  float* out = o.out;
  long long ldo = o.ldo;
  asm volatile("" : "+l"(out), "+l"(ldo), "+l"(i0), "+l"(j0));
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long r = i0 + out_row<MI>(i);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long c = j0 + out_col<NJ>(j);
      if (c < cols) out[r * ldo + c] += acc[i][j];
    }
  }
}

// Upper Gramian tile p (ti <= tj, row-major over the upper triangle of nt
// x nt tiles) of A's d columns over all n rows, into g; for STORE also its
// mirror tile off the diagonal.
template <typename TA, bool VA, bool PA, bool ACC>
__device__ __forceinline__ void gram_tile(unsigned char* smem, const TA* __restrict__ A,
                                          const Out& g, int n, int d, long long lda, int nt,
                                          int p) {
  int ti = 0;
  int rem = p;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const long long i0 = (long long)ti * TM;
  const long long j0 = (long long)tj * TM;
  constexpr int FLUSH = CHUNK / BK;  // stages a chunk
  float acc[8][8];
  init_tile<ACC, 8, 8>(g, d, d, i0, j0);
  mainloop<BK, STAGES, 8, 8, VA, VA, false, false, PA, PA, FLUSH>
      (smem, A, lda, i0, d, A, lda, j0, d, 0, n, false, acc,
       [&](const float(&sums)[8][8]) { add_tile(g, d, d, i0, j0, sums); });
  if constexpr (!ACC) {
    if (ti == tj) return;  // a diagonal tile is computed whole
    // The mirror tile, from the totals this thread wrote.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = i0 + out_row<8>(i);
      if (r >= d) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = j0 + out_col<8>(j);
        if (c < d) g.out[c * d + r] = g.out[r * d + c];
      }
    }
  }
}

// NJ: the correlation's label tile, 16 * NJ columns; nkt of them, and ncorr
// correlation blocks in all.
template <typename TA, int NJ, bool VA, bool PA, bool ACC>
__global__ void __launch_bounds__(THREADS, MINB)
gram_corr_kernel(const TA* __restrict__ A, const float* __restrict__ R, Out g, Out c, int n,
                 int d, int k, long long lda, long long ldr, int nt, int ncorr, int nkt) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < ncorr) {
    const long long i0 = (long long)(blockIdx.x / nkt) * 16 * CORR_MI;
    const long long j0 = (long long)(blockIdx.x % nkt) * 16 * NJ;
    float acc[CORR_MI][NJ];
    init_tile<ACC, CORR_MI, NJ>(c, d, k, i0, j0);
    mainloop<CORR_BK, STAGES, CORR_MI, NJ, VA, false, false, false, PA, false,
             CORR_CHUNK / CORR_BK>(
        smem, A, lda, i0, d, R, ldr, j0, k, 0, n, false, acc,
        [&](const float(&sums)[CORR_MI][NJ]) { add_tile(c, d, k, i0, j0, sums); });
    return;
  }
  gram_tile<TA, VA, PA, ACC>(smem, A, g, n, d, lda, nt, blockIdx.x - ncorr);
}

// The Gramian tiles alone, float32 A: block p is upper tile p.
template <bool VA, bool PA, bool ACC>
__global__ void __launch_bounds__(THREADS, MINB)
gram_kernel(const float* __restrict__ A, Out g, int n, int d, long long lda, int nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  gram_tile<float, VA, PA, ACC>(smem, A, g, n, d, lda, nt, blockIdx.x);
}

// The copy instance for A (base pointer, row stride lda, d columns):
// element-wise, 16-byte (whole chunks), or 16-byte with the last chunk in
// part; fn(VA, PA) as std::integral_constant<bool> pairs.
template <typename TA, typename Fn>
inline auto with_copies(const TA* A, long long lda, int d, Fn&& fn) {
  using T = std::true_type;
  using F = std::false_type;
  if (!rows_vec_ok(A, lda)) return fn(F{}, F{});
  return d % vec_elems<TA>() == 0 ? fn(T{}, F{}) : fn(T{}, T{});
}

// The upper tiles of a d-wide Gramian.
inline int gram_blocks(int d) {
  const int nt = (d + TM - 1) / TM;
  return nt * (nt + 1) / 2;
}

// The correlation's blocks: 16 * CORR_MI columns of A x ktile label columns.
inline int corr_blocks(int d, int k, int ktile) {
  return (d + 16 * CORR_MI - 1) / (16 * CORR_MI) * ((k + ktile - 1) / ktile);
}

// A kernel's resources on the current device at `threads` a block: out[0]
// its resident blocks an SM, out[1..2] registers and local (spilled) bytes
// a thread, out[3] the SM count.
template <typename Kernel>
cudaError_t resources(Kernel kernel, int smem, int* out, int threads = THREADS) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
}

// The Gramian + correlation kernel instance for these operands, its shared
// memory, and its label tile's width.
template <typename TA, bool ACC>
struct Instance {
  void (*kernel)(const TA*, const float*, Out, Out, int, int, int, long long, long long, int,
                 int, int);
  int smem;
  int ktile;
};

template <typename TA, bool ACC>
cudaError_t instance(const TA* A, int d, int k, long long lda, Instance<TA, ACC>* out) {
  *out = with_copies(A, lda, d, [&](auto va, auto pa) {
    return with_label_tile(k, [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      constexpr bool VA = decltype(va)::value, PA = decltype(pa)::value;
      return Instance<TA, ACC>{gram_corr_kernel<TA, NJ, VA, PA, ACC>, smem_of<TA, NJ>(), 16 * NJ};
    });
  });
  return cudaFuncSetAttribute(out->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              out->smem);
}

// The grid of one Gramian + correlation launch: out[0] Gramian blocks,
// out[1] correlation blocks, out[2] the label tile's width, out[3..6] the
// kernel's resources, out[7] the columns of A a correlation block, out[8]
// whether A is copied in 16-byte chunks.
template <typename TA, bool ACC>
cudaError_t plan(const TA* A, int d, int k, long long lda, int* out) {
  Instance<TA, ACC> inst;
  const cudaError_t err = instance(A, d, k, lda, &inst);
  if (err != cudaSuccess) return err;
  out[0] = gram_blocks(d);
  out[1] = corr_blocks(d, k, inst.ktile);
  out[2] = inst.ktile;
  out[7] = 16 * CORR_MI;
  out[8] = rows_vec_ok(A, lda);
  return resources(inst.kernel, inst.smem, out + 3);
}

template <typename TA, bool ACC>
int launch(const TA* A, const float* R, const Out& g, const Out& c, int n, int d, int k,
           long long lda, long long ldr, cudaStream_t stream) {
  Instance<TA, ACC> inst;
  const cudaError_t err = instance(A, d, k, lda, &inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d + TM - 1) / TM;
  const int ncorr = corr_blocks(d, k, inst.ktile);
  inst.kernel<<<ncorr + gram_blocks(d), THREADS, inst.smem, stream>>>(
      A, R, g, c, n, d, k, lda, ldr, nt, ncorr, (k + inst.ktile - 1) / inst.ktile);
  return static_cast<int>(cudaGetLastError());
}

using GramKernel = void (*)(const float*, Out, int, int, long long, int);

// The Gramian-alone kernel for the float32 operand W (base pointer, row
// stride ldf, b columns): a 16-byte instance where rows_vec_ok (vec), else
// the element-wise one.
template <bool ACC>
cudaError_t gram_instance(const float* W, int b, long long ldf, GramKernel* kernel, bool* vec) {
  *vec = rows_vec_ok(W, ldf);
  *kernel = with_copies(W, ldf, b, [](auto va, auto pa) -> GramKernel {
    return gram_kernel<decltype(va)::value, decltype(pa)::value, ACC>;
  });
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              gram_smem<float>());
}

// The Gramian-alone grid: out[0] blocks, out[1] whether the 16-byte path
// is taken, out[2..5] the kernel's resources.
template <bool ACC>
cudaError_t gram_plan(const float* W, int b, long long ldf, int* out) {
  GramKernel kernel;
  bool vec;
  const cudaError_t err = gram_instance<ACC>(W, b, ldf, &kernel, &vec);
  if (err != cudaSuccess) return err;
  out[0] = gram_blocks(b);
  out[1] = vec;
  return resources(kernel, gram_smem<float>(), out + 2);
}

template <bool ACC>
int launch_gram(const float* W, const Out& g, int n, int b, long long ldf, cudaStream_t stream) {
  GramKernel kernel;
  bool vec;
  const cudaError_t err = gram_instance<ACC>(W, b, ldf, &kernel, &vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<gram_blocks(b), THREADS, gram_smem<float>(), stream>>>(W, g, n, b, ldf,
                                                                 (b + TM - 1) / TM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kt_gram
