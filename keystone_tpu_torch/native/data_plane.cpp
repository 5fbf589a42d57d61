// Native host-side data plane, part 2: fixed-record binary decode (CIFAR
// family) and a threaded multi-buffer CSV parser. Port of
// keystone_tpu/native/data_plane.cpp (the same functions and results).
//
// The reference reads 3073-byte CIFAR records on Spark's master node
// (loaders/CifarLoader.scala:14-53) and parses CSVs through Spark's line
// RDDs; here the record deinterleave + planar->HWC uint8->float conversion
// and bulk CSV parsing are parallel native loops feeding the device.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// From csv_loader.cpp.
long ks_parse_csv(const char* buf, long len, double* out, long max_vals,
                  long* n_cols, long* n_rows);

// Deinterleave fixed-size records of [label_bytes | c*h*w planar uint8].
// Writes the LAST label byte per record (CIFAR-10: the only byte; CIFAR-100:
// the fine label) to labels_out and HWC float32 pixels to images_out.
void ks_split_records(const uint8_t* buf, long n_records, long label_bytes,
                      long channels, long height, long width,
                      int64_t* labels_out, float* images_out) {
  const long img_bytes = channels * height * width;
  const long rec = label_bytes + img_bytes;
  const long plane = height * width;

  long n_threads = (long)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_records) n_threads = n_records;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const long chunk = (n_records + n_threads - 1) / n_threads;
  for (long t = 0; t < n_threads; ++t) {
    const long lo = t * chunk;
    const long hi = (lo + chunk < n_records) ? lo + chunk : n_records;
    if (lo >= hi) break;
    workers.emplace_back([=]() {
      for (long r = lo; r < hi; ++r) {
        const uint8_t* p = buf + r * rec;
        labels_out[r] = (int64_t)p[label_bytes - 1];
        const uint8_t* img = p + label_bytes;
        float* out = images_out + r * img_bytes;
        for (long c = 0; c < channels; ++c) {
          const uint8_t* pl = img + c * plane;
          for (long i = 0; i < plane; ++i) {
            out[i * channels + c] = (float)pl[i];
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

// Parse n_bufs CSV byte buffers concurrently (one task per buffer, pulled
// from a shared counter by hardware_concurrency() threads). Per-buffer
// outputs mirror ks_parse_csv: value count, column count, row count.
void ks_parse_csv_many(const char** bufs, const long* lens, long n_bufs,
                       double** outs, const long* max_vals, long* counts,
                       long* n_cols, long* n_rows) {
  long n_threads = (long)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_bufs) n_threads = n_bufs;
  std::atomic<long> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (long t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        const long i = next.fetch_add(1);
        if (i >= n_bufs) return;
        counts[i] = ks_parse_csv(bufs[i], lens[i], outs[i], max_vals[i],
                                 &n_cols[i], &n_rows[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"

extern "C" {

// From csv_loader.cpp.
int ks_decode_pnm(const unsigned char* data, long len, float* out,
                  long max_vals, long* x, long* y, long* c);

// Decode n_bufs PNM buffers concurrently (thread pool over a shared counter).
// Per-buffer outputs mirror ks_decode_pnm; rcs[i] is the per-buffer return
// code (0 = ok).
void ks_decode_pnm_many(const char** bufs, const long* lens, long n_bufs,
                        float** outs, const long* max_vals, long* xs,
                        long* ys, long* cs, long* rcs) {
  long n_threads = (long)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_bufs) n_threads = n_bufs;
  std::atomic<long> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (long t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        const long i = next.fetch_add(1);
        if (i >= n_bufs) return;
        rcs[i] = ks_decode_pnm(
            reinterpret_cast<const unsigned char*>(bufs[i]), lens[i],
            outs[i], max_vals[i], &xs[i], &ys[i], &cs[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
