// Native host-side data plane: fast CSV float parsing + PNM decode.
// Port of keystone_tpu/native/csv_loader.cpp (the same functions and
// results; built with g++ and bound through ctypes by
// keystone_tpu_torch/native/__init__.py).
//
// The reference ships a native tier for host-side work the JVM was too slow
// for (src/main/cpp/{VLFeat,EncEval}.cxx). The compute members of that tier
// live on the device here; the host-side member that remains is the data
// loader: CSV/text ingestion feeding the device.

#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

// Parse a buffer of comma/whitespace-separated doubles.
// Returns the number of values written to `out` (capped at max_vals).
// Writes the first row's column count to n_cols and the number of non-empty
// rows to n_rows so the caller can validate rectangular shape.
long ks_parse_csv(const char* buf, long len, double* out, long max_vals,
                  long* n_cols, long* n_rows) {
  const char* p = buf;
  const char* end = buf + len;
  long count = 0;
  long cols = 0;
  long rows = 0;
  long row_vals = 0;
  bool first_row = true;
  *n_cols = 0;

  while (p < end && count < max_vals) {
    // skip separators
    while (p < end && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r')) p++;
    if (p < end && *p == '\n') {
      if (row_vals > 0) {
        rows++;
        if (first_row) {
          *n_cols = cols;
          first_row = false;
        }
      }
      row_vals = 0;
      p++;
      continue;
    }
    if (p >= end) break;
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) {  // unparseable token: skip it
      while (p < end && *p != ',' && *p != '\n' && *p != ' ' && *p != '\t') p++;
      continue;
    }
    out[count++] = v;
    row_vals++;
    if (first_row) cols++;
    p = next;
  }
  if (row_vals > 0) {
    rows++;
    if (first_row) *n_cols = cols;
  }
  *n_rows = rows;
  return count;
}

// Decode binary PPM (P6) / PGM (P5) into float32 HWC, rescaled to [0, 255].
// Returns 0 on success; fills x_dim (height), y_dim (width), channels.
// maxval > 255 (2-byte samples) returns an error so the caller can fall back
// to a full decoder.
int ks_decode_pnm(const unsigned char* buf, long len, float* out, long max_vals,
                  long* x_dim, long* y_dim, long* channels) {
  if (len < 2 || buf[0] != 'P') return 1;
  int kind = buf[1] - '0';
  if (kind != 5 && kind != 6) return 2;
  long pos = 2;
  long vals[3];  // width, height, maxval
  int got = 0;
  while (got < 3 && pos < len) {
    // skip whitespace and comments
    while (pos < len && (isspace(buf[pos]) || buf[pos] == '#')) {
      if (buf[pos] == '#')
        while (pos < len && buf[pos] != '\n') pos++;
      else
        pos++;
    }
    long v = 0;
    bool any = false;
    while (pos < len && isdigit(buf[pos])) {
      v = v * 10 + (buf[pos] - '0');
      pos++;
      any = true;
    }
    if (!any) return 3;
    vals[got++] = v;
  }
  if (got < 3 || pos >= len) return 3;
  pos++;  // single whitespace after maxval
  long w = vals[0], h = vals[1], maxval = vals[2];
  if (maxval <= 0 || maxval > 255) return 6;  // 16-bit: let PIL handle it
  long c = (kind == 6) ? 3 : 1;
  if (h * w * c > max_vals) return 4;
  if (pos + h * w * c > len) return 5;
  float scale = 255.0f / (float)maxval;
  for (long i = 0; i < h * w * c; i++) out[i] = (float)buf[pos + i] * scale;
  *x_dim = h;
  *y_dim = w;
  *channels = c;
  return 0;
}

}  // extern "C"
