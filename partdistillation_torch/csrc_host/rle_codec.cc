// COCO-compatible RLE mask codec on the host: the pseudo-label stores encode
// and decode millions of masks a stage.
//
// The port's own copy of the repository's C++ codec (native/rle_codec.cc),
// bound with ctypes by partdistillation_torch/utils/native_lib.py and used
// by partdistillation_torch/utils/rle.py. Its bytes equal the numpy codec's
// there (and pycocotools'):
//   * column-major (Fortran) run lengths, first run counts zeros
//   * "counts" string: per-count delta vs count[i-2], 5-bit groups + 48.
//
// Build (native_lib.build_host_library, with ms_deform_attn_cpu.cc):
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17 *.cc -o libpd_host_<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- counts compression (pycocotools LEB128-with-sign variant) ----

inline void compress_counts(const std::vector<int64_t>& runs, std::vector<char>& out) {
  out.clear();
  out.reserve(runs.size() * 3);
  for (size_t i = 0; i < runs.size(); ++i) {
    int64_t x = (i < 2) ? runs[i] : runs[i] - runs[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1F;
      x >>= 5;
      more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      out.push_back(static_cast<char>(c + 48));
    }
  }
}

inline bool decompress_counts(const char* s, int64_t n, std::vector<int64_t>& runs) {
  runs.clear();
  int64_t i = 0;
  while (i < n) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= n) return false;
      int64_t c = static_cast<int64_t>(s[i]) - 48;
      x |= (c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    }
    if (runs.size() >= 2) x += runs[runs.size() - 2];
    runs.push_back(x);
  }
  return true;
}

}  // namespace

extern "C" {

// Encode a C-order (h, w) uint8 mask. Writes counts bytes into `out`
// (capacity `cap`); returns bytes written, or -(needed) if cap too small,
// or -1 on error.
int64_t pd_rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                      char* out, int64_t cap) {
  if (h * w == 0) return 0;  // an empty mask has no runs (the numpy codec's "")
  std::vector<int64_t> runs;
  runs.reserve(64);
  uint8_t prev = 0;  // spec: first run counts zeros
  int64_t run = 0;
  for (int64_t j = 0; j < w; ++j) {
    const uint8_t* col = mask + j;  // stride w in C order
    for (int64_t i = 0; i < h; ++i) {
      uint8_t v = col[i * w] != 0;
      if (v == prev) {
        ++run;
      } else {
        runs.push_back(run);
        run = 1;
        prev = v;
      }
    }
  }
  runs.push_back(run);
  std::vector<char> buf;
  compress_counts(runs, buf);
  if ((int64_t)buf.size() > cap) return -(int64_t)buf.size();
  std::memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Decode counts into a C-order (h, w) uint8 mask. Returns 0 on success.
int64_t pd_rle_decode(const char* s, int64_t slen, int64_t h, int64_t w,
                      uint8_t* out) {
  std::vector<int64_t> runs;
  if (!decompress_counts(s, slen, runs)) return -1;
  int64_t total = 0;
  for (int64_t r : runs) total += r;
  if (total != h * w) return -2;
  std::memset(out, 0, (size_t)(h * w));
  int64_t pos = 0;
  for (size_t k = 0; k < runs.size(); ++k) {
    if (k & 1) {  // runs of ones
      for (int64_t t = 0; t < runs[k]; ++t) {
        int64_t p = pos + t;
        out[(p % h) * w + (p / h)] = 1;  // fortran pos -> C order
      }
    }
    pos += runs[k];
  }
  return 0;
}

int64_t pd_rle_area(const char* s, int64_t slen) {
  std::vector<int64_t> runs;
  if (!decompress_counts(s, slen, runs)) return -1;
  int64_t a = 0;
  for (size_t k = 1; k < runs.size(); k += 2) a += runs[k];
  return a;
}

// IoU directly on run lengths (no decode) — two-pointer walk over the two
// run streams computing the length of positions where both masks are 1.
double pd_rle_iou(const char* a, int64_t alen, const char* b, int64_t blen) {
  std::vector<int64_t> ra, rb;
  if (!decompress_counts(a, alen, ra) || !decompress_counts(b, blen, rb))
    return -1.0;
  int64_t area_a = 0, area_b = 0;
  for (size_t k = 1; k < ra.size(); k += 2) area_a += ra[k];
  for (size_t k = 1; k < rb.size(); k += 2) area_b += rb[k];

  int64_t inter = 0;
  size_t ia = 0, ib = 0;
  int64_t ca = ra.empty() ? 0 : ra[0];  // remaining length of current run
  int64_t cb = rb.empty() ? 0 : rb[0];
  bool va = false, vb = false;          // current run values
  while (ia < ra.size() && ib < rb.size()) {
    while (ca == 0) {
      if (++ia >= ra.size()) break;
      ca = ra[ia];
      va = (ia & 1) != 0;
    }
    while (cb == 0) {
      if (++ib >= rb.size()) break;
      cb = rb[ib];
      vb = (ib & 1) != 0;
    }
    if (ia >= ra.size() || ib >= rb.size()) break;
    int64_t step = ca < cb ? ca : cb;
    if (va && vb) inter += step;
    ca -= step;
    cb -= step;
  }
  double uni = (double)(area_a + area_b - inter);
  return uni > 0 ? (double)inter / uni : 0.0;
}

// Batched pairwise IoU: D x G matrix from flattened counts buffers with
// offsets (the proposal evaluator's inner loop).
void pd_rle_iou_matrix(const char* bufa, const int64_t* offa, int64_t na,
                       const char* bufb, const int64_t* offb, int64_t nb,
                       double* out) {
  for (int64_t i = 0; i < na; ++i) {
    const char* a = bufa + offa[i];
    int64_t alen = offa[i + 1] - offa[i];
    for (int64_t j = 0; j < nb; ++j) {
      out[i * nb + j] = pd_rle_iou(a, alen, bufb + offb[j], offb[j + 1] - offb[j]);
    }
  }
}

}  // extern "C"
