// Native COCO RLE codec core (C ABI, loaded via ctypes).
//
// TPU-native replacement for the reference's only native component — the
// vendored pycocotools C codec (reference: refer/external/maskApi.c) —
// implemented from the public COCO RLE format: Fortran-order flattening,
// alternating zero/one run counts starting with zeros, and the 5-bit
// varint "LEB"-style compressed counts string (+48 ASCII offset, counts
// after the second delta-encoded against counts[i-2]).
//
// Build: hybridgl_tpu_torch/utils/native_build.py, at first use

#include <cstdint>
#include <cstring>

extern "C" {

// Encode a row-major [h, w] binary mask. Walks in Fortran (column-major)
// order. Returns the number of counts written, or -1 if max_counts is too
// small. counts[0] is the leading zero-run (possibly 0).
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts, int64_t max_counts) {
  int64_t n = 0;
  uint8_t prev = 0;  // runs start with zeros
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        if (n >= max_counts) return -1;
        counts[n++] = run;
        run = 1;
        prev = v;
      }
    }
  }
  if (n >= max_counts) return -1;
  counts[n++] = run;
  return n;
}

// Decode counts into a row-major [h, w] uint8 mask.
void rle_decode(const uint32_t* counts, int64_t n, uint8_t* mask,
                int64_t h, int64_t w) {
  std::memset(mask, 0, (size_t)(h * w));
  int64_t idx = 0;
  uint8_t v = 0;
  const int64_t total = h * w;
  for (int64_t i = 0; i < n && idx < total; ++i) {
    int64_t run = counts[i];
    if (v) {
      int64_t end = idx + run;
      if (end > total) end = total;
      for (int64_t j = idx; j < end; ++j) {
        int64_t y = j % h, x = j / h;
        mask[y * w + x] = 1;
      }
    }
    idx += run;
    v ^= 1;
  }
}

// Compress counts to the COCO ASCII string. Returns bytes written or -1.
int64_t rle_compress(const uint32_t* counts, int64_t n, char* out,
                     int64_t max_out) {
  int64_t p = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (p >= max_out) return -1;
      out[p++] = (char)(c + 48);
    }
  }
  return p;
}

// Decompress the ASCII string into counts. Returns counts written or -1.
int64_t rle_decompress(const char* s, int64_t len, uint32_t* counts,
                       int64_t max_counts) {
  int64_t n = 0, i = 0;
  while (i < len) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    int64_t c = 0;
    while (more) {
      if (i >= len) return -1;
      c = (int64_t)s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
    }
    if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    if (n > 2) x += (int64_t)counts[n - 2];
    if (n >= max_counts) return -1;
    counts[n++] = (uint32_t)x;
  }
  return n;
}

// Union/intersection area stats of two RLEs without materialising masks.
// kind: 0 = intersection, 1 = union. Returns pixel count.
int64_t rle_overlap_area(const uint32_t* a, int64_t na, const uint32_t* b,
                         int64_t nb, int kind) {
  int64_t ia = 0, ib = 0;
  int64_t ra = na ? (int64_t)a[0] : 0;  // remaining in current a-run
  int64_t rb = nb ? (int64_t)b[0] : 0;
  uint8_t va = 0, vb = 0;
  int64_t acc = 0;
  while (ia < na && ib < nb) {
    while (ra == 0 && ++ia < na) { ra = a[ia]; va ^= 1; }
    while (rb == 0 && ++ib < nb) { rb = b[ib]; vb ^= 1; }
    if (ia >= na || ib >= nb) break;
    int64_t step = ra < rb ? ra : rb;
    uint8_t v = kind ? (va | vb) : (va & vb);
    if (v) acc += step;
    ra -= step;
    rb -= step;
  }
  return acc;
}

}  // extern "C"
