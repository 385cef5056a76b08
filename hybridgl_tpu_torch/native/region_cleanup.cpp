// Native small-region mask cleanup (holes + islands) for the host
// postprocess pass (pipeline/postprocess.py).
//
// Reference semantics: automatic_mask_generator.py:323-372 +
// utils/amg.py:267-291 — fill background components ("holes") smaller than
// min_area unless they are the global background seen through the bbox
// window (ring-connected), then drop mask components ("islands") smaller
// than min_area, keeping the raster-first largest when all are small.
//
// The python/cv2 path costs two connectedComponentsWithStats calls plus
// ~6 numpy passes per mask; this does both labelings with one union-find
// each directly on the strided crop window of the full [P, H, W] array,
// in place, single pass per labeling, no allocations after warmup.
// The host is single-core in deployment, so the batch loop is serial.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

struct UF {
  std::vector<int32_t> parent;
  std::vector<int64_t> size;
  std::vector<uint8_t> ring;  // touches an enabled ring side

  void reset() {
    parent.clear();
    size.clear();
    ring.clear();
  }
  int32_t make() {
    int32_t id = static_cast<int32_t>(parent.size());
    parent.push_back(id);
    size.push_back(0);
    ring.push_back(0);
    return id;
  }
  int32_t find(int32_t x) {
    int32_t r = x;
    while (parent[r] != r) r = parent[r];
    while (parent[x] != r) {
      int32_t n = parent[x];
      parent[x] = r;
      x = n;
    }
    return r;
  }
  // union preferring the smaller id as root: roots then order components
  // by raster-scan first encounter, matching cv2's label ordering (which
  // np.argmax tie-breaks rely on)
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b)
      parent[b] = a;
    else
      parent[a] = b;
  }
};

// Label the pixels of value `v` inside the crop window (8-connected).
// labels[ci] gets the component id for value-v pixels, -1 otherwise.
// After the pass, uf.size[root] holds pixel counts and uf.ring[root] is set
// for components touching an enabled ring side.
void label_value(const uint8_t* m, int64_t W, int64_t ch, int64_t cw,
                 uint8_t v, std::vector<int32_t>& labels, UF& uf,
                 int ring_top, int ring_bottom, int ring_left,
                 int ring_right) {
  uf.reset();
  labels.assign(static_cast<size_t>(ch) * cw, -1);
  for (int64_t y = 0; y < ch; ++y) {
    const uint8_t* row = m + y * W;
    int32_t* lrow = labels.data() + y * cw;
    const int32_t* lup = lrow - cw;
    for (int64_t x = 0; x < cw; ++x) {
      if (row[x] != v) continue;
      int32_t lab = -1;
      if (x > 0 && lrow[x - 1] >= 0) lab = lrow[x - 1];
      if (y > 0) {
        if (lup[x] >= 0) {
          if (lab < 0)
            lab = lup[x];
          else
            uf.unite(lab, lup[x]);
        }
        if (x > 0 && lup[x - 1] >= 0) {
          if (lab < 0)
            lab = lup[x - 1];
          else
            uf.unite(lab, lup[x - 1]);
        }
        if (x + 1 < cw && lup[x + 1] >= 0) {
          if (lab < 0)
            lab = lup[x + 1];
          else
            uf.unite(lab, lup[x + 1]);
        }
      }
      if (lab < 0) lab = uf.make();
      lrow[x] = lab;
    }
  }
  // resolve + accumulate sizes and ring contact
  for (int64_t y = 0; y < ch; ++y) {
    int32_t* lrow = labels.data() + y * cw;
    for (int64_t x = 0; x < cw; ++x) {
      if (lrow[x] < 0) continue;
      int32_t r = uf.find(lrow[x]);
      lrow[x] = r;
      uf.size[r] += 1;
      if ((ring_top && y == 0) || (ring_bottom && y == ch - 1) ||
          (ring_left && x == 0) || (ring_right && x == cw - 1))
        uf.ring[r] = 1;
    }
  }
}

}  // namespace

extern "C" {

// Cleans masks[i] in place for every valid i. boxes are float32 xyxy in
// frame coordinates (AMG output). img_h/img_w bound the crop windows to
// the image's true extent inside the padded frame. For each mask:
//   changed[i] <- 1 if the mask was modified or flagged (reference
//                 semantics: the islands pass flags whenever ANY island is
//                 small, even if keep-largest leaves it identical)
//   out_boxes[i] <- xyxy box of the cleaned mask (frame coords, only when
//                 changed)
//   out_areas[i] <- final pixel count (only when changed)
// Returns the number of changed masks.
int64_t region_cleanup_batch(uint8_t* masks, int64_t P, int64_t H, int64_t W,
                             const float* boxes, const uint8_t* valid,
                             int64_t img_h, int64_t img_w, int64_t min_area,
                             uint8_t* changed, float* out_boxes,
                             int64_t* out_areas) {
  thread_local std::vector<int32_t> labels;
  thread_local UF uf;
  int64_t n_changed = 0;

  for (int64_t i = 0; i < P; ++i) {
    changed[i] = 0;
    if (!valid[i]) continue;
    const float* b = boxes + i * 4;
    int64_t bx0 = static_cast<int64_t>(b[0]);
    int64_t by0 = static_cast<int64_t>(b[1]);
    int64_t bx1 = static_cast<int64_t>(b[2]);
    int64_t by1 = static_cast<int64_t>(b[3]);
    int64_t y0 = by0 - 1 > 0 ? by0 - 1 : 0;
    int64_t x0 = bx0 - 1 > 0 ? bx0 - 1 : 0;
    int64_t y1 = by1 + 2 < img_h ? by1 + 2 : img_h;
    int64_t x1 = bx1 + 2 < img_w ? bx1 + 2 : img_w;
    if (y1 <= y0 || x1 <= x0) continue;
    int ring_top = by0 >= 1;
    int ring_bottom = by1 + 2 <= img_h;
    int ring_left = bx0 >= 1;
    int ring_right = bx1 + 2 <= img_w;
    int64_t ch = y1 - y0, cw = x1 - x0;
    uint8_t* crop = masks + (static_cast<int64_t>(i) * H + y0) * W + x0;

    // ---- holes: small non-ring background components become mask ----
    label_value(crop, W, ch, cw, 0, labels, uf, ring_top, ring_bottom,
                ring_left, ring_right);
    bool ch1 = false;
    {
      std::vector<uint8_t> fill(uf.parent.size(), 0);
      bool any = false;
      for (size_t r = 0; r < uf.parent.size(); ++r) {
        if (uf.parent[r] != static_cast<int32_t>(r)) continue;
        if (uf.size[r] > 0 && uf.size[r] < min_area && !uf.ring[r]) {
          fill[r] = 1;
          any = true;
        }
      }
      if (any) {
        for (int64_t y = 0; y < ch; ++y) {
          uint8_t* row = crop + y * W;
          const int32_t* lrow = labels.data() + y * cw;
          for (int64_t x = 0; x < cw; ++x)
            if (lrow[x] >= 0 && fill[lrow[x]]) row[x] = 1;
        }
        ch1 = true;
      }
    }

    // ---- islands: small mask components are dropped (keep raster-first
    // largest when all are small) ----
    label_value(crop, W, ch, cw, 1, labels, uf, 0, 0, 0, 0);
    bool ch2 = false;
    {
      bool any_small = false, any_kept = false;
      for (size_t r = 0; r < uf.parent.size(); ++r) {
        if (uf.parent[r] != static_cast<int32_t>(r) || uf.size[r] == 0)
          continue;
        if (uf.size[r] < min_area)
          any_small = true;
        else
          any_kept = true;
      }
      if (any_small) {
        ch2 = true;  // flagged even when the result is identical
        int32_t keep_only = -1;
        if (!any_kept) {
          // All small: keep the largest; ties go to the smallest root id
          // (raster-first — DETERMINISTIC, unlike the cv2 path, whose
          // np.argmax winner depends on cv2's implementation-defined BBDT
          // label order; the reference inherits the same arbitrariness.
          // Pinned by tests/test_postprocess_native.py:
          // test_allsmall_tie_native_rule.)
          int64_t best = -1;
          for (size_t r = 0; r < uf.parent.size(); ++r) {
            if (uf.parent[r] != static_cast<int32_t>(r) || uf.size[r] == 0)
              continue;
            if (uf.size[r] > best) {
              best = uf.size[r];
              keep_only = static_cast<int32_t>(r);
            }
          }
        }
        for (int64_t y = 0; y < ch; ++y) {
          uint8_t* row = crop + y * W;
          const int32_t* lrow = labels.data() + y * cw;
          for (int64_t x = 0; x < cw; ++x) {
            int32_t r = lrow[x];
            if (r < 0) continue;
            bool keep = keep_only >= 0 ? (r == keep_only)
                                       : (uf.size[r] >= min_area);
            if (!keep) row[x] = 0;
          }
        }
      }
    }

    if (ch1 || ch2) {
      changed[i] = 1;
      ++n_changed;
      // bbox + area of the cleaned mask (it lives inside the crop window)
      int64_t mnx = cw, mny = ch, mxx = -1, mxy = -1, area = 0;
      for (int64_t y = 0; y < ch; ++y) {
        const uint8_t* row = crop + y * W;
        for (int64_t x = 0; x < cw; ++x) {
          if (!row[x]) continue;
          ++area;
          if (x < mnx) mnx = x;
          if (x > mxx) mxx = x;
          if (y < mny) mny = y;
          if (y > mxy) mxy = y;
        }
      }
      float* ob = out_boxes + i * 4;
      if (mxx < 0) {
        ob[0] = ob[1] = ob[2] = ob[3] = 0.0f;
      } else {
        ob[0] = static_cast<float>(mnx + x0);
        ob[1] = static_cast<float>(mny + y0);
        ob[2] = static_cast<float>(mxx + x0);
        ob[3] = static_cast<float>(mxy + y0);
      }
      out_areas[i] = area;
    }
  }
  return n_changed;
}

}  // extern "C"
