// The C++ mask codec of the evaluation path: COCO's compressed RLE
// (pycocotools maskApi.c's rleEncode / rleDecode / rleToString /
// rleFrString: column-major runs starting with a zero-run, the counts
// string a 5-bit LEB varint with a 3-back delta), and run-space areas,
// intersections and IoUs, so that evaluation never decodes to dense masks,
// with COCOeval's greedy matching; masks are encoded a batch a call, from
// row-major masks or from their transposes (encode_masks_cm, which reads
// its bytes in order, eight at a time). A plain C ABI loaded through ctypes by
// sipmask_tpu_torch/native/__init__.py, which builds it with g++ at first
// use; sipmask_tpu_torch/eval/rle.py and eval/maskops.py keep the plain
// numpy versions that the tests hold it against, byte for byte.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 maskops.cpp -o libmaskops.so

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RLE <-> mask
// ---------------------------------------------------------------------------

// Encode a row-major (h, w) {0,1} mask into column-major run lengths.
// Returns the number of runs written, or -1 if `cap` is too small.
// Runs alternate zero-run, one-run, ... (first run may be 0).
int runs_from_mask(const uint8_t* mask, int h, int w,
                   uint32_t* runs, int cap) {
  int n = 0;
  uint32_t cur = 0;
  uint8_t val = 0;  // runs start counting zeros
  for (int x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;  // stride h between column elements is w
    for (int y = 0; y < h; ++y) {
      uint8_t v = col[(int64_t)y * w] != 0;
      if (v == val) {
        ++cur;
      } else {
        if (n >= cap) return -1;
        runs[n++] = cur;
        cur = 1;
        val = v;
      }
    }
  }
  if (n >= cap) return -1;
  runs[n++] = cur;
  return n;
}

// Decode run lengths into a row-major (h, w) mask. Returns 0 on success.
int mask_from_runs(const uint32_t* runs, int n_runs, int h, int w,
                   uint8_t* mask) {
  int64_t pos = 0;
  const int64_t total = (int64_t)h * w;
  uint8_t val = 0;
  for (int i = 0; i < n_runs; ++i) {
    int64_t end = pos + runs[i];
    if (end > total) end = total;
    if (val) {
      for (int64_t p = pos; p < end; ++p) {
        // column-major position p -> row-major (y, x) = (p % h, p / h)
        mask[(p % h) * (int64_t)w + (p / h)] = 1;
      }
    }
    pos = end;
    val ^= 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// RLE string codec (COCO "counts" format: 5-bit LEB with 3-back delta)
// ---------------------------------------------------------------------------

// Returns string length, or -1 if `cap` too small.
int string_from_runs(const uint32_t* runs, int n_runs, char* out, int cap) {
  int len = 0;
  for (int i = 0; i < n_runs; ++i) {
    int64_t x = (int64_t)runs[i];
    if (i > 2) x -= (int64_t)runs[i - 2];
    bool more = true;
    while (more) {
      int c = (int)(x & 0x1f);
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (len >= cap) return -1;
      out[len++] = (char)(c + 48);
    }
  }
  return len;
}

// Returns number of runs, or -1 if `cap` too small.
int runs_from_string(const char* s, int len, uint32_t* runs, int cap) {
  int n = 0;
  int i = 0;
  while (i < len) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    int c = 0;
    while (more && i < len) {
      c = s[i] - 48;
      x |= (int64_t)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
    }
    if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    if (n > 2) x += (int64_t)runs[n - 2];
    if (n >= cap) return -1;
    runs[n++] = (uint32_t)x;
  }
  return n;
}

// Convenience: encode mask straight to a counts string.
// Returns string length or -1 on overflow.
int encode_mask(const uint8_t* mask, int h, int w, char* out, int cap) {
  std::vector<uint32_t> runs((size_t)h * w + 1);
  int n = runs_from_mask(mask, h, w, runs.data(), (int)runs.size());
  if (n < 0) return -1;
  return string_from_runs(runs.data(), n, out, cap);
}

// ---------------------------------------------------------------------------
// Run-space geometry
// ---------------------------------------------------------------------------

int64_t area_from_runs(const uint32_t* runs, int n_runs) {
  int64_t a = 0;
  for (int i = 1; i < n_runs; i += 2) a += runs[i];
  return a;
}

// Intersection of two run-encoded masks in O(na + nb): two-pointer sweep
// over the one-intervals implied by the runs.
static int64_t runs_intersection(const uint32_t* a, int na,
                                 const uint32_t* b, int nb) {
  int64_t inter = 0;
  int ia = 1, ib = 1;  // odd indices are one-runs
  int64_t sa = (na > 0) ? (int64_t)a[0] : 0;  // start of current one-run
  int64_t sb = (nb > 0) ? (int64_t)b[0] : 0;
  while (ia < na && ib < nb) {
    int64_t ea = sa + a[ia];
    int64_t eb = sb + b[ib];
    int64_t lo = sa > sb ? sa : sb;
    int64_t hi = ea < eb ? ea : eb;
    if (hi > lo) inter += hi - lo;
    if (ea <= eb) {
      sa = ea + ((ia + 1 < na) ? (int64_t)a[ia + 1] : 0);
      ia += 2;
    } else {
      sb = eb + ((ib + 1 < nb) ? (int64_t)b[ib + 1] : 0);
      ib += 2;
    }
  }
  return inter;
}

// IoU matrix between two batches of run-encoded masks.
// dt/gt runs are concatenated with prefix offsets (offs has n+1 entries).
// iscrowd: per-gt flag; crowd IoU = inter / area_dt (the COCO convention).
// out: (n_dt, n_gt) row-major doubles.
void rle_iou_matrix(const uint32_t* dt_runs, const int64_t* dt_offs, int n_dt,
                    const uint32_t* gt_runs, const int64_t* gt_offs, int n_gt,
                    const uint8_t* iscrowd, double* out) {
  std::vector<int64_t> dt_area(n_dt), gt_area(n_gt);
  for (int i = 0; i < n_dt; ++i)
    dt_area[i] = area_from_runs(dt_runs + dt_offs[i],
                                (int)(dt_offs[i + 1] - dt_offs[i]));
  for (int j = 0; j < n_gt; ++j)
    gt_area[j] = area_from_runs(gt_runs + gt_offs[j],
                                (int)(gt_offs[j + 1] - gt_offs[j]));
  for (int i = 0; i < n_dt; ++i) {
    const uint32_t* a = dt_runs + dt_offs[i];
    int na = (int)(dt_offs[i + 1] - dt_offs[i]);
    for (int j = 0; j < n_gt; ++j) {
      const uint32_t* b = gt_runs + gt_offs[j];
      int nb = (int)(gt_offs[j + 1] - gt_offs[j]);
      double denom;
      int64_t inter = runs_intersection(a, na, b, nb);
      if (iscrowd && iscrowd[j]) {
        denom = (double)dt_area[i];
      } else {
        denom = (double)(dt_area[i] + gt_area[j] - inter);
      }
      out[(int64_t)i * n_gt + j] = denom > 0 ? (double)inter / denom : 0.0;
    }
  }
}

// Raw intersection-area matrix between two batches of run-encoded masks
// (same layout as rle_iou_matrix). Used for spatio-temporal track IoU where
// intersections/areas are accumulated over frames before dividing.
void rle_inter_matrix(const uint32_t* dt_runs, const int64_t* dt_offs,
                      int n_dt, const uint32_t* gt_runs,
                      const int64_t* gt_offs, int n_gt, double* out) {
  for (int i = 0; i < n_dt; ++i) {
    const uint32_t* a = dt_runs + dt_offs[i];
    int na = (int)(dt_offs[i + 1] - dt_offs[i]);
    for (int j = 0; j < n_gt; ++j) {
      const uint32_t* b = gt_runs + gt_offs[j];
      int nb = (int)(gt_offs[j + 1] - gt_offs[j]);
      out[(int64_t)i * n_gt + j] = (double)runs_intersection(a, na, b, nb);
    }
  }
}

// Batched encode: n row-major (h, w) masks -> counts strings packed into
// `out` with prefix offsets out_offs (n+1 entries, out_offs[0] must be 0 on
// entry). Returns 0 on success, -1 if out_cap too small.
int encode_masks(const uint8_t* masks, int n, int h, int w,
                 char* out, int64_t out_cap, int64_t* out_offs) {
  int64_t pos = 0;
  for (int i = 0; i < n; ++i) {
    int len = encode_mask(masks + (int64_t)i * h * w, h, w, out + pos,
                          (int)(out_cap - pos));
    if (len < 0) return -1;
    pos += len;
    out_offs[i + 1] = pos;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Column-major masks (the evaluation path's device transposes its pasted
// masks before the copy to the host)
// ---------------------------------------------------------------------------

// Runs of `total` bytes of one mask stored column-major (x-major: the
// transpose of the row-major (h, w) mask), the same runs as
// runs_from_mask gives for the row-major mask. Bytes are read in order,
// eight at a time while they all hold the current run's value as 0 or 1
// (any non-zero byte is a one). Returns the number of runs, or -1 if `cap`
// is too small.
static int runs_from_mask_cm(const uint8_t* m, int64_t total,
                             uint32_t* runs, int cap) {
  const uint64_t kOnes = 0x0101010101010101ull;
  int n = 0;
  int64_t p = 0, start = 0;
  uint8_t val = 0;  // runs start counting zeros
  for (;;) {
    const uint64_t pattern = val ? kOnes : 0ull;
    for (;;) {
      while (p + 8 <= total) {
        uint64_t word;
        std::memcpy(&word, m + p, 8);
        if (word != pattern) break;
        p += 8;
      }
      if (p < total && (m[p] != 0) == val) {
        ++p;
        continue;
      }
      break;
    }
    if (n >= cap) return -1;
    runs[n++] = (uint32_t)(p - start);
    if (p >= total) return n;
    start = p;
    val ^= 1;
  }
}

// Batched encode of n column-major masks, each (w, h): the transposes of
// row-major (h, w) masks, giving the bytes encode_masks gives for those.
// Counts strings packed into `out` with prefix offsets out_offs (n+1
// entries, out_offs[0] must be 0 on entry). Returns 0 on success, -1 if
// out_cap is too small.
int encode_masks_cm(const uint8_t* masks, int n, int h, int w, char* out,
                    int64_t out_cap, int64_t* out_offs) {
  const int64_t total = (int64_t)h * w;
  std::vector<uint32_t> runs((size_t)total + 1);
  int64_t pos = 0;
  for (int i = 0; i < n; ++i) {
    int nr = runs_from_mask_cm(masks + (int64_t)i * total, total,
                               runs.data(), (int)runs.size());
    if (nr < 0) return -1;
    int64_t room = out_cap - pos;
    int len = string_from_runs(runs.data(), nr, out + pos,
                               room < INT32_MAX ? (int)room : INT32_MAX);
    if (len < 0) return -1;
    pos += len;
    out_offs[i + 1] = pos;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// COCO greedy matching (the COCOeval evaluateImg inner loop)
// ---------------------------------------------------------------------------

// For each IoU threshold t and each detection (score-descending order),
// greedily pick the best still-unmatched gt (crowd gts stay matchable);
// prefer non-ignored gts (stop scanning once only ignored remain after a
// non-ignored match). Mirrors pycocotools' evaluateImg matching semantics.
//
// ious: (n_dt, n_gt) row-major, gt columns already sorted ignore-last.
// gt_ig / iscrowd: per-gt flags. thrs: (n_thr,).
// Outputs (row-major): dtm (n_thr, n_dt) int32 1-based gt match (0 = none),
// dt_ig (n_thr, n_dt) uint8.
void greedy_match(const double* ious, int n_dt, int n_gt,
                  const double* thrs, int n_thr,
                  const uint8_t* gt_ig, const uint8_t* iscrowd,
                  int32_t* dtm, uint8_t* dt_ig) {
  std::vector<int32_t> gtm(n_gt);
  for (int ti = 0; ti < n_thr; ++ti) {
    std::fill(gtm.begin(), gtm.end(), 0);
    for (int di = 0; di < n_dt; ++di) {
      double best = thrs[ti] < 1.0 - 1e-10 ? thrs[ti] : 1.0 - 1e-10;
      int m = -1;
      for (int gi = 0; gi < n_gt; ++gi) {
        if (gtm[gi] > 0 && !iscrowd[gi]) continue;
        if (m > -1 && !gt_ig[m] && gt_ig[gi]) break;
        double v = ious[(int64_t)di * n_gt + gi];
        if (v < best) continue;
        best = v;
        m = gi;
      }
      int64_t o = (int64_t)ti * n_dt + di;
      if (m == -1) {
        dtm[o] = 0;
        dt_ig[o] = 0;
      } else {
        dtm[o] = m + 1;
        dt_ig[o] = gt_ig[m];
        gtm[m] = di + 1;
      }
    }
  }
}

}  // extern "C"
