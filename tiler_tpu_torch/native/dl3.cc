// Dennis Lee v3 color quantizer — fresh implementation of the semantics of
// the reference's dl3quant (reference dlquant/quantizer.c:437-663):
// histogram at lookup_bpc bits per component, then greedy pairwise merging
// of the two entries whose weighted mean-shift error is smallest, palette =
// rounded means of the survivors.
//
// The reference's merge bookkeeping (build_table3/recount_*/reduce_table3)
// tracks, per entry i, the best partner j>i only, repairs stale partners
// after each merge, and always merges the FIRST strict minimum in scan
// order. Those details determine the exact output palette and are
// reproduced so the merge order — and therefore the palette — matches.
//
// Layout: entries live in parallel arrays (SoA). The O(C^2) pair scans are
// two-pass — a branch-free SIMD-friendly error sweep into a scratch buffer,
// then a scalar first-strict-min scan (preserving the reference's tie
// order). Same arithmetic per pair as the AoS form, so results are
// bit-identical; the sweep auto-vectorizes under -O3 -march=native.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct Table {
  std::vector<int64_t> r, g, b, cnt;  // component sums + pixel count
  std::vector<int> rr, gg, bb;        // rounded means
  std::vector<float> err;             // best merge error with partner cc
  std::vector<int> cc;                // best partner index (cc > index)

  int size() const { return int(cnt.size()); }
  void reserve(size_t n) {
    r.reserve(n); g.reserve(n); b.reserve(n); cnt.reserve(n);
    rr.reserve(n); gg.reserve(n); bb.reserve(n);
    err.reserve(n); cc.reserve(n);
  }
  void push(int64_t rs, int64_t gs, int64_t bs, int64_t c) {
    r.push_back(rs); g.push_back(gs); b.push_back(bs); cnt.push_back(c);
    int64_t v2 = c >> 1;
    rr.push_back(int((rs + v2) / c));
    gg.push_back(int((gs + v2) / c));
    bb.push_back(int((bs + v2) / c));
    err.push_back(HUGE_VALF); cc.push_back(0);
  }
  void set_mean(int i) {
    int64_t v2 = cnt[i] >> 1;
    rr[i] = int((r[i] + v2) / cnt[i]);
    gg[i] = int((g[i] + v2) / cnt[i]);
    bb[i] = int((b[i] + v2) / cnt[i]);
  }
  void move(int dst, int src) {  // t[dst] = t[src]
    r[dst] = r[src]; g[dst] = g[src]; b[dst] = b[src]; cnt[dst] = cnt[src];
    rr[dst] = rr[src]; gg[dst] = gg[src]; bb[dst] = bb[src];
    err[dst] = err[src]; cc[dst] = cc[src];
  }
};

// Exact truncating int64 division via double with branch-free +-1
// correction: int64 hardware division dominates the O(C^2) pair scans; a
// double divide plus fixup is exact for the value ranges here (sums <
// 2^53), and the branchless form keeps the sweep vectorizable.
inline int64_t fast_div(int64_t num, int64_t den) {
  int64_t q = int64_t(double(num) / double(den));
  q -= int64_t(q * den > num);
  q += int64_t((q + 1) * den <= num);
  return q;
}

// fast_div with the divisor's reciprocal precomputed: the quotient estimate
// is within 1 of exact (num < 2^53, num/den <= 255, so the relative error
// of num*inv is far below 1), and the same +-1 fixup lands it. One divide
// per PAIR instead of three (the divide is the sweep's longest-latency op).
inline int64_t fast_div_inv(int64_t num, int64_t den, double inv) {
  int64_t q = int64_t(double(num) * inv);
  q -= int64_t(q * den > num);
  q += int64_t((q + 1) * den <= num);
  return q;
}

inline float pair_err(const Table& t, int64_t ar, int64_t ag, int64_t ab,
                      int64_t ac, int arr, int agg, int abb, int j) {
  int64_t p2 = t.cnt[j], p3 = ac + p2, h = p3 >> 1;
  double inv = 1.0 / double(p3);
  int r3 = int(fast_div_inv(ar + t.r[j] + h, p3, inv));
  int g3 = int(fast_div_inv(ag + t.g[j] + h, p3, inv));
  int b3 = int(fast_div_inv(ab + t.b[j] + h, p3, inv));
  float d1 = float((r3 - arr) * (r3 - arr) + (g3 - agg) * (g3 - agg) +
                   (b3 - abb) * (b3 - abb));
  float d2 = float((t.rr[j] - r3) * (t.rr[j] - r3) +
                   (t.gg[j] - g3) * (t.gg[j] - g3) +
                   (t.bb[j] - b3) * (t.bb[j] - b3));
  return sqrtf(d1) * float(ac) + sqrtf(d2) * float(p2);
}

inline float calc_err(const Table& t, int c1, int c2) {
  return pair_err(t, t.r[c1], t.g[c1], t.b[c1], t.cnt[c1],
                  t.rr[c1], t.gg[c1], t.bb[c1], c2);
}

// First strict minimum of buf[lo..hi): vectorizable two-pass form — a
// lane-wise min reduction (no NaNs occur here), then the first index
// holding the min. Identical result to the scalar first-strict-min scan.
inline int first_min_index(const float* buf, int lo, int hi, float* out_min) {
  float lanes[16];
  for (int l = 0; l < 16; l++) lanes[l] = HUGE_VALF;
  int j = lo;
  for (; j + 16 <= hi; j += 16)
    for (int l = 0; l < 16; l++)
      lanes[l] = std::min(lanes[l], buf[j + l]);
  float m = HUGE_VALF;
  for (int l = 0; l < 16; l++) m = std::min(m, lanes[l]);
  for (; j < hi; j++) m = std::min(m, buf[j]);
  *out_min = m;
  if (m == HUGE_VALF) return 0;
  for (j = lo; j < hi; j++)
    if (buf[j] == m) return j;
  return 0;
}

void recount_next(Table& t, int tot, int i, float* ebuf) {
  const int64_t ar = t.r[i], ag = t.g[i], ab = t.b[i], ac = t.cnt[i];
  const int arr = t.rr[i], agg = t.gg[i], abb = t.bb[i];
  // pass 1: branch-free error sweep (vectorizes)
  for (int j = i + 1; j < tot; j++)
    ebuf[j] = pair_err(t, ar, ag, ab, ac, arr, agg, abb, j);
  // pass 2: first strict minimum in scan order, as in recount_next
  float err;
  int c2 = first_min_index(ebuf, i + 1, tot, &err);
  t.err[i] = err;
  t.cc[i] = c2;
}

// pair_err with j fixed and i varying (the mirror of recount_next's sweep):
// d1 uses i's mean shift, d2 uses j's — matches calc_err(i, j) exactly.
void pair_err_imajor(const Table& t, int j, int n, float* ebuf) {
  const int64_t jr = t.r[j], jg = t.g[j], jb = t.b[j], jc = t.cnt[j];
  const int jrr = t.rr[j], jgg = t.gg[j], jbb = t.bb[j];
  for (int i = 0; i < n; i++) {
    int64_t p1 = t.cnt[i], p3 = p1 + jc, h = p3 >> 1;
    double inv = 1.0 / double(p3);
    int r3 = int(fast_div_inv(t.r[i] + jr + h, p3, inv));
    int g3 = int(fast_div_inv(t.g[i] + jg + h, p3, inv));
    int b3 = int(fast_div_inv(t.b[i] + jb + h, p3, inv));
    float d1 = float((r3 - t.rr[i]) * (r3 - t.rr[i]) +
                     (g3 - t.gg[i]) * (g3 - t.gg[i]) +
                     (b3 - t.bb[i]) * (b3 - t.bb[i]));
    float d2 = float((jrr - r3) * (jrr - r3) + (jgg - g3) * (jgg - g3) +
                     (jbb - b3) * (jbb - b3));
    ebuf[i] = sqrtf(d1) * float(p1) + sqrtf(d2) * float(jc);
  }
}

void recount_dist(Table& t, int tot, int c1, float* ebuf, float* ibuf) {
  recount_next(t, tot, c1, ebuf);
  // The reference walks i<c1 scalar, lazily evaluating calc_err(i,c1) per
  // row — the dominant cost of the merge loop (2*tot scalar pair errors
  // per merge). Two-pass form: a branch-free i-major error sweep into its
  // own buffer (vectorizes like recount_next's), then the compare/update
  // pass. calc_err(i,c1) depends only on rows i and c1, neither of which
  // the updates below touch, so precomputing every value is identical to
  // the lazy walk (recount_next rows reuse ebuf, not ibuf).
  pair_err_imajor(t, c1, c1, ibuf);
  for (int i = 0; i < c1; i++) {
    if (t.cc[i] == c1) {
      recount_next(t, tot, i, ebuf);
    } else {
      float e = ibuf[i];
      if (e < t.err[i]) { t.err[i] = e; t.cc[i] = c1; }
    }
  }
}

int reduce_entries(Table& t, int quant_to, uint8_t* out_pal, int max_out) {
  int tot = t.size();

  if (tot > quant_to) {
    std::vector<float> ebuf((size_t)tot), ibuf((size_t)tot);
    for (int i = 0; i < tot - 1; i++) recount_next(t, tot, i, ebuf.data());
    t.err[tot - 1] = HUGE_VALF;
    t.cc[tot - 1] = tot;

    while (tot > quant_to) {
      // first strict minimum in scan order, as in reduce_table3
      float err;
      int c1 = first_min_index(t.err.data(), 0, tot, &err);
      int c2 = t.cc[c1];
      t.r[c2] += t.r[c1]; t.g[c2] += t.g[c1]; t.b[c2] += t.b[c1];
      t.cnt[c2] += t.cnt[c1];
      t.set_mean(c2);
      tot--;
      t.move(c1, tot);
      t.err[tot - 1] = HUGE_VALF;
      t.cc[tot - 1] = tot;
      for (int i = 0; i < c1; i++) {
        if (t.cc[i] == tot) t.cc[i] = c1;
      }
      for (int i = c1 + 1; i < tot; i++) {
        if (t.cc[i] == tot) recount_next(t, tot, i, ebuf.data());
      }
      recount_dist(t, tot, c1, ebuf.data(), ibuf.data());
      if (c2 != tot) recount_dist(t, tot, c2, ebuf.data(), ibuf.data());
    }
  }

  for (int i = 0; i < tot && i < max_out; i++) {
    out_pal[i * 3 + 0] = uint8_t(t.rr[i]);
    out_pal[i * 3 + 1] = uint8_t(t.gg[i]);
    out_pal[i * 3 + 2] = uint8_t(t.bb[i]);
  }
  return tot < max_out ? tot : max_out;
}

// Sort-based histogram: bins in ascending bin-index order (identical to a
// dense-array sweep) without allocating+zeroing the 4x8B x 2^(3*bpc)
// dense tables (~64MB of memset per call at bpc=7 — it dominated the
// per-palette cost for typical pixel counts). Each pixel packs to
// bin_index<<24 | r<<16 | g<<8 | b in a u64; one sort + one run scan.
// LSD radix sort over the low `bits_used` bits: same ascending order as
// std::sort (radix is total on the used bits; the rest are zero), ~6x
// faster on the 0.25M-key histogram sorts that dominate per-palette cost.
void radix_sort_u64(std::vector<uint64_t>& v, int bits_used) {
  static thread_local std::vector<uint64_t> tmp;
  tmp.resize(v.size());
  const int passes = (bits_used + 7) / 8;
  for (int p = 0; p < passes; p++) {
    size_t cnt[257] = {0};
    const int sh = p * 8;
    for (uint64_t k : v) cnt[((k >> sh) & 0xff) + 1]++;
    for (int i = 0; i < 256; i++) cnt[i + 1] += cnt[i];
    for (uint64_t k : v) tmp[cnt[(k >> sh) & 0xff]++] = k;
    std::swap(v, tmp);
  }
}

void accumulate_runs(const std::vector<uint64_t>& keys, Table& t) {
  int64_t rs = 0, gs = 0, bs = 0, c = 0;
  uint64_t bin = keys[0] >> 24;
  for (size_t i = 0; i < keys.size(); i++) {
    uint64_t k = keys[i];
    if ((k >> 24) != bin) {
      t.push(rs, gs, bs, c);
      rs = gs = bs = c = 0;
      bin = k >> 24;
    }
    rs += (k >> 16) & 0xff; gs += (k >> 8) & 0xff; bs += k & 0xff; c++;
  }
  t.push(rs, gs, bs, c);
}

void histogram_into_table(const uint8_t* rgb, int64_t n_pixels,
                          int lookup_bpc, Table& t) {
  const int mbpc = (1 << lookup_bpc) - 1;
  std::vector<uint64_t> keys(static_cast<size_t>(n_pixels));
  for (int64_t i = 0; i < n_pixels; i++) {
    uint64_t r = rgb[i * 3 + 0], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
    uint64_t idx = (b * mbpc / 255) | ((g * mbpc / 255) << lookup_bpc) |
                   ((r * mbpc / 255) << (lookup_bpc * 2));
    keys[size_t(i)] = (idx << 24) | (r << 16) | (g << 8) | b;
  }
  radix_sort_u64(keys, 24 + 3 * lookup_bpc);
  accumulate_runs(keys, t);
}

// Same histogram but gathering pixels from whole 8x8 tiles of a global
// [N,8,8,3] array via an index list — avoids the caller materializing the
// gathered pixel copy.
void histogram_tiles_into_table(const uint8_t* tiles, const int32_t* sel,
                                int64_t n_sel, int lookup_bpc, Table& t) {
  const int mbpc = (1 << lookup_bpc) - 1;
  std::vector<uint64_t> keys(static_cast<size_t>(n_sel) * 64);
  size_t o = 0;
  for (int64_t s = 0; s < n_sel; s++) {
    const uint8_t* px = tiles + size_t(sel[s]) * 192;
    for (int i = 0; i < 64; i++) {
      uint64_t r = px[i * 3 + 0], g = px[i * 3 + 1], b = px[i * 3 + 2];
      uint64_t idx = (b * mbpc / 255) | ((g * mbpc / 255) << lookup_bpc) |
                     ((r * mbpc / 255) << (lookup_bpc * 2));
      keys[o++] = (idx << 24) | (r << 16) | (g << 8) | b;
    }
  }
  radix_sort_u64(keys, 24 + 3 * lookup_bpc);
  accumulate_runs(keys, t);
}

// Cap + reduce: when the table holds more than `cap` distinct bins, the
// long tail of rare bins pre-merges into its nearest high-count bin
// (squared-RGB on rounded means) before the exact greedy runs — bounding
// the O(C^2) pair scans. cap <= 0 disables capping.
int cap_and_reduce(Table& t, int quant_to, int cap, uint8_t* out_pal) {
  if (cap > 0 && t.size() > cap) {
    // order bins by count desc (stable: bin-index asc); keep the head
    const int n = t.size();
    std::vector<int> order((size_t)n);
    for (int i = 0; i < n; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return t.cnt[a] > t.cnt[b];
    });
    std::vector<char> kept(size_t(n), 0);
    std::vector<int> keep(order.begin(), order.begin() + cap);
    std::sort(keep.begin(), keep.end());  // ascending bin-index compaction
    for (int i : keep) kept[i] = 1;
    // SoA copies of the kept means for the vectorizable nearest scan
    const int kn = int(keep.size());
    std::vector<int> krr(kn), kgg(kn), kbb(kn);
    for (int j = 0; j < kn; j++) {
      krr[j] = t.rr[keep[j]]; kgg[j] = t.gg[keep[j]]; kbb[j] = t.bb[keep[j]];
    }
    // Nearest kept bin by squared RGB of rounded means, FIRST minimum in
    // keep[]-scan order on ties. Default path: exact 3D grid search
    // (16^3 cells of 16^3 color cubes, expanding chebyshev rings with a
    // conservative ring lower bound) — typically visits a few dozen kept
    // bins instead of all `cap`, and selects (dist, j) lexicographically
    // so ties resolve identically to the linear sweep. The linear sweep
    // stays selectable (TILER_DL3_LINEAR_PREMERGE=1) as the
    // cross-check oracle.
    const bool linear = std::getenv("TILER_DL3_LINEAR_PREMERGE") != nullptr;
    std::vector<int> cell_start, cell_items;
    if (!linear) {
      // bucket kept bins by color cell, preserving j (scan) order
      std::vector<int> counts(16 * 16 * 16 + 1, 0);
      auto cell_of = [&](int j) {
        return ((krr[j] >> 4) << 8) | ((kgg[j] >> 4) << 4) | (kbb[j] >> 4);
      };
      for (int j = 0; j < kn; j++) counts[cell_of(j) + 1]++;
      for (int c = 0; c < 16 * 16 * 16; c++) counts[c + 1] += counts[c];
      cell_start = counts;
      cell_items.resize((size_t)kn);
      std::vector<int> fill(cell_start.begin(), cell_start.end());
      for (int j = 0; j < kn; j++) cell_items[fill[cell_of(j)]++] = j;
    }
    if (!linear) {
      // Amortized per-cell ring search: tail bins sharing a color cell run
      // ONE shell expansion (to the max ring any of them needs). Each
      // query still sees every kept bin with d <= its best — a candidate
      // that could win or tie has ring lower bound <= d <= best, i.e. it
      // sits inside the shared expansion — so the (dist, j) lexicographic
      // winner is identical to the per-bin search; the shell enumeration
      // cost amortizes over all queries in the cell (it dominated on
      // noisy content with >100k tail bins).
      std::vector<int> tail;
      tail.reserve(size_t(n));
      for (int i = 0; i < n; i++)
        if (!kept[i]) tail.push_back(i);
      // bucket tail bins by cell, preserving index order
      std::vector<int> tstart(16 * 16 * 16 + 1, 0);
      auto tcell_of = [&](int i) {
        return ((t.rr[i] >> 4) << 8) | ((t.gg[i] >> 4) << 4) | (t.bb[i] >> 4);
      };
      for (int i : tail) tstart[tcell_of(i) + 1]++;
      for (int c = 0; c < 16 * 16 * 16; c++) tstart[c + 1] += tstart[c];
      std::vector<int> titems(tail.size());
      {
        std::vector<int> fill(tstart.begin(), tstart.end());
        for (int i : tail) titems[size_t(fill[tcell_of(i)]++)] = i;
      }
      std::vector<int32_t> best;
      std::vector<int> tj;
      for (int cell = 0; cell < 16 * 16 * 16; cell++) {
        const int q0 = tstart[cell], q1 = tstart[cell + 1];
        if (q0 == q1) continue;
        const int nq = q1 - q0;
        const int cr = cell >> 8, cg = (cell >> 4) & 15, cb = cell & 15;
        best.assign(size_t(nq), INT32_MAX);
        tj.assign(size_t(nq), -1);
        int32_t worst = INT32_MAX;
        for (int ring = 0; ring < 16; ring++) {
          // a ring-r cell differs by >= 16r-15 on some axis (queries sit
          // inside their own cell), so the ring's min distance^2 is
          // (16r-15)^2 — stop once that exceeds the worst per-query best
          if (ring >= 1) {
            const int32_t gap = 16 * ring - 15;
            if (int64_t(gap) * gap > worst) break;
          }
          const int r0 = std::max(0, cr - ring), r1 = std::min(15, cr + ring);
          const int g0 = std::max(0, cg - ring), g1 = std::min(15, cg + ring);
          const int b0 = std::max(0, cb - ring), b1 = std::min(15, cb + ring);
          for (int xr = r0; xr <= r1; xr++)
            for (int xg = g0; xg <= g1; xg++)
              for (int xb = b0; xb <= b1; xb++) {
                const int ch = std::max({std::abs(xr - cr), std::abs(xg - cg),
                                         std::abs(xb - cb)});
                if (ch != ring) continue;  // only the new shell
                const int c = (xr << 8) | (xg << 4) | xb;
                for (int p = cell_start[c]; p < cell_start[c + 1]; p++) {
                  const int j = cell_items[p];
                  const int jr = krr[j], jg = kgg[j], jb = kbb[j];
                  for (int q = 0; q < nq; q++) {
                    const int i = titems[size_t(q0 + q)];
                    const int32_t dr = t.rr[i] - jr, dg = t.gg[i] - jg,
                                  db = t.bb[i] - jb;
                    const int32_t d = dr * dr + dg * dg + db * db;
                    if (d < best[q] || (d == best[q] && j < tj[q])) {
                      best[q] = d;
                      tj[q] = j;
                    }
                  }
                }
              }
          worst = 0;
          for (int q = 0; q < nq; q++) worst = std::max(worst, best[q]);
        }
        for (int q = 0; q < nq; q++) {
          const int i = titems[size_t(q0 + q)];
          const int tgt = keep[tj[q]];
          t.r[tgt] += t.r[i]; t.g[tgt] += t.g[i]; t.b[tgt] += t.b[i];
          t.cnt[tgt] += t.cnt[i];
        }
      }
    } else {
      std::vector<int32_t> dbuf((size_t)kn);
      for (int i = 0; i < n; i++) {
        if (kept[i]) continue;
        const int irr = t.rr[i], igg = t.gg[i], ibb = t.bb[i];
        for (int j = 0; j < kn; j++) {
          int32_t dr = irr - krr[j], dg = igg - kgg[j], db = ibb - kbb[j];
          dbuf[j] = dr * dr + dg * dg + db * db;
        }
        int32_t best = INT32_MAX;
        for (int j = 0; j < kn; j++) best = std::min(best, dbuf[j]);
        int tj = 0;
        while (dbuf[tj] != best) tj++;
        int tgt = keep[tj];
        t.r[tgt] += t.r[i]; t.g[tgt] += t.g[i]; t.b[tgt] += t.b[i];
        t.cnt[tgt] += t.cnt[i];
      }
    }
    Table capped;
    capped.reserve(keep.size());
    for (int i : keep) {
      t.set_mean(i);
      capped.push(t.r[i], t.g[i], t.b[i], t.cnt[i]);
    }
    std::swap(t, capped);
  }
  return reduce_entries(t, quant_to, out_pal, quant_to);
}

}  // namespace

extern "C" {

int tiler_dl3_quant(const uint8_t* rgb, int64_t n_pixels, int quant_to,
                    int lookup_bpc, uint8_t* out_pal) {
  std::memset(out_pal, 0, size_t(quant_to) * 3);
  if (n_pixels <= 0 || lookup_bpc < 1 || lookup_bpc > 8) return 0;

  Table t;
  histogram_into_table(rgb, n_pixels, lookup_bpc, t);
  return reduce_entries(t, quant_to, out_pal, quant_to);
}


int tiler_dl3_quant_capped(const uint8_t* rgb, int64_t n_pixels,
                           int quant_to, int lookup_bpc, int cap,
                           uint8_t* out_pal) {
  std::memset(out_pal, 0, size_t(quant_to) * 3);
  if (n_pixels <= 0 || lookup_bpc < 1 || lookup_bpc > 8) return 0;
  Table t;
  histogram_into_table(rgb, n_pixels, lookup_bpc, t);
  return cap_and_reduce(t, quant_to, cap, out_pal);
}

// Tiles-gather form: pixels come from whole 8x8 tiles of the global
// [N,8,8,3] array selected by index — identical result to calling
// tiler_dl3_quant_capped on the gathered pixel copy, without the copy.
int tiler_dl3_quant_tiles_capped(const uint8_t* tiles, const int32_t* sel,
                                 int64_t n_sel, int quant_to,
                                 int lookup_bpc, int cap,
                                 uint8_t* out_pal) {
  std::memset(out_pal, 0, size_t(quant_to) * 3);
  if (n_sel <= 0 || lookup_bpc < 1 || lookup_bpc > 8) return 0;
  Table t;
  histogram_tiles_into_table(tiles, sel, n_sel, lookup_bpc, t);
  return cap_and_reduce(t, quant_to, cap, out_pal);
}

// Same greedy reduction but starting from pre-aggregated bins (sums +
// counts), in the given order. Lets the host cap the O(C^2) pair scans by
// pre-merging the long tail of rare bins before the exact greedy runs.
int tiler_dl3_quant_bins(const int64_t* r_sums, const int64_t* g_sums,
                         const int64_t* b_sums, const int64_t* counts,
                         int64_t n, int quant_to, uint8_t* out_pal) {
  std::memset(out_pal, 0, size_t(quant_to) * 3);
  Table t;
  t.reserve(size_t(n));
  for (int64_t i = 0; i < n; i++) {
    if (counts[i] <= 0) continue;
    t.push(r_sums[i], g_sums[i], b_sums[i], counts[i]);
  }
  return reduce_entries(t, quant_to, out_pal, quant_to);
}

}  // extern "C"
