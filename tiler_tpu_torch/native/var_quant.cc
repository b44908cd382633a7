// Value-at-Risk palette quantizer (DoValueAtRiskBased, reference
// main.pas:2256-2394): the semantics of ops/palette.var_palette, which the
// CPU tests hold this code to byte for byte.
//
// One group's used colours, sorted by count desc, hue, val, sat and packed
// value (CompareCMUCntHLS, a stable sort as numpy's lexsort), are merged
// pairwise: always the adjacent pair with the smallest ColorCompare, from a
// heap ordered by (distance, insertion sequence) whose entries are lazily
// invalidated by per-node versions; a merge folds the earlier node into
// the later one as count-weighted floor averages of HSV and luma, and the
// loop stops once the survivors reach the CmlPct position or two successive
// minima are equal. The palette samples the survivors along the group's
// gPalettePattern row, rounding half to even as np.round does.
//
// The functions take plain arrays and hold no global state, so the ctypes
// binding releases the interpreter lock for the whole call and the Dither
// quantize pool's threads run side by side.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

namespace {

// integer HSV (main.pas:3496-3543), as color.rgb_to_hsv_int_np
int64_t muldiv(int64_t a, int64_t b, int64_t c) {
  int64_t p = a * b;
  int64_t sign = p < 0 ? -1 : 1;
  int64_t m = p < 0 ? -p : p;
  return sign * ((m + c / 2) / c);
}

void rgb_to_hsv(int64_t r, int64_t g, int64_t b, int64_t* h, int64_t* s,
                int64_t* v) {
  int64_t mx = std::max(std::max(r, g), b);
  int64_t mn = std::min(std::min(r, g), b);
  int64_t delta = mx - mn;
  *v = mx & 0xff;
  if (delta == 0) {
    *h = 0;
    *s = 0;
    return;
  }
  *s = muldiv(delta, 255, mx) & 0xff;
  int64_t hh;
  if (r == mx)
    hh = muldiv(g - b, 42, delta);
  else if (g == mx)
    hh = muldiv(b - r, 42, delta) + 84;
  else
    hh = muldiv(r - g, 42, delta) + 168;
  // np.fmod keeps the dividend's sign; the low byte of its two's complement
  *h = (hh % 252) & 0xff;
}

// integer HSV -> RGB (main.pas:3545-3579), as color.hsv_to_rgb_int_np; every
// quotient is of non-negative integers
void hsv_to_rgb(int64_t h, int64_t s, int64_t v, int64_t* r, int64_t* g,
                int64_t* b) {
  h %= 252;
  if (s == 0) {
    *r = *g = *b = v;
    return;
  }
  int64_t f = h % 42, hi = h / 42, ls = v * s;
  int64_t p = v - ls / 255;
  int64_t q = v - (ls * f) / (255 * 42);
  int64_t t = v - (ls * (42 - f)) / (255 * 42);
  switch (hi) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
  *r &= 0xff;
  *g &= 0xff;
  *b &= 0xff;
}

// ColorCompare (main.pas:1557-1571) of rgb1 against rgb2; the luma
// difference's quotient truncates toward zero
int64_t color_compare(int64_t r1, int64_t g1, int64_t b1, int64_t r2,
                      int64_t g2, int64_t b2) {
  int64_t ld = (r1 * 2126 + g1 * 7152 + b1 * 722)
               - (r2 * 2126 + g2 * 7152 + b2 * 722);
  int64_t lumadiff = ld / 10000;
  int64_t dr = r1 - r2, dg = g1 - g2, db = b1 - b2;
  return (dr * dr + dg * dg + db * db) * 13 + lumadiff * lumadiff * 32;
}

// a heap entry: (distance << 40 | insertion sequence) orders it, the
// distance being < 2^23; p and j the pair, vp and vj their versions then
struct Entry {
  uint64_t key;
  int32_t p, j, vp, vj;
  bool operator>(const Entry& o) const { return key > o.key; }
};

// one colour of the list, in list order
struct Node {
  int64_t cnt;
  int32_t prv, nxt, ver;
  uint32_t idx;               // packed r | g << 8 | b << 16
  int32_t h, s, v, lum;
  uint8_t r, g, b, dead;
};

// the quantizer on a histogram: cols[n] packed r|g<<8|b<<16, counts[n];
// writes tile_palette_size packed entries to out and returns the merges
int64_t var_core(const uint32_t* cols, const int64_t* counts, int64_t n,
                 int64_t total_budget, double pal_var, int tile_palette_size,
                 int palette_count, const double* pattern_row,
                 uint32_t* out) {
  std::memset(out, 0, sizeof(uint32_t) * size_t(tile_palette_size));
  if (n <= 0) return 0;

  // one 128-bit key a colour, ascending in (count desc, hue, val, sat,
  // packed), with the input position last so that the order is total, as
  // numpy's stable lexsort: count < 2^40 (bits 88-127, inverted), hue, val
  // and sat (64-87), packed (40-63), position < 2^40 (0-39)
  typedef unsigned __int128 u128;
  const uint64_t kLow40 = (uint64_t(1) << 40) - 1;
  std::vector<u128> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t h, s, v;
    rgb_to_hsv(cols[i] & 0xff, (cols[i] >> 8) & 0xff, (cols[i] >> 16) & 0xff,
               &h, &s, &v);
    uint64_t hi = (kLow40 - uint64_t(counts[i])) << 24
                  | uint64_t(h << 16 | v << 8 | s);
    uint64_t lo = uint64_t(cols[i] & 0xffffff) << 40 | uint64_t(i);
    keys[i] = u128(hi) << 64 | lo;
  }
  std::sort(keys.begin(), keys.end());

  std::vector<Node> node(n);
  for (int64_t k = 0; k < n; ++k) {
    uint64_t hi = uint64_t(keys[k] >> 64), lo = uint64_t(keys[k]);
    Node& x = node[k];
    x.cnt = counts[lo & kLow40];
    x.h = int32_t(hi >> 16 & 0xff);
    x.v = int32_t(hi >> 8 & 0xff);
    x.s = int32_t(hi & 0xff);
    x.idx = uint32_t(lo >> 40);
    x.r = uint8_t(x.idx);
    x.g = uint8_t(x.idx >> 8);
    x.b = uint8_t(x.idx >> 16);
    x.lum = (x.r * 2126 + x.g * 7152 + x.b * 722) / 10000;
    x.prv = int32_t(k - 1);
    x.nxt = int32_t(k + 1);
    x.ver = 0;
    x.dead = 0;
  }
  std::vector<u128>().swap(keys);

  // CmlPct: the first position whose cumulative count reaches
  // round(total_budget * pal_var), half to even as Python's round
  int64_t acc = int64_t(std::nearbyint(double(total_budget) * pal_var));
  int64_t cml = 0, csum = 0;
  for (int64_t i = 0; i < n; ++i) {
    csum += node[i].cnt;
    if (csum >= acc) {
      cml = i;
      break;
    }
  }
  cml = std::max(cml, std::min(n, int64_t(tile_palette_size)
                                      * int64_t(palette_count)));

  auto dist = [&](int64_t p, int64_t j) {
    const Node &a = node[j], &b = node[p];
    return uint64_t(color_compare(a.r, a.g, a.b, b.r, b.g, b.b));
  };
  std::vector<Entry> init;
  init.reserve(size_t(n));
  for (int64_t p = 0; p + 1 < n; ++p)
    init.push_back({dist(p, p + 1) << 40 | uint64_t(p), int32_t(p),
                    int32_t(p + 1), 0, 0});
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap(
      std::greater<Entry>(), std::move(init));
  uint64_t seq = uint64_t(n - 1);
  auto push_pair = [&](int64_t p, int64_t j) {
    if (p < 0 || j >= n) return;
    heap.push({dist(p, j) << 40 | seq, int32_t(p), int32_t(j), node[p].ver,
               node[j].ver});
    ++seq;
  };

  int64_t alive = n, merges = 0;
  uint64_t prev_best = 0;
  bool have_prev = false;
  while (alive > cml) {
    while (!heap.empty()) {
      const Entry& e = heap.top();
      if (node[e.p].ver == e.vp && node[e.j].ver == e.vj
          && node[e.p].nxt == e.j)
        break;
      heap.pop();
    }
    if (heap.empty()) break;
    Entry e = heap.top();
    uint64_t d = e.key >> 40;
    if (have_prev && d == prev_best) break;  // until best = PrevBest
    prev_best = d;
    have_prev = true;
    heap.pop();

    // merge p (earlier) into j, weighted by counts (main.pas:2375-2382)
    Node &p = node[e.p], &j = node[e.j];
    int64_t acc2 = j.cnt + p.cnt;
    j.h = int32_t((j.h * j.cnt + p.h * p.cnt) / acc2);
    j.s = int32_t((j.s * j.cnt + p.s * p.cnt) / acc2);
    j.v = int32_t((j.v * j.cnt + p.v * p.cnt) / acc2);
    j.lum = int32_t((j.lum * j.cnt + p.lum * p.cnt) / acc2);
    j.cnt = acc2;
    int64_t r, g, b;
    hsv_to_rgb(j.h, j.s, j.v, &r, &g, &b);
    j.r = uint8_t(r);
    j.g = uint8_t(g);
    j.b = uint8_t(b);
    j.idx = uint32_t(r | g << 8 | b << 16);
    ++j.ver;
    ++p.ver;
    int32_t pp = p.prv;
    if (pp >= 0) node[pp].nxt = e.j;
    j.prv = pp;
    p.dead = 1;
    --alive;
    ++merges;
    push_pair(pp, e.j);
    if (j.nxt < n) push_pair(e.j, j.nxt);
  }

  std::vector<int64_t> surv;
  surv.reserve(size_t(alive));
  for (int64_t k = 0; k < n; ++k)
    if (!node[k].dead) surv.push_back(k);
  int64_t last = int64_t(surv.size()) - 1;
  for (int i = 0; i < tile_palette_size; ++i) {
    int64_t pos = int64_t(std::nearbyint(pattern_row[i] * double(last)));
    pos = std::min(std::max(pos, int64_t(0)), last);
    out[i] = node[surv[pos]].idx;
  }
  return merges;
}

}  // namespace

extern "C" {

// VAR palette of a histogram: cols[n] packed colours, counts[n] their uses.
// stats[0] = colours, stats[1] = merges.
void tiler_var_quant(const uint32_t* cols, const int64_t* counts, int64_t n,
                     int64_t total_budget, double pal_var,
                     int tile_palette_size, int palette_count,
                     const double* pattern_row, uint32_t* out,
                     int64_t* stats) {
  stats[0] = n > 0 ? n : 0;
  stats[1] = var_core(cols, counts, n, total_budget, pal_var,
                      tile_palette_size, palette_count, pattern_row, out);
}

// VAR palette of the pixels of tiles[sel] ([N,8,8,3] uint8): the histogram
// (np.unique of the packed pixels) is made here too.
void tiler_var_quant_tiles(const uint8_t* tiles, const int32_t* sel,
                           int64_t n_sel, int64_t total_budget,
                           double pal_var, int tile_palette_size,
                           int palette_count, const double* pattern_row,
                           uint32_t* out, int64_t* stats) {
  std::vector<uint32_t> px(size_t(n_sel) * 64);
  for (int64_t t = 0; t < n_sel; ++t) {
    const uint8_t* src = tiles + int64_t(sel[t]) * 192;
    uint32_t* dst = px.data() + t * 64;
    for (int i = 0; i < 64; ++i)
      dst[i] = uint32_t(src[3 * i]) | (uint32_t(src[3 * i + 1]) << 8)
               | (uint32_t(src[3 * i + 2]) << 16);
  }
  // three 8-bit LSD radix passes sort the 24-bit packed pixels
  std::vector<uint32_t> tmp(px.size());
  for (int shift = 0; shift < 24; shift += 8) {
    size_t bucket[257] = {0};
    for (uint32_t c : px) ++bucket[((c >> shift) & 0xff) + 1];
    for (int i = 0; i < 256; ++i) bucket[i + 1] += bucket[i];
    for (uint32_t c : px) tmp[bucket[(c >> shift) & 0xff]++] = c;
    px.swap(tmp);
  }
  std::vector<uint32_t> cols;
  std::vector<int64_t> counts;
  for (size_t i = 0; i < px.size();) {
    size_t k = i;
    while (k < px.size() && px[k] == px[i]) ++k;
    cols.push_back(px[i]);
    counts.push_back(int64_t(k - i));
    i = k;
  }
  tiler_var_quant(cols.data(), counts.data(), int64_t(cols.size()),
                  total_budget, pal_var, tile_palette_size, palette_count,
                  pattern_row, out, stats);
}

}  // extern "C"
