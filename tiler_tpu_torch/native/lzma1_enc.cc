// LZMA1 ("alone"-format) ENCODER supporting the full lc 0..8 range.
//
// Why this exists: the reference's save path spawns
// `lzma.exe e src dst -lc8 -eos` per keyframe
// (reference extern.pas:202-240, flags at :224) — lc=8 models each
// byte on the FULL previous byte, which fits the GTM command stream's
// palette-index-heavy data. liblzma enforces lc+lp<=4 and cannot encode
// that, so round 2 shipped lc=3 streams. This is a fresh implementation
// of the public LZMA specification's encode side (range coder + adaptive
// bit-tree models + hash-chain match finder with lazy matching), the
// companion of the decoder in lzma1.cc — not a port of the 7-Zip SDK.
//
// Framing matches `-eos`: 13-byte LZMA-alone header (props, dict dword,
// unknown-size 0xFF..FF) + range-coded stream terminated by the
// dist=0xFFFFFFFF end marker, so the bundled JS player's per-stream
// header re-read (reference decoders/htmljs/lzma.js:692-721)
// accepts it.
//
// C API (ctypes-friendly):
//   tiler_lzma_encode_alone(src, n, lc, lp, pb, depth, nice_len,
//                           &out_len, &status)
//     -> malloc'd stream (caller frees with tiler_free)

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

using std::ptrdiff_t;

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr int kNumBitModelTotalBits = 11;
constexpr uint16_t kBitModelTotal = 1 << kNumBitModelTotalBits;
constexpr int kNumMoveBits = 5;
constexpr int kNumStates = 12;
constexpr int kNumPosBitsMax = 4;
constexpr int kEndPosModelIndex = 14;
constexpr int kNumFullDistances = 1 << (kEndPosModelIndex >> 1);
constexpr int kNumAlignBits = 4;
constexpr int kMatchMinLen = 2;
constexpr int kMatchMaxLen = kMatchMinLen + 271;  // 273

struct RangeEncoder {
  std::vector<uint8_t>* out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;

  void shift_low() {
    if (uint32_t(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = uint8_t(low >> 32);
      uint8_t temp = cache;
      do {
        out->push_back(uint8_t(temp + carry));
        temp = 0xFF;
      } while (--cache_size != 0);
      cache = uint8_t(low >> 24);
    }
    cache_size++;
    low = (low & 0x00FFFFFFu) << 8;
  }
  void encode_bit(uint16_t* prob, int bit) {
    uint32_t bound = (range >> kNumBitModelTotalBits) * *prob;
    if (!bit) {
      range = bound;
      *prob += (kBitModelTotal - *prob) >> kNumMoveBits;
    } else {
      low += bound;
      range -= bound;
      *prob -= *prob >> kNumMoveBits;
    }
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }
  void encode_direct(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) {
      range >>= 1;
      if ((v >> i) & 1) low += range;
      while (range < kTop) {
        range <<= 8;
        shift_low();
      }
    }
  }
  void bit_tree_encode(uint16_t* probs, int num_bits, unsigned sym) {
    unsigned m = 1;
    for (int i = num_bits - 1; i >= 0; i--) {
      unsigned bit = (sym >> i) & 1;
      encode_bit(&probs[m], bit);
      m = (m << 1) | bit;
    }
  }
  void bit_tree_reverse_encode(uint16_t* probs, int num_bits, unsigned sym) {
    unsigned m = 1;
    for (int i = 0; i < num_bits; i++) {
      unsigned bit = sym & 1;
      sym >>= 1;
      encode_bit(&probs[m], bit);
      m = (m << 1) | bit;
    }
  }
  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

struct LenEncoder {
  uint16_t choice, choice2;
  uint16_t low[1 << kNumPosBitsMax][8];
  uint16_t mid[1 << kNumPosBitsMax][8];
  uint16_t high[256];

  void init() {
    choice = choice2 = kBitModelTotal / 2;
    for (auto& t : low)
      for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& t : mid)
      for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : high) p = kBitModelTotal / 2;
  }
  void encode(RangeEncoder& rc, unsigned len, unsigned pos_state) {
    // len is the coded value (actual - kMatchMinLen), 0..271
    if (len < 8) {
      rc.encode_bit(&choice, 0);
      rc.bit_tree_encode(low[pos_state], 3, len);
    } else if (len < 16) {
      rc.encode_bit(&choice, 1);
      rc.encode_bit(&choice2, 0);
      rc.bit_tree_encode(mid[pos_state], 3, len - 8);
    } else {
      rc.encode_bit(&choice, 1);
      rc.encode_bit(&choice2, 1);
      rc.bit_tree_encode(high, 8, len - 16);
    }
  }
};

inline unsigned pos_slot_of(uint32_t dist) {
  if (dist < 4) return dist;
  int log = 31 - __builtin_clz(dist);
  return unsigned((log << 1) | ((dist >> (log - 1)) & 1));
}

// -- bit prices (for the optimal parse) -----------------------------------
//
// price(prob, bit) = -log2(P(bit)) in 1/16-bit units, exact to rounding
// (a full 2048-entry table; no need for the SDK's 128-entry quantization).

struct PriceTable {
  uint32_t p[kBitModelTotal];
  PriceTable() {
    p[0] = p[kBitModelTotal - 1] = 0;  // unreachable guards
    for (int q = 1; q < kBitModelTotal; q++)
      p[q] = uint32_t(
          std::lround(-std::log2(double(q) / kBitModelTotal) * 16.0));
  }
};
const PriceTable g_price_table;

inline uint32_t prc(uint16_t prob, int bit) {
  return g_price_table.p[bit ? (kBitModelTotal - prob) : prob];
}

inline uint32_t tree_price(const uint16_t* probs, int num_bits,
                           unsigned sym) {
  uint32_t price = 0;
  unsigned m = 1;
  for (int i = num_bits - 1; i >= 0; i--) {
    unsigned bit = (sym >> i) & 1;
    price += prc(probs[m], bit);
    m = (m << 1) | bit;
  }
  return price;
}

inline uint32_t rev_tree_price(const uint16_t* probs, int num_bits,
                               unsigned sym) {
  uint32_t price = 0;
  unsigned m = 1;
  for (int i = 0; i < num_bits; i++) {
    unsigned bit = sym & 1;
    sym >>= 1;
    price += prc(probs[m], bit);
    m = (m << 1) | bit;
  }
  return price;
}

inline uint32_t len_price_of(const LenEncoder& le, unsigned len_coded,
                             unsigned pos_state) {
  if (len_coded < 8)
    return prc(le.choice, 0) + tree_price(le.low[pos_state], 3, len_coded);
  if (len_coded < 16)
    return prc(le.choice, 1) + prc(le.choice2, 0) +
           tree_price(le.mid[pos_state], 3, len_coded - 8);
  return prc(le.choice, 1) + prc(le.choice2, 1) +
         tree_price(le.high, 8, len_coded - 16);
}

// -- hash-chain match finder ---------------------------------------------

struct MatchFinder {
  const uint8_t* buf;
  size_t n;
  int depth;
  unsigned nice_len;
  size_t max_dist;  // declared dict size: never emit a farther match
  std::vector<int32_t> head4, head3, head2, prev;

  static constexpr int kH4Bits = 17;
  static constexpr int kH3Bits = 16;
  static constexpr int kH2Bits = 16;

  void init(const uint8_t* b, size_t len, int d, unsigned nice,
            size_t window) {
    buf = b;
    n = len;
    depth = d;
    nice_len = nice;
    max_dist = window;
    head4.assign(size_t(1) << kH4Bits, -1);
    head3.assign(size_t(1) << kH3Bits, -1);
    head2.assign(size_t(1) << kH2Bits, -1);
    prev.assign(n, -1);
  }
  inline uint32_t h4(size_t p) const {
    uint32_t x;
    std::memcpy(&x, buf + p, 4);
    return (x * 2654435761u) >> (32 - kH4Bits);
  }
  inline uint32_t h3(size_t p) const {
    uint32_t x = buf[p] | (uint32_t(buf[p + 1]) << 8) |
                 (uint32_t(buf[p + 2]) << 16);
    return (x * 2654435761u) >> (32 - kH3Bits);
  }
  inline uint32_t h2(size_t p) const {
    return buf[p] | (uint32_t(buf[p + 1]) << 8);
  }
  inline unsigned match_len(size_t a, size_t b, unsigned cap) const {
    unsigned l = 0;
    while (l < cap && buf[a + l] == buf[b + l]) l++;
    return l;
  }
  // longest normal match at p; returns length (0 = none), sets dist
  unsigned find(size_t p, uint32_t* dist_out) {
    unsigned cap = unsigned(n - p) < unsigned(kMatchMaxLen)
                       ? unsigned(n - p)
                       : unsigned(kMatchMaxLen);
    unsigned best = 0;
    uint32_t best_dist = 0;
    if (cap >= 2) {
      int32_t c = head2[h2(p)];
      if (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist) {
        unsigned l = match_len(size_t(c), p, cap);
        if (l >= 2) {
          best = l;
          best_dist = uint32_t(p - size_t(c) - 1);
        }
      }
    }
    if (cap >= 3) {
      int32_t c = head3[h3(p)];
      if (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist) {
        unsigned l = match_len(size_t(c), p, cap);
        if (l >= 3 && l > best) {
          best = l;
          best_dist = uint32_t(p - size_t(c) - 1);
        }
      }
    }
    if (cap >= 4) {
      int32_t c = head4[h4(p)];
      int steps = depth;
      while (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist &&
             steps-- > 0) {
        size_t cp = size_t(c);
        // quick reject on the current best tail byte
        if (best == 0 || (best < cap && buf[cp + best] == buf[p + best])) {
          unsigned l = match_len(cp, p, cap);
          if (l > best) {
            best = l;
            best_dist = uint32_t(p - cp - 1);
            if (l >= nice_len) break;
          }
        }
        c = prev[cp];
      }
    }
    *dist_out = best_dist;
    return best;
  }
  // all (len, dist) match pairs at p with strictly increasing len, then
  // post-processed so dists[i] is the NEAREST distance achieving >= len
  // (a longer match at a closer distance also serves every shorter len).
  // Returns the pair count (0 = no match).
  int find_pairs(size_t p, uint32_t* lens, uint32_t* dists) {
    unsigned cap = unsigned(n - p) < unsigned(kMatchMaxLen)
                       ? unsigned(n - p)
                       : unsigned(kMatchMaxLen);
    int np = 0;
    unsigned best = kMatchMinLen - 1;
    if (cap >= 2) {
      int32_t c = head2[h2(p)];
      if (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist) {
        unsigned l = match_len(size_t(c), p, cap);
        if (l >= 2) {
          lens[np] = l;
          dists[np++] = uint32_t(p - size_t(c) - 1);
          best = l;
        }
      }
    }
    if (cap >= 3) {
      int32_t c = head3[h3(p)];
      if (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist) {
        unsigned l = match_len(size_t(c), p, cap);
        if (l > best) {
          lens[np] = l;
          dists[np++] = uint32_t(p - size_t(c) - 1);
          best = l;
        }
      }
    }
    if (cap >= 4) {
      int32_t c = head4[h4(p)];
      int steps = depth;
      while (c >= 0 && size_t(c) < p && p - size_t(c) <= max_dist &&
             steps-- > 0) {
        size_t cp = size_t(c);
        if (best == 0 ||
            (best < cap && buf[cp + best] == buf[p + best])) {
          unsigned l = match_len(cp, p, cap);
          if (l > best) {
            lens[np] = l;
            dists[np++] = uint32_t(p - cp - 1);
            best = l;
            if (l >= nice_len) break;
          }
        }
        c = prev[cp];
      }
    }
    // nearest-dist monotonicity: a later (longer) pair at a closer dist
    // dominates earlier pairs for their whole length range
    for (int i = np - 2; i >= 0; i--)
      if (dists[i + 1] < dists[i]) dists[i] = dists[i + 1];
    return np;
  }
  void insert(size_t p) {
    if (p + 2 <= n) head2[h2(p)] = int32_t(p);
    if (p + 3 <= n) head3[h3(p)] = int32_t(p);
    if (p + 4 <= n) {
      uint32_t h = h4(p);
      prev[p] = head4[h];
      head4[h] = int32_t(p);
    }
  }
  // optimal-parse insert discipline: every position enters the chains
  // exactly once (a double insert would self-loop prev[]); insert_below(p)
  // inserts every position < p not yet inserted
  size_t inserted = 0;
  void insert_below(size_t p) {
    while (inserted < p && inserted < n) insert(inserted++);
  }
};

// -- encoder --------------------------------------------------------------

struct LzmaEncoder {
  int lc, lp, pb;
  RangeEncoder rc;
  std::vector<uint16_t> lit_probs;
  uint16_t is_match[kNumStates][1 << kNumPosBitsMax];
  uint16_t is_rep[kNumStates], is_rep_g0[kNumStates], is_rep_g1[kNumStates],
      is_rep_g2[kNumStates];
  uint16_t is_rep0_long[kNumStates][1 << kNumPosBitsMax];
  uint16_t pos_slot[4][1 << 6];
  uint16_t spec_pos[kNumFullDistances - kEndPosModelIndex];
  uint16_t align_probs[1 << kNumAlignBits];
  LenEncoder len_enc, rep_len_enc;

  unsigned state = 0;
  uint32_t reps[4] = {0, 0, 0, 0};

  void init_probs() {
    lit_probs.assign(size_t(0x300) << (lc + lp), kBitModelTotal / 2);
    for (auto& t : is_match)
      for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : is_rep) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g0) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g1) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g2) p = kBitModelTotal / 2;
    for (auto& t : is_rep0_long)
      for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& t : pos_slot)
      for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : spec_pos) p = kBitModelTotal / 2;
    for (auto& p : align_probs) p = kBitModelTotal / 2;
    len_enc.init();
    rep_len_enc.init();
  }

  void encode_literal(const uint8_t* buf, size_t pos, unsigned pos_state) {
    (void)pos_state;
    unsigned prev_byte = pos ? buf[pos - 1] : 0;
    unsigned lit_state =
        ((unsigned(pos) & ((1u << lp) - 1)) << lc) + (prev_byte >> (8 - lc));
    uint16_t* probs = &lit_probs[size_t(0x300) * lit_state];
    unsigned sym = buf[pos];
    if (state >= 7) {
      // matched-literal mode: the decoder follows rep0's byte bit by bit
      unsigned match_byte = buf[pos - reps[0] - 1];
      unsigned ctx = 1;
      unsigned i = 7;
      for (;;) {
        unsigned match_bit = (match_byte >> i) & 1;
        unsigned bit = (sym >> i) & 1;
        rc.encode_bit(&probs[((1 + match_bit) << 8) + ctx], bit);
        ctx = (ctx << 1) | bit;
        if (i == 0) break;
        i--;
        if (match_bit != bit) {
          // fall back to the plain tree for the remaining bits
          while (true) {
            bit = (sym >> i) & 1;
            rc.encode_bit(&probs[ctx], bit);
            ctx = (ctx << 1) | bit;
            if (i == 0) break;
            i--;
          }
          break;
        }
      }
    } else {
      unsigned ctx = 1;
      for (int i = 7; i >= 0; i--) {
        unsigned bit = (sym >> i) & 1;
        rc.encode_bit(&probs[ctx], bit);
        ctx = (ctx << 1) | bit;
      }
    }
    state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
  }

  void encode_match(unsigned len, uint32_t dist, unsigned pos_state) {
    rc.encode_bit(&is_rep[state], 0);
    state = state < 7 ? 7 : 10;
    len_enc.encode(rc, len - kMatchMinLen, pos_state);
    unsigned len_to_pos = (len - kMatchMinLen) < 4 ? (len - kMatchMinLen) : 3;
    unsigned slot = pos_slot_of(dist);
    rc.bit_tree_encode(pos_slot[len_to_pos], 6, slot);
    if (slot >= 4) {
      int num_direct = int(slot >> 1) - 1;
      uint32_t base = (2u | (slot & 1)) << num_direct;
      uint32_t rest = dist - base;
      if (slot < kEndPosModelIndex) {
        uint16_t* probs =
            spec_pos + ptrdiff_t(base) - ptrdiff_t(slot) - 1;
        rc.bit_tree_reverse_encode(probs, num_direct, rest);
      } else {
        rc.encode_direct(rest >> kNumAlignBits, num_direct - kNumAlignBits);
        rc.bit_tree_reverse_encode(align_probs, kNumAlignBits,
                                   rest & ((1u << kNumAlignBits) - 1));
      }
    }
    reps[3] = reps[2];
    reps[2] = reps[1];
    reps[1] = reps[0];
    reps[0] = dist;
  }

  void encode_rep(unsigned rep_index, unsigned len, unsigned pos_state) {
    rc.encode_bit(&is_rep[state], 1);
    if (rep_index == 0) {
      rc.encode_bit(&is_rep_g0[state], 0);
      rc.encode_bit(&is_rep0_long[state][pos_state], 1);
    } else {
      rc.encode_bit(&is_rep_g0[state], 1);
      uint32_t dist = reps[rep_index];
      if (rep_index == 1) {
        rc.encode_bit(&is_rep_g1[state], 0);
      } else {
        rc.encode_bit(&is_rep_g1[state], 1);
        rc.encode_bit(&is_rep_g2[state], rep_index == 2 ? 0 : 1);
        if (rep_index == 3) reps[3] = reps[2];
        reps[2] = reps[1];
      }
      reps[1] = reps[0];
      reps[0] = dist;
    }
    rep_len_enc.encode(rc, len - kMatchMinLen, pos_state);
    state = state < 7 ? 8 : 11;
  }

  void encode_short_rep(unsigned pos_state) {
    rc.encode_bit(&is_rep[state], 1);
    rc.encode_bit(&is_rep_g0[state], 0);
    rc.encode_bit(&is_rep0_long[state][pos_state], 0);
    state = state < 7 ? 9 : 11;
  }

  void encode_eos(unsigned pos_state) {
    rc.encode_bit(&is_match[state][pos_state], 1);
    rc.encode_bit(&is_rep[state], 0);
    state = state < 7 ? 7 : 10;
    len_enc.encode(rc, 0, pos_state);
    uint32_t dist = 0xFFFFFFFFu;
    unsigned slot = pos_slot_of(dist);  // 63
    rc.bit_tree_encode(pos_slot[0], 6, slot);
    int num_direct = int(slot >> 1) - 1;  // 30
    uint32_t base = (2u | (slot & 1)) << num_direct;
    uint32_t rest = dist - base;
    rc.encode_direct(rest >> kNumAlignBits, num_direct - kNumAlignBits);
    rc.bit_tree_reverse_encode(align_probs, kNumAlignBits,
                               rest & ((1u << kNumAlignBits) - 1));
  }

  // SDK-style "change pair": switching to a much smaller distance is
  // worth one length step
  static bool change_pair(uint32_t small_dist, uint32_t big_dist) {
    return small_dist < (big_dist >> 7);
  }

  void encode(const uint8_t* buf, size_t n, int depth, unsigned nice_len,
              size_t dict_size, std::vector<uint8_t>& out) {
    rc.out = &out;
    init_probs();
    MatchFinder mf;
    mf.init(buf, n, depth, nice_len, dict_size);
    const unsigned pb_mask = (1u << pb) - 1;

    size_t pos = 0;
    while (pos < n) {
      unsigned pos_state = unsigned(pos) & pb_mask;

      // candidates: longest rep match + longest normal match
      unsigned rep_len = 0, rep_idx = 0;
      unsigned cap = unsigned(n - pos) < unsigned(kMatchMaxLen)
                         ? unsigned(n - pos)
                         : unsigned(kMatchMaxLen);
      if (pos > 0) {
        for (unsigned r = 0; r < 4; r++) {
          if (reps[r] + 1 > pos) continue;
          unsigned l = mf.match_len(pos - reps[r] - 1, pos, cap);
          if (l >= 2 && l > rep_len) {
            rep_len = l;
            rep_idx = r;
          }
        }
      }
      uint32_t main_dist = 0;
      unsigned main_len = mf.find(pos, &main_dist);
      // a len-2 far match costs more than two literals; prune like the
      // SDK fast mode
      if (main_len == 2 && main_dist >= 512) main_len = 0;
      if (main_len >= 2 && main_len + 1 == rep_len &&
          !change_pair(main_dist, reps[rep_idx]))
        main_len = 0;  // rep almost as long and much cheaper to code

      bool use_rep =
          rep_len >= 2 &&
          (rep_len + 1 >= main_len ||
           (rep_len + 2 >= main_len && main_dist >= (1u << 9)) ||
           (rep_len + 3 >= main_len && main_dist >= (1u << 15)));

      if (use_rep) {
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_rep(rep_idx, rep_len, pos_state);
        for (unsigned i = 0; i < rep_len; i++) mf.insert(pos + i);
        pos += rep_len;
        continue;
      }

      if (main_len >= 2) {
        // lazy step: if the next position holds a clearly better match,
        // emit a literal now
        bool defer = false;
        if (main_len < nice_len && pos + 1 < n) {
          mf.insert(pos);
          uint32_t dist2 = 0;
          unsigned len2 = mf.find(pos + 1, &dist2);
          if (len2 > main_len ||
              (len2 == main_len && dist2 < main_dist &&
               change_pair(dist2, main_dist)))
            defer = true;
          if (!defer) {
            rc.encode_bit(&is_match[state][pos_state], 1);
            encode_match(main_len, main_dist, pos_state);
            for (unsigned i = 1; i < main_len; i++) mf.insert(pos + i);
            pos += main_len;
            continue;
          }
          // fall through to literal below (pos already inserted)
          rc.encode_bit(&is_match[state][pos_state], 0);
          encode_literal(buf, pos, pos_state);
          pos += 1;
          continue;
        }
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_match(main_len, main_dist, pos_state);
        for (unsigned i = 0; i < main_len; i++) mf.insert(pos + i);
        pos += main_len;
        continue;
      }

      // short rep beats a literal whenever the byte equals rep0's byte
      // (4 model bits vs up to 8)
      if (pos > 0 && reps[0] + 1 <= pos &&
          buf[pos] == buf[pos - reps[0] - 1]) {
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_short_rep(pos_state);
        mf.insert(pos);
        pos += 1;
        continue;
      }

      rc.encode_bit(&is_match[state][pos_state], 0);
      encode_literal(buf, pos, pos_state);
      mf.insert(pos);
      pos += 1;
    }
    encode_eos(unsigned(pos) & pb_mask);
    rc.flush();
  }

  // -- optimal parse ------------------------------------------------------
  //
  // Windowed forward DP (Viterbi over positions): nodes are input
  // positions; each settled node relaxes literal / short-rep / rep r
  // (all lengths) / nearest-match (all lengths) edges with exact model
  // prices, tracking (state, reps[4]) per node along its best path.
  // Prices are frozen at window start (the models only advance when the
  // window's chosen path is emitted) — the same approximation class as
  // liblzma's optimal mode, which refreshes its price tables
  // periodically. A match/rep >= nice_len cuts the window early and is
  // taken whole (long matches are always worth it, and this keeps the
  // DP cost bounded on highly repetitive data).

  static constexpr uint32_t kInfPrice = 0xFFFFFFFFu;
  static constexpr uint32_t kOpLit = 0xFFFFFFFFu;
  static constexpr uint32_t kOpShortRep = 0xFFFFFFFEu;
  static constexpr uint32_t kOpMatchBase = 4;  // dist_code = dist + 4
  static constexpr size_t kOptWindow = 4096;

  struct Opt {
    uint32_t price;
    int32_t back;        // predecessor node index
    uint32_t len;        // bytes consumed by the arriving op
    uint32_t dist_code;  // kOpLit / kOpShortRep / rep 0..3 / dist+4
    uint8_t state;
    uint32_t reps[4];
  };

  static unsigned lit_next_state(unsigned st) {
    return st < 4 ? 0 : (st < 10 ? st - 3 : st - 6);
  }
  static void rep_reorder(const uint32_t* r, unsigned idx, uint32_t* out) {
    out[0] = r[idx];
    out[1] = r[0 + (idx < 1)];
    out[2] = r[1 + (idx < 2)];
    out[3] = r[2 + (idx < 3)];
  }

  uint32_t price_literal(const uint8_t* buf, size_t pos, unsigned st,
                         uint32_t rep0, unsigned pos_state) const {
    uint32_t price = prc(is_match[st][pos_state], 0);
    unsigned prev_byte = pos ? buf[pos - 1] : 0;
    unsigned lit_state = ((unsigned(pos) & ((1u << lp) - 1)) << lc) +
                         (prev_byte >> (8 - lc));
    const uint16_t* probs = &lit_probs[size_t(0x300) * lit_state];
    unsigned sym = buf[pos];
    if (st >= 7 && pos > rep0) {
      unsigned match_byte = buf[pos - rep0 - 1];
      unsigned ctx = 1;
      unsigned i = 7;
      for (;;) {
        unsigned match_bit = (match_byte >> i) & 1;
        unsigned bit = (sym >> i) & 1;
        price += prc(probs[((1 + match_bit) << 8) + ctx], bit);
        ctx = (ctx << 1) | bit;
        if (i == 0) break;
        i--;
        if (match_bit != bit) {
          while (true) {
            bit = (sym >> i) & 1;
            price += prc(probs[ctx], bit);
            ctx = (ctx << 1) | bit;
            if (i == 0) break;
            i--;
          }
          break;
        }
      }
    } else {
      unsigned ctx = 1;
      for (int i = 7; i >= 0; i--) {
        unsigned bit = (sym >> i) & 1;
        price += prc(probs[ctx], bit);
        ctx = (ctx << 1) | bit;
      }
    }
    return price;
  }

  uint32_t price_short_rep(unsigned st, unsigned pos_state) const {
    return prc(is_match[st][pos_state], 1) + prc(is_rep[st], 1) +
           prc(is_rep_g0[st], 0) + prc(is_rep0_long[st][pos_state], 0);
  }

  uint32_t price_rep_prefix(unsigned st, unsigned pos_state,
                            unsigned r) const {
    uint32_t price = prc(is_match[st][pos_state], 1) + prc(is_rep[st], 1);
    if (r == 0)
      return price + prc(is_rep_g0[st], 0) +
             prc(is_rep0_long[st][pos_state], 1);
    price += prc(is_rep_g0[st], 1);
    if (r == 1) return price + prc(is_rep_g1[st], 0);
    return price + prc(is_rep_g1[st], 1) +
           prc(is_rep_g2[st], r == 2 ? 0 : 1);
  }

  // per-window cached tables: len prices per pos_state, distance prices
  // per len_to_pos bucket (full spec_pos price under 128, slot+align
  // above)
  struct WindowPrices {
    uint32_t len_tab[1 << kNumPosBitsMax][kMatchMaxLen - kMatchMinLen + 1];
    uint32_t rep_len_tab[1 << kNumPosBitsMax]
                        [kMatchMaxLen - kMatchMinLen + 1];
    uint32_t dist_low[4][kNumFullDistances];
    uint32_t slot_tab[4][64];
    uint32_t align_tab[1 << kNumAlignBits];
  };

  void fill_window_prices(WindowPrices& wp, unsigned pb_mask) const {
    for (unsigned ps = 0; ps <= pb_mask; ps++)
      for (unsigned l = 0; l <= kMatchMaxLen - kMatchMinLen; l++) {
        wp.len_tab[ps][l] = len_price_of(len_enc, l, ps);
        wp.rep_len_tab[ps][l] = len_price_of(rep_len_enc, l, ps);
      }
    for (unsigned a = 0; a < (1u << kNumAlignBits); a++)
      wp.align_tab[a] = rev_tree_price(align_probs, kNumAlignBits, a);
    for (unsigned l2p = 0; l2p < 4; l2p++) {
      for (unsigned slot = 0; slot < 64; slot++)
        wp.slot_tab[l2p][slot] = tree_price(pos_slot[l2p], 6, slot);
      for (uint32_t d = 0; d < kNumFullDistances; d++) {
        unsigned slot = pos_slot_of(d);
        uint32_t price = wp.slot_tab[l2p][slot];
        if (slot >= 4) {
          int nd = int(slot >> 1) - 1;
          uint32_t base = (2u | (slot & 1)) << nd;
          price += rev_tree_price(
              spec_pos + ptrdiff_t(base) - ptrdiff_t(slot) - 1, nd,
              d - base);
        }
        wp.dist_low[l2p][d] = price;
      }
    }
  }

  uint32_t dist_price(const WindowPrices& wp, unsigned l2p,
                      uint32_t dist) const {
    if (dist < kNumFullDistances) return wp.dist_low[l2p][dist];
    unsigned slot = pos_slot_of(dist);
    uint32_t price = wp.slot_tab[l2p][slot];
    int nd = int(slot >> 1) - 1;
    price += uint32_t(nd - kNumAlignBits) << 4;  // direct bits: 16 u/bit
    return price + wp.align_tab[dist & ((1u << kNumAlignBits) - 1)];
  }

  // emit the DP-chosen path ending at node `end` (backtrack via back
  // pointers), advancing the real models
  void emit_path(const uint8_t* buf, size_t window_start,
                 std::vector<Opt>& opt, size_t end, unsigned pb_mask) {
    // collect node indices along the path, then walk forward
    static thread_local std::vector<uint32_t> chain;
    chain.clear();
    for (size_t j = end; opt[j].back >= 0; j = size_t(opt[j].back))
      chain.push_back(uint32_t(j));
    for (size_t c = chain.size(); c-- > 0;) {
      const Opt& o = opt[chain[c]];
      size_t pos = window_start + size_t(chain[c]) - o.len;
      unsigned pos_state = unsigned(pos) & pb_mask;
      if (o.dist_code == kOpLit) {
        rc.encode_bit(&is_match[state][pos_state], 0);
        encode_literal(buf, pos, pos_state);
      } else if (o.dist_code == kOpShortRep) {
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_short_rep(pos_state);
      } else if (o.dist_code < kOpMatchBase) {
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_rep(o.dist_code, o.len, pos_state);
      } else {
        rc.encode_bit(&is_match[state][pos_state], 1);
        encode_match(o.len, o.dist_code - kOpMatchBase, pos_state);
      }
    }
  }

  void encode_optimal(const uint8_t* buf, size_t n, int depth,
                      unsigned nice_len, size_t dict_size,
                      std::vector<uint8_t>& out) {
    rc.out = &out;
    init_probs();
    MatchFinder mf;
    mf.init(buf, n, depth, nice_len, dict_size);
    const unsigned pb_mask = (1u << pb) - 1;
    std::vector<Opt> opt(kOptWindow + kMatchMaxLen + 1);
    std::vector<uint32_t> plens(kMatchMaxLen + 4), pdists(kMatchMaxLen + 4);
    auto wp = std::make_unique<WindowPrices>();

    size_t S = 0;
    while (S < n) {
      fill_window_prices(*wp, pb_mask);
      const size_t cut = std::min(kOptWindow, n - S);
      const size_t limit = std::min(cut + size_t(kMatchMaxLen), n - S);
      for (size_t j = 0; j <= limit; j++) opt[j].price = kInfPrice;
      opt[0].price = 0;
      opt[0].back = -1;
      opt[0].state = uint8_t(state);
      std::memcpy(opt[0].reps, reps, sizeof(reps));

      auto relax = [&](size_t j, uint32_t price, size_t i, uint32_t len,
                       uint32_t dist_code, unsigned new_state,
                       const uint32_t* new_reps) {
        Opt& o = opt[j];
        if (price >= o.price) return;
        o.price = price;
        o.back = int32_t(i);
        o.len = len;
        o.dist_code = dist_code;
        o.state = uint8_t(new_state);
        std::memcpy(o.reps, new_reps, 4 * sizeof(uint32_t));
      };

      // early cut: a match/rep >= nice_len is taken whole
      size_t early_i = SIZE_MAX;
      unsigned early_len = 0;
      uint32_t early_dist = 0;
      int early_rep = -1;

      for (size_t i = 0; i < cut; i++) {
        const Opt cur = opt[i];  // copy: relax may touch opt[i+...]
        if (cur.price == kInfPrice) continue;
        const size_t abs = S + i;
        const unsigned ps = unsigned(abs) & pb_mask;
        const unsigned st = cur.state;
        const unsigned cap32 = unsigned(
            std::min(n - abs, size_t(kMatchMaxLen)));
        const unsigned span = unsigned(limit - i);  // room in the window

        // literal
        relax(i + 1,
              cur.price + price_literal(buf, abs, st, cur.reps[0], ps), i,
              1, kOpLit, lit_next_state(st), cur.reps);
        // short rep
        if (abs > cur.reps[0] && buf[abs] == buf[abs - cur.reps[0] - 1])
          relax(i + 1, cur.price + price_short_rep(st, ps), i, 1,
                kOpShortRep, st < 7 ? 9 : 11, cur.reps);
        // rep matches, all lengths
        for (unsigned r = 0; r < 4; r++) {
          if (cur.reps[r] + 1 > abs || cur.reps[r] + 1 > mf.max_dist)
            continue;
          unsigned l = mf.match_len(abs - cur.reps[r] - 1, abs, cap32);
          if (l < 2) continue;
          if (l >= nice_len &&
              (early_i == SIZE_MAX || l > early_len)) {
            early_i = i;
            early_len = l;
            early_rep = int(r);
            early_dist = cur.reps[r];
          }
          uint32_t prefix = cur.price + price_rep_prefix(st, ps, r);
          unsigned new_state = st < 7 ? 8 : 11;
          uint32_t new_reps[4];
          rep_reorder(cur.reps, r, new_reps);
          unsigned lmax = std::min(l, span);
          for (unsigned L = 2; L <= lmax; L++)
            relax(i + L,
                  prefix + wp->rep_len_tab[ps][L - kMatchMinLen], i, L,
                  r, new_state, new_reps);
        }
        // normal matches: nearest dist per length
        int np = mf.find_pairs(abs, plens.data(), pdists.data());
        mf.insert_below(abs + 1);
        if (np > 0) {
          unsigned longest = plens[np - 1];
          if (longest >= nice_len &&
              (early_i == SIZE_MAX || longest > early_len)) {
            early_i = i;
            early_len = longest;
            early_rep = -1;
            early_dist = pdists[np - 1];
          }
          uint32_t prefix =
              cur.price + prc(is_match[st][ps], 1) + prc(is_rep[st], 0);
          unsigned new_state = st < 7 ? 7 : 10;
          int pi = 0;
          unsigned lmax = std::min(longest, span);
          for (unsigned L = 2; L <= lmax; L++) {
            while (plens[pi] < L) pi++;
            uint32_t d = pdists[pi];
            unsigned lc2 = L - kMatchMinLen;
            uint32_t new_reps[4] = {d, cur.reps[0], cur.reps[1],
                                    cur.reps[2]};
            relax(i + L,
                  prefix + wp->len_tab[ps][lc2] +
                      dist_price(*wp, lc2 < 4 ? lc2 : 3, d),
                  i, L, d + kOpMatchBase, new_state, new_reps);
          }
        }
        if (early_i != SIZE_MAX) break;
      }

      if (early_i != SIZE_MAX) {
        emit_path(buf, S, opt, early_i, pb_mask);
        size_t abs = S + early_i;
        unsigned ps = unsigned(abs) & pb_mask;
        rc.encode_bit(&is_match[state][ps], 1);
        if (early_rep >= 0) {
          // recover the rep index under the EMITTED reps (the DP node's
          // rep order matches the emitted models by construction)
          encode_rep(unsigned(early_rep), early_len, ps);
        } else {
          encode_match(early_len, early_dist, ps);
        }
        S = abs + early_len;
        mf.insert_below(S);
        // greedy-chain consecutive >=nice_len matches: restarting the
        // window per long match would pay the full price-table refill +
        // node reinit to advance <=273 bytes — run-heavy data measured
        // ~11x slower without this skip loop. S stays UNinserted until
        // an op consumes it (find-before-insert discipline).
        while (S < n) {
          unsigned cap = unsigned(
              std::min(n - S, size_t(kMatchMaxLen)));
          unsigned rl = 0, ri = 0;
          for (unsigned r = 0; r < 4; r++) {
            if (reps[r] + 1 > S || reps[r] + 1 > mf.max_dist) continue;
            unsigned l = mf.match_len(S - reps[r] - 1, S, cap);
            if (l > rl) {
              rl = l;
              ri = r;
            }
          }
          int np2 = mf.find_pairs(S, plens.data(), pdists.data());
          unsigned ml = np2 ? plens[np2 - 1] : 0;
          if (rl < nice_len && ml < nice_len) break;
          unsigned ps2 = unsigned(S) & pb_mask;
          rc.encode_bit(&is_match[state][ps2], 1);
          if (rl >= ml) {
            encode_rep(ri, rl, ps2);
            S += rl;
          } else {
            encode_match(ml, pdists[np2 - 1], ps2);
            S += ml;
          }
          mf.insert_below(S);
        }
        continue;
      }

      // choose the end node: any j >= cut is a fully-priced prefix;
      // prefer longer prefixes via a completion estimate at the window's
      // own average cost per byte
      size_t jend = cut;
      if (limit > cut) {
        double unit = opt[cut].price != kInfPrice && cut > 0
                          ? double(opt[cut].price) / double(cut)
                          : 128.0;
        double best_score = 1e300;
        for (size_t j = cut; j <= limit; j++) {
          if (opt[j].price == kInfPrice) continue;
          double score = double(opt[j].price) + double(limit - j) * unit;
          if (score < best_score) {
            best_score = score;
            jend = j;
          }
        }
      }
      emit_path(buf, S, opt, jend, pb_mask);
      S += jend;
      mf.insert_below(S);
    }
    encode_eos(unsigned(S) & pb_mask);
    rc.flush();
  }
};

}  // namespace

namespace {

uint8_t* encode_alone_impl(const uint8_t* src, size_t n, int lc, int lp,
                           int pb, int depth, unsigned nice_len, int algo,
                           size_t* out_len, int* status) try {
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4 ||
      depth < 1 || nice_len < 8 || nice_len > kMatchMaxLen || algo < 0 ||
      algo > 1) {
    *status = -1;
    *out_len = 0;
    return nullptr;
  }
  std::vector<uint8_t> out;
  out.reserve(n / 2 + 64);
  // 13-byte LZMA-alone header: props, dict size, unknown size (-eos).
  // The match finder honors the declared dict size as its window, so
  // inputs beyond the cap still produce spec-valid streams for windowed
  // decoders.
  out.push_back(uint8_t((pb * 5 + lp) * 9 + lc));
  uint32_t dict = 1u << 16;
  while (dict < n && dict < (1u << 26)) dict <<= 1;
  for (int i = 0; i < 4; i++) out.push_back(uint8_t(dict >> (8 * i)));
  for (int i = 0; i < 8; i++) out.push_back(0xFF);

  LzmaEncoder enc;
  enc.lc = lc;
  enc.lp = lp;
  enc.pb = pb;
  if (algo == 1)
    enc.encode_optimal(src, n, depth, nice_len, size_t(dict), out);
  else
    enc.encode(src, n, depth, nice_len, size_t(dict), out);

  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
  if (!buf) {
    *status = -6;
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  *out_len = out.size();
  *status = 0;
  return buf;
} catch (...) {
  *status = -6;
  *out_len = 0;
  return nullptr;
}

}  // namespace

extern "C" {

uint8_t* tiler_lzma_encode_alone(const uint8_t* src, size_t n, int lc,
                                 int lp, int pb, int depth,
                                 unsigned nice_len, size_t* out_len,
                                 int* status) {
  return encode_alone_impl(src, n, lc, lp, pb, depth, nice_len, 0,
                           out_len, status);
}

// algo 0 = greedy+lazy parse, 1 = optimal parse (windowed price DP)
uint8_t* tiler_lzma_encode_alone2(const uint8_t* src, size_t n, int lc,
                                  int lp, int pb, int depth,
                                  unsigned nice_len, int algo,
                                  size_t* out_len, int* status) {
  return encode_alone_impl(src, n, lc, lp, pb, depth, nice_len, algo,
                           out_len, status);
}

}  // extern "C"
