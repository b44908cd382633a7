// LZMA1 ("alone"-format) decoder supporting the full lc 0..8 range.
//
// Why this exists: the reference encoder compresses each GTM keyframe with
// `lzma.exe e src dst -lc8 -eos` (reference extern.pas:224) and the
// published demo bitstreams use lc=8. liblzma (Python's lzma module) enforces
// lc+lp<=4 and cannot decode those streams, so the framework needs its own
// LZMA1 decoder for golden-file conformance. This is a fresh implementation
// of the public LZMA specification (range coder + bit-tree models), not a
// port of the bundled js-lzma.
//
// C API (ctypes-friendly):
//   tiler_lzma_decode_alone(src, src_len, &out_len, &consumed, &status)
//     -> malloc'd output buffer (caller frees with tiler_free), decodes ONE
//        13-byte-header stream until EOS marker / declared size / input end.
//   tiler_free(ptr)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstddef>
#include <vector>

namespace {

constexpr size_t kMaxOutput = size_t(1) << 30;  // 1 GiB per stream

constexpr uint32_t kTopValue = 1u << 24;
constexpr int kNumBitModelTotalBits = 11;
constexpr uint16_t kBitModelTotal = 1 << kNumBitModelTotalBits;
constexpr int kNumMoveBits = 5;
constexpr int kMatchMinLen = 2;
constexpr int kNumStates = 12;
constexpr int kNumPosBitsMax = 4;
constexpr int kEndPosModelIndex = 14;
constexpr int kNumFullDistances = 1 << (kEndPosModelIndex >> 1);
constexpr int kNumAlignBits = 4;

struct RangeDecoder {
  const uint8_t* buf;
  size_t size;
  size_t pos;
  uint32_t range;
  uint32_t code;
  bool overrun;

  void init(const uint8_t* b, size_t n) {
    buf = b; size = n; pos = 0; range = 0xFFFFFFFFu; code = 0; overrun = false;
    // first byte of the coded stream must be 0; then 4 code bytes
    next();  // skip
    for (int i = 0; i < 4; i++) code = (code << 8) | next();
  }
  uint8_t next() {
    if (pos < size) return buf[pos++];
    overrun = true; return 0;
  }
  void normalize() {
    if (range < kTopValue) { range <<= 8; code = (code << 8) | next(); }
  }
  int decode_bit(uint16_t* prob) {
    uint32_t bound = (range >> kNumBitModelTotalBits) * *prob;
    int bit;
    if (code < bound) {
      range = bound;
      *prob += (kBitModelTotal - *prob) >> kNumMoveBits;
      bit = 0;
    } else {
      range -= bound;
      code -= bound;
      *prob -= *prob >> kNumMoveBits;
      bit = 1;
    }
    normalize();
    return bit;
  }
  uint32_t decode_direct_bits(int n) {
    uint32_t res = 0;
    while (n--) {
      range >>= 1;
      code -= range;
      uint32_t t = 0u - (code >> 31);
      code += range & t;
      normalize();
      res = (res << 1) + (t + 1);
    }
    return res;
  }
  unsigned bit_tree_decode(uint16_t* probs, int num_bits) {
    unsigned m = 1;
    for (int i = 0; i < num_bits; i++) m = (m << 1) | decode_bit(&probs[m]);
    return m - (1u << num_bits);
  }
  unsigned bit_tree_reverse_decode(uint16_t* probs, int num_bits) {
    unsigned m = 1, sym = 0;
    for (int i = 0; i < num_bits; i++) {
      unsigned bit = decode_bit(&probs[m]);
      m = (m << 1) | bit;
      sym |= bit << i;
    }
    return sym;
  }
};

struct LenDecoder {
  uint16_t choice, choice2;
  uint16_t low[1 << kNumPosBitsMax][8];
  uint16_t mid[1 << kNumPosBitsMax][8];
  uint16_t high[256];

  void init() {
    choice = choice2 = kBitModelTotal / 2;
    for (auto& t : low) for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& t : mid) for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : high) p = kBitModelTotal / 2;
  }
  unsigned decode(RangeDecoder& rc, unsigned pos_state) {
    if (!rc.decode_bit(&choice))
      return rc.bit_tree_decode(low[pos_state], 3);
    if (!rc.decode_bit(&choice2))
      return 8 + rc.bit_tree_decode(mid[pos_state], 3);
    return 16 + rc.bit_tree_decode(high, 8);
  }
};

struct LzmaDecoder {
  int lc, lp, pb;
  uint64_t unpack_size;     // 0xFFFFFFFFFFFFFFFF = unknown (EOS-terminated)
  bool size_known;

  RangeDecoder rc;
  std::vector<uint16_t> lit_probs;
  uint16_t is_match[kNumStates][1 << kNumPosBitsMax];
  uint16_t is_rep[kNumStates], is_rep_g0[kNumStates], is_rep_g1[kNumStates],
      is_rep_g2[kNumStates];
  uint16_t is_rep0_long[kNumStates][1 << kNumPosBitsMax];
  uint16_t pos_slot[4][1 << 6];
  uint16_t spec_pos[kNumFullDistances - kEndPosModelIndex];
  uint16_t align_probs[1 << kNumAlignBits];
  LenDecoder len_dec, rep_len_dec;

  void init_probs() {
    lit_probs.assign(size_t(0x300) << (lc + lp), kBitModelTotal / 2);
    for (auto& t : is_match) for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : is_rep) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g0) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g1) p = kBitModelTotal / 2;
    for (auto& p : is_rep_g2) p = kBitModelTotal / 2;
    for (auto& t : is_rep0_long) for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& t : pos_slot) for (auto& p : t) p = kBitModelTotal / 2;
    for (auto& p : spec_pos) p = kBitModelTotal / 2;
    for (auto& p : align_probs) p = kBitModelTotal / 2;
    len_dec.init();
    rep_len_dec.init();
  }

  // returns 0 on success, negative on error; out gets the decoded bytes
  int decode(const uint8_t* src, size_t src_len, std::vector<uint8_t>& out,
             size_t* consumed) {
    if (src_len < 13) return -1;
    unsigned props = src[0];
    if (props >= 9 * 5 * 5) return -2;
    lc = props % 9; props /= 9;
    lp = props % 5; pb = props / 5;
    // dict size (src[1..4]) is irrelevant for an in-memory decode
    unpack_size = 0;
    for (int i = 0; i < 8; i++) unpack_size |= uint64_t(src[5 + i]) << (8 * i);
    size_known = unpack_size != 0xFFFFFFFFFFFFFFFFull;

    init_probs();
    rc.init(src + 13, src_len - 13);

    unsigned state = 0;
    uint32_t rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
    const unsigned pb_mask = (1u << pb) - 1;
    const unsigned lp_mask = (1u << lp) - 1;

    for (;;) {
      if (size_known && out.size() >= unpack_size) break;
      if (rc.overrun) return -3;
      // decompression-bomb guard: a crafted header can demand up to
      // 2^64 output from a tiny input (matches emit ~273 bytes per few
      // input bits); no real GTM keyframe stream approaches 1 GiB
      if (out.size() > kMaxOutput) return -5;

      unsigned pos_state = unsigned(out.size()) & pb_mask;
      if (!rc.decode_bit(&is_match[state][pos_state])) {
        // literal
        unsigned prev = out.empty() ? 0 : out.back();
        unsigned lit_state =
            ((unsigned(out.size()) & lp_mask) << lc) + (prev >> (8 - lc));
        uint16_t* probs = &lit_probs[size_t(0x300) * lit_state];
        unsigned symbol = 1;
        if (state >= 7) {
          if (rep0 + 1 > out.size()) return -4;
          unsigned match_byte = out[out.size() - rep0 - 1];
          do {
            unsigned match_bit = (match_byte >> 7) & 1;
            match_byte <<= 1;
            unsigned bit =
                rc.decode_bit(&probs[((1 + match_bit) << 8) + symbol]);
            symbol = (symbol << 1) | bit;
            if (match_bit != bit) break;
          } while (symbol < 0x100);
        }
        while (symbol < 0x100)
          symbol = (symbol << 1) | rc.decode_bit(&probs[symbol]);
        out.push_back(uint8_t(symbol & 0xff));
        state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
        continue;
      }

      unsigned len;
      if (rc.decode_bit(&is_rep[state])) {
        // rep match
        if (out.empty() && !size_known) return -5;
        if (!rc.decode_bit(&is_rep_g0[state])) {
          if (!rc.decode_bit(&is_rep0_long[state][pos_state])) {
            // short rep: single byte from rep0
            state = state < 7 ? 9 : 11;
            if (rep0 + 1 > out.size()) return -4;
            out.push_back(out[out.size() - rep0 - 1]);
            continue;
          }
        } else {
          uint32_t dist;
          if (!rc.decode_bit(&is_rep_g1[state])) {
            dist = rep1;
          } else if (!rc.decode_bit(&is_rep_g2[state])) {
            dist = rep2;
            rep2 = rep1;
          } else {
            dist = rep3;
            rep3 = rep2;
            rep2 = rep1;
          }
          rep1 = rep0;
          rep0 = dist;
        }
        len = rep_len_dec.decode(rc, pos_state);
        state = state < 7 ? 8 : 11;
      } else {
        // new match
        rep3 = rep2; rep2 = rep1; rep1 = rep0;
        len = len_dec.decode(rc, pos_state);
        state = state < 7 ? 7 : 10;
        unsigned len_to_pos = len < 4 ? len : 3;
        unsigned slot = rc.bit_tree_decode(pos_slot[len_to_pos], 6);
        if (slot < 4) {
          rep0 = slot;
        } else {
          int num_direct = int(slot >> 1) - 1;
          uint32_t dist = (2 | (slot & 1)) << num_direct;
          if (slot < kEndPosModelIndex) {
            // base may point one before spec_pos[0]; the reverse tree only
            // accesses indices >= 1 relative to the base.
            uint16_t* base = spec_pos + std::ptrdiff_t(dist) - std::ptrdiff_t(slot) - 1;
            dist += rc.bit_tree_reverse_decode(base, num_direct);
          } else {
            dist += rc.decode_direct_bits(num_direct - kNumAlignBits)
                    << kNumAlignBits;
            dist += rc.bit_tree_reverse_decode(align_probs, kNumAlignBits);
          }
          rep0 = dist;
        }
        // end-of-stream marker; a truncated stream whose zero-fill still
        // decodes to the marker must NOT report a clean end (parity with
        // pylzma1's check at its EOS return)
        if (rep0 == 0xFFFFFFFFu) {
          if (rc.overrun) return -3;
          break;
        }
      }
      len += kMatchMinLen;
      if (rep0 + 1 > out.size()) return -4;
      size_t from = out.size() - rep0 - 1;
      for (unsigned i = 0; i < len; i++) out.push_back(out[from + i]);
    }

    *consumed = 13 + rc.pos;
    return 0;
  }
};

}  // namespace

extern "C" {

// status: 0 ok, <0 error codes above
uint8_t* tiler_lzma_decode_alone(const uint8_t* src, size_t src_len,
                                 size_t* out_len, size_t* consumed,
                                 int* status) try {
  LzmaDecoder dec;
  std::vector<uint8_t> out;
  out.reserve(src_len * 4);
  size_t cons = 0;
  int rc = dec.decode(src, src_len, out, &cons);
  *status = rc;
  *consumed = cons;
  *out_len = out.size();
  if (rc != 0) return nullptr;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size() ? out.size() : 1));
  if (!buf) {  // malloc fails by returning NULL, not by throwing
    *status = -6;
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  return buf;
} catch (...) {
  // a C++ exception (e.g. bad_alloc) must not cross the ctypes ABI —
  // it would std::terminate the host process
  *status = -6;
  *out_len = 0;
  *consumed = 0;
  return nullptr;
}

void tiler_free(void* p) { std::free(p); }

}  // extern "C"
