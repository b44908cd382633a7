// GTM command-stream parser — native counterpart of decode.interpret_commands.
//
// Parses the decompressed 16-bit command stream (grammar defined by the JS
// player, reference decoders/htmljs/gtm.player.js:274-363, and the
// writer reference main.pas:4529-4763) into flat arrays: the tileset,
// per-frame draw ops (cell position, tile index, attrs) and per-frame
// palette snapshots. The Python decoder walks ~millions of commands per
// clip; this parser does it at memory speed and returns views the batched
// renderer consumes directly.
//
// C API: handle-based.
//   h = tiler_gtm_parse(data, len, &status)       status 0 = ok
//   tiler_gtm_info(h, ...)                        dims / counts
//   tiler_gtm_tiles(h)                            [tile_count*64] bytes
//   tiler_gtm_frame(h, f, ...)                    one frame's ops + flags
//   tiler_gtm_palettes(h, f)                      [256*pal_size*4] snapshot
//   tiler_gtm_free(h)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxTiles = int64_t(1) << 26;  // 64M tiles = 4 GB cap

enum Cmd {
  kSkipBlock = 0,
  kShortTileIdx = 1,
  kLongTileIdx = 2,
  kLoadPalette = 3,
  kFrameEnd = 28,
  kTileSet = 29,
  kSetDimensions = 30,
};

struct Frame {
  std::vector<int32_t> pos, tile, attrs;
  int kf_end = 0;
  std::vector<uint8_t> palettes;  // 256 * pal_size * 4 snapshot
};

struct Parsed {
  int tilemap_w = 0, tilemap_h = 0;
  int64_t frame_ns = 0;
  int pal_size = 0;
  std::vector<uint8_t> tiles;  // tile_count * 64
  int64_t tile_count = 0;
  std::vector<Frame> frames;
};

}  // namespace

extern "C" {

void* tiler_gtm_parse(const uint8_t* data, size_t len, int* status) try {
  auto* p = new Parsed();
  *status = 0;
  size_t pos = 0;  // byte offset
  std::vector<uint8_t> palettes(256 * 4, 0);  // grows with pal_size
  int pal_size = 0;
  int64_t tm_pos = 0;
  Frame cur;

  auto word = [&](size_t at) -> uint32_t {
    return uint32_t(data[at]) | (uint32_t(data[at + 1]) << 8);
  };
  auto dword = [&](size_t at) -> uint32_t {
    return word(at) | (word(at + 2) << 16);
  };

  while (pos + 2 <= len) {
    uint32_t w = word(pos);
    pos += 2;
    uint32_t cmd = w & 0x3f;
    uint32_t attrs = w >> 6;

    switch (cmd) {
      case kSetDimensions: {
        if (pos + 12 > len) { *status = -1; return p; }
        p->tilemap_w = int(word(pos));
        p->tilemap_h = int(word(pos + 2));
        p->frame_ns = int64_t(dword(pos + 4));
        int64_t tile_count = int64_t(dword(pos + 8));
        pos += 12;
        // malformed-input guard: a crafted dword here would drive a
        // multi-GB resize (uncaught bad_alloc kills the process); no
        // real stream approaches 2^26 tiles
        if (tile_count > kMaxTiles) { *status = -4; return p; }
        if (int64_t(p->tiles.size()) < tile_count * 64)
          p->tiles.resize(size_t(tile_count) * 64, 0);
        p->tile_count = tile_count;
        break;
      }
      case kTileSet: {
        if (pos + 8 > len) { *status = -1; return p; }
        int64_t tstart = int64_t(dword(pos));
        int64_t tend = int64_t(dword(pos + 4));
        pos += 8;
        pal_size = int(attrs);
        p->pal_size = pal_size;
        // malformed-input guards: tend < tstart makes cnt negative and
        // size_t(cnt)*64 WRAPS past the bounds check into an OOB memcpy;
        // a huge tend would bad_alloc the resize
        if (tend < tstart || tend >= kMaxTiles) { *status = -4; return p; }
        int64_t cnt = tend - tstart + 1;
        if (size_t(cnt) * 64 > len - pos) { *status = -1; return p; }
        if (int64_t(p->tiles.size()) < (tend + 1) * 64)
          p->tiles.resize(size_t(tend + 1) * 64, 0);
        if (tend + 1 > p->tile_count) p->tile_count = tend + 1;
        std::memcpy(p->tiles.data() + tstart * 64, data + pos,
                    size_t(cnt) * 64);
        pos += size_t(cnt) * 64;
        break;
      }
      case kLoadPalette: {
        if (pos + 2 + size_t(pal_size) * 4 > len) { *status = -1; return p; }
        int pal_idx = data[pos];
        pos += 2;  // idx byte + format byte
        if (int(palettes.size()) < 256 * pal_size * 4)
          palettes.assign(size_t(256) * pal_size * 4, 0);
        std::memcpy(palettes.data() + size_t(pal_idx) * pal_size * 4,
                    data + pos, size_t(pal_size) * 4);
        pos += size_t(pal_size) * 4;
        break;
      }
      case kSkipBlock:
        tm_pos += attrs + 1;
        break;
      case kShortTileIdx: {
        if (pos + 2 > len) { *status = -1; return p; }
        cur.pos.push_back(int32_t(tm_pos++));
        cur.tile.push_back(int32_t(word(pos)));
        cur.attrs.push_back(int32_t(attrs));
        pos += 2;
        break;
      }
      case kLongTileIdx: {
        if (pos + 4 > len) { *status = -1; return p; }
        cur.pos.push_back(int32_t(tm_pos++));
        cur.tile.push_back(int32_t(dword(pos)));
        cur.attrs.push_back(int32_t(attrs));
        pos += 4;
        break;
      }
      case kFrameEnd: {
        if (tm_pos != int64_t(p->tilemap_w) * p->tilemap_h) {
          *status = -2;  // incomplete tilemap
          return p;
        }
        cur.kf_end = int(attrs & 1);
        cur.palettes = palettes;
        p->frames.push_back(std::move(cur));
        cur = Frame();
        tm_pos = 0;
        break;
      }
      default:
        *status = -3;  // undecoded command
        return p;
    }
  }
  return p;
} catch (...) {
  // exceptions (e.g. bad_alloc) must not cross the ctypes ABI (that
  // would std::terminate the host). The partially-built Parsed leaks on
  // this path — acceptable: it is reachable only via allocation failure
  // on already-sanity-capped sizes, and the process survives to report.
  *status = -5;
  return nullptr;
}

void tiler_gtm_free(void* h) { delete static_cast<Parsed*>(h); }

void tiler_gtm_info(void* h, int32_t* tw, int32_t* th, int64_t* frame_ns,
                    int64_t* tile_count, int32_t* pal_size,
                    int32_t* n_frames) {
  auto* p = static_cast<Parsed*>(h);
  *tw = p->tilemap_w;
  *th = p->tilemap_h;
  *frame_ns = p->frame_ns;
  *tile_count = p->tile_count;
  *pal_size = p->pal_size;
  *n_frames = int32_t(p->frames.size());
}

const uint8_t* tiler_gtm_tiles(void* h) {
  return static_cast<Parsed*>(h)->tiles.data();
}

int tiler_gtm_frame(void* h, int f, const int32_t** pos,
                    const int32_t** tile, const int32_t** attrs,
                    int32_t* n, int32_t* kf_end) {
  auto* p = static_cast<Parsed*>(h);
  if (f < 0 || size_t(f) >= p->frames.size()) return -1;
  auto& fr = p->frames[size_t(f)];
  *pos = fr.pos.data();
  *tile = fr.tile.data();
  *attrs = fr.attrs.data();
  *n = int32_t(fr.pos.size());
  *kf_end = fr.kf_end;
  return 0;
}

const uint8_t* tiler_gtm_palettes(void* h, int f) {
  auto* p = static_cast<Parsed*>(h);
  if (f < 0 || size_t(f) >= p->frames.size()) return nullptr;
  return p->frames[size_t(f)].palettes.data();
}

}  // extern "C"
