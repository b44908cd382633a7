// Floyd-Steinberg error diffusion (sub-8-bit posterize paths).
//
// Faithful ports of the reference's two FS variants:
//  - whole-frame in-place diffusion, DitherFloydSteinberg
//    (reference main.pas:1966-1996): NOTE the reference's border
//    behavior — at the last column/row the neighbor offsets collapse to 0,
//    so the error is added onto the just-written pixel itself (and onto
//    already-processed left/right pixels on the last row), clamped 0..255.
//  - per-tile diffusion with replicated 1-px borders,
//    DitherTileFloydSteinberg (main.pas:1877-1929): border cells absorb
//    the error, accumulation is unclamped, min(255, .) on output.
//
// Posterize(v) = min(255, ((v*CvtPre) div 255) * CvtPost)
// (main.pas:706-709); quantization error is always >= 0 for inputs in
// 0..255, so plain integer ops suffice.
//
// The default cBitsPerComp = 8 makes both paths identity upstream; these
// exist so the BITS_PER_COMP knob (main.pas:20) is usable at real speed
// (the Python fallback interprets ~2M loop steps per 1080p frame).

#include <algorithm>
#include <cstdint>

namespace {

inline int posterize(int v, int cvt_pre, int cvt_post) {
  return std::min(255, ((v * cvt_pre) / 255) * cvt_post);
}

}  // namespace

extern "C" {

// In-place whole-frame diffusion over interleaved RGB bytes [h*w*3].
void tiler_fs_posterize(uint8_t* px, int h, int w, int bits) {
  const int cvt_pre = (1 << bits) - 1;
  const int cvt_post = 256 / cvt_pre;
  uint8_t* p = px;
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const int ypo = (y < h - 1) ? w * 3 : 0;
      const int xpo = (x < w - 1) ? 3 : 0;
      const int xmo = (x > 0) ? -3 : 0;
      for (int c = 0; c < 3; c++) {
        const int old = *p;
        const int nw = posterize(old, cvt_pre, cvt_post);
        const int err = old - nw;
        *p = static_cast<uint8_t>(nw);
        const int offs[4] = {xpo, ypo + xmo, ypo, ypo + xpo};
        const int fac[4] = {7, 3, 5, 1};
        for (int k = 0; k < 4; k++) {
          int v = p[offs[k]] + ((err * fac[k]) >> 4);
          p[offs[k]] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
        ++p;
      }
    }
  }
}

// Per-tile diffusion: src/dst are 8x8x3 interleaved RGB.
void tiler_fs_tile(const uint8_t* src, int bits, uint8_t* dst) {
  const int cvt_pre = (1 << bits) - 1;
  const int cvt_post = 256 / cvt_pre;
  int px[10][10][3];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      for (int c = 0; c < 3; c++)
        px[y + 1][x + 1][c] = src[(y * 8 + x) * 3 + c];
  for (int y = 1; y <= 8; y++)
    for (int c = 0; c < 3; c++) {
      px[y][0][c] = px[y][1][c];
      px[y][9][c] = px[y][8][c];
    }
  for (int x = 0; x < 10; x++)
    for (int c = 0; c < 3; c++) {
      px[0][x][c] = px[1][x][c];
      px[9][x][c] = px[8][x][c];
    }
  for (int y = 1; y <= 8; y++)
    for (int x = 1; x <= 8; x++)
      for (int c = 0; c < 3; c++) {
        const int old = px[y][x][c];
        const int nw = posterize(old, cvt_pre, cvt_post);
        const int err = old - nw;
        px[y][x][c] = nw;
        px[y][x + 1][c] += (err * 7) >> 4;
        px[y + 1][x - 1][c] += (err * 3) >> 4;
        px[y + 1][x][c] += (err * 5) >> 4;
        px[y + 1][x + 1][c] += (err * 1) >> 4;
      }
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      for (int c = 0; c < 3; c++)
        dst[(y * 8 + x) * 3 + c] =
            static_cast<uint8_t>(std::min(255, px[y + 1][x + 1][c]));
}

}  // extern "C"
