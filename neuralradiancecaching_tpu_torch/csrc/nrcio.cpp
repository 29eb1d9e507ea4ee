// nrcio: the port's host library, the Radiance .hdr (RGBE) payload decode,
// new-style RLE scanlines and the flat fallback.
//
// This is nrc_hdr_decode of the JAX package's csrc/nrcio.cpp, copied as it
// is. That library's other entry points (the env-map CDFs, the density
// volume, the fbm cloud, the EXR writer, the idx1 reader) are called by no
// loader of either package, only by the JAX package's tests, so they are
// not copied: the port's loaders use its own Python envmap CDFs, density,
// EXR and idx1 code, as the JAX package's do.
//
// Exposed with a plain C ABI for ctypes; no external dependencies.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Radiance HDR (RGBE) decode
// ---------------------------------------------------------------------------

// Decode the pixel payload of a Radiance file (after the header) into
// float32 RGB. Returns 0 on success.
int nrc_hdr_decode(const uint8_t* data, int64_t size, int width, int height,
                   float* out_rgb) {
  int64_t bp = 0;
  std::vector<uint8_t> row(static_cast<size_t>(width) * 4);
  for (int y = 0; y < height; ++y) {
    if (width >= 8 && width < 0x8000 && bp + 4 <= size && data[bp] == 2 &&
        data[bp + 1] == 2 &&
        ((data[bp + 2] << 8) | data[bp + 3]) == width) {
      bp += 4;  // new-style RLE: 4 channel planes
      for (int c = 0; c < 4; ++c) {
        int x = 0;
        while (x < width) {
          if (bp >= size) return 1;
          int count = data[bp++];
          if (count > 128) {  // run
            count -= 128;
            if (bp >= size || x + count > width) return 1;
            uint8_t v = data[bp++];
            for (int i = 0; i < count; ++i) row[(x + i) * 4 + c] = v;
            x += count;
          } else {  // literal
            // count==0 would consume bytes without advancing x; a valid
            // encoder never emits it -- treat as corrupt input
            if (count == 0 || bp + count > size || x + count > width)
              return 1;
            for (int i = 0; i < count; ++i) row[(x + i) * 4 + c] = data[bp++];
            x += count;
          }
        }
      }
    } else {  // flat scanline
      if (bp + static_cast<int64_t>(width) * 4 > size) return 1;
      std::memcpy(row.data(), data + bp, static_cast<size_t>(width) * 4);
      bp += static_cast<int64_t>(width) * 4;
    }
    float* dst = out_rgb + static_cast<int64_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      int e = row[x * 4 + 3];
      float scale = e ? std::ldexp(1.0f, e - 136) : 0.0f;
      dst[x * 3 + 0] = row[x * 4 + 0] * scale;
      dst[x * 3 + 1] = row[x * 4 + 1] * scale;
      dst[x * 3 + 2] = row[x * 4 + 2] * scale;
    }
  }
  return 0;
}

}  // extern "C"
