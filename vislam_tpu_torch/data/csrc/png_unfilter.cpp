// PNG row unfiltering on the host (the reconstruction of PNG spec section 9):
// each of `height` rows of `src` is one filter-type byte then `stride` bytes;
// `dst` receives the reconstructed rows, `stride` bytes each. `bpp` is the
// bytes per complete pixel (1 grey, 2 grey + alpha, 3 RGB, 4 RGBA at 8 bits).
// Sub and Average and Paeth are sequential along a row, which is why this
// runs as C++ and not as numpy.
//
// Returns 0, or -(row + 1) for the first row with an unknown filter type.

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int stride,
                            int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + (size_t)y * (stride + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + (size_t)y * stride;
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:
        for (int x = 0; x < stride; ++x) out[x] = in[x];
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; ++x) out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}
