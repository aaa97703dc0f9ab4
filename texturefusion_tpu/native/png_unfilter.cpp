// PNG scanline unfiltering (PNG spec §9.2-9.4) for the image reader in
// io/image.py. Average and Paeth rows chain every byte to its left
// neighbour, which numpy cannot vectorise along a row; libpng-written
// files (TUM RGB-D among them) use those filters on most rows.
//
// Exposed via extern "C" for ctypes.

#include <cstdint>
#include <cstdlib>

extern "C" {

// data: [h, 1 + stride] filtered scanlines (filter type byte first);
// out: [h, stride] bytes. Returns 0, or -1 on an unknown filter type.
int32_t png_unfilter(const uint8_t* data, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t ft = data[y * (stride + 1)];
        const uint8_t* raw = data + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        const uint8_t* prev = y ? cur - stride : nullptr;
        if (ft > 4) return -1;
        for (int64_t x = 0; x < stride; ++x) {
            const int a = x >= bpp ? cur[x - bpp] : 0;
            const int b = prev ? prev[x] : 0;
            const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
            int pred = 0;
            switch (ft) {
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int pa = std::abs(b - c), pb = std::abs(a - c);
                    const int pc = std::abs(a + b - 2 * c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: break;
            }
            cur[x] = static_cast<uint8_t>(raw[x] + pred);
        }
    }
    return 0;
}

}  // extern "C"
