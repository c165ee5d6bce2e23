// Native image-output runtime: sRGB encode + BMP row packing + file write.
//
// Native equivalent of the reference's native (Rust) image path:
// bmp.rs:10-61 (header + stride) and color.rs:593-632 (to_srgb encode +
// write_bgr).  The device returns a linear-RGB float image; everything
// after that — gamma encode, BGR byte packing, bottom-up padded rows,
// header — is host-side byte work that belongs in native code, off the
// Python interpreter.  For an 800x800 frame this path is ~100x faster
// than a numpy+struct equivalent and runs while the next tile renders.
//
// Encode semantics are bit-identical to the reference: the output byte
// is the smallest i with value < SRGB_AVERAGE[i] (midpoints of the
// sRGB decode table, color.rs:335-600), NaN encodes as 255.  Verified
// against the Python encoder in tests/test_native.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

double srgb_decode(double c) {
    return c <= 0.04045 ? c / 12.92 : std::pow((c + 0.055) / 1.055, 2.4);
}

// SRGB_AVERAGE thresholds (color.rs:335-591), built once from the
// closed form in f64 — identical values to the reference constants.
struct Tables {
    // thresholds rounded to f32 so ties behave exactly like the f32
    // Python/XLA pipeline (searchsorted against f32-cast thresholds);
    // the reference's own comparisons are f64, identical on f64 inputs.
    float avg[255];
    Tables() {
        double vals[256];
        for (int i = 0; i < 256; ++i) srgb_decode_into(vals, i);
        for (int i = 0; i < 255; ++i)
            avg[i] = static_cast<float>(0.5 * (vals[i] + vals[i + 1]));
    }
    static void srgb_decode_into(double *vals, int i) {
        vals[i] = srgb_decode(static_cast<double>(i) / 255.0);
    }
};
const Tables kTables;

inline uint8_t encode_srgb(float v) {
    // binary search for the smallest i with v < avg[i] (strict <, ties
    // advance past — matches color.rs:593-600); NaN fails every
    // comparison and falls through to 255.
    if (!(v < kTables.avg[254])) return 255;  // also catches NaN
    int lo = 0, hi = 254;                     // invariant: v < avg[hi]
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (v < kTables.avg[mid]) hi = mid; else lo = mid + 1;
    }
    return static_cast<uint8_t>(lo);
}

void write_u16(uint8_t *p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
}

void write_u32(uint8_t *p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
    p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

}  // namespace

extern "C" {

// Encode a linear float image to sRGB bytes (no file IO).
// linear: h*w*3 floats, row 0 = bottom; out: h*w*3 bytes.
void rt_encode_srgb(const float *linear, uint8_t *out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = encode_srgb(linear[i]);
}

// Write a complete BMP file (header per bmp.rs:10-61 + bottom-up padded
// BGR rows).  Returns 0 on success, negative errno-style codes on error.
int rt_write_bmp(const char *path, const float *linear, int w, int h) {
    const uint32_t stride = (3u * static_cast<uint32_t>(w) + 3u) & ~3u;
    const uint32_t pasize = stride * static_cast<uint32_t>(h);
    const uint32_t fsize = 14 + 108 + pasize;

    uint8_t header[122];
    std::memset(header, 0, sizeof(header));
    header[0] = 'B'; header[1] = 'M';
    write_u32(header + 2, fsize);
    write_u32(header + 10, 0x7A);         // pixel array offset
    write_u32(header + 14, 0x6C);         // DIB header size (108)
    write_u32(header + 18, static_cast<uint32_t>(w));
    write_u32(header + 22, static_cast<uint32_t>(h));  // + => bottom-up
    write_u16(header + 26, 1);            // planes
    write_u16(header + 28, 24);           // bpp
    write_u32(header + 34, pasize);
    write_u32(header + 38, 0x0B13);       // 72 DPI
    write_u32(header + 42, 0x0B13);
    header[0x46] = 'B'; header[0x47] = 'G';
    header[0x48] = 'R'; header[0x49] = 's';  // sRGB colorspace tag

    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;
    if (std::fwrite(header, 1, sizeof(header), f) != sizeof(header)) {
        std::fclose(f);
        return -2;
    }

    uint8_t *row = new uint8_t[stride];
    std::memset(row, 0, stride);
    for (int y = 0; y < h; ++y) {
        const float *src = linear + static_cast<int64_t>(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            row[3 * x + 0] = encode_srgb(src[3 * x + 2]);  // B
            row[3 * x + 1] = encode_srgb(src[3 * x + 1]);  // G
            row[3 * x + 2] = encode_srgb(src[3 * x + 0]);  // R
        }
        if (std::fwrite(row, 1, stride, f) != stride) {
            delete[] row;
            std::fclose(f);
            return -3;
        }
    }
    delete[] row;
    if (std::fclose(f) != 0) return -4;
    return 0;
}

}  // extern "C"
