// Native fast paths for the chunk codec layer: the port's own copy of the
// JAX package's native/fastpath.cpp (same functions, same bytes).
//
// Host-side equivalent of the reference's C++ codec/checksum internals
// (ytlib/table_chunk_format/*_column_writer.cpp, library/cpp/yt/coding
// varint + zigzag, core/misc checksums): varint streams for integer column
// segments, bit-packed validity bitmaps, CRC-64/XZ block checksums, and
// delta coding for sorted key columns.  Compiled once with g++ at first use
// and loaded through ctypes (no pybind11 in the image); Python fallbacks in
// native/__init__.py keep behavior identical when no compiler is available.
//
// ABI: plain C, int64/uint64/uint8 buffers, lengths as int64.

#include <cstdint>
#include <cstring>

extern "C" {

// --- zigzag varint ----------------------------------------------------------

// Encodes n int64s; returns number of bytes written (caller provides a
// buffer of at least 10*n bytes).
int64_t yt_varint_encode_zigzag(const int64_t* values, int64_t n,
                                uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = (static_cast<uint64_t>(values[i]) << 1) ^
                     static_cast<uint64_t>(values[i] >> 63);
        while (v >= 0x80) {
            *p++ = static_cast<uint8_t>(v) | 0x80;
            v >>= 7;
        }
        *p++ = static_cast<uint8_t>(v);
    }
    return p - out;
}

// Decodes n int64s from the stream; returns bytes consumed, or -1 on
// truncation.
int64_t yt_varint_decode_zigzag(const uint8_t* data, int64_t size, int64_t n,
                                int64_t* out) {
    const uint8_t* p = data;
    const uint8_t* end = data + size;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = 0;
        int shift = 0;
        while (true) {
            if (p >= end) return -1;
            uint8_t byte = *p++;
            v |= static_cast<uint64_t>(byte & 0x7F) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
        }
        out[i] = static_cast<int64_t>((v >> 1) ^ (~(v & 1) + 1));
    }
    return p - data;
}

// --- validity bitmaps -------------------------------------------------------

void yt_bitmap_pack(const uint8_t* bools, int64_t n, uint8_t* out) {
    std::memset(out, 0, (n + 7) / 8);
    for (int64_t i = 0; i < n; ++i) {
        if (bools[i]) out[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
    }
}

// Returns 0 on success, -1 if the bit buffer is too small for n bits.
int64_t yt_bitmap_unpack(const uint8_t* bits, int64_t bits_size, int64_t n,
                         uint8_t* out) {
    if (bits_size * 8 < n) return -1;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (bits[i >> 3] >> (i & 7)) & 1;
    }
    return 0;
}

// --- delta coding for sorted/clustered int columns --------------------------

void yt_delta_encode(const int64_t* values, int64_t n, int64_t* out) {
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = values[i] - prev;
        prev = values[i];
    }
}

void yt_delta_decode(const int64_t* deltas, int64_t n, int64_t* out) {
    int64_t acc = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc += deltas[i];
        out[i] = acc;
    }
}

// --- CRC-64/XZ (poly 0x42F0E1EBA9EA3693, reflected) -------------------------

static uint64_t g_crc_table[256];
static bool g_crc_init = false;

static void crc64_init() {
    const uint64_t poly = 0xC96C5795D7870F42ULL;  // reflected polynomial
    for (int i = 0; i < 256; ++i) {
        uint64_t crc = static_cast<uint64_t>(i);
        for (int j = 0; j < 8; ++j) {
            crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
        }
        g_crc_table[i] = crc;
    }
    g_crc_init = true;
}

uint64_t yt_crc64(const uint8_t* data, int64_t size, uint64_t seed) {
    if (!g_crc_init) crc64_init();
    uint64_t crc = ~seed;
    for (int64_t i = 0; i < size; ++i) {
        crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    }
    return ~crc;
}

// --- dictionary code remap (hot path of cross-chunk string unification) -----

void yt_remap_i32(const int32_t* codes, int64_t n, const int32_t* table,
                  int64_t table_size, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = codes[i];
        out[i] = (c >= 0 && c < table_size) ? table[c] : 0;
    }
}

}  // extern "C"
