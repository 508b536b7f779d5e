// Native host runtime for compu_tpu.
//
// The reference implements its runtime layer natively (the C-ABI allocator
// bridge in src/mem.rs, the fixed staging buffer in src/buffer.rs, with the
// codec hot loops in native libraries). Here the codec compute path is
// JAX/XLA on the TPU; this module is the native *host* runtime around it:
//
//  - slice-by-8 crc32 / vectorizable adler32 / xxh64: the host side of the
//    framing path (device kernels produce per-block partials; these cover
//    host-only flows and verification at IO speed);
//  - size-headered aligned allocation (compu_malloc/compu_free), mirroring
//    the reference's allocator bridge design (mem.rs:27-48: the allocation
//    size is stored in a header preceding the returned pointer).
//
// Built with: g++ -O3 -shared -fPIC -o libcompu_runtime.so compu_runtime.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// crc32 (gzip polynomial, slice-by-16: two independent 8-byte streams per
// iteration break the per-load table-lookup dependency chain)
// ---------------------------------------------------------------------------
static uint32_t g_crc_tables[16][256];
static bool g_crc_init = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
        g_crc_tables[0][i] = c;
    }
    for (int t = 1; t < 16; t++)
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = g_crc_tables[t - 1][i];
            g_crc_tables[t][i] = g_crc_tables[0][c & 0xFF] ^ (c >> 8);
        }
    g_crc_init = true;
}

uint32_t compu_crc32(const uint8_t* data, size_t n, uint32_t crc) {
    if (!g_crc_init) crc_init();
    crc = ~crc;
    while (n && ((uintptr_t)data & 7)) {
        crc = g_crc_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
        n--;
    }
    while (n >= 16) {
        uint64_t w1, w2;
        memcpy(&w1, data, 8);
        memcpy(&w2, data + 8, 8);
        w1 ^= crc;  // low 4 bytes fold in the register
        crc = g_crc_tables[15][w1 & 0xFF] ^ g_crc_tables[14][(w1 >> 8) & 0xFF] ^
              g_crc_tables[13][(w1 >> 16) & 0xFF] ^ g_crc_tables[12][(w1 >> 24) & 0xFF] ^
              g_crc_tables[11][(w1 >> 32) & 0xFF] ^ g_crc_tables[10][(w1 >> 40) & 0xFF] ^
              g_crc_tables[9][(w1 >> 48) & 0xFF] ^ g_crc_tables[8][(w1 >> 56) & 0xFF] ^
              g_crc_tables[7][w2 & 0xFF] ^ g_crc_tables[6][(w2 >> 8) & 0xFF] ^
              g_crc_tables[5][(w2 >> 16) & 0xFF] ^ g_crc_tables[4][(w2 >> 24) & 0xFF] ^
              g_crc_tables[3][(w2 >> 32) & 0xFF] ^ g_crc_tables[2][(w2 >> 40) & 0xFF] ^
              g_crc_tables[1][(w2 >> 48) & 0xFF] ^ g_crc_tables[0][(w2 >> 56) & 0xFF];
        data += 16;
        n -= 16;
    }
    while (n--) crc = g_crc_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// ---------------------------------------------------------------------------
// adler32 (16-lane inner step: the b accumulation becomes a weighted dot
// product the compiler can vectorize, instead of a serial a/b chain)
// ---------------------------------------------------------------------------
uint32_t compu_adler32(const uint8_t* data, size_t n, uint32_t adler) {
    const uint32_t MOD = 65521;
    uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    while (n) {
        size_t chunk = n > 5552 ? 5552 : n;  // max bytes before overflow
        n -= chunk;
        while (chunk >= 16) {
            uint32_t s = 0, w = 0;
            for (int j = 0; j < 16; j++) {
                s += data[j];
                w += (uint32_t)(16 - j) * data[j];
            }
            b += 16 * a + w;
            a += s;
            data += 16;
            chunk -= 16;
        }
        for (size_t i = 0; i < chunk; i++) {
            a += data[i];
            b += a;
        }
        data += chunk;
        a %= MOD;
        b %= MOD;
    }
    return (b << 16) | a;
}

// ---------------------------------------------------------------------------
// xxh64 (zstd content checksum)
// ---------------------------------------------------------------------------
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t compu_xxh64(const uint8_t* data, size_t n, uint64_t seed) {
    const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
    const uint8_t* end = data + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            uint64_t k;
            memcpy(&k, data, 8); v1 = rotl64(v1 + k * P2, 31) * P1; data += 8;
            memcpy(&k, data, 8); v2 = rotl64(v2 + k * P2, 31) * P1; data += 8;
            memcpy(&k, data, 8); v3 = rotl64(v3 + k * P2, 31) * P1; data += 8;
            memcpy(&k, data, 8); v4 = rotl64(v4 + k * P2, 31) * P1; data += 8;
        } while (data <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        uint64_t vs[4] = {v1, v2, v3, v4};
        for (int i = 0; i < 4; i++) {
            h ^= rotl64(vs[i] * P2, 31) * P1;
            h = h * P1 + P4;
        }
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    while (data + 8 <= end) {
        uint64_t k;
        memcpy(&k, data, 8);
        h ^= rotl64(k * P2, 31) * P1;
        h = rotl64(h, 27) * P1 + P4;
        data += 8;
    }
    if (data + 4 <= end) {
        uint32_t k;
        memcpy(&k, data, 4);
        h ^= (uint64_t)k * P1;
        h = rotl64(h, 23) * P2 + P3;
        data += 4;
    }
    while (data < end) {
        h ^= (*data++) * P5;
        h = rotl64(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------------------
// Size-headered aligned allocation (the mem.rs bridge design): the
// allocation size lives in a header before the returned pointer so free
// needs no external bookkeeping.
// ---------------------------------------------------------------------------
static const size_t COMPU_ALIGN = 64;  // cache-line/DMA friendly

void* compu_malloc(size_t size) {
    size_t total = size + COMPU_ALIGN;
    void* raw = aligned_alloc(COMPU_ALIGN, (total + COMPU_ALIGN - 1) & ~(COMPU_ALIGN - 1));
    if (!raw) return nullptr;
    *(size_t*)raw = size;
    return (uint8_t*)raw + COMPU_ALIGN;
}

void compu_free(void* ptr) {
    if (!ptr) return;
    free((uint8_t*)ptr - COMPU_ALIGN);
}

size_t compu_alloc_size(void* ptr) {
    if (!ptr) return 0;
    return *(size_t*)((uint8_t*)ptr - COMPU_ALIGN);
}

}  // extern "C"
