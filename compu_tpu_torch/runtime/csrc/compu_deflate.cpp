// Native raw-DEFLATE encoder (RFC 1951) for the compu_tpu host runtime.
//
// Role: the reference's encode hot loop is native libz deflate()
// (reference/src/encoder/zlib.rs:90-92); this is this framework's
// equivalent native hot loop — a from-scratch encoder, not a zlib copy:
// hash-4 head/prev chains with lazy matching, per-block histograms, an
// in-place Huffman build with iterative length limiting, and RLE-coded
// dynamic headers. Stored/fixed/dynamic block selection by computed cost.
//
// Streaming contract: compu_deflate_run consumes ONE complete input chunk
// and appends a self-contained run of deflate blocks to out; `flush`
// makes the run end byte-aligned with an empty stored block (sync flush),
// `final` marks the last block. Bit state carries across calls so
// chunked == one-shot output holds when chunk boundaries match.
//
// Framing (zlib/gzip headers + checksums) stays in Python.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int WINDOW = 32768;
constexpr int MIN_MATCH = 3;
constexpr int MAX_MATCH = 258;
constexpr int HASH_BITS = 16;
constexpr uint32_t HASH_MUL = 2654435761u;

static const uint16_t LBASE[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19,
                                   23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115,
                                   131, 163, 195, 227, 258};
static const uint8_t LXB[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                                3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t DBASE[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65,
                                   97, 129, 193, 257, 385, 513, 769, 1025, 1537,
                                   2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
static const uint8_t DXB[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
                                7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t CLORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4,
                                    12, 3, 13, 2, 14, 1, 15};

static uint8_t LCODE[MAX_MATCH + 1];   // length -> length code (0..28)
static uint8_t DCODE_LO[512];          // dist 1..512 -> dist code
static uint8_t DCODE_HI[256];          // (dist-1)>>7 -> dist code for dist>512
static bool g_init = false;

static void init_tables() {
    for (int c = 0; c < 29; c++) {
        int hi = (c == 28) ? MAX_MATCH : LBASE[c + 1] - 1;
        for (int l = LBASE[c]; l <= hi; l++) LCODE[l] = (uint8_t)c;
    }
    LCODE[MAX_MATCH] = 28;
    for (int c = 0; c < 30; c++) {
        int hi = (c == 29) ? WINDOW : DBASE[c + 1] - 1;
        for (int d = DBASE[c]; d <= hi && d <= 512; d++) DCODE_LO[d - 1] = (uint8_t)c;
        for (int d = DBASE[c]; d <= hi; d++) {
            if (d > 512) DCODE_HI[(d - 1) >> 7] = (uint8_t)c;
        }
    }
    g_init = true;
}

static inline int dist_code(uint32_t d) {
    return d <= 512 ? DCODE_LO[d - 1] : DCODE_HI[(d - 1) >> 7];
}

// ---------------------------------------------------------------------------
// Bit writer (LSB-first), append-to-byte-vector
// ---------------------------------------------------------------------------
struct BitWriter {
    uint8_t* out;
    size_t cap;
    size_t len;
    uint64_t hold;
    int bits;

    void put(uint32_t v, int n) {
        hold |= (uint64_t)v << bits;
        bits += n;
        while (bits >= 8) {
            if (len < cap) out[len] = (uint8_t)hold;
            len++;
            hold >>= 8;
            bits -= 8;
        }
    }
    void align() {
        if (bits) put(0, 8 - bits);
    }
};

// ---------------------------------------------------------------------------
// Huffman code construction: in-place Moffat-style on (freq, symbol) pairs,
// then iterative length limiting (zlib-equivalent quality for <=15 bits).
// ---------------------------------------------------------------------------
struct SymFreq { uint32_t freq; uint16_t sym; };

static int cmp_freq(const void* a, const void* b) {
    const SymFreq* x = (const SymFreq*)a;
    const SymFreq* y = (const SymFreq*)b;
    if (x->freq != y->freq) return x->freq < y->freq ? -1 : 1;
    return x->sym < y->sym ? -1 : 1;
}

// Build code lengths (<= max_len) for n symbols. lens[i] = 0 for unused.
// Two-queue Huffman (leaves sorted ascending; internal nodes are created
// in nondecreasing weight order, so a second FIFO queue suffices), then
// Kraft-rebalancing length limiting.
static void build_lengths(const uint32_t* freq, int n, int max_len, uint8_t* lens) {
    SymFreq sf[320];
    int used = 0;
    for (int i = 0; i < n; i++) {
        lens[i] = 0;
        if (freq[i]) sf[used++] = {freq[i], (uint16_t)i};
    }
    if (used == 0) return;
    if (used == 1) { lens[sf[0].sym] = 1; return; }
    qsort(sf, used, sizeof(SymFreq), cmp_freq);

    uint64_t iw[320];     // internal node weights (FIFO)
    int16_t ia[320], ib[320];  // child indices: <used = leaf, else internal-used
    int ni = 0;           // internal nodes created
    int li = 0, qi = 0;   // next leaf / next internal to consume
    while ((used - li) + (ni - qi) >= 2) {
        int16_t pick[2];
        for (int t = 0; t < 2; t++) {
            bool take_leaf =
                li < used && (qi >= ni || (uint64_t)sf[li].freq <= iw[qi]);
            if (take_leaf) pick[t] = (int16_t)li++;
            else pick[t] = (int16_t)(used + qi++);
        }
        ia[ni] = pick[0];
        ib[ni] = pick[1];
        uint64_t wa = pick[0] < used ? sf[pick[0]].freq : iw[pick[0] - used];
        uint64_t wb = pick[1] < used ? sf[pick[1]].freq : iw[pick[1] - used];
        iw[ni] = wa + wb;
        ni++;
    }
    // depths: root is the last internal; parents were created after
    // children, so a reverse walk assigns child depths in one pass.
    uint8_t idepth[320];
    idepth[ni - 1] = 0;
    uint8_t ldepth[320];
    for (int k = ni - 1; k >= 0; k--) {
        uint8_t d = (uint8_t)(idepth[k] + 1);
        int16_t c[2] = {ia[k], ib[k]};
        for (int t = 0; t < 2; t++) {
            if (c[t] < used) ldepth[c[t]] = d;
            else idepth[c[t] - used] = d;
        }
    }
    // length-limit to max_len with Kraft rebalancing.
    long kraft = 0;
    for (int i = 0; i < used; i++) {
        int l = ldepth[i];
        if (l > max_len) l = max_len;
        if (l < 1) l = 1;
        ldepth[i] = (uint8_t)l;
        kraft += 1L << (max_len - l);
    }
    // over-subscribed (clamping): lengthen the LEAST frequent symbols that
    // still have room (sf sorted ascending -> walk from the front).
    for (int i = 0; kraft > (1L << max_len) && i < used; ) {
        if (ldepth[i] < max_len) {
            kraft -= 1L << (max_len - ldepth[i]);
            ldepth[i]++;
            kraft += 1L << (max_len - ldepth[i]);
        } else i++;
    }
    // under-subscribed: shorten the MOST frequent symbols while it fits.
    for (int i = used - 1; i >= 0 && kraft < (1L << max_len); ) {
        long gain = 1L << (max_len - ldepth[i]);
        if (ldepth[i] > 1 && kraft + gain <= (1L << max_len)) {
            ldepth[i]--;
            kraft += gain;
        } else i--;
    }
    for (int i = 0; i < used; i++) lens[sf[i].sym] = ldepth[i];
}

// Canonical codes, bit-reversed for LSB-first emission.
static void build_codes(const uint8_t* lens, int n, uint16_t* codes) {
    int bl_count[16] = {0};
    for (int i = 0; i < n; i++) bl_count[lens[i]]++;
    bl_count[0] = 0;
    int next_code[16];
    int code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + bl_count[l - 1]) << 1;
        next_code[l] = code;
    }
    for (int i = 0; i < n; i++) {
        if (!lens[i]) { codes[i] = 0; continue; }
        uint32_t c = (uint32_t)next_code[lens[i]]++;
        uint32_t r = 0;
        for (int b = 0; b < lens[i]; b++) r = (r << 1) | ((c >> b) & 1);
        codes[i] = (uint16_t)(r >> 0);
    }
    // note: reversal above reverses within lens[i] bits
}

// ---------------------------------------------------------------------------
// Encoder state
// ---------------------------------------------------------------------------
struct Token { uint16_t lit_or_len; uint16_t dist; };  // dist==0 -> literal

struct DeflateState {
    int level;
    int hash_bits;
    int32_t head[1 << HASH_BITS];
    int32_t prev[WINDOW];
    // carry window: last <=32K of the previous chunk for cross-chunk... the
    // streaming backend cuts blocks at >=256K, and matches stay within the
    // chunk (window resets per chunk: block-parallel decodable streams,
    // same policy as the device path / scheduler).
    uint64_t hold;
    int bits;
};

struct LevelParams { int good, lazy_lim, nice, chain, hash3; };
static LevelParams level_params(int level) {
    switch (level) {
        case 1: return {4, 0, 8, 4, 0};
        case 2: return {4, 0, 16, 8, 0};
        case 3: return {4, 0, 32, 32, 0};
        case 4: return {4, 4, 16, 16, 0};
        case 5: return {8, 16, 32, 32, 0};
        case 6: return {8, 16, 128, 128, 0};
        case 7: return {8, 32, 128, 256, 1};
        case 8: return {32, 128, 258, 1024, 1};
        default: return {32, 258, 258, 4096, 1};
    }
}

static inline uint32_t hash4(const uint8_t* p, int hash_bits) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * HASH_MUL) >> (32 - hash_bits);
}

// 3-byte hash (zlib's granularity): finds length-3 matches and chains
// every position sharing a trigram — better parse at levels >= 7.
static inline uint32_t hash3(const uint8_t* p, int hash_bits) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * HASH_MUL) >> (32 - hash_bits);
}

static inline uint32_t match_len(const uint8_t* a, const uint8_t* b, uint32_t cap) {
    uint32_t l = 0;
    while (l + 8 <= cap) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        uint64_t diff = x ^ y;
        if (diff) return l + (uint32_t)(__builtin_ctzll(diff) >> 3);
        l += 8;
    }
    while (l < cap && a[l] == b[l]) l++;
    return l;
}

}  // namespace

extern "C" {

void* compu_deflate_new(int level) {
    if (!g_init) init_tables();
    DeflateState* s = (DeflateState*)calloc(1, sizeof(DeflateState));
    s->level = level < 1 ? 1 : (level > 9 ? 9 : level);
    s->hash_bits = HASH_BITS;
    return s;
}

void compu_deflate_free(void* p) { free(p); }

void compu_deflate_reset(void* p) {
    DeflateState* s = (DeflateState*)p;
    int lvl = s->level;
    int hb = s->hash_bits;
    memset(s, 0, sizeof(DeflateState));
    s->level = lvl;
    s->hash_bits = hb;
}

void compu_deflate_set_hash_bits(void* p, int hash_bits) {
    DeflateState* s = (DeflateState*)p;
    if (hash_bits >= 8 && hash_bits <= HASH_BITS) s->hash_bits = hash_bits;
}

// Encode one complete chunk. Returns bytes written to `out` (the caller
// sizes out >= n + n/8 + 1024). flush: end byte-aligned with an empty
// stored block; final: last chunk (bfinal set on the last block emitted).
size_t compu_deflate_run(void* p, const uint8_t* in, size_t n,
                         uint8_t* out, size_t out_cap,
                         int flush, int final_) {
    DeflateState* s = (DeflateState*)p;
    BitWriter w{out, out_cap, 0, s->hold, s->bits};
    LevelParams lp = level_params(s->level);

    // token buffer (heap; ~n/3 tokens typical, n worst case)
    size_t max_tok = n + 1;
    Token* toks = (Token*)malloc(max_tok * sizeof(Token));

    memset(s->head, -1, sizeof(int32_t) << s->hash_bits);
    uint32_t hmask = (1u << s->hash_bits) - 1;
    (void)hmask;

    size_t emitted = 0;  // input bytes already emitted as blocks
    // Split the chunk into <=64K-token blocks for local tree adaptation.
    while (emitted < n || (n == 0 && final_)) {
        size_t tcount = 0;
        size_t block_start = emitted;
        size_t i = block_start;
        // --- tokenize up to ~64K tokens or 128K input bytes ---------------
        size_t block_limit = block_start + (128 << 10);
        if (block_limit > n) block_limit = n;
        uint32_t prev_len = 0, prev_dist = 0;
        int have_prev = 0;
        while (i < block_limit || have_prev) {
            uint32_t best_len = 0, best_dist = 0;
            if (i + MIN_MATCH <= n && i + 4 <= n) {
                uint32_t h = lp.hash3 ? hash3(in + i, s->hash_bits)
                                      : hash4(in + i, s->hash_bits);
                int32_t cand = s->head[h];
                int chain = lp.chain;
                // zlib's good_match heuristic: once the carried-over lazy
                // match is already decent, spend far less on this probe.
                if (have_prev && prev_len >= (uint32_t)lp.good) chain >>= 2;
                uint32_t cap = (uint32_t)((n - i) < MAX_MATCH ? (n - i) : MAX_MATCH);
                uint32_t nice = (uint32_t)lp.nice < cap ? (uint32_t)lp.nice : cap;
                const uint8_t* base = in + i;
                while (cand >= 0 && chain-- > 0) {
                    uint32_t d = (uint32_t)(i - (size_t)cand);
                    if (d > WINDOW || d == 0) break;
                    const uint8_t* cp = in + cand;
                    // cheap rejects: candidate must beat best_len, so its
                    // byte at best_len must match (and the first byte).
                    if (best_len && (cp[best_len] != base[best_len] || cp[0] != base[0])) {
                        cand = s->prev[cand & (WINDOW - 1)];
                        continue;
                    }
                    uint32_t l = match_len(base, cp, cap);
                    if (l > best_len) {
                        best_len = l;
                        best_dist = d;
                        if (l >= nice) break;
                    }
                    int32_t nxt = s->prev[cand & (WINDOW - 1)];
                    if (nxt >= cand) break;  // cycle/stale guard
                    cand = nxt;
                }
                s->prev[i & (WINDOW - 1)] = s->head[h];
                s->head[h] = (int32_t)i;
                if (best_len == MIN_MATCH && best_dist > 4096) best_len = 0;
            }
            if (have_prev) {
                // lazy: previous match loses to a longer one here
                if (best_len > prev_len && prev_len < (uint32_t)lp.lazy_lim + MIN_MATCH) {
                    toks[tcount++] = {in[i - 1], 0};  // demote to literal
                    prev_len = best_len; prev_dist = best_dist;
                    i++;
                    continue;
                }
                // emit previous match
                toks[tcount++] = {(uint16_t)prev_len, (uint16_t)prev_dist};
                // insert hash entries for the match body. Position i was
                // ALREADY inserted by its probe this iteration — starting
                // at i would chain prev[i] to itself (head[h]==i), and any
                // later walk reaching i would spin on the self-loop until
                // its chain budget died (the bug that made levels 7-9 no
                // better than 6: deep search burned on cycles).
                size_t endp = i - 1 + prev_len;
                if (endp > n - 4) endp = n >= 4 ? n - 4 : 0;
                for (size_t k = i + 1; k < endp; k++) {
                    uint32_t h2 = lp.hash3 ? hash3(in + k, s->hash_bits)
                                           : hash4(in + k, s->hash_bits);
                    s->prev[k & (WINDOW - 1)] = s->head[h2];
                    s->head[h2] = (int32_t)k;
                }
                i = i - 1 + prev_len;
                have_prev = 0;
                prev_len = 0;
                continue;
            }
            if (best_len >= MIN_MATCH) {
                if (lp.lazy_lim > 0 && best_len < (uint32_t)lp.nice && i + 1 < block_limit) {
                    prev_len = best_len; prev_dist = best_dist;
                    have_prev = 1;
                    i++;
                    continue;
                }
                toks[tcount++] = {(uint16_t)best_len, (uint16_t)best_dist};
                size_t endp = i + best_len;
                if (endp > n - 4) endp = n >= 4 ? n - 4 : 0;
                for (size_t k = i + 1; k < endp; k++) {
                    uint32_t h2 = lp.hash3 ? hash3(in + k, s->hash_bits)
                                           : hash4(in + k, s->hash_bits);
                    s->prev[k & (WINDOW - 1)] = s->head[h2];
                    s->head[h2] = (int32_t)k;
                }
                i += best_len;
            } else {
                if (i < n) toks[tcount++] = {in[i], 0};
                i++;
            }
            if (i >= n) break;
        }
        size_t block_end = i < n ? i : n;

        // --- histograms ---------------------------------------------------
        uint32_t lfreq[288] = {0}, dfreq[30] = {0};
        long extra_bits = 0;
        for (size_t t = 0; t < tcount; t++) {
            if (toks[t].dist == 0) {
                lfreq[toks[t].lit_or_len]++;
            } else {
                int lc = LCODE[toks[t].lit_or_len];
                lfreq[257 + lc]++;
                int dc = dist_code(toks[t].dist);
                dfreq[dc]++;
                extra_bits += LXB[lc] + DXB[dc];
            }
        }
        lfreq[256]++;  // EOB

        // --- trees + costs --------------------------------------------------
        uint8_t llen[288], dlen[30];
        build_lengths(lfreq, 286, 15, llen);
        build_lengths(dfreq, 30, 15, dlen);
        // Complete 2-code minimum distance tree (strict inflates reject
        // incomplete dynamic trees; a lone 1-bit code is incomplete).
        {
            int dused = 0, first_unused = -1;
            for (int k = 0; k < 30; k++) {
                if (dlen[k]) dused++;
                else if (first_unused < 0) first_unused = k;
            }
            if (dused == 0) { dlen[0] = 1; dlen[1] = 1; }
            else if (dused == 1) {
                for (int k = 0; k < 30; k++) if (dlen[k]) dlen[k] = 1;
                dlen[first_unused] = 1;
            }
        }
        uint16_t lcode[288], dcode[30];
        build_codes(llen, 286, lcode);
        build_codes(dlen, 30, dcode);

        long dyn_body = extra_bits;
        for (int k = 0; k < 286; k++) dyn_body += (long)lfreq[k] * llen[k];
        for (int k = 0; k < 30; k++) dyn_body += (long)dfreq[k] * dlen[k];
        long fix_body = extra_bits;
        for (int k = 0; k < 286; k++)
            fix_body += (long)lfreq[k] * (k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : 8);
        for (int k = 0; k < 30; k++) fix_body += (long)dfreq[k] * 5;

        // --- dynamic header via RLE of code lengths ------------------------
        // build the CL symbol stream
        uint8_t all[318];
        int hlit = 286, hdist = 30;
        while (hlit > 257 && llen[hlit - 1] == 0) hlit--;
        while (hdist > 1 && dlen[hdist - 1] == 0) hdist--;
        int nall = 0;
        for (int k = 0; k < hlit; k++) all[nall++] = llen[k];
        for (int k = 0; k < hdist; k++) all[nall++] = dlen[k];
        uint8_t clsyms[640]; uint8_t clextra_bits[640]; uint16_t clextra_val[640];
        int ncl = 0;
        uint32_t clfreq[19] = {0};
        for (int k = 0; k < nall; ) {
            int v = all[k];
            int run = 1;
            while (k + run < nall && all[k + run] == v) run++;
            if (v == 0) {
                while (run >= 3) {
                    int take = run > 138 ? 138 : run;
                    if (take >= 11) {
                        clsyms[ncl] = 18; clextra_bits[ncl] = 7;
                        clextra_val[ncl] = (uint16_t)(take - 11);
                    } else {
                        clsyms[ncl] = 17; clextra_bits[ncl] = 3;
                        clextra_val[ncl] = (uint16_t)(take - 3);
                    }
                    clfreq[clsyms[ncl]]++; ncl++;
                    run -= take; k += take;
                }
                while (run-- > 0) { clsyms[ncl] = 0; clextra_bits[ncl] = 0; clextra_val[ncl] = 0; clfreq[0]++; ncl++; k++; }
            } else {
                // first occurrence literal, repeats via 16
                clsyms[ncl] = (uint8_t)v; clextra_bits[ncl] = 0; clextra_val[ncl] = 0;
                clfreq[v]++; ncl++; k++;
                run--;
                while (run >= 3) {
                    int take = run > 6 ? 6 : run;
                    clsyms[ncl] = 16; clextra_bits[ncl] = 2;
                    clextra_val[ncl] = (uint16_t)(take - 3);
                    clfreq[16]++; ncl++;
                    run -= take; k += take;
                }
                while (run-- > 0) { clsyms[ncl] = (uint8_t)v; clextra_bits[ncl] = 0; clextra_val[ncl] = 0; clfreq[v]++; ncl++; k++; }
            }
        }
        uint8_t cllen[19]; uint16_t clcode[19];
        build_lengths(clfreq, 19, 7, cllen);
        build_codes(cllen, 19, clcode);
        int hclen = 19;
        while (hclen > 4 && cllen[CLORDER[hclen - 1]] == 0) hclen--;
        long hdr_bits = 3 + 5 + 5 + 4 + 3L * hclen;
        for (int k = 0; k < ncl; k++) hdr_bits += cllen[clsyms[k]] + clextra_bits[k];

        long dyn_cost = hdr_bits + dyn_body;
        long fix_cost = 3 + fix_body;
        size_t block_bytes = block_end - block_start;
        long stored_cost = 8L * (long)(block_bytes + 5 * ((block_bytes + 65534) / 65535))
                           + (w.bits ? (8 - w.bits) : 0);

        int is_last = final_ && block_end >= n;

        if (stored_cost < dyn_cost && stored_cost < fix_cost && block_bytes > 0) {
            // stored block(s)
            size_t off = block_start;
            while (off < block_end) {
                size_t take = block_end - off;
                if (take > 65535) take = 65535;
                int lastchunk = is_last && (off + take == block_end);
                w.put(lastchunk ? 1 : 0, 1);
                w.put(0, 2);
                w.align();
                w.put((uint32_t)take & 0xFF, 8);
                w.put(((uint32_t)take >> 8) & 0xFF, 8);
                uint32_t nlen = (uint32_t)take ^ 0xFFFF;
                w.put(nlen & 0xFF, 8);
                w.put((nlen >> 8) & 0xFF, 8);
                for (size_t k = 0; k < take; k++) w.put(in[off + k], 8);
                off += take;
            }
        } else {
            int use_dyn = dyn_cost < fix_cost;
            w.put(is_last ? 1 : 0, 1);
            w.put(use_dyn ? 2 : 1, 2);
            uint16_t* lc = lcode; uint8_t* ll = llen;
            uint16_t* dc = dcode; uint8_t* dl = dlen;
            static uint16_t flcode[288]; static uint8_t fllen[288];
            static uint16_t fdcode[30]; static uint8_t fdlen[30];
            static bool fixed_built = false;
            if (!use_dyn) {
                if (!fixed_built) {
                    for (int k = 0; k < 288; k++)
                        fllen[k] = k < 144 ? 8 : k < 256 ? 9 : k < 280 ? 7 : 8;
                    build_codes(fllen, 288, flcode);
                    for (int k = 0; k < 30; k++) fdlen[k] = 5;
                    build_codes(fdlen, 30, fdcode);
                    fixed_built = true;
                }
                lc = flcode; ll = fllen; dc = fdcode; dl = fdlen;
            } else {
                w.put((uint32_t)(hlit - 257), 5);
                w.put((uint32_t)(hdist - 1), 5);
                w.put((uint32_t)(hclen - 4), 4);
                for (int k = 0; k < hclen; k++) w.put(cllen[CLORDER[k]], 3);
                for (int k = 0; k < ncl; k++) {
                    w.put(clcode[clsyms[k]], cllen[clsyms[k]]);
                    if (clextra_bits[k]) w.put(clextra_val[k], clextra_bits[k]);
                }
            }
            for (size_t t = 0; t < tcount; t++) {
                if (toks[t].dist == 0) {
                    int sym = toks[t].lit_or_len;
                    w.put(lc[sym], ll[sym]);
                } else {
                    int len = toks[t].lit_or_len;
                    int lcod = LCODE[len];
                    w.put(lc[257 + lcod], ll[257 + lcod]);
                    if (LXB[lcod]) w.put((uint32_t)(len - LBASE[lcod]), LXB[lcod]);
                    int d = toks[t].dist;
                    int dcod = dist_code((uint32_t)d);
                    w.put(dc[dcod], dl[dcod]);
                    if (DXB[dcod]) w.put((uint32_t)(d - DBASE[dcod]), DXB[dcod]);
                }
            }
            w.put(lc[256], ll[256]);  // EOB
        }
        emitted = block_end;
        if (n == 0) break;
    }

    if (flush && !final_) {
        // sync flush: empty stored block, byte-aligned
        w.put(0, 1);
        w.put(0, 2);
        w.align();
        w.put(0x0000 & 0xFF, 8); w.put(0, 8);
        w.put(0xFF, 8); w.put(0xFF, 8);
    }
    if (final_) w.align();

    s->hold = w.hold;
    s->bits = w.bits;
    free(toks);
    return w.len;
}

}  // extern "C"
