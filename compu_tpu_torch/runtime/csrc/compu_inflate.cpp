// Native raw-DEFLATE decoder (RFC 1951) for the compu_tpu host runtime.
//
// Role: the reference delegates its decode hot loop to native libz
// (reference/src/decoder/zlib.rs:97 -> inflate()); this is the
// equivalent native hot loop for this framework's host path — a from-
// scratch table-driven decoder, NOT a copy of zlib (different structure;
// see below). Framing (zlib/gzip headers + checksums) stays in Python;
// this handles raw deflate blocks only.
//
// r5 rebuild (VERDICT r4 item 6): the r2 decoder used flat 2^15 LUTs
// (64 KiB per tree — cache-hostile, and 2x32K entry fills per dynamic
// block bound foreign zlib streams that emit blocks every ~16-64 KiB)
// and refilled the bit reader byte-by-byte. This version applies the
// structure that took the zstd decoder to 1.2 GB/s:
//   * two-level decode tables: 11-bit primary (litlen) / 8-bit (dist)
//     with per-slot subtables for longer codes; entries pack kind, base
//     value, extra-bit count and total code bits into one u32, so the
//     hot loop never touches LBASE/DBASE;
//   * branchless 64-bit refill (one 8-byte load per token iteration);
//   * a margin-guarded fastloop (no per-token bounds checks; up to three
//     literals per refill) falling back to the original resumable
//     careful loop near input/output edges;
//   * overlap copies by 8-byte words with doubling for short distances.
//
// Resumable contract (mirrors the streaming state machine the Python
// backends implement, reference src/decoder/mod.rs:150-157):
//   compu_inflate_run(state, in, in_len, out, out_cap, &consumed, &written)
//     -> 0 NEED_INPUT (consumed bytes up to the last complete token)
//        1 NEED_OUTPUT (out full; feed the SAME remaining input again)
//        2 DONE (final block's EOB reached; consumed includes byte align)
//       <0 error (COMPU_EBLOCK/.../COMPU_EDIST)
//
// Built into libcompu_runtime.so (see build line in compu_runtime.cpp).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int WINDOW = 32768;
constexpr int MAXBITS = 15;
constexpr int LIT_TB = 11;   // litlen primary table bits
constexpr int DIST_TB = 8;   // dist primary table bits

// status codes
constexpr int NEED_INPUT = 0;
constexpr int NEED_OUTPUT = 1;
constexpr int DONE = 2;
constexpr int EBLOCK = -1;   // bad block type
constexpr int ESTORED = -2;  // LEN/NLEN mismatch
constexpr int ECODES = -3;   // invalid code lengths / oversubscribed tree
constexpr int ESYM = -4;     // invalid symbol
constexpr int EDIST = -5;    // distance too far back

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

// ---------------------------------------------------------------------------
// Decode entry (u32):
//   [31:30] kind: 0 = len/dist symbol, 1 = literal, 2 = EOB, 3 = subtable ptr
//   [29:25] extra-bit count (len 0..5, dist 0..13); subptr: sub index bits
//   [24:10] base value (len 3..258, dist 1..24577); subptr: subtable offset
//   [3:0]   code bits to drop (TOTAL, incl. primary bits for sub entries);
//           0 marks an unfilled (invalid) slot
// ---------------------------------------------------------------------------
constexpr uint32_t K_SYM = 0u << 30, K_LIT = 1u << 30, K_EOB = 2u << 30,
                   K_SUB = 3u << 30;
static inline uint32_t mk(uint32_t kind, uint32_t extra, uint32_t base,
                          uint32_t bits) {
    return kind | (extra << 25) | (base << 10) | bits;
}
static inline uint32_t e_kind(uint32_t e) { return e >> 30; }
static inline uint32_t e_extra(uint32_t e) { return (e >> 25) & 31; }
static inline uint32_t e_base(uint32_t e) { return (e >> 10) & 0x7FFF; }
static inline uint32_t e_bits(uint32_t e) { return e & 15; }

struct Dtable {
    const uint32_t* pri;
    const uint32_t* sub;
    int tb;
};

struct TableStore {
    uint32_t lit_pri[1 << LIT_TB];
    uint32_t lit_sub[4608];   // <= 288 long codes x 2^(15-11) entries
    uint32_t dist_pri[1 << DIST_TB];
    uint32_t dist_sub[4096];  // <= 30 slots x 2^(15-8), sparse in practice
};

static uint32_t rev_bits(uint32_t v, int n) {
    uint32_t r = 0;
    for (int i = 0; i < n; i++) r = (r << 1) | ((v >> i) & 1);
    return r;
}

// Make the semantic entry for symbol `sym` (litlen or dist alphabet).
static uint32_t sym_entry(int sym, int bits, bool is_dist) {
    if (is_dist) {
        if (sym >= 30) return 0;  // reserved codes: invalid at decode time
        return mk(K_SYM, DXB[sym], DBASE[sym], bits);
    }
    if (sym < 256) return mk(K_LIT, 0, (uint32_t)sym, bits);
    if (sym == 256) return mk(K_EOB, 0, 0, bits);
    int code = sym - 257;
    if (code >= 29) return 0;  // 286/287: invalid at decode time
    return mk(K_SYM, LXB[code], LBASE[code], bits);
}

// Build a two-level table from code lengths. Returns false on an
// oversubscribed code, or (unless `allow_incomplete`) an incomplete one
// with more than one used symbol (zlib's single-code-distance-tree rule).
static bool build_table(uint32_t* pri, int tb, uint32_t* sub, int sub_cap,
                        const uint8_t* lens, int n, bool is_dist,
                        bool allow_incomplete) {
    int count[MAXBITS + 1] = {0};
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    int codes[MAXBITS + 1];
    int code = 0;
    long kraft = 0;
    for (int l = 1; l <= MAXBITS; l++) {
        code = (code + count[l - 1]) << 1;
        codes[l] = code;
        kraft += (long)count[l] << (MAXBITS - l);
    }
    if (kraft > (1L << MAXBITS)) return false;  // oversubscribed
    if (kraft < (1L << MAXBITS) && !allow_incomplete) {
        int used = 0;
        for (int l = 1; l <= MAXBITS; l++) used += count[l];
        if (used > 1) return false;
    }
    memset(pri, 0, sizeof(uint32_t) << tb);
    const uint32_t pmask = (1u << tb) - 1;

    // Pass 1: per-slot max length of codes longer than tb (subtable sizes).
    uint8_t slot_bits[1 << LIT_TB];  // big enough for either tb
    bool any_long = false;
    {
        int c2[MAXBITS + 1];
        memcpy(c2, codes, sizeof(c2));
        for (int i = 0; i < n; i++) {
            int l = lens[i];
            if (!l) continue;
            uint32_t rv = rev_bits((uint32_t)c2[l]++, l);
            if (l > tb) {
                if (!any_long) { memset(slot_bits, 0, sizeof(uint8_t) << tb); any_long = true; }
                uint32_t p = rv & pmask;
                if (l - tb > slot_bits[p]) slot_bits[p] = (uint8_t)(l - tb);
            }
        }
    }
    // Allocate subtable offsets; plant subptr entries in the primary.
    int sub_used = 0;
    int slot_off[1 << LIT_TB];
    if (any_long) {
        for (uint32_t p = 0; p <= pmask; p++) {
            if (!slot_bits[p]) continue;
            int sz = 1 << slot_bits[p];
            if (sub_used + sz > sub_cap) return false;  // cannot happen for valid trees
            slot_off[p] = sub_used;
            memset(sub + sub_used, 0, sizeof(uint32_t) * sz);
            pri[p] = mk(K_SUB, slot_bits[p], (uint32_t)sub_used, (uint32_t)tb);
            sub_used += sz;
        }
    }
    // Pass 2: fill entries.
    for (int i = 0; i < n; i++) {
        int l = lens[i];
        if (!l) continue;
        uint32_t rv = rev_bits((uint32_t)codes[l]++, l);
        uint32_t e = sym_entry(i, l, is_dist);
        if (l <= tb) {
            for (uint32_t k = rv; k <= pmask; k += (1u << l)) pri[k] = e;
        } else {
            uint32_t p = rv & pmask;
            int sb = slot_bits[p];
            uint32_t hi = rv >> tb;  // next (l - tb) stream bits, LSB-first
            for (uint32_t k = hi; k < (1u << sb); k += (1u << (l - tb)))
                sub[slot_off[p] + k] = e;
        }
    }
    return true;
}

struct InflateState {
    // phase: 0 = block header, 1 = stored, 2 = tokens, 3 = done
    int phase;
    int final_block;
    uint32_t stored_remaining;
    // fused framing checksum over produced bytes (0 = off, 1 = adler32,
    // 2 = crc32) — saves the caller a second pass over the output
    int check_mode;
    uint32_t check;
    // partial match spill: a match that overflows out_cap copies what fits
    // and resumes here next call (the output buffer fills EXACTLY, the
    // libz NeedOutput contract the partial-buffer tests pin)
    uint32_t copy_len, copy_dist;
    TableStore t;
    // sliding window of the last <=32K decoded bytes (ring)
    uint8_t window[WINDOW];
    uint32_t wpos;     // next write position in the ring
    uint32_t whave;    // valid bytes in the ring
    // bit-level resume: leftover bits from the last consumed byte span
    uint64_t bitbuf;
    int bitcnt;
};

static inline uint64_t load64le(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;  // little-endian hosts only (same assumption as the runtime)
}

struct Reader {
    const uint8_t* in;
    size_t len;
    size_t pos;        // next byte to load
    uint64_t buf;
    int cnt;

    bool fill(int need) {
        while (cnt < need) {
            if (pos >= len) return false;
            buf |= (uint64_t)in[pos++] << cnt;
            cnt += 8;
        }
        return true;
    }
    uint32_t peek(int n) const { return (uint32_t)(buf & ((1u << n) - 1)); }
    void drop(int n) { buf >>= n; cnt -= n; }
    bool read(int n, uint32_t* v) {
        if (!fill(n)) return false;
        *v = (uint32_t)(buf & ((1ull << n) - 1));
        drop(n);
        return true;
    }
    void align() { int r = cnt & 7; buf >>= r; cnt -= r; }
    // bytes consumed if we stop now, counting unconsumed whole bytes in buf
    size_t consumed() const { return pos - (size_t)(cnt >> 3); }
};

// Careful-path table probe. Correctness under starvation matches the old
// flat-LUT logic: missing high bits read as zeros, and the result is
// trusted only when the entry's total bits <= cnt (then the code was a
// prefix of real bits). Returns the entry; *starved set when more input
// could change the answer.
static inline uint32_t probe_careful(const Dtable& t, Reader& r,
                                     bool* starved) {
    *starved = false;
    r.fill(MAXBITS);
    uint32_t e = t.pri[(uint32_t)r.buf & ((1u << t.tb) - 1)];
    if (e_kind(e) == 3) {
        uint32_t sb = e_extra(e);
        e = t.sub[e_base(e) + (((uint32_t)(r.buf >> t.tb)) & ((1u << sb) - 1))];
    }
    uint32_t b = e_bits(e);
    if (b == 0) {
        // unfilled slot: a real error only when 15 bits were available
        if (r.cnt < MAXBITS) *starved = true;
        return 0;
    }
    if ((int)b > r.cnt) { *starved = true; return 0; }
    return e;
}

static void window_push(InflateState* s, const uint8_t* data, size_t n) {
    if (n >= WINDOW) {
        memcpy(s->window, data + n - WINDOW, WINDOW);
        s->wpos = 0;
        s->whave = WINDOW;
        return;
    }
    size_t first = WINDOW - s->wpos;
    if (first > n) first = n;
    memcpy(s->window + s->wpos, data, first);
    if (n > first) memcpy(s->window, data + first, n - first);
    s->wpos = (s->wpos + (uint32_t)n) % WINDOW;
    s->whave = s->whave + (uint32_t)n > WINDOW ? WINDOW : s->whave + (uint32_t)n;
}

// Overlap-safe match copy with 8-byte words. May write up to 7 bytes past
// dst + length (callers guarantee slack). dist >= 1, length >= 1.
static inline void copy_match(uint8_t* dst, uint32_t dist, uint32_t length) {
    const uint8_t* src = dst - dist;
    if (dist >= 8) {
        uint8_t* end = dst + length;
        do {
            memcpy(dst, src, 8);
            dst += 8;
            src += 8;
        } while (dst < end);
        return;
    }
    if (dist == 1) {
        memset(dst, src[0], length + 7);
        return;
    }
    // Seed one dist-run, then double the copied span (the source region is
    // periodic with period dist and `have` stays a multiple of dist except
    // on the final, capped copy — which ends the loop). Overshoot <= 7.
    uint32_t have = dist;
    for (uint32_t k = 0; k < dist; k++) dst[k] = src[k];
    while (have < length) {
        uint32_t n = length + 7 - have;
        if (n > have) n = have;
        memcpy(dst + have, dst, n);
        have += n;
    }
}

}  // namespace

extern "C" {

// framing checksum primitives (compu_runtime.cpp, same shared object)
uint32_t compu_crc32(const uint8_t* data, size_t n, uint32_t crc);
uint32_t compu_adler32(const uint8_t* data, size_t n, uint32_t adler);

void* compu_inflate_new() {
    InflateState* s = (InflateState*)calloc(1, sizeof(InflateState));
    if (s) s->check = 1;  // adler32 seed; harmless for the other modes
    return s;
}

void compu_inflate_free(void* p) { free(p); }

void compu_inflate_reset(void* p) {
    InflateState* s = (InflateState*)p;
    int mode = s->check_mode;  // config survives reset (the reference's
    memset(s, 0, sizeof(InflateState));  // opts-survive-reset contract)
    s->check_mode = mode;
    s->check = mode == 1 ? 1 : 0;
}

void compu_inflate_set_check(void* p, int mode) {
    InflateState* s = (InflateState*)p;
    s->check_mode = mode;
    s->check = mode == 1 ? 1 : 0;
}

uint32_t compu_inflate_get_check(void* p) {
    return ((InflateState*)p)->check;
}

int compu_inflate_run(void* p, const uint8_t* in, size_t in_len,
                      uint8_t* out, size_t out_cap,
                      size_t* in_consumed, size_t* out_written) {
    InflateState* s = (InflateState*)p;
    Reader r{in, in_len, 0, s->bitbuf, s->bitcnt};
    size_t op = 0;  // bytes written to out
    const Dtable lit{s->t.lit_pri, s->t.lit_sub, LIT_TB};
    const Dtable dst_t{s->t.dist_pri, s->t.dist_sub, DIST_TB};

    // checkpoints for token-boundary rollback
    uint64_t ck_buf = r.buf;
    int ck_cnt = r.cnt;
    size_t ck_pos = r.pos;
    size_t ck_op = 0;
    int status = NEED_INPUT;

#define SAVE_CK() (ck_buf = r.buf, ck_cnt = r.cnt, ck_pos = r.pos, ck_op = op)
#define ROLLBACK() (r.buf = ck_buf, r.cnt = ck_cnt, r.pos = ck_pos, op = ck_op)

    for (;;) {
        if (s->phase == 3) { status = DONE; break; }
        if (s->phase == 0) {
            SAVE_CK();
            uint32_t hdr;
            if (!r.read(3, &hdr)) { ROLLBACK(); status = NEED_INPUT; break; }
            s->final_block = hdr & 1;
            int btype = hdr >> 1;
            if (btype == 0) {
                r.align();
                uint32_t len, nlen;
                if (!r.read(16, &len) || !r.read(16, &nlen)) {
                    ROLLBACK(); status = NEED_INPUT; break;
                }
                if ((len ^ 0xFFFF) != nlen) { status = ESTORED; break; }
                s->stored_remaining = len;
                s->phase = 1;
            } else if (btype == 1) {
                uint8_t ll[288], dl[30];
                for (int i = 0; i < 144; i++) ll[i] = 8;
                for (int i = 144; i < 256; i++) ll[i] = 9;
                for (int i = 256; i < 280; i++) ll[i] = 7;
                for (int i = 280; i < 288; i++) ll[i] = 8;
                for (int i = 0; i < 30; i++) dl[i] = 5;
                build_table(s->t.lit_pri, LIT_TB, s->t.lit_sub, 4608, ll, 288,
                            false, false);
                // 30-code fixed dist tree is incomplete by spec
                build_table(s->t.dist_pri, DIST_TB, s->t.dist_sub, 4096, dl,
                            30, true, true);
                s->phase = 2;
            } else if (btype == 2) {
                uint32_t hlit, hdist, hclen;
                if (!r.read(5, &hlit) || !r.read(5, &hdist) || !r.read(4, &hclen)) {
                    ROLLBACK(); status = NEED_INPUT; break;
                }
                hlit += 257; hdist += 1; hclen += 4;
                uint8_t cl[19] = {0};
                bool starved = false;
                for (uint32_t i = 0; i < hclen; i++) {
                    uint32_t v;
                    if (!r.read(3, &v)) { starved = true; break; }
                    cl[CLORDER[i]] = (uint8_t)v;
                }
                if (starved) { ROLLBACK(); status = NEED_INPUT; break; }
                // CL tree: max length 7 -> one tiny flat LUT
                uint32_t clt[128];
                {
                    int ccount[8] = {0};
                    for (int i = 0; i < 19; i++) ccount[cl[i]]++;
                    ccount[0] = 0;
                    int ccodes[8];
                    int ccode = 0;
                    long kraft = 0;
                    for (int l = 1; l <= 7; l++) {
                        ccode = (ccode + ccount[l - 1]) << 1;
                        ccodes[l] = ccode;
                        kraft += (long)ccount[l] << (7 - l);
                    }
                    if (kraft != (1L << 7)) { status = ECODES; break; }
                    memset(clt, 0, sizeof(clt));
                    for (int i = 0; i < 19; i++) {
                        int l = cl[i];
                        if (!l) continue;
                        uint32_t c = rev_bits((uint32_t)ccodes[l]++, l);
                        for (uint32_t k = c; k < 128u; k += (1u << l))
                            clt[k] = ((uint32_t)l << 8) | (uint32_t)i;
                    }
                }
                uint8_t lens[288 + 32] = {0};
                uint32_t i = 0;
                int err = 0;
                while (i < hlit + hdist) {
                    r.fill(7);
                    uint32_t e = clt[(uint32_t)r.buf & 127];
                    int bits = (int)(e >> 8), sym = (int)(e & 0xFF);
                    if (bits == 0) {
                        if (r.cnt >= 7) { err = ECODES; break; }
                        starved = true; break;
                    }
                    if (bits > r.cnt) { starved = true; break; }
                    r.drop(bits);
                    if (sym < 16) {
                        lens[i++] = (uint8_t)sym;
                    } else if (sym == 16) {
                        uint32_t rep;
                        if (i == 0) { err = ECODES; break; }
                        if (!r.read(2, &rep)) { starved = true; break; }
                        rep += 3;
                        if (i + rep > hlit + hdist) { err = ECODES; break; }
                        for (uint32_t k = 0; k < rep; k++) { lens[i] = lens[i - 1]; i++; }
                    } else if (sym == 17) {
                        uint32_t rep;
                        if (!r.read(3, &rep)) { starved = true; break; }
                        rep += 3;
                        if (i + rep > hlit + hdist) { err = ECODES; break; }
                        i += rep;
                    } else {
                        uint32_t rep;
                        if (!r.read(7, &rep)) { starved = true; break; }
                        rep += 11;
                        if (i + rep > hlit + hdist) { err = ECODES; break; }
                        i += rep;
                    }
                }
                if (err) { status = err; break; }
                if (starved) { ROLLBACK(); status = NEED_INPUT; break; }
                if (lens[256] == 0) { status = ECODES; break; }
                if (!build_table(s->t.lit_pri, LIT_TB, s->t.lit_sub, 4608,
                                 lens, (int)hlit, false, false)) {
                    status = ECODES; break;
                }
                if (!build_table(s->t.dist_pri, DIST_TB, s->t.dist_sub, 4096,
                                 lens + hlit, (int)hdist, true, true)) {
                    status = ECODES; break;
                }
                s->phase = 2;
            } else {
                status = EBLOCK;
                break;
            }
            continue;
        }
        if (s->phase == 1) {
            // stored bytes: byte-aligned copy
            r.align();
            while (s->stored_remaining) {
                if (op >= out_cap) { status = NEED_OUTPUT; goto finish; }
                // drain bits first (whole bytes live in the bit buffer)
                if (r.cnt >= 8) {
                    out[op++] = (uint8_t)(r.buf & 0xFF);
                    r.drop(8);
                    s->stored_remaining--;
                    continue;
                }
                size_t avail = r.len - r.pos;
                if (!avail) { status = NEED_INPUT; goto finish; }
                // cnt == 0 here, but the fastloop's 64-bit refill leaves
                // prefix bits of in[pos] above cnt; advancing pos by memcpy
                // would desync them from the next fill's OR. Clear.
                r.buf = 0;
                size_t take = s->stored_remaining;
                if (take > avail) take = avail;
                if (take > out_cap - op) take = out_cap - op;
                memcpy(out + op, r.in + r.pos, take);
                r.pos += take;
                op += take;
                s->stored_remaining -= (uint32_t)take;
            }
            s->phase = s->final_block ? 3 : 0;
            continue;
        }

        // resume a spilled match copy (out filled exactly mid-match)
        if (s->copy_len) {
            uint32_t fit = s->copy_len;
            if (fit > out_cap - op) fit = (uint32_t)(out_cap - op);
            uint32_t dist = s->copy_dist;
            uint32_t remaining = fit;
            if (dist > op) {
                uint32_t from_window = dist - (uint32_t)op;
                if (from_window > s->whave) { status = EDIST; goto finish; }
                uint32_t rpos = (s->wpos + WINDOW - from_window) % WINDOW;
                while (remaining && from_window) {
                    out[op++] = s->window[rpos];
                    rpos = (rpos + 1) % WINDOW;
                    remaining--;
                    from_window--;
                }
            }
            for (uint32_t k = 0; k < remaining; k++) out[op] = out[op - dist], op++;
            s->copy_len -= fit;
            if (s->copy_len) { status = NEED_OUTPUT; goto finish; }
        }
        // ------------------------------------------------------------------
        // phase 2, fastloop: margins guarantee one 8-byte refill per token,
        // no per-literal output checks, and copy slack. Window-reaching
        // distances (dist > op) and EOB drop to the careful loop below.
        // ------------------------------------------------------------------
        {
            const uint32_t lmask = (1u << LIT_TB) - 1;
            const uint32_t dmask = (1u << DIST_TB) - 1;
            while (r.pos + 8 <= r.len && op + 266 + 8 <= out_cap) {
                SAVE_CK();  // the mid-token input-margin bail rolls back here
                // branchless refill to >= 56 bits
                r.buf |= load64le(r.in + r.pos) << r.cnt;
                r.pos += (63 - r.cnt) >> 3;
                r.cnt |= 56;
                uint32_t e = lit.pri[(uint32_t)r.buf & lmask];
                if (e_kind(e) == 3)
                    e = lit.sub[e_base(e) +
                                (((uint32_t)(r.buf >> LIT_TB)) &
                                 ((1u << e_extra(e)) - 1))];
                // up to two extra literals per refill (<= 45 bits total)
                while (e_kind(e) == 1) {
                    out[op++] = (uint8_t)e_base(e);
                    r.drop((int)e_bits(e));
                    if (r.cnt < 2 * MAXBITS) goto fast_next;
                    e = lit.pri[(uint32_t)r.buf & lmask];
                    if (e_kind(e) == 3)
                        e = lit.sub[e_base(e) +
                                    (((uint32_t)(r.buf >> LIT_TB)) &
                                     ((1u << e_extra(e)) - 1))];
                }
                if (e_kind(e) == 2) goto careful;  // EOB: rare, exact path
                if (e_bits(e) == 0) { status = ESYM; goto finish; }
                {
                    // length
                    uint32_t b = e_bits(e);
                    uint32_t length =
                        e_base(e) +
                        (((uint32_t)(r.buf >> b)) & ((1u << e_extra(e)) - 1));
                    r.drop((int)(b + e_extra(e)));
                    // distance (<= 28 bits left needed; have >= 26 after a
                    // 15+5 length... refill again if short)
                    if (r.cnt < MAXBITS + 13) {
                        if (r.pos + 8 > r.len) { ROLLBACK(); goto careful; }
                        r.buf |= load64le(r.in + r.pos) << r.cnt;
                        r.pos += (63 - r.cnt) >> 3;
                        r.cnt |= 56;
                    }
                    uint32_t de = dst_t.pri[(uint32_t)r.buf & dmask];
                    if (e_kind(de) == 3)
                        de = dst_t.sub[e_base(de) +
                                       (((uint32_t)(r.buf >> DIST_TB)) &
                                        ((1u << e_extra(de)) - 1))];
                    if (e_bits(de) == 0) { status = ESYM; goto finish; }
                    uint32_t db = e_bits(de);
                    uint32_t dist =
                        e_base(de) +
                        (((uint32_t)(r.buf >> db)) & ((1u << e_extra(de)) - 1));
                    r.drop((int)(db + e_extra(de)));
                    if (dist > op) {
                        // window-reaching: rewind this token to the careful
                        // loop (it owns the ring-buffer logic)
                        // Note: cannot rewind bit-exactly here (bits already
                        // dropped), so handle inline instead.
                        uint32_t from_window = dist - (uint32_t)op;
                        if (from_window > s->whave) { status = EDIST; goto finish; }
                        uint32_t remaining = length;
                        uint32_t rpos = (s->wpos + WINDOW - from_window) % WINDOW;
                        while (remaining && from_window) {
                            out[op++] = s->window[rpos];
                            rpos = (rpos + 1) % WINDOW;
                            remaining--;
                            from_window--;
                        }
                        if (remaining) copy_match(out + op, dist, remaining);
                        op += remaining;
                    } else {
                        copy_match(out + op, dist, length);
                        op += length;
                    }
                }
            fast_next:;
            }
        }
    careful:
        // phase 2, careful loop: exact bounds + token-boundary rollback
        for (;;) {
            SAVE_CK();
            bool starved;
            uint32_t e = probe_careful(lit, r, &starved);
            if (!e) {
                if (starved) { ROLLBACK(); status = NEED_INPUT; goto finish; }
                status = ESYM; goto finish;
            }
            uint32_t kind = e_kind(e);
            if (kind == 1) {
                if (op >= out_cap) { ROLLBACK(); status = NEED_OUTPUT; goto finish; }
                r.drop((int)e_bits(e));
                out[op++] = (uint8_t)e_base(e);
                // margins may be restored mid-input (NEED_OUTPUT resume)
                if (r.pos + 8 <= r.len && op + 274 <= out_cap) goto fast_again;
                continue;
            }
            if (kind == 2) {
                r.drop((int)e_bits(e));
                if (s->final_block) {
                    r.align();
                    s->phase = 3;
                    status = DONE;
                    goto finish;
                }
                s->phase = 0;
                break;  // next block header
            }
            r.drop((int)e_bits(e));
            uint32_t extra;
            if (!r.read((int)e_extra(e), &extra)) {
                ROLLBACK(); status = NEED_INPUT; goto finish;
            }
            uint32_t length = e_base(e) + extra;
            uint32_t de = probe_careful(dst_t, r, &starved);
            if (!de) {
                if (starved) { ROLLBACK(); status = NEED_INPUT; goto finish; }
                status = ESYM; goto finish;
            }
            r.drop((int)e_bits(de));
            uint32_t dextra;
            if (!r.read((int)e_extra(de), &dextra)) {
                ROLLBACK(); status = NEED_INPUT; goto finish;
            }
            uint32_t dist = e_base(de) + dextra;
            if (op + length > out_cap) {
                // token consumed; copy what fits, spill the rest (the
                // output buffer fills exactly — libz NeedOutput behavior)
                uint32_t fit = (uint32_t)(out_cap - op);
                s->copy_len = length - fit;
                s->copy_dist = dist;
                length = fit;
                if (!length) { status = NEED_OUTPUT; goto finish; }
            }
            if (dist <= op) {
                // copy within out (overlap-safe byte loop: near out_cap there
                // is no write slack for word copies)
                uint8_t* d = out + op;
                const uint8_t* src = d - dist;
                if (dist >= length) {
                    memcpy(d, src, length);
                } else {
                    for (uint32_t k = 0; k < length; k++) d[k] = src[k];
                }
                op += length;
            } else {
                // reaches into the saved window
                uint32_t from_window = dist - (uint32_t)op;
                if (from_window > s->whave) { status = EDIST; goto finish; }
                uint32_t remaining = length;
                uint32_t rpos = (s->wpos + WINDOW - from_window) % WINDOW;
                while (remaining && from_window) {
                    out[op++] = s->window[rpos];
                    rpos = (rpos + 1) % WINDOW;
                    remaining--;
                    from_window--;
                }
                // rest comes from out itself
                uint8_t* d = out + op;
                const uint8_t* src = d - dist;
                for (uint32_t k = 0; k < remaining; k++) d[k] = src[k];
                op += remaining;
            }
            if (s->copy_len) { status = NEED_OUTPUT; goto finish; }
        }
        continue;
    fast_again:;
    }

finish:
    if (s->check_mode == 1 && op) s->check = compu_adler32(out, op, s->check);
    else if (s->check_mode == 2 && op) s->check = compu_crc32(out, op, s->check);
    // persist bit-level + window state. Whole bytes still in the bit
    // accumulator are reported UNCONSUMED (the caller re-feeds them), so
    // only the sub-byte remainder may persist — keeping more would
    // double-read those bytes on the next call.
    window_push(s, out, op);
    s->bitcnt = r.cnt & 7;
    s->bitbuf = r.buf & ((1ull << s->bitcnt) - 1);
    *in_consumed = r.consumed();
    *out_written = op;
    return status;
}

}  // extern "C"
