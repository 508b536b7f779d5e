// Standalone native brotli ENCODER (RFC 7932) — the framework's second,
// fully independent brotli encoder implementation.
//
// Role: the reference ships TWO complete interchangeable brotli encoders
// behind one vtable (reference/src/encoder/brotli.rs:22-29 pure-Rust
// vs reference/src/encoder/brotli_c.rs:42-50 C). This file completes
// the same pattern here: the Python meta-block planner
// (formats/brotli/encode.py, with csrc/compu_brotli_enc.cpp hot loops) is
// one implementation; this is the other — a from-scratch C++ encoder with
// a different design (hash-chain matcher over a sliding history buffer,
// single-tree meta-blocks, two-pass histogram->emit), registered as
// encoder Interface "brotli-native".
//
// Stream shape: one compressed meta-block per compress() call (the Python
// backend feeds fixed absolute-offset chunks, so chunked == one-shot),
// ISUNCOMPRESSED fallback for incompressible chunks, final call appends
// the ISLAST+ISLASTEMPTY terminator. Single block type per category,
// NPOSTFIX=0 NDIRECT=0, no context maps (NTREES=1) — simple, valid
// streams; the distance ring and bit phase carry across meta-blocks
// (the decoder keeps both stream-global).
//
// Validated against libbrotli (decode oracle) and this repo's two
// independent brotli decoders (tests/test_native_brotli_enc.py).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// normative tables (RFC 7932 §5-§6)
static const int INSERT_BASE[24] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26,
                                    34, 50, 66, 98, 130, 194, 322, 578, 1090,
                                    2114, 6210, 22594};
static const int INSERT_EXTRA[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                     4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
static const int COPY_BASE[24] = {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18,
                                  22, 30, 38, 54, 70, 102, 134, 198, 326,
                                  582, 1094, 2118};
static const int COPY_EXTRA[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2,
                                   3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
static const int INSERT_RANGE_LUT[9] = {0, 0, 8, 8, 0, 16, 8, 16, 16};
static const int COPY_RANGE_LUT[9] = {0, 8, 0, 8, 16, 0, 16, 8, 16};
static const int CLCODE_ORDER[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9,
                                     10, 11, 12, 13, 14, 15};
// fixed code for the code-length-code lengths: value -> (bits, nbits)
static const int CLFIX_BITS[6] = {0x0, 0x7, 0x3, 0x2, 0x1, 0xF};
static const int CLFIX_N[6] = {2, 4, 3, 2, 2, 4};

constexpr int NUM_LIT = 256;
constexpr int NUM_CMD = 704;
constexpr int NUM_DIST = 64;  // 16 + 0 direct + 48<<0

struct Sink {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int nbits = 0;

    inline void push(uint64_t v, int n) {
        if (!n) return;
        acc |= (v & ((n < 64 ? (1ULL << n) : 0) - 1)) << nbits;
        nbits += n;
        while (nbits >= 8) {
            bytes.push_back((uint8_t)acc);
            acc >>= 8;
            nbits -= 8;
        }
    }
    inline void align() {
        if (nbits) {
            bytes.push_back((uint8_t)acc);
            acc = 0;
            nbits = 0;
        }
    }
};

static uint32_t rev_bits(uint32_t v, int n) {
    uint32_t r = 0;
    for (int i = 0; i < n; i++) r = (r << 1) | ((v >> i) & 1);
    return r;
}

// ---------------------------------------------------------------------------
// Complete length-limited Huffman lengths (Kraft sum exactly 2^cap over
// used symbols; >= 1 used symbol required).
// ---------------------------------------------------------------------------
static void build_lengths(const int64_t* freq, int n, int cap,
                          uint8_t* lens) {
    memset(lens, 0, (size_t)n);
    std::vector<int> used;
    for (int i = 0; i < n; i++)
        if (freq[i] > 0) used.push_back(i);
    if (used.empty()) return;
    if (used.size() == 1) { lens[used[0]] = 0; return; }  // single: special

    // Huffman via two sorted queues.
    struct Node { int64_t f; int l, r; };
    std::vector<Node> nodes;
    std::vector<int> leaves = used;
    std::sort(leaves.begin(), leaves.end(), [&](int a, int b) {
        return freq[a] < freq[b] || (freq[a] == freq[b] && a < b);
    });
    for (int s : leaves) nodes.push_back({freq[s], -1 - s, -1 - s});
    size_t qa = 0;  // leaf queue cursor
    std::vector<int> merged;  // internal node indices (ascending freq)
    size_t qb = 0;
    auto take = [&]() -> int {
        bool leaf_ok = qa < leaves.size();
        bool int_ok = qb < merged.size();
        if (leaf_ok && (!int_ok || nodes[(size_t)qa].f <= nodes[(size_t)merged[qb]].f))
            return (int)qa++;
        return merged[qb++];
    };
    size_t nleaf = leaves.size();
    while (nleaf + merged.size() - qa - qb >= 2) {
        int a = take();
        int b = take();
        nodes.push_back({nodes[(size_t)a].f + nodes[(size_t)b].f, a, b});
        merged.push_back((int)nodes.size() - 1);
        if (merged.size() > 2 * leaves.size()) break;  // safety
    }
    // depths by DFS from the root (last merged node)
    std::vector<std::pair<int, int>> stack;  // (node, depth)
    stack.push_back({merged.empty() ? 0 : merged.back(), 0});
    std::vector<int> depth_of(nodes.size(), 0);
    while (!stack.empty()) {
        auto [ni, d] = stack.back();
        stack.pop_back();
        const Node& nd = nodes[(size_t)ni];
        if (nd.l < 0) {  // leaf
            int sym = leaves[(size_t)ni];
            lens[sym] = (uint8_t)(d > 0 ? d : 1);
        } else {
            stack.push_back({nd.l, d + 1});
            stack.push_back({nd.r, d + 1});
        }
    }
    // clamp + make Kraft sum exactly 2^cap
    for (int s : used)
        if (lens[s] > cap) lens[s] = (uint8_t)cap;
    long long budget = 1LL << cap;
    auto kraft = [&]() {
        long long k = 0;
        for (int s : used) k += 1LL << (cap - lens[s]);
        return k;
    };
    long long k = kraft();
    // overflow: lengthen the shortest (largest-unit) codes
    while (k > budget) {
        int best = -1;
        for (int s : used)
            if (lens[s] < cap && (best < 0 || lens[s] < lens[best])) best = s;
        k -= 1LL << (cap - lens[best]);
        lens[best]++;
        k += 1LL << (cap - lens[best]);
    }
    // deficit: shorten the highest-frequency symbol whose unit fits
    while (k < budget) {
        long long d = budget - k;
        int best = -1;
        for (int s : used) {
            if (lens[s] <= 1) continue;
            if ((1LL << (cap - lens[s])) <= d
                && (best < 0 || freq[s] > freq[best]))
                best = s;
        }
        if (best < 0) {
            // no unit fits: halve the deficit by lengthening... cannot
            // happen (deficit is a multiple of the smallest unit), but
            // guard with the longest symbol
            for (int s : used)
                if (best < 0 || lens[s] > lens[best]) best = s;
            k -= 1LL << (cap - lens[best]);
            lens[best]++;
            k += 1LL << (cap - lens[best]);
            continue;
        }
        k += 1LL << (cap - lens[best]);
        lens[best]--;
    }
}

// canonical codes (bit-reversed for the LSB-first stream)
static void canon_codes(const uint8_t* lens, int n, uint16_t* codes) {
    int count[16] = {0};
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    int next[16];
    int code = 0;
    for (int l = 1; l <= 15; l++) {
        code = (code + count[l - 1]) << 1;
        next[l] = code;
    }
    for (int i = 0; i < n; i++) {
        if (!lens[i]) { codes[i] = 0; continue; }
        codes[i] = (uint16_t)rev_bits((uint32_t)next[lens[i]]++, lens[i]);
    }
}

// ---------------------------------------------------------------------------
// Prefix-code description writer (RFC 7932 §3.4-§3.5)
// ---------------------------------------------------------------------------
struct Code {
    std::vector<uint8_t> lens;
    std::vector<uint16_t> codes;
    int single = -1;  // single-symbol code: emit no bits per symbol

    inline void put(Sink& s, int sym) const {
        if (single >= 0) return;
        s.push(codes[(size_t)sym], lens[(size_t)sym]);
    }
};

static void alpha_bits_of(int alphabet, int* bits) {
    int b = 1;
    while ((1 << b) < alphabet) b++;
    *bits = b;
}

static void write_code(Sink& s, const int64_t* freq, int alphabet,
                       Code& out) {
    out.lens.assign((size_t)alphabet, 0);
    out.codes.assign((size_t)alphabet, 0);
    out.single = -1;
    std::vector<int> used;
    for (int i = 0; i < alphabet; i++)
        if (freq[i] > 0) used.push_back(i);
    if (used.empty()) used.push_back(0);  // degenerate: never referenced

    if (used.size() == 1) {
        // simple code, NSYM=1
        int ab;
        alpha_bits_of(alphabet, &ab);
        s.push(1, 2);          // hskip == 1 -> simple
        s.push(0, 2);          // nsym - 1 = 0
        s.push((uint64_t)used[0], ab);
        out.single = used[0];
        return;
    }
    if (used.size() <= 4) {
        // simple code, 2-4 symbols, ordered most-frequent-first
        std::vector<int> order = used;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return freq[a] > freq[b] || (freq[a] == freq[b] && a < b);
        });
        int ab;
        alpha_bits_of(alphabet, &ab);
        int nsym = (int)order.size();
        s.push(1, 2);
        s.push((uint64_t)(nsym - 1), 2);
        // lengths per the decoder's fixed assignment
        if (nsym == 2) {
            out.lens[(size_t)order[0]] = 1;
            out.lens[(size_t)order[1]] = 1;
        } else if (nsym == 3) {
            out.lens[(size_t)order[0]] = 1;
            out.lens[(size_t)order[1]] = 2;
            out.lens[(size_t)order[2]] = 2;
        } else {
            // tree-select: depth (1,2,3,3) if skewed beats (2,2,2,2)
            long long flat = 2 * (freq[order[0]] + freq[order[1]]
                                  + freq[order[2]] + freq[order[3]]);
            long long skew = freq[order[0]] + 2 * freq[order[1]]
                             + 3 * (freq[order[2]] + freq[order[3]]);
            if (skew < flat) {
                out.lens[(size_t)order[0]] = 1;
                out.lens[(size_t)order[1]] = 2;
                out.lens[(size_t)order[2]] = 3;
                out.lens[(size_t)order[3]] = 3;
            } else {
                for (int i = 0; i < 4; i++) out.lens[(size_t)order[i]] = 2;
            }
        }
        // NSYM=4: symbol list first, then the tree-select bit
        for (int i = 0; i < nsym; i++) s.push((uint64_t)order[i], ab);
        if (nsym == 4)
            s.push(out.lens[(size_t)order[0]] == 1 ? 1 : 0, 1);
        canon_codes(out.lens.data(), alphabet, out.codes.data());
        return;
    }

    // complex code
    build_lengths(freq, alphabet, 15, out.lens.data());
    canon_codes(out.lens.data(), alphabet, out.codes.data());

    // RLE the length sequence with symbols 16 (repeat prev nonzero) and
    // 17 (zero run). Trailing zeros are implicit (decoder fills by space).
    // CONSECUTIVE 16s (or 17s) COMPOUND in the decoder
    // (count = ((count-2) << extra_bits) + 3 + extra), so a plain literal
    // is re-emitted between repeat units to reset the chain — a few bits
    // of header for a much simpler exact encoding.
    int last = alphabet;
    while (last > 0 && out.lens[(size_t)last - 1] == 0) last--;
    std::vector<std::pair<int, int>> seq;  // (cl symbol, extra value)
    {
        int i = 0;
        while (i < last) {
            int v = out.lens[(size_t)i];
            int j = i;
            while (j < last && out.lens[(size_t)j] == v) j++;
            int run = j - i;
            if (v == 0) {
                while (run > 0) {
                    if (run < 3) {
                        while (run--) seq.push_back({0, -1});
                        break;
                    }
                    int take = run > 10 ? 10 : run;
                    seq.push_back({17, take - 3});
                    run -= take;
                    if (run >= 3) {  // literal zero resets the 17 chain
                        seq.push_back({0, -1});
                        run -= 1;
                    }
                }
            } else {
                seq.push_back({v, -1});  // literal; prev-nonzero becomes v
                run -= 1;
                while (run > 0) {
                    if (run < 3) {
                        while (run--) seq.push_back({v, -1});
                        break;
                    }
                    int take = run > 6 ? 6 : run;
                    seq.push_back({16, take - 3});
                    run -= take;
                    if (run >= 3) {  // literal resets the 16 chain
                        seq.push_back({v, -1});
                        run -= 1;
                    }
                }
            }
            i = j;
        }
    }
    // code-length code over the cl symbols
    int64_t clfreq[18] = {0};
    for (auto& p : seq) clfreq[p.first]++;
    uint8_t cl_lens[18] = {0};
    {
        int usedc = 0, only = -1;
        for (int i = 0; i < 18; i++)
            if (clfreq[i]) { usedc++; only = i; }
        if (usedc == 1) {
            // single used cl symbol: pair it with an unused partner at
            // length 1 so the cl code is COMPLETE (some decoders reject
            // incomplete multi-entry tables); the partner never appears
            // in the emitted sequence
            cl_lens[only] = 1;
            cl_lens[only == 0 ? 1 : 0] = 1;
        } else {
            build_lengths(clfreq, 18, 5, cl_lens);
        }
    }
    uint16_t cl_codes[18];
    canon_codes(cl_lens, 18, cl_codes);

    s.push(0, 2);  // hskip = 0
    // the decoder stops reading cl lengths the moment the code completes
    // (space <= 0), so emission must stop at the same entry
    int space = 32;
    for (int i = 0; i < 18 && space > 0; i++) {
        int v = cl_lens[CLCODE_ORDER[i]];
        s.push((uint64_t)CLFIX_BITS[v], CLFIX_N[v]);
        if (v) space -= 32 >> v;
    }
    for (auto& p : seq) {
        s.push(cl_codes[p.first], cl_lens[p.first]);
        if (p.first == 16) s.push((uint64_t)p.second, 2);
        else if (p.first == 17) s.push((uint64_t)p.second, 3);
    }
}

// ---------------------------------------------------------------------------
// length-code helpers
// ---------------------------------------------------------------------------
static int length_code(const int* base, int n, long long v) {
    int c = 0;
    for (int i = 0; i < n; i++)
        if (base[i] <= v) c = i;
    return c;
}

static int cmd_symbol(int ic, int cc, bool implicit) {
    if (implicit) return ((cc < 8 ? 0 : 1) << 6) | ((ic & 7) << 3) | (cc & 7);
    int ir = ic & ~7, cr = cc & ~7;
    for (int cell = 0; cell < 9; cell++)
        if (INSERT_RANGE_LUT[cell] == ir && COPY_RANGE_LUT[cell] == cr)
            return ((cell + 2) << 6) | ((ic & 7) << 3) | (cc & 7);
    return 0;  // unreachable
}

// distance -> (dsym, extra_bits, extra_val) with NPOSTFIX=0 NDIRECT=0,
// given the current ring. Returns the cheapest valid encoding.
static void dist_symbol(long long dist, const long long* ring, int* dsym,
                        int* ebits, long long* eval) {
    for (int i = 0; i < 4; i++)
        if (ring[i] == dist) { *dsym = i; *ebits = 0; *eval = 0; return; }
    for (int k = 0; k < 6; k++) {
        long long delta = (k >> 1) + 1;
        long long v = (k & 1) ? ring[0] + delta : ring[0] - delta;
        if (v == dist && v > 0) { *dsym = 4 + k; *ebits = 0; *eval = 0; return; }
        v = (k & 1) ? ring[1] + delta : ring[1] - delta;
        if (v == dist && v > 0) { *dsym = 10 + k; *ebits = 0; *eval = 0; return; }
    }
    // explicit: dist = ((offset + extra) << 0) + 0 + 1;
    // offset = ((2 + (hcode&1)) << nbits) - 4
    long long d = dist - 1;  // ndirect=0, postfix=0
    // find nbits >= 1 and hcode parity such that
    // d - ((2+(h&1))<<nbits) + 4 in [0, 2^nbits)
    for (int nbits = 1; nbits <= 30; nbits++) {
        for (int h = 0; h < 2; h++) {
            long long off = ((2LL + h) << nbits) - 4;
            long long e = d - off;
            if (e >= 0 && e < (1LL << nbits)) {
                int dcode = ((nbits - 1) << 1) | h;
                *dsym = 16 + dcode;
                *ebits = nbits;
                *eval = e;
                return;
            }
        }
    }
    *dsym = 16; *ebits = 1; *eval = 0;  // unreachable for valid dist
}

// ---------------------------------------------------------------------------
// encoder state
// ---------------------------------------------------------------------------
struct Cmd {
    long long ins_start;  // offset of insert run in the chunk
    long long ins_len;
    long long copy_len;   // 0 for the tail command
    long long dist;
};

struct BrEnc2 {
    int quality;
    int wbits;
    long long window_size;
    bool header_done;
    Sink sink;
    // sliding buffer: history tail + current chunk
    std::vector<uint8_t> buf;
    long long buf_base;   // stream offset of buf[0]
    long long total_in;
    long long ring[4];
    // hash chains over buf (buf-relative int32: half the chain-walk
    // memory traffic; rebased on window slide)
    std::vector<int32_t> head;   // hash -> buf index (-1 empty)
    std::vector<int32_t> prev;   // buf index -> previous buf index
    int hbits;

    void reset() {
        header_done = false;
        sink.bytes.clear();
        sink.acc = 0;
        sink.nbits = 0;
        buf.clear();
        buf_base = 0;
        total_in = 0;
        // most-recent-first, matching the decoders (RFC 7932 §4)
        ring[0] = 4; ring[1] = 11; ring[2] = 15; ring[3] = 16;
        head.assign((size_t)1 << hbits, -1);
        prev.clear();
    }
};

static inline uint32_t hash4(const uint8_t* p, int hbits) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - hbits);
}

// 5-byte hash for mid/high qualities (smaller buckets on text; the
// minimum found match becomes 5, which the q>=4 parse prefers anyway)
static inline uint32_t hash5(const uint8_t* p, int hbits) {
    uint64_t v;
    memcpy(&v, p, 8);
    v &= 0xFFFFFFFFFFULL;
    return (uint32_t)((v * 0x9E3779B185EBCA87ULL) >> (64 - hbits));
}

// greedy/lazy hash-chain parse of chunk [cstart, cend) within st->buf
static void parse_chunk(BrEnc2* st, long long cstart, long long cend,
                        std::vector<Cmd>& cmds) {
    const uint8_t* b = st->buf.data();
    long long n = cend;
    int depth = st->quality <= 2 ? 8 : st->quality <= 5 ? 12
                : st->quality <= 9 ? 48 : 192;
    bool lazy = st->quality >= 4;
    bool h5 = st->quality >= 4;
    long long nice = st->quality <= 4 ? 32 : st->quality <= 8 ? 64 : 128;
    long long ins_start = cstart;
    long long i = cstart;
    const int hbits = st->hbits;
    auto find = [&](long long pos, long long* bl, long long* bd) {
        *bl = 0;
        *bd = 0;
        if (pos + 8 > n) return;
        long long limit = n - pos;
        if (limit > (1 << 24)) limit = 1 << 24;
        long long minpos = pos - st->window_size;  // buf-relative
        int fails = 0;
        int32_t cand = st->head[h5 ? hash5(b + pos, hbits)
                                   : hash4(b + pos, hbits)];
        for (int d = 0; d < depth && cand >= 0; d++) {
            if (cand < minpos) break;
            long long cb = cand;
            long long dist = pos - cb;
            if (dist > 0) {
                const uint8_t* p1 = b + cb;
                const uint8_t* p2 = b + pos;
                // cheap reject: a candidate that can't beat the current
                // best disagrees at the best-length byte (degenerate
                // low-entropy chains otherwise cost a full multi-KB
                // compare per candidate)
                if (*bl >= limit || p1[*bl] != p2[*bl]) {
                    cand = st->prev[(size_t)cb];
                    continue;
                }
                long long l = 0;
                while (l + 8 <= limit) {
                    uint64_t x1, x2;
                    memcpy(&x1, p1 + l, 8);
                    memcpy(&x2, p2 + l, 8);
                    if (x1 != x2) {
                        l += (long long)(__builtin_ctzll(x1 ^ x2) >> 3);
                        goto donelen;
                    }
                    l += 8;
                }
                while (l < limit && p1[l] == p2[l]) l++;
            donelen:
                if (l > *bl || (l == *bl && dist < *bd)) {
                    *bl = l;
                    *bd = dist;
                    fails = 0;
                    if (l >= nice) break;  // long enough: stop the walk
                } else if (++fails >= 6) {
                    break;  // futile chain (dense short-match data)
                }
            }
            cand = st->prev[(size_t)cb];
        }
    };
    auto insert_pos = [&](long long pos) {
        if (pos + 8 > n) return;
        uint32_t h = h5 ? hash5(b + pos, hbits) : hash4(b + pos, hbits);
        st->prev[(size_t)pos] = st->head[h];
        st->head[h] = (int32_t)pos;
    };
    long long minmatch = st->quality <= 3 ? 6 : 4;
    long long run_lit = 0;  // consecutive literals: drives the skip rate
    while (i < cend) {
        long long bl, bd;
        find(i, &bl, &bd);
        if (bl >= minmatch || (bl >= 4 && bd == st->ring[0])) {
            run_lit = 0;
            if (lazy && bl < 16 && i + 1 < cend) {
                long long bl2, bd2;
                insert_pos(i);
                find(i + 1, &bl2, &bd2);
                if (bl2 > bl + 1) {
                    i += 1;  // literal; retry at i+1
                    continue;
                }
            } else {
                insert_pos(i);
            }
            cmds.push_back({ins_start, i - ins_start, bl, bd});
            long long end = i + bl;
            long long step = st->quality >= 8 ? 1
                             : st->quality >= 4 ? 2 : 4;
            if (bl > 256) step = bl >> 6;  // huge matches: sparse inserts
            for (long long k = i + 1; k < end && k < cend; k += step)
                insert_pos(k);
            i = end;
            ins_start = i;
        } else {
            insert_pos(i);
            run_lit++;
            // incompressible-region acceleration: long literal runs walk
            // cache-hostile collision chains for nothing; step over them
            // at an increasing rate (libbrotli-style skip, q<=9)
            i += (st->quality <= 9 && run_lit > 64)
                     ? 1 + ((run_lit - 64) >> 6)
                     : 1;
        }
    }
    if (i > cend) i = cend;
    if (ins_start < cend || cmds.empty())
        cmds.push_back({ins_start, cend - ins_start, 0, 0});
}

static void emit_meta_block(BrEnc2* st, long long cstart, long long cend) {
    long long mlen = cend - cstart;
    std::vector<Cmd> cmds;
    parse_chunk(st, cstart, cend, cmds);

    // plan: symbols + ring simulation (two passes share the plan)
    struct Planned {
        int cmd_sym;
        int ic, cc;
        bool implicit;
        bool has_dist;
        int dsym, debits;
        long long deval;
    };
    std::vector<Planned> plan(cmds.size());
    int64_t lit_freq[NUM_LIT] = {0};
    int64_t cmd_freq[NUM_CMD] = {0};
    int64_t dist_freq[NUM_DIST] = {0};
    long long extra_bits = 0;  // insert/copy/dist extra-bit total
    long long ring_sim[4];
    memcpy(ring_sim, st->ring, sizeof(ring_sim));
    const uint8_t* b = st->buf.data();
    for (size_t ci = 0; ci < cmds.size(); ci++) {
        const Cmd& c = cmds[ci];
        Planned& p = plan[ci];
        long long ins = c.ins_len;
        long long cpy = c.copy_len ? c.copy_len : 2;  // tail: copy unused
        p.ic = length_code(INSERT_BASE, 24, ins);
        p.cc = length_code(COPY_BASE, 24, cpy);
        extra_bits += INSERT_EXTRA[p.ic] + COPY_EXTRA[p.cc];
        for (long long k = 0; k < ins; k++)
            lit_freq[b[c.ins_start + k]]++;
        p.has_dist = false;
        p.implicit = false;
        if (c.copy_len) {
            if (c.dist == ring_sim[0] && p.ic < 8 && p.cc < 16) {
                p.implicit = true;  // dsym omitted entirely
            } else {
                int dsym, ebits;
                long long eval;
                dist_symbol(c.dist, ring_sim, &dsym, &ebits, &eval);
                p.dsym = dsym;
                p.debits = ebits;
                p.deval = eval;
                p.has_dist = true;
                extra_bits += ebits;
                dist_freq[dsym]++;
                if (dsym != 0) {
                    ring_sim[3] = ring_sim[2];
                    ring_sim[2] = ring_sim[1];
                    ring_sim[1] = ring_sim[0];
                    ring_sim[0] = c.dist;
                }
            }
        }
        p.cmd_sym = cmd_symbol(p.ic, p.cc, p.implicit);
        cmd_freq[p.cmd_sym]++;
    }

    // incompressible guard: entropy-estimate the compressed body from the
    // histograms; an ISUNCOMPRESSED meta-block wins on noise chunks
    Sink& s = st->sink;
    int mnibbles = (mlen - 1) < (1 << 16) ? 4
                   : (mlen - 1) < (1 << 20) ? 5 : 6;
    {
        auto hist_bits = [](const int64_t* f, int n) {
            long long tot = 0;
            double bits = 0;
            for (int i = 0; i < n; i++) tot += f[i];
            if (!tot) return 0.0;
            for (int i = 0; i < n; i++)
                if (f[i]) bits += (double)f[i] * log2((double)tot / (double)f[i]);
            return bits;
        };
        double est = hist_bits(lit_freq, NUM_LIT) + hist_bits(cmd_freq, NUM_CMD)
                     + hist_bits(dist_freq, NUM_DIST) + (double)extra_bits
                     + 600.0;  // header/description allowance
        if (est >= 8.0 * (double)mlen) {
            s.push(0, 1);  // ISLAST = 0
            s.push((uint64_t)(mnibbles - 4), 2);
            for (int k = 0; k < mnibbles; k++)
                s.push((uint64_t)((mlen - 1) >> (4 * k)) & 0xF, 4);
            s.push(1, 1);  // ISUNCOMPRESSED
            s.align();
            const uint8_t* src = st->buf.data() + cstart;
            s.bytes.insert(s.bytes.end(), src, src + (size_t)mlen);
            return;
        }
    }
    s.push(0, 1);  // ISLAST = 0
    // minimal nibble count: RFC 7932 requires the TOP nibble nonzero for
    // MNIBBLES 5/6 (an exact 2^16/2^20 chunk must use the smaller count)
    s.push((uint64_t)(mnibbles - 4), 2);
    for (int k = 0; k < mnibbles; k++)
        s.push((uint64_t)((mlen - 1) >> (4 * k)) & 0xF, 4);
    s.push(0, 1);       // ISUNCOMPRESSED = 0
    s.push(0, 1);       // NBLTYPESL = 1
    s.push(0, 1);       // NBLTYPESI = 1
    s.push(0, 1);       // NBLTYPESD = 1
    s.push(0, 2);       // NPOSTFIX = 0
    s.push(0, 4);       // NDIRECT = 0
    s.push(0, 2);       // context mode for the single literal block type
    s.push(0, 1);       // NTREESL = 1 (no context map)
    s.push(0, 1);       // NTREESD = 1 (no context map)

    Code lit_code, cmd_code, dist_code;
    write_code(s, lit_freq, NUM_LIT, lit_code);
    write_code(s, cmd_freq, NUM_CMD, cmd_code);
    write_code(s, dist_freq, NUM_DIST, dist_code);

    // body
    for (size_t ci = 0; ci < cmds.size(); ci++) {
        const Cmd& c = cmds[ci];
        const Planned& p = plan[ci];
        cmd_code.put(s, p.cmd_sym);
        s.push((uint64_t)(c.ins_len - INSERT_BASE[p.ic]), INSERT_EXTRA[p.ic]);
        long long cpy = c.copy_len ? c.copy_len : 2;
        s.push((uint64_t)(cpy - COPY_BASE[p.cc]), COPY_EXTRA[p.cc]);
        for (long long k = 0; k < c.ins_len; k++)
            lit_code.put(s, b[c.ins_start + k]);
        if (!c.copy_len) break;  // tail command: decoder stops after inserts
        if (p.has_dist) {
            dist_code.put(s, p.dsym);
            s.push((uint64_t)p.deval, p.debits);
            if (p.dsym != 0) {
                st->ring[3] = st->ring[2];
                st->ring[2] = st->ring[1];
                st->ring[1] = st->ring[0];
                st->ring[0] = c.dist;
            }
        }
    }
}

}  // namespace

extern "C" {

void* compu_brenc2_new(int quality, int window_bits) {
    BrEnc2* st = new BrEnc2();
    st->quality = quality < 1 ? 1 : quality > 11 ? 11 : quality;
    st->wbits = window_bits < 10 ? 10 : window_bits > 24 ? 24 : window_bits;
    st->window_size = (1LL << st->wbits) - 16;
    st->hbits = st->quality <= 4 ? 16 : 17;
    st->reset();
    return st;
}

void compu_brenc2_free(void* p) { delete (BrEnc2*)p; }

void compu_brenc2_reset(void* p) { ((BrEnc2*)p)->reset(); }

// Compress one chunk (one meta-block; empty chunk emits none). final != 0
// appends the ISLAST empty meta-block and byte-aligns. Returns bytes
// written to out, or -1 if out_cap is too small.
long long compu_brenc2_run(void* p, const uint8_t* in, size_t n,
                           uint8_t* out, size_t out_cap, int final_flag) {
    BrEnc2* st = (BrEnc2*)p;
    Sink& s = st->sink;
    if (!st->header_done) {
        // WBITS (RFC 7932 §9.1)
        int w = st->wbits;
        if (w == 16) s.push(0, 1);
        else if (w == 17) { s.push(1, 1); s.push(0, 3); s.push(0, 3); }
        else if (w > 17) { s.push(1, 1); s.push((uint64_t)(w - 17), 3); }
        else { s.push(1, 1); s.push(0, 3); s.push((uint64_t)(w - 8), 3); }
        st->header_done = true;
    }
    if (n) {
        // append chunk to the sliding buffer
        long long cstart = (long long)st->buf.size();
        st->buf.insert(st->buf.end(), in, in + n);
        st->prev.resize(st->buf.size(), -1);
        emit_meta_block(st, cstart, (long long)st->buf.size());
        st->total_in += (long long)n;
        // slide: keep at most window_size history
        long long keep = st->window_size;
        if ((long long)st->buf.size() > keep + (8LL << 20)) {
            long long drop = (long long)st->buf.size() - keep;
            st->buf.erase(st->buf.begin(), st->buf.begin() + drop);
            st->prev.erase(st->prev.begin(), st->prev.begin() + drop);
            for (auto& h : st->head)
                h = h >= (int32_t)drop ? h - (int32_t)drop : -1;
            for (auto& pv : st->prev)
                pv = pv >= (int32_t)drop ? pv - (int32_t)drop : -1;
            st->buf_base += drop;
        }
    }
    if (final_flag) {
        s.push(1, 1);  // ISLAST
        s.push(1, 1);  // ISLASTEMPTY
        s.align();
    }
    if (s.bytes.size() > out_cap) return -1;
    memcpy(out, s.bytes.data(), s.bytes.size());
    long long written = (long long)s.bytes.size();
    s.bytes.clear();
    return written;
}

}  // extern "C"
