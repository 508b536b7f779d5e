// Cost-model optimal parse (Zopfli-style squeeze) for the host ladders.
//
// Role: the backward DP that the level-9 deflate ladder and the brotli
// q10/q11 ladder run over (match, distance) candidates. The recurrence is
// strictly sequential in position, so it cannot vectorize on numpy and
// costs ~5 s/MiB in Python (PLAN.md); this native loop is the same
// algorithm at ~60 M simple ops per MiB. Mirrors the role of the cost
// model inside libbrotli's q10/q11 backward references and zlib's
// level-9 effort that the reference reaches through FFI
// (reference/src/encoder/brotli_c.rs:53-85,
//  reference/src/encoder/zlib.rs:90-92).
//
// Contract (matches formats/deflate/deflate_encode.py::_optimal_parse):
//   cost[i] = min( litcost[data[i]] + cost[i+1],
//                  min over usable sublengths l of the match at i:
//                      lcost[l-3] + dcost[i] + cost[i+l] )
// where the sublengths tried are the full match length plus every
// length-code base below it (cost steps happen only at code boundaries).
// Extraction walks the choices forward and emits (pos, len, dist) tokens
// with len 0 marking literals.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns the token count (<= n), or -1 on allocation failure.
// tok_pos/tok_len/tok_dist must have capacity n entries each.
int64_t compu_optimal_parse(const uint8_t* data, int64_t n,
                            const int64_t* lens, const int64_t* dists,
                            const double* litcost,   // [256]
                            const double* lcost,     // [256], index l-3
                            const double* dcost,     // [n] per-position
                            const int32_t* cands, int32_t ncands,  // ascending
                            int32_t* tok_pos, int32_t* tok_len,
                            int32_t* tok_dist) {
    double* cost = (double*)malloc((size_t)(n + 1) * sizeof(double));
    int32_t* choice = (int32_t*)malloc((size_t)n * sizeof(int32_t));
    if (!cost || !choice) {
        free(cost);
        free(choice);
        return -1;
    }
    cost[n] = 0.0;
    for (int64_t i = n - 1; i >= 0; i--) {
        double best = litcost[data[i]] + cost[i + 1];
        int32_t ch = 0;
        int64_t L = lens[i];
        if (L >= 3) {
            double dc = dcost[i];
            double c = lcost[L - 3] + dc + cost[i + L];
            if (c < best) {
                best = c;
                ch = (int32_t)L;
            }
            for (int32_t k = 0; k < ncands; k++) {
                int32_t lb = cands[k];
                if (lb >= L) break;
                c = lcost[lb - 3] + dc + cost[i + lb];
                if (c < best) {
                    best = c;
                    ch = lb;
                }
            }
        }
        cost[i] = best;
        choice[i] = ch;
    }
    int64_t t = 0;
    for (int64_t i = 0; i < n;) {
        int32_t ch = choice[i];
        tok_pos[t] = (int32_t)i;
        if (ch) {
            tok_len[t] = ch;
            tok_dist[t] = (int32_t)dists[i];
            i += ch;
        } else {
            tok_len[t] = 0;
            tok_dist[t] = 0;
            i += 1;
        }
        t++;
    }
    free(cost);
    free(choice);
    return t;
}

}  // extern "C"
