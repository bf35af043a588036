// libdatavec_native: the host loops that feed Word2Vec's host pair path.
//
// The port's own copy of the JAX package's helper, with the same generator
// and the same loops, so that one seed gives both packages the same pairs
// bit for bit. Built with g++ into deeplearning4j_tpu_torch/_build/ at first
// use (native/__init__.py) and called through ctypes.
//
// RNG: a splitmix64 stream seeded per call.

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint64_t splitmix64(uint64_t &state) {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

static inline double uniform01(uint64_t &state) {
    return (splitmix64(state) >> 11) * (1.0 / 9007199254740992.0);
}

// Skip-gram training pairs for a WHOLE corpus chunk in one call.
//
// ids:        concatenated word indices of all sentences
// offsets:    n_sent+1 sentence boundaries into ids
// window:     max window; per-position reduced window b ~ U[1, window]
// keep:       per-vocab-word keep probability (frequent-word subsampling),
//             may be null for no subsampling
// seed:       rng seed for this chunk
// centers/contexts: caller-allocated output, capacity cap pairs
// Returns number of pairs written (<= cap).
int64_t sg_pairs(const int32_t *ids, const int64_t *offsets,
                 int64_t n_sent, int32_t window, const double *keep,
                 uint64_t seed, int32_t *centers, int32_t *contexts,
                 int64_t cap) {
    uint64_t state = seed ? seed : 0x853C49E6748FEA9BULL;
    int64_t out = 0;
    // scratch for the subsampled sentence (bounded by longest sentence)
    static thread_local int32_t *buf = nullptr;
    static thread_local int64_t buf_cap = 0;
    for (int64_t s = 0; s < n_sent; ++s) {
        const int32_t *sent = ids + offsets[s];
        int64_t n = offsets[s + 1] - offsets[s];
        if (n > buf_cap) {
            delete[] buf;
            buf_cap = n * 2;
            buf = new int32_t[buf_cap];
        }
        int64_t m = 0;
        if (keep) {
            for (int64_t i = 0; i < n; ++i)
                if (uniform01(state) < keep[sent[i]]) buf[m++] = sent[i];
        } else {
            std::memcpy(buf, sent, n * sizeof(int32_t));
            m = n;
        }
        if (m < 2) continue;
        for (int64_t i = 0; i < m; ++i) {
            int32_t b = 1 + (int32_t)(splitmix64(state) % (uint64_t)window);
            int64_t lo = i - b < 0 ? 0 : i - b;
            int64_t hi = i + b >= m ? m - 1 : i + b;
            for (int64_t j = lo; j <= hi; ++j) {
                if (j == i) continue;
                if (out >= cap) return out;
                centers[out] = buf[i];
                contexts[out] = buf[j];
                ++out;
            }
        }
    }
    return out;
}

// Vocab counting over a raw whitespace-delimited UTF-8 buffer: emits
// (token_offset, token_len) spans so Python interns strings once instead of
// per-token splitting. Returns span count (<= cap).
int64_t tokenize_spans(const char *text, int64_t len,
                       int64_t *starts, int64_t *lens, int64_t cap) {
    int64_t out = 0;
    int64_t i = 0;
    while (i < len) {
        while (i < len && (text[i] == ' ' || text[i] == '\t' ||
                           text[i] == '\n' || text[i] == '\r')) ++i;
        int64_t start = i;
        while (i < len && !(text[i] == ' ' || text[i] == '\t' ||
                            text[i] == '\n' || text[i] == '\r')) ++i;
        if (i > start) {
            if (out >= cap) return out;
            starts[out] = start;
            lens[out] = i - start;
            ++out;
        }
    }
    return out;
}

}  // extern "C"
