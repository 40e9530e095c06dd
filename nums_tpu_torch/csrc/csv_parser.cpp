// Fast delimiter-separated numeric text parser.
//
// Role: the inner loop of parallel CSV ingestion. Python splits the file
// into newline-aligned byte ranges; each range is parsed here with the
// GIL released (ctypes), so ranges parse on real OS threads in parallel.
//
// Build: c++ -O3 -shared -fPIC csv_parser.cpp -o libnums_csv_<hash>.so
// (done at first use by nums_tpu_torch/core/io/_native.py and cached).

#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <locale.h>

// strtod is LC_NUMERIC-dependent: an embedding application that calls
// setlocale() into a comma-decimal locale (de_DE etc., common in GUI /
// plotting stacks) would make strtod consume ',' field delimiters as
// decimal points, silently merging fields. Pin the C locale for the
// fallback path explicitly (the fast path is locale-free by design).
static locale_t nums_c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

// Exact powers of ten representable in a double (10^0 .. 10^22).
static const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22,
};

// Clinger exact fast path: a decimal with <= 15 significant digits and
// a net decimal exponent in [-22, 22] converts EXACTLY as
// mantissa * / 10^|exp| (one IEEE multiply or divide of two exactly-
// representable values), so the result is bit-identical to strtod's
// correctly-rounded answer. strtod spends most of its time in locale
// lookups and arbitrary-precision paths this data never needs. Returns the
// position after the number, or nullptr when this field needs the
// strtod fallback (too many digits, huge exponent, inf/nan, hex, or no
// digits at all).
static inline const char* fast_double(const char* p, const char* end,
                                      double* outv) {
    const char* s = p;
    bool neg = false;
    if (p < end && (*p == '+' || *p == '-')) {
        neg = (*p == '-');
        p++;
    }
    uint64_t mant = 0;
    int digs = 0;   // significant digits accumulated
    int dexp = 0;   // decimal-point shift
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        any = true;
        if (digs < 19) {
            mant = mant * 10 + (uint64_t)(*p - '0');
            if (mant) digs++;
        } else {
            dexp++;  // digits past capacity shift the exponent
        }
        p++;
    }
    if (p < end && *p == '.') {
        p++;
        while (p < end && *p >= '0' && *p <= '9') {
            any = true;
            if (digs < 19) {
                mant = mant * 10 + (uint64_t)(*p - '0');
                if (mant) digs++;
                dexp--;
            }
            p++;
        }
    }
    if (!any) return nullptr;  // "nan"/"inf"/stray text: strtod decides
    int eexp = 0;
    if (p < end && (*p == 'e' || *p == 'E')) {
        const char* ep = p + 1;
        bool eneg = false;
        if (ep < end && (*ep == '+' || *ep == '-')) {
            eneg = (*ep == '-');
            ep++;
        }
        if (ep < end && *ep >= '0' && *ep <= '9') {
            p = ep;
            while (p < end && *p >= '0' && *p <= '9') {
                if (eexp < 10000) eexp = eexp * 10 + (*p - '0');
                p++;
            }
            if (eneg) eexp = -eexp;
        }
        // 'e' with no digits: not part of the number — leave p at 'e';
        // strtod would stop there too, but the mantissa alone is still
        // exact, so fall through with eexp = 0.
    }
    int ex = dexp + eexp;
    if (digs > 15 || ex < -22 || ex > 22) {
        (void)s;
        return nullptr;  // outside the exact window: strtod fallback
    }
    double v = (double)mant;
    v = (ex >= 0) ? v * kPow10[ex] : v / kPow10[-ex];
    *outv = neg ? -v : v;
    return p;
}

extern "C" {

// Parse `len` bytes of text: rows separated by '\n', fields by `delim`.
// Writes up to max_vals doubles to out. Returns number of values parsed,
// or -1 if out capacity was exceeded, -2 on a malformed field, -3 when a
// row's width differs from the first row's (ragged input — numpy's
// loadtxt raises on this, so the caller must not accept it silently).
// *n_rows/*n_cols receive the parsed row count and row width.
long nums_parse_csv(const char* buf, long len, char delim, double* out,
                    long max_vals, long* n_rows, long* n_cols) {
    long count = 0;
    long rows = 0;
    long cols = -1;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        // Skip blank lines / trailing newline runs.
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        long row_cols = 0;
        while (p < end && *p != '\n') {
            double v;
            const char* next = fast_double(p, end, &v);
            if (next == nullptr) {
                // Exact fast path declined: correctly-rounded strtod
                // (buf is null-terminated by the Python bytes object),
                // pinned to the C locale (see nums_c_locale above).
                char* sn = nullptr;
                v = strtod_l(p, &sn, nums_c_locale());
                if (sn == p) {
                    // Not a number (e.g. stray text): fail parse.
                    return -2;
                }
                next = sn;
            }
            if (count >= max_vals) return -1;
            out[count++] = v;
            row_cols++;
            p = next;
            // Skip delimiter / spaces / CR before next field or newline.
            while (p < end && (*p == delim || *p == ' ' || *p == '\t' ||
                               *p == '\r'))
                p++;
        }
        if (cols < 0) cols = row_cols;
        else if (row_cols != cols) return -3;
        rows++;
        if (p < end) p++;  // consume '\n'
    }
    *n_rows = rows;
    *n_cols = cols < 0 ? 0 : cols;
    return count;
}

}  // extern "C"
