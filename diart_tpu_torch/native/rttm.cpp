// Native RTTM assembly for the serving path (a copy of
// diart_tpu/native/rttm.cpp, the port's own).
//
// Per hop the server ships one RTTM text per stream back over the wire.
// This module does the whole post-fetch pipeline in one pass per stream:
//   bits/scores -> turn onsets/offsets -> frame-middle times -> sort ->
//   snprintf lines
// with EXACT string parity against the numpy routes of ops/binarize.py
// (same float operation order, same strictly-greater threshold, same
// (start, end, str(track)) sort key, same %.3f rendering — glibc printf
// and CPython both produce the correctly-rounded decimal).
//
// Semantics mirrored (via ops/binarize.py): diart's Binarize block and
// pyannote's Annotation.to_rttm line format and itertracks sort order.
//
// Two entry points:
//   rttm_from_bits   — (B, stride) packed uint8 bitmap of (frames,
//                      speakers) already-thresholded scores, MSB-first
//                      (numpy packbits order). The serving fetch path:
//                      thresholding runs on the device (the same f32
//                      compare), the wire carries 32x fewer bytes.
//   rttm_from_scores — (B, frames, speakers) float32 scores + threshold;
//                      the route when raw scores are fetched.
//
// Output buffers are malloc'd per stream; the caller frees them with
// rttm_free. No Python API usage — loaded via ctypes, and callable with
// the GIL released.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>

namespace {

inline int utoa(char* buf, long v);

// Every fmt3 output buffer must hold the longest possible %.3f rendering
// of a double: ~309 integer digits + sign + '.' + 3 decimals + NUL.
constexpr int kFmt3Cap = 336;

// %.3f formatting, bit-exact with snprintf/CPython (both produce the
// correctly-rounded decimal, ties to even) but ~20x cheaper for the
// common case. Fast path: scale by 1000 and round; this is provably
// correct whenever the scaled value sits further from a .5 boundary than
// the multiply's rounding error (|v*1000| * 2^-52 plus slack). Near-tie
// or huge values fall back to snprintf — including EXACT binary ties,
// where the computed product landing on k+0.5 does not prove the true
// decimal expansion is a tie. Dense hops spend most of their time here
// (two doubles per RTTM line). buf must have room for kFmt3Cap bytes;
// the returned length is the number of bytes actually written.
inline int fmt3(char* buf, double v) {
    double a = std::fabs(v);
    if (!(a < 1e12)) {  // huge or NaN
        int n = snprintf(buf, kFmt3Cap, "%.3f", v);
        return n < kFmt3Cap ? n : kFmt3Cap - 1;
    }
    double scaled = a * 1000.0;
    double fl = std::floor(scaled);
    double frac = scaled - fl;
    double err = scaled * 2.3e-16 + 1e-12;
    if (std::fabs(frac - 0.5) <= err) {
        return snprintf(buf, kFmt3Cap, "%.3f", v);  // < 1e12: always fits
    }
    long k = (long)fl + (frac > 0.5 ? 1 : 0);
    char* p = buf;
    if (std::signbit(v)) *p++ = '-';
    long milli = k % 1000;
    p += utoa(p, k / 1000);
    *p++ = '.';
    *p++ = (char)('0' + milli / 100);
    *p++ = (char)('0' + (milli / 10) % 10);
    *p++ = (char)('0' + milli % 10);
    *p = '\0';
    return (int)(p - buf);
}

struct Turn {
    double start;
    double end;
    long track;  // speaker-major enumeration index (pre-drop)
    long speaker;
};

// Nonnegative long -> decimal ASCII (no terminator needed by callers that
// use the returned length). ~10x cheaper than snprintf("%ld").
inline int utoa(char* buf, long v) {
    char tmp[24];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    for (int i = 0; i < n; ++i) buf[i] = tmp[n - 1 - i];
    buf[n] = '\0';
    return n;
}

inline int ndigits(long v) {
    int n = 1;
    while (v >= 10) { v /= 10; ++n; }
    return n;
}

// Decimal-STRING order of two nonnegative track ids ("10" < "2"), without
// formatting: equal digit counts compare numerically; otherwise scale the
// shorter to the longer's length — a scaled tie means the shorter is a
// prefix, which sorts first.
inline bool dec_str_less(long a, long b) {
    if (a == b) return false;
    int da = ndigits(a), db = ndigits(b);
    if (da == db) return a < b;
    if (da < db) {
        for (int i = 0; i < db - da; ++i) a *= 10;
        return a <= b;
    }
    for (int i = 0; i < da - db; ++i) b *= 10;
    return a < b;
}

// Python sorts entries by (start, end, str(track)): decimal-string
// comparison of the track id, so "10" < "2".
inline bool turn_less(const Turn& a, const Turn& b) {
    if (a.start != b.start) return a.start < b.start;
    if (a.end != b.end) return a.end < b.end;
    return dec_str_less(a.track, b.track);
}

// Append one stream's RTTM text given its turns (speaker-major detection
// order). Mirrors ops/binarize.py _rttm_lines: empty segments dropped
// AFTER track ids were assigned; lines sorted by (start, end, str(track)).
char* assemble(std::vector<Turn>& turns, const char* uri, long* out_len) {
    std::vector<Turn> kept;
    kept.reserve(turns.size());
    for (const Turn& t : turns)
        if (t.end - t.start > 0) kept.push_back(t);
    std::stable_sort(kept.begin(), kept.end(), turn_less);

    const char* u = (uri && uri[0]) ? uri : "<NA>";
    size_t ulen = strlen(u);
    std::string text;
    text.reserve(kept.size() * (48 + ulen));
    char nbuf[kFmt3Cap];
    for (const Turn& t : kept) {
        text.append("SPEAKER ", 8);
        text.append(u, ulen);
        text.append(" 1 ", 3);
        text.append(nbuf, fmt3(nbuf, t.start));
        text.push_back(' ');
        text.append(nbuf, fmt3(nbuf, t.end - t.start));
        text.append(" <NA> <NA> speaker", 18);
        text.append(nbuf, utoa(nbuf, t.speaker));
        text.append(" <NA> <NA>\n", 11);
    }
    char* buf = (char*)malloc(text.size() + 1);
    if (!buf) { *out_len = -1; return nullptr; }
    memcpy(buf, text.data(), text.size());
    buf[text.size()] = '\0';
    *out_len = (long)text.size();
    return buf;
}

// Turn detection over one stream, speaker-major, from a bit accessor.
// Frame-middle times in numpy's exact operation order:
//   (window_start + idx * resolution) + 0.5 * resolution
// (ops/binarize.py batch_binarize_rttm / binarize_rttm middles).
template <typename GetBit>
void detect(GetBit get, long frames, long speakers, double ws,
            double resolution, std::vector<Turn>& turns) {
    const double half = 0.5 * resolution;
    long track = 0;
    for (long s = 0; s < speakers; ++s) {
        long onset = -1;
        for (long f = 0; f < frames; ++f) {
            bool active = get(f, s);
            if (active && onset < 0) {
                onset = f;
            } else if (!active && onset >= 0) {
                turns.push_back({(ws + (double)onset * resolution) + half,
                                 (ws + (double)f * resolution) + half,
                                 track++, s});
                onset = -1;
            }
        }
        if (onset >= 0) {
            turns.push_back({(ws + (double)onset * resolution) + half,
                             (ws + (double)frames * resolution) + half,
                             track++, s});
        }
    }
}

}  // namespace

extern "C" {

// bits: (b, stream_stride) uint8, each stream's (frames, speakers) bool
//   map flattened frame-major then packed MSB-first (numpy packbits).
// window_starts: (b,) float64; resolution: shared frame duration (= step).
// uris: (b,) C strings (may be null -> "<NA>").
// emit: (b,) uint8 — streams to assemble (others get out[i] = NULL).
// out/out_len: (b,) caller-allocated arrays filled with malloc'd buffers.
// Returns 0, or -1 on allocation failure.
int rttm_from_bits(const unsigned char* bits, long b, long frames,
                   long speakers, long stream_stride,
                   const double* window_starts, double resolution,
                   const char* const* uris, const unsigned char* emit,
                   char** out, long* out_len) {
    std::vector<Turn> turns;
    for (long i = 0; i < b; ++i) {
        out[i] = nullptr;
        out_len[i] = 0;
        if (!emit[i]) continue;
        const unsigned char* row = bits + i * stream_stride;
        turns.clear();
        detect(
            [row, speakers](long f, long s) -> bool {
                long bit = f * speakers + s;
                return (row[bit >> 3] >> (7 - (bit & 7))) & 1;
            },
            frames, speakers, window_starts[i], resolution, turns);
        out[i] = assemble(turns, uris ? uris[i] : nullptr, &out_len[i]);
        if (!out[i] && out_len[i] < 0) return -1;
    }
    return 0;
}

// scores: (b, frames, speakers) float32, C-contiguous. Threshold is
// strictly-greater in float32 — numpy 2 (NEP 50) casts the Python float
// threshold to the array dtype, so comparing in f32 here is bit-identical
// to the batch_binarize_rttm route.
int rttm_from_scores(const float* scores, long b, long frames, long speakers,
                     const double* window_starts, double resolution,
                     float threshold, const char* const* uris,
                     const unsigned char* emit, char** out, long* out_len) {
    std::vector<Turn> turns;
    const long stream = frames * speakers;
    for (long i = 0; i < b; ++i) {
        out[i] = nullptr;
        out_len[i] = 0;
        if (!emit[i]) continue;
        const float* row = scores + i * stream;
        turns.clear();
        detect(
            [row, speakers, threshold](long f, long s) -> bool {
                return row[f * speakers + s] > threshold;
            },
            frames, speakers, window_starts[i], resolution, turns);
        out[i] = assemble(turns, uris ? uris[i] : nullptr, &out_len[i]);
        if (!out[i] && out_len[i] < 0) return -1;
    }
    return 0;
}

void rttm_free(char** out, long b) {
    for (long i = 0; i < b; ++i) {
        free(out[i]);
        out[i] = nullptr;
    }
}

}  // extern "C"
