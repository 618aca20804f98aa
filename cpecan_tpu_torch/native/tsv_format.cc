// Native 15-column posterior-tsv block formatter.
//
// writePosteriorProbs (reference vanillaAlign.c:26-95) emits one tsv row
// per aligned pair; the Python block formatter (cli/signal_align.py) is
// exact but CPython %-formatting costs ~1.5us/row, which dominates the
// batched signalAlign pipeline's host time.  This formatter emits the
// identical bytes at ~0.15us/row.
//
// Float columns use "%f" semantics (6 decimals).  CPython formats via
// David Gay's dtoa: correctly rounded, ties-to-even ON THE EXACT BINARY
// VALUE.  That is reproduced exactly with integer arithmetic:
//   x = mant * 2^e  (53-bit mant via frexp/ldexp, exact for subnormals too)
//   x * 10^6 = (mant * 5^6) * 2^(e+6), and mant*5^6 fits in 67 bits,
// so the scaled value is an exact 128-bit integer times a power of two;
// round-half-even of that shift is the correctly-rounded decimal.  Values
// with |x| >= 9e12 (q would overflow int64), inf and nan fall back to
// snprintf (glibc is also correctly rounded; the pipeline's columns are
// posteriors <= 1 and pA-scale event stats, so the fallback never fires
// in practice).
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

char* emit_ll(char* o, long long v) {
  char tmp[24];
  int i = 0;
  unsigned long long u = v < 0 ? (*o++ = '-', 0ull - (unsigned long long)v)
                               : (unsigned long long)v;
  do { tmp[i++] = (char)('0' + u % 10); u /= 10; } while (u);
  while (i) *o++ = tmp[--i];
  return o;
}

// %f (6 decimals), exact CPython parity; returns new write pointer.
char* emit_f(char* o, double x) {
  if (!std::isfinite(x) || std::fabs(x) >= 9e12)
    return o + std::snprintf(o, 344, "%f", x);
  uint64_t bits;
  std::memcpy(&bits, &x, 8);
  if (bits >> 63) *o++ = '-';  // incl. -0.0 -> "-0.000000"
  int e;
  double m = std::frexp(std::fabs(x), &e);      // |x| = m * 2^e, m in [.5,1)
  uint64_t mant = (uint64_t)std::ldexp(m, 53);  // exact integer
  int s = -(e - 53 + 6);  // |x|*1e6 = (mant*5^6) * 2^-s
  unsigned __int128 P = (unsigned __int128)mant * 15625u;
  uint64_t q;
  if (s <= 0) {
    q = (uint64_t)(P << (-s));  // |x| < 9e12 keeps this in range
  } else if (s >= 69) {
    q = 0;  // P < 2^68 <= half: rounds to zero
  } else {
    unsigned __int128 rem = P & (((unsigned __int128)1 << s) - 1);
    unsigned __int128 half = (unsigned __int128)1 << (s - 1);
    q = (uint64_t)(P >> s);
    if (rem > half || (rem == half && (q & 1))) q++;
  }
  o = emit_ll(o, (long long)(q / 1000000u));
  *o++ = '.';
  uint32_t f = (uint32_t)(q % 1000000u);
  for (int d = 100000; d; d /= 10) *o++ = (char)('0' + (f / d) % 10);
  return o;
}

}  // namespace

extern "C" long long tsv_format_rows(
    const char* frag0,    // "<contig>\t"
    const char* frag2,    // "\t<label>\t<strand>\t"
    long long n,
    const long long* x_adj,
    const char* ref_col, long long ref_w,   // fixed-width byte kmers
    const long long* y,
    const double* ev,                        // [n, 3] row-major
    const char* k_col, long long k_w,
    const double* e_level, const double* e_noise, const double* p,
    const double* dmean, const double* de_level,
    char* out, long long cap) {
  const size_t l0 = std::strlen(frag0), l2 = std::strlen(frag2);
  // worst-case row: frags + 2 ints + 10 floats (snprintf fallback can hit
  // ~340 chars for huge magnitudes) + kmers + separators
  const long long row_max =
      (long long)(l0 + l2) + 2 * 21 + 10 * 344 + ref_w + k_w + 16;
  char* o = out;
  for (long long i = 0; i < n; i++) {
    if ((out + cap) - o < row_max) return -1;
    std::memcpy(o, frag0, l0); o += l0;
    o = emit_ll(o, x_adj[i]); *o++ = '\t';
    std::memcpy(o, ref_col + i * ref_w, ref_w); o += ref_w;
    std::memcpy(o, frag2, l2); o += l2;
    o = emit_ll(o, y[i]);
    const double* e3 = ev + 3 * i;
    *o++ = '\t'; o = emit_f(o, e3[0]);
    *o++ = '\t'; o = emit_f(o, e3[1]);
    *o++ = '\t'; o = emit_f(o, e3[2]);
    *o++ = '\t'; std::memcpy(o, k_col + i * k_w, k_w); o += k_w;
    *o++ = '\t'; o = emit_f(o, e_level[i]);
    *o++ = '\t'; o = emit_f(o, e_noise[i]);
    *o++ = '\t'; o = emit_f(o, p[i]);
    *o++ = '\t'; o = emit_f(o, dmean[i]);
    *o++ = '\t'; o = emit_f(o, de_level[i]);
    *o++ = '\n';
  }
  return o - out;
}
