// Featurizer kernels for the host, with a plain C interface.
//
// A copy of the extract half of the reference package's native featurize
// module (deepsignal_tpu/native/featkernel.cpp: pairwise_sum, median_inplace,
// normalize_mad, segment_stats, append_repr6, format_rows6) for the PyTorch
// port, bound with ctypes instead of the CPython C API.  The caller
// allocates every output; a function that would write past an output's
// capacity, or read past its input, returns an error code instead.
//
// Every function reproduces numpy's bits (the extract_features.py hot loops
// at :143-151 and :269-276, and the feature-TSV cell format of :289-303):
// - mean/std: numpy reduces a contiguous float64 row with pairwise
//   summation (8 partial sums per block of at most 128, recursive halving
//   above), copied here step for step;
// - median: the element(s) numpy's partition selects; an even length takes
//   (lo + hi) / 2 in double, as np.median does;
// - np.around(x, 6) == rint(x * 1e6) / 1e6;
// - text: numpy's str() of a float64, shortest round-trip digits
//   (std::to_chars and numpy's dragon4 in its unique mode both give the
//   correctly rounded shortest decimal), positional for lo <= |x| < hi and
//   scientific elsewhere.  Where numpy switches notation depends on its
//   version, so the caller passes the range, probed from the installed
//   numpy.
//
// Build without -ffast-math, -march=native or FMA contraction: the sums
// must round as numpy's do.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// numpy's scalar pairwise summation (numpy/_core/src/umath/loops.c.src):
// blocks of 128, 8 partial sums.
double pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double s = 0.0;
    for (int64_t i = 0; i < n; i++) s += a[i];
    return s;
  }
  if (n <= 128) {
    double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
    double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
    int64_t i = 8;
    for (; i + 8 <= n; i += 8) {
      r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
      r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
    }
    double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
    for (; i < n; i++) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// np.median: partition-select; an even length -> mean of the two middles.
double median_inplace(std::vector<double>& v) {
  const size_t n = v.size();
  const size_t k = (n - 1) / 2;
  std::nth_element(v.begin(), v.begin() + k, v.end());
  const double lo = v[k];
  if (n % 2) return lo;
  const double hi = *std::min_element(v.begin() + k + 1, v.end());
  return (lo + hi) / 2.0;
}

// the longest text append_repr6 writes: "-1.2345678901234567e-308" is 24
// bytes; a positional form (hi <= 1e16, lo >= 1e-12) is shorter
constexpr int64_t kMaxRepr = 32;

// Lays out str() of a finite non-zero x from its shortest digits: positional
// for lo <= |x| < hi, else the scientific form that to_chars writes
// ("d[.ddd]e+-EE", at least two exponent digits, as numpy and Python).
int append_shortest(char* out, double x, double lo, double hi) {
  char tmp[48];
  const auto res = std::to_chars(tmp, tmp + sizeof tmp, x,
                                 std::chars_format::scientific);
  const double ax = std::fabs(x);
  if (!(ax >= lo && ax < hi)) {
    memcpy(out, tmp, res.ptr - tmp);
    return static_cast<int>(res.ptr - tmp);
  }
  // "[-]d[.ddd]e<sign>EE" -> digits and a decimal exponent
  const char* p = tmp;
  const bool neg = (*p == '-');
  if (neg) p++;
  char digits[24];
  int m = 0;
  digits[m++] = *p++;
  if (*p == '.') {
    p++;
    while (*p != 'e') digits[m++] = *p++;
  }
  int exp = 0;
  const bool eneg = (p[1] == '-');
  for (p += 2; p < res.ptr; p++) exp = exp * 10 + (*p - '0');
  if (eneg) exp = -exp;
  char* o = out;
  if (neg) *o++ = '-';
  if (exp + 1 >= m) {  // integral: digits, zero-pad, ".0"
    memcpy(o, digits, m);
    o += m;
    for (int i = 0; i < exp + 1 - m; i++) *o++ = '0';
    *o++ = '.';
    *o++ = '0';
  } else if (exp >= 0) {  // the point inside the digits
    memcpy(o, digits, exp + 1);
    o += exp + 1;
    *o++ = '.';
    memcpy(o, digits + exp + 1, m - exp - 1);
    o += m - exp - 1;
  } else {  // leading "0.00..."
    *o++ = '0';
    *o++ = '.';
    for (int i = 0; i < -exp - 1; i++) *o++ = '0';
    memcpy(o, digits, m);
    o += m;
  }
  return static_cast<int>(o - out);
}

// Appends str(np.float64 x) at out for an x already rounded to 6 decimals;
// returns the bytes written (at most kMaxRepr).  Where the 6-decimal
// positional form is the shortest round-trip text (1e-4 <= |x| < 1e9, inside
// the positional range, and x the double nearest k / 1e6: there the double's
// spacing is finer than the 6-decimal grid), it is written from the integer
// k, trailing zeros trimmed, with no digit search; every other value goes
// through append_shortest.
int append_repr6(char* out, double x, double lo, double hi) {
  char* o = out;
  if (std::isnan(x)) {
    memcpy(o, "nan", 3);
    return 3;
  }
  if (std::isinf(x)) {
    if (x < 0) *o++ = '-';
    memcpy(o, "inf", 3);
    return static_cast<int>(o - out) + 3;
  }
  if (x == 0.0) {
    if (std::signbit(x)) *o++ = '-';
    memcpy(o, "0.0", 3);
    return static_cast<int>(o - out) + 3;
  }
  const double ax = std::fabs(x);
  if (ax >= lo && ax < hi && ax >= 1e-4 && ax < 1e9) {
    const long long k = llrint(x * 1e6);
    if (static_cast<double>(k) / 1e6 == x) {
      unsigned long long u = k < 0 ? -static_cast<unsigned long long>(k)
                                   : static_cast<unsigned long long>(k);
      const unsigned long long q = u / 1000000;
      unsigned long long r = u % 1000000;
      if (k < 0) *o++ = '-';
      o = std::to_chars(o, o + 24, q).ptr;
      *o++ = '.';
      char frac[6];
      for (int d = 5; d >= 0; d--) { frac[d] = '0' + (r % 10); r /= 10; }
      int flen = 6;
      while (flen > 1 && frac[flen - 1] == '0') flen--;
      memcpy(o, frac, flen);
      return static_cast<int>(o - out) + flen;
    }
  }
  return append_shortest(out, x, lo, hi);
}

}  // namespace

extern "C" {

// np.mean and np.std (ddof 0) of x[starts[i] .. starts[i] + lens[i]) for
// i < m, into means[i] and stds[i].  Returns 0, or i + 1 when segment i is
// empty or runs outside x[0 .. n).
int64_t ds_segment_stats(const double* x, int64_t n, const int64_t* starts,
                         const int64_t* lens, int64_t m, double* means,
                         double* stds) {
  std::vector<double> sq;
  for (int64_t i = 0; i < m; i++) {
    const int64_t s = starts[i], len = lens[i];
    if (len <= 0 || s < 0 || s > n - len) return i + 1;
    const double* seg = x + s;
    // np.mean: pairwise sum / len
    const double mean = pairwise_sum(seg, len) / static_cast<double>(len);
    // np.std (_var, ddof=0): pairwise sum of (x - mean)^2 / len, then sqrt
    sq.resize(len);
    for (int64_t j = 0; j < len; j++) {
      const double d = seg[j] - mean;
      sq[j] = d * d;
    }
    means[i] = mean;
    stds[i] = std::sqrt(pairwise_sum(sq.data(), len) /
                        static_cast<double>(len));
  }
  return 0;
}

// MAD normalization of a rescaled signal x[0 .. n) into out, rounded to 6
// decimals: (x - median(x)) / median(|x - median(x)| / 0.6744897501960817),
// the statsmodels robust.mad op order (extract_features.py:143-151).
void ds_normalize_mad(const double* x, int64_t n, double* out) {
  if (n <= 0) return;
  constexpr double kMadScale = 0.6744897501960817;  // norm.ppf(0.75)
  std::vector<double> scratch(x, x + n);
  const double med = median_inplace(scratch);
  for (int64_t i = 0; i < n; i++)
    scratch[i] = std::fabs(x[i] - med) / kMadScale;
  const double sscale = median_inplace(scratch);
  for (int64_t i = 0; i < n; i++)
    out[i] = std::rint((x[i] - med) / sscale * 1e6) / 1e6;
}

// Each row of the [s, k] matrix x (6-decimal values) as the comma-joined
// str() of its values, the rows one after another in out (capacity cap
// bytes), the end offset of row i in ends[i]; positional for lo <= |x| <
// hi.  Returns the bytes written, or -1 when out is too small.
int64_t ds_format_rows6(const double* x, int64_t s, int64_t k, char* out,
                        int64_t cap, int64_t* ends, double lo, double hi) {
  int64_t w = 0;
  for (int64_t i = 0; i < s; i++) {
    for (int64_t j = 0; j < k; j++) {
      if (w + kMaxRepr + 1 > cap) return -1;
      if (j) out[w++] = ',';
      w += append_repr6(out + w, x[i * k + j], lo, hi);
    }
    ends[i] = w;
  }
  return w;
}

}  // extern "C"
