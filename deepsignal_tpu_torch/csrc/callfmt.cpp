// Call-row formatter for the host, with a plain C interface.
//
// A copy of the call-row half of the reference package's native featurize
// module (deepsignal_tpu/native/featkernel.cpp: append_float32_repr,
// format_call_block, count_read_runs, repr_f32) for the PyTorch port, bound
// with ctypes instead of the CPython C API.  The caller passes the batch's
// sampleinfo strings as one utf-8 buffer with [n + 1] byte offsets and
// allocates every output; a function that would write past an output's
// capacity returns -1 instead.
//
// Each call_mods output line is "info\tp0\tp1\tpred\tkmer\n" with the
// probabilities formatted as numpy prints a float32 scalar (str()), the
// 10-column contract of the reference's call_modifications.py:184-190.
// Where numpy switches between positional and scientific notation depends
// on its version (numpy 2.0: positional for 1e-4 <= |x| < 1e16, the range
// the reference package hardcodes; later versions leave positional notation
// sooner), so the caller passes that range, probed from the installed
// numpy.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Appends str(np.float32 x) at out; returns the bytes written (at most 24).
// - nan (any sign) -> "nan"; +/-inf -> "inf"/"-inf"; +/-0 -> "0.0"/"-0.0"
// - shortest round-trip digits (std::to_chars and numpy's dragon4 in its
//   unique mode both give the correctly rounded shortest decimal)
// - positional iff lo <= |x| < hi, compared on the exact double value
//   (numpy's own test: with lo = 1e-4, float32(1e-4) = 9.9999997e-5 prints
//   scientific), with ".0" after an integral value; else the scientific
//   form "d[.ddd]e+-EE" that to_chars writes (float32 exponents have 2
//   digits).
int append_float32_repr(char* out, float x, double lo, double hi) {
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
  if (x == 0.0f) {
    if (std::signbit(x)) *o++ = '-';
    memcpy(o, "0.0", 3);
    return static_cast<int>(o - out) + 3;
  }
  char tmp[48];
  const auto res = std::to_chars(tmp, tmp + sizeof tmp, x,
                                 std::chars_format::scientific);
  // "[-]d[.ddd]e<sign>EE" -> digits and a decimal exponent
  const char* p = tmp;
  const bool neg = (*p == '-');
  if (neg) p++;
  char digits[16];
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

  const double ax = std::fabs(static_cast<double>(x));
  if (ax >= lo && ax < hi) {  // positional
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
  } else {  // scientific: the to_chars output as it is
    memcpy(o, tmp, res.ptr - tmp);
    o += res.ptr - tmp;
  }
  return static_cast<int>(o - out);
}

// the longest repr: "-" + 9 digits zero-padded to 16 places + ".0" (hi is
// at most 1e16)
constexpr int64_t kMaxRepr = 24;

}  // namespace

extern "C" {

// str(np.float32) of x[0..n), positional for lo <= |x| < hi: the texts one
// after another in out (capacity cap bytes), the end offset of text i in
// ends[i].  Returns the bytes written, or -1 when out is too small.
int64_t ds_repr_f32(const float* x, int64_t n, char* out, int64_t cap,
                    int64_t* ends, double lo, double hi) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    if (w + kMaxRepr > cap) return -1;
    w += append_float32_repr(out + w, x[i], lo, hi);
    ends[i] = w;
  }
  return w;
}

// The call rows of a batch as one block in out (capacity cap bytes):
// sampleinfo i is info[offs[i]..offs[i + 1]), kmers [n, k] uint8 codes
// mapped to letters by lut (256 bytes), the probabilities positional for
// lo <= |p| < hi.  Returns the bytes written, or -1 when out is too small.
int64_t ds_format_call_block(const char* info, const int64_t* offs,
                             const float* p0, const float* p1,
                             const int64_t* pred, const uint8_t* kmers,
                             int64_t n, int64_t k, const char* lut, char* out,
                             int64_t cap, double lo, double hi) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t ulen = offs[i + 1] - offs[i];
    if (w + ulen + 2 * kMaxRepr + 24 + k + 4 > cap) return -1;
    memcpy(out + w, info + offs[i], ulen);
    w += ulen;
    out[w++] = '\t';
    w += append_float32_repr(out + w, p0[i], lo, hi);
    out[w++] = '\t';
    w += append_float32_repr(out + w, p1[i], lo, hi);
    out[w++] = '\t';
    const auto ires = std::to_chars(out + w, out + w + 24,
                                    static_cast<long long>(pred[i]));
    w = ires.ptr - out;
    out[w++] = '\t';
    const uint8_t* row = kmers + i * k;
    for (int64_t j = 0; j < k; j++) out[w++] = lut[row[j]];
    out[w++] = '\n';
  }
  return w;
}

// The contiguous same-read runs over the n sampleinfo strings (read name =
// the 5th of the 6 tab-separated fields).  Writes [first_start, first_end,
// last_start, last_end] (byte offsets into info of the first and the last
// row's read name) and returns the run count, or -(i + 1) when string i has
// fewer than 6 fields.
int64_t ds_count_read_runs(const char* info, const int64_t* offs, int64_t n,
                           int64_t* names) {
  names[0] = names[1] = names[2] = names[3] = 0;
  const char* prev = nullptr;
  int64_t prev_len = 0;
  int64_t runs = 0;
  for (int64_t i = 0; i < n; i++) {
    const char* p = info + offs[i];
    const char* end = info + offs[i + 1];
    int tabs = 0;
    while (p < end && tabs < 4) {
      if (*p == '\t') tabs++;
      p++;
    }
    const char* q = p;
    while (q < end && *q != '\t') q++;
    if (tabs < 4 || q == end) return -(i + 1);
    const int64_t len = q - p;
    if (prev == nullptr || len != prev_len ||
        memcmp(p, prev, static_cast<size_t>(len)) != 0) {
      runs++;
      if (runs == 1) {
        names[0] = p - info;
        names[1] = q - info;
      }
    }
    prev = p;
    prev_len = len;
    names[2] = p - info;
    names[3] = q - info;
  }
  return runs;
}

}  // extern "C"
