// Feature-TSV block parser for the host, with a plain C interface.
//
// A copy of the reference package's native parser
// (deepsignal_tpu/native/fastparse.cpp, parse_feature_block) for the
// PyTorch port, bound with ctypes instead of the CPython C API: the caller
// counts the rows with ds_count_feature_rows, allocates the numpy outputs
// and passes them in, and gets each row's sampleinfo back as a byte range
// of the block.  ds_read_full reads a chunk of a TSV and
// ds_find_read_batch_ends finds in it where the reader's read-grouped
// batches end.  Rows are the 12-column deepsignal feature rows: chrom, pos,
// strand, pos_in_strand, readname, read_strand, k_mer, means csv, stds csv,
// lens csv, cent_signals csv, label.
//
// What bounds it on the host: about 400 floats a row.  strtof takes most of
// a row's time, so a float is parsed with std::from_chars where that gives
// strtof's answer, and with strtof everywhere else: from_chars takes no
// leading whitespace, no '+', no hex, and reports out-of-range values
// instead of rounding them, so a value that starts with anything but a
// digit, '.' or "-<digit>", that from_chars refuses, or that it stops at an
// 'x' (the "0x" of a hex value) goes to strtof.  The rows accepted and the
// float32 bits are then those of the reference parser, whose quirks are
// kept as they are (a field's last value may be followed by anything up to
// the next tab; strtof may skip a tab as leading whitespace).
//
// The block must end in a NUL byte one past its length (a Python bytes
// object does): strtof and strtol, as in the reference, read up to the
// first character that is not part of a number.

#include <unistd.h>

#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <vector>

namespace {

inline const char* find_tab(const char* p, const char* end) {
  return static_cast<const char*>(memchr(p, '\t', end - p));
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// One float32 at p, as strtof(p, &next) parses it; returns next (== p when
// nothing was parsed).  `end` is the end of the whole block.
inline const char* parse_f32(const char* p, const char* end, float* out) {
  const char c = *p;
  if (is_digit(c) || c == '.' || (c == '-' && (is_digit(p[1]) || p[1] == '.'))) {
    float v;
    const auto r = std::from_chars(p, end, v);
    if (r.ec == std::errc() && *r.ptr != 'x' && *r.ptr != 'X') {
      *out = v;
      return r.ptr;
    }
  }
  char* next = nullptr;
  *out = strtof(p, &next);
  return next;
}

// a comma-separated float list into out[0..n)
bool parse_floats(const char* p, const char* end, const char* block_end,
                  float* out, int n) {
  for (int i = 0; i < n; i++) {
    const char* next = parse_f32(p, block_end, out + i);
    if (next == p) return false;
    p = next;
    if (i + 1 < n) {
      if (p >= end || *p != ',') return false;
      p++;
    }
  }
  return true;
}

bool parse_ints(const char* p, const char* end, int* out, int n) {
  char* next = nullptr;
  for (int i = 0; i < n; i++) {
    out[i] = static_cast<int>(strtol(p, &next, 10));
    if (next == p) return false;
    p = next;
    if (i + 1 < n) {
      if (p >= end || *p != ',') return false;
      p++;
    }
  }
  return true;
}

int base_code(char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case 'U': return 3;  // RNA
    default: return 4;   // N / unknown
  }
}

}  // namespace

extern "C" {

// The rows of a block: its non-empty lines.
int64_t ds_count_feature_rows(const char* data, int64_t len) {
  const char* p = data;
  const char* end = data + len;
  int64_t n = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* le = nl ? nl : end;
    if (le > p) n++;
    p = nl ? nl + 1 : end;
  }
  return n;
}

// Parse the n rows of a block into the caller's arrays: kmers, lens [n, k]
// int32, means, stds [n, k] and signals [n, s] float32, labels [n] int32,
// info [n, 2] int64 (each row's sampleinfo as [start, end) byte offsets).
// Returns 0, or 1 for a row without its 12 columns, 2 for a malformed
// numeric field, 3 for a malformed label, with the row in *bad_row; -1 when
// the block holds another number of rows than n.
int ds_parse_feature_block(const char* data, int64_t len, int32_t kmer_len,
                           int32_t signal_len, int64_t n, int32_t* km,
                           float* me, float* st, int32_t* le, float* si,
                           int32_t* la, int64_t* info, int64_t* bad_row) {
  const char* end = data + len;
  const int64_t k = kmer_len, s = signal_len;
  std::vector<int> tmp_int(k > 0 ? k : 1);
  const char* p = data;
  int64_t r = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    if (line_end == p) {  // empty line
      p = nl ? nl + 1 : end;
      continue;
    }
    if (r >= n) return -1;
    *bad_row = r;
    const char* le_ptr = line_end;
    if (le_ptr[-1] == '\r') le_ptr--;

    // columns 0-5 -> sampleinfo
    const char* q = p;
    const char* info_end = nullptr;
    for (int c = 0; c < 6; c++) {
      const char* t = find_tab(q, le_ptr);
      if (!t) return 1;
      info_end = t;
      q = t + 1;
    }
    const char* col_start[6];  // cols 6..11
    col_start[0] = q;  // kmer
    for (int c = 1; c < 6; c++) {
      const char* t = find_tab(q, le_ptr);
      if (!t) return 1;
      q = t + 1;
      col_start[c] = q;
    }
    for (int64_t i = 0; i < k; i++)
      km[r * k + i] = base_code(col_start[0][i]);
    if (!parse_floats(col_start[1], col_start[2] - 1, end, me + r * k,
                      static_cast<int>(k)) ||
        !parse_floats(col_start[2], col_start[3] - 1, end, st + r * k,
                      static_cast<int>(k)) ||
        !parse_ints(col_start[3], col_start[4] - 1, tmp_int.data(),
                    static_cast<int>(k)) ||
        !parse_floats(col_start[4], col_start[5] - 1, end, si + r * s,
                      static_cast<int>(s)))
      return 2;
    for (int64_t i = 0; i < k; i++) le[r * k + i] = tmp_int[i];
    char* lend = nullptr;
    la[r] = static_cast<int32_t>(strtol(col_start[5], &lend, 10));
    if (lend == col_start[5]) return 3;
    info[2 * r] = p - data;
    info[2 * r + 1] = info_end - data;
    r++;
    p = nl ? nl + 1 : end;
  }
  return r == n ? 0 : -1;
}

// Read fd into buf[0, len) until it is full or the input ends: a pipe gives
// at most its own buffer a read, and one call here holds no interpreter
// lock between those reads.  Returns the bytes read and sets *at_eof when
// the input ended; an interrupted read returns what was read so far, for
// the caller to handle its signals and call again; -errno on an error.
int64_t ds_read_full(int32_t fd, char* buf, int64_t len, int32_t* at_eof) {
  int64_t got = 0;
  *at_eof = 0;
  while (got < len) {
    const ssize_t r = read(fd, buf + got, static_cast<size_t>(len - got));
    if (r == 0) {
      *at_eof = 1;
      break;
    }
    if (r < 0) {
      if (errno == EINTR) break;
      return -errno;
    }
    got += r;
  }
  return got;
}

// The ends of read-grouped batches in a chunk of feature rows, for the
// reader that groups a TSV by read (call_modifications.py:35-91): a batch
// ends where the reads_per_batch-th, 2 * reads_per_batch-th, ... change of
// read name begins, counted from the first row of the file.  A row's read
// name is its fifth tab-separated field as line.split(b"\t", 5)[4] takes
// it: from the fourth tab to the fifth, or to the row's end, newline
// included, when the row has no fifth tab.
//
// The chunk holds rows in file order; a last row without its newline is
// scanned only when at_eof.  prev[0, prev_len) is the read name of the row
// before the chunk (prev_len < 0 before the file's first row).  state[0]
// holds the reads completed so far and is updated; on return state[1],
// state[2] are the last scanned row's read name as [start, end) offsets of
// data (-1 when no row was scanned), state[3] the bytes of the rows
// scanned, state[4] their count, and state[5] the chunk's first row with
// fewer than five fields (-1 for none), where the scan stopped.  Writes the
// offsets at which a batch ends into ends and returns their count, or -1
// when they outnumber max_ends.
int64_t ds_find_read_batch_ends(const char* data, int64_t len, int32_t at_eof,
                                const char* prev, int64_t prev_len,
                                int64_t reads_per_batch, int64_t* ends,
                                int64_t max_ends, int64_t* state) {
  const char* end = data + len;
  const char* name = prev;
  int64_t name_len = prev_len;
  int64_t reads = state[0], n_ends = 0, rows = 0;
  state[1] = state[2] = state[5] = -1;
  const char* p = data;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl && !at_eof) break;
    const char* row_end = nl ? nl + 1 : end;
    const char* q = p;
    int tabs = 0;
    for (; tabs < 4; tabs++) {
      const char* t = find_tab(q, row_end);
      if (!t) break;
      q = t + 1;
    }
    if (tabs < 4) {
      state[5] = rows;
      break;
    }
    const char* t = find_tab(q, row_end);
    const int64_t q_len = (t ? t : row_end) - q;
    if (name_len >= 0 &&
        (q_len != name_len || memcmp(q, name, q_len) != 0) &&
        ++reads % reads_per_batch == 0) {
      if (n_ends >= max_ends) return -1;
      ends[n_ends++] = p - data;
    }
    name = q;
    name_len = q_len;
    state[1] = q - data;
    state[2] = q - data + q_len;
    rows++;
    p = row_end;
  }
  state[0] = reads;
  state[3] = p - data;
  state[4] = rows;
  return n_ends;
}

}  // extern "C"
