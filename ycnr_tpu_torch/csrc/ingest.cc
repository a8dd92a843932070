// Native MovieLens ratings parser of the PyTorch/CUDA port (host code).
//
// The port's own copy of the parsing entry points of the JAX package's
// ycnr_tpu/native/ingest.cc, so that both packages read a file into the
// same arrays at the same speed:
//
//   ycnr_count_rows(path)               -> row count (for preallocation)
//   ycnr_parse_ratings(path, sep, ...)  -> fill user/item/rating arrays
//   ycnr_parse_ratings_ts(...)          -> the same plus the timestamps
//
// Built at first use by ycnr_tpu_torch/data/native.py:
//   g++ -O3 -march=native -shared -fPIC ingest.cc -o libycnr_ingest-<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Count data rows (newline count, minus a possible "userId,..." header).
long long ycnr_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long long lines = 0;
  bool header = false;
  std::vector<char> buf(1 << 20);
  size_t got;
  bool first_chunk = true;
  char last = '\n';
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    if (first_chunk) {
      // same non-digit-first-byte sniff as ycnr_parse_ratings
      size_t i = 0;
      while (i < got && (buf[i] == ' ' || buf[i] == '\t')) i++;
      header = (i < got && !(buf[i] >= '0' && buf[i] <= '9'));
      first_chunk = false;
    }
    for (size_t i = 0; i < got; i++)
      if (buf[i] == '\n') lines++;
    last = buf[got - 1];
  }
  fclose(f);
  if (last != '\n') lines++;  // unterminated final line
  return lines - (header ? 1 : 0);
}

// --- fast field parsers (ASCII, no locale) -------------------------------
// strtol/strtof are locale-aware and slow; rating files are plain ASCII
// decimals. Both helpers bound themselves by `end` and report via `ok`.

static inline long ycnr_parse_long(char** pp, char* end, bool* ok) {
  char* p = *pp;
  while (p < end && (*p == ' ' || *p == '\t')) p++;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); p++; }
  long v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    any = true;
    p++;
  }
  *ok = any;
  *pp = p;
  return neg ? -v : v;
}

static inline float ycnr_parse_float(char** pp, char* end, bool* ok) {
  char* p = *pp;
  while (p < end && (*p == ' ' || *p == '\t')) p++;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); p++; }
  double v = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p - '0');
    any = true;
    p++;
  }
  if (p < end && *p == '.') {
    p++;
    double f = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * f;
      f *= 0.1;
      any = true;
      p++;
    }
  }
  if (any && p < end && (*p == 'e' || *p == 'E')) {
    char* save = p;
    p++;
    bool eok;
    long ex = ycnr_parse_long(&p, end, &eok);
    if (eok) {
      double scale = 1.0;
      long a = ex < 0 ? -ex : ex;
      while (a--) scale *= 10.0;
      v = ex < 0 ? v / scale : v * scale;
    } else {
      p = save;  // bare 'e' belongs to whatever follows, not the number
    }
  }
  *ok = any;
  *pp = p;
  return (float)(neg ? -v : v);
}

// Parse "<user><sep><item><sep><rating>..." rows. sep_mode: 0 = single char
// in sep[0] (tab or comma), 1 = the two-char separator "::" (ml-1m/10m).
// Skips a "userId..." header. Returns rows parsed, or -1 on open failure.
//
// Streams through a fixed 4 MB buffer (partial trailing line carried across
// reads) instead of slurping the file: a whole-file vector means hundreds of
// MB of fresh first-touch pages before parsing starts, which on ballooned
// VMs (docs/KERNELS.md "host-side build notes") costs far more than the
// parse itself.
// Core loop shared by the with/without-timestamp entry points: `ts` may be
// null (skip the 4th column) or an int64 output array (parse it; a missing
// or malformed 4th field stores 0 but keeps the row — some exports drop the
// timestamp column and that must not reject the dataset).
static long long ycnr_parse_impl(const char* path, int sep_mode, int64_t cap,
                                 int32_t* users, int32_t* items,
                                 float* ratings, int64_t* ts) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const size_t BUF = (size_t)4 << 20;
  std::vector<char> buf(BUF);
  size_t have = 0;      // carried bytes of an unterminated trailing line
  bool first = true;    // header sniff pending
  bool discard = false; // inside a line longer than BUF: drop to newline
  const int sw = (sep_mode == 1 ? 2 : 1);  // separator width
  long long row = 0;
  long long bad = 0;
  for (;;) {
    size_t got = fread(buf.data() + have, 1, BUF - have, f);
    size_t len = have + got;
    if (len == 0) break;
    bool eof = (got == 0);
    char* p = buf.data();
    char* end = p + len;
    if (discard) {
      while (p < end && *p != '\n') p++;
      if (p < end) {
        p++;
        discard = false;
      }
    }
    // parse only up to the last complete line unless this is the tail
    char* stop = end;
    if (!eof) {
      while (stop > p && stop[-1] != '\n') stop--;
      if (stop == p && len == BUF && !discard) {
        // no newline in a full buffer: pathological line; skip it
        bad++;
        discard = true;
        have = 0;
        continue;
      }
    }
    if (first) {
      // header sniff: a first line starting with a non-digit is a
      // header/comment ("userId", "user_id", ... — the Python fallback is
      // case-insensitive and this must not be stricter)
      char* q = p;
      while (q < stop && (*q == ' ' || *q == '\t')) q++;
      if (q < stop && !(*q >= '0' && *q <= '9')) {
        while (p < stop && *p != '\n') p++;
        if (p < stop) p++;
      }
      first = false;
    }
    while (p < stop && row < cap) {
      if (*p == '\n') { p++; continue; }
      char* line_end = p;
      while (line_end < stop && *line_end != '\n') line_end++;
      bool ok;
      long u = ycnr_parse_long(&p, line_end, &ok);
      ok = ok && (p + sw <= line_end);
      long it = 0;
      float r = 0.0f;
      if (ok) {
        p += sw;
        it = ycnr_parse_long(&p, line_end, &ok);
        ok = ok && (p + sw <= line_end);
      }
      if (ok) {
        p += sw;
        r = ycnr_parse_float(&p, line_end, &ok);
      }
      if (ok) {
        users[row] = (int32_t)u;
        items[row] = (int32_t)it;
        ratings[row] = r;
        if (ts) {
          long long t = 0;
          if (p + sw <= line_end) {
            p += sw;
            bool tok;
            long tv = ycnr_parse_long(&p, line_end, &tok);
            if (tok) t = tv;
          }
          ts[row] = (int64_t)t;
        }
        row++;
      } else {
        bad++;  // malformed row: skip the LINE, keep parsing (the Python
                // fallback skips bad lines too; breaking here would
                // silently truncate the dataset at the first bad row)
      }
      p = (line_end < stop) ? line_end + 1 : line_end;
    }
    if (eof || row >= cap) break;
    have = (size_t)(end - stop);
    if (have) memmove(buf.data(), stop, have);
  }
  fclose(f);
  // a file that yielded nothing but had content is not "an empty dataset";
  // signal failure so the caller falls back to the tolerant Python parser
  if (row == 0 && bad > 0) return -2;
  return row;
}

long long ycnr_parse_ratings(const char* path, const char* sep, int sep_mode,
                             int64_t cap, int32_t* users, int32_t* items,
                             float* ratings) {
  (void)sep;  // separator bytes are skipped positionally (as before)
  return ycnr_parse_impl(path, sep_mode, cap, users, items, ratings,
                         nullptr);
}

// 4-column variant: also extracts the timestamp column (reference call
// stack 3.1 parses (userId, movieId, rating, ts); the reference keeps ts
// in its DB rows, which enables time-ordered splits).
long long ycnr_parse_ratings_ts(const char* path, const char* sep,
                                int sep_mode, int64_t cap, int32_t* users,
                                int32_t* items, float* ratings,
                                int64_t* ts) {
  (void)sep;
  return ycnr_parse_impl(path, sep_mode, cap, users, items, ratings, ts);
}

// Packed rated-set bitfield for BPR's collision test: bits is a zeroed
// [(n_users + 1) * W] uint32 array, W = ceil(n_items / 32). One pass over
// nnz; the caller has checked the id ranges.
int ycnr_pack_bits(const int32_t* u, const int32_t* i, int64_t nnz,
                   int64_t W, uint32_t* bits) {
  for (int64_t k = 0; k < nnz; k++) {
    const int64_t row = (int64_t)u[k] * W + (i[k] >> 5);
    bits[row] |= (uint32_t)1 << (i[k] & 31);
  }
  return 0;
}

}  // extern "C"
