// Native genotype parsing + packing (mixmogam_tpu.native).
//
// The reference parses genotype CSVs line-by-line in pure Python
// (dataParsers.py, SURVEY.md §2.1) — fine for 200k rows on 2008 hardware,
// a bottleneck for the 1M-SNP configs this framework targets. This module
// is the host-side data-plane in C++: a threaded CSV->int8 dosage parser
// and a 2-bit genotype packer/unpacker, exposed through a C ABI consumed
// via ctypes (no pybind11 dependency).
//
// Layout contract (shared with data/genotype.py): row-major (M, n) int8,
// missing = -1; chromosomes int32, positions int64.
//
// Build: make -C native   (g++ -O3 -shared -fPIC, no deps)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Count NON-BLANK data lines and detect the number of comma-separated
// fields in the header. Blank/whitespace-only lines (including a trailing
// '\n\n') are not data rows — counting them used to allocate phantom rows
// that parse_dosage_csv left as uninitialized memory. Returns 0 on success.
int count_csv(const char* path, int64_t* n_rows, int64_t* n_fields) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  // header
  int64_t fields = 1;
  int c;
  while ((c = fgetc(f)) != EOF && c != '\n')
    if (c == ',') fields++;
  if (c == EOF) { fclose(f); return 2; }
  // count remaining non-blank lines (buffered)
  std::vector<char> buf(1 << 20);
  int64_t rows = 0;
  size_t got;
  bool has_content = false;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; i++) {
      if (buf[i] == '\n') {
        if (has_content) rows++;
        has_content = false;
      } else if (buf[i] != ' ' && buf[i] != '\t' && buf[i] != '\r') {
        has_content = true;
      }
    }
  }
  if (has_content) rows++;  // file without trailing newline
  fclose(f);
  *n_rows = rows;
  *n_fields = fields;
  return 0;
}

namespace {

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// strict non-negative integer field terminated by ','; tolerates
// surrounding whitespace; anything else (e.g. 'Chr1', 'X') is a parse
// FAILURE so the caller falls back to the Python parser, which raises a
// proper error — silently stripping letters mapped 'X'/'MT' to 0.
inline bool parse_int_field(const char*& p, const char* end, int64_t* out) {
  while (p < end && is_space(*p)) p++;
  bool digit = false;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    digit = true;
    p++;
  }
  while (p < end && is_space(*p)) p++;
  if (!digit || p >= end || *p != ',') return false;
  p++;  // consume ','
  *out = v;
  return true;
}

// missing-token spellings shared with the Python parser
// (_MISSING_TOKENS in data/parsers.py); token is already trimmed
inline bool is_missing_token(const char* b, const char* e) {
  size_t len = (size_t)(e - b);
  if (len == 0) return true;
  if (len == 1) return *b == 'N' || *b == '-' || *b == '?';
  if (len == 2) return b[0] == 'N' && b[1] == 'A';
  if (len == 3) return (b[0] == 'N' && b[1] == 'a' && b[2] == 'N') ||
                       (b[0] == 'n' && b[1] == 'a' && b[2] == 'n');
  return false;
}

// parse one data line "chrom,pos,v,v,..." into row-major outputs
inline bool parse_line(const char* p, const char* end, int64_t row,
                       int64_t n_samples, int8_t* mat, int32_t* chroms,
                       int64_t* poss) {
  int64_t chrom = 0, pos = 0;
  if (!parse_int_field(p, end, &chrom)) return false;
  if (!parse_int_field(p, end, &pos)) return false;
  chroms[row] = (int32_t)chrom;
  poss[row] = pos;
  int8_t* out = mat + row * n_samples;
  int64_t i = 0;
  while (i < n_samples && p <= end) {
    // token until ',' or line end; trim whitespace (a ', '-separated CSV
    // used to turn every padded cell into missing)
    const char* tok = p;
    while (p < end && *p != ',') p++;
    const char* te = p;
    while (tok < te && is_space(*tok)) tok++;
    while (te > tok && is_space(te[-1])) te--;
    int v;
    if (is_missing_token(tok, te)) {
      v = -1;
    } else {
      bool neg = false;
      const char* q = tok;
      if (*q == '-') { neg = true; q++; }
      bool digit = false;
      int acc = 0;
      while (q < te) {
        if (*q < '0' || *q > '9') return false;  // not int, not missing
        acc = acc * 10 + (*q - '0');
        digit = true;
        q++;
      }
      if (!digit) return false;
      v = neg ? -acc : acc;
      if (v > 127) return false;  // int8 overflow: Python path raises too
    }
    out[i++] = (int8_t)(v < 0 ? -1 : v);
    if (p < end) p++;  // skip comma
    else break;
  }
  while (i < n_samples) out[i++] = -1;
  return true;
}

}  // namespace

// Parse the data body of a dosage CSV (after the header line) into
// preallocated arrays. Blank/whitespace-only lines are skipped (matching
// count_csv and the Python parser). n_threads <= 0 -> hardware
// concurrency. Returns number of rows parsed, -1 on I/O error, or -2 on
// a malformed line (non-numeric chrom/pos or a token that is neither an
// integer dosage nor a missing spelling) — the caller then falls back to
// the Python parser, which raises a descriptive error.
int64_t parse_dosage_csv(const char* path, int64_t n_rows,
                         int64_t n_samples, int8_t* mat, int32_t* chroms,
                         int64_t* poss, int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // slurp whole file (SNP CSVs are <=GBs; bounded by container RAM)
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> data((size_t)sz);
  if (fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    return -1;
  }
  fclose(f);
  const char* base = data.data();
  const char* eof = base + sz;
  // skip header
  const char* body = (const char*)memchr(base, '\n', (size_t)sz);
  if (!body) return -1;
  body++;

  // index non-blank lines as explicit (start, end) spans so a skipped
  // blank line never leaks into the previous row's token stream
  std::vector<const char*> starts, ends;
  starts.reserve((size_t)n_rows);
  ends.reserve((size_t)n_rows);
  const char* p = body;
  while (p < eof && (int64_t)starts.size() < n_rows) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(eof - p));
    const char* e = nl ? nl : eof;
    while (e > p && (e[-1] == '\n' || e[-1] == '\r')) e--;
    bool content = false;
    for (const char* q = p; q < e; q++)
      if (*q != ' ' && *q != '\t') { content = true; break; }
    if (content) {
      starts.push_back(p);
      ends.push_back(e);
    }
    p = nl ? nl + 1 : eof;
  }
  int64_t rows = (int64_t)starts.size();

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > rows) nt = (int)rows;
  if (nt < 1) nt = 1;
  std::vector<std::thread> th;
  std::atomic<bool> bad(false);
  int64_t per = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min(rows, lo + per);
    if (lo >= hi) break;
    th.emplace_back([&, lo, hi]() {
      for (int64_t r = lo; r < hi; r++) {
        if (!parse_line(starts[(size_t)r], ends[(size_t)r], r, n_samples,
                        mat, chroms, poss)) {
          bad.store(true, std::memory_order_relaxed);
          return;
        }
      }
    });
  }
  for (auto& x : th) x.join();
  if (bad.load()) return -2;
  return rows;
}

// ---- 2-bit genotype packing (dosage 0..2 + missing) ------------------
// Codes: 0->0b00, 1->0b01, 2->0b10, missing->0b11. 4 genotypes/byte along
// the sample axis; rows padded to a multiple of 4 samples.

int64_t packed_row_bytes(int64_t n_samples) { return (n_samples + 3) / 4; }

void pack_2bit(const int8_t* mat, int64_t n_rows, int64_t n_samples,
               uint8_t* out) {
  int64_t rb = packed_row_bytes(n_samples);
  for (int64_t r = 0; r < n_rows; r++) {
    const int8_t* row = mat + r * n_samples;
    uint8_t* orow = out + r * rb;
    for (int64_t b = 0; b < rb; b++) {
      uint8_t v = 0;
      for (int k = 0; k < 4; k++) {
        int64_t i = b * 4 + k;
        uint8_t code = 3;
        if (i < n_samples) {
          int8_t g = row[i];
          code = (g >= 0 && g <= 2) ? (uint8_t)g : 3;
        }
        v |= (uint8_t)(code << (2 * k));
      }
      orow[b] = v;
    }
  }
}

void unpack_2bit(const uint8_t* packed, int64_t n_rows, int64_t n_samples,
                 int8_t* out) {
  int64_t rb = packed_row_bytes(n_samples);
  for (int64_t r = 0; r < n_rows; r++) {
    const uint8_t* prow = packed + r * rb;
    int8_t* orow = out + r * n_samples;
    for (int64_t i = 0; i < n_samples; i++) {
      uint8_t code = (uint8_t)((prow[i / 4] >> (2 * (i % 4))) & 3);
      orow[i] = code == 3 ? -1 : (int8_t)code;
    }
  }
}

}  // extern "C"
