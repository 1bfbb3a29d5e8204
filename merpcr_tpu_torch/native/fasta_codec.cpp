// Native host codec for merpcr_tpu_torch: the host-side hot loops around
// the GPU — FASTA byte filtering and 4-bit nibble packing on the way in,
// hit-line formatting on the way out — as a small C++ library loaded via
// ctypes (built by native/__init__.py; a Python fallback keeps everything
// working without it).
//
// Parity contract:
//  * fasta_filter matches the reference filter (fasta.py:60): keep bytes
//    whose uppercase is in "ACGTBDHKMNRSVWXY", preserving case.
//  * nibble_pack produces the same layout as ops/encoding.py pack_nibbles
//    (NIB_LUT codes, low nibble = even position).
//  * format_hits writes the reference's hit line (engine.py:442) byte for
//    byte: its integers as Python's str(int) writes them.

#include <cstdint>
#include <cstring>

extern "C" {

// 256-entry tables are built once on the Python side and passed in, so the
// semantics live in exactly one place (ops/encoding.py).

// Filter src[0..n) into dst keeping bytes where keep[b] != 0.
// Returns number of bytes written. dst may alias src.
int64_t mp_fasta_filter(const uint8_t* src, int64_t n, const uint8_t* keep,
                        uint8_t* dst) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t b = src[i];
    dst[w] = b;
    w += keep[b] != 0;
  }
  return w;
}

// Map src bytes through lut into 4-bit codes and pack two per byte
// (low nibble = even index). n must be even. Returns 0, or -1 if any byte
// maps to 255 (not representable; caller falls back to the byte pipeline).
int32_t mp_nibble_pack(const uint8_t* src, int64_t n, const uint8_t* lut,
                       uint8_t* dst) {
  uint8_t bad = 0;
  for (int64_t i = 0; i < n; i += 2) {
    uint8_t a = lut[src[i]];
    uint8_t b = lut[src[i + 1]];
    bad |= a | b;
    dst[i >> 1] = (uint8_t)((a & 15) | (b << 4));
  }
  return (bad & 0x80) ? -1 : 0;  // 255 has the high bit set; codes 0..15 don't
}

// Write v in decimal, as Python's str(int): a '-' and the magnitude's
// digits for a negative number (INT64_MIN included), no padding.
static inline uint8_t* put_int(uint8_t* p, int64_t v) {
  uint64_t u = v < 0 ? 0 - (uint64_t)v : (uint64_t)v;
  uint8_t digits[20];
  int n = 0;
  do {
    digits[n++] = (uint8_t)('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *p++ = '-';
  while (n) *p++ = digits[--n];
  return p;
}

// Hit lines "{label}{a}..{b}{tail}" of rows i = 0..n into dst: label
// bytes [label_off[rec[i]], label_off[rec[i] + 1]) of labels, a = pos1[i],
// b = pos2[i], tail bytes [tail_off[entry[i]], tail_off[entry[i] + 1]) of
// tails. The caller checks the indices and sizes dst for the longest
// lines: every label and tail plus 42 bytes (two 20-byte integers and
// "..") a row. Returns the number of bytes written.
int64_t mp_format_hits(const int64_t* pos1, const int64_t* pos2,
                       const int64_t* entry, const int64_t* rec, int64_t n,
                       const uint8_t* labels, const int64_t* label_off,
                       const uint8_t* tails, const int64_t* tail_off,
                       uint8_t* dst) {
  // the tails are read in the rows' order, at random in a table of ~10^5
  // entries: fetch a row's offset 16 rows ahead and its bytes 8 rows ahead,
  // so the misses overlap instead of stalling each row in turn
  const int64_t ahead = 8;
  uint8_t* p = dst;
  for (int64_t i = 0; i < n; ++i) {
    if (i + 2 * ahead < n) __builtin_prefetch(tail_off + entry[i + 2 * ahead]);
    if (i + ahead < n) __builtin_prefetch(tails + tail_off[entry[i + ahead]]);
    const int64_t l0 = label_off[rec[i]], l1 = label_off[rec[i] + 1];
    std::memcpy(p, labels + l0, (size_t)(l1 - l0));
    p += l1 - l0;
    p = put_int(p, pos1[i]);
    *p++ = '.';
    *p++ = '.';
    p = put_int(p, pos2[i]);
    const int64_t t0 = tail_off[entry[i]], t1 = tail_off[entry[i] + 1];
    std::memcpy(p, tails + t0, (size_t)(t1 - t0));
    p += t1 - t0;
  }
  return p - dst;
}

// Combined FASTA line scan: strip/concatenate sequence lines of one record
// is left in Python (cheap); the per-byte work above is the hot part.

}  // extern "C"
