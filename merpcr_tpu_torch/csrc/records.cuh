// Record lookup (K14) and base matching (K11, K9) shared by the verify_p1 and
// margin_p2 kernels.
//
// A tile plane holds one record or, on the stream path, many records laid
// end to end with 8-aligned starts and gaps of 0xFF bytes between them
// (merpcr_tpu/engine.py::_stream_layout). rmeta[r] = (start, length) of
// record r in plane coordinates; recmap[b] = the record that owns the
// 8-position block b. Without a recmap the plane holds record 0 alone
// (the single-record scan: rmeta = [(0, record length)]).
//
// Bases match as in merpcr_tpu/ops/scan.py:1020-1025 and :1138-1146: at
// -I 0 the genome's 4-bit code equals the primer's code; at -I 1 the
// genome letter's IUPAC expansion set meets the primer letter's
// (EXP_NIB[nibble] & p_exp[entry][i]) != 0. On a raw-byte plane (K9) the
// genome byte meets the primer byte: case-insensitive equality at -I 0
// (scan.py:1031), the reference's 256 x 256 match table at -I 1 (:1029).
#pragma once

#include <cstdint>

#include "compact.cuh"

namespace mp {

// IUPAC expansion masks of the 16 genome letters "ACGTBDHKMNRSVWXY":
// merpcr_tpu_torch/ops/encoding.py::iupac_exp_masks()[0] (a CPU test holds
// the two equal).
__constant__ uint32_t kExpNib[16] = {
    0x1u,    0x4u,    0x10u,   0x1800u, 0x9c56u, 0x5a59u, 0xd8a5u, 0x1850u,
    0x85u,   0xffffu, 0x211u,  0x414u,  0x2695u, 0x5801u, 0x10000u, 0x9804u,
};

struct Records {
  const int* rmeta;  // [R, 2]: (start, length) in plane coordinates
  const int* recmap;  // [n_map]: 8-position block -> record; null: record 0
  long long n_map;
};

struct RecordSpan {
  int id;
  long long start, len;
};

// The record that owns stream position gpos (scan.py:993-1005).
__device__ __forceinline__ RecordSpan record_at(const Records& r,
                                                long long gpos) {
  int id = 0;
  if (r.recmap) {
    long long b = gpos >> 3;
    b = b < 0 ? 0 : (b >= r.n_map ? r.n_map - 1 : b);
    id = r.recmap[b];
  }
  return RecordSpan{id, r.rmeta[2LL * id], r.rmeta[2LL * id + 1]};
}

// Does genome code `nib` (0xFF outside the plane) match primer base i?
// `exp_row` null: -I 0 code equality against `code_row`.
__device__ __forceinline__ bool base_match(uint32_t nib, int i,
                                           const uint8_t* code_row,
                                           const uint32_t* exp_row) {
  if (exp_row) return nib < 16u && (kExpNib[nib] & exp_row[i]) != 0u;
  return nib == code_row[i];
}

// Raw-byte planes (K9): byte p of a plane of n_pos bytes, or -1 outside it.
// -1 equals no byte; 0xFF would not do, it is a real byte (latin-1 y-umlaut).
__device__ __forceinline__ int byte_at(const uint8_t* __restrict__ plane,
                                       long long p, long long n_pos) {
  return (p < 0 || p >= n_pos) ? -1 : static_cast<int>(plane[p]);
}

// ASCII a..z -> A..Z, every other byte unchanged (_byte_fold, scan.py:263).
__device__ __forceinline__ int fold(int b) {
  return (b >= 'a' && b <= 'z') ? b - 32 : b;
}

// Does genome byte s (-1 outside the plane) match primer byte p? `match`
// null: -I 0, case-insensitive equality (scan.py:1031); else the reference's
// 256 x 256 table match[s * 256 + p] (-I 1, :1029).
__device__ __forceinline__ bool byte_match(int s, int p,
                                           const uint8_t* __restrict__ match) {
  if (s < 0) return false;
  return match ? match[s * 256 + p] != 0 : fold(s) == fold(p);
}

// Genome position p against primer base i: a byte of a raw plane (`raw`,
// the primer row holds bytes) or a nibble of a packed one (the row holds
// codes, exp_row the -I 1 masks).
__device__ __forceinline__ bool site_match(const uint8_t* __restrict__ plane,
                                           long long p, long long n_pos,
                                           bool raw, int i,
                                           const uint8_t* row,
                                           const uint32_t* exp_row,
                                           const uint8_t* match) {
  if (raw) return byte_match(byte_at(plane, p, n_pos), row[i], match);
  return base_match(nibble_at(plane, p, n_pos), i, row, exp_row);
}

}  // namespace mp
