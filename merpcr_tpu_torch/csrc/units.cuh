// u32-unit decode shared by the front_end and expand kernels.
//
// The packed genome plane holds one 4-bit letter code per base, two per
// byte, low nibble first; a little-endian uint32 "unit" therefore holds
// 8 bases, base k in nibble k. Codes 0-3 are A, C, G, T (the 2-bit hash
// codes); codes >= 4 are ambiguity letters ("dirty" bases). Every value is
// LSB-first: base j of a register sits at bits [2j, 2j+2), as in the table
// compiler's bucket keys.
#pragma once

#include <cstdint>

namespace mp {

// The 8 low 2-bit fields of a unit's nibbles, packed into 16 bits.
__device__ __forceinline__ uint32_t codes_of(uint32_t u) {
  uint32_t m = u & 0x33333333u;
  m = (m | (m >> 2)) & 0x0F0F0F0Fu;
  m = (m | (m >> 4)) & 0x00FF00FFu;
  return (m | (m >> 8)) & 0x0000FFFFu;
}

// Per-base 2-bit field that is nonzero iff the base's nibble is >= 4.
__device__ __forceinline__ uint32_t dirty_of(uint32_t u) {
  return codes_of(u >> 2);
}

// Registers of the 24-base window that starts at unit r: A = bases 0..15,
// B = bases 16..23, and the matching dirty fields.
struct UnitRegs {
  uint32_t A, Aa, B, Ba;
};

__device__ __forceinline__ UnitRegs load_unit(const uint32_t* __restrict__ units,
                                              int r) {
  const uint32_t u0 = units[r], u1 = units[r + 1], u2 = units[r + 2];
  UnitRegs g;
  g.A = codes_of(u0) | (codes_of(u1) << 16);
  g.Aa = dirty_of(u0) | (dirty_of(u1) << 16);
  g.B = codes_of(u2);
  g.Ba = dirty_of(u2);
  return g;
}

// Registers of stride group q = P*r + p (P = 8 / stride groups per unit),
// whose window starts at base stride*p of unit r (scan.py:581-588,
// :783-795): the unit's registers shifted right by that many bases. A shift
// by 32 is undefined in C++, so p = 0 takes its own branch.
__device__ __forceinline__ UnitRegs load_group(const uint32_t* __restrict__ units,
                                               int q, int stride) {
  const int per_unit = 8 / stride;
  const UnitRegs g = load_unit(units, q / per_unit);
  const int sh = 2 * stride * (q % per_unit);
  if (sh == 0) return g;
  return {(g.A >> sh) | (g.B << (32 - sh)), (g.Aa >> sh) | (g.Ba << (32 - sh)),
          g.B >> sh, g.Ba >> sh};
}

// Mask of the low n bases (2 bits each) of a register; 16 bases fill it,
// and 1u << 32 is undefined in C++.
__device__ __host__ __forceinline__ uint32_t mask2w(int n) {
  return n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
}

// Bases d .. d+n-1 (n <= 16) of the window whose bases 0..15 are lo and
// 16..23 are hi (d in 0..7): a phase's W-mer, or its dirty field.
__device__ __forceinline__ uint32_t window_bases(uint32_t lo, uint32_t hi,
                                                 int d, int n) {
  uint32_t v = lo >> (2 * d);
  if (d > 0 && 2 * (d + n) > 32) v |= hi << (32 - 2 * d);
  return v & mask2w(n);
}

// Bases d .. d+15 of the window (d in 0..7). A shift by 32 is undefined in
// C++, so phase 0 takes its own branch.
__device__ __forceinline__ uint32_t window16(uint32_t lo, uint32_t hi, int d) {
  return d == 0 ? lo : (lo >> (2 * d)) | (hi << (32 - 2 * d));
}

// Raw-byte planes (records outside the 16-letter alphabet) hold one byte per
// position. kAmbig is the code of every byte that is no A/C/G/T/U, in
// either case (encoding.SCODE, scan.py:270-284, without a table); it is the
// only code with a bit above the low two.
constexpr uint32_t kAmbig = 100u;

// Branch-free, so that a warp over mixed bases does not diverge: a letter's
// low five bits are 1 (A), 3 (C), 7 (G), 20 (T) or 21 (U) in either case;
// kBases marks those five, kCodes holds their 2-bit codes at bits 2 * low5.
constexpr uint32_t kBases = (1u << 1) | (1u << 3) | (1u << 7) | (1u << 20) | (1u << 21);
constexpr uint64_t kCodes = (1ull << 6) | (2ull << 14) | (3ull << 40) | (3ull << 42);

__device__ __forceinline__ uint32_t scode(uint32_t b) {
  const uint32_t low5 = b & 0x1Fu;
  const bool letter = (b | 32u) - 'a' <= 'z' - 'a';  // ASCII letters only
  const bool base = (kBases >> low5) & 1u;
  return letter && base ? static_cast<uint32_t>(kCodes >> (2 * low5)) & 3u : kAmbig;
}

// The LSB-first W-mer of the W bytes at p (base k at bits 2k, 2k+1; all 32
// bits at W = 16), or false when one of them is ambiguous (scan.py:661-669).
__device__ __forceinline__ bool raw_hash(const uint8_t* __restrict__ p, int W,
                                         uint32_t* h) {
  uint32_t v = 0;
  for (int k = 0; k < W; ++k) {
    const uint32_t c = scode(p[k]);
    if (c == kAmbig) return false;
    v |= c << (2 * k);
  }
  *h = v;
  return true;
}

// Exact-width OR-smear of the dirty fields: field d of the result is
// nonzero iff window d .. d+W-1 holds a dirty base. sm[k] smears over 2^k
// bases; W is assembled from its binary digits, high first.
__device__ __forceinline__ uint32_t dirty_smear(uint32_t Aa, uint32_t Ba,
                                                int W) {
  uint32_t lo[5], hi[5];
  lo[0] = Aa;
  hi[0] = Ba;
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    const int s = 1 << k;  // bits = 2 * (2^(k-1)) bases
    lo[k] = lo[k - 1] | ((lo[k - 1] >> s) | (hi[k - 1] << (32 - s)));
    hi[k] = hi[k - 1] | (hi[k - 1] >> s);
  }
  uint32_t acc = 0;
  int got = 0;
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    if (W & (1 << k)) {
      const int s = 2 * got;
      acc |= s == 0 ? lo[k] : ((lo[k] >> s) | (hi[k] << (32 - s)));
      got += 1 << k;
    }
  }
  return acc;
}

}  // namespace mp
