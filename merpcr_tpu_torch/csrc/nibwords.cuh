// Word-wide primer compare on a packed nibble plane, shared by the
// verify_p1 (primer 1) and margin_p2 (primer 2) kernels.
//
// At -I 0 a genome base matches a primer base when their 4-bit codes are
// equal (merpcr_tpu/ops/scan.py:1020-1025, :1138-1146). The compare takes
// 16 bases per step, as the JAX stage's 16-byte row gathers do: the plane
// as little-endian 64-bit words of nibbles counted from the 8-byte boundary
// at or below the plane, the window funnel-shifted out of two words, XOR
// the primer codes packed the same way from 8-byte loads of the primer row
// (a code >= 16 sets a bit of its own word: it equals no genome nibble), an
// OR-fold to one bit per mismatching nibble, and __popcll under the length
// mask. The positions outside the plane mismatch, and a protected stretch
// of the primer admits no mismatch: both are masks over the same nibbles.
// tests/test_torch_verify_words.py and tests/test_torch_margin_words.py
// model this arithmetic in numpy.
#pragma once

#include <cstdint>

namespace mp {

constexpr uint64_t kNibOnes = 0x1111111111111111ull;  // bit 0 of each nibble

// Bit 0 of nibbles a .. b-1 (clamped to 0 .. 16).
__device__ __forceinline__ uint64_t nib_range(long long a, long long b) {
  const auto below = [](long long n) -> uint64_t {
    if (n <= 0) return 0ull;
    return n >= 16 ? kNibOnes : kNibOnes & ((1ull << (4 * n)) - 1ull);
  };
  return below(b) & ~below(a);
}

// The low nibbles of 8 bytes packed into 32 bits (byte k -> nibble k).
__device__ __forceinline__ uint64_t pack_nibbles(uint64_t bytes) {
  uint64_t v = bytes & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v >> 4)) & 0x00FF00FF00FF00FFull;
  v = (v | (v >> 8)) & 0x0000FFFF0000FFFFull;
  return (v | (v >> 16)) & 0x00000000FFFFFFFFull;
}

// Primer bases 16c .. 16c+15 of row pc (p_max bytes, 8-byte aligned) as
// (code & 15 nibbles, code >> 4 nibbles): a code >= 16 (U, or no letter)
// equals no genome nibble. Bytes past the row read as 0.
__device__ __forceinline__ void primer_word(const uint8_t* pc, int c, int p_max,
                                            uint64_t* lo, uint64_t* hi) {
  const unsigned long long* row = reinterpret_cast<const unsigned long long*>(pc);
  const uint64_t b0 = __ldg(row + 2 * c);
  const uint64_t b1 = 16 * c + 8 < p_max ? __ldg(row + 2 * c + 1) : 0ull;
  *lo = pack_nibbles(b0) | (pack_nibbles(b1) << 32);
  *hi = pack_nibbles(b0 >> 4) | (pack_nibbles(b1 >> 4) << 32);
}

// floor(a / 16) for a of either sign.
__device__ __forceinline__ long long floor16(long long a) {
  return a >= 0 ? a >> 4 : -((15 - a) >> 4);
}

// Does the window of l bases at tile position s match primer row pc within
// nmm mismatches, with none among primer bases pa .. pb-1? word(q) is the
// plane's 64-bit word q counted from the 8-byte boundary `mis` bytes below
// the plane (0 past the plane's words); n_pos positions are in the plane.
template <class Word>
__device__ __forceinline__ bool window_words_ok(const Word& word, int mis,
                                                long long n_pos, long long s,
                                                int l, const uint8_t* pc,
                                                int p_max, int pa, int pb,
                                                int nmm) {
  int mism = 0;
  for (int c = 0; 16 * c < l; ++c) {
    const long long sc = s + 16 * c;  // tile position of nibble 0
    const long long a = sc + 2 * mis;  // ... in the aligned words
    const long long q = floor16(a);
    const int r = static_cast<int>(a - 16 * q);
    const uint64_t w0 = word(q);
    const uint64_t g = r ? (w0 >> (4 * r)) | (word(q + 1) << (64 - 4 * r)) : w0;
    uint64_t p_lo, p_hi;
    primer_word(pc, c, p_max, &p_lo, &p_hi);
    uint64_t x = (g ^ p_lo) | p_hi;  // nonzero nibble: mismatch
    x |= x >> 2;
    x |= x >> 1;
    const uint64_t out = kNibOnes & ~nib_range(-sc, n_pos - sc);  // off the plane
    const uint64_t mm = ((x & kNibOnes) | out) & nib_range(0, l - 16 * c);
    if (mm & nib_range(pa - 16 * c, pb - 16 * c)) return false;  // protected
    mism += __popcll(mm);
    if (mism > nmm) return false;
  }
  return true;
}

}  // namespace mp
