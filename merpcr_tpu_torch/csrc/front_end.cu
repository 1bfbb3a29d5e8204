// front_end: the front ends of one tile, strict (K1), loose (K8, K12a) and
// raw-byte (K9a).
//
// K1 replaces merpcr_tpu/ops/scan.py::_scan_tile_impl, packed decode and
// the strict branch (scan.py:452-502, :522-578, _bit_at :252): per u32
// unit of the scan span, one bit of the strict table (qbloom_s at -N 0,
// qbloom_s1 at -N 1) keyed by window bases 7..19, an exact-width OR-smear
// for "some phase's W-mer is clean", and flag = in-bounds & clean-phase &
// (table hit | dirty key), packed LSB-first into 32-unit words; c_total
// counts the flags. K8/K12a (front_end_loose_kernel) is the loose branch
// (:579-659), K9a (front_end_raw_kernel) the unpacked one (:660-678).
//
// Bound on the card: each item (unit, stride group or raw position) reads
// its plane bytes once and makes one random lookup into a table of 0.5-32
// MB that stays L2-resident; each such 4-byte gather costs a 32-byte L2
// sector, which is what held the kernels at 8-21x their byte bounds. So
// every kernel here is one launch with no fill and no copy, counts its
// flags without a host read (the last block leaves c_total in the scan
// state, and the tile's expand hands it to the host with its own totals),
// and the loose and raw kernels first test a prefilter: a fold of their
// table to at most 2^19 bits (64 KB, ops/table.py::fold_bits), staged in
// shared memory by a grid of about one block per SM. A clear prefilter bit proves the full table's bit
// clear, so only the 0.2-3 % of items whose prefilter bit is set gather
// from the full table, in a loop over those items alone. Where the table
// has at most 2^19 bits the prefilter is the table and nothing is
// confirmed. What is left is integer work (a few tens of operations per
// item), so a warp whose plane words hold no dirty base skips the smear.

#include <algorithm>
#include <atomic>
#include <mutex>
#include <vector>

#include "compact.cuh"
#include "units.cuh"

namespace {

constexpr int kProjShift = 14;  // 2 * PROJ_UNIT_START: key starts at base 7
constexpr uint32_t kProjHi = 0xFFu;  // bases 16..19 taken from the B register
constexpr uint32_t kGold = 0x9E3779B1u;  // multiplier of the mult-hash bloom
constexpr int kUnits = 4;  // units per thread of K1 and K8 (one 16-byte load)
constexpr int kRun = 16;   // raw positions per thread of K9a (one 16-byte load)
constexpr int kMaxThreads = 1024;  // threads per block of a staged launch
constexpr int kMaxPreBits = 20;    // a staged prefilter takes at most 128 KB

// The plane words of thread t's kUnits units r0 = 4t .. 4t+3: one 16-byte
// evict-first load (the plane is read once, the table should stay in L2),
// or four loads where the plane is not 16-byte aligned; zero past the tile.
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ units, int t,
                                           int n_thr, bool vec) {
  if (t >= n_thr) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(units) + t);
  const uint32_t* u = units + kUnits * t;
  return make_uint4(__ldcs(u), __ldcs(u + 1), __ldcs(u + 2), __ldcs(u + 3));
}

// Whether thread t loads the two units past its own (r0+4, r0+5): lane 31
// and the tile's last thread, whose neighbour lane holds no such units (the
// plane holds 2 units past n_units).
__device__ __forceinline__ bool owns_past(int t, int n_thr) {
  return t < n_thr && ((threadIdx.x & 31) == 31 || t + 1 == n_thr);
}

__device__ __forceinline__ uint2 load_past(const uint32_t* __restrict__ units, int t,
                                           int n_thr) {
  if (!owns_past(t, n_thr)) return make_uint2(0u, 0u);
  return make_uint2(__ldcs(units + kUnits * t + kUnits), __ldcs(units + kUnits * t + kUnits + 1));
}

// The codes and dirty fields of the thread's units (k = 0..3) and of the
// two past them (k = 4, 5): each word decoded once, the two past it the
// next lane's first two through __shfl_down_sync, or its own `past` words.
// Every lane of the warp must call it.
__device__ __forceinline__ void decode_units(uint4 v, uint2 past, bool own_past,
                                             uint32_t c[kUnits + 2], uint32_t d[kUnits + 2]) {
  const uint32_t u[kUnits] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    c[k] = mp::codes_of(u[k]);
    d[k] = mp::dirty_of(u[k]);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    c[kUnits + k] = __shfl_down_sync(0xffffffffu, c[k], 1);
    d[kUnits + k] = __shfl_down_sync(0xffffffffu, d[k], 1);
  }
  if (own_past) {
    c[kUnits] = mp::codes_of(past.x), d[kUnits] = mp::dirty_of(past.x);
    c[kUnits + 1] = mp::codes_of(past.y), d[kUnits + 1] = mp::dirty_of(past.y);
  }
}

// The block's flag count: one 64-bit atomic per block adds the count (low
// half) and one finished block (high half) to the scan state's counter
// pair, so no fence is needed: the block that finishes last gets the other
// blocks' sum back, writes c_total and the count slot, and puts the pair
// back to 0. A pinned host word written here would hold the kernel's end
// for the PCIe write; the count slot reaches the host with the tile's
// expand totals instead. Every thread of the block calls it once.
__device__ __forceinline__ void count_flags(unsigned int cnt, int* warp_cnt,
                                            unsigned int* __restrict__ ticket,
                                            int* __restrict__ c_total) {
  const unsigned int w = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = static_cast<int>(w);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int sum = 0;
    for (int k = 0; k < (blockDim.x >> 5); ++k) sum += warp_cnt[k];
    unsigned long long* pair = reinterpret_cast<unsigned long long*>(ticket);
    const unsigned long long old = atomicAdd(pair, (1ull << 32) | sum);
    if ((old >> 32) == gridDim.x - 1) {  // every other block is done
      const int total = static_cast<int>(static_cast<unsigned int>(old) + sum);
      *c_total = total;
      ticket[mp::kFlagSlot] = static_cast<unsigned int>(total);
      *pair = 0ull;
    }
  }
}

// The prefilter's words, copied into the block's dynamic shared memory
// (coalesced 16-byte loads, then a barrier). Every thread of the block
// calls it, after it has issued its first plane load.
__device__ __forceinline__ const uint32_t* stage_prefilter(const uint32_t* __restrict__ pre,
                                                           int pre_bits, uint4* sh) {
  const int n_words = 1 << (pre_bits - 5);
  if ((n_words & 3) == 0) {
    for (int i = threadIdx.x; i < n_words / 4; i += blockDim.x)
      sh[i] = __ldg(reinterpret_cast<const uint4*>(pre) + i);
  } else {  // fewer than 4 words
    for (int i = threadIdx.x; i < n_words; i += blockDim.x)
      reinterpret_cast<uint32_t*>(sh)[i] = __ldg(pre + i);
  }
  __syncthreads();
  return reinterpret_cast<const uint32_t*>(sh);
}

__device__ __forceinline__ uint32_t bit_of(const uint32_t* tab, uint32_t i) {
  return (tab[i >> 5] >> (i & 31)) & 1u;
}

// K1: kUnits consecutive units per thread. The kUnits table gathers are
// independent and issued back to back. Eight threads make one 32-unit flag
// word, their 4-bit groups ORed together with __shfl_xor_sync.
__global__ void front_end_kernel(const uint32_t* __restrict__ units,
                                 const uint32_t* __restrict__ qbloom_s,
                                 uint32_t m2q, int W, int n_units, int n_scan,
                                 bool vec, uint32_t* __restrict__ words,
                                 unsigned int* __restrict__ ticket,
                                 int* __restrict__ c_total) {
  __shared__ int warp_cnt[32];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int n_thr = n_units / kUnits;
  const bool live = t < n_thr;
  const int r0 = kUnits * t;
  uint32_t c[kUnits + 2], d[kUnits + 2];  // codes and dirty fields per word
  decode_units(load_quad(units, t, n_thr, vec), load_past(units, t, n_thr),
               owns_past(t, n_thr), c, d);
  uint32_t bk[kUnits], tw[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const uint32_t A = c[k] | (c[k + 1] << 16), B = c[k + 2];
    bk[k] = ((A >> kProjShift) | ((B & kProjHi) << (32 - kProjShift))) & m2q;
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) tw[k] = live ? __ldg(qbloom_s + (bk[k] >> 5)) : 0u;
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const uint32_t Aa = d[k] | (d[k + 1] << 16), Ba = d[k + 2];
    const uint32_t vfull = (Aa >> kProjShift) | ((Ba & kProjHi) << (32 - kProjShift));
    const bool key_clean = (vfull & m2q) == 0;
    const bool hit = (tw[k] >> (bk[k] & 31)) & 1u;
    const uint32_t acc = mp::dirty_smear(Aa, Ba, W);
    const bool some_phase_clean = ((acc | (acc >> 1)) & 0x5555u) != 0x5555u;
    const bool in_scan = static_cast<long long>(r0 + k) * 8 < n_scan;
    bits |= static_cast<uint32_t>(live && some_phase_clean && in_scan &&
                                  (hit || !key_clean)) << k;
  }
  uint32_t word = bits << (kUnits * (lane & 7));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, o);
  // n_units is a multiple of 32: a word's 8 threads are all live or none
  if (live && (lane & 7) == 0) words[t >> 3] = word;
  count_flags(__popc(bits), warp_cnt, ticket, c_total);
}

// K8/K12a: the loose front end. Group q = P*r + p (P = 8 / kStride groups
// per unit) covers scan positions kStride*q .. kStride*q + kStride-1, and
// its window starts at base kStride*p of unit r. A thread takes kUnits
// units (G = kUnits * P groups, bits in group order), a block walks the
// tile in steps of the grid, the next step's plane words in flight while
// it works (the first step's while the prefilter is staged). Per unit: in
// a warp with a dirty base, one exact-width smear gives every phase's
// "W-mer clean"; with the scan bound, bit 2e says position 8r+e is a
// clean, in-bounds phase, and a group is valid when one of its kStride
// phases is. Per group: its key (the span value, folded to the table by
// m2q, or with kHash the mult-hash of its first 16 bases, scan.py:605-611),
// then one prefilter bit at ((index >> pre_shift) & pre_mask); where that
// bit is set, the key clean and the group valid (confirm), one gather from
// the full table, in a loop over those few groups only. flag = valid &
// (hit | dirty key), as in the JAX stage. T = 32 / G threads' bits form
// one word (JAX's parity interleave, _spread, is group order).
template <int kStride, bool kHash>
__global__ void __launch_bounds__(kMaxThreads)
front_end_loose_kernel(const uint32_t* __restrict__ units,
                       const uint32_t* __restrict__ qbloom,
                       const uint32_t* __restrict__ pre, uint32_t m2q, uint32_t m2kb,
                       int hash_bits, int pre_bits, int pre_shift, bool confirm, int W,
                       int n_units, int n_scan, bool vec, uint32_t* __restrict__ words,
                       unsigned int* __restrict__ ticket, int* __restrict__ c_total) {
  constexpr int P = 8 / kStride;       // groups per unit
  constexpr int G = kUnits * P;        // groups (flag bits) per thread
  constexpr int T = 32 / G;            // threads per flag word
  constexpr uint32_t kPhases = kStride == 4 ? 0x55u : 0x5u;  // a group's phase bits
  extern __shared__ uint4 pre_sh[];
  __shared__ int warp_cnt[32];
  const int lane = threadIdx.x & 31;
  const int n_thr = n_units / kUnits;
  const int step = gridDim.x * blockDim.x;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  uint4 v = load_quad(units, t, n_thr, vec);
  uint2 past = load_past(units, t, n_thr);
  const uint32_t* pf = stage_prefilter(pre, pre_bits, pre_sh);
  const uint32_t m_key = m2kb & m2q;  // an exact key's table index: key & m_key
  const uint32_t pre_mask = (1u << pre_bits) - 1u;
  unsigned int cnt = 0;
  for (int t0 = blockIdx.x * blockDim.x; t0 < n_thr; t0 += step, t += step) {
    const bool live = t < n_thr;
    const uint4 v_next = load_quad(units, t + step, n_thr, vec);
    const uint2 past_next = load_past(units, t + step, n_thr);
    uint32_t c[kUnits + 2], d[kUnits + 2];
    decode_units(v, past, owns_past(t, n_thr), c, d);
    const bool dirt = __any_sync(0xffffffffu, (d[0] | d[1] | d[2] | d[3] | d[4] | d[5]) != 0);
    uint32_t idx[G];  // each group's table index
    uint32_t valid = 0, dirty = 0, hit = 0;  // bit g per group
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint32_t A = c[k] | (c[k + 1] << 16), B = c[k + 2];
      const uint32_t Aa = d[k] | (d[k + 1] << 16), Ba = d[k + 2];
      const long long lim = static_cast<long long>(n_scan) - 8ll * (kUnits * t + k);
      uint32_t clean = !live || lim <= 0 ? 0u
                       : lim >= 8 ? 0x5555u : 0x5555u & ((1u << (2 * lim)) - 1u);
      if (dirt) {
        const uint32_t acc = mp::dirty_smear(Aa, Ba, W);
        clean &= ~(acc | (acc >> 1));
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int g = k * P + p, sh = 2 * kStride * p;
        const uint32_t key = sh ? __funnelshift_r(A, B, sh) : A;
        idx[g] = kHash ? ((key & m2kb) * kGold) >> (32 - hash_bits) : key & m_key;
        valid |= static_cast<uint32_t>(((clean >> sh) & kPhases) != 0) << g;
        if (dirt) {
          const uint32_t kd = (sh ? __funnelshift_r(Aa, Ba, sh) : Aa) & m2kb;
          dirty |= static_cast<uint32_t>(kd != 0) << g;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      hit |= bit_of(pf, (idx[g] >> pre_shift) & pre_mask) << g;
    if (confirm) {  // the prefilter's hits, confirmed in the full table
      uint32_t need = valid & ~dirty & hit, full = 0;
      while (need) {
        const int g = __ffs(need) - 1;
        need &= need - 1;
        uint32_t b = 0;
#pragma unroll
        for (int x = 0; x < G; ++x) b = x == g ? idx[x] : b;
        full |= ((__ldg(qbloom + (b >> 5)) >> (b & 31)) & 1u) << g;
      }
      hit = full;
    }
    const uint32_t bits = valid & (dirty | hit);
    uint32_t word = bits << (G * (lane & (T - 1)));
#pragma unroll
    for (int o = 1; o < T; o <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, o);
    // n_thr is a multiple of 8: a word's T threads are all live or none
    if (live && (lane & (T - 1)) == 0) words[(t * G) >> 5] = word;
    cnt += __popc(bits);
    v = v_next, past = past_next;
  }
  count_flags(cnt, warp_cnt, ticket, c_total);
}

// Bit j of the result is the OR of bits j .. j+n-1 of x (1 <= n <= 16):
// x smeared over 2^k bits for each binary digit k of n, high digit first.
__device__ __forceinline__ uint32_t smear_bits(uint32_t x, int n) {
  uint32_t s[5];
  s[0] = x;
#pragma unroll
  for (int k = 1; k < 5; ++k) s[k] = s[k - 1] | (s[k - 1] >> (1 << (k - 1)));
  uint32_t acc = 0;
  int got = 0;
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    if (n & (1 << k)) {
      acc |= s[k] >> got;
      got += 1 << k;
    }
  }
  return acc;
}

// Codes of 16 plane bytes: cw holds byte k's 2-bit code at bits 2k, 2k+1
// and amb bit k is set when byte k is ambiguous. lut[b] is mp::scode(b) as
// code | ambiguous << 16, so two sums of lut[b] << 2k (8 bytes each) carry
// both fields; every 1 of the ambiguity field sits at an even bit, which
// the last lines gather into 16 bits.
__device__ __forceinline__ void code16(uint4 v, const uint32_t* lut, uint32_t& cw,
                                       uint32_t& amb) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t acc[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    acc[k >> 3] += lut[__byte_perm(x[k >> 2], 0u, 0x4440u | (k & 3))] << (2 * (k & 7));
  cw = (acc[0] & 0xFFFFu) | (acc[1] << 16);
  uint32_t m = ((acc[0] >> 16) | (acc[1] & 0xFFFF0000u)) & 0x55555555u;
  m = (m | (m >> 1)) & 0x33333333u;
  m = (m | (m >> 2)) & 0x0F0F0F0Fu;
  m = (m | (m >> 4)) & 0x00FF00FFu;
  amb = (m | (m >> 8)) & 0xFFFFu;
}

// The 16 plane bytes at p: one load when the plane allows it, else byte by
// byte (n of them, the rest 0: at the tile's end only W - 1 bytes past it
// are readable).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, bool vec, int n) {
  if (vec && n == 16) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) x[k >> 2] |= static_cast<uint32_t>(p[k]) << (8 * (k & 3));
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// K9a: the raw-byte front end (scan.py:660-678, bloom_flag :445-450), for
// records with bytes outside the 16-letter alphabet. Position i is flagged
// iff i < n_scan, its W bytes hold no ambiguous byte, and the table's W-mer
// occupancy map holds bit h >> bloom_shift of their LSB-first W-mer h (a
// prefix filter once 2W passes its 24 bits). A thread takes kRun = 16
// consecutive positions: it codes its 16 bytes once (one 16-byte load, the
// next step's in flight meanwhile, and a 1 KB code table in shared memory)
// and gets the next 16 bytes' codes from the next lane (lane 31 from the
// next warp's lane 0 through shared memory; the block's last thread, and
// the tile's, code them itself). The two code words, shifted down by
// bloom_shift once, hold every position's bloom index: position j's is one
// funnel shift by 2j, masked; one smear of the ambiguity bits marks every
// window with an ambiguous byte. So each position costs one new code, where
// the W-mer needs W. The 16 prefilter bits come next, then a gather from
// the full bloom for each of the few positions whose bit is set. Two
// threads make one 32-position word.
__global__ void __launch_bounds__(kMaxThreads)
front_end_raw_kernel(const uint8_t* __restrict__ plane, const uint32_t* __restrict__ bloom,
                     const uint32_t* __restrict__ pre, int bloom_shift, int pre_bits,
                     bool confirm, int W, int n_pos, int n_scan, bool vec,
                     uint32_t* __restrict__ words, unsigned int* __restrict__ ticket,
                     int* __restrict__ c_total) {
  extern __shared__ uint4 pre_sh[];
  __shared__ uint32_t lut[256];
  __shared__ uint2 first[2][kMaxThreads / 32 + 1];  // (codes, amb) of each warp's lane 0
  __shared__ int warp_cnt[32];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    const uint32_t s = mp::scode(b);
    lut[b] = s == mp::kAmbig ? 1u << 16 : s;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_thr = n_pos / kRun;
  const int step = gridDim.x * blockDim.x;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 v = t < n_thr ? load16(plane + static_cast<long long>(kRun) * t, vec, 16) : zero;
  const uint32_t* pf = stage_prefilter(pre, pre_bits, pre_sh);  // (its barrier: lut too)
  const uint32_t pre_mask = (1u << pre_bits) - 1u;  // pre_bits <= bloom bits
  const uint32_t bloom_mask = mp::mask2w(W) >> bloom_shift;
  unsigned int cnt = 0;
  int it = 0;
  for (int t0 = blockIdx.x * blockDim.x; t0 < n_thr; t0 += step, t += step, it ^= 1) {
    const bool live = t < n_thr;
    const uint4 v_next =
        t + step < n_thr ? load16(plane + static_cast<long long>(kRun) * (t + step), vec, 16)
                         : zero;
    uint32_t cw = 0, amb = 0;
    if (live) code16(v, lut, cw, amb);
    if (lane == 0) first[it][warp] = make_uint2(cw, amb);
    uint32_t ncw = __shfl_down_sync(0xffffffffu, cw, 1);
    uint32_t namb = __shfl_down_sync(0xffffffffu, amb, 1);
    const bool own_next = live && (t + 1 == n_thr || threadIdx.x == blockDim.x - 1);
    if (own_next)  // past the tile (W - 1 readable bytes) or past the block's run
      code16(load16(plane + static_cast<long long>(kRun) * (t + 1), vec,
                    t + 1 == n_thr ? W - 1 : 16), lut, ncw, namb);
    __syncthreads();
    if (lane == 31 && !own_next) {
      const uint2 f = first[it][warp + 1];
      ncw = f.x, namb = f.y;
    }
    const long long lim = static_cast<long long>(n_scan) - static_cast<long long>(kRun) * t;
    const uint32_t in_scan = !live || lim <= 0 ? 0u : lim >= 16 ? 0xFFFFu : (1u << lim) - 1u;
    const uint32_t clean = ~smear_bits(amb | (namb << 16), W) & in_scan;
    const uint32_t lo = __funnelshift_r(cw, ncw, bloom_shift), hi = ncw >> bloom_shift;
    uint32_t hit = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      hit |= bit_of(pf, __funnelshift_r(lo, hi, 2 * j) & pre_mask) << j;
    hit &= clean;
    if (confirm) {  // the prefilter's hits, confirmed in the full bloom
      uint32_t need = hit, full = 0;
      while (need) {
        const int j = __ffs(need) - 1;
        need &= need - 1;
        const uint32_t b = __funnelshift_r(lo, hi, 2 * j) & bloom_mask;
        full |= ((__ldg(bloom + (b >> 5)) >> (b & 31)) & 1u) << j;
      }
      hit = full;
    }
    uint32_t word = hit << (16 * (lane & 1));
    word |= __shfl_xor_sync(0xffffffffu, word, 1);
    // n_thr is even: a word's two threads are both live or neither
    if (live && (lane & 1) == 0) words[t >> 1] = word;
    cnt += __popc(hit);
    v = v_next;
  }
  count_flags(cnt, warp_cnt, ticket, c_total);
}

constexpr int kMaxDevices = 64;

// The SM count of device dev, asked of the runtime once.
int sm_count(int dev) {
  static std::atomic<int> known[kMaxDevices];
  int n = dev >= 0 && dev < kMaxDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = std::max(n, 1);
    if (dev >= 0 && dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Grid of a loose or raw launch over n_thr threads' work: about one wave
// of blocks as large as the work allows; each block stages the prefilter
// (smem bytes) once and walks the tile in steps of the grid. The blocks of
// kKernel resident per SM come from the runtime on the first launch of a
// (device, block, smem) shape, which also lifts the kernel's shared-memory
// limit to kMaxPreBits' 128 KB, and are kept: a later launch of that shape
// asks the runtime only for the current device.
template <auto kKernel>
cudaError_t launch_shape(int n_thr, int smem, dim3* grid, dim3* block) {
  struct Shape {
    int dev, threads, smem, fit;
  };
  static std::mutex mu;
  static std::vector<Shape> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(dev);
  int threads = kMaxThreads;
  if (n_thr < sms * kMaxThreads)
    threads = std::max(128, ((n_thr + sms - 1) / sms + 31) / 32 * 32);
  int fit = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Shape& k : known)
      if (k.dev == dev && k.threads == threads && k.smem == smem) fit = k.fit;
    if (fit == 0) {
      e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (1 << kMaxPreBits) / 8);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kKernel, threads, smem);
      if (e != cudaSuccess) return e;
      fit = std::max(fit, 1);
      known.push_back({dev, threads, smem, fit});
    }
  }
  *block = dim3(threads);
  *grid = dim3(std::min(sms * fit, (n_thr + threads - 1) / threads));
  return cudaSuccess;
}

template <int kStride, bool kHash>
cudaError_t launch_loose(const uint32_t* units, const uint32_t* qbloom, const uint32_t* pre,
                         uint32_t m2q, uint32_t m2kb, int hash_bits, int pre_bits,
                         int pre_shift, bool confirm, int W, int n_units, int n_scan,
                         bool vec, uint32_t* words, unsigned int* ticket, int* c_total,
                         cudaStream_t stream) {
  auto kernel = front_end_loose_kernel<kStride, kHash>;
  const int smem = (1 << pre_bits) / 8;
  dim3 grid, block;
  const cudaError_t e =
      launch_shape<front_end_loose_kernel<kStride, kHash>>(n_units / kUnits, smem, &grid, &block);
  if (e != cudaSuccess) return e;
  kernel<<<grid, block, smem, stream>>>(units, qbloom, pre, m2q, m2kb, hash_bits, pre_bits,
                                        pre_shift, confirm, W, n_units, n_scan, vec, words,
                                        ticket, c_total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// units: the tile plane as uint32, offset to the first scan unit (LEAD/8),
// 16-byte aligned when vec; n_units = tile_len / 8 (a multiple of 32), with
// 2 readable units past them; words: n_units / 32 outputs; ticket: the
// device's scan-state counters (compact.cuh ScanState: the pair 0 on entry
// and on exit, the count slot written); c_total: one device int, written
// with the flag count.
int mp_front_end(const void* units, const void* qbloom_s, int gq, int W,
                 int n_units, int n_scan, int vec, void* words, void* ticket,
                 void* c_total, void* stream) {
  const uint32_t m2q = gq >= 32 ? 0xFFFFFFFFu : ((1u << gq) - 1u);
  const int n_thr = n_units / kUnits;
  front_end_kernel<<<mp::n_blocks(n_thr), mp::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units),
      static_cast<const uint32_t*>(qbloom_s), m2q, W, n_units, n_scan, vec != 0,
      static_cast<uint32_t*>(words), static_cast<unsigned int*>(ticket),
      static_cast<int*>(c_total));
  return static_cast<int>(cudaGetLastError());
}

// K8/K12a. units, vec, ticket and c_total as above; q_bits: log2 bits of
// the group table qbloom; hash_bits: 0 for an exact span table, else
// q_bits of the mult-hash bloom; stride: 4 or 2 scan positions per group;
// n_groups = tile_len / stride; pre: the prefilter of 2^pre_bits bits
// (5 <= pre_bits <= 20; qbloom itself when pre_bits == q_bits, then no
// gather confirms it), indexed by (key >> pre_shift) & (2^pre_bits - 1) and
// staged in shared memory; words: n_groups / 32 outputs in group order.
int mp_front_end_loose(const void* units, const void* qbloom, int q_bits,
                       int hash_bits, int W, int stride, int n_groups,
                       int n_scan, int vec, const void* pre, int pre_bits,
                       int pre_shift, void* words, void* ticket,
                       void* c_total, void* stream) {
  const uint32_t m2q = q_bits >= 32 ? 0xFFFFFFFFu : ((1u << q_bits) - 1u);
  // key bases: the whole span of an exact table, at most 16 of a hashed one
  const uint32_t m2kb = mp::mask2w(W + stride - 1);
  const bool confirm = pre_bits < q_bits;
  const int n_units = n_groups * stride / 8;
  // one instantiation per stride and key kind
  using Launch = cudaError_t (*)(const uint32_t*, const uint32_t*, const uint32_t*, uint32_t,
                                 uint32_t, int, int, int, bool, int, int, int, bool,
                                 uint32_t*, unsigned int*, int*, cudaStream_t);
  const Launch launches[2][2] = {{launch_loose<4, false>, launch_loose<4, true>},
                                 {launch_loose<2, false>, launch_loose<2, true>}};
  const cudaError_t e = launches[stride == 2][hash_bits != 0](
      static_cast<const uint32_t*>(units), static_cast<const uint32_t*>(qbloom),
      static_cast<const uint32_t*>(pre), m2q, m2kb, hash_bits, pre_bits, pre_shift, confirm, W,
      n_units, n_scan, vec != 0, static_cast<uint32_t*>(words),
      static_cast<unsigned int*>(ticket), static_cast<int*>(c_total),
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// K9a. plane: the raw tile plane, one byte per position, offset to the first
// scan position (lead), 16-byte aligned when vec; n_pos = tile_len (a
// multiple of 256), with W - 1 readable bytes past it; bloom: 2^(2W -
// bloom_shift) bits; pre, pre_bits: its prefilter as above (the low
// pre_bits bits of the bloom index); words: n_pos / 32 outputs; ticket and
// c_total as above.
int mp_front_end_raw(const void* plane, const void* bloom, int bloom_shift,
                     int W, int n_pos, int n_scan, int vec, const void* pre,
                     int pre_bits, void* words, void* ticket,
                     void* c_total, void* stream) {
  const int smem = (1 << pre_bits) / 8;
  dim3 grid, block;
  cudaError_t e = launch_shape<front_end_raw_kernel>(n_pos / kRun, smem, &grid, &block);
  if (e != cudaSuccess) return static_cast<int>(e);
  front_end_raw_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const uint32_t*>(bloom),
      static_cast<const uint32_t*>(pre), bloom_shift, pre_bits,
      pre_bits < 2 * W - bloom_shift, W, n_pos, n_scan, vec != 0,
      static_cast<uint32_t*>(words), static_cast<unsigned int*>(ticket),
      static_cast<int*>(c_total));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
