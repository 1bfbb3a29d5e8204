// front_end: the front ends of one tile, strict (K1), loose (K8) and
// raw-byte (K9a, front_end_raw_kernel below).
//
// K1 replaces merpcr_tpu/ops/scan.py::_scan_tile_impl, packed decode and
// the strict branch (scan.py:452-502, :522-578, _bit_at :252): per u32
// unit of the scan span, one bit of the strict table (qbloom_s at -N 0,
// qbloom_s1 at -N 1) keyed by window bases 7..19, an exact-width OR-smear
// for "some phase's W-mer is clean", and flag = in-bounds & clean-phase &
// (table hit | dirty key), packed LSB-first into 32-unit words; c_total
// counts the flags. K8 (front_end_loose_kernel below) is the loose branch.
//
// Bound on the card: memory and launch latency. Each unit reads its 4 plane
// bytes and makes one random 4-byte gather into an 8 MB table that stays
// L2-resident; the arithmetic is ~60 integer ops per unit. The strict
// kernel is the whole call (no fill, no copy): a thread takes 4 units with
// one 16-byte load, decodes each plane word once and has its 4 gathers in
// flight together; the last block leaves c_total in a device slot that the
// tile's expand hands to the host with its own totals. The loose kernel
// (one thread per group, its own fill of c_total) makes one gather per
// group (two or four per unit) into an 8-32 MB group table. The raw kernel
// reads one byte per position, codes it once into shared memory and builds
// each position's W-mer from W codes there (~3W integer ops per position; a
// rolling W-mer would need ~14), and makes one random 4-byte gather into
// the bloom per clean window. Its bound is the ~1.2 bytes per position it
// moves, not its arithmetic.

#include "compact.cuh"
#include "units.cuh"

namespace {

constexpr int kProjShift = 14;  // 2 * PROJ_UNIT_START: key starts at base 7
constexpr uint32_t kProjHi = 0xFFu;  // bases 16..19 taken from the B register
constexpr uint32_t kGold = 0x9E3779B1u;  // multiplier of the mult-hash bloom

// K1: kUnits consecutive units per thread. The thread's plane words come in
// one 16-byte evict-first load (the plane is read once, the table should
// stay in L2), each decoded once; the two words past them are the next
// lane's first two, decoded, through __shfl_down_sync (lane 31 and the
// last thread load their own). The kUnits table gathers are independent and
// issued back to back. Eight threads make one 32-unit flag word, their
// 4-bit groups ORed together with __shfl_xor_sync. Flags are counted per
// block, and one 64-bit atomic per block adds the count (low half) and
// one finished block (high half) to the scan state's counter pair, so no
// fence is needed: the block that finishes last gets the other blocks'
// sum back, writes c_total and the count slot, and puts the pair back to
// 0. A pinned host word written here would hold the kernel's end for the
// PCIe write; the count slot reaches the host with the tile's expand
// totals instead.
constexpr int kUnits = 4;

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
  uint32_t u[kUnits] = {0u, 0u, 0u, 0u};
  if (live) {
    if (vec) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(units) + t);
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) u[k] = __ldcs(units + r0 + k);
    }
  }
  uint32_t c[kUnits + 2], d[kUnits + 2];  // codes and dirty fields per word
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
  if (live && (lane == 31 || t + 1 == n_thr)) {
    // units r0+4, r0+5 lie in the plane: it holds 2 units past n_units
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t x = __ldcs(units + r0 + kUnits + k);
      c[kUnits + k] = mp::codes_of(x);
      d[kUnits + k] = mp::dirty_of(x);
    }
  }
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
  const int cnt = __reduce_add_sync(0xffffffffu, __popc(bits));
  if (lane == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int sum = 0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) sum += warp_cnt[w];
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

// K8: the loose front end (scan.py:579-659). One thread per stride group
// q = P*r + p (scan positions stride*q .. stride*q + stride-1; stride 4 at
// W <= 11, 2 above). The JAX stage builds one flag word per parity and
// bit-interleaves them into group order (_spread, :623-659), which suits
// the TPU's lanes; here consecutive threads are consecutive groups, so
// __ballot_sync gives the group-ordered word directly. The P threads of a
// unit share its plane words (L1 hits). The key of an exact group table is
// the group's span value, folded to the table's size (m2q); with hash_bits
// != 0 the table is the mult-hash bloom of the wide words (:605-611), keyed
// by the first m2kb bases of the span.
__global__ void front_end_loose_kernel(const uint32_t* __restrict__ units,
                                       const uint32_t* __restrict__ qbloom,
                                       uint32_t m2q, uint32_t m2kb,
                                       int hash_bits, int W, int stride,
                                       int n_groups, int n_scan,
                                       uint32_t* __restrict__ words,
                                       int* __restrict__ c_total) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  bool flag = false;
  if (q < n_groups) {
    const mp::UnitRegs g = mp::load_group(units, q, stride);
    bool some_phase_clean = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (d >= stride) break;
      const uint32_t va = mp::window_bases(g.Aa, g.Ba, d, W);
      some_phase_clean |= va == 0 && static_cast<long long>(stride) * q + d < n_scan;
    }
    const uint32_t key = g.A & m2kb;
    const uint32_t bk = hash_bits ? (key * kGold) >> (32 - hash_bits) : key & m2q;
    const bool hit = (__ldg(qbloom + (bk >> 5)) >> (bk & 31)) & 1u;
    const bool span_clean = (g.Aa & m2kb) == 0;
    flag = some_phase_clean && (hit || !span_clean);
  }
  const unsigned word = __ballot_sync(0xffffffffu, flag);
  // n_groups is a multiple of 32, so a warp is wholly inside or outside
  if ((threadIdx.x & 31) == 0 && q < n_groups) {
    words[q >> 5] = word;
    if (word) atomicAdd(c_total, __popc(word));
  }
}

// K9a: the raw-byte front end (scan.py:660-678, bloom_flag :445-450), for
// records with bytes outside the 16-letter alphabet. One thread per scan
// position i: the LSB-first W-mer of bytes i .. i+W-1 (any ambiguous byte
// clears the flag), i < n_scan, and one bit of the table's W-mer occupancy
// map at h >> (2W - bloom_bits), a prefix filter once 2W passes its 24 bits.
// A block codes its kBlock + W - 1 bytes once (coalesced byte loads, the
// branch-free mp::scode) into shared memory; each thread then reads its W
// codes there (neighbouring threads share 4-byte words: no bank conflict).
// A warp is 32 consecutive positions, so __ballot_sync gives the flag word
// with bit i = position 32w + i; one random 4-byte gather into the <= 2 MB
// bloom (L2-resident) per clean window.
__global__ void front_end_raw_kernel(const uint8_t* __restrict__ plane,
                                     const uint32_t* __restrict__ bloom,
                                     int bloom_shift, int W, int n_pos,
                                     int n_scan, uint32_t* __restrict__ words,
                                     int* __restrict__ c_total) {
  __shared__ uint8_t codes[mp::kBlock + 16];
  const int base = blockIdx.x * mp::kBlock;
  const int i = base + threadIdx.x;
  // n_pos is a multiple of kBlock and W - 1 bytes past it are readable
  codes[threadIdx.x] = mp::scode(plane[i]);
  if (threadIdx.x < W - 1)
    codes[mp::kBlock + threadIdx.x] = mp::scode(plane[base + mp::kBlock + threadIdx.x]);
  __syncthreads();
  uint32_t h = 0, any = 0;
  for (int k = 0; k < W; ++k) {
    const uint32_t c = codes[threadIdx.x + k];
    h |= (c & 3u) << (2 * k);
    any |= c;
  }
  bool flag = false;
  if (i < n_scan && !(any & ~3u)) {  // only kAmbig has a bit above the low two
    const uint32_t bk = h >> bloom_shift;
    flag = (__ldg(bloom + (bk >> 5)) >> (bk & 31u)) & 1u;
  }
  const unsigned word = __ballot_sync(0xffffffffu, flag);
  if ((threadIdx.x & 31) == 0) {
    words[i >> 5] = word;
    if (word) atomicAdd(c_total, __popc(word));
  }
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

// K8. units as above; q_bits: log2 bits of the group table qbloom;
// hash_bits: 0 for an exact span table, else q_bits of the mult-hash bloom;
// stride: 4 or 2 scan positions per group; n_groups = tile_len / stride (a
// multiple of 32); words: n_groups / 32 outputs in group order; c_total:
// one int, zeroed by the caller.
int mp_front_end_loose(const void* units, const void* qbloom, int q_bits,
                       int hash_bits, int W, int stride, int n_groups,
                       int n_scan, void* words, void* c_total, void* stream) {
  const uint32_t m2q = q_bits >= 32 ? 0xFFFFFFFFu : ((1u << q_bits) - 1u);
  // key bases: the whole span of an exact table, at most 16 of a hashed one
  const uint32_t m2kb = mp::mask2w(W + stride - 1);
  front_end_loose_kernel<<<mp::n_blocks(n_groups), mp::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), static_cast<const uint32_t*>(qbloom),
      m2q, m2kb, hash_bits, W, stride, n_groups, n_scan,
      static_cast<uint32_t*>(words), static_cast<int*>(c_total));
  return static_cast<int>(cudaGetLastError());
}

// K9a. plane: the raw tile plane, one byte per position, offset to the first
// scan position (lead); n_pos = tile_len (a multiple of 256), with W - 1
// readable bytes past it; bloom: 2^(2W - bloom_shift) bits; words: n_pos / 32
// outputs; c_total: one int, zeroed by the caller.
int mp_front_end_raw(const void* plane, const void* bloom, int bloom_shift,
                     int W, int n_pos, int n_scan, void* words, void* c_total,
                     void* stream) {
  front_end_raw_kernel<<<mp::n_blocks(n_pos), mp::kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), static_cast<const uint32_t*>(bloom),
      bloom_shift, W, n_pos, n_scan, static_cast<uint32_t*>(words),
      static_cast<int*>(c_total));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
