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
// Bound on the card: memory. Each unit reads its 4 plane bytes (the two
// neighbour units come from L1/L2) and makes one random 4-byte gather into
// an 8 MB table that stays L2-resident; the arithmetic is ~60 integer ops
// per unit. One thread per unit keeps neighbouring threads on neighbouring
// plane words (coalesced), __ballot_sync builds each flag word in
// registers, and c_total costs one atomicAdd per warp, not per flag. The
// loose kernel makes one gather per group (two or four per unit) into an
// 8-32 MB group table. The raw kernel reads one byte per position, codes
// it once into shared memory and builds each position's W-mer from W codes
// there (~3W integer ops per position; a rolling W-mer would need ~14), and
// makes one random 4-byte gather into the bloom per clean window. Its bound
// is the ~1.2 bytes per position it moves, not its arithmetic.

#include "compact.cuh"
#include "units.cuh"

namespace {

constexpr int kProjShift = 14;  // 2 * PROJ_UNIT_START: key starts at base 7
constexpr uint32_t kProjHi = 0xFFu;  // bases 16..19 taken from the B register
constexpr uint32_t kGold = 0x9E3779B1u;  // multiplier of the mult-hash bloom

__global__ void front_end_kernel(const uint32_t* __restrict__ units,
                                 const uint32_t* __restrict__ qbloom_s,
                                 uint32_t m2q, int W, int n_units, int n_scan,
                                 uint32_t* __restrict__ words,
                                 int* __restrict__ c_total) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool flag = false;
  if (r < n_units) {
    const mp::UnitRegs g = mp::load_unit(units, r);
    const uint32_t kfull = (g.A >> kProjShift) | ((g.B & kProjHi) << (32 - kProjShift));
    const uint32_t vfull = (g.Aa >> kProjShift) | ((g.Ba & kProjHi) << (32 - kProjShift));
    const uint32_t bk = kfull & m2q;
    const bool key_clean = (vfull & m2q) == 0;
    const bool hit = (__ldg(qbloom_s + (bk >> 5)) >> (bk & 31)) & 1u;
    const uint32_t acc = mp::dirty_smear(g.Aa, g.Ba, W);
    const uint32_t dirty2 = (acc | (acc >> 1)) & 0x5555u;
    const bool some_phase_clean = dirty2 != 0x5555u;
    const bool in_scan = static_cast<long long>(r) * 8 < n_scan;
    flag = some_phase_clean && in_scan && (hit || !key_clean);
  }
  const unsigned word = __ballot_sync(0xffffffffu, flag);
  // n_units is a multiple of 32, so a warp is wholly inside or outside
  if ((threadIdx.x & 31) == 0 && r < n_units) {
    words[r >> 5] = word;
    if (word) atomicAdd(c_total, __popc(word));
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

// units: the tile plane as uint32, offset to the first scan unit (LEAD/8);
// n_units = tile_len / 8 (a multiple of 32); words: n_units / 32 outputs;
// c_total: one int, zeroed by the caller.
int mp_front_end(const void* units, const void* qbloom_s, int gq, int W,
                 int n_units, int n_scan, void* words, void* c_total,
                 void* stream) {
  const uint32_t m2q = gq >= 32 ? 0xFFFFFFFFu : ((1u << gq) - 1u);
  front_end_kernel<<<mp::n_blocks(n_units), mp::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units),
      static_cast<const uint32_t*>(qbloom_s), m2q, W, n_units, n_scan,
      static_cast<uint32_t*>(words), static_cast<int*>(c_total));
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
