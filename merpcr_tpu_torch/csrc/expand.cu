// expand: flagged units or stride groups -> (entry, position) candidate
// pairs of one tile.
//
// Replaces merpcr_tpu/ops/scan.py::_scan_tile_impl stages K2-K5: the
// flag-word compaction (scan.py:680-719, _rank_invert :317-341,
// _blocked_scan :287-314), the phase expansion (:757-927), the hashed
// 16-base position filter t16 (:929-949) and the CSR pair expansion
// (exact_csr :721-741, :953-964); and K10, the dirty-span phase filter
// (dirty_bloom, :803-822): with a bloom table, a phase of a unit whose
// group span is dirty survives only if its W-mer is a key of the table's
// occupancy bitmap (its top 24 bits at W >= 13). At -N 1 the strict1
// variant runs this code with t16_1 in place of t16.
//
// The word size picks the tables (K12; table.py:567-574). Phase bits
// (ptab_bits, :832-871): with an exact group table a clean span trusts the
// folded phase table ptab, `stride` bits per span value, 4 at W <= 11 and
// 2 at W = 12, 13 (four groups per unit); at W >= 14 there is no ptab and
// every valid phase expands (:872-875), pruned by the bloom when K10 is
// armed. Bucket lookup (Csr below): one (start, count) row of bsc at
// W <= 11, the pair bstart[h], bstart[h+1] at W = 12, a binary search of
// the sorted unique keys uhash and then ustart at W >= 13.
//
// The loose mode (mode 1) is the loose branch of the same stages
// (scan.py:775-795, :863-875), behind the K8 front end: an item is a
// stride group q = P*r + p (in the group order of the front end's words), whose registers are unit r's shifted right by
// stride*p bases; `stride` phases at scan positions stride*q + d; a clean
// span keeps ptab's phase bits within the valid ones, a dirty span (or any
// span without a ptab) all valid phases; no t16 and no bloom.
//
// The raw mode (mode 2, K9b) is the unpacked branch (scan.py:680-719,
// :965-977) behind the raw-byte front end (K9a): an item is a flag word of a
// plane with one byte per position (32 positions, bit d = position 32w +
// d), each set bit its own lane; a lane hashes its W bytes and expands its
// one bucket. There is no position stage there, so pos_total
// stays 0 as in the JAX totals.
//
// Pairs come out in (item, phase, bucket slot) order, so pair j here is
// the JAX pipeline's pair j: the order is the emission key pair_order.
// pos_total counts phase bits before the t16 filter, pair_total bucket
// slots after it, as the JAX totals do.
//
// Bound on the card: launch latency and chains of dependent gathers, not
// bytes. Only flagged items (a few per 10^4 units on a clean genome, a
// third of them on a dirty or raw one) gather from ptab, the K10 bloom,
// t16 and the CSR, and a bucket lookup is a row gather, two gathers, or
// ~log2(U) dependent gathers of the binary search. So the design does
// each lookup once, spreads the chains over threads, and makes one launch
// per call (expand_kernel): a block takes a tile of 64 to 256 flag words
// (about 256 tiles per call), lists its items in order in shared memory, works out each
// item's phase bits on a thread of its own, writes one lane per (item,
// phase), looks each lane up on a thread of its own (the phases of one
// item side by side), and takes its pair base from a single-pass look-back
// scan (compact.cuh); it writes its pairs into the caller's buffers of
// `cap` pairs, and the last tile writes (pos_total, pair_total) into
// pinned host memory, the call's one host read, and with them the strict
// front end's flag count, which that kernel left in the scan state
// (front_end.cu). Only when pair_total passes cap does a second launch
// (expand_overflow_kernel) write the pairs from the stored lanes: no
// bucket is looked up twice. In the deferred mode of the tile scan the
// totals go to device memory, where verify_p1 reads the pair count, and a
// tile past cap is rerun by the host after its one read of the plane. The lane buffers are scratch from the
// wrapper, 12 bytes per scan position of the tile (a tile's lanes are
// among its scan positions, so each tile of flag words owns a region).

#include "compact.cuh"
#include "units.cuh"

namespace {

constexpr uint32_t kGold = 0x9E3779B1u;  // t16 multiplicative hash

// Bucket lookup of a W-mer h (exact_csr, scan.py:721-741).
enum CsrKind { kCsrRows = 0, kCsrStarts = 1, kCsrSearch = 2 };

struct Csr {
  int kind;
  const int* a;  // rows: bsc [4^W, 2]; starts: bstart [4^W + 1]; search:
                 // uhash [n_keys], uint32 keys ascending as unsigned
  const int* b;  // search: ustart [n_keys + 1]
  int n_keys;
};

__device__ __forceinline__ int2 bucket_of(const Csr& c, uint32_t h) {
  if (c.kind == kCsrRows) return __ldg(reinterpret_cast<const int2*>(c.a) + h);
  if (c.kind == kCsrStarts) {
    const int start = __ldg(c.a + h);
    return make_int2(start, __ldg(c.a + h + 1) - start);
  }
  // first key >= h; keys compare as uint32 (at W = 16 they use all 32 bits)
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(c.a);
  int lo = 0, hi = c.n_keys;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < h) lo = mid + 1; else hi = mid;
  }
  const int uc = min(lo, c.n_keys - 1);
  const int start = __ldg(c.b + uc);
  const bool found = lo < c.n_keys && __ldg(keys + uc) == h;
  return make_int2(start, found ? __ldg(c.b + uc + 1) - start : 0);
}

struct Tables {
  const uint32_t* ptab;  // folded phase bits; null: no exact group table
  uint32_t m2pf;  // folded span-value mask of ptab
  int stride;  // scan positions per ptab group (4 or 2)
  const uint32_t* t16;
  int t16_bits;  // 0: no position filter
  Csr csr;
  int n_entries;
  const uint32_t* bloom;  // W-mer occupancy bits (K10); null: filter off
  int bloom_shift;  // 2W - bloom_bits
};

// K10: is phase d's W-mer (bases d..d+W-1 of the window) a table key (at
// bloom_shift > 0: does it share a key's top bits)?
__device__ __forceinline__ bool bloom_hit(const mp::UnitRegs& g, int d, int W,
                                          const Tables& t) {
  const uint32_t bk = mp::window_bases(g.A, g.B, d, W) >> t.bloom_shift;
  return (__ldg(t.bloom + (bk >> 5)) >> (bk & 31u)) & 1u;
}

// Phase bits of one stride group from its W+stride-1-base span (ptab_bits,
// scan.py:832-871): a clean span trusts ptab's phase bits (32/stride span
// values per word) within the valid phases nbv_g; a dirty span keeps
// dirty_g (its valid phases, or those the K10 bloom kept).
__device__ __forceinline__ uint32_t span_phases(uint32_t Ak, uint32_t Aak,
                                                uint32_t nbv_g, uint32_t dirty_g,
                                                int W, const Tables& t) {
  const uint32_t m2kb = mp::mask2w(W + t.stride - 1);
  if ((Aak & m2kb) != 0) return dirty_g;
  const uint32_t kf = Ak & m2kb & t.m2pf;
  const uint32_t per_word = 32u / t.stride;
  const uint32_t nbt = (__ldg(t.ptab + kf / per_word) >> ((kf % per_word) * t.stride)) &
                       ((1u << t.stride) - 1u);
  return nbt & nbv_g;
}

// Bit d set iff bases d..d+W-1 of the window are clean and scan position
// pos0 + d is in bounds (nbv, scan.py:796-802).
__device__ __forceinline__ uint32_t valid_phases(const mp::UnitRegs& g,
                                                 int n_phases, long long pos0,
                                                 int W, int n_scan) {
  uint32_t nbv = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    if (d >= n_phases) break;
    const uint32_t pha = mp::window_bases(g.Aa, g.Ba, d, W);
    nbv |= static_cast<uint32_t>(pha == 0 && pos0 + d < n_scan) << d;
  }
  return nbv;
}

// The phases of nbv whose W-mer the bloom holds.
__device__ __forceinline__ uint32_t bloom_phases(const mp::UnitRegs& g,
                                                 uint32_t nbv, int first,
                                                 int n, int W, const Tables& t) {
  for (int k = first; k < first + n; ++k)
    if (((nbv >> k) & 1u) && !bloom_hit(g, k, W, t)) nbv &= ~(1u << k);
  return nbv;
}

// Phase nibble of a strict-flagged unit (scan.py:796-876): with a ptab,
// its 8/stride groups each through span_phases, a dirty span's phases
// pruned by the bloom when it is armed (K10); without one, every valid
// phase, all of them pruned by the bloom when it is armed (:872-875).
__device__ __forceinline__ uint32_t unit_phases(const mp::UnitRegs& g, int r,
                                                int W, int n_scan,
                                                const Tables& t) {
  const uint32_t nbv = valid_phases(g, 8, 8ll * r, W, n_scan);
  if (!t.ptab) return t.bloom ? bloom_phases(g, nbv, 0, 8, W, t) : nbv;
  const int S = t.stride;
  const uint32_t m2kb = mp::mask2w(W + S - 1);
  uint32_t nb = 0;
  for (int p = 0; p < 8 / S; ++p) {  // the unit's stride groups
    const int sh = 2 * S * p;
    const uint32_t Ak = p == 0 ? g.A : (g.A >> sh) | (g.B << (32 - sh));
    const uint32_t Aak = p == 0 ? g.Aa : (g.Aa >> sh) | (g.Ba << (32 - sh));
    const uint32_t nbv_p = (nbv >> (S * p)) & ((1u << S) - 1u);
    uint32_t dirty_p = nbv_p;
    if (t.bloom && (Aak & m2kb) != 0)
      dirty_p = (bloom_phases(g, nbv, S * p, S, W, t) >> (S * p)) & ((1u << S) - 1u);
    nb |= span_phases(Ak, Aak, nbv_p, dirty_p, W, t) << (S * p);
  }
  return nb;
}

// Bucket (start, count) of phase d's W-mer after the t16 filter.
__device__ __forceinline__ int2 phase_bucket(const mp::UnitRegs& g, int d,
                                             int W, const Tables& t) {
  if (t.t16_bits) {
    const uint32_t v16 = mp::window16(g.A, g.B, d);
    const uint32_t va16 = mp::window16(g.Aa, g.Ba, d);
    const uint32_t bk = (v16 * kGold) >> (32 - t.t16_bits);
    if (!((__ldg(t.t16 + (bk >> 5)) >> (bk & 31)) & 1u) && va16 == 0)
      return make_int2(0, 0);
  }
  return bucket_of(t.csr, mp::window_bases(g.A, g.B, d, W));
}

// The three modes of an item (the `mode` argument of the C entries). An
// item is a strict-flagged u32 unit (8 phases), in the loose mode a
// loose-flagged stride group q = P*r + p (`stride` phases, scan.py:775-795,
// :863-875; no t16, no K10), or in the raw mode a flag word of a raw-byte
// plane (K9b, scan.py:965-977: 32 positions, the word's bits are its
// phases). Lane (item i, phase d) is scan position ppos = i * n_phases + d.
enum Mode { kStrict = 0, kLoose = 1, kRaw = 2 };

template <int kMode>
__device__ __forceinline__ int n_phases(const Tables& t) {
  return kMode == kStrict ? 8 : kMode == kLoose ? t.stride : 32;
}

// Phase bits of flagged unit or stride group i (not the raw mode, whose
// phase bits are its flag word).
template <int kMode>
__device__ __forceinline__ uint32_t item_phases(const uint32_t* __restrict__ units,
                                                int i, int W, int n_scan,
                                                const Tables& t) {
  if (kMode == kLoose) {
    const mp::UnitRegs g = mp::load_group(units, i, t.stride);
    const uint32_t nbv =
        valid_phases(g, t.stride, static_cast<long long>(t.stride) * i, W, n_scan);
    return t.ptab ? span_phases(g.A, g.Aa, nbv, nbv, W, t) : nbv;
  }
  return unit_phases(mp::load_unit(units, i), i, W, n_scan, t);
}

// Bucket (start, count) of the lane at scan position p: its window's t16
// test (strict) and bucket lookup. Raw: the front end flagged only clean
// windows, so the position's W-mer hashes.
template <int kMode>
__device__ __forceinline__ int2 lane_bucket(const uint32_t* __restrict__ units,
                                            int p, int W, const Tables& t) {
  if (kMode == kRaw) {
    uint32_t h;
    return mp::raw_hash(reinterpret_cast<const uint8_t*>(units) + p, W, &h)
               ? bucket_of(t.csr, h)
               : make_int2(0, 0);
  }
  if (kMode == kLoose)
    return phase_bucket(mp::load_group(units, p / t.stride, t.stride), p % t.stride, W, t);
  return phase_bucket(mp::load_unit(units, p >> 3), p & 7, W, t);
}

// Flag words per tile (one block each): about 256 tiles per call, at 64
// to 256 words (a power of two). Fewer, wider tiles serialise a dirty
// tile's items (up to a third of the units are flagged) over few blocks;
// more, narrower ones lengthen the look-back and add waves of blocks.
constexpr int kMaxTileWords = mp::kBlock;
__host__ __device__ inline int tile_words(int n_words) {
  int w = 64;
  while (w < kMaxTileWords && w * 256 < n_words) w *= 2;
  return w;
}

// Scan positions of one tile: the bound of its lanes, and the length of
// its region of the lane buffers.
__host__ __device__ inline int region_len(int words, int mode, int n_phases) {
  return words * 32 * (mode == kRaw ? 1 : n_phases);
}

// The pairs of a tile's lanes, from each lane's bucket start and pair
// offset: pair `base + o` of the call is (entry clamped into the table,
// the lane's scan position). Pairs at or past `cap` are not written.
__device__ __forceinline__ void write_pairs(const int* lp, const int* ls,
                                            const int* lo, int n_lanes,
                                            int n_pairs, int base,
                                            int n_entries, int* entry,
                                            int* ppos, int cap) {
  for (int l = threadIdx.x; l < n_lanes; l += blockDim.x) {
    const int first = lo[l];
    const int last = l + 1 < n_lanes ? lo[l + 1] : n_pairs;
    const int start = ls[l], p = lp[l];
    for (int o = first; o < last && base + o < cap; ++o) {
      entry[base + o] = min(max(start + (o - first), 0), n_entries - 1);
      ppos[base + o] = p;
    }
  }
}

// One launch per call. A block takes a tile of tile_words(n_words) flag
// words from the ticket and, inside the block:
//   1. lists the tile's items (set flag bits) in order in shared memory;
//   2. works out each item's phase bits once, one item per thread (ptab and
//      K10 bloom gathers), and writes one lane (the scan position of an
//      (item, phase)) per phase bit, in (item, phase) order, into the
//      tile's own region of the lane buffers (raw: the bits are the lanes);
//   3. makes each lane's t16 test and bucket lookup once, one lane per
//      thread, so the phases of one item look up side by side, and stores
//      the lane's bucket start and its pair offset within the tile;
//   4. takes the tile's pair base from the single-pass look-back scan
//      (compact.cuh), adds its lanes to the lane sum, and
//   5. writes its pairs, if they fit the caller's buffers of `cap` pairs.
// The last tile writes (pos_total, pair_total) into the caller's pinned
// host words and puts the counters back to 0. blk[tile] keeps (lanes, pair
// base) for expand_overflow_kernel.
template <int kMode>
__global__ void __launch_bounds__(mp::kBlock)
expand_kernel(const uint32_t* __restrict__ units,
              const uint32_t* __restrict__ words, Tables t, int W,
              int n_words, int n_scan, mp::ScanState ss,
              int* __restrict__ lane_ppos, int* __restrict__ lane_start,
              int* __restrict__ lane_off, int2* __restrict__ blk,
              int* __restrict__ entry, int* __restrict__ ppos, int cap,
              int* __restrict__ totals, bool dev_totals) {
  __shared__ int warp_sums[32];
  const int n_tw = tile_words(n_words);
  __shared__ int items[kMode == kRaw ? 1 : kMaxTileWords * 32];
  __shared__ unsigned int tile_sh;
  __shared__ int base_sh;
  if (threadIdx.x == 0) tile_sh = mp::take_tile(ss);
  __syncthreads();
  const int tile = static_cast<int>(tile_sh);
  const int P = n_phases<kMode>(t);
  const long long region = static_cast<long long>(tile) * region_len(n_tw, kMode, P);
  int* lp = lane_ppos + region;
  int* ls = lane_start + region;
  int* lo = lane_off + region;
  const int w = tile * n_tw + threadIdx.x;
  const uint32_t bits = static_cast<int>(threadIdx.x) < n_tw && w < n_words ? words[w] : 0u;
  int n_bits;
  int o = mp::block_exclusive_scan(__popc(bits), warp_sums, &n_bits);
  int n_lanes;
  if (kMode == kRaw) {
    for (uint32_t m = bits; m; m &= m - 1u) lp[o++] = 32 * w + __ffs(m) - 1;
    n_lanes = n_bits;
  } else {
    for (uint32_t m = bits; m; m &= m - 1u) items[o++] = 32 * w + __ffs(m) - 1;
    __syncthreads();
    n_lanes = 0;
    for (int k0 = 0; k0 < n_bits; k0 += mp::kBlock) {
      const int k = k0 + threadIdx.x;
      const uint32_t nb = k < n_bits ? item_phases<kMode>(units, items[k], W, n_scan, t) : 0u;
      int chunk;
      int l = n_lanes + mp::block_exclusive_scan(__popc(nb), warp_sums, &chunk);
      for (uint32_t f = nb; f; f &= f - 1u) lp[l++] = items[k] * P + __ffs(f) - 1;
      n_lanes += chunk;
    }
  }
  __syncthreads();  // the tile's lanes are written
  int n_pairs = 0;
  for (int l0 = 0; l0 < n_lanes; l0 += mp::kBlock) {
    const int l = l0 + threadIdx.x;
    int count = 0;
    if (l < n_lanes) {
      const int2 sc = lane_bucket<kMode>(units, lp[l], W, t);
      ls[l] = sc.x;
      count = sc.y;
    }
    int chunk;
    const int off = n_pairs + mp::block_exclusive_scan(count, warp_sums, &chunk);
    if (l < n_lanes) lo[l] = off;
    n_pairs += chunk;
  }
  if (threadIdx.x < 32) {  // warp 0 looks back
    if (threadIdx.x == 0 && n_lanes) {
      atomicAdd(ss.ticket + 1, static_cast<unsigned int>(n_lanes));
      __threadfence();  // the lane sum holds this tile before it publishes
    }
    __syncwarp();
    const unsigned int base = mp::look_back(ss, tile, static_cast<unsigned int>(n_pairs));
    if (threadIdx.x == 0) {
      base_sh = static_cast<int>(base);
      blk[tile] = make_int2(n_lanes, static_cast<int>(base));
      if (tile == static_cast<int>(gridDim.x) - 1) {  // every tile has published
        __threadfence();
        const unsigned int lanes = atomicExch(ss.ticket + 1, 0u);
        // raw planes have no position stage; the tile's front-end flag
        // count rides along
        const int pos_total = kMode == kRaw ? 0 : static_cast<int>(lanes);
        const int pair_total = static_cast<int>(base) + n_pairs;
        const int c_total = static_cast<int>(ss.ticket[mp::kFlagSlot]);
        if (dev_totals) {  // the deferred scan's (c, pos, pair) row
          totals[0] = c_total;
          totals[1] = pos_total;
          totals[2] = pair_total;
        } else {
          // one 16-byte store: each store to pinned host memory is a PCIe
          // write that the kernel's end waits for
          *reinterpret_cast<int4*>(totals) = make_int4(pos_total, pair_total, c_total, 0);
        }
        ss.ticket[mp::kFlagSlot] = 0u;
        ss.ticket[0] = 0u;
      }
    }
  }
  __syncthreads();
  write_pairs(lp, ls, lo, n_lanes, n_pairs, base_sh, t.n_entries, entry, ppos, cap);
}

// The pairs of every tile, when pair_total passed the capacity of
// expand_kernel's buffers: one block per tile, from the stored lanes.
__global__ void __launch_bounds__(mp::kBlock)
expand_overflow_kernel(const int* __restrict__ lane_ppos,
                       const int* __restrict__ lane_start,
                       const int* __restrict__ lane_off,
                       const int2* __restrict__ blk, int region,
                       int pair_total, int n_entries, int* __restrict__ entry,
                       int* __restrict__ ppos) {
  const int tile = blockIdx.x;
  const long long first = static_cast<long long>(tile) * region;
  const int2 b = blk[tile];
  const int end = tile + 1 < static_cast<int>(gridDim.x) ? blk[tile + 1].y : pair_total;
  write_pairs(lane_ppos + first, lane_start + first, lane_off + first, b.x,
              end - b.y, b.y, n_entries, entry, ppos, pair_total);
}

Tables make_tables(const void* ptab, int pf_bits, const void* t16,
                   int t16_bits, int csr_kind, const void* csr_a,
                   const void* csr_b, int n_keys, int n_entries,
                   const void* bloom, int bloom_shift, int stride) {
  return Tables{static_cast<const uint32_t*>(ptab),
                pf_bits >= 32 ? 0xFFFFFFFFu : ((1u << pf_bits) - 1u),
                stride,
                static_cast<const uint32_t*>(t16),
                t16_bits,
                Csr{csr_kind, static_cast<const int*>(csr_a),
                    static_cast<const int*>(csr_b), n_keys},
                n_entries,
                static_cast<const uint32_t*>(bloom),
                bloom_shift};
}

template <int kMode>
cudaError_t launch(int grid, cudaStream_t s, const uint32_t* u, const uint32_t* w,
                   const Tables& t, int W, int n_words, int n_scan,
                   const mp::ScanState& ss, int* lp, int* ls, int* lo, int2* blk,
                   int* entry, int* ppos, int cap, int* totals, bool dev_totals) {
  expand_kernel<kMode><<<grid, mp::kBlock, 0, s>>>(u, w, t, W, n_words, n_scan, ss, lp, ls,
                                                   lo, blk, entry, ppos, cap, totals,
                                                   dev_totals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles of flag words (blocks) of one expansion.
int mp_expand_tiles(int n_words) {
  return (n_words + tile_words(n_words) - 1) / tile_words(n_words);
}

// The expansion, one launch. mode 0 (strict): n_words = tile_len / 256
// flag words of one bit per unit; 1 (loose): tile_len / (32 * stride)
// words of one bit per stride group; 2 (raw): tile_len / 32 flag words of
// 32 positions, `units` then being the raw byte plane offset to the first
// scan position (W - 1 readable bytes past the last). ptab null: no exact
// group table (W >= 14, and the raw mode). t16 may be null when t16_bits
// is 0, bloom null to leave K10 off (the loose and raw modes read
// neither). csr_kind 0: csr_a = bsc rows; 1: csr_a = bstart; 2: csr_a =
// uhash (n_keys of them), csr_b = ustart. ticket/status/seq: the device's
// scan state (compact.cuh ScanState), status holding
// mp_expand_tiles(n_words) entries. lane_ppos, lane_start and lane_off
// hold tile_len ints each, blk mp_expand_tiles(n_words) int2; entry/ppos hold cap ints each.
// totals: four ints, 16-byte aligned, that the kernel writes (pos_total,
// pair_total, the front end's flag count from the scan state's
// slot, 0), host-mapped pinned memory in the count-first wrapper; with
// dev_totals, three device ints (the flag count, pos_total, pair_total) of
// the deferred scan's totals row. If pair_total > cap, mp_expand_overflow
// writes the pairs (the deferred scan reruns the tile instead).
int mp_expand(const void* units, const void* words, const void* ptab,
              int pf_bits, const void* t16, int t16_bits, int csr_kind,
              const void* csr_a, const void* csr_b, int n_keys, int n_entries,
              const void* bloom, int bloom_shift, int W, int stride,
              int n_words, int n_scan, int mode, void* ticket, void* status,
              int seq, void* lane_ppos, void* lane_start, void* lane_off,
              void* blk, void* entry, void* ppos, int cap, void* totals,
              int dev_totals, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = make_tables(ptab, pf_bits, t16, t16_bits, csr_kind, csr_a,
                               csr_b, n_keys, n_entries, bloom, bloom_shift,
                               stride);
  const uint32_t* u = static_cast<const uint32_t*>(units);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const mp::ScanState ss = {static_cast<unsigned int*>(ticket),
                            static_cast<unsigned long long*>(status),
                            static_cast<unsigned int>(seq)};
  int* lp = static_cast<int*>(lane_ppos);
  int* ls = static_cast<int*>(lane_start);
  int* lo = static_cast<int*>(lane_off);
  int2* b = static_cast<int2*>(blk);
  int* en = static_cast<int*>(entry);
  int* pp = static_cast<int*>(ppos);
  int* tot = static_cast<int*>(totals);
  const int g = mp_expand_tiles(n_words);
  const bool dt = dev_totals != 0;
  return static_cast<int>(
      mode == kRaw ? launch<kRaw>(g, s, u, w, t, W, n_words, n_scan, ss, lp, ls, lo, b, en, pp, cap, tot, dt)
      : mode == kLoose ? launch<kLoose>(g, s, u, w, t, W, n_words, n_scan, ss, lp, ls, lo, b, en, pp, cap, tot, dt)
                       : launch<kStrict>(g, s, u, w, t, W, n_words, n_scan, ss, lp, ls, lo, b, en, pp, cap, tot, dt));
}

// The pairs when pair_total passed cap: entry/ppos hold pair_total ints
// each; the lane buffers and blk as mp_expand left them.
int mp_expand_overflow(const void* lane_ppos, const void* lane_start,
                       const void* lane_off, const void* blk, int n_words,
                       int mode, int stride, int pair_total, int n_entries,
                       void* entry, void* ppos, void* stream) {
  const int phases = mode == kStrict ? 8 : stride;
  expand_overflow_kernel<<<mp_expand_tiles(n_words), mp::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lane_ppos), static_cast<const int*>(lane_start),
      static_cast<const int*>(lane_off), static_cast<const int2*>(blk),
      region_len(tile_words(n_words), mode, phases), pair_total, n_entries, static_cast<int*>(entry),
      static_cast<int*>(ppos));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
