// expand: flagged units -> (entry, position) candidate pairs of one tile.
//
// Replaces merpcr_tpu/ops/scan.py::_scan_tile_impl stages K2-K5: the
// flag-word compaction (scan.py:680-719, _rank_invert :317-341,
// _blocked_scan :287-314), the strict phase expansion through the exact
// phase table ptab (:757-927, ptab_bits :832-862), the hashed 16-base
// position filter t16 (:929-949) and the dense W <= 11 CSR pair expansion
// (exact_csr :728-730, :953-964); and K10, the dirty-span phase filter
// (dirty_bloom, :803-822, applied at :859-861): with a bloom table, a
// phase of a unit whose stride-4 span is dirty survives only if its W-mer
// is a key of the table's occupancy bitmap. At -N 1 the strict1 variant
// runs this code with t16_1 in place of t16.
//
// The loose mode (loose != 0) is the loose branch of the same stages
// (scan.py:775-795, :863-871), behind the K8 front end: one thread per
// stride-4 group q = 2r + p, whose registers are unit r's shifted right
// by 4 bases for p = 1; 4 phases at scan positions 4q + d; a clean span
// keeps ptab's phase bits within the valid ones, a dirty span all valid
// phases; no t16 and no bloom.
//
// Pairs come out in (item, phase, bucket slot) order, so pair j here is
// the JAX pipeline's pair j: the order is the emission key pair_order.
// pos_total counts phase bits before the t16 filter, pair_total bucket
// slots after it, as the JAX totals do.
//
// Bound on the card: memory, and little of it. One thread per item reads
// its flag word; only flagged units (a few per 10^4) read their three plane
// words and make 2 ptab gathers (32 MB table), one t16 gather and one bsc
// row gather (32 MB) per phase; with the dirty-span filter armed, one
// 4-byte gather into the 512 KB bloom per clean phase of a dirty span
// (L2-resident; only the phases the filter decides are looked up, not all
// eight as in the JAX stage). Reduce-then-scan with recompute: the
// count pass keeps nothing per unit, the write pass recomputes the unit's
// phases and writes at block offset + block-exclusive offset, so no buffer
// is sized before its total is known and the order is exact.

#include "compact.cuh"
#include "units.cuh"

namespace {

constexpr uint32_t kGold = 0x9E3779B1u;  // t16 multiplicative hash

struct Tables {
  const uint32_t* ptab;
  uint32_t m2pf;  // folded span-value mask of ptab
  const uint32_t* t16;
  int t16_bits;  // 0: no position filter
  const int* bsc;  // [4^W, 2] (start, count)
  int n_entries;
  const uint32_t* bloom;  // W-mer occupancy bits (K10); null: filter off
  int bloom_shift;  // 2W - bloom_bits
};

// K10: is phase d's W-mer (bases d..d+W-1 of the window) a table key?
__device__ __forceinline__ bool bloom_hit(const mp::UnitRegs& g, int d, int W,
                                          const Tables& t) {
  const uint32_t m2w = mp::mask2w(W);
  uint32_t wm = (g.A >> (2 * d)) & m2w;
  if (2 * (d + W) > 32) wm |= (g.B << (32 - 2 * d)) & m2w;  // d >= 1 here
  const uint32_t bk = wm >> t.bloom_shift;
  return (__ldg(t.bloom + (bk >> 5)) >> (bk & 31u)) & 1u;
}

// Phase nibble of one stride-4 group from its 14-base span (ptab_bits,
// scan.py:832-871): a clean span trusts ptab's phase bits within the valid
// phases nbv_g; a dirty span keeps dirty_g (its valid phases, or those the
// K10 bloom kept).
__device__ __forceinline__ uint32_t span_phases(uint32_t Ak, uint32_t Aak,
                                                uint32_t nbv_g, uint32_t dirty_g,
                                                int W, const Tables& t) {
  const uint32_t m2kb = (1u << (2 * (W + 3))) - 1u;  // span = W + stride - 1
  const uint32_t kf = Ak & m2kb & t.m2pf;
  const uint32_t nbt = (__ldg(t.ptab + (kf >> 3)) >> ((kf & 7u) * 4u)) & 0xFu;
  return (Aak & m2kb) == 0 ? (nbt & nbv_g) : dirty_g;
}

// Bit d set iff bases d..d+W-1 of the window are clean and scan position
// pos0 + d is in bounds (nbv, scan.py:796-802).
template <int kPhases>
__device__ __forceinline__ uint32_t valid_phases(const mp::UnitRegs& g,
                                                 long long pos0, int W,
                                                 int n_scan) {
  const uint32_t m2w = mp::mask2w(W);
  uint32_t nbv = 0;
#pragma unroll
  for (int d = 0; d < kPhases; ++d) {
    uint32_t pha = (g.Aa >> (2 * d)) & m2w;
    if (2 * (d + W) > 32) pha |= (g.Ba << (32 - 2 * d)) & m2w;  // d >= 1 here
    nbv |= static_cast<uint32_t>(pha == 0 && pos0 + d < n_scan) << d;
  }
  return nbv;
}

// Phase nibble of a strict-flagged unit (scan.py:796-876 for stride 4):
// its two stride-4 groups, each through span_phases; a dirty span's
// phases are pruned by the bloom when it is armed (K10).
__device__ __forceinline__ uint32_t unit_phases(const mp::UnitRegs& g, int r,
                                                int W, int n_scan,
                                                const Tables& t) {
  const uint32_t nbv = valid_phases<8>(g, 8ll * r, W, n_scan);
  uint32_t nb = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // two stride-4 groups per unit
    const uint32_t Ak = p == 0 ? g.A : (g.A >> 8) | (g.B << 24);
    const uint32_t Aak = p == 0 ? g.Aa : (g.Aa >> 8) | (g.Ba << 24);
    const uint32_t nbv_p = (nbv >> (4 * p)) & 0xFu;
    uint32_t dirty_p = nbv_p;
    if (t.bloom && (Aak & ((1u << (2 * (W + 3))) - 1u)) != 0) {
      for (int k = 0; k < 4; ++k)
        if (((dirty_p >> k) & 1u) && !bloom_hit(g, 4 * p + k, W, t))
          dirty_p &= ~(1u << k);
    }
    nb |= span_phases(Ak, Aak, nbv_p, dirty_p, W, t) << (4 * p);
  }
  return nb;
}

// Bucket (start, count) of phase d's W-mer after the t16 filter.
__device__ __forceinline__ int2 phase_bucket(const mp::UnitRegs& g, int d,
                                             int W, const Tables& t) {
  const uint32_t m2w = mp::mask2w(W);
  uint32_t phh = (g.A >> (2 * d)) & m2w;
  if (2 * (d + W) > 32) phh |= (g.B << (32 - 2 * d)) & m2w;
  bool keep = true;
  if (t.t16_bits) {
    const uint32_t v16 = mp::window16(g.A, g.B, d);
    const uint32_t va16 = mp::window16(g.Aa, g.Ba, d);
    const uint32_t bk = (v16 * kGold) >> (32 - t.t16_bits);
    keep = ((__ldg(t.t16 + (bk >> 5)) >> (bk & 31)) & 1u) || va16 != 0;
  }
  const int2 sc = __ldg(reinterpret_cast<const int2*>(t.bsc) + phh);
  return make_int2(sc.x, keep ? sc.y : 0);
}

// An item is a strict-flagged u32 unit (8 phases) or, in the loose mode, a
// loose-flagged stride-4 group (4 phases, scan.py:775-795, :863-871; no
// t16, no K10). Its registers hold the window that starts at its first
// scan position, and its phase nibble says which phases expand.
template <bool kLoose>
struct Item {
  static constexpr int kPhases = kLoose ? 4 : 8;
  mp::UnitRegs g;
  uint32_t nb;

  __device__ __forceinline__ void load(const uint32_t* __restrict__ units,
                                       int i, int W, int n_scan,
                                       const Tables& t) {
    if (kLoose) {
      g = mp::load_group(units, i);
      const uint32_t nbv = valid_phases<4>(g, 4ll * i, W, n_scan);
      nb = span_phases(g.A, g.Aa, nbv, nbv, W, t);
    } else {
      g = mp::load_unit(units, i);
      nb = unit_phases(g, i, W, n_scan, t);
    }
  }

  __device__ __forceinline__ int n_pairs(int W, const Tables& t) const {
    int n = 0;
#pragma unroll
    for (int d = 0; d < kPhases; ++d)
      if ((nb >> d) & 1u) n += phase_bucket(g, d, W, t).y;
    return n;
  }
};

__device__ __forceinline__ bool item_flag(const uint32_t* __restrict__ words,
                                          int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

template <bool kLoose>
__global__ void expand_count_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_items, int n_scan,
                                    int* __restrict__ pos_total,
                                    int* __restrict__ blk_pairs) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n_pos = 0, n_pairs = 0;
  if (i < n_items && item_flag(words, i)) {
    Item<kLoose> it;
    it.load(units, i, W, n_scan, t);
    n_pos = __popc(it.nb);
    n_pairs = it.n_pairs(W, t);
  }
  int blk;
  mp::block_exclusive_scan(n_pos, warp_sums, &blk);
  if (threadIdx.x == 0 && blk) atomicAdd(pos_total, blk);
  mp::block_exclusive_scan(n_pairs, warp_sums, &blk);
  if (threadIdx.x == 0) blk_pairs[blockIdx.x] = blk;
}

template <bool kLoose>
__global__ void expand_write_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_items, int n_scan,
                                    const int* __restrict__ blk_off,
                                    int* __restrict__ entry,
                                    int* __restrict__ ppos) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Item<kLoose> it;
  it.g = {0, 0, 0, 0};
  it.nb = 0;
  int n_pairs = 0;
  if (i < n_items && item_flag(words, i)) {
    it.load(units, i, W, n_scan, t);
    n_pairs = it.n_pairs(W, t);
  }
  int unused;
  int out = mp::block_exclusive_scan(n_pairs, warp_sums, &unused);
  if (!n_pairs) return;
  out += blk_off[blockIdx.x];
  for (int d = 0; d < Item<kLoose>::kPhases; ++d) {
    if (!((it.nb >> d) & 1u)) continue;
    const int2 sc = phase_bucket(it.g, d, W, t);
    for (int s = 0; s < sc.y; ++s, ++out) {
      entry[out] = min(max(sc.x + s, 0), t.n_entries - 1);
      ppos[out] = i * Item<kLoose>::kPhases + d;
    }
  }
}

}  // namespace

extern "C" {

// Count pass + block-sum scan. n_items: tile_len / 8 units, or with loose
// != 0 tile_len / 4 stride-4 groups; blk_pairs/blk_off hold
// n_blocks(n_items) ints; totals is int[2] = (pos_total, pair_total),
// zeroed by the caller. t16 may be null when t16_bits is 0, bloom null to
// leave K10 off (the loose mode never reads either).
int mp_expand_count(const void* units, const void* words, const void* ptab,
                    int pf_bits, const void* t16, int t16_bits,
                    const void* bsc, int n_entries, const void* bloom,
                    int bloom_shift, int W, int n_items, int n_scan, int loose,
                    void* blk_pairs, void* blk_off, void* totals,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = {static_cast<const uint32_t*>(ptab),
                    (1u << pf_bits) - 1u,
                    static_cast<const uint32_t*>(t16), t16_bits,
                    static_cast<const int*>(bsc), n_entries,
                    static_cast<const uint32_t*>(bloom), bloom_shift};
  const int nb = mp::n_blocks(n_items);
  int* tot = static_cast<int*>(totals);
  const uint32_t* u = static_cast<const uint32_t*>(units);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (loose)
    expand_count_kernel<true><<<nb, mp::kBlock, 0, s>>>(
        u, w, t, W, n_items, n_scan, tot, static_cast<int*>(blk_pairs));
  else
    expand_count_kernel<false><<<nb, mp::kBlock, 0, s>>>(
        u, w, t, W, n_items, n_scan, tot, static_cast<int*>(blk_pairs));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mp::launch_scan_sums(
      static_cast<const int*>(blk_pairs), nb, static_cast<int*>(blk_off),
      tot + 1, s));
}

// Write pass: entry/ppos hold pair_total ints each.
int mp_expand_write(const void* units, const void* words, const void* ptab,
                    int pf_bits, const void* t16, int t16_bits,
                    const void* bsc, int n_entries, const void* bloom,
                    int bloom_shift, int W, int n_items, int n_scan, int loose,
                    const void* blk_off, void* entry, void* ppos,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = {static_cast<const uint32_t*>(ptab),
                    (1u << pf_bits) - 1u,
                    static_cast<const uint32_t*>(t16), t16_bits,
                    static_cast<const int*>(bsc), n_entries,
                    static_cast<const uint32_t*>(bloom), bloom_shift};
  const int nb = mp::n_blocks(n_items);
  const uint32_t* u = static_cast<const uint32_t*>(units);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const int* off = static_cast<const int*>(blk_off);
  if (loose)
    expand_write_kernel<true><<<nb, mp::kBlock, 0, s>>>(
        u, w, t, W, n_items, n_scan, off, static_cast<int*>(entry),
        static_cast<int*>(ppos));
  else
    expand_write_kernel<false><<<nb, mp::kBlock, 0, s>>>(
        u, w, t, W, n_items, n_scan, off, static_cast<int*>(entry),
        static_cast<int*>(ppos));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
