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
// is a key of the table's occupancy bitmap.
//
// Pairs come out in (unit, phase, bucket slot) order, so pair j here is
// the JAX pipeline's pair j: the order is the emission key pair_order.
// pos_total counts phase bits before the t16 filter, pair_total bucket
// slots after it, as the JAX totals do.
//
// Bound on the card: memory, and little of it. One thread per unit reads
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

// Phase nibble of a flagged unit (scan.py:796-876 for stride 4, strict):
// bit d set iff phase d's W-mer window is clean and in bounds, and -- when
// the 14-base span of its stride group is clean -- ptab says phase d
// starts some bucket key, or -- when the span is dirty and the bloom is
// armed -- the bloom holds phase d's W-mer.
__device__ __forceinline__ uint32_t phase_bits(const mp::UnitRegs& g, int r,
                                               int W, int n_scan,
                                               const Tables& t) {
  const uint32_t m2w = mp::mask2w(W);
  uint32_t nbv = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    uint32_t pha = (g.Aa >> (2 * d)) & m2w;
    if (2 * (d + W) > 32) pha |= (g.Ba << (32 - 2 * d)) & m2w;  // d >= 1 here
    const bool ok = pha == 0 && static_cast<long long>(r) * 8 + d < n_scan;
    nbv |= static_cast<uint32_t>(ok) << d;
  }
  const uint32_t m2kb = (1u << (2 * (W + 3))) - 1u;  // span = W + stride - 1
  uint32_t nb = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // two stride-4 groups per unit
    const uint32_t Ak = p == 0 ? g.A : (g.A >> 8) | (g.B << 24);
    const uint32_t Aak = p == 0 ? g.Aa : (g.Aa >> 8) | (g.Ba << 24);
    const uint32_t kf = Ak & m2kb & t.m2pf;
    const uint32_t nbt = (__ldg(t.ptab + (kf >> 3)) >> ((kf & 7u) * 4u)) & 0xFu;
    const uint32_t nbv_p = (nbv >> (4 * p)) & 0xFu;
    const bool span_clean = (Aak & m2kb) == 0;
    uint32_t dirty_p = nbv_p;
    if (!span_clean && t.bloom) {
      for (int k = 0; k < 4; ++k)
        if (((dirty_p >> k) & 1u) && !bloom_hit(g, 4 * p + k, W, t))
          dirty_p &= ~(1u << k);
    }
    nb |= (span_clean ? (nbt & nbv_p) : dirty_p) << (4 * p);
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

__device__ __forceinline__ bool unit_flag(const uint32_t* __restrict__ words,
                                          int r) {
  return (words[r >> 5] >> (r & 31)) & 1u;
}

__global__ void expand_count_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_units, int n_scan,
                                    int* __restrict__ pos_total,
                                    int* __restrict__ blk_pairs) {
  __shared__ int warp_sums[32];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  int n_pos = 0, n_pairs = 0;
  if (r < n_units && unit_flag(words, r)) {
    const mp::UnitRegs g = mp::load_unit(units, r);
    const uint32_t nb = phase_bits(g, r, W, n_scan, t);
    n_pos = __popc(nb);
    for (int d = 0; d < 8; ++d)
      if ((nb >> d) & 1u) n_pairs += phase_bucket(g, d, W, t).y;
  }
  int blk;
  mp::block_exclusive_scan(n_pos, warp_sums, &blk);
  if (threadIdx.x == 0 && blk) atomicAdd(pos_total, blk);
  mp::block_exclusive_scan(n_pairs, warp_sums, &blk);
  if (threadIdx.x == 0) blk_pairs[blockIdx.x] = blk;
}

__global__ void expand_write_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_units, int n_scan,
                                    const int* __restrict__ blk_off,
                                    int* __restrict__ entry,
                                    int* __restrict__ ppos) {
  __shared__ int warp_sums[32];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n_units && unit_flag(words, r);
  mp::UnitRegs g = {0, 0, 0, 0};
  uint32_t nb = 0;
  int n_pairs = 0;
  if (live) {
    g = mp::load_unit(units, r);
    nb = phase_bits(g, r, W, n_scan, t);
    for (int d = 0; d < 8; ++d)
      if ((nb >> d) & 1u) n_pairs += phase_bucket(g, d, W, t).y;
  }
  int unused;
  int out = mp::block_exclusive_scan(n_pairs, warp_sums, &unused);
  if (!n_pairs) return;
  out += blk_off[blockIdx.x];
  for (int d = 0; d < 8; ++d) {
    if (!((nb >> d) & 1u)) continue;
    const int2 sc = phase_bucket(g, d, W, t);
    for (int s = 0; s < sc.y; ++s, ++out) {
      entry[out] = min(max(sc.x + s, 0), t.n_entries - 1);
      ppos[out] = r * 8 + d;
    }
  }
}

}  // namespace

extern "C" {

// Count pass + block-sum scan. blk_pairs/blk_off hold n_blocks(n_units)
// ints; totals is int[2] = (pos_total, pair_total), zeroed by the caller.
int mp_expand_count(const void* units, const void* words, const void* ptab,
                    int pf_bits, const void* t16, int t16_bits,
                    const void* bsc, int n_entries, const void* bloom,
                    int bloom_shift, int W, int n_units, int n_scan,
                    void* blk_pairs, void* blk_off, void* totals,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = {static_cast<const uint32_t*>(ptab),
                    (1u << pf_bits) - 1u,
                    static_cast<const uint32_t*>(t16), t16_bits,
                    static_cast<const int*>(bsc), n_entries,
                    static_cast<const uint32_t*>(bloom), bloom_shift};
  const int nb = mp::n_blocks(n_units);
  int* tot = static_cast<int*>(totals);
  expand_count_kernel<<<nb, mp::kBlock, 0, s>>>(
      static_cast<const uint32_t*>(units), static_cast<const uint32_t*>(words),
      t, W, n_units, n_scan, tot, static_cast<int*>(blk_pairs));
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
                    int bloom_shift, int W, int n_units, int n_scan,
                    const void* blk_off, void* entry, void* ppos,
                    void* stream) {
  const Tables t = {static_cast<const uint32_t*>(ptab),
                    (1u << pf_bits) - 1u,
                    static_cast<const uint32_t*>(t16), t16_bits,
                    static_cast<const int*>(bsc), n_entries,
                    static_cast<const uint32_t*>(bloom), bloom_shift};
  expand_write_kernel<<<mp::n_blocks(n_units), mp::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(units), static_cast<const uint32_t*>(words),
      t, W, n_units, n_scan, static_cast<const int*>(blk_off),
      static_cast<int*>(entry), static_cast<int*>(ppos));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
