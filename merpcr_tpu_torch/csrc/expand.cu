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
// (scan.py:775-795, :863-875), behind the K8 front end: one thread per
// stride group q = P*r + p, whose registers are unit r's shifted right by
// stride*p bases; `stride` phases at scan positions stride*q + d; a clean
// span keeps ptab's phase bits within the valid ones, a dirty span (or any
// span without a ptab) all valid phases; no t16 and no bloom.
//
// The raw mode (mode 2, K9b) is the unpacked branch (scan.py:680-719,
// :965-977) behind the raw-byte front end (K9a): one thread per flag word
// of a plane with one byte per position (32 positions, bit d = position
// 32w + d); each flagged position recomputes its W-mer from its W bytes and
// expands its one bucket. There is no position stage there, so pos_total
// stays 0 as in the JAX totals.
//
// Pairs come out in (item, phase, bucket slot) order, so pair j here is
// the JAX pipeline's pair j: the order is the emission key pair_order.
// pos_total counts phase bits before the t16 filter, pair_total bucket
// slots after it, as the JAX totals do.
//
// Bound on the card: memory, and little of it. One thread per item reads
// its flag word; only flagged units (a few per 10^4) read their three plane
// words and make one ptab gather per group, one t16 gather and one bucket
// lookup per phase (a row gather, two gathers, or ~log2(U) dependent
// gathers of the search); with the dirty-span filter armed, one
// 4-byte gather into the bloom per clean phase of a dirty span
// (L2-resident; only the phases the filter decides are looked up, not all
// eight as in the JAX stage). Reduce-then-scan with recompute: the
// count pass keeps nothing per unit, the write pass recomputes the unit's
// phases and writes at block offset + block-exclusive offset, so no buffer
// is sized before its total is known and the order is exact.

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

// The three modes of an item (the `mode` argument of the C entries).
enum Mode { kStrict = 0, kLoose = 1, kRaw = 2 };

// An item is a strict-flagged u32 unit (8 phases), in the loose mode a
// loose-flagged stride group (`stride` phases, scan.py:775-795, :863-875;
// no t16, no K10), or in the raw mode a nonzero flag word of a raw-byte
// plane (K9b, scan.py:965-977: 32 positions, the word's bits are its
// phases). Its registers hold the window that starts at its first scan
// position (raw: `bytes` points at its first position's byte), and its
// phase bits say which phases expand.
template <int kMode>
struct Item {
  mp::UnitRegs g;
  uint32_t nb;
  const uint8_t* bytes;

  static __device__ __forceinline__ int n_phases(const Tables& t) {
    return kMode == kStrict ? 8 : kMode == kLoose ? t.stride : 32;
  }

  // Is item i flagged: its bit of the flag words, or (raw) its word.
  static __device__ __forceinline__ bool flagged(const uint32_t* __restrict__ words,
                                                 int i) {
    if (kMode == kRaw) return words[i] != 0u;
    return (words[i >> 5] >> (i & 31)) & 1u;
  }

  __device__ __forceinline__ void load(const uint32_t* __restrict__ units,
                                       const uint32_t* __restrict__ words,
                                       int i, int W, int n_scan,
                                       const Tables& t) {
    if (kMode == kRaw) {
      bytes = reinterpret_cast<const uint8_t*>(units) + 32ll * i;
      nb = words[i];
    } else if (kMode == kLoose) {
      g = mp::load_group(units, i, t.stride);
      const uint32_t nbv =
          valid_phases(g, t.stride, static_cast<long long>(t.stride) * i, W, n_scan);
      nb = t.ptab ? span_phases(g.A, g.Aa, nbv, nbv, W, t) : nbv;
    } else {
      g = mp::load_unit(units, i);
      nb = unit_phases(g, i, W, n_scan, t);
    }
  }

  // Bucket (start, count) of phase d. Raw: the front end flagged only
  // clean windows, so the position's W-mer hashes.
  __device__ __forceinline__ int2 bucket(int d, int W, const Tables& t) const {
    if (kMode == kRaw) {
      uint32_t h;
      return mp::raw_hash(bytes + d, W, &h) ? bucket_of(t.csr, h) : make_int2(0, 0);
    }
    return phase_bucket(g, d, W, t);
  }

  // Positions the JAX totals count: the raw path has no position stage
  // (pos_total is 0 there, scan.py:967).
  __device__ __forceinline__ int n_positions() const {
    return kMode == kRaw ? 0 : __popc(nb);
  }

  __device__ __forceinline__ int n_pairs(int W, const Tables& t) const {
    int n = 0;
    for (uint32_t m = nb; m; m &= m - 1u) n += bucket(__ffs(m) - 1, W, t).y;
    return n;
  }
};

template <int kMode>
__global__ void expand_count_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_items, int n_scan,
                                    int* __restrict__ pos_total,
                                    int* __restrict__ blk_pairs) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n_pos = 0, n_pairs = 0;
  if (i < n_items && Item<kMode>::flagged(words, i)) {
    Item<kMode> it;
    it.load(units, words, i, W, n_scan, t);
    n_pos = it.n_positions();
    n_pairs = it.n_pairs(W, t);
  }
  int blk;
  mp::block_exclusive_scan(n_pos, warp_sums, &blk);
  if (threadIdx.x == 0 && blk) atomicAdd(pos_total, blk);
  mp::block_exclusive_scan(n_pairs, warp_sums, &blk);
  if (threadIdx.x == 0) blk_pairs[blockIdx.x] = blk;
}

template <int kMode>
__global__ void expand_write_kernel(const uint32_t* __restrict__ units,
                                    const uint32_t* __restrict__ words,
                                    Tables t, int W, int n_items, int n_scan,
                                    const int* __restrict__ blk_off,
                                    int* __restrict__ entry,
                                    int* __restrict__ ppos) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Item<kMode> it;
  it.g = {0, 0, 0, 0};
  it.nb = 0;
  it.bytes = nullptr;
  int n_pairs = 0;
  if (i < n_items && Item<kMode>::flagged(words, i)) {
    it.load(units, words, i, W, n_scan, t);
    n_pairs = it.n_pairs(W, t);
  }
  int unused;
  int out = mp::block_exclusive_scan(n_pairs, warp_sums, &unused);
  if (!n_pairs) return;
  out += blk_off[blockIdx.x];
  const int n_phases = Item<kMode>::n_phases(t);
  for (uint32_t m = it.nb; m; m &= m - 1u) {  // phases in ascending order
    const int d = __ffs(m) - 1;
    const int2 sc = it.bucket(d, W, t);
    for (int s = 0; s < sc.y; ++s, ++out) {
      entry[out] = min(max(sc.x + s, 0), t.n_entries - 1);
      ppos[out] = i * n_phases + d;
    }
  }
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
cudaError_t launch_count(int nb, cudaStream_t s, const uint32_t* u,
                         const uint32_t* w, const Tables& t, int W,
                         int n_items, int n_scan, int* tot, int* blk_pairs) {
  expand_count_kernel<kMode><<<nb, mp::kBlock, 0, s>>>(u, w, t, W, n_items,
                                                       n_scan, tot, blk_pairs);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_write(int nb, cudaStream_t s, const uint32_t* u,
                         const uint32_t* w, const Tables& t, int W,
                         int n_items, int n_scan, const int* off, int* entry,
                         int* ppos) {
  expand_write_kernel<kMode><<<nb, mp::kBlock, 0, s>>>(u, w, t, W, n_items,
                                                       n_scan, off, entry, ppos);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Count pass + block-sum scan. mode 0 (strict): n_items = tile_len / 8
// units; 1 (loose): tile_len / stride groups; 2 (raw): tile_len / 32 flag
// words of 32 positions, `units` then being the raw byte plane offset to the first scan position
// (W - 1 readable bytes past the last). blk_pairs/blk_off hold
// n_blocks(n_items) ints; totals is int[2] = (pos_total, pair_total),
// zeroed by the caller. ptab null: no exact group table (W >= 14, and the
// raw mode). t16 may be null when t16_bits is 0, bloom null to leave K10
// off (the loose and raw modes read neither).
// csr_kind 0: csr_a = bsc rows; 1: csr_a = bstart; 2: csr_a = uhash
// (n_keys of them), csr_b = ustart.
int mp_expand_count(const void* units, const void* words, const void* ptab,
                    int pf_bits, const void* t16, int t16_bits, int csr_kind,
                    const void* csr_a, const void* csr_b, int n_keys,
                    int n_entries, const void* bloom, int bloom_shift, int W,
                    int stride, int n_items, int n_scan, int mode,
                    void* blk_pairs, void* blk_off, void* totals,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = make_tables(ptab, pf_bits, t16, t16_bits, csr_kind, csr_a,
                               csr_b, n_keys, n_entries, bloom, bloom_shift,
                               stride);
  const int nb = mp::n_blocks(n_items);
  int* tot = static_cast<int*>(totals);
  const uint32_t* u = static_cast<const uint32_t*>(units);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  int* bp = static_cast<int*>(blk_pairs);
  const cudaError_t e =
      mode == kRaw ? launch_count<kRaw>(nb, s, u, w, t, W, n_items, n_scan, tot, bp)
      : mode == kLoose ? launch_count<kLoose>(nb, s, u, w, t, W, n_items, n_scan, tot, bp)
                       : launch_count<kStrict>(nb, s, u, w, t, W, n_items, n_scan, tot, bp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mp::launch_scan_sums(
      static_cast<const int*>(blk_pairs), nb, static_cast<int*>(blk_off),
      tot + 1, s));
}

// Write pass: entry/ppos hold pair_total ints each.
int mp_expand_write(const void* units, const void* words, const void* ptab,
                    int pf_bits, const void* t16, int t16_bits, int csr_kind,
                    const void* csr_a, const void* csr_b, int n_keys,
                    int n_entries, const void* bloom, int bloom_shift, int W,
                    int stride, int n_items, int n_scan, int mode,
                    const void* blk_off, void* entry, void* ppos,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tables t = make_tables(ptab, pf_bits, t16, t16_bits, csr_kind, csr_a,
                               csr_b, n_keys, n_entries, bloom, bloom_shift,
                               stride);
  const int nb = mp::n_blocks(n_items);
  const uint32_t* u = static_cast<const uint32_t*>(units);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const int* off = static_cast<const int*>(blk_off);
  int* en = static_cast<int*>(entry);
  int* pp = static_cast<int*>(ppos);
  return static_cast<int>(
      mode == kRaw ? launch_write<kRaw>(nb, s, u, w, t, W, n_items, n_scan, off, en, pp)
      : mode == kLoose ? launch_write<kLoose>(nb, s, u, w, t, W, n_items, n_scan, off, en, pp)
                       : launch_write<kStrict>(nb, s, u, w, t, W, n_items, n_scan, off, en, pp));
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
