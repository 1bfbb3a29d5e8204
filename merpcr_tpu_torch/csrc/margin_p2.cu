// margin_p2: margin-window primer-2 verify and hit emission of one tile.
//
// Replaces merpcr_tpu/ops/scan.py::_margin_stage (scan.py:1047-1318) at
// every margin, the static-slice branch (R <= 257) and the rank-chunked one
// (K13, :1103-1127, :1201-1235): per (anchor, rank) the reference clamps
// of the expected product end exp/hi/lo (:1070-1077), rank r -> offset d
// = 0, -1, +1, -2, ... (_rank_d :344), the structural bounds (:1241-1248),
// the rank mask (:1249-1257) and the primer-2 verify with the '-' strand's
// first-X-bases protection (_p2_ok_of :1133-1158; at -I 1 the IUPAC
// expansion-set test of K11, :1139-1143; in the byte mode, K9c, genome
// bytes against primer bytes, :1147-1152). Every clamp and bound runs in the
// coordinates of the anchor's record (K14, :1058-1077): its length and
// index come from the record that owns the pair's scan position, while the
// plane reads use the plane anchor. Hits come out anchor-major, rank-minor
// as rows (pos1, pos2, entry, pair_order, rank, rec), pos1/pos2
// record-local. ops/host_scan.py:101-131 of the JAX package states the
// same semantics in scalar form.
//
// The JAX stage reads a window sized by the margin cap and clamps its row
// gathers; here each (anchor, rank) reads exactly the nibbles of its own
// primer-2 site, and only once the clamps, bounds and rank mask have let
// it through, so no read can leave the record. Ranks past 2*M+1 (runtime
// -M) can never emit and are not launched. Nothing here has a static rank
// count: at -M 10000 an anchor is 20,001 threads, and the wrapper bounds a
// launch by passing the anchors through in chunks (a_idx offset), whose
// rows it concatenates in chunk order, which is (anchor, rank) order.
//
// Bound on the card: launch latency. Anchors are real primer matches (tens
// per 2^23-base tile); each of the anchors x (2M+1) threads reads at most
// 16 plane bytes and one 32-byte primer row. The hit flags are compacted
// in item order (compact.cuh), which is exactly (anchor, rank) order.

#include "compact.cuh"
#include "records.cuh"

namespace {

struct Margin {
  const uint8_t* plane;  // tile plane (packed nibbles, or raw bytes)
  long long n_pos;  // positions in the tile plane
  bool raw;  // one byte per position (K9c)
  const int* a_idx;  // anchor -> pair index
  const int* entry;  // pair -> entry
  const int* ppos;  // pair -> scan position in the tile
  const int* emeta;  // [E, 8]
  const uint8_t* p2_codes;  // [E, p2_max] codes, or primer bytes when raw
  const uint32_t* p2_exp;  // [E, p2_max] IUPAC masks (-I 1); null: -I 0
  const uint8_t* match;  // raw: 256 x 256 match table (-I 1); null: -I 0
  int p2_max;
  long long tile_start;  // plane position of the first scan position
  mp::Records rec;
  int lead;
  int margin;  // runtime -M
  int nmm;
  int three_prime;
};

struct Item {
  int pair, e, rank, rec;
  long long ak, pos2;  // anchor and product end (record-local)
  bool live;  // clamps, bounds and rank mask passed
  long long p2;  // primer-2 site (record-local)
  long long rstart;  // record start in plane coordinates
  int l2;
};

__device__ __forceinline__ Item item_of(long long f, const Margin& m) {
  const int n_ranks = 2 * m.margin + 1;
  Item it;
  const int a = static_cast<int>(f / n_ranks);
  it.rank = static_cast<int>(f % n_ranks);
  it.pair = m.a_idx[a];
  it.e = m.entry[it.pair];
  const int* em = m.emeta + 8LL * it.e;
  const long long hoff = em[0], l1 = em[1], l2 = em[2], exp0 = em[3];
  it.l2 = static_cast<int>(l2);
  const long long gpos = m.tile_start + m.ppos[it.pair];
  const mp::RecordSpan r = mp::record_at(m.rec, gpos);
  const long long ak = gpos - hoff - r.start;  // record-local anchor
  const long long arl = r.len;
  const bool room = arl - (ak + l1) >= l2;  // engine.py:524-525
  const long long actual = arl - ak;
  const bool clamped = exp0 > actual;
  const long long exp = clamped ? actual : exp0;
  const long long hi = clamped ? 0 : min(static_cast<long long>(m.margin), arl - ak - exp);
  const long long lo = max(min(static_cast<long long>(m.margin), exp - l1 - l2), 0LL);
  const int dmag = (it.rank + 1) / 2;
  const int d = (it.rank & 1) ? -dmag : dmag;
  const bool rmask = d == 0 || (d < 0 ? dmag <= lo : dmag <= hi);
  const long long p2 = ak + exp - l2 + d;
  // k + len_p1 <= p2 is checked for d <= 0 only (engine.py:546, 568)
  const bool fits = p2 + l2 <= arl && (d > 0 || p2 >= ak + l1);
  it.rec = r.id;
  it.rstart = r.start;
  it.ak = ak;
  it.p2 = p2;
  it.pos2 = p2 + l2 - 1;
  it.live = room && rmask && fits;
  return it;
}

__device__ __forceinline__ bool p2_ok(const Item& it, const Margin& m) {
  const long long base = it.p2 + it.rstart - m.tile_start + m.lead;
  const long long row = static_cast<long long>(it.e) * m.p2_max;
  const uint8_t* pc = m.p2_codes + row;
  const uint32_t* px = m.p2_exp ? m.p2_exp + row : nullptr;
  int mism = 0;
  for (int i = 0; i < it.l2; ++i) {
    if (!mp::site_match(m.plane, base + i, m.n_pos, m.raw, i, pc, px, m.match)) {
      if (i < m.three_prime) return false;  // '-': first X bases
      ++mism;
    }
  }
  return mism <= m.nmm;
}

__global__ void margin_count_kernel(Margin m, long long n_items,
                                    uint8_t* __restrict__ hit,
                                    int* __restrict__ blk_cnt) {
  const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool h = false;
  if (f < n_items) {
    const Item it = item_of(f, m);
    h = it.live && p2_ok(it, m);
    hit[f] = h;
  }
  const int c = __syncthreads_count(h);
  if (threadIdx.x == 0) blk_cnt[blockIdx.x] = c;
}

__global__ void margin_write_kernel(Margin m, long long n_items,
                                    const uint8_t* __restrict__ hit,
                                    const int* __restrict__ blk_off,
                                    int* __restrict__ rows) {
  __shared__ int warp_sums[32];
  const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int h = (f < n_items && hit[f]) ? 1 : 0;
  int unused;
  const int k = mp::block_exclusive_scan(h, warp_sums, &unused);
  if (!h) return;
  const Item it = item_of(f, m);
  int* row = rows + 6LL * (blk_off[blockIdx.x] + k);
  row[0] = static_cast<int>(it.ak);
  row[1] = static_cast<int>(it.pos2);
  row[2] = it.e;
  row[3] = it.pair;
  row[4] = it.rank;
  row[5] = it.rec;
}

Margin make_margin(const void* plane, long long n_pos, int raw,
                   const void* a_idx, const void* entry, const void* ppos,
                   const void* emeta, const void* p2_codes,
                   const void* p2_exp, const void* match, int p2_max,
                   long long tile_start, const void* rmeta,
                   const void* recmap, long long n_map, int lead, int margin,
                   int nmm, int three_prime) {
  return Margin{static_cast<const uint8_t*>(plane), n_pos, raw != 0,
                static_cast<const int*>(a_idx), static_cast<const int*>(entry),
                static_cast<const int*>(ppos), static_cast<const int*>(emeta),
                static_cast<const uint8_t*>(p2_codes),
                static_cast<const uint32_t*>(p2_exp),
                static_cast<const uint8_t*>(match), p2_max, tile_start,
                mp::Records{static_cast<const int*>(rmeta),
                            static_cast<const int*>(recmap), n_map},
                lead, margin, nmm, three_prime};
}

}  // namespace

extern "C" {

// Count pass + block-sum scan over n_anch * (2 * margin + 1) items: hit
// holds one byte per item, blk_cnt/blk_off n_blocks(items) ints, hit_total
// one int. raw 0: a nibble plane of n_pos positions, p2_codes and (-I 1)
// p2_exp; raw 1: a byte plane of n_pos bytes, p2_codes holding the primer
// bytes and (-I 1) match the 65,536-byte match table. p2_exp/match null:
// -I 0. recmap null: the plane holds record 0 alone.
int mp_margin_count(const void* plane, long long n_pos, int raw,
                    const void* a_idx, int n_anch, const void* entry,
                    const void* ppos, const void* emeta, const void* p2_codes,
                    const void* p2_exp, const void* match, int p2_max,
                    long long tile_start,
                    const void* rmeta, const void* recmap, long long n_map,
                    int lead, int margin, int nmm, int three_prime, void* hit,
                    void* blk_cnt, void* blk_off, void* hit_total,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Margin m = make_margin(plane, n_pos, raw, a_idx, entry, ppos, emeta,
                               p2_codes, p2_exp, match, p2_max, tile_start,
                               rmeta, recmap, n_map, lead, margin, nmm,
                               three_prime);
  const long long n_items = static_cast<long long>(n_anch) * (2 * margin + 1);
  const int nb = mp::n_blocks(n_items);
  margin_count_kernel<<<nb, mp::kBlock, 0, s>>>(
      m, n_items, static_cast<uint8_t*>(hit), static_cast<int*>(blk_cnt));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mp::launch_scan_sums(
      static_cast<const int*>(blk_cnt), nb, static_cast<int*>(blk_off),
      static_cast<int*>(hit_total), s));
}

// Write pass: rows holds hit_total x 6 ints.
int mp_margin_write(const void* plane, long long n_pos, int raw,
                    const void* a_idx, int n_anch, const void* entry,
                    const void* ppos, const void* emeta, const void* p2_codes,
                    const void* p2_exp, const void* match, int p2_max,
                    long long tile_start,
                    const void* rmeta, const void* recmap, long long n_map,
                    int lead, int margin, int nmm, int three_prime,
                    const void* hit,
                    const void* blk_off, void* rows, void* stream) {
  const Margin m = make_margin(plane, n_pos, raw, a_idx, entry, ppos, emeta,
                               p2_codes, p2_exp, match, p2_max, tile_start,
                               rmeta, recmap, n_map, lead, margin, nmm,
                               three_prime);
  const long long n_items = static_cast<long long>(n_anch) * (2 * margin + 1);
  margin_write_kernel<<<mp::n_blocks(n_items), mp::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      m, n_items, static_cast<const uint8_t*>(hit),
      static_cast<const int*>(blk_off), static_cast<int*>(rows));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
