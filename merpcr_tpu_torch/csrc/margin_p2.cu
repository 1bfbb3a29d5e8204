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
// Bound on the card: launch latency at small margins (anchors are real
// primer matches, tens per 2^23-base tile), the rank compares at large
// ones. So the whole call is one launch, and each block works on one
// anchor, taken in ticket order (cutting an anchor's ranks over several
// blocks measured slower: blocks of 1,024 threads fit one per SM, so the
// extra blocks ran in waves, each paying the anchor's chain of loads):
//
// * the anchor's emeta row, record, clamps and bounds once per block. The
//   rank mask and the bounds are monotone in |d|, so the live offsets are
//   one range d = -lo .. hi (d = 0 live only when the product holds both
//   primers), and only those ranks are visited, in rank order;
// * the primer-2 sites of the live range, 2M + len_p2 bases at most, staged
//   once in shared memory with coalesced loads (64-bit words of a nibble
//   plane, bytes of a raw one); positions outside the plane read as
//   mismatches, as in the plain version;
// * at -I 0 on a nibble plane 16 bases per compare (nibwords.cuh, shared
//   with verify_p1) on the staged words, the first-X protection a mask; at
//   -I 1 and in the byte modes site by site on the staged window (at -I 1
//   against a per-base mask of the matching genome codes, made once);
// * hit bits kept in shared memory, the anchor's row base from the
//   single-pass look-back scan of compact.cuh (anchor order is ticket
//   order), and the rows written in rank order. The last anchor's block
//   writes hit_total into the caller's pinned host word.
//
// Rows go into a buffer of `cap` rows that the host sizes; a hit_total
// above it takes a second launch into a buffer of exactly hit_total rows.

#include "compact.cuh"
#include "nibwords.cuh"
#include "records.cuh"

namespace {

constexpr int kMaxThreads = 1024;

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

// One anchor in the coordinates of its record. Its live offsets (clamps,
// bounds and rank mask passed) are d = -lo .. -1, 0 when d0, and 1 .. hi.
struct Anchor {
  int pair, e, rec, l2, lo, hi, n_live;
  bool d0;
  long long ak;  // record-local anchor
  long long base;  // record-local primer-2 site at d = 0
  long long tbase;  // ... as a tile position
};

__device__ __forceinline__ Anchor anchor_of(int a, const Margin& m) {
  Anchor an;
  an.pair = m.a_idx[a];
  an.e = m.entry[an.pair];
  const int* em = m.emeta + 8LL * an.e;
  const long long hoff = em[0], l1 = em[1], l2 = em[2], exp0 = em[3];
  an.l2 = static_cast<int>(l2);
  const long long gpos = m.tile_start + m.ppos[an.pair];
  const mp::RecordSpan r = mp::record_at(m.rec, gpos);
  const long long ak = gpos - hoff - r.start;  // record-local anchor
  const long long arl = r.len;
  const bool room = arl - (ak + l1) >= l2;  // engine.py:524-525
  const long long actual = arl - ak;
  const bool clamped = exp0 > actual;
  const long long exp = clamped ? actual : exp0;
  const long long M = m.margin;
  // d > 0: the rank mask d <= hi implies p2 + l2 <= arl; d < 0: -d <= lo
  // implies p2 >= ak + l1 (checked for d <= 0 only, engine.py:546, 568);
  // d = 0: always masked in, in bounds iff exp >= l1 + l2
  an.hi = room && !clamped ? static_cast<int>(min(M, arl - ak - exp)) : 0;
  an.lo = room ? static_cast<int>(max(min(M, exp - l1 - l2), 0LL)) : 0;
  an.d0 = room && exp >= l1 + l2;
  an.n_live = (an.d0 ? 1 : 0) + an.lo + an.hi;
  an.rec = r.id;
  an.ak = ak;
  an.base = ak + exp - l2;
  an.tbase = an.base + r.start - m.tile_start + m.lead;
  return an;
}

// Live index j (0 .. n_live-1, ascending rank) -> rank, and its offset d.
__device__ __forceinline__ int rank_of(int j, const Anchor& an, int* d) {
  if (an.d0) {
    if (j == 0) {
      *d = 0;
      return 0;
    }
    --j;
  }
  const int both = min(an.lo, an.hi);  // d = -both .. both: ranks 1 .. 2 both
  if (j < 2 * both) {
    const int r = j + 1, dmag = (r + 1) / 2;
    *d = (r & 1) ? -dmag : dmag;
    return r;
  }
  const int k = both + 1 + (j - 2 * both);  // one sign only past that
  *d = an.lo > an.hi ? -k : k;
  return an.lo > an.hi ? 2 * k - 1 : 2 * k;
}

// The staged window: tile positions w0 .. w0 + wlen - 1 (every live site),
// as the plane's 64-bit words q0 .. q1 (nibble plane) or its bytes (raw).
struct Window {
  long long w0, q0, q1;
  int mis;  // the plane's offset from the 8-byte boundary below it
  const uint64_t* words;
  const uint8_t* bytes;
  const uint32_t* codes_ok;  // -I 1: bit n of [i] = genome code n matches base i
};

__device__ __forceinline__ bool p2_ok(long long s, const Anchor& an,
                                      const Window& w, const Margin& m) {
  const long long row = static_cast<long long>(an.e) * m.p2_max;
  const uint8_t* pc = m.p2_codes + row;
  if (!m.raw && !m.p2_exp) {
    const auto word = [&](long long q) -> uint64_t {
      return (q < w.q0 || q > w.q1) ? 0ull : w.words[q - w.q0];
    };
    // '-': the first X bases admit no mismatch
    return mp::window_words_ok(word, w.mis, m.n_pos, s, an.l2, pc, m.p2_max, 0,
                               m.three_prime, m.nmm);
  }
  int mism = 0;
  for (int i = 0; i < an.l2; ++i) {
    const long long p = s + i;
    const bool in = p >= 0 && p < m.n_pos;
    bool ok;
    if (m.raw) {
      ok = mp::byte_match(in ? static_cast<int>(w.bytes[p - w.w0]) : -1, pc[i], m.match);
    } else {
      ok = false;  // off the plane: a mismatch
      if (in) {
        const long long a = p + 2 * w.mis;
        const uint32_t nib =
            static_cast<uint32_t>(w.words[(a >> 4) - w.q0] >> (4 * (a & 15))) & 15u;
        ok = (w.codes_ok[i] >> nib) & 1u;
      }
    }
    if (!ok) {
      if (i < m.three_prime) return false;  // '-': first X bases
      if (++mism > m.nmm) return false;
    }
  }
  return true;
}

// One anchor per block at a time (ticket order), the blocks looping over
// the live anchors (compact.cuh live_items: the host's count, or in the
// deferred mode the count verify_p1 left on the device). smem: n_win 64-bit
// words of window, at -I 1 on a nibble plane the codes_ok mask of each
// primer base (p2_max words; a table lookup per lane in __constant__
// kExpNib would serialise over the distinct codes of a warp), then the hit
// bits of the live ranks (one 32-bit word per warp and strip).
__global__ void __launch_bounds__(kMaxThreads)
margin_p2_kernel(Margin m, int n_host, const int* __restrict__ n_dev, int a_cap,
                 int n_win, mp::ScanState ss, int* __restrict__ rows, int cap,
                 int* __restrict__ hit_total) {
  extern __shared__ uint64_t smem[];
  uint32_t* codes_ok = reinterpret_cast<uint32_t*>(smem + n_win);
  uint32_t* bits = codes_ok + (m.p2_max + 1) / 2 * 2;
  __shared__ int warp_sums[32];
  __shared__ unsigned int tile_sh, excl_sh;
  const unsigned int n_tiles =
      static_cast<unsigned int>(mp::live_items(n_dev, n_host, a_cap));  // anchors
  const unsigned int workers = min(gridDim.x, n_tiles);
  if (blockIdx.x >= workers) {
    if (n_tiles == 0 && blockIdx.x == 0 && threadIdx.x == 0) *hit_total = 0;
    return;
  }
  while (true) {
    if (threadIdx.x == 0) tile_sh = mp::take_tile(ss);
    __syncthreads();
    const unsigned int tile = tile_sh;
    if (tile >= n_tiles) {
      if (threadIdx.x == 0) mp::release_ticket(ss, tile, n_tiles, workers);
      return;
    }
    const Anchor an = anchor_of(static_cast<int>(tile), m);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int cnt = 0;
    if (an.n_live) {
      Window w;
      const int dmin = an.lo ? -an.lo : (an.d0 ? 0 : 1);
      const int dmax = an.hi ? an.hi : (an.d0 ? 0 : -1);
      const long long wlen = dmax - dmin + an.l2;
      w.w0 = an.tbase + dmin;
      w.mis = static_cast<int>(reinterpret_cast<uintptr_t>(m.plane) & 7u);
      w.words = smem;
      w.bytes = reinterpret_cast<const uint8_t*>(smem);
      w.codes_ok = codes_ok;
      if (m.p2_exp && !m.raw) {
        const uint32_t* px = m.p2_exp + static_cast<long long>(an.e) * m.p2_max;
        for (int i = threadIdx.x; i < an.l2; i += blockDim.x) {
          uint32_t ok = 0;
#pragma unroll
          for (int n = 0; n < 16; ++n) ok |= static_cast<uint32_t>((mp::kExpNib[n] & px[i]) != 0u) << n;
          codes_ok[i] = ok;
        }
      }
      if (m.raw) {
        uint8_t* sb = reinterpret_cast<uint8_t*>(smem);
        for (long long i = threadIdx.x; i < wlen; i += blockDim.x) {
          const long long p = w.w0 + i;
          sb[i] = (p < 0 || p >= m.n_pos) ? 0 : m.plane[p];
        }
      } else {
        const uint64_t* gw = reinterpret_cast<const uint64_t*>(m.plane - w.mis);
        const long long q_max = (m.n_pos - 1 + 2 * w.mis) >> 4;  // last word in the plane
        w.q0 = mp::floor16(w.w0 + 2 * w.mis);
        w.q1 = mp::floor16(w.w0 + wlen - 1 + 2 * w.mis) + 1;  // the funnel's next word
        for (long long i = threadIdx.x; i <= w.q1 - w.q0; i += blockDim.x) {
          const long long q = w.q0 + i;
          smem[i] = (q < 0 || q > q_max) ? 0ull : gw[q];
        }
      }
      __syncthreads();
      for (int j0 = 0; j0 < an.n_live; j0 += blockDim.x) {  // strips, in rank order
        const int j = j0 + threadIdx.x;
        bool hit = false;
        if (j < an.n_live) {
          int d;
          rank_of(j, an, &d);
          hit = p2_ok(an.tbase + d, an, w, m);
        }
        const unsigned int b = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) bits[(j0 >> 5) + warp] = b;
        cnt += hit;
      }
    }
    int agg;
    mp::block_exclusive_scan(cnt, warp_sums, &agg);  // also publishes bits
    if (threadIdx.x < 32) {  // warp 0 looks back
      const unsigned int excl = mp::look_back(ss, tile, static_cast<unsigned int>(agg));
      if (threadIdx.x == 0) {
        excl_sh = excl;
        if (tile == n_tiles - 1) *hit_total = static_cast<int>(excl) + agg;
      }
    }
    __syncthreads();
    if (agg) {
      const int n_words = (an.n_live + 31) >> 5;
      int carry = static_cast<int>(excl_sh);
      for (int w0 = 0; w0 < n_words; w0 += blockDim.x) {
        const int wi = w0 + threadIdx.x;
        uint32_t b = wi < n_words ? bits[wi] : 0u;
        int chunk;
        int k = carry + mp::block_exclusive_scan(__popc(b), warp_sums, &chunk);
        for (; b; b &= b - 1, ++k) {
          if (k >= cap) break;  // past the buffer: the caller sizes a second one
          int d;
          const int r = rank_of(32 * wi + __ffs(b) - 1, an, &d);
          int* row = rows + 6LL * k;
          row[0] = static_cast<int>(an.ak);
          row[1] = static_cast<int>(an.base + d + an.l2 - 1);
          row[2] = an.e;
          row[3] = an.pair;
          row[4] = r;
          row[5] = an.rec;
        }
        carry += chunk;
      }
    }
    __syncthreads();  // shared memory is read before the next anchor
  }
}

}  // namespace

extern "C" {

// One launch over n_anch anchors, a block at a time each: rows holds cap
// x 6 ints, the first min(hit_total, cap) rows of the call in (anchor,
// rank) order; hit_total is one int that the kernel writes, host-mapped
// pinned memory in the count-first wrapper. n_dev null: n_anch anchors;
// else the deferred mode: *n_dev anchors, read on the device, at most
// n_anch (a_idx's capacity), and hit_total a device int. raw 0: a nibble
// plane of n_pos positions, p2_codes (rows of p2_max bytes, p2_max a
// multiple of 8, 8-byte aligned) and (-I 1) p2_exp; raw 1: a byte plane of
// n_pos bytes, p2_codes holding the primer bytes and (-I 1) match the
// 65,536-byte match table. p2_exp/match null: -I 0. recmap null: the plane
// holds record 0 alone. ticket/status/seq: the device's scan state
// (compact.cuh ScanState), status holding n_anch entries. Grid:
// compact.cuh loop_grid (a block per anchor, or in the deferred mode as
// many as the card holds at once, looping over the anchors).
int mp_margin_p2(const void* plane, long long n_pos, int raw,
                 const void* a_idx, int n_anch, const void* n_dev,
                 const void* entry, const void* ppos, const void* emeta,
                 const void* p2_codes, const void* p2_exp, const void* match,
                 int p2_max, long long tile_start, const void* rmeta,
                 const void* recmap, long long n_map, int lead, int margin,
                 int nmm, int three_prime, void* ticket, void* status,
                 int seq, void* rows, int cap, void* hit_total,
                 void* stream) {
  const Margin m = {static_cast<const uint8_t*>(plane), n_pos, raw != 0,
                    static_cast<const int*>(a_idx), static_cast<const int*>(entry),
                    static_cast<const int*>(ppos), static_cast<const int*>(emeta),
                    static_cast<const uint8_t*>(p2_codes),
                    static_cast<const uint32_t*>(p2_exp),
                    static_cast<const uint8_t*>(match), p2_max, tile_start,
                    mp::Records{static_cast<const int*>(rmeta),
                                static_cast<const int*>(recmap), n_map},
                    lead, margin, nmm, three_prime};
  const mp::ScanState ss = {static_cast<unsigned int*>(ticket),
                            static_cast<unsigned long long*>(status),
                            static_cast<unsigned int>(seq)};
  const int n_ranks = 2 * margin + 1;
  const int threads = n_ranks >= kMaxThreads ? kMaxThreads : (n_ranks + 31) / 32 * 32;
  // window: every live site lies in 2M + p2_max positions
  const long long span = 2LL * margin + p2_max;
  const int n_win = raw ? static_cast<int>((span + 7) / 8) : static_cast<int>(span / 16 + 4);
  const int n_bits = (n_ranks + threads - 1) / threads * (threads / 32);
  const size_t smem = 8 * static_cast<size_t>(n_win) +
                      4 * static_cast<size_t>((p2_max + 1) / 2 * 2 + n_bits);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        margin_p2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = mp::loop_grid(margin_p2_kernel, threads, smem, n_anch, n_dev);
  margin_p2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, n_anch, static_cast<const int*>(n_dev), n_anch, n_win, ss,
      static_cast<int*>(rows), cap, static_cast<int*>(hit_total));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
