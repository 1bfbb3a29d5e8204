// verify_p1: primer-1 verify of every candidate pair, then the anchors.
//
// Replaces merpcr_tpu/ops/scan.py::_scan_tile_impl stage K6, the primer-1
// verify (scan.py:979-1045, _row_window :350-382): per pair, the entry's
// emeta row, the anchor k = position - hash_offset, the record that owns
// the scan position and the bounds in that record's coordinates (K14,
// :985-1010), then the genome's 4-bit codes against the primer over the
// primer length (code equality, or at -I 1 the IUPAC expansion-set test
// of K11, :1020-1022) with the mismatch budget and the '+' strand's
// last-X-bases protection. The passing pairs, in pair order, are the
// anchors; an anchor's pair index is its emission key pair_order. The byte
// mode (K9c, :1026-1031) reads a raw-byte plane and compares genome bytes
// with the primer bytes, case-insensitively at -I 0 and through the
// reference's 256 x 256 match table at -I 1; everything else is the same.
//
// Bound on the card: launch latency. A pair reads one 32-byte emeta row, a
// few plane words and one primer row, and pairs are few (hundreds per
// 2^23-base tile). So the whole call is one launch: one thread per pair,
// and the passing pairs are compacted in pair order in the same launch by
// the single-pass look-back scan of compact.cuh; the last tile writes
// anch_total straight into the caller's pinned host word. In the deferred
// mode of the tile scan the pair count is the one expand left on the
// device and anch_total goes to device memory, so no stage of a tile waits
// for the host; the launch then covers the pair buffer's capacity.
//
// The compare at -I 0 on a nibble plane (the main path) takes 16 bases
// per step (nibwords.cuh, shared with margin_p2: the window funnel-shifted
// out of the plane's 64-bit words against the primer packed from 8-byte
// loads of its row); -I 1 (an expansion-set test per base) and the byte
// modes compare site by site (records.cuh site_match).

#include "compact.cuh"
#include "nibwords.cuh"
#include "records.cuh"

namespace {

struct Verify1 {
  const uint8_t* plane;  // tile plane (packed nibbles, or raw bytes)
  long long n_pos;  // positions in the tile plane
  bool raw;  // one byte per position (K9c)
  const int* emeta;  // [E, 8]
  const uint8_t* p1_codes;  // [E, p1_max] codes, or primer bytes when raw
  const uint32_t* p1_exp;  // [E, p1_max] IUPAC masks (-I 1); null: -I 0
  const uint8_t* match;  // raw: 256 x 256 match table (-I 1); null: -I 0
  int p1_max;
  long long tile_start;  // plane position of the first scan position
  mp::Records rec;
  int lead;  // tile index of the first scan position
  int nmm;  // mismatch budget (-N)
  int three_prime;  // protected 3' bases (-X)
};

// -I 0 on a nibble plane, 16 bases per step (nibwords.cuh): does the
// window of l1 bases at tile position kl match row pc within the budget
// and the '+' strand's protection of the last X bases?
__device__ __forceinline__ bool p1_words_ok(long long kl, int l1,
                                            const uint8_t* pc,
                                            const Verify1& v) {
  // the plane as 64-bit words from the 8-byte boundary at or below it
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(v.plane) & 7u);
  const uint64_t* words = reinterpret_cast<const uint64_t*>(v.plane - mis);
  const long long q_max = (v.n_pos - 1 + 2 * mis) >> 4;  // last word in the plane
  const auto word = [&](long long q) -> uint64_t {
    return (q < 0 || q > q_max) ? 0ull : words[q];
  };
  return mp::window_words_ok(word, mis, v.n_pos, kl, l1, pc, v.p1_max,
                             l1 - v.three_prime, l1, v.nmm);
}

__device__ __forceinline__ bool p1_ok(int e, int pos, const Verify1& v) {
  const int* em = v.emeta + 8LL * e;
  const int hoff = em[0], l1 = em[1];
  const mp::RecordSpan r = mp::record_at(v.rec, v.tile_start + pos);
  const long long kg = v.tile_start + pos - hoff - r.start;  // record-local
  if (kg < 0 || kg + l1 > r.len) return false;  // scan.py:1010
  const long long kl = static_cast<long long>(pos) - hoff + v.lead;
  const long long row = static_cast<long long>(e) * v.p1_max;
  const uint8_t* pc = v.p1_codes + row;
  if (!v.raw && !v.p1_exp) return p1_words_ok(kl, l1, pc, v);
  const uint32_t* px = v.p1_exp ? v.p1_exp + row : nullptr;
  int mism = 0;
  for (int i = 0; i < l1; ++i) {
    if (!mp::site_match(v.plane, kl + i, v.n_pos, v.raw, i, pc, px, v.match)) {
      if (i >= l1 - v.three_prime) return false;  // '+': last X bases
      ++mism;
    }
  }
  return mism <= v.nmm;
}

// One thread per pair of a ticketed tile; the passing pair indices go to
// a_idx in pair order. The blocks loop over the tiles of the live pairs
// (compact.cuh live_items: the host's n, or the count on the device); the
// last tile writes anch_total, and the last failing ticket puts the ticket
// back to 0.
__global__ void verify_p1_kernel(const int* __restrict__ entry,
                                 const int* __restrict__ ppos, int n_host,
                                 const int* __restrict__ n_dev, int cap,
                                 Verify1 v, mp::ScanState ss,
                                 int* __restrict__ a_idx,
                                 int* __restrict__ anch_total) {
  __shared__ int warp_sums[32];
  __shared__ unsigned int tile_sh, excl_sh;
  const int n = mp::live_items(n_dev, n_host, cap);
  const unsigned int n_tiles = (n + mp::kBlock - 1) / mp::kBlock;
  const unsigned int workers = min(gridDim.x, n_tiles);
  if (blockIdx.x >= workers) {
    if (n_tiles == 0 && blockIdx.x == 0 && threadIdx.x == 0) *anch_total = 0;
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
    const int i = static_cast<int>(tile) * mp::kBlock + threadIdx.x;
    const int pass = (i < n && p1_ok(entry[i], ppos[i], v)) ? 1 : 0;
    int agg;
    const int local = mp::block_exclusive_scan(pass, warp_sums, &agg);
    if (threadIdx.x < 32) {  // warp 0 looks back
      const unsigned int excl = mp::look_back(ss, tile, static_cast<unsigned int>(agg));
      if (threadIdx.x == 0) {
        excl_sh = excl;
        if (tile == n_tiles - 1) *anch_total = static_cast<int>(excl) + agg;
      }
    }
    __syncthreads();
    if (pass) a_idx[excl_sh + local] = i;
    __syncthreads();  // tile_sh and excl_sh are read before the next tile
  }
}

}  // namespace

extern "C" {

// One launch: a_idx holds n ints (the anchors' pair indices, ascending, in
// its first *anch_total entries); anch_total is one int that the kernel
// writes, host-mapped pinned memory in the count-first wrapper. n_dev
// null: n pairs; else the deferred mode: *n_dev pairs, read on the device,
// at most n (the buffers' capacity), and anch_total a device int. raw 0: a
// nibble plane of n_pos positions, p1_codes (rows of p1_max bytes, p1_max
// a multiple of 8, 8-byte aligned) and (-I 1) p1_exp; raw 1: a byte plane
// of n_pos bytes, p1_codes holding the primer bytes and (-I 1) match the
// 65,536-byte match table. p1_exp/match null: -I 0. recmap null: the plane
// holds record 0 alone. ticket/status/seq: the device's scan state
// (compact.cuh ScanState), status holding n_blocks(n) entries. Grid:
// compact.cuh loop_grid.
int mp_verify_p1(const void* plane, long long n_pos, int raw,
                 const void* entry, const void* ppos, int n, const void* n_dev,
                 const void* emeta, const void* p1_codes, const void* p1_exp,
                 const void* match, int p1_max, long long tile_start,
                 const void* rmeta, const void* recmap, long long n_map,
                 int lead, int nmm, int three_prime, void* ticket,
                 void* status, int seq, void* a_idx, void* anch_total,
                 void* stream) {
  const Verify1 v = {static_cast<const uint8_t*>(plane), n_pos, raw != 0,
                     static_cast<const int*>(emeta),
                     static_cast<const uint8_t*>(p1_codes),
                     static_cast<const uint32_t*>(p1_exp),
                     static_cast<const uint8_t*>(match), p1_max, tile_start,
                     mp::Records{static_cast<const int*>(rmeta),
                                 static_cast<const int*>(recmap), n_map},
                     lead, nmm, three_prime};
  const mp::ScanState ss = {static_cast<unsigned int*>(ticket),
                            static_cast<unsigned long long*>(status),
                            static_cast<unsigned int>(seq)};
  const int grid = mp::loop_grid(verify_p1_kernel, mp::kBlock, 0, mp::n_blocks(n), n_dev);
  verify_p1_kernel<<<grid, mp::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(entry), static_cast<const int*>(ppos), n,
      static_cast<const int*>(n_dev), n, v, ss, static_cast<int*>(a_idx),
      static_cast<int*>(anch_total));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
