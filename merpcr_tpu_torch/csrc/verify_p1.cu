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
// Bound on the card: memory latency of small gathers. A pair reads one
// 32-byte emeta row, at most 16 plane bytes and one primer row; pairs are
// few (hundreds per 2^23-base tile), so the kernel is launch-bound. One
// thread per pair, then the shared order-preserving compaction
// (compact.cuh) over one flag byte per pair. The record lookup adds two
// dependent 4-byte gathers per pair (recmap, then rmeta).

#include "compact.cuh"
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

__device__ __forceinline__ bool p1_ok(int e, int pos, const Verify1& v) {
  const int* em = v.emeta + 8LL * e;
  const int hoff = em[0], l1 = em[1];
  const mp::RecordSpan r = mp::record_at(v.rec, v.tile_start + pos);
  const long long kg = v.tile_start + pos - hoff - r.start;  // record-local
  if (kg < 0 || kg + l1 > r.len) return false;  // scan.py:1010
  const long long kl = static_cast<long long>(pos) - hoff + v.lead;
  const long long row = static_cast<long long>(e) * v.p1_max;
  const uint8_t* pc = v.p1_codes + row;
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

__global__ void verify_p1_count_kernel(const int* __restrict__ entry,
                                       const int* __restrict__ ppos, int n,
                                       Verify1 v, uint8_t* __restrict__ ok,
                                       int* __restrict__ blk_cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool pass = i < n && p1_ok(entry[i], ppos[i], v);
  if (i < n) ok[i] = pass;
  const int c = __syncthreads_count(pass);
  if (threadIdx.x == 0) blk_cnt[blockIdx.x] = c;
}

}  // namespace

extern "C" {

// Count pass + block-sum scan: ok holds n bytes, blk_cnt/blk_off hold
// n_blocks(n) ints, anch_total one int. raw 0: a nibble plane of n_pos
// positions, p1_codes and (-I 1) p1_exp; raw 1: a byte plane of n_pos
// bytes, p1_codes holding the primer bytes and (-I 1) match the 65,536-byte
// match table. p1_exp/match null: -I 0. recmap null: the plane holds
// record 0 alone.
int mp_verify_p1_count(const void* plane, long long n_pos, int raw,
                       const void* entry, const void* ppos, int n,
                       const void* emeta, const void* p1_codes,
                       const void* p1_exp, const void* match, int p1_max,
                       long long tile_start, const void* rmeta,
                       const void* recmap, long long n_map, int lead,
                       int nmm, int three_prime, void* ok, void* blk_cnt,
                       void* blk_off, void* anch_total, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Verify1 v = {static_cast<const uint8_t*>(plane), n_pos, raw != 0,
                     static_cast<const int*>(emeta),
                     static_cast<const uint8_t*>(p1_codes),
                     static_cast<const uint32_t*>(p1_exp),
                     static_cast<const uint8_t*>(match), p1_max, tile_start,
                     mp::Records{static_cast<const int*>(rmeta),
                                 static_cast<const int*>(recmap), n_map},
                     lead, nmm, three_prime};
  const int nb = mp::n_blocks(n);
  verify_p1_count_kernel<<<nb, mp::kBlock, 0, s>>>(
      static_cast<const int*>(entry), static_cast<const int*>(ppos), n, v,
      static_cast<uint8_t*>(ok), static_cast<int*>(blk_cnt));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(mp::launch_scan_sums(
      static_cast<const int*>(blk_cnt), nb, static_cast<int*>(blk_off),
      static_cast<int*>(anch_total), s));
}

// Write pass: a_idx holds anch_total ints (pair indices, ascending).
int mp_verify_p1_write(const void* ok, int n, const void* blk_off,
                       void* a_idx, void* stream) {
  mp::compact_flags_kernel<<<mp::n_blocks(n), mp::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ok), n, static_cast<const int*>(blk_off),
      static_cast<int*>(a_idx));
  return static_cast<int>(cudaGetLastError());
}

const char* mp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
