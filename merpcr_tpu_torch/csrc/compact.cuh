// Order-preserving compaction shared by the expand, verify_p1 and
// margin_p2 kernels.
//
// Output order follows the item index exactly, run after run. Slot claims
// by atomicAdd would make the order depend on scheduling, and the emitted
// hit order (pair_order, rank) is part of the output contract. Two schemes:
//
// * reduce-then-scan (margin_p2): a count pass writes one sum per block,
//   one single-block kernel turns the block sums into exclusive block
//   offsets (and the total), and a write pass places each thread's items
//   at its block offset plus its exclusive offset inside the block;
// * single pass (expand, verify_p1): decoupled look-back (Merrill and
//   Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
//   NVIDIA 2016). A block takes its tile from an atomic ticket, so every
//   tile it waits on belongs to a block that already runs (forward
//   progress); it publishes its tile's sum, walks back over the published
//   sums of earlier tiles until it meets an inclusive prefix, and publishes
//   its own inclusive prefix. The tile statuses carry the launch's sequence
//   number, so no launch has to clear them; the ticket counters are put
//   back to 0 by the launch that used them. verify_p1 and margin_p2 loop
//   over their tiles (live_items below), so that a launch over a buffer's
//   capacity, whose count is on the device, needs no more blocks than the
//   card holds.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace mp {

constexpr int kBlock = 256;      // threads per block of every count/write pass
constexpr int kScanBlock = 1024; // threads of the single-block sum scan

// Exclusive prefix sum of one int per thread across the block. Returns the
// thread's exclusive offset and stores the block's total in *total. Every
// thread of the block must call it (it synchronises); blockDim.x must be a
// multiple of 32 and at most 1024. `warp_sums` is 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive per warp
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused once every thread has read it
  return before + x - v;
}

// Single block: excl[i] = in[0] + ... + in[i-1]; *total = sum of in[0..n).
__global__ void scan_sums_kernel(const int* __restrict__ in, int n,
                                 int* __restrict__ excl,
                                 int* __restrict__ total) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? in[i] : 0;
    int chunk;
    const int e = block_exclusive_scan(v, warp_sums, &chunk);
    if (i < n) excl[i] = carry + e;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

static inline cudaError_t launch_scan_sums(const int* in, int n, int* excl,
                                           int* total, cudaStream_t stream) {
  scan_sums_kernel<<<1, kScanBlock, 0, stream>>>(in, n, excl, total);
  return cudaGetLastError();
}

static inline int n_blocks(long long n) {
  return static_cast<int>((n + kBlock - 1) / kBlock);
}

// 4-bit letter code at position p of a packed nibble plane of n_pos
// positions (low nibble = even position). Positions outside the plane read
// as 0xFF, which equals no primer code, so an unexpected out-of-plane read
// can only fail a match, never fake one.
__device__ __forceinline__ uint32_t nibble_at(const uint8_t* __restrict__ plane,
                                              long long p, long long n_pos) {
  if (p < 0 || p >= n_pos) return 0xFFu;
  const uint32_t b = plane[p >> 1];
  return (p & 1) ? (b >> 4) : (b & 15u);
}

// Shared state of the single-pass scans of one device (ops/kernels.py
// ScanState): ticket[0] hands out tiles, ticket[1] collects a sum in any
// order (expand's lanes); the launch's last tile puts both back to 0. Each
// front end uses the two as one 64-bit counter (its sum and its finished
// blocks) and leaves its flag count in ticket[kFlagSlot], which expand's
// last tile hands to the host with its totals and clears.
// status[t] = value | kInclusive | seq << 33 once tile t has published
// (value: the tile's sum, or with kInclusive the sum of tiles 0..t); an
// entry with another seq is not published yet. seq runs 1 .. 2^31 - 1,
// and the buffer starts zeroed, so no stale entry ever matches.
constexpr int kFlagSlot = 2;

struct ScanState {
  unsigned int* ticket;
  unsigned long long* status;
  unsigned int seq;
};

constexpr unsigned long long kInclusive = 1ull << 32;

__device__ __forceinline__ void publish(const ScanState& s, unsigned int t,
                                        unsigned int v, bool inclusive) {
  volatile unsigned long long* st = s.status;
  st[t] = static_cast<unsigned long long>(v) | (inclusive ? kInclusive : 0ull) |
          (static_cast<unsigned long long>(s.seq) << 33);
}

// The next tile of this launch (thread 0 of a block calls it).
__device__ __forceinline__ unsigned int take_tile(const ScanState& s) {
  return atomicAdd(s.ticket, 1u);
}

// Exclusive prefix of tile t whose own sum is `agg` (the same in every
// lane), by decoupled look-back; publishes tile t's inclusive prefix. The
// 32 lanes of one warp call it: each pass reads the statuses of the 32
// tiles before the window's end, waits until all are published, and stops
// at the nearest inclusive one (before tile 0 counts as an inclusive 0).
__device__ __forceinline__ unsigned int look_back(const ScanState& s,
                                                  unsigned int t,
                                                  unsigned int agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) publish(s, 0, agg, true);
    return 0;
  }
  if (lane == 0) publish(s, t, agg, false);
  volatile unsigned long long* st = s.status;
  unsigned int excl = 0;
  long long end = static_cast<long long>(t) - 1;  // the window's newest tile
  while (true) {
    const long long j = end - lane;
    unsigned long long v = 0;
    bool ready = true, inclusive = true;
    if (j >= 0) {
      v = st[j];
      ready = static_cast<unsigned int>(v >> 33) == s.seq;
      inclusive = (v & kInclusive) != 0;
    }
    if (!__all_sync(0xffffffffu, ready)) continue;  // a tile not yet published
    const unsigned int incl = __ballot_sync(0xffffffffu, inclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl += __reduce_add_sync(0xffffffffu,
                              j >= 0 && lane <= stop ? static_cast<unsigned int>(v) : 0u);
    if (incl) break;
    end -= 32;
  }
  if (lane == 0) publish(s, t, excl + agg, true);
  return excl;
}

// Launches that loop over their tiles (verify_p1, margin_p2). The live
// item count is the host's n, or in the deferred tile scan the count an
// earlier kernel of the stream left in device memory (n_dev), at most the
// buffer's cap: the host reads nothing between the stages. Blocks below
// min(gridDim.x, tiles) are the workers: each takes tiles from the ticket
// until one past the last, so `workers` tickets fail; blocks at or past
// that exit at once. The block holding the last failing ticket puts the
// ticket back to 0: every worker has taken its last ticket by then.
__device__ __forceinline__ int live_items(const int* n_dev, int n, int cap) {
  return n_dev ? min(max(*n_dev, 0), cap) : n;
}

__device__ __forceinline__ void release_ticket(const ScanState& s,
                                               unsigned int ticket,
                                               unsigned int n_tiles,
                                               unsigned int workers) {
  if (ticket == n_tiles + workers - 1) s.ticket[0] = 0u;
}

// Blocks of such a launch over n_tiles tiles: one per tile when the host
// knows the count (n_dev null), else (the deferred mode, a launch over a
// buffer's capacity) as many as the device holds at once, occupancy x SMs,
// at most n_tiles, the blocks then looping; at least 1. The occupancy is
// queried once per (device, kernel, threads, shared memory) and kept.
template <typename Kernel>
static inline int loop_grid(Kernel kernel, int threads, size_t smem,
                            long long n_tiles, const void* n_dev) {
  long long g = n_tiles;
  if (n_dev != nullptr) {
    struct Fit {
      int dev, threads;
      size_t smem;
      int blocks;
    };
    static std::mutex mu;
    static std::vector<Fit> known;
    int dev = 0;
    cudaGetDevice(&dev);
    int blocks = 0;
    {
      std::lock_guard<std::mutex> lock(mu);
      for (const Fit& k : known)
        if (k.dev == dev && k.threads == threads && k.smem == smem) blocks = k.blocks;
      if (blocks == 0) {
        int sms = 1, per_sm = 1;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        blocks = max(per_sm, 1) * max(sms, 1);
        known.push_back({dev, threads, smem, blocks});
      }
    }
    g = min(g, static_cast<long long>(blocks));
  }
  return static_cast<int>(max(g, 1LL));
}

}  // namespace mp
