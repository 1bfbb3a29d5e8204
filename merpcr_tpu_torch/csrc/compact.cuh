// Order-preserving compaction shared by the expand, verify_p1 and
// margin_p2 kernels.
//
// Every compaction here is reduce-then-scan: a count pass writes one sum
// per block, one single-block kernel turns the block sums into exclusive
// block offsets (and the total), and a write pass places each thread's
// items at its block offset plus its exclusive offset inside the block.
// Output order therefore follows the item index exactly, run after run.
// Slot claims by atomicAdd would make the order depend on scheduling, and
// the emitted hit order (pair_order, rank) is part of the output contract.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// Write pass of a flag compaction: out[k] = i for the k-th set flag, in
// ascending i. `blk_off` holds the exclusive block offsets of the counts
// that the count pass wrote with the same kBlock decomposition.
__global__ void compact_flags_kernel(const uint8_t* __restrict__ flags, int n,
                                     const int* __restrict__ blk_off,
                                     int* __restrict__ out) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int f = (i < n && flags[i]) ? 1 : 0;
  int unused;
  const int e = block_exclusive_scan(f, warp_sums, &unused);
  if (f) out[blk_off[blockIdx.x] + e] = i;
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

}  // namespace mp
