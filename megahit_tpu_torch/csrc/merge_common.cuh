// Shared device code of the two merge kernels (merge_pairs.cu,
// merge_path.cu): 48-bit keys as a u32 `hi` plane and a u16 `lo` plane,
// compared as the u64 (hi << 16) | lo, ascending. merge_path.cu takes
// only the key helpers; it has its own pipelined tile merge.
//
// merge_tile merges two sorted runs that one block holds in shared
// memory (A at [0, len_a), B at [len_a, len_a + len_b), 6 B a key) into
// consecutive output ranks in device memory. Each thread takes ITEMS
// consecutive output ranks per round, finds where they start with a
// merge-path binary search over the two runs (ties go to A, the rule of
// megahit_tpu/core/sortnet.py::_merge_path_splits), then merges them
// sequentially in registers. The round's results go through a staging
// buffer in shared memory, so the stores to device memory are
// coalesced.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace merge {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kRound = kThreads * kItems;
// largest tile (keys a block merges): 6 B a key in shared memory plus
// the 16 KB staging buffer must fit the 227 KB a block can use
constexpr int kMaxTile = 32768;

__device__ __forceinline__ uint64_t key_at(const uint32_t* hi,
                                           const uint16_t* lo, int i) {
  return (static_cast<uint64_t>(hi[i]) << 16) | lo[i];
}

__device__ __forceinline__ uint64_t gkey(const uint32_t* __restrict__ hi,
                                         const uint16_t* __restrict__ lo,
                                         long long i) {
  return (static_cast<uint64_t>(__ldg(hi + i)) << 16) | __ldg(lo + i);
}

// Copy n keys from device memory into the shared planes at offset dst.
__device__ __forceinline__ void load_run(const uint32_t* __restrict__ hi,
                                         const uint16_t* __restrict__ lo,
                                         long long src, int n,
                                         uint32_t* s_hi, uint16_t* s_lo,
                                         int dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_hi[dst + i] = __ldg(hi + src + i);
    s_lo[dst + i] = __ldg(lo + src + i);
  }
}

__device__ void merge_tile(const uint32_t* s_hi, const uint16_t* s_lo,
                           int la, int lb, uint64_t* stage,
                           uint32_t* __restrict__ out_hi,
                           uint16_t* __restrict__ out_lo) {
  const uint32_t* b_hi = s_hi + la;
  const uint16_t* b_lo = s_lo + la;
  const int total = la + lb;
  for (int base = 0; base < total; base += kRound) {
    const int q = base + threadIdx.x * kItems;
    if (q < total) {
      int x_lo = max(0, q - lb), x_hi = min(q, la);
      while (x_lo < x_hi) {
        const int x = (x_lo + x_hi + 1) >> 1;
        if (key_at(s_hi, s_lo, x - 1) <= key_at(b_hi, b_lo, q - x))
          x_lo = x;
        else
          x_hi = x - 1;
      }
      int i = x_lo, j = q - x_lo;
      uint64_t va = i < la ? key_at(s_hi, s_lo, i) : ~0ull;
      uint64_t vb = j < lb ? key_at(b_hi, b_lo, j) : ~0ull;
#pragma unroll
      for (int t = 0; t < kItems; ++t) {
        // A wins ties; an exhausted run reads as +infinity, and a
        // rank past the end is never stored
        const bool take_a = j >= lb || (i < la && va <= vb);
        stage[threadIdx.x * kItems + t] = take_a ? va : vb;
        if (take_a) {
          ++i;
          va = i < la ? key_at(s_hi, s_lo, i) : ~0ull;
        } else {
          ++j;
          vb = j < lb ? key_at(b_hi, b_lo, j) : ~0ull;
        }
      }
    }
    __syncthreads();
    const int n_out = min(kRound, total - base);
    for (int r = threadIdx.x; r < n_out; r += kThreads) {
      const uint64_t v = stage[r];
      out_hi[base + r] = static_cast<uint32_t>(v >> 16);
      out_lo[base + r] = static_cast<uint16_t>(v & 0xffffu);
    }
    __syncthreads();
  }
}

// dynamic shared memory of a block that merges `tile` keys: both planes
// (the u32 plane first keeps the u16 plane aligned) plus the staging
// buffer
inline size_t smem_bytes(int tile) {
  return static_cast<size_t>(kRound) * sizeof(uint64_t) +
         static_cast<size_t>(tile) * (sizeof(uint32_t) + sizeof(uint16_t));
}

}  // namespace merge
