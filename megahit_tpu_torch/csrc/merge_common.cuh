// Shared device code of the two merge kernels (merge_pairs.cu,
// merge_path.cu): 48-bit keys as a u32 `hi` plane and a u16 `lo` plane,
// compared as the u64 (hi << 16) | lo, ascending.
//
// Both kernels are one pipeline. Persistent blocks (persistent_grid)
// walk contiguous ranges of output tiles. Warp 8 of a block is the
// producer: it copies the next tile's input windows from device memory
// into a two-slot ring in shared memory with 1-D bulk copies
// (cp.async.bulk, completion on an mbarrier) while the 8 merge warps
// merge the current tile. The copies need 16-B aligned addresses and
// sizes, so each window's aligned superset is copied and its lead kept
// (window). Each merge thread takes kItems consecutive output ranks: one
// merge-path binary search in shared memory (ties go to A, the rule of
// megahit_tpu/core/sortnet.py::_merge_path_splits), then a sequential
// merge in registers (merge_ranks). The results are staged in the slot
// that was just merged, hi and lo in separate planes of 16-B units whose
// index is XOR-swizzled (unit u at u ^ ((u >> 3) & 7)), so that neither
// the threads' writes of their own 32 ranks nor the coalesced reads hit a
// bank twice in an 8-lane phase (stage_ranks), and go to device memory
// as 16-B vector stores (store_staged). Then the slot is handed back to
// the producer (release).
//
// What differs between the kernels is where a tile's windows come from:
// merge_path.cu searches each tile's split of a pair in device memory;
// merge_pairs.cu's tiles are whole pairs, one window a plane.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace merge {

constexpr int kConsumers = 256;  // 8 merge warps
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kItems = 32;  // output ranks a merge thread takes
constexpr int kTile = kConsumers * kItems;  // ranks a block merges at once
constexpr int kSlots = 2;  // ring depth
constexpr int kBlocksPerSm = 2;
constexpr int kHeader = 128;  // mbarriers and per-slot window offsets

__device__ __forceinline__ uint64_t key_at(const uint32_t* hi,
                                           const uint16_t* lo, int i) {
  return (static_cast<uint64_t>(hi[i]) << 16) | lo[i];
}

__device__ __forceinline__ uint64_t gkey(const uint32_t* __restrict__ hi,
                                         const uint16_t* __restrict__ lo,
                                         long long i) {
  return (static_cast<uint64_t>(__ldg(hi + i)) << 16) | __ldg(lo + i);
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The ring's mbarriers, by thread 0, before the block's first barrier:
// full[s] completes when slot s has arrived, empty[s] when every merge
// thread is done with it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// the merge warps' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// A merge thread is done with slot s: its next contents arrive by the
// async proxy.
__device__ __forceinline__ void release(uint64_t* empty) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive(empty);
}

struct Window {
  const void* src;  // 16-B aligned superset of the window
  unsigned bytes;
  int lead;  // keys before the window's first key
};

__device__ __forceinline__ Window window(const void* p, int len, int elem) {
  if (len == 0) return {p, 0u, 0};
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t s = a & ~static_cast<uintptr_t>(15);
  const uintptr_t e = (a + static_cast<uintptr_t>(len) * elem + 15) &
                      ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const void*>(s), static_cast<unsigned>(e - s),
          static_cast<int>((a - s) / elem)};
}

// ---------------------------------------------------------------------------
// the merge warps' step: merge, stage, store
// ---------------------------------------------------------------------------

// staging layout: 16-B unit u of a plane lives at unit swz(u)
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }
__device__ __forceinline__ int hi_at(int e) {
  return (swz(e >> 2) << 2) | (e & 3);
}
__device__ __forceinline__ int lo_at(int e) {
  return (swz(e >> 3) << 3) | (e & 7);
}

// A thread's kItems merged ranks in registers: hi words, lo halves
// packed two to a word.
struct Ranks {
  uint32_t hi[kItems];
  uint32_t lo[kItems / 2];
};

__device__ __forceinline__ void put(Ranks& r, int k, uint64_t v) {
  r.hi[k] = static_cast<uint32_t>(v >> 16);
  const uint32_t l16 = static_cast<uint32_t>(v & 0xffffu);
  r.lo[k >> 1] = (k & 1) ? r.lo[k >> 1] | (l16 << 16) : l16;
}

// Merged ranks [q, q + kItems) of the sorted runs a (la keys) and b (lb
// keys) in shared memory: the A-priority split of the first q ranks by
// binary search, then a sequential merge. A wins ties; an exhausted run
// reads as +infinity, and a rank past the end is never stored.
__device__ __forceinline__ void merge_ranks(const uint32_t* a_hi,
                                            const uint16_t* a_lo, int la,
                                            const uint32_t* b_hi,
                                            const uint16_t* b_lo, int lb,
                                            int q, Ranks& out) {
  int x_lo = max(0, q - lb), x_hi = min(q, la);
  while (x_lo < x_hi) {
    const int x = (x_lo + x_hi + 1) >> 1;
    if (key_at(a_hi, a_lo, x - 1) <= key_at(b_hi, b_lo, q - x))
      x_lo = x;
    else
      x_hi = x - 1;
  }
  int ia = x_lo, jb = q - x_lo;
  uint64_t va = ia < la ? key_at(a_hi, a_lo, ia) : ~0ull;
  uint64_t vb = jb < lb ? key_at(b_hi, b_lo, jb) : ~0ull;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool take_a = jb >= lb || (ia < la && va <= vb);
    put(out, k, take_a ? va : vb);
    const int idx = take_a ? ++ia : ++jb;
    const int lim = take_a ? la : lb;
    const uint64_t nx = idx < lim ? key_at(take_a ? a_hi : b_hi,
                                         take_a ? a_lo : b_lo, idx)
                                  : ~0ull;
    if (take_a)
      va = nx;
    else
      vb = nx;
  }
}

// A thread's ranks [q, q + kItems) of a tile of len ranks into the
// slot's staging planes (after a consumers_sync: every read of the slot
// is done).
__device__ __forceinline__ void stage_ranks(uint32_t* s_hi, uint16_t* s_lo,
                                            int q, int len, const Ranks& r) {
  if (q + kItems <= len) {
#pragma unroll
    for (int u = 0; u < kItems / 4; ++u)
      reinterpret_cast<uint4*>(s_hi)[swz(threadIdx.x * (kItems / 4) + u)] =
          make_uint4(r.hi[4 * u], r.hi[4 * u + 1], r.hi[4 * u + 2],
                     r.hi[4 * u + 3]);
#pragma unroll
    for (int u = 0; u < kItems / 8; ++u)
      reinterpret_cast<uint4*>(s_lo)[swz(threadIdx.x * (kItems / 8) + u)] =
          make_uint4(r.lo[4 * u], r.lo[4 * u + 1], r.lo[4 * u + 2],
                     r.lo[4 * u + 3]);
  } else if (q < len) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (q + k < len) {
        s_hi[hi_at(q + k)] = r.hi[k];
        s_lo[lo_at(q + k)] =
            static_cast<uint16_t>(r.lo[k >> 1] >> (16 * (k & 1)));
      }
    }
  }
}

// The staged tile of len ranks to device memory (after a consumers_sync):
// 16-B stores of its first len & ~7 ranks (dh and dl 16-B aligned, which
// the launch functions ensure), scalar stores of the rest.
__device__ __forceinline__ void store_staged(const uint32_t* s_hi,
                                             const uint16_t* s_lo, int len,
                                             uint32_t* dh, uint16_t* dl) {
  const int vec = len & ~7;
  for (int u = threadIdx.x; u < vec / 4; u += kConsumers)
    reinterpret_cast<uint4*>(dh)[u] =
        reinterpret_cast<const uint4*>(s_hi)[swz(u)];
  for (int u = threadIdx.x; u < vec / 8; u += kConsumers)
    reinterpret_cast<uint4*>(dl)[u] =
        reinterpret_cast<const uint4*>(s_lo)[swz(u)];
  for (int e = vec + threadIdx.x; e < len; e += kConsumers) {
    dh[e] = s_hi[hi_at(e)];
    dl[e] = s_lo[lo_at(e)];
  }
}

// A thread's ranks [q, q + kItems) straight from registers to device
// memory as 16-B stores (dh, dl at rank q, 16-B aligned): for tiles whose
// slot still holds input that later ranks need.
__device__ __forceinline__ void store_ranks(const Ranks& r, uint32_t* dh,
                                            uint16_t* dl) {
#pragma unroll
  for (int u = 0; u < kItems / 4; ++u)
    reinterpret_cast<uint4*>(dh)[u] = make_uint4(
        r.hi[4 * u], r.hi[4 * u + 1], r.hi[4 * u + 2], r.hi[4 * u + 3]);
#pragma unroll
  for (int u = 0; u < kItems / 8; ++u)
    reinterpret_cast<uint4*>(dl)[u] = make_uint4(
        r.lo[4 * u], r.lo[4 * u + 1], r.lo[4 * u + 2], r.lo[4 * u + 3]);
}

// Launch geometry shared by both kernels: the persistent grid (blocks an
// SM that fit, times the SMs, at most `tiles`) for `smem` dynamic bytes.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, long long tiles,
                            long long* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < 1LL * per_sm * sms ? tiles : 1LL * per_sm * sms;
  return cudaSuccess;
}

}  // namespace merge
