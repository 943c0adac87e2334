// One merge level of the keys-only sort of 48-bit (hi u32, lo u16)
// planes, where a whole pair of runs fits one block: every pair of
// sorted runs of length run_len becomes one sorted run of 2 * run_len.
//
// Replaces megahit_tpu/core/sortnet.py::_merge_level_aligned (kernel
// body _merge_pair_kernel), which merged each pair in VMEM with a
// Batcher odd-even network of lane rolls and selects, the u16 plane
// widened to u32 because the TPU's vector unit has no u16 compare. None
// of that carries over.
//
// Bound: bytes. Each level reads and writes every key once, 12 B a key
// (6 B read, 6 B written); the searches and merges run in shared memory
// and registers. The port's first version (one block per pair) loaded
// its pair with scalar 4-B and 2-B loads, waited on a block barrier,
// then merged 8 ranks a thread after a binary search, with stores
// through a staging buffer whose writes conflicted on banks: loads,
// merge and stores did not overlap inside a block, and it ran at about a
// third of the bound. This version runs merge_common.cuh's pipeline, as
// merge_path.cu does, with no split search: a pair starts at a known
// offset, and its split is A = the first run, B = the second.
//   - Persistent blocks walk contiguous ranges of slots. A slot is
//     kTile = 8192 consecutive keys (whole pairs), or one pair where a
//     pair is longer (up to kMaxPair); the last slot may be partial.
//   - The producer warp bulk-copies the next slot's hi and lo planes
//     into the ring, one copy a plane (the aligned superset where the
//     planes are not on 16 B), while the 8 merge warps merge the current
//     slot.
//   - A merge thread takes 32 consecutive ranks inside its own pair: one
//     merge-path search in shared memory, ties to A, then a sequential
//     merge in registers; where a pair is shorter than 32 keys (run_len
//     1 to 8), it merges its 32 / (2 * run_len) whole pairs in turn.
//     The slot's results go through the swizzled staging and out as 16-B
//     stores. A pair longer than kTile is merged kTile ranks at a time
//     from a slot that still holds its input, so those ranks go from
//     registers straight to device memory as 16-B stores.
// Shared memory: a slot is (slot + 8) * 4 + (slot + 16) * 2 bytes, the
// ring kSlots of them where they fit (one where a pair is 32768 keys),
// and a 128-B header: 98,560 B at 8192 keys, 2 blocks (2 x 288 threads)
// an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmerge_pairs.so merge_pairs.cu

#include "merge_common.cuh"

namespace {

using namespace merge;

// longest pair: one slot of it must fit a block's shared memory
constexpr int kMaxPair = 32768;
constexpr int kMaxSmem = 232448;  // shared memory a block can use, sm_90

struct SlotInfo {
  int lead_hi, lead_lo;  // keys before the slot's first key in the ring
};

static_assert(kSlots * (2 * sizeof(uint64_t) + sizeof(SlotInfo)) <= kHeader,
              "the ring's mbarriers and slot offsets fit the header");

__host__ __device__ constexpr int slot_bytes(int slot) {
  return (slot + 8) * 4 + (slot + 16) * 2;
}

static_assert(kHeader + slot_bytes(kMaxPair) <= kMaxSmem,
              "one slot of the longest pair fits a block");

// A thread's kItems ranks from k (its first key in the slot), where a
// pair is shorter than kItems: kItems / (2 * run) whole pairs, A =
// [p, p + run) and B = [p + run, p + 2 * run) each, merged in turn.
__device__ __forceinline__ void merge_short(const uint32_t* k_hi,
                                            const uint16_t* k_lo, int run,
                                            Ranks& out) {
  int p = 0, ia = 0, jb = 0;
  uint64_t va = 0, vb = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((k & (2 * run - 1)) == 0) {  // a pair starts
      p = k;
      ia = jb = 0;
      va = key_at(k_hi, k_lo, p);
      vb = key_at(k_hi, k_lo, p + run);
    }
    const bool take_a = jb >= run || (ia < run && va <= vb);
    put(out, k, take_a ? va : vb);
    const int idx = take_a ? ++ia : ++jb;
    const uint64_t nx =
        idx < run ? key_at(k_hi, k_lo, p + (take_a ? 0 : run) + idx) : ~0ull;
    if (take_a)
      va = nx;
    else
      vb = nx;
  }
}

template <bool kShort>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
merge_pairs_kernel(const uint32_t* __restrict__ hi,
                   const uint16_t* __restrict__ lo,
                   uint32_t* __restrict__ out_hi,
                   uint16_t* __restrict__ out_lo, long long n, int run_len,
                   int slot, long long slots, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kSlots;
  SlotInfo* info = reinterpret_cast<SlotInfo*>(empty + kSlots);
  const int hi_cap = slot + 8;
  const long long s_begin = slots * blockIdx.x / gridDim.x;
  const long long s_end = slots * (blockIdx.x + 1) / gridDim.x;
  init_ring(full, empty);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    for (long long t = s_begin; t < s_end; ++t) {
      const int i = static_cast<int>(t - s_begin), s = i % depth;
      if (i >= depth) mbar_wait(empty + s, (i / depth - 1) & 1);
      if ((threadIdx.x & 31) == 0) {
        const long long g = t * slot;
        const int len = static_cast<int>(min(1LL * slot, n - g));
        unsigned char* ring = smem + kHeader + s * slot_bytes(slot);
        const Window h = window(hi + g, len, 4), l = window(lo + g, len, 2);
        info[s] = {h.lead, l.lead};
        mbar_expect_tx(full + s, h.bytes + l.bytes);
        bulk_load(ring, h.src, h.bytes, full + s);
        bulk_load(ring + hi_cap * 4, l.src, l.bytes, full + s);
      }
      __syncwarp();
    }
    return;
  }

  // the merge warps
  const int pair = 2 * run_len;
  for (long long t = s_begin; t < s_end; ++t) {
    const int i = static_cast<int>(t - s_begin), s = i % depth;
    const long long g = t * slot;
    const int len = static_cast<int>(min(1LL * slot, n - g));
    mbar_wait(full + s, (i / depth) & 1);
    const SlotInfo si = info[s];
    unsigned char* ring = smem + kHeader + s * slot_bytes(slot);
    uint32_t* s_hi = reinterpret_cast<uint32_t*>(ring);
    uint16_t* s_lo = reinterpret_cast<uint16_t*>(ring + hi_cap * 4);
    const uint32_t* k_hi = s_hi + si.lead_hi;  // the slot's keys
    const uint16_t* k_lo = s_lo + si.lead_lo;
    for (int base = 0; base < len; base += kTile) {
      const int q = base + threadIdx.x * kItems;
      Ranks r;
      if (q < len) {
        if (kShort) {
          merge_short(k_hi + q, k_lo + q, run_len, r);
        } else {
          const int p = q & ~(pair - 1);
          merge_ranks(k_hi + p, k_lo + p, run_len, k_hi + p + run_len,
                      k_lo + p + run_len, run_len, q - p, r);
        }
      }
      if (len <= kTile) {  // the whole slot in one round: stage it
        consumers_sync();  // every read of the slot is done
        stage_ranks(s_hi, s_lo, q, len, r);
        consumers_sync();
        store_staged(s_hi, s_lo, len, out_hi + g, out_lo + g);
      } else {  // a pair longer than kTile: len is a multiple of kTile
        store_ranks(r, out_hi + g + q, out_lo + g + q);
      }
    }
    release(empty + s);
  }
}

template <bool kShort>
cudaError_t launch(const void* hi, const void* lo, void* out_hi,
                   void* out_lo, long long n, int run_len, int slot,
                   long long slots, int depth, cudaStream_t stream) {
  const int smem = kHeader + depth * slot_bytes(slot);
  long long grid = 0;
  const cudaError_t err =
      persistent_grid(merge_pairs_kernel<kShort>, smem, slots, &grid);
  if (err != cudaSuccess) return err;
  merge_pairs_kernel<kShort><<<static_cast<unsigned>(grid), kThreads, smem,
                               stream>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint16_t*>(out_lo), n,
      run_len, slot, slots, depth);
  return cudaGetLastError();
}

}  // namespace

// n keys (a multiple of 2 * run_len), run_len a power of two with
// 2 * run_len <= kMaxPair (32768); hi and lo at any offset; out_hi and
// out_lo 16-B aligned. Returns the CUDA error of the launch (0 on
// success).
extern "C" int merge_pairs_launch(const void* hi, const void* lo,
                                  void* out_hi, void* out_lo, long long n,
                                  int run_len, void* stream) {
  if (run_len <= 0 || (run_len & (run_len - 1)) ||
      2 * run_len > kMaxPair || n % (2 * run_len) ||
      ((reinterpret_cast<uintptr_t>(out_hi) |
        reinterpret_cast<uintptr_t>(out_lo)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int slot = max(kTile, 2 * run_len);
  const long long slots = (n + slot - 1) / slot;
  const int depth =
      kHeader + kSlots * slot_bytes(slot) <= kMaxSmem ? kSlots : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      2 * run_len < kItems
          ? launch<true>(hi, lo, out_hi, out_lo, n, run_len, slot, slots,
                         depth, st)
          : launch<false>(hi, lo, out_hi, out_lo, n, run_len, slot, slots,
                          depth, st));
}
