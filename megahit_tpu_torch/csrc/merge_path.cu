// One merge level of the keys-only sort of 48-bit (hi u32, lo u16)
// planes for runs longer than a block's tile: every pair of sorted runs
// of length run_len becomes one sorted run of 2 * run_len, in output
// tiles of `tile` ranks.
//
// Replaces megahit_tpu/core/sortnet.py::_merge_level_path (kernel from
// _make_path_kernel, splits from _merge_path_splits). There, an XLA pass
// computed every tile's A/B split ahead of the grid and scalar prefetch
// handed them to the kernel, which DMA'd 16-row-aligned windows into
// VMEM (double-buffered), rotated them into place with a log-decomposed
// roll (a Mosaic tiling constraint) and merged them with a Batcher
// network.
//
// Bound: bytes. Each level reads and writes every key once, 12 B a key
// (6 B read, 6 B written). The port's first version (one block per tile)
// ran its phases one after the other: two threads binary-searched the
// split in device memory (13 to 23 dependent loads), then scalar loads
// filled shared memory, then the merge and its stores ran with no load
// in flight, through a staging buffer whose writes conflicted on banks.
// This version overlaps them:
//   - persistent blocks, each over a contiguous range of tiles, so tile
//     t's end split is tile t+1's start split (one search a tile; a
//     tile that opens a pair starts at 0);
//   - the search is one warp's: 32 lanes probe 32 candidates, and a
//     ballot narrows the range 32-fold, about 5 dependent rounds instead
//     of up to 23. Ties go to A, as in merge_path_splits_plain; the
//     exported check merge_path_splits_launch runs the same function;
//   - warp 8 of each block is the producer: it searches tile t+1's split
//     while the 8 merge warps merge tile t, then copies tile t+1's A and
//     B windows into the other slot of a two-slot ring in shared memory
//     with 1-D bulk copies (cp.async.bulk, completion on an mbarrier).
//     The copies need 16-B aligned addresses and sizes, so each window's
//     aligned superset is copied and its offset kept;
//   - each merge thread takes 32 consecutive output ranks: one
//     merge-path binary search in shared memory (ties to A), then a
//     sequential merge in registers. The results are staged in the slot
//     that was just merged (its windows are no longer needed), hi and lo
//     in separate planes of 16-B units whose index is XOR-swizzled (unit
//     u at u ^ ((u >> 3) & 7)), so that neither the threads' writes of
//     their own 32 ranks nor the coalesced reads hit a bank twice in an
//     8-lane phase, and go to device memory as 16-B vector stores. Then
//     the slot is handed back to the producer (mbarrier).
// Shared memory: kSlots = 2 slots of (tile + 16) * 4 + (tile + 32) * 2
// bytes and a 128-B header, 98,688 B at the tile of 8192 (its largest,
// 32 ranks x 256 threads), so kBlocksPerSm = 2 blocks (2 x 288 threads)
// fit an SM's 228 KB. A deeper ring (3 or 4 slots, one block an SM, 256
// or 512 merge threads) measured slower on an H100 at large runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmerge_path.so merge_path.cu

#include "merge_common.cuh"

namespace {

constexpr int kSlots = 2;  // ring depth
constexpr int kBlocksPerSm = 2;
constexpr int kConsumers = 256;  // 8 merge warps
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kItems = 32;  // output ranks a merge thread takes
constexpr int kPathMaxTile = kConsumers * kItems;
constexpr int kHeader = 128;  // mbarriers and per-slot window offsets
constexpr unsigned kAll = 0xffffffffu;

struct TileInfo {
  int la, lb, a_hi, b_hi, a_lo, b_lo;  // window lengths, key offsets
};

static_assert(kSlots * (2 * sizeof(uint64_t) + sizeof(TileInfo)) <= kHeader,
              "the ring's mbarriers and window offsets fit the header");

struct Window {
  const void* src;  // 16-B aligned superset of the window
  unsigned bytes;
  int lead;  // keys before the window's first key
};

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

// the merge warps' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ Window window(const void* p, int len, int elem) {
  if (len == 0) return {p, 0u, 0};
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t s = a & ~static_cast<uintptr_t>(15);
  const uintptr_t e = (a + static_cast<uintptr_t>(len) * elem + 15) &
                      ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const void*>(s), static_cast<unsigned>(e - s),
          static_cast<int>((a - s) / elem)};
}

// staging layout: 16-B unit u of a plane lives at unit swz(u)
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }
__device__ __forceinline__ int hi_at(int e) {
  return (swz(e >> 2) << 2) | (e & 3);
}
__device__ __forceinline__ int lo_at(int e) {
  return (swz(e >> 3) << 3) | (e & 7);
}

// One warp, every lane: the A-priority split of the first q merged
// ranks of runs a (length la) and b (length lb) in device memory, the
// largest x with x == max(0, q - lb) or A[x - 1] <= B[q - x]. The
// predicate is true on a prefix of x (both runs are sorted), so each
// round probes 32 candidates and keeps the stretch between the last
// true and the first false one.
__device__ int warp_split(const uint32_t* __restrict__ hi,
                          const uint16_t* __restrict__ lo, long long a,
                          long long b, int la, int lb, int q) {
  const int lane = threadIdx.x & 31;
  int x_lo = max(0, q - lb), x_hi = min(q, la);
  while (x_lo < x_hi) {
    const int d = x_hi - x_lo;
    const int c =
        d <= 32 ? x_lo + 1 + lane
                : x_lo + static_cast<int>(
                             (static_cast<long long>(lane + 1) * d) >> 5);
    const bool p = lane < d && merge::gkey(hi, lo, a + c - 1) <=
                                   merge::gkey(hi, lo, b + q - c);
    const int k = __popc(__ballot_sync(kAll, p));
    const int c_last = __shfl_sync(kAll, c, max(k - 1, 0));
    const int c_next = __shfl_sync(kAll, c, min(k, 31));
    if (k == 0) {
      x_hi = c_next - 1;
    } else {
      x_lo = c_last;
      if (k < min(d, 32)) x_hi = c_next - 1;
    }
  }
  return x_lo;
}

using merge::key_at;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
merge_path_kernel(const uint32_t* __restrict__ hi,
                  const uint16_t* __restrict__ lo,
                  uint32_t* __restrict__ out_hi,
                  uint16_t* __restrict__ out_lo, int run_len, int tile,
                  long long tiles, int hi_cap, int lo_cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kSlots;
  TileInfo* info = reinterpret_cast<TileInfo*>(empty + kSlots);
  const int slot_bytes = hi_cap * 4 + lo_cap * 2;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  const long long pair = 2LL * run_len;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x & 31;
    const long long ps0 = t_begin * tile / pair * pair;
    int a_from = warp_split(hi, lo, ps0, ps0 + run_len, run_len, run_len,
                            static_cast<int>(t_begin * tile - ps0));
    for (long long t = t_begin; t < t_end; ++t) {
      const int i = static_cast<int>(t - t_begin), s = i % kSlots;
      const long long ps = t * tile / pair * pair;
      const int q_lo = static_cast<int>(t * tile - ps);
      if (q_lo == 0) a_from = 0;
      const int a_to = warp_split(hi, lo, ps, ps + run_len, run_len,
                                  run_len, q_lo + tile);
      if (i >= kSlots) mbar_wait(empty + s, (i / kSlots - 1) & 1);
      if (lane == 0) {
        const int la = a_to - a_from, lb = tile - la;
        const long long ga = ps + a_from, gb = ps + run_len + q_lo - a_from;
        unsigned char* slot = smem + kHeader + s * slot_bytes;
        uint32_t* s_hi = reinterpret_cast<uint32_t*>(slot);
        uint16_t* s_lo = reinterpret_cast<uint16_t*>(slot + hi_cap * 4);
        const Window ah = window(hi + ga, la, 4), bh = window(hi + gb, lb, 4);
        const Window al = window(lo + ga, la, 2), bl = window(lo + gb, lb, 2);
        info[s] = {la, lb, ah.lead, static_cast<int>(ah.bytes / 4) + bh.lead,
                   al.lead, static_cast<int>(al.bytes / 2) + bl.lead};
        mbar_expect_tx(full + s, ah.bytes + bh.bytes + al.bytes + bl.bytes);
        uint64_t* bar = full + s;
        if (ah.bytes) bulk_load(s_hi, ah.src, ah.bytes, bar);
        if (bh.bytes) bulk_load(s_hi + ah.bytes / 4, bh.src, bh.bytes, bar);
        if (al.bytes) bulk_load(s_lo, al.src, al.bytes, bar);
        if (bl.bytes) bulk_load(s_lo + al.bytes / 2, bl.src, bl.bytes, bar);
      }
      __syncwarp();
      a_from = a_to;
    }
    return;
  }

  // the merge warps
  const int q = threadIdx.x * kItems;  // the thread's first rank in a tile
  for (long long t = t_begin; t < t_end; ++t) {
    const int i = static_cast<int>(t - t_begin), s = i % kSlots;
    mbar_wait(full + s, (i / kSlots) & 1);
    const TileInfo ti = info[s];
    unsigned char* slot = smem + kHeader + s * slot_bytes;
    uint32_t* s_hi = reinterpret_cast<uint32_t*>(slot);
    uint16_t* s_lo = reinterpret_cast<uint16_t*>(slot + hi_cap * 4);
    const uint32_t* a_hi = s_hi + ti.a_hi;
    const uint32_t* b_hi = s_hi + ti.b_hi;
    const uint16_t* a_lo = s_lo + ti.a_lo;
    const uint16_t* b_lo = s_lo + ti.b_lo;
    const int la = ti.la, lb = ti.lb;
    uint32_t oh[kItems], ol[kItems / 2];
    if (q < tile) {
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
        // A wins ties; an exhausted run reads as +infinity, and a rank
        // past the tile is never stored
        const bool take_a = jb >= lb || (ia < la && va <= vb);
        const uint64_t v = take_a ? va : vb;
        oh[k] = static_cast<uint32_t>(v >> 16);
        const uint32_t l16 = static_cast<uint32_t>(v & 0xffffu);
        ol[k >> 1] = (k & 1) ? ol[k >> 1] | (l16 << 16) : l16;
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
    consumers_sync();  // every read of the windows is done
    if (q + kItems <= tile) {
#pragma unroll
      for (int u = 0; u < kItems / 4; ++u)
        reinterpret_cast<uint4*>(s_hi)[swz(threadIdx.x * (kItems / 4) + u)] =
            make_uint4(oh[4 * u], oh[4 * u + 1], oh[4 * u + 2], oh[4 * u + 3]);
#pragma unroll
      for (int u = 0; u < kItems / 8; ++u)
        reinterpret_cast<uint4*>(s_lo)[swz(threadIdx.x * (kItems / 8) + u)] =
            make_uint4(ol[4 * u], ol[4 * u + 1], ol[4 * u + 2], ol[4 * u + 3]);
    } else if (q < tile) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (q + k < tile) {
          s_hi[hi_at(q + k)] = oh[k];
          s_lo[lo_at(q + k)] =
              static_cast<uint16_t>(ol[k >> 1] >> (16 * (k & 1)));
        }
      }
    }
    consumers_sync();
    uint32_t* dh = out_hi + t * tile;
    uint16_t* dl = out_lo + t * tile;
    if (tile >= 8) {
      for (int u = threadIdx.x; u < tile / 4; u += kConsumers)
        reinterpret_cast<uint4*>(dh)[u] =
            reinterpret_cast<const uint4*>(s_hi)[swz(u)];
      for (int u = threadIdx.x; u < tile / 8; u += kConsumers)
        reinterpret_cast<uint4*>(dl)[u] =
            reinterpret_cast<const uint4*>(s_lo)[swz(u)];
    } else {
      for (int e = threadIdx.x; e < tile; e += kConsumers) {
        dh[e] = s_hi[hi_at(e)];
        dl[e] = s_lo[lo_at(e)];
      }
    }
    // the slot's next contents arrive by the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(empty + s);
  }
}

// The split search alone, one warp per tile, so that it can be held to
// its plain version (sortnet.merge_path_splits_plain).
__global__ void merge_path_splits_kernel(const uint32_t* __restrict__ hi,
                                         const uint16_t* __restrict__ lo,
                                         int* __restrict__ a_from,
                                         int* __restrict__ a_to,
                                         long long tiles, int run_len,
                                         int tile) {
  const long long t =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (t >= tiles) return;  // whole warps
  const long long pair = 2LL * run_len;
  const long long ps = t * tile / pair * pair;
  const int q_lo = static_cast<int>(t * tile - ps);
  const int f = warp_split(hi, lo, ps, ps + run_len, run_len, run_len, q_lo);
  const int e =
      warp_split(hi, lo, ps, ps + run_len, run_len, run_len, q_lo + tile);
  if ((threadIdx.x & 31) == 0) {
    a_from[t] = f;
    a_to[t] = e;
  }
}

bool bad_level(long long n, int run_len, int tile) {
  return tile <= 0 || (tile & (tile - 1)) || run_len < tile ||
         run_len % tile || n % (2LL * run_len);
}

}  // namespace

// n keys (a multiple of 2 * run_len), tile a power of two that divides
// run_len, at most kPathMaxTile (8192); out_hi and out_lo 16-B aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int merge_path_launch(const void* hi, const void* lo,
                                 void* out_hi, void* out_lo, long long n,
                                 int run_len, int tile, void* stream) {
  if (bad_level(n, run_len, tile) || tile > kPathMaxTile ||
      ((reinterpret_cast<uintptr_t>(out_hi) |
        reinterpret_cast<uintptr_t>(out_lo)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n / tile;
  if (tiles == 0) return 0;
  const int hi_cap = (tile + 16 + 3) / 4 * 4;
  const int lo_cap = (tile + 32 + 7) / 8 * 8;
  const int smem = kHeader + kSlots * (hi_cap * 4 + lo_cap * 2);
  cudaError_t err = cudaFuncSetAttribute(
      merge_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, merge_path_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid =
      tiles < 1LL * per_sm * sms ? tiles : 1LL * per_sm * sms;
  merge_path_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint16_t*>(out_lo),
      run_len, tile, tiles, hi_cap, lo_cap);
  return static_cast<int>(cudaGetLastError());
}

// merge_path_launch's split search alone: per output tile t, the A-run
// range [a_from[t], a_to[t]) of its window (int32), same operands.
extern "C" int merge_path_splits_launch(const void* hi, const void* lo,
                                        void* a_from, void* a_to,
                                        long long n, int run_len, int tile,
                                        void* stream) {
  if (bad_level(n, run_len, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n / tile;
  if (tiles == 0) return 0;
  const int threads = 256;  // 8 tiles a block
  merge_path_splits_kernel<<<static_cast<unsigned>((tiles * 32 + threads - 1) /
                                                   threads),
                             threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<int*>(a_from), static_cast<int*>(a_to), tiles, run_len,
      tile);
  return static_cast<int>(cudaGetLastError());
}
