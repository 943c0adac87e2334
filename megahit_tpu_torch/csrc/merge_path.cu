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

using namespace merge;
constexpr unsigned kAll = 0xffffffffu;

struct TileInfo {
  int la, lb, a_hi, b_hi, a_lo, b_lo;  // window lengths, key offsets
};

static_assert(kSlots * (2 * sizeof(uint64_t) + sizeof(TileInfo)) <= kHeader,
              "the ring's mbarriers and window offsets fit the header");

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
    const bool p = lane < d && gkey(hi, lo, a + c - 1) <=
                                   gkey(hi, lo, b + q - c);
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
  init_ring(full, empty);
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
    Ranks r;
    if (q < tile)
      merge_ranks(s_hi + ti.a_hi, s_lo + ti.a_lo, ti.la, s_hi + ti.b_hi,
                  s_lo + ti.b_lo, ti.lb, q, r);
    consumers_sync();  // every read of the windows is done
    stage_ranks(s_hi, s_lo, q, tile, r);
    consumers_sync();
    store_staged(s_hi, s_lo, tile, out_hi + t * tile, out_lo + t * tile);
    release(empty + s);
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
// run_len, at most kTile (8192); out_hi and out_lo 16-B aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int merge_path_launch(const void* hi, const void* lo,
                                 void* out_hi, void* out_lo, long long n,
                                 int run_len, int tile, void* stream) {
  if (bad_level(n, run_len, tile) || tile > kTile ||
      ((reinterpret_cast<uintptr_t>(out_hi) |
        reinterpret_cast<uintptr_t>(out_lo)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n / tile;
  if (tiles == 0) return 0;
  const int hi_cap = (tile + 16 + 3) / 4 * 4;
  const int lo_cap = (tile + 32 + 7) / 8 * 8;
  const int smem = kHeader + kSlots * (hi_cap * 4 + lo_cap * 2);
  long long grid = 0;
  const cudaError_t err = persistent_grid(merge_path_kernel, smem, tiles,
                                          &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
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
