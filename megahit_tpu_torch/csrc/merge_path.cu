// One merge level of the keys-only sort of 48-bit (hi u32, lo u16)
// planes for runs longer than a block's tile: every pair of sorted runs
// of length run_len becomes one sorted run of 2 * run_len, one block per
// output tile of `tile` ranks.
//
// Replaces megahit_tpu/core/sortnet.py::_merge_level_path (kernel from
// _make_path_kernel, splits from _merge_path_splits). There, an XLA pass
// computed every tile's A/B split ahead of the grid and scalar prefetch
// handed them to the kernel, which DMA'd 16-row-aligned windows into
// VMEM (double-buffered), rotated them into place with a log-decomposed
// roll (a Mosaic tiling constraint) and merged them with a Batcher
// network. Here each block finds its own split: two threads binary-
// search the pair in device memory for where the tile's first and
// one-past-last ranks fall (ties go to A), so no split pass and no
// alignment slack exist. The block then copies its A and B windows,
// which hold exactly `tile` keys together, into shared memory (6 B a
// key, coalesced) and merges them as merge_pairs.cu does
// (merge_common.cuh).
//
// Bound: bytes. Each level reads and writes every key once, 12 B a key
// (6 B read, 6 B written); the two searches per block touch about
// 2 * log2(run_len) keys, mostly from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmerge_path.so merge_path.cu

#include "merge_common.cuh"

namespace {

// A count among the merged ranks of output tile t's pair before the
// tile's first rank (end 0) or past its last (end 1).
__device__ __forceinline__ int tile_split(const uint32_t* __restrict__ hi,
                                          const uint16_t* __restrict__ lo,
                                          long long t, int run_len,
                                          int tile, int end) {
  const long long pair = 2LL * run_len;
  const long long pair_start = t * tile / pair * pair;
  const int q = static_cast<int>(t * tile - pair_start) + end * tile;
  return merge::split_global(hi, lo, pair_start, pair_start + run_len,
                             run_len, run_len, q);
}

__global__ void __launch_bounds__(merge::kThreads)
merge_path_kernel(const uint32_t* __restrict__ hi,
                  const uint16_t* __restrict__ lo,
                  uint32_t* __restrict__ out_hi,
                  uint16_t* __restrict__ out_lo, int run_len, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(stage + merge::kRound);
  uint16_t* s_lo = reinterpret_cast<uint16_t*>(s_hi + tile);
  __shared__ int split[2];

  const long long t0 = static_cast<long long>(blockIdx.x) * tile;
  const long long pair = 2LL * run_len;
  const long long pair_start = t0 / pair * pair;
  const int q_lo = static_cast<int>(t0 - pair_start);
  const long long a_base = pair_start, b_base = pair_start + run_len;
  if (threadIdx.x < 2)
    split[threadIdx.x] = tile_split(hi, lo, blockIdx.x, run_len, tile,
                                    static_cast<int>(threadIdx.x));
  __syncthreads();
  const int a_from = split[0], a_to = split[1];
  const int la = a_to - a_from;
  const int b_from = q_lo - a_from;
  merge::load_run(hi, lo, a_base + a_from, la, s_hi, s_lo, 0);
  merge::load_run(hi, lo, b_base + b_from, tile - la, s_hi, s_lo, la);
  __syncthreads();
  merge::merge_tile(s_hi, s_lo, la, tile - la, stage, out_hi + t0,
                    out_lo + t0);
}

// The blocks' split search alone, one thread per tile, so that it can
// be held to its plain version (sortnet.merge_path_splits_plain).
__global__ void merge_path_splits_kernel(const uint32_t* __restrict__ hi,
                                         const uint16_t* __restrict__ lo,
                                         int* __restrict__ a_from,
                                         int* __restrict__ a_to,
                                         long long tiles, int run_len,
                                         int tile) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= tiles) return;
  a_from[t] = tile_split(hi, lo, t, run_len, tile, 0);
  a_to[t] = tile_split(hi, lo, t, run_len, tile, 1);
}

}  // namespace

// n keys (a multiple of 2 * run_len), tile a divisor of run_len,
// tile <= merge::kMaxTile. Returns the CUDA error of the launch (0 on
// success).
extern "C" int merge_path_launch(const void* hi, const void* lo,
                                 void* out_hi, void* out_lo, long long n,
                                 int run_len, int tile, void* stream) {
  if (tile <= 0 || tile > merge::kMaxTile || run_len < tile ||
      run_len % tile || n % (2LL * run_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n / tile;
  if (tiles == 0) return 0;
  const size_t smem = merge::smem_bytes(tile);
  cudaError_t err = cudaFuncSetAttribute(
      merge_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_path_kernel<<<static_cast<unsigned>(tiles), merge::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint16_t*>(out_lo),
      run_len, tile);
  return static_cast<int>(cudaGetLastError());
}

// merge_path_launch's split search alone: per output tile t, the A-run
// range [a_from[t], a_to[t]) of its window (int32), same operands.
extern "C" int merge_path_splits_launch(const void* hi, const void* lo,
                                        void* a_from, void* a_to,
                                        long long n, int run_len, int tile,
                                        void* stream) {
  if (tile <= 0 || run_len < tile || run_len % tile || n % (2LL * run_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = n / tile;
  if (tiles == 0) return 0;
  const int threads = 256;
  merge_path_splits_kernel<<<static_cast<unsigned>((tiles + threads - 1) /
                                                   threads),
                             threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<int*>(a_from), static_cast<int*>(a_to), tiles, run_len,
      tile);
  return static_cast<int>(cudaGetLastError());
}
