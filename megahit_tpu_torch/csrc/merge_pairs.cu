// One merge level of the keys-only sort of 48-bit (hi u32, lo u16)
// planes, where a whole pair of runs fits one block: every pair of
// sorted runs of length run_len becomes one sorted run of 2 * run_len.
//
// Replaces megahit_tpu/core/sortnet.py::_merge_level_aligned (kernel
// body _merge_pair_kernel), which merged each pair in VMEM with a
// Batcher odd-even network of lane rolls and selects, the u16 plane
// widened to u32 because the TPU's vector unit has no u16 compare. None
// of that carries over: here a block loads its pair into shared memory
// (6 B a key, coalesced), each thread finds its output ranks' start with
// a merge-path binary search and merges sequentially in registers, and
// the stores go out coalesced through a staging buffer
// (merge_common.cuh).
//
// Bound: bytes. Each level reads and writes every key once, 12 B a key
// (6 B read, 6 B written); the binary searches and merges run in shared
// memory and registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmerge_pairs.so merge_pairs.cu

#include "merge_common.cuh"

namespace {

__global__ void __launch_bounds__(merge::kThreads)
merge_pairs_kernel(const uint32_t* __restrict__ hi,
                   const uint16_t* __restrict__ lo,
                   uint32_t* __restrict__ out_hi,
                   uint16_t* __restrict__ out_lo, int run_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(stage + merge::kRound);
  uint16_t* s_lo = reinterpret_cast<uint16_t*>(s_hi + 2 * run_len);
  const long long base = static_cast<long long>(blockIdx.x) * 2 * run_len;
  merge::load_run(hi, lo, base, 2 * run_len, s_hi, s_lo, 0);
  __syncthreads();
  merge::merge_tile(s_hi, s_lo, run_len, run_len, stage, out_hi + base,
                    out_lo + base);
}

}  // namespace

// n keys (a multiple of 2 * run_len), 2 * run_len <= merge::kMaxTile.
// Returns the CUDA error of the launch (0 on success).
extern "C" int merge_pairs_launch(const void* hi, const void* lo,
                                  void* out_hi, void* out_lo, long long n,
                                  int run_len, void* stream) {
  if (run_len <= 0 || 2 * run_len > merge::kMaxTile || n % (2 * run_len))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = n / (2 * run_len);
  if (pairs == 0) return 0;
  const size_t smem = merge::smem_bytes(2 * run_len);
  cudaError_t err = cudaFuncSetAttribute(
      merge_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_pairs_kernel<<<static_cast<unsigned>(pairs), merge::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint16_t*>(lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint16_t*>(out_lo),
      run_len);
  return static_cast<int>(cudaGetLastError());
}
