// Run-length count over sorted SoA key columns.
//
// Replaces megahit_tpu/core/pallas_kernels.py count_sorted_runs_pallas
// (kernel body _count_kernel). Contract (kmerops.count_sorted_runs_soa):
//   head[i]   = row i differs from row i-1 in some column (row 0 always)
//   nh[i]     = first head strictly after i, or n
//   counts[i] = head[i] ? nh[i] - i - (nh[i] == n ? n_inv : 0) : 0
//   head[i]  &= counts[i] > 0
//
// Bound: bytes, W*4 B read and 5 B written per row. The TPU kernel walks
// its grid last block first and carries the suffix-min of head positions
// in SMEM from one step to the next. Blocks on Hopper run in no order,
// so the carry is explicit and takes three launches:
//   1. runs_heads: each thread flags its row (it reads its predecessor
//      row directly, so block boundaries need no pre-pass) and each block
//      reduces its first head position;
//   2. runs_carry: one block turns the block minima into an exclusive
//      suffix-min (the first head in any later block);
//   3. runs_finish: each block finishes its own suffix-min of head
//      positions with warp shuffles plus shared memory, takes the carry,
//      and writes counts and the final head flags.
// Any n < 2^31 works (no padding), and a run that spans many blocks costs
// no more than a short one: no thread scans forward to the next head.
// runs_heads is instantiated per column count, so the column pointers
// stay in registers; positions are 32-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libcount_runs.so count_runs.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps: one warp scans the warp minima
constexpr int kMaxCols = 16;
constexpr unsigned kAll = 0xffffffffu;

struct Cols {
  const uint32_t* p[kMaxCols];
};

// inclusive suffix-min within the warp: lane l gets min over lanes >= l
__device__ __forceinline__ int warp_suffix_min(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_down_sync(kAll, v, off);
    if (lane + off < 32) v = min(v, t);
  }
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
runs_heads(Cols cols, int n, uint8_t* __restrict__ head,
           int* __restrict__ block_min) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int hp = n;
  if (i < n) {
    bool h = i == 0;
    if (!h) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        h |= __ldg(cols.p[c] + i) != __ldg(cols.p[c] + i - 1);
    }
    head[i] = h;
    if (h) hp = i;
  }
  __shared__ int smin[kThreads / 32];
  hp = __reduce_min_sync(kAll, hp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smin[warp] = hp;
  __syncthreads();
  if (warp == 0) {
    const int v = __reduce_min_sync(kAll, smin[lane]);
    if (lane == 0) block_min[blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
runs_carry(const int* __restrict__ block_min, int* __restrict__ carry,
           int nb, int n) {
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(nb, lo + per);
  int agg = n;
  for (int b = lo; b < hi; ++b) agg = min(agg, block_min[b]);
  __shared__ int s[kThreads];
  s[threadIdx.x] = agg;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = threadIdx.x + off < kThreads ? s[threadIdx.x + off] : n;
    __syncthreads();
    s[threadIdx.x] = min(s[threadIdx.x], v);
    __syncthreads();
  }
  int run = threadIdx.x + 1 < kThreads ? s[threadIdx.x + 1] : n;
  for (int b = hi - 1; b >= lo; --b) {
    carry[b] = run;
    run = min(run, block_min[b]);
  }
}

__global__ void __launch_bounds__(kThreads)
runs_finish(int n, int n_inv, const int* __restrict__ carry,
            uint8_t* __restrict__ head, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool h = i < n && head[i] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = warp_suffix_min(h ? i : n);
  __shared__ int wmin[kThreads / 32];
  __shared__ int wlater[kThreads / 32];  // min over later warps
  if (lane == 0) wmin[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_suffix_min(wmin[lane]);
    const int later = __shfl_down_sync(kAll, v, 1);
    wlater[lane] = lane < 31 ? later : n;
  }
  __syncthreads();
  const int next_lane = __shfl_down_sync(kAll, s, 1);
  int nh = lane < 31 ? next_lane : n;
  nh = min(nh, wlater[warp]);
  nh = min(nh, carry[blockIdx.x]);
  if (i < n) {
    int cnt = nh - i;
    if (nh == n) cnt -= n_inv;
    if (!h) cnt = 0;
    counts[i] = cnt;
    head[i] = cnt > 0;
  }
}

}  // namespace

// cols: host array of w device pointers to (n,) u32 columns.
// head: (n,) u8 out; counts: (n,) i32 out; block_min, carry: (nb,) i32
// scratch with nb = ceil(n / 1024). Returns the first cudaError_t.
extern "C" int count_sorted_runs_launch(const void* const* cols, int w,
                                        int n, int n_inv, void* head,
                                        void* counts, void* block_min,
                                        void* carry, void* stream) {
  if (w < 1 || w > kMaxCols || n < 1) return (int)cudaErrorInvalidValue;
  Cols c{};
  for (int i = 0; i < w; ++i) c.p[i] = static_cast<const uint32_t*>(cols[i]);
  const int nb = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* hd = static_cast<uint8_t*>(head);
  int* bm = static_cast<int*>(block_min);
  int* cr = static_cast<int*>(carry);
  switch (w) {
#define HEADS_CASE(N) \
  case N:             \
    runs_heads<N><<<nb, kThreads, 0, s>>>(c, n, hd, bm); \
    break;
    HEADS_CASE(1) HEADS_CASE(2) HEADS_CASE(3) HEADS_CASE(4)
    HEADS_CASE(5) HEADS_CASE(6) HEADS_CASE(7) HEADS_CASE(8)
    HEADS_CASE(9) HEADS_CASE(10) HEADS_CASE(11) HEADS_CASE(12)
    HEADS_CASE(13) HEADS_CASE(14) HEADS_CASE(15) HEADS_CASE(16)
#undef HEADS_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  runs_carry<<<1, kThreads, 0, s>>>(bm, cr, nb, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  runs_finish<<<nb, kThreads, 0, s>>>(n, n_inv, cr, hd,
                                      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}
