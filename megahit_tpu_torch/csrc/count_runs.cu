// Run-length count over sorted SoA key columns, in one pass.
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
// in SMEM from one step to the next. Blocks on Hopper run in no order;
// the port's first version therefore took three launches (heads and
// block minima, a one-block carry, finish) and sent the head flags
// through device memory twice. This version is one launch with a
// decoupled look-ahead, which carries the suffix-min across tiles:
//   - tiles of kTile = 256 threads x 16 rows. A block takes its tile from
//     an atomic ticket, last tile first (tile = nt - 1 - ticket), so a
//     tile waits only on tiles whose blocks started before it (blockIdx
//     is not used for this: blocks start in no order, and waiting on one
//     that has not started could deadlock);
//   - a thread takes 16 rows of every column as 4 groups of 4
//     consecutive rows, group k of lane l at the warp's base + 128k + 4l,
//     so that each 16-B load of a warp covers 512 contiguous bytes
//     (scalar loads where a column does not start on a 16-B boundary,
//     e.g. a view x[1:]: the outputs, which are aligned, would not line
//     up with such an input). The row before a group comes from the
//     neighbouring lane by shuffle (lane 0 of a warp's first group loads
//     it), and the head flags stay in a 16-bit mask in a register;
//   - the next head after each row comes from the mask (__ffs), warp
//     shuffles across lanes (a suffix-min per group) and shared memory
//     across warps; the tile's first head is its aggregate;
//   - a descriptor per tile (one 64-bit word: flag none / aggregate /
//     inclusive in the high half, value in the low half, published with
//     st.release and read with ld.acquire) carries the suffix-min across
//     tiles. A tile with a head publishes "inclusive = its first head" at
//     once: every later position is larger. A headless tile publishes
//     "aggregate", then one warp reads the descriptors after it 32 at a
//     time until it finds an inclusive one (or runs past the last tile)
//     and upgrades its own descriptor to "inclusive" with that value.
//     Every tile reads tile + 1's descriptor for the first head after
//     it; usually it is already inclusive.
//   - counts go out as 16-B vectors and the 4 head bytes of a group as
//     one 32-bit word, both coalesced across the warp.
// The descriptors and the ticket are zeroed by one cudaMemsetAsync on
// the same stream before the launch. Rows are 32-bit ints: n is at most
// 2^31 - kTile, so the last tile's row indices do not overflow. The tile
// size lives here only: the caller sizes the scratch and the row limit
// from count_runs_tile(), and the launch refuses a scratch too short for
// its tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libcount_runs.so count_runs.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows per thread
constexpr int kTile = kThreads * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;
constexpr unsigned kAll = 0xffffffffu;
// descriptor flags (high 32 bits of a descriptor word)
constexpr unsigned kAggregate = 1, kInclusive = 2;

struct Cols {
  const uint32_t* p[kMaxCols];
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned flag, int value) {
  const unsigned long long v =
      (static_cast<unsigned long long>(flag) << 32) |
      static_cast<unsigned>(value);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A thread's 16 rows of one column: group k (0..3) is the 4 rows
// g + 4 * lane + [0, 4), g = base + 128 * k, so that a warp's load of one
// group is 512 contiguous bytes. Rows at or past n read as 0 or as
// whatever shares a 16-B granule with a valid row; the caller masks them.
template <bool kVec>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ p,
                                          int base, int n, uint32_t* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRows / 4; ++k) {
    const int r = base + 128 * k + 4 * lane;
    if (kVec) {
      const uint4 x = r < n ? __ldg(reinterpret_cast<const uint4*>(p + r))
                            : make_uint4(0, 0, 0, 0);
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * k + j] = r + j < n ? __ldg(p + r + j) : 0;
    }
  }
}

// Bit 4k + j set where row j of the thread's group k equals the row
// before it in this column. The row before a group is lane - 1's last
// row of it, or for lane 0 lane 31's last row of group k - 1 (for group
// 0, the warp before's last row: one load).
__device__ __forceinline__ unsigned same_as_prev(const uint32_t* v,
                                                 const uint32_t* p,
                                                 int base, int n) {
  const int lane = threadIdx.x & 31;
  unsigned same = 0;
#pragma unroll
  for (int k = 0; k < kRows / 4; ++k) {
    const uint32_t up = __shfl_up_sync(kAll, v[4 * k + 3], 1);
    const uint32_t wrap =
        __shfl_sync(kAll, v[(4 * k + kRows - 1) % kRows], 31);
    uint32_t prev = up;
    if (lane == 0) {
      if (k > 0)
        prev = wrap;
      else if (base > 0 && base < n)
        prev = __ldg(p + base - 1);
    }
    unsigned g = v[4 * k] == prev;
#pragma unroll
    for (int j = 1; j < 4; ++j)
      g |= static_cast<unsigned>(v[4 * k + j] == v[4 * k + j - 1]) << j;
    same |= g << (4 * k);
  }
  return same;
}

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

// One warp: the first head at or after tile t's first row, from the
// descriptors of tiles t, t+1, ... (past the last tile: n).
__device__ int look_ahead(const unsigned long long* desc, int t, int nt,
                          int n) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int i = t + lane;
    const unsigned long long d =
        i < nt ? ld_acquire(desc + i)
               : (static_cast<unsigned long long>(kInclusive) << 32) |
                     static_cast<unsigned>(n);
    // the first descriptor that is not "aggregate" (a headless tile)
    const unsigned stop =
        __ballot_sync(kAll, static_cast<unsigned>(d >> 32) != kAggregate);
    if (stop == 0) {
      t += 32;
      continue;
    }
    const int f = __ffs(stop) - 1;
    const unsigned long long df = __shfl_sync(kAll, d, f);
    if (static_cast<unsigned>(df >> 32) == kInclusive)
      return static_cast<int>(static_cast<unsigned>(df));
    t += f;  // not published yet: its block holds an earlier ticket
    __nanosleep(64);
  }
}

// bits 0..3 of b -> bytes 0..3 of a word (each 0 or 1)
__device__ __forceinline__ unsigned bytes_of(unsigned b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads)
count_runs_kernel(Cols cols, int n, int n_inv, int nt,
                  unsigned long long* __restrict__ desc,
                  unsigned* __restrict__ ticket, uint8_t* __restrict__ head,
                  int32_t* __restrict__ counts) {
  __shared__ int s_tile, s_carry;
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = nt - 1 - static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile + warp * (kTile / kWarps);

  // head flags, bit 4k + j for row base + 128k + 4 lane + j: a row is a
  // head unless it equals the row before it in every column
  unsigned same = 0xffffu;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    uint32_t v[kRows];
    load_rows<kVec>(cols.p[c], base, n, v);
    same &= same_as_prev(v, cols.p[c], base, n);
  }
  unsigned mask = ~same & 0xffffu;
  if (base == 0 && lane == 0) mask |= 1u;
#pragma unroll
  for (int k = 0; k < kRows / 4; ++k) {
    const int nv = min(max(n - (base + 128 * k + 4 * lane), 0), 4);
    mask &= ~(0xfu << (4 * k)) | (((1u << nv) - 1u) << (4 * k));
  }

  // first head of each group over lanes >= this one (rows in order:
  // group, lane, row), and the warp's first head
  int suf[kRows / 4];
  int wfirst = n;
#pragma unroll
  for (int k = 0; k < kRows / 4; ++k) {
    const unsigned g = (mask >> (4 * k)) & 0xfu;
    suf[k] = warp_suffix_min(g ? base + 128 * k + 4 * lane + __ffs(g) - 1
                               : n);
    wfirst = min(wfirst, __shfl_sync(kAll, suf[k], 0));
  }
  if (lane == 0) s_warp[warp] = wfirst;
  __syncthreads();
  int first = n, later = n;  // the tile's first head; after this warp
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    first = min(first, v);
    if (w > warp) later = min(later, v);
  }
  if (warp == 0) {
    if (lane == 0)
      st_release(desc + tile, first < n ? kInclusive : kAggregate, first);
    const int carry = look_ahead(desc, tile + 1, nt, n);
    if (lane == 0) {
      if (first == n) st_release(desc + tile, kInclusive, carry);
      s_carry = carry;
    }
  }
  __syncthreads();
  later = min(later, s_carry);

#pragma unroll
  for (int k = kRows / 4 - 1; k >= 0; --k) {
    // first head after this lane's group k: later lanes of group k, then
    // later groups (later holds them once group k + 1 is folded in)
    const int next_lane = __shfl_down_sync(kAll, suf[k], 1);
    const int after = lane < 31 ? min(next_lane, later) : later;
    later = min(later, __shfl_sync(kAll, suf[k], 0));
    const int r = base + 128 * k + 4 * lane;
    const unsigned g = (mask >> (4 * k)) & 0xfu;
    int cnt[4];
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned above = g >> (j + 1);
      const int nh = above ? r + j + __ffs(above) : after;
      int c = nh - (r + j);
      if (nh == n) c -= n_inv;
      if (!((g >> j) & 1u)) c = 0;
      cnt[j] = c;
      keep |= static_cast<unsigned>(c > 0) << j;
    }
    if (r + 4 <= n) {
      *reinterpret_cast<int4*>(counts + r) =
          make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
      *reinterpret_cast<unsigned*>(head + r) = bytes_of(keep);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r + j < n) {
          counts[r + j] = cnt[j];
          head[r + j] = (keep >> j) & 1u;
        }
      }
    }
  }
}

template <int W>
cudaError_t launch_w(const Cols& c, bool vec, int n, int n_inv, int nt,
                     unsigned long long* desc, unsigned* ticket,
                     uint8_t* head, int32_t* counts, cudaStream_t s) {
  if (vec)
    count_runs_kernel<W, true><<<nt, kThreads, 0, s>>>(
        c, n, n_inv, nt, desc, ticket, head, counts);
  else
    count_runs_kernel<W, false><<<nt, kThreads, 0, s>>>(
        c, n, n_inv, nt, desc, ticket, head, counts);
  return cudaGetLastError();
}

}  // namespace

// Rows per tile: the scratch holds ceil(n / tile) + 1 u64 words, and n
// is at most 2^31 - tile.
extern "C" int count_runs_tile() { return kTile; }

// cols: host array of w device pointers to (n,) u32 columns, 4-B
// aligned. head: (n,) u8 out and counts: (n,) i32 out, both 16-B
// aligned. scratch: scratch_words u64 words, at least ceil(n / kTile) +
// 1, zeroed here (the tiles' descriptors, then the ticket). Returns the
// first cudaError_t.
extern "C" int count_sorted_runs_launch(const void* const* cols, int w,
                                        int n, int n_inv, void* head,
                                        void* counts, void* scratch,
                                        long long scratch_words,
                                        void* stream) {
  if (w < 1 || w > kMaxCols || n < 1 || n > 0x7fffffff - kTile + 1 ||
      ((reinterpret_cast<uintptr_t>(head) |
        reinterpret_cast<uintptr_t>(counts)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n + kTile - 1) / kTile;
  if (scratch_words < static_cast<long long>(nt) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c{};
  bool vec = true;
  for (int i = 0; i < w; ++i) {
    c.p[i] = static_cast<const uint32_t*>(cols[i]);
    vec &= (reinterpret_cast<uintptr_t>(cols[i]) & 15) == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* desc = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (static_cast<size_t>(nt) + 1) * sizeof(*desc), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* ticket = reinterpret_cast<unsigned*>(desc + nt);
  uint8_t* hd = static_cast<uint8_t*>(head);
  int32_t* ct = static_cast<int32_t*>(counts);
  switch (w) {
#define W_CASE(N) \
  case N:         \
    return static_cast<int>(                                           \
        launch_w<N>(c, vec, n, n_inv, nt, desc, ticket, hd, ct, s));
    W_CASE(1) W_CASE(2) W_CASE(3) W_CASE(4)
    W_CASE(5) W_CASE(6) W_CASE(7) W_CASE(8)
    W_CASE(9) W_CASE(10) W_CASE(11) W_CASE(12)
    W_CASE(13) W_CASE(14) W_CASE(15) W_CASE(16)
#undef W_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
