// Canonical k-mer keys at every base offset of a 2-bit packed pool.
//
// Replaces megahit_tpu/core/pallas_kernels.py canonical_all_kmers_pallas
// (kernel body _canon_kernel). Same output, bit for bit: (W, n_out) u32
// words, PHASE-GROUPED - within each block of kBlockQ window starts,
// column r * kBlockQ + q_local holds the canonical key at base offset
// (block * kBlockQ + q_local) * 16 + r. Window starts past the pool
// read zero words.
//
// Bound: bytes. The pool is read once from memory (4 B a word) and W*4 B
// are written per base offset, so the stores are 16W times the loads.
// The design:
//   - a block owns kThreads * V consecutive window starts inside one
//     kBlockQ block and copies their words (plus the W that the last
//     window reaches into) into shared memory once: one 1-D bulk copy
//     (cp.async.bulk, completion on an mbarrier) where the pool is 16-B
//     aligned and the tile lies inside it, else coalesced 4-B loads
//     (a view such as x[1:]). Words at index >= p are read as zero, in
//     both branches' place of a padded copy of the pool;
//   - a thread takes V consecutive window starts and all 16 phases. It
//     reads its V + W words from shared memory once and takes their
//     reverse complements once (__brev, a swap of each bit pair and a
//     complement); the forward key at phase r is a funnel shift of the
//     words, and its reverse complement a funnel shift of the reversed
//     words, by 32 + sh - 2r bits where sh = 2 (16W - k) realigns it to
//     the top (word offset 1 when sh >= 2r: a branch that is the same
//     for the whole grid). So a key word costs two shifts, a compare
//     step and a select, and the pool is not read again;
//   - for each key plane a thread writes its V words of one phase as
//     one streaming store (st.global.cs, evict first: the output must
//     not push the pool's words out of L2): V = 4, a 16-B store, so a
//     warp writes 512 contiguous bytes at once. Output planes start
//     16-B aligned, as n_out is a multiple of kBlockQ * 16. V = 4 up to
//     W = 12, 2 above (a thread holds V * W key words of a phase).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libcanonical_kmers.so canonical_kmers.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 2048;
constexpr int kThreads = 128;

// V = 4 spills at W = 13 (ptxas -v), so 2 from there on
template <int W>
constexpr int vec_width() {
  return W <= 12 ? 4 : 2;
}

// Reverse complement of the 16 bases of a word.
__device__ __forceinline__ uint32_t revcomp(uint32_t x) {
  const uint32_t y = __brev(x);
  return ~(((y & 0x55555555u) << 1) | ((y >> 1) & 0x55555555u));
}

// Top 32 bits of (hi:lo) << s, 0 <= s < 32.
__device__ __forceinline__ uint32_t funnel(uint32_t hi, uint32_t lo, int s) {
  return __funnelshift_l(lo, hi, s);
}

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* s, uint32_t* d) {
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(s);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(s);
    d[0] = x.x, d[1] = x.y;
  } else {
    d[0] = s[0];
  }
}

template <int V>
__device__ __forceinline__ void store_stream(uint32_t* g, const uint32_t* w) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<uint4*>(g), make_uint4(w[0], w[1], w[2], w[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<uint2*>(g), make_uint2(w[0], w[1]));
  } else {
    __stcs(g, w[0]);
  }
}

// mbarrier and bulk copy (one use a block: parity 0)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_tile(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(1u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  }
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

template <int W, int V>
struct Shape {
  static constexpr int kStarts = kThreads * V;  // window starts a block
  static constexpr int kWords = V * ((V + W + V - 1) / V);  // a thread's
  // a block's words, rounded up to 16 B for the bulk copy
  static constexpr int kTile = (kStarts - V + kWords + 3) / 4 * 4;
  static_assert(kBlockQ % kStarts == 0, "a block lies in one kBlockQ block");
};

// The V keys of one phase (forward shift s; the reverse complement's
// word offset kHi and bit shift ofs), stored to plane rows at dst.
template <int W, int V, bool kHi>
__device__ __forceinline__ void phase(const uint32_t* a, const uint32_t* b,
                                      int s, int ofs, uint32_t tail,
                                      uint32_t* dst, long long n_out) {
  uint32_t key[W][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uint32_t fwd[W], rc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) fwd[i] = funnel(a[v + i], a[v + i + 1], s);
    fwd[W - 1] &= tail;
    // the reverse complement of a[v .. v+W] is b[v+W], ..., b[v]; the
    // word after it that the shift reaches (b[v - 1], 0 at v = 0) only
    // feeds bits that the tail mask clears
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int j = v + W - i - (kHi ? 1 : 0);
      rc[i] = funnel(b[j], j >= 1 ? b[j >= 1 ? j - 1 : 0] : 0u, ofs);
    }
    rc[W - 1] &= tail;
    // canonical = rc only when strictly smaller
    bool lt = false;
#pragma unroll
    for (int i = W - 1; i >= 0; --i)
      lt = rc[i] < fwd[i] || (rc[i] == fwd[i] && lt);
#pragma unroll
    for (int i = 0; i < W; ++i) key[i][v] = lt ? rc[i] : fwd[i];
  }
#pragma unroll
  for (int i = 0; i < W; ++i) store_stream<V>(dst + i * n_out, key[i]);
}

template <int W, int V>
__global__ void __launch_bounds__(kThreads)
canon_kernel(const uint32_t* __restrict__ packed, long long p,
             uint32_t* __restrict__ out, long long n_out, int k) {
  using S = Shape<W, V>;
  __shared__ __align__(16) uint32_t tile[S::kTile];
  __shared__ __align__(8) uint64_t bar;

  const long long q0 = (long long)blockIdx.x * S::kStarts;
  if ((reinterpret_cast<uintptr_t>(packed) & 15) == 0 && q0 + S::kTile <= p) {
    bulk_tile(tile, packed + q0, S::kTile * 4, &bar);
  } else {
    for (int j = threadIdx.x; j < S::kTile; j += kThreads)
      tile[j] = q0 + j < p ? __ldg(packed + q0 + j) : 0u;
    __syncthreads();
  }

  uint32_t a[S::kWords], b[S::kWords];
#pragma unroll
  for (int j = 0; j < S::kWords; j += V)
    load_words<V>(tile + threadIdx.x * V + j, a + j);
#pragma unroll
  for (int j = 0; j < S::kWords; ++j) b[j] = revcomp(a[j]);

  const int used = k - (W - 1) * 16;  // bases in the last word, 1..16
  const uint32_t tail = used < 16 ? (0xFFFFFFFFu << (32 - 2 * used))
                                  : 0xFFFFFFFFu;
  const int sh = 2 * (W * 16 - k);  // revcomp realignment, 0..30
  const long long blk = q0 / kBlockQ;
  uint32_t* dst = out + blk * (kBlockQ * 16) + (q0 - blk * kBlockQ) +
                  threadIdx.x * V;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (sh >= 2 * r)
      phase<W, V, true>(a, b, 2 * r, sh - 2 * r, tail, dst + r * kBlockQ,
                        n_out);
    else
      phase<W, V, false>(a, b, 2 * r, 32 + sh - 2 * r, tail,
                         dst + r * kBlockQ, n_out);
  }
}

template <int W>
cudaError_t launch(const uint32_t* in, long long p, uint32_t* o,
                   long long n_out, int k, cudaStream_t s) {
  constexpr int V = vec_width<W>();
  const dim3 grid((unsigned)(n_out / 16 / Shape<W, V>::kStarts));
  canon_kernel<W, V><<<grid, kThreads, 0, s>>>(in, p, o, n_out, k);
  return cudaGetLastError();
}

}  // namespace

// packed: (p,) u32 words, any 4-B offset; words past p read as zero.
// out: (W, n_out) u32, n_out = q_pad * 16, q_pad = p - W rounded up to
// a multiple of 2048. Returns the cudaError_t of the launch.
extern "C" int canonical_all_kmers_launch(const void* packed, long long p,
                                          void* out, long long n_out, int k,
                                          void* stream) {
  const int w = (k + 15) / 16;
  if (k < 1 || k > 255 || p <= w || n_out <= 0 ||
      n_out % (kBlockQ * 16) != 0 || n_out / 16 < p - w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(packed);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (w) {
#define CANON_CASE(N) \
  case N:             \
    return (int)launch<N>(in, p, o, n_out, k, s);
    CANON_CASE(1) CANON_CASE(2) CANON_CASE(3) CANON_CASE(4)
    CANON_CASE(5) CANON_CASE(6) CANON_CASE(7) CANON_CASE(8)
    CANON_CASE(9) CANON_CASE(10) CANON_CASE(11) CANON_CASE(12)
    CANON_CASE(13) CANON_CASE(14) CANON_CASE(15) CANON_CASE(16)
#undef CANON_CASE
  }
  return (int)cudaErrorInvalidValue;
}
