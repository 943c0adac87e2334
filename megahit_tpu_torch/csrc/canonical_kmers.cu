// Canonical k-mer keys at every base offset of a 2-bit packed pool.
//
// Replaces megahit_tpu/core/pallas_kernels.py canonical_all_kmers_pallas
// (kernel body _canon_kernel). Same output, bit for bit: (W, n_out) u32
// words, PHASE-GROUPED - within each block of kBlockQ window starts,
// column r * kBlockQ + q_local holds the canonical key at base offset
// (block * kBlockQ + q_local) * 16 + r.
//
// Bound: bytes. The pool is read once from memory (4 B a word) and W*4 B
// are written per base offset. One thread per output column; neighbouring
// threads take neighbouring window starts of one phase r, so both the
// loads of the w+1 input words and the W stores coalesce, and the 16
// phases of a window start re-read its words from L2. The Pallas
// kernel's w+1 pre-shifted input views (a Mosaic load-alignment
// workaround) and its 2048-start grid have no counterpart here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libcanonical_kmers.so canonical_kmers.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 2048;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t reverse_bases(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = ((x & 0x00FF00FFu) << 8) | ((x & 0xFF00FF00u) >> 8);
  return (x << 16) | (x >> 16);
}

// Top 32 bits of (hi:lo) << s, 0 <= s < 32.
__device__ __forceinline__ uint32_t funnel(uint32_t hi, uint32_t lo, int s) {
  return __funnelshift_l(lo, hi, s);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
canon_kernel(const uint32_t* __restrict__ packed, uint32_t* __restrict__ out,
             long long n_out, int k) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n_out) return;
  const long long blk = col / (kBlockQ * 16);
  const int rem = (int)(col - blk * (kBlockQ * 16));
  const int r = rem / kBlockQ;
  const long long q = blk * kBlockQ + (rem - r * kBlockQ);

  uint32_t a[W + 1];
#pragma unroll
  for (int i = 0; i <= W; ++i) a[i] = packed[q + i];

  const int used = k - (W - 1) * 16;  // bases in the last word, 1..16
  const uint32_t tail = used < 16 ? (0xFFFFFFFFu << (32 - 2 * used))
                                  : 0xFFFFFFFFu;
  const int sh = 2 * (W * 16 - k);  // revcomp realignment, 0..30

  uint32_t fwd[W];
#pragma unroll
  for (int i = 0; i < W; ++i) fwd[i] = funnel(a[i], a[i + 1], 2 * r);
  fwd[W - 1] &= tail;

  // reverse complement: complement + 2-bit reversal per word, word
  // order reversed, then a left shift by sh bits across words
  uint32_t rev[W];
#pragma unroll
  for (int i = 0; i < W; ++i) rev[i] = reverse_bases(~fwd[W - 1 - i]);
  uint32_t rc[W];
#pragma unroll
  for (int i = 0; i < W; ++i)
    rc[i] = funnel(rev[i], i + 1 < W ? rev[i + 1] : 0u, sh);
  rc[W - 1] &= tail;

  // canonical = rc only when strictly smaller
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    lt = lt || (eq && rc[i] < fwd[i]);
    eq = eq && rc[i] == fwd[i];
  }
#pragma unroll
  for (int i = 0; i < W; ++i)
    out[(long long)i * n_out + col] = lt ? rc[i] : fwd[i];
}

}  // namespace

// packed: (q_pad + W,) u32 words, zero-padded by the caller.
// out: (W, n_out) u32, n_out = q_pad * 16, q_pad a multiple of 2048.
// Returns the cudaError_t of the launch.
extern "C" int canonical_all_kmers_launch(const void* packed, void* out,
                                          long long n_out, int k,
                                          void* stream) {
  const int w = (k + 15) / 16;
  const dim3 grid((unsigned)((n_out + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(packed);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (w) {
#define CANON_CASE(N) \
  case N:             \
    canon_kernel<N><<<grid, block, 0, s>>>(in, o, n_out, k); \
    break;
    CANON_CASE(1) CANON_CASE(2) CANON_CASE(3) CANON_CASE(4)
    CANON_CASE(5) CANON_CASE(6) CANON_CASE(7) CANON_CASE(8)
    CANON_CASE(9) CANON_CASE(10) CANON_CASE(11) CANON_CASE(12)
    CANON_CASE(13) CANON_CASE(14) CANON_CASE(15) CANON_CASE(16)
#undef CANON_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
