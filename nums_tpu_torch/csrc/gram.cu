// Symmetric gram  G = XᵀX  and weighted gram  G = Xᵀ·diag(s)·X  for Hopper.
//
// Replaces the Pallas TPU kernels nums_tpu/core/ops/pallas_gram.py:
// _make_kernel(scaled=False) / _gram_call (K1) and
// _make_kernel(scaled=True) (K2).
//
// What it computes, as the TPU kernel does:
//   * only the upper-triangular tile pairs (ti <= tj) of G;
//   * every input is rounded to bf16 (round to nearest even) and the MACs
//     accumulate in f32. The product of two bf16 values is exact in f32,
//     so a plain SIMT FMA loop on bf16-rounded operands is bit for bit the
//     reference's "bf16 MACs, f32 accumulation" class;
//   * with s, each row is scaled by sqrt(s) in f32 BEFORE the bf16
//     rounding (pallas_gram.py:81-84), so sqrt(s)·X never exists in memory;
//   * G is exactly symmetric: the lower triangle copies the upper one
//     element by element.
//
// Design. The TPU kernel keeps the whole (d, d) f32 accumulator in VMEM
// and walks the rows in order. A Hopper block has 227 KB of shared memory
// (4 MB for G at d = 1000), and blocks run in no order, so:
//   1. gram_tiles: grid = (upper tile pair) x (row split). Each block loops
//      over its rows, stages the two 64-column strips of a 32-row chunk in
//      shared memory (bf16-rounded, masked to zero past n and d), and
//      accumulates its 64x64 tile in registers (4x4 per thread). Each chunk
//      is summed apart first and then added to the running tile, which
//      keeps the f32 rounding error of long row loops small. The tile goes
//      to a per-split workspace.
//   2. gram_reduce: one thread per element of G sums the splits in a fixed
//      order (no atomics, so the result does not change from run to run)
//      and reads element (min(i,j), max(i,j)), which mirrors the lower
//      triangle.
// No cap on d and no alignment rule: ragged rows and columns are masked by
// index, and nothing is read out of bounds.
//
// Bound: at 2.5M x 1000 the upper triangle is about 2·n·d²/2 = 2.5 TFLOP
// against a single 10 GB read of X. On the SIMT f32 units that this simple
// version uses (67 TFLOP/s peak) that is at least 37 ms of compute against
// 3 ms of reading, so the kernel is bound by compute; it also re-reads each
// strip once per tile pair through L2. Left on the table: the bf16 tensor
// cores (wgmma, 989 TFLOP/s: 2.5 ms, about even with the read), TMA-fed
// shared-memory rings, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 32;    // rows staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Row-major enumeration of the upper tile pairs: pair p -> (ti, tj).
__device__ __forceinline__ void decode_pair(int p, int t, int* ti, int* tj) {
  int i = 0;
  int rem = p;
  while (rem >= t - i) {
    rem -= t - i;
    ++i;
  }
  *ti = i;
  *tj = i + rem;
}

__device__ __forceinline__ long long pair_index(int ti, int tj, int t) {
  return (long long)ti * t - (long long)ti * (ti - 1) / 2 + (tj - ti);
}

__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ x, const float* __restrict__ s,
           float* __restrict__ ws, long long n, long long d, int t,
           long long npairs, long long rows_per_split) {
  __shared__ float a_sm[kChunk][kTile];
  __shared__ float b_sm[kChunk][kTile];
  int ti, tj;
  decode_pair(blockIdx.x, t, &ti, &tj);
  const long long split = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long ca0 = (long long)ti * kTile;
  const long long cb0 = (long long)tj * kTile;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kr = e / kTile;
      const int c = e % kTile;
      const long long r = r0 + kr;
      float a = 0.0f, b = 0.0f;
      if (r < r_end) {
        const float* row = x + r * d;
        const float w = s ? sqrtf(s[r]) : 1.0f;
        if (ca0 + c < d) a = round_bf16(s ? row[ca0 + c] * w : row[ca0 + c]);
        if (cb0 + c < d) b = round_bf16(s ? row[cb0 + c] * w : row[cb0 + c]);
      }
      a_sm[kr][c] = a;
      b_sm[kr][c] = b;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[u][v] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = a_sm[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = b_sm[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[u][v] = fmaf(av[u], bv[v], part[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += part[u][v];
    __syncthreads();
  }

  float* out = ws + (split * npairs + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      out[(ty + 16 * u) * kTile + tx + 16 * v] = acc[u][v];
}

__global__ void gram_reduce(const float* __restrict__ ws, float* __restrict__ g,
                            long long d, int t, long long npairs, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d * d) return;
  const long long i = idx / d;
  const long long j = idx % d;
  const long long a = min(i, j);
  const long long b = max(i, j);
  const long long p = pair_index((int)(a / kTile), (int)(b / kTile), t);
  const long long off = p * kTile * kTile + (a % kTile) * kTile + (b % kTile);
  const long long stride = npairs * kTile * kTile;
  float sum = 0.0f;
  for (int sp = 0; sp < splits; ++sp) sum += ws[sp * stride + off];
  g[idx] = sum;
}

}  // namespace

extern "C" {

// Edge of the output tile; the caller sizes the workspace with it.
int nums_gram_tile() { return kTile; }

// G (d, d) = XᵀX, or Xᵀ·diag(s)·X when s is not NULL. x: (n, d) f32
// row-major; s: (n,) f32 >= 0; ws: splits * npairs * 64 * 64 f32 scratch.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int nums_gram(const float* x, const float* s, float* ws, float* g,
              long long n, long long d, int splits, void* stream) {
  const int t = (int)((d + kTile - 1) / kTile);
  const long long npairs = (long long)t * (t + 1) / 2;
  long long rows_per_split = (n + splits - 1) / splits;
  rows_per_split = (rows_per_split + kChunk - 1) / kChunk * kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_tiles<<<dim3((unsigned)npairs, (unsigned)splits), kThreads, 0, st>>>(
      x, s, ws, n, d, t, npairs, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = d * d;
  const int threads = 256;
  gram_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      ws, g, d, t, npairs, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
