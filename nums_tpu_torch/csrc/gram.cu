// Symmetric gram  G = XᵀX  and weighted gram  G = Xᵀ·diag(s)·X  for Hopper,
// on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernels nums_tpu/core/ops/pallas_gram.py:
// _make_kernel(scaled=False) / _gram_call (K1) and
// _make_kernel(scaled=True) (K2), and computes the Hessian of
// nums_tpu/core/ops/pallas_newton.py (K3) with that kernel's rounding.
//
// What it computes, as the TPU kernels do:
//   * only the upper-triangular tile pairs (ti <= tj) of G;
//   * every operand is rounded to bf16 (round to nearest even) and the MACs
//     accumulate in f32. The product of two bf16 values is exact in f32, so
//     tensor cores that accumulate in f32 stay in the reference's class,
//     "bf16 MACs, f32 accumulation". The rounding has three modes:
//       0  bf16(x)                          K1, and K3's linear kind;
//       1  bf16(x·sqrt(s)), scaled in f32   K2 (pallas_gram.py:81-84);
//       2  bf16(bf16(x)·bf16(sqrt(s)))      K3's H (pallas_newton.py:114);
//   * G is exactly symmetric: the lower triangle copies the upper one
//     element by element, and the result is the same from run to run.
//
// Bound. At 2.5M x 1000 the upper 128x128 tile pairs are 36 of 64, about
// 2·n·36·128² = 2.95 TFLOP: 3 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 3 ms to read the 10 GB of X once at 3.35 TB/s. The kernel this
// one replaced ran its MACs as SIMT f32 FMAs (67 TFLOP/s peak) and reached
// 13-14 TFLOP/s: 190 ms, bound by the FMA units and the per-element bf16
// conversion inside its row loop. This design, measured on an H100 80GB
// HBM3 at 700 W: the staging pass 5.8 ms (2.6 TB/s); gram_mma 7.7 ms, of
// which its loads alone take 7.1 ms and its wgmmas alone 3.8 ms. Each block
// moves 32 KB from L2 for 2 MFLOP, so the 36 pairs pull 41 GB through L2
// (5.8 TB/s), the same with the operands held in L2: gram_mma is bound by
// L2-to-SM traffic, not by device memory or the tensor cores. Larger tiles
// or TMA multicast across a cluster would cut that traffic.
//
// Design, three launches on one stream:
//   1. gram_stage (bound by memory bandwidth) reads X in f32 (and s),
//      applies the mode's rounding once and writes a bf16 copy of Xᵀ,
//      (d_pad, n_pad), through 64x64 shared-memory tiles so that both the
//      reads and the writes coalesce. d_pad is d rounded up to the output
//      tile and n_pad is n rounded up to the K tile; the pad is zero. Both
//      wgmma operands are then K-major rows of this copy, every row stride
//      is a multiple of 16 bytes as TMA requires (X's own is 4004 bytes at
//      d = 1001), and the zero pad replaces all masking in the hot loop.
//      At 2.5M x 1000: 10 GB in, 5.1 GB out, and 5.1 GB of scratch.
//   2. gram_mma: one block per (upper tile pair) x (row split), the pairs of
//      a split adjacent in launch order, so that the blocks over the same
//      rows run together and read each row panel from device memory about
//      once (the other pairs of the panel read it from L2). One producer
//      warp keeps TMA loads (128-byte swizzle) of the two 128-row strips in
//      a 6-stage shared-memory ring, completed on mbarriers; a diagonal pair
//      loads its one strip once. Two consumer warpgroups issue
//      wgmma m64n128k16 (f32 += bf16·bf16), 64 output rows each. The tensor
//      cores' own f32 accumulation is summed in runs of 256 rows that start
//      from zero and are then added to a running f32 tile, which keeps the
//      error of long row loops small (the kernel this one replaced summed
//      32-row runs the same way). The 128x128 f32 tile goes to a per-split
//      workspace.
//   3. gram_reduce sums the splits in a fixed order (no atomics) and reads
//      element (min(i,j), max(i,j)), which mirrors the lower triangle.
// Any n and d work: the user's tensor has no alignment rule, and nothing is
// read out of bounds (the staging pass masks by index; the TMA boxes lie
// inside the padded copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 128;      // output tile edge, wgmma M (2 x 64) and N
constexpr int kK = 64;          // rows of X per stage: 128 bytes of bf16
constexpr int kStages = 6;      // shared-memory ring depth
constexpr int kRunTiles = 4;    // K tiles summed apart (256 rows)
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kMmaThreads = (kConsumers * 4 + 1) * 32;  // + one producer warp
constexpr int kStripBytes = kTile * kK * 2;             // one 128 x 64 box
constexpr int kSmemBytes = 1024 + kStages * 2 * kStripBytes + kStages * 2 * 8;
constexpr int kStageEdge = 64;  // transpose tile of the staging pass
constexpr int kStageThreads = 256;

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

// Pins the accumulator registers in program order around wgmma, so the
// compiler neither reads them before a wait nor moves writes past a fence.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kStageThreads)
gram_stage(const float* __restrict__ x, const float* __restrict__ s,
           __nv_bfloat16* __restrict__ xt, long long n, long long d,
           long long n_pad, int mode) {
  constexpr int kRowsPerPass = kStageThreads / kStageEdge;
  constexpr int kPasses = kStageEdge / kRowsPerPass;
  __shared__ __nv_bfloat16 tile[kStageEdge][kStageEdge + 2];  // [col][row]
  __shared__ float w_sm[kStageEdge];  // sqrt(s) of the tile's rows
  const long long r0 = (long long)blockIdx.x * kStageEdge;
  const long long c0 = (long long)blockIdx.y * kStageEdge;
  if (mode != 0 && threadIdx.x < kStageEdge) {
    const long long r = r0 + threadIdx.x;
    w_sm[threadIdx.x] = r < n ? sqrtf(s[r]) : 0.0f;
  }
  const int tc = threadIdx.x % kStageEdge;
  const int tr = threadIdx.x / kStageEdge;
  const long long c = c0 + tc;
  float v[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {  // all loads first, then the math
    const long long r = r0 + tr + u * kRowsPerPass;
    v[u] = (r < n && c < d) ? x[r * d + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int k = tr + u * kRowsPerPass;
    float e = v[u];
    if (mode == 1) {
      e = e * w_sm[k];
    } else if (mode == 2) {
      e = round_bf16(e) * round_bf16(w_sm[k]);
    }
    tile[tc][k] = __float2bfloat16_rn(e);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int k = threadIdx.x / 32; k < kStageEdge; k += kStageThreads / 32) {
    __nv_bfloat162 v2;
    v2.x = tile[k][2 * lane];
    v2.y = tile[k][2 * lane + 1];
    *reinterpret_cast<__nv_bfloat162*>(xt + (c0 + k) * n_pad + r0 +
                                       2 * lane) = v2;
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
gram_mma(const __grid_constant__ CUtensorMap xt_map, float* __restrict__ ws,
         int t, int npairs, int tiles_per_split, int k_tiles) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint8_t* a_sm = base;
  uint8_t* b_sm = base + kStages * kStripBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + 2 * kStages * kStripBytes);
  uint64_t* empty = full + kStages;

  const int pair = blockIdx.x % npairs;
  const int split = blockIdx.x / npairs;
  int ti, tj;
  decode_pair(pair, t, &ti, &tj);
  const bool diag = ti == tj;
  const int kt0 = split * tiles_per_split;
  const int nk = max(0, min(k_tiles, kt0 + tiles_per_split) - kt0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers * 4);  // one arrive per warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // producer warp
    if (lane == 0) {
      hopper::tma_prefetch_map(&xt_map);
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st],
                                      diag ? kStripBytes : 2 * kStripBytes);
        const int k = (kt0 + i) * kK;
        hopper::tma_load_2d(a_sm + st * kStripBytes, &xt_map, &full[st], k,
                            ti * kTile);
        if (!diag)
          hopper::tma_load_2d(b_sm + st * kStripBytes, &xt_map, &full[st], k,
                              tj * kTile);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows 64·wg .. 64·wg + 63 of the tile.
  const int wg = warp / 4;
  float part[64];
  float total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    part[i] = 0.0f;
    total[i] = 0.0f;
  }
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* a = a_sm + st * kStripBytes + wg * 64 * kK * 2;
    const uint8_t* b = (diag ? a_sm : b_sm) + st * kStripBytes;
    const uint64_t da = hopper::desc_sw128(a);
    const uint64_t db = hopper::desc_sw128(b);
    const int fresh = i % kRunTiles == 0;  // first tile of a run
    hopper::wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)  // 16 values = 32 bytes = 2 units
      hopper::wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk,
                               (fresh && kk == 0) ? 0 : 1);
    hopper::wgmma_commit();
    // Waiting for this group before the next is issued measured faster
    // than keeping one group in flight (ptxas then serialises the wgmmas).
    hopper::wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (i % kRunTiles == kRunTiles - 1 || i == nk - 1) {
#pragma unroll
      for (int j = 0; j < 64; ++j) total[j] += part[j];
    }
  }

  float* out = ws + ((long long)split * npairs + pair) * kTile * kTile;
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + row * kTile + col) =
        make_float2(total[i], total[i + 1]);
  }
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

// Edge of the output tile (d is padded to it) and rows per K tile (n is
// padded to it); the caller sizes the staged copy and the workspace.
int nums_gram_tile() { return kTile; }
int nums_gram_ktile() { return kK; }

// Staging pass: xt (d_pad, n_pad) bf16 = the mode's rounding of Xᵀ, zero
// in the pad. x: (n, d) f32 row-major; s: (n,) f32 >= 0, or NULL for
// mode 0. d_pad and n_pad are multiples of 128 and 64. Launches on
// `stream`, does not synchronise; returns cudaGetLastError().
int nums_gram_stage(const float* x, const float* s, void* xt, long long n,
                    long long d, long long n_pad, long long d_pad, int mode,
                    void* stream) {
  const dim3 grid((unsigned)(n_pad / kStageEdge),
                  (unsigned)(d_pad / kStageEdge));
  gram_stage<<<grid, kStageThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, s, static_cast<__nv_bfloat16*>(xt), n, d, n_pad, mode);
  return (int)cudaGetLastError();
}

// G (d, d) from the staged copy xt (d_pad, n_pad). ws: splits · npairs ·
// 128 · 128 f32 scratch, npairs = t(t+1)/2 with t = d_pad / 128. Returns
// cudaGetLastError(), or -1 if cuTensorMapEncodeTiled refuses the TMA
// tensor map.
int nums_gram_staged(const void* xt, float* ws, float* g, long long d,
                     long long n_pad, long long d_pad, int splits,
                     void* stream) {
  const int t = (int)(d_pad / kTile);
  const int npairs = t * (t + 1) / 2;
  const int k_tiles = (int)(n_pad / kK);
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  CUtensorMap map;
  if (!hopper::make_map_bf16(&map, xt, (uint64_t)d_pad, (uint64_t)n_pad, kTile,
                             kK))
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      gram_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_mma<<<(unsigned)(npairs * splits), kMmaThreads, kSmemBytes, st>>>(
      map, ws, t, npairs, tiles_per_split, k_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = d * d;
  const int threads = 256;
  gram_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      ws, g, d, t, npairs, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
