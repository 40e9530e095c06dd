// GLM Newton statistics for Hopper: the row pass and the gradient of one
// Newton iteration. The Hessian is the weighted gram of gram.cu.
//
// Replaces the Pallas TPU kernel nums_tpu/core/ops/pallas_newton.py:
// _link / _make_kernel / _stats_call (K3). For one iteration it computes
//   eta = X·beta              bf16 operands, exact products
//   mu, s = link(eta)         logistic: mu = 1/(1+e^-eta), s = mu(1-mu)
//                             linear:   mu = eta, no weight
//                             poisson:  mu = e^eta, s = mu
//   r = mu - y
//   g = Xᵀ·r                  bf16 operands, f32 accumulation
// and the caller adds H = Xᵀ·diag(s)·X with gram.cu (K2's kernel), or XᵀX
// (K1's) for the linear kind.
//
// Design. The TPU kernel does all of it in one pass per row chunk, with
// the (d, d) Hessian resident in VMEM. On Hopper eta needs a whole row
// before g and H can use it, and H cannot stay on chip, so the work is
// split in three steps, each reading X once:
//   1. newton_rows: one warp per row computes eta, the link, r and s.
//      Rows past n do not exist here, which is the reference's mask of r
//      and s on out-of-range rows (pallas_newton.py:95-104). eta
//      accumulates in f64 (the bf16 products are exact in either type);
//      the kernel and its plain version then round eta, and so r and s,
//      identically, and differ only in the order of the f32 sums of g and H.
//   2. newton_grad: a (column strip) x (row split) grid; each thread owns
//      one column, sums bf16(x)·bf16(r) over its rows in 64-row parts, and
//      writes a per-split partial; newton_grad_reduce sums the splits in a
//      fixed order (no atomics).
//   3. the weighted gram (gram.cu) with the TPU Newton kernel's rounding:
//      bf16(bf16(x)·bf16(sqrt(s))) (pallas_newton.py:114, mode 2 of
//      gram.cu's staging pass), or XᵀX (mode 0) for the linear kind. The
//      plain version rounds the same way.
//
// Bound: the row pass and the gradient each read X once (10 GB at
// 2.5M x 1001) with a few flops per element, so they are bound by memory
// bandwidth (3.35 TB/s), and so is the gram's staging pass, which reads X
// a third time; the gram itself runs on the tensor cores (see gram.cu).
// Left on the table: one read of X for all three steps (the TPU design),
// for instance the staging pass fused into newton_grad, and vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;  // 8 warps, one row each
constexpr int kColThreads = 256;  // columns per gradient block
constexpr int kPart = 64;         // rows summed apart in the gradient

enum Kind { kLogistic = 0, kLinear = 1, kPoisson = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kRowThreads)
newton_rows(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ beta, float* __restrict__ r,
            float* __restrict__ s, long long n, long long d, int kind) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kRowThreads / 32) +
                        threadIdx.x / 32;
  if (row >= n) return;
  const float* xr = x + row * d;
  double acc = 0.0;
  for (long long c = lane; c < d; c += 32)
    acc += (double)round_bf16(xr[c]) * (double)round_bf16(beta[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const float eta = (float)acc;
  float mu, w;
  if (kind == kLogistic) {
    mu = 1.0f / (1.0f + expf(-eta));
    w = mu * (1.0f - mu);
  } else if (kind == kPoisson) {
    mu = expf(eta);
    w = mu;
  } else {
    mu = eta;
    w = 1.0f;
  }
  r[row] = mu - y[row];
  if (s) s[row] = w;
}

__global__ void __launch_bounds__(kColThreads)
newton_grad(const float* __restrict__ x, const float* __restrict__ r,
            float* __restrict__ gws, long long n, long long d,
            long long rows_per_split) {
  const long long c = (long long)blockIdx.x * kColThreads + threadIdx.x;
  const long long split = blockIdx.y;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);
  if (c >= d) return;
  float acc = 0.0f;
  for (long long r0 = r_begin; r0 < r_end; r0 += kPart) {
    const long long stop = min(r_end, r0 + kPart);
    float part = 0.0f;
    for (long long row = r0; row < stop; ++row)
      part = fmaf(round_bf16(x[row * d + c]), round_bf16(r[row]), part);
    acc += part;
  }
  gws[split * d + c] = acc;
}

__global__ void newton_grad_reduce(const float* __restrict__ gws,
                                   float* __restrict__ g, long long d,
                                   int splits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float sum = 0.0f;
  for (int sp = 0; sp < splits; ++sp) sum += gws[sp * d + c];
  g[c] = sum;
}

}  // namespace

extern "C" {

// Row pass and gradient of one Newton iteration. x: (n, d) f32 row-major;
// y: (n,) f32; beta: (d,) f32; r: (n,) f32 scratch; s: (n,) f32 output of
// the Hessian weight, or NULL for the linear kind; gws: splits * d f32
// scratch; g: (d,) f32 output. kind: 0 logistic, 1 linear, 2 poisson.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int nums_newton_stats(const float* x, const float* y, const float* beta,
                      float* r, float* s, float* gws, float* g, long long n,
                      long long d, int kind, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kRowThreads / 32;
  newton_rows<<<(unsigned)((n + rows_per_block - 1) / rows_per_block),
                kRowThreads, 0, st>>>(x, y, beta, r, s, n, d, kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_split = (n + splits - 1) / splits;
  const unsigned col_blocks = (unsigned)((d + kColThreads - 1) / kColThreads);
  newton_grad<<<dim3(col_blocks, (unsigned)splits), kColThreads, 0, st>>>(
      x, r, gws, n, d, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  newton_grad_reduce<<<(unsigned)((d + 255) / 256), 256, 0, st>>>(gws, g, d,
                                                                 splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
