// GLM Newton statistics for Hopper: the row pass and the gradient of one
// Newton iteration, and the scaled operand of its Hessian. The Hessian is
// the gram of gram.cu.
//
// Replaces the Pallas TPU kernel nums_tpu/core/ops/pallas_newton.py:
// _link / _make_kernel / _stats_call (K3). For one iteration it computes
//   eta = X·beta              bf16 operands, exact products
//   mu, s = link(eta)         logistic: mu = 1/(1+e^-eta), s = mu(1-mu)
//                             linear:   mu = eta, no weight
//                             poisson:  mu = e^eta, s = mu
//   r = mu - y
//   g = Xᵀ·r                  bf16 operands, f32 accumulation
// and the caller adds H = Xᵀ·diag(s)·X with gram.cu's gram_mma, or XᵀX for
// the linear kind.
//
// Design. Every use of X in the TPU kernel is bf16(x): eta takes
// bf16(x)·bf16(beta) (pallas_newton.py:80-92), g takes bf16(x)·bf16(r)
// (:105-109) and H takes bf16(bf16(x)·bf16(sqrt(s))) (:114), which follows
// exactly from bf16(x). X does not change across the iterations of a fit,
// so the fp32 X is read once per fit, by gram.cu's staging pass in mode 0:
// the bf16 copy of Xᵀ, (d_pad, n_pad), zero in the pad. Each iteration then
// reads only that copy (5.1 GB at 2.5M x 1001, against 10 GB for one read
// of the fp32 X), in two passes and the gram:
//   1. newton_eta: each thread owns 8 consecutive rows, so one 16-byte load
//      is one feature of its rows and a warp's load is 512 contiguous bytes.
//      It walks the d features with kEtaUnroll loads in flight, bf16(beta)
//      in shared memory. eta accumulates in f64 (the bf16 products are
//      exact in either type); the kernel and its plain version then round
//      eta, and so r and s, alike. It writes bf16(r) and, where the kind
//      has a weight, bf16(sqrt(s)), zero past n: rows past n do not exist,
//      which is the reference's mask of r and s on out-of-range rows
//      (pallas_newton.py:95-104).
//   2. newton_grad_scale: one pass over the staged copy with 16-byte loads,
//      a block per (kGradFeatures features) x (row split). Each thread adds
//      bf16(x)·bf16(r) to one f32 sum per feature; the block sums its
//      threads in a fixed order and writes a per-split partial, which
//      newton_grad_reduce sums in split order (no atomics). For the
//      weighted kinds it also writes bf16(bf16(x)·bf16(sqrt(s))) into a
//      second (d_pad, n_pad) buffer of the same layout and zero pad: the
//      operand of H in the TPU kernel's rounding (mode 2 of gram.cu). The
//      linear kind writes nothing: its H is the gram of the staged copy.
//   3. gram_mma + gram_reduce (gram.cu) on the scaled buffer, or on the
//      staged copy for the linear kind.
//
// Bound: both passes do a few operations per element and are bound by
// memory bandwidth (3.35 TB/s): newton_eta reads the bf16 copy once (5.1
// GB, 1.5 ms), newton_grad_scale reads it once and writes the scaled
// buffer (10.2 GB, 3.0 ms). The gram runs on the tensor cores (gram.cu).
// Left on the table: applying sqrt(s) inside gram_mma's consumer
// warpgroups, which would save the scaled buffer's write and read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // rows per thread: 16 bytes of bf16
constexpr int kEtaUnroll = 8;        // feature loads in flight, newton_eta
constexpr int kBetaChunk = 2048;     // features of bf16(beta) in shared memory
constexpr int kGradFeatures = 16;    // features per newton_grad_scale block
constexpr int kRowsPerIter = kThreads * kVec;  // rows of a block per step

enum Kind { kLogistic = 0, kLinear = 1, kPoisson = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 8 bf16 values of a 16-byte load, in f32 (exact).
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 8 f32 values rounded to bf16 (round to nearest even), as one 16-byte word.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__global__ void __launch_bounds__(kThreads)
newton_eta(const __nv_bfloat16* __restrict__ xt, const float* __restrict__ y,
           const float* __restrict__ beta, __nv_bfloat16* __restrict__ rb,
           __nv_bfloat16* __restrict__ wb, long long n, long long d,
           long long n_pad, int kind) {
  __shared__ float b_sm[kBetaChunk];
  const long long row0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  const bool live = row0 < n_pad;
  const __nv_bfloat16* p = xt + row0;
  double acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0;
  for (long long c0 = 0; c0 < d; c0 += kBetaChunk) {
    const int m = (int)min((long long)kBetaChunk, d - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads)
      b_sm[i] = round_bf16(beta[c0 + i]);
    __syncthreads();
    if (!live) continue;
    const __nv_bfloat16* pc = p + c0 * n_pad;
    int c = 0;
    for (; c + kEtaUnroll <= m; c += kEtaUnroll) {
      uint4 v[kEtaUnroll];
#pragma unroll
      for (int u = 0; u < kEtaUnroll; ++u) v[u] = load16(pc + (c + u) * n_pad);
#pragma unroll
      for (int u = 0; u < kEtaUnroll; ++u) {
        float f[kVec];
        unpack8(v[u], f);
        const float b = b_sm[c + u];
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] += (double)(f[k] * b);
      }
    }
    for (; c < m; ++c) {
      float f[kVec];
      unpack8(load16(pc + c * n_pad), f);
      const float b = b_sm[c];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] += (double)(f[k] * b);
    }
  }
  if (!live) return;
  float r[kVec], w[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long row = row0 + k;
    r[k] = 0.0f;
    w[k] = 0.0f;
    if (row >= n) continue;
    const float eta = (float)acc[k];
    float mu, s;
    if (kind == kLogistic) {
      mu = 1.0f / (1.0f + expf(-eta));
      s = mu * (1.0f - mu);
    } else if (kind == kPoisson) {
      mu = expf(eta);
      s = mu;
    } else {
      mu = eta;
      s = 1.0f;
    }
    r[k] = mu - y[row];
    w[k] = sqrtf(s);
  }
  *reinterpret_cast<uint4*>(rb + row0) = pack8(r);
  if (wb) *reinterpret_cast<uint4*>(wb + row0) = pack8(w);
}

template <bool kScale>
__global__ void __launch_bounds__(kThreads, 2)
newton_grad_scale(const __nv_bfloat16* __restrict__ xt,
                  const __nv_bfloat16* __restrict__ rb,
                  const __nv_bfloat16* __restrict__ wb,
                  __nv_bfloat16* __restrict__ xs, float* __restrict__ gws,
                  long long d, long long n_pad, long long iters_per_split) {
  __shared__ float red[kGradFeatures][kThreads / 32];
  const long long c0 = (long long)blockIdx.x * kGradFeatures;
  const int nf = (int)min((long long)kGradFeatures, d - c0);
  const long long split = blockIdx.y;
  const long long it0 = split * iters_per_split;
  float acc[kGradFeatures];
#pragma unroll
  for (int f = 0; f < kGradFeatures; ++f) acc[f] = 0.0f;
  for (long long it = it0; it < it0 + iters_per_split; ++it) {
    const long long row = (it * kThreads + threadIdx.x) * kVec;
    if (row >= n_pad) break;
    float rf[kVec], wf[kVec];
    unpack8(load16(rb + row), rf);
    if (kScale) unpack8(load16(wb + row), wf);
    uint4 v[kGradFeatures];
#pragma unroll
    for (int f = 0; f < kGradFeatures; ++f)
      if (f < nf) v[f] = load16(xt + (c0 + f) * n_pad + row);
#pragma unroll
    for (int f = 0; f < kGradFeatures; ++f) {
      if (f >= nf) continue;
      float x[kVec];
      unpack8(v[f], x);
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) part = fmaf(x[k], rf[k], part);
      acc[f] += part;
      if (kScale) {
        float sx[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) sx[k] = x[k] * wf[k];  // exact
        *reinterpret_cast<uint4*>(xs + (c0 + f) * n_pad + row) = pack8(sx);
      }
    }
  }
  // Sum the block's threads in a fixed order: a butterfly within each
  // warp, then the warps in order.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int f = 0; f < kGradFeatures; ++f) {
    float v = acc[f];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[f][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < nf) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[threadIdx.x][w];
    gws[split * d + c0 + threadIdx.x] = sum;
  }
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

// Row pass of one Newton iteration. xt: (d_pad, n_pad) bf16, the staged
// copy of Xᵀ (gram.cu, mode 0), n_pad a multiple of 64; y: (n,) f32;
// beta: (d,) f32; rb: (n_pad,) bf16 output, bf16(r); wb: (n_pad,) bf16
// output, bf16(sqrt(s)), or NULL for the linear kind; both zero past n.
// kind: 0 logistic, 1 linear, 2 poisson. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
int nums_newton_eta(const void* xt, const float* y, const float* beta,
                    void* rb, void* wb, long long n, long long d,
                    long long n_pad, int kind, void* stream) {
  const long long blocks = (n_pad + kRowsPerIter - 1) / kRowsPerIter;
  newton_eta<<<(unsigned)blocks, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xt), y, beta,
      static_cast<__nv_bfloat16*>(rb), static_cast<__nv_bfloat16*>(wb), n, d,
      n_pad, kind);
  return (int)cudaGetLastError();
}

// Gradient and scaled operand of one Newton iteration. xt: as above; rb,
// wb: newton_eta's outputs (wb NULL for the linear kind); xs: (d_pad,
// n_pad) bf16 output, bf16(bf16(x)·bf16(sqrt(s))) in xt's layout and zero
// in its pad, or NULL with wb; gws: splits * d f32 scratch; g: (d,) f32
// output. Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
int nums_newton_grad_scale(const void* xt, const void* rb, const void* wb,
                           void* xs, float* gws, float* g, long long d,
                           long long n_pad, long long d_pad, int splits,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(xt);
  const auto* r = static_cast<const __nv_bfloat16*>(rb);
  const auto* w = static_cast<const __nv_bfloat16*>(wb);
  auto* out = static_cast<__nv_bfloat16*>(xs);
  const long long iters = (n_pad + kRowsPerIter - 1) / kRowsPerIter;
  const long long per = (iters + splits - 1) / splits;
  const dim3 grid((unsigned)((d + kGradFeatures - 1) / kGradFeatures),
                  (unsigned)splits);
  cudaError_t err;
  if (out) {
    err = cudaMemsetAsync(out + d * n_pad, 0,
                          (size_t)((d_pad - d) * n_pad) * 2, st);
    if (err != cudaSuccess) return (int)err;
    newton_grad_scale<true><<<grid, kThreads, 0, st>>>(x, r, w, out, gws, d,
                                                       n_pad, per);
  } else {
    newton_grad_scale<false><<<grid, kThreads, 0, st>>>(x, r, w, out, gws,
                                                        d, n_pad, per);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  newton_grad_reduce<<<(unsigned)((d + 255) / 256), 256, 0, st>>>(gws, g, d,
                                                                 splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
