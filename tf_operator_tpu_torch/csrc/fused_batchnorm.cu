// Fused train-mode BatchNorm for Hopper (sm_90a): the kernels K5
// (forward) and K6 (backward).
//
// K5 replaces the TPU kernel tf_operator_tpu/ops/fused_batchnorm.py::_fwd_kernel
// (line 166; launched by _fwd_pallas), K6 replaces
// tf_operator_tpu/ops/fused_batchnorm.py::_bwd_kernel (line 250; launched by
// _bwd_pallas).  Both work on the [R, C] view of an NHWC activation (R =
// N*H*W rows, C channels, row-major), x in float32 or bf16, gamma, beta and
// the statistics in float32.
//
// K5: Sum x and Sum x^2 per channel in float32; mean = Sum x / R, var =
// max(Sum x^2 / R - mean^2, 0) (the biased fast variance), rstd =
// rsqrt(var + eps); y = [relu]((x - mean) * (rstd * gamma) + beta
// [+ residual]) in float32 with one cast at the end.  mean and var are
// written out for the running statistics.
// K6: g = dy, masked to 0 where the saved y is not > 0 under ReLU;
// Sum g (= dbeta) and Sum g * xhat (= dgamma) with xhat = (x - mean) * rstd
// and rstd recomputed from the saved var; dx = gamma * rstd * (g - Sum g / R
// - xhat * Sum g * xhat / R); dres = g (the residual branch's cotangent).
// The residual, dx and dres have x's dtype.
//
// Bound, by bytes at 3.35 TB/s (every input read once, every output written
// once).  ResNet-50 at batch 64 and 224 px, one training step, all 53 norms:
// 711.3 M normalised elements, 353.2 M of them with a residual, 96.3 M in the
// projection norms (no ReLU).  K5 reads x (and the residual) and writes y:
// 3.55 GB, 1.06 ms.  K6 reads dy, x (and y under ReLU) and writes dx (and
// dres): 6.20 GB, 1.85 ms.  The stem norm alone ([802816, 64] bf16): K5 61
// us, K6 123 us.
//
// Why not the TPU design.  The Pallas kernels carry the sums in VMEM across
// a sequential sweep over the rows of one channel tile (grid (C tiles, 2, R
// tiles)).  On the card one CTA per channel tile would give 1 CTA to the
// stem's 64 channels, walking 802,816 rows alone.  So R is split across
// CTAs, and each kernel is two launches, with no atomics, so that the
// result does not change from run to run:
//
// 1. partial sums.  Grid (C tiles of 64 channels, R chunks), about two CTAs
//    for each of the 132 SMs (the wrapper's chunk_rows).  A CTA of 256
//    threads is 8 lanes along C (8 channels each, one 16-byte load of bf16
//    or two of float32) by 32 lanes down the rows; each thread keeps 4 rows
//    of loads in flight.  Where C % 8 != 0 or a pointer is not 16-byte
//    aligned (only the tests' ragged shapes; every ResNet C is a multiple
//    of 64) every load is a masked scalar load.  The 32 row lanes meet in
//    shared memory and are added in a fixed order; the CTA writes its
//    partial sums to a [chunks, C] float32 workspace.
// 2. elementwise pass, on the same grid.  Each CTA adds its channel tile's
//    partials over all chunks in a fixed order (every CTA of a tile does
//    the same additions, so all use the same constants), computes the
//    per-channel constants, and streams its chunk's rows to write y (or dx
//    and dres).  The CTAs of chunk 0 write mean and var (or dgamma and
//    dbeta).
//
// Why two CTAs an SM and not more: every CTA of the elementwise pass adds
// all of its tile's partials again, so the L2 reads of that step grow with
// the square of the chunk count (for the stem, whose one channel tile gets
// every chunk, 264 chunks read 36 MB; 528 would read 143 MB).  At 78-128
// registers a thread, two CTAs of 256 threads are also what an SM holds of
// the elementwise kernels.
//
// So K5 reads x twice and K6 reads dy, x and y twice: at best 71 % (K5)
// and 60 % (K6) of the bound.  A single launch over a CTA cluster or a grid
// barrier, and a chunk of x kept in shared memory between the sums and the
// normalise, are for a later redesign.
//
// Numerics against the plain versions (ops/fused_batchnorm.py), which
// compute the same expressions in the same order: the sums run in another
// order (per-thread sequential, then fixed-order trees); rsqrtf is the
// hardware reciprocal square root (within 2 ulp); nvcc contracts a
// multiply and an add into one fused multiply-add.  Read on the card: the
// moments within 6e-7 relative, a bf16 y within one bf16 ulp of the O(1)
// terms (a y that cancels near 0 can differ by several ulps of itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;                       // channels a thread owns
constexpr int kLanesC = 8;                    // threads across a channel tile
constexpr int kTileC = kVec * kLanesC;        // 64 channels a CTA
constexpr int kLanesR = 32;                   // threads down the rows
constexpr int kThreads = kLanesC * kLanesR;   // 256
constexpr int kUnroll = 4;                    // rows of loads in flight a thread
constexpr int kPartGroups = kThreads / kTileC;  // partial rows summed at once

// 8 values of a row from p (channels c .. c + 7), as float32; `valid`
// channels are read, the rest are 0
template <bool kVecIO>
__device__ __forceinline__ void load8(const float* p, int valid, float (&v)[kVec]) {
  if (kVecIO) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

template <bool kVecIO>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid, float (&v)[kVec]) {
  if (kVecIO) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the upper half of its float32
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  }
}

template <bool kVecIO>
__device__ __forceinline__ void store8(float* p, int valid, const float (&v)[kVec]) {
  if (kVecIO) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < valid) p[j] = v[j];
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <bool kVecIO>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int valid, const float (&v)[kVec]) {
  if (kVecIO) {
    uint4 u;
    u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < valid) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// Where a thread stands: its first channel, how many of its 8 channels lie
// inside C, and its chunk's rows [r0, r1).
struct Place {
  int c, valid, r0, r1, ty, tx;
};

__device__ __forceinline__ Place place(int R, int C, int rows_per_chunk) {
  Place p;
  p.tx = threadIdx.x % kLanesC;
  p.ty = threadIdx.x / kLanesC;
  p.c = blockIdx.x * kTileC + p.tx * kVec;
  p.valid = min(kVec, C - p.c);
  p.r0 = blockIdx.y * rows_per_chunk;
  p.r1 = min(R, p.r0 + rows_per_chunk);
  return p;
}

// The 32 row lanes' sums a[8], b[8] of each thread added in a fixed order
// (row lane 0 first); the CTA's partials go to pa, pb [chunks, C].
__device__ __forceinline__ void write_partials(const Place& p, const float (&a)[kVec],
                                               const float (&b)[kVec], float* pa, float* pb,
                                               int C) {
  __shared__ float red[2][kLanesR][kTileC];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][p.ty][p.tx * kVec + j] = a[j];
    red[1][p.ty][p.tx * kVec + j] = b[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kTileC) {
    const int which = threadIdx.x / kTileC, col = threadIdx.x % kTileC;
    float acc = 0.f;
    for (int i = 0; i < kLanesR; ++i) acc += red[which][i][col];
    const int cc = blockIdx.x * kTileC + col;
    if (cc < C) (which ? pb : pa)[(size_t)blockIdx.y * C + cc] = acc;
  }
}

// The tile's partials over all chunks, added in a fixed order: thread t
// sums the chunks t / 64, t / 64 + 4, ... of channel t % 64, and the four
// groups meet in order.  out[0][col], out[1][col] get the totals.
__device__ __forceinline__ void reduce_partials(const float* pa, const float* pb, int C,
                                                int chunks, float (*out)[kTileC]) {
  __shared__ float red[2][kPartGroups][kTileC];
  const int col = threadIdx.x % kTileC, grp = threadIdx.x / kTileC;
  const int cc = blockIdx.x * kTileC + col;
  float a = 0.f, b = 0.f;
  if (cc < C) {
#pragma unroll 4
    for (int k = grp; k < chunks; k += kPartGroups) {
      a += pa[(size_t)k * C + cc];
      b += pb[(size_t)k * C + cc];
    }
  }
  red[0][grp][col] = a;
  red[1][grp][col] = b;
  __syncthreads();
  if (threadIdx.x < kTileC) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int g = 0; g < kPartGroups; ++g) {
      sa += red[0][g][col];
      sb += red[1][g][col];
    }
    out[0][col] = sa;
    out[1][col] = sb;
  }
}

// ---------------------------------------------------------------------------
// K5

template <typename T, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
bn_fwd_stats(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
             int R, int C, int rows_per_chunk) {
  const Place p = place(R, C, rows_per_chunk);
  float s[kVec] = {}, q[kVec] = {};
  if (p.valid > 0) {
    int r = p.r0 + p.ty;
    for (; r + (kUnroll - 1) * kLanesR < p.r1; r += kUnroll * kLanesR) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load8<kVecIO>(x + (size_t)(r + u * kLanesR) * C + p.c, p.valid, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[j] += v[u][j];
          q[j] += v[u][j] * v[u][j];
        }
    }
    for (; r < p.r1; r += kLanesR) {
      float v[kVec];
      load8<kVecIO>(x + (size_t)r * C + p.c, p.valid, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] += v[j];
        q[j] += v[j] * v[j];
      }
    }
  }
  write_partials(p, s, q, psum, psq, C);
}

template <typename T, bool kVecIO, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads)
bn_fwd_apply(const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ psum, const float* __restrict__ psq,
             T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ var_out,
             int R, int C, int rows_per_chunk, int chunks, float inv_n, float eps) {
  __shared__ float tot[2][kTileC];
  __shared__ float s_mu[kTileC], s_mul[kTileC], s_beta[kTileC];
  reduce_partials(psum, psq, C, chunks, tot);
  __syncthreads();
  if (threadIdx.x < kTileC) {
    const int cc = blockIdx.x * kTileC + threadIdx.x;
    float mu = 0.f, mul = 0.f, b = 0.f;
    if (cc < C) {
      mu = tot[0][threadIdx.x] * inv_n;
      const float var = fmaxf(tot[1][threadIdx.x] * inv_n - mu * mu, 0.f);
      mul = rsqrtf(var + eps) * gamma[cc];
      b = beta[cc];
      if (blockIdx.y == 0) {
        mean_out[cc] = mu;
        var_out[cc] = var;
      }
    }
    s_mu[threadIdx.x] = mu;
    s_mul[threadIdx.x] = mul;
    s_beta[threadIdx.x] = b;
  }
  __syncthreads();
  const Place p = place(R, C, rows_per_chunk);
  if (p.valid <= 0) return;
  float mu[kVec], mul[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mu[j] = s_mu[p.tx * kVec + j];
    mul[j] = s_mul[p.tx * kVec + j];
    b[j] = s_beta[p.tx * kVec + j];
  }
  int r = p.r0 + p.ty;
  auto row = [&](const float (&v)[kVec], const float (&rv)[kVec], int rr) {
    float o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t = (v[j] - mu[j]) * mul[j] + b[j];
      if (kRes) t += rv[j];
      if (kRelu) t = fmaxf(t, 0.f);
      o[j] = t;
    }
    store8<kVecIO>(y + (size_t)rr * C + p.c, p.valid, o);
  };
  for (; r + (kUnroll - 1) * kLanesR < p.r1; r += kUnroll * kLanesR) {
    float v[kUnroll][kVec], rv[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load8<kVecIO>(x + (size_t)(r + u * kLanesR) * C + p.c, p.valid, v[u]);
      if (kRes) load8<kVecIO>(res + (size_t)(r + u * kLanesR) * C + p.c, p.valid, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row(v[u], rv[u], r + u * kLanesR);
  }
  for (; r < p.r1; r += kLanesR) {
    float v[kVec], rv[kVec];
    load8<kVecIO>(x + (size_t)r * C + p.c, p.valid, v);
    if (kRes) load8<kVecIO>(res + (size_t)r * C + p.c, p.valid, rv);
    row(v, rv, r);
  }
}

// ---------------------------------------------------------------------------
// K6

// the per-channel mean and rstd = rsqrt(var + eps) of a thread's 8 channels
__device__ __forceinline__ void channel_consts(const Place& p, const float* mean,
                                               const float* var, float eps,
                                               float (&mu)[kVec], float (&rstd)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool in = j < p.valid;
    mu[j] = in ? mean[p.c + j] : 0.f;
    rstd[j] = in ? rsqrtf(var[p.c + j] + eps) : 0.f;
  }
}

template <typename T, bool kVecIO, bool kRelu>
__device__ __forceinline__ void masked_grad(const T* dy, const T* y, size_t off, int valid,
                                            float (&g)[kVec]) {
  load8<kVecIO>(dy + off, valid, g);
  if (kRelu) {
    float yv[kVec];
    load8<kVecIO>(y + off, valid, yv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) g[j] = yv[j] > 0.f ? g[j] : 0.f;
  }
}

template <typename T, bool kVecIO, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_bwd_stats(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ y,
             const float* __restrict__ mean, const float* __restrict__ var, float eps,
             float* __restrict__ psg, float* __restrict__ psgx, int R, int C,
             int rows_per_chunk) {
  const Place p = place(R, C, rows_per_chunk);
  float sg[kVec] = {}, sgx[kVec] = {};
  if (p.valid > 0) {
    float mu[kVec], rstd[kVec];
    channel_consts(p, mean, var, eps, mu, rstd);
    auto acc = [&](const float (&g)[kVec], const float (&v)[kVec]) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sg[j] += g[j];
        sgx[j] += g[j] * ((v[j] - mu[j]) * rstd[j]);
      }
    };
    int r = p.r0 + p.ty;
    for (; r + (kUnroll - 1) * kLanesR < p.r1; r += kUnroll * kLanesR) {
      float g[kUnroll][kVec], v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(r + u * kLanesR) * C + p.c;
        masked_grad<T, kVecIO, kRelu>(dy, y, off, p.valid, g[u]);
        load8<kVecIO>(x + off, p.valid, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc(g[u], v[u]);
    }
    for (; r < p.r1; r += kLanesR) {
      const size_t off = (size_t)r * C + p.c;
      float g[kVec], v[kVec];
      masked_grad<T, kVecIO, kRelu>(dy, y, off, p.valid, g);
      load8<kVecIO>(x + off, p.valid, v);
      acc(g, v);
    }
  }
  write_partials(p, sg, sgx, psg, psgx, C);
}

template <typename T, bool kVecIO, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads)
bn_bwd_apply(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ y,
             const float* __restrict__ gamma, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ psg,
             const float* __restrict__ psgx, T* __restrict__ dx, T* __restrict__ dres,
             float* __restrict__ dgamma, float* __restrict__ dbeta, int R, int C,
             int rows_per_chunk, int chunks, float inv_n, float eps) {
  __shared__ float tot[2][kTileC];
  reduce_partials(psg, psgx, C, chunks, tot);
  __syncthreads();
  if (blockIdx.y == 0 && threadIdx.x < kTileC) {
    const int cc = blockIdx.x * kTileC + threadIdx.x;
    if (cc < C) {
      dbeta[cc] = tot[0][threadIdx.x];
      dgamma[cc] = tot[1][threadIdx.x];
    }
  }
  const Place p = place(R, C, rows_per_chunk);
  if (p.valid <= 0) return;
  float mu[kVec], rstd[kVec], k[kVec], c1[kVec], c2[kVec];
  channel_consts(p, mean, var, eps, mu, rstd);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    k[j] = j < p.valid ? gamma[p.c + j] * rstd[j] : 0.f;
    c1[j] = tot[0][p.tx * kVec + j] * inv_n;
    c2[j] = tot[1][p.tx * kVec + j] * inv_n;
  }
  auto row = [&](const float (&g)[kVec], const float (&v)[kVec], size_t off) {
    float o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xhat = (v[j] - mu[j]) * rstd[j];
      o[j] = k[j] * (g[j] - c1[j] - xhat * c2[j]);
    }
    store8<kVecIO>(dx + off, p.valid, o);
    if (kRes) store8<kVecIO>(dres + off, p.valid, g);
  };
  int r = p.r0 + p.ty;
  for (; r + (kUnroll - 1) * kLanesR < p.r1; r += kUnroll * kLanesR) {
    float g[kUnroll][kVec], v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = (size_t)(r + u * kLanesR) * C + p.c;
      masked_grad<T, kVecIO, kRelu>(dy, y, off, p.valid, g[u]);
      load8<kVecIO>(x + off, p.valid, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row(g[u], v[u], (size_t)(r + u * kLanesR) * C + p.c);
  }
  for (; r < p.r1; r += kLanesR) {
    const size_t off = (size_t)r * C + p.c;
    float g[kVec], v[kVec];
    masked_grad<T, kVecIO, kRelu>(dy, y, off, p.valid, g);
    load8<kVecIO>(x + off, p.valid, v);
    row(g, v, off);
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename T, bool kVecIO>
int fwd_launch(const void* x, const void* res, const float* gamma, const float* beta,
               void* y, float* mean, float* var, float* ws, int relu, int R, int C,
               int chunks, int rows_per_chunk, float eps, cudaStream_t stream) {
  const dim3 grid((C + kTileC - 1) / kTileC, chunks);
  float* psum = ws;
  float* psq = ws + (size_t)chunks * C;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  bn_fwd_stats<T, kVecIO><<<grid, kThreads, 0, stream>>>(xt, psum, psq, R, C, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float inv_n = 1.0f / (float)R;
#define BN_FWD_APPLY(RELU, RES)                                                         \
  bn_fwd_apply<T, kVecIO, RELU, RES><<<grid, kThreads, 0, stream>>>(                    \
      xt, rt, gamma, beta, psum, psq, yt, mean, var, R, C, rows_per_chunk, chunks, inv_n, \
      eps)
  if (relu && res) BN_FWD_APPLY(true, true);
  else if (relu) BN_FWD_APPLY(true, false);
  else if (res) BN_FWD_APPLY(false, true);
  else BN_FWD_APPLY(false, false);
#undef BN_FWD_APPLY
  return (int)cudaGetLastError();
}

template <typename T, bool kVecIO>
int bwd_launch(const void* dy, const void* x, const void* y, const float* gamma,
               const float* mean, const float* var, void* dx, void* dres, float* dgamma,
               float* dbeta, float* ws, int relu, int R, int C, int chunks, int rows_per_chunk,
               float eps, cudaStream_t stream) {
  const dim3 grid((C + kTileC - 1) / kTileC, chunks);
  float* psg = ws;
  float* psgx = ws + (size_t)chunks * C;
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  T* drt = static_cast<T*>(dres);
  if (relu)
    bn_bwd_stats<T, kVecIO, true><<<grid, kThreads, 0, stream>>>(
        dyt, xt, yt, mean, var, eps, psg, psgx, R, C, rows_per_chunk);
  else
    bn_bwd_stats<T, kVecIO, false><<<grid, kThreads, 0, stream>>>(
        dyt, xt, yt, mean, var, eps, psg, psgx, R, C, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float inv_n = 1.0f / (float)R;
#define BN_BWD_APPLY(RELU, RES)                                                          \
  bn_bwd_apply<T, kVecIO, RELU, RES><<<grid, kThreads, 0, stream>>>(                     \
      dyt, xt, yt, gamma, mean, var, psg, psgx, dxt, drt, dgamma, dbeta, R, C,           \
      rows_per_chunk, chunks, inv_n, eps)
  if (relu && dres) BN_BWD_APPLY(true, true);
  else if (relu) BN_BWD_APPLY(true, false);
  else if (dres) BN_BWD_APPLY(false, true);
  else BN_BWD_APPLY(false, false);
#undef BN_BWD_APPLY
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when C % 8 == 0 and every [R, C]
// pointer is 16-byte aligned.  res may be null (no residual).  ws holds
// 2 * chunks * C floats.  Returns cudaGetLastError() of the launches (0 =
// launched).
extern "C" int fused_batchnorm_fwd_launch(const void* x, const void* res, const void* gamma,
                                          const void* beta, void* y, void* mean, void* var,
                                          void* ws, int dtype, int vec, int relu, int R,
                                          int C, int chunks, int rows_per_chunk, float eps,
                                          void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec ? fwd_launch<__nv_bfloat16, true>(x, res, g, b, y, m, v, w, relu, R, C, chunks,
                                                 rows_per_chunk, eps, st)
               : fwd_launch<__nv_bfloat16, false>(x, res, g, b, y, m, v, w, relu, R, C,
                                                  chunks, rows_per_chunk, eps, st);
  }
  return vec ? fwd_launch<float, true>(x, res, g, b, y, m, v, w, relu, R, C, chunks,
                                       rows_per_chunk, eps, st)
             : fwd_launch<float, false>(x, res, g, b, y, m, v, w, relu, R, C, chunks,
                                        rows_per_chunk, eps, st);
}

// y may be null when relu is 0; dres may be null (no residual).
extern "C" int fused_batchnorm_bwd_launch(const void* dy, const void* x, const void* y,
                                          const void* gamma, const void* mean,
                                          const void* var, void* dx, void* dres,
                                          void* dgamma, void* dbeta, void* ws, int dtype,
                                          int vec, int relu, int R, int C, int chunks,
                                          int rows_per_chunk, float eps, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec ? bwd_launch<__nv_bfloat16, true>(dy, x, y, g, m, v, dx, dres, dg, db, w, relu,
                                                 R, C, chunks, rows_per_chunk, eps, st)
               : bwd_launch<__nv_bfloat16, false>(dy, x, y, g, m, v, dx, dres, dg, db, w,
                                                  relu, R, C, chunks, rows_per_chunk, eps, st);
  }
  return vec ? bwd_launch<float, true>(dy, x, y, g, m, v, dx, dres, dg, db, w, relu, R, C,
                                       chunks, rows_per_chunk, eps, st)
             : bwd_launch<float, false>(dy, x, y, g, m, v, dx, dres, dg, db, w, relu, R, C,
                                        chunks, rows_per_chunk, eps, st);
}
