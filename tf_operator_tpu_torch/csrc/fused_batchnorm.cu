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
// CTAs, with no atomics, so that the result does not change from run to
// run.  A CTA of 256 threads is 8 lanes along C (8 channels each, one
// 16-byte load of bf16 or two of float32) by 32 lanes down the rows; each
// thread keeps 4 rows of loads in flight.  Where C % 8 != 0 or a pointer
// is not 16-byte aligned (only the tests' ragged shapes; every ResNet C is
// a multiple of 64) every load is a masked scalar load (K6 then keeps one
// row in flight, and two rows of float32 on the 16-byte path).
//
// K5: two launches.
//
// 1. partial sums.  Grid (C tiles of 64 channels, R chunks), about two CTAs
//    for each of the 132 SMs (the wrapper's chunk_rows).  The 32 row lanes
//    meet in shared memory and are added in a fixed order; the CTA writes
//    its partial sums to a [chunks, C] float32 workspace.
// 2. elementwise pass, on the same grid.  Each CTA adds its channel tile's
//    partials over all chunks in a fixed order (every CTA of a tile does
//    the same additions, so all use the same constants), computes the
//    per-channel constants, and streams its chunk's rows to write y.  The
//    CTAs of chunk 0 write mean and var.
//
// So K5 reads x twice (at best 71 % of the bound), and every CTA of the
// elementwise pass adds all of its tile's partials again: the L2 reads of
// that step grow with the square of the chunk count.
//
// K6: one cooperative launch (cudaLaunchCooperativeKernel) of a persistent
// grid of exactly the CTAs the card holds at once (the occupancy query
// times the SMs: two CTAs of 256 threads an SM, each with half of the SM's
// shared memory).  The work items are (channel tile, row chunk) pairs, one
// per CTA wherever C / 64 tiles fit the grid (every ResNet layer), the
// chunks as many as fill it.
//
// 1. sums.  Each CTA streams its chunk's rows in order: g = dy (masked by
//    the saved y under ReLU), Sum g and Sum g * xhat per thread, then its
//    warps' row lanes meet by shuffles and in shared memory in a fixed
//    order, and the CTA writes its partials to a [chunks, C] workspace.
//    The chunk's last rows, as many as the dynamic shared memory holds
//    (436 rows of 64 channels in bf16, 218 in float32), stay on chip as g
//    and x, in x's dtype (exact: g is dy or 0): the ReLU mask is spent and
//    y is not kept.
// 2. grid barrier (cooperative_groups::this_grid().sync()).  Each CTA then
//    adds the partials of its own slice of 8 channels, over all chunks, in
//    a fixed order (32 strided groups of chunks, then the groups in
//    order), and writes the totals (dbeta, dgamma, and a copy in the
//    workspace): the L2 reads are the partials once, not once per CTA.
// 3. grid barrier, then the elementwise pass over each CTA's rows in
//    reverse: first the rows it holds on chip, then the rest from the one
//    read last (most likely still in L2) down to the chunk's first.  A CTA
//    reads its tile's totals from L2 once, into shared memory: every warp
//    of the grid reading the same few lines of L2 cost about 3 us a call
//    on an H100 (0.18 ms over a ResNet-50 step's 53 calls).
//
// Alternatives tried on an H100 and dropped: L2 eviction hints on the held
// rows (so that L2 keeps the rows before them) made a step slower, holding
// the first rows instead of the last moved it within noise, and one CTA an
// SM with twice the shared memory was slower.
//
// A layer whose dy and x fit in the grid's shared memory whole (at batch 64
// in bf16: every [3136, C] layer of ResNet-50, [12544, 256], [12544, 512]
// and [50176, 128]) reads each input byte from device memory once; a
// larger one reads again only what neither shared memory nor L2 kept.
// What it does not do: keep the rest of a large layer compressed on chip,
// or overlap one layer's barriers with another layer's work.
//
// Numerics against the plain versions (ops/fused_batchnorm.py), which
// compute the same expressions in the same order: the sums run in another
// order (per-thread sequential, then fixed-order trees); rsqrtf is the
// hardware reciprocal square root (within 2 ulp); nvcc contracts a
// multiply and an add into one fused multiply-add.  Read on the card: the
// moments within 6e-7 relative, a bf16 y within one bf16 ulp of the O(1)
// terms (a y that cancels near 0 can differ by several ulps of itself).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

constexpr int kBwdCtasPerSm = 2;              // resident CTAs an SM, by design
constexpr int kWarpsCta = kThreads / 32;      // 8
constexpr int kSliceC = 8;                    // channels a CTA totals after barrier 1
constexpr int kSliceGroups = kThreads / kSliceC;  // 32 strided groups of chunks

// the per-channel mean and rstd = rsqrt(var + eps) of a thread's 8 channels
__device__ __forceinline__ void channel_consts(int c, int valid, const float* mean,
                                               const float* var, float eps,
                                               float (&mu)[kVec], float (&rstd)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool in = j < valid;
    mu[j] = in ? mean[c + j] : 0.f;
    rstd[j] = in ? rsqrtf(var[c + j] + eps) : 0.f;
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

// One work item: channel tile `tile`, row chunk `chunk`.  n rows from r0;
// the rows from `first_held` on (local index) stay on chip.
struct Item {
  int c, valid, r0, n, chunk, first_held;
};

__device__ __forceinline__ Item item_at(int it, int tiles, int R, int C, int rows_per_chunk,
                                        int hold_rows, bool keep) {
  Item t;
  const int tile = it % tiles;  // neighbouring CTAs: neighbouring tiles of the same rows
  t.chunk = it / tiles;
  t.c = tile * kTileC + (threadIdx.x % kLanesC) * kVec;
  t.valid = min(kVec, C - t.c);
  t.r0 = t.chunk * rows_per_chunk;
  t.n = min(R, t.r0 + rows_per_chunk) - t.r0;
  t.first_held = keep ? max(0, t.n - hold_rows) : t.n;
  return t;
}

// a held row's slot: g then x, each [hold_rows][8 channel lanes][8 values]
// in T, so a warp's 4 rows x 8 lanes are 512 contiguous bytes (bf16)
template <typename T>
__device__ __forceinline__ T* held(unsigned char* hold, int hold_rows, int slot, int which) {
  return reinterpret_cast<T*>(hold) +
         ((size_t)which * hold_rows * kLanesC + (size_t)slot * kLanesC + threadIdx.x % kLanesC) *
             kVec;
}

template <typename T, bool kVecIO, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
bn_bwd_fused_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ gamma, const float* __restrict__ mean,
                    const float* __restrict__ var, T* __restrict__ dx, T* __restrict__ dres,
                    float* __restrict__ dgamma, float* __restrict__ dbeta, float* ws, int R,
                    int C, int chunks, int rows_per_chunk, int hold_rows, float inv_n,
                    float eps) {
  // rows of loads in flight a thread, within the registers two CTAs an SM
  // leave: 4 of bf16, 2 of float32 (the same 64 bytes of each input), 1
  // on the masked scalar path (ragged C, misaligned pointers)
  constexpr int kU = !kVecIO ? 1 : sizeof(T) == 2 ? kUnroll : kUnroll / 2;
  extern __shared__ __align__(16) unsigned char hold[];
  __shared__ float red[2][kWarpsCta][kTileC];
  cg::grid_group grid = cg::this_grid();
  const int tiles = (C + kTileC - 1) / kTileC;
  const int items = tiles * chunks;
  float* psg = ws;                             // [chunks, C]
  float* psgx = ws + (size_t)chunks * C;       // [chunks, C]
  float* tot = ws + 2 * (size_t)chunks * C;    // [2, C]: Sum g, Sum g * xhat
  const int ty = threadIdx.x / kLanesC, tx = threadIdx.x % kLanesC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the CTA's items are blockIdx.x, + gridDim.x, ...; the last one keeps
  // its tail on chip
  const int cta = blockIdx.x, n_ctas = gridDim.x;
  const int last = cta < items ? cta + (items - 1 - cta) / n_ctas * n_ctas : -1;

  // 1. sums, rows in order
  for (int it = cta; it < items; it += n_ctas) {
    const Item t = item_at(it, tiles, R, C, rows_per_chunk, hold_rows, it == last);
    float sg[kVec] = {}, sgx[kVec] = {};
    if (t.valid > 0) {
      float mu[kVec], rstd[kVec];
      channel_consts(t.c, t.valid, mean, var, eps, mu, rstd);
      auto acc = [&](const float (&g)[kVec], const float (&v)[kVec], int i) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          sg[j] += g[j];
          sgx[j] += g[j] * ((v[j] - mu[j]) * rstd[j]);
        }
        if (i >= t.first_held) {
          store8<true>(held<T>(hold, hold_rows, i - t.first_held, 0), kVec, g);
          store8<true>(held<T>(hold, hold_rows, i - t.first_held, 1), kVec, v);
        }
      };
      auto load_row = [&](int i, float (&g)[kVec], float (&v)[kVec]) {
        const size_t off = (size_t)(t.r0 + i) * C + t.c;
        masked_grad<T, kVecIO, kRelu>(dy, y, off, t.valid, g);
        load8<kVecIO>(x + off, t.valid, v);
      };
      int i = ty;
      for (; i + (kU - 1) * kLanesR < t.n; i += kU * kLanesR) {
        float g[kU][kVec], v[kU][kVec];
#pragma unroll
        for (int u = 0; u < kU; ++u) load_row(i + u * kLanesR, g[u], v[u]);
#pragma unroll
        for (int u = 0; u < kU; ++u) acc(g[u], v[u], i + u * kLanesR);
      }
      for (; i < t.n; i += kLanesR) {
        float g[kVec], v[kVec];
        load_row(i, g, v);
        acc(g, v, i);
      }
    }
    // the 32 row lanes meet: the warp's 4 by shuffles, the 8 warps in
    // order in shared memory
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sg[j] += __shfl_xor_sync(0xffffffffu, sg[j], 8);
      sg[j] += __shfl_xor_sync(0xffffffffu, sg[j], 16);
      sgx[j] += __shfl_xor_sync(0xffffffffu, sgx[j], 8);
      sgx[j] += __shfl_xor_sync(0xffffffffu, sgx[j], 16);
    }
    if (lane < kLanesC) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        red[0][warp][tx * kVec + j] = sg[j];
        red[1][warp][tx * kVec + j] = sgx[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kTileC) {
      const int which = threadIdx.x / kTileC, col = threadIdx.x % kTileC;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsCta; ++w) sum += red[which][w][col];
      const int cc = (it % tiles) * kTileC + col;
      if (cc < C) (which ? psgx : psg)[(size_t)t.chunk * C + cc] = sum;
    }
    __syncthreads();
  }
  grid.sync();

  // 2. each CTA totals its slices of 8 channels over every chunk, in a
  // fixed order
  float (*sred)[kSliceGroups][kSliceC] = reinterpret_cast<float (*)[kSliceGroups][kSliceC]>(red);
  for (int sl = cta; sl * kSliceC < C; sl += n_ctas) {
    const int cc = sl * kSliceC + threadIdx.x % kSliceC, grp = threadIdx.x / kSliceC;
    float a = 0.f, b = 0.f;
    if (cc < C) {
#pragma unroll 4
      for (int k = grp; k < chunks; k += kSliceGroups) {
        a += __ldcg(psg + (size_t)k * C + cc);
        b += __ldcg(psgx + (size_t)k * C + cc);
      }
    }
    sred[0][grp][threadIdx.x % kSliceC] = a;
    sred[1][grp][threadIdx.x % kSliceC] = b;
    __syncthreads();
    if (threadIdx.x < 2 * kSliceC) {
      const int which = threadIdx.x / kSliceC, col = threadIdx.x % kSliceC;
      const int c = sl * kSliceC + col;
      float sum = 0.f;
      for (int g = 0; g < kSliceGroups; ++g) sum += sred[which][g][col];
      if (c < C) {
        tot[(size_t)which * C + c] = sum;
        (which ? dgamma : dbeta)[c] = sum;
      }
    }
    __syncthreads();
  }
  grid.sync();

  // 3. the elementwise pass, items and rows in reverse: the rows held on
  // chip first, then the rest from the one read last
  for (int it = last; it >= cta; it -= n_ctas) {
    const Item t = item_at(it, tiles, R, C, rows_per_chunk, hold_rows, it == last);
    // the tile's totals, read from L2 once a CTA into shared memory (every
    // warp of the grid reading the same few lines of L2 costs ~5 us)
    if (threadIdx.x < 2 * kTileC) {
      const int which = threadIdx.x / kTileC, col = threadIdx.x % kTileC;
      const int cc = (it % tiles) * kTileC + col;
      red[0][which][col] = cc < C ? __ldcg(tot + (size_t)which * C + cc) * inv_n : 0.f;
    }
    __syncthreads();
    float mu[kVec], rstd[kVec], k[kVec], c1[kVec], c2[kVec];
    channel_consts(t.c, t.valid, mean, var, eps, mu, rstd);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      k[j] = j < t.valid ? gamma[t.c + j] * rstd[j] : 0.f;
      c1[j] = red[0][0][tx * kVec + j];
      c2[j] = red[0][1][tx * kVec + j];
    }
    __syncthreads();  // the next item overwrites them
    if (t.valid <= 0) continue;
    auto row = [&](const float (&g)[kVec], const float (&v)[kVec], int i) {
      const size_t off = (size_t)(t.r0 + i) * C + t.c;
      float o[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = (v[j] - mu[j]) * rstd[j];
        o[j] = k[j] * (g[j] - c1[j] - xhat * c2[j]);
      }
      store8<kVecIO>(dx + off, t.valid, o);
      if (kRes) store8<kVecIO>(dres + off, t.valid, g);
    };
    // this thread's rows are ty + 32 m
    int m = t.n > ty ? (t.n - ty - 1) / kLanesR : -1;
    for (; m >= 0 && ty + m * kLanesR >= t.first_held; --m) {
      const int i = ty + m * kLanesR;
      float g[kVec], v[kVec];
      load8<true>(held<T>(hold, hold_rows, i - t.first_held, 0), kVec, g);
      load8<true>(held<T>(hold, hold_rows, i - t.first_held, 1), kVec, v);
      row(g, v, i);
    }
    for (; m >= kU - 1; m -= kU) {
      float g[kU][kVec], v[kU][kVec];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t off = (size_t)(t.r0 + ty + (m - u) * kLanesR) * C + t.c;
        masked_grad<T, kVecIO, kRelu>(dy, y, off, t.valid, g[u]);
        load8<kVecIO>(x + off, t.valid, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) row(g[u], v[u], ty + (m - u) * kLanesR);
    }
    for (; m >= 0; --m) {
      const size_t off = (size_t)(t.r0 + ty + m * kLanesR) * C + t.c;
      float g[kVec], v[kVec];
      masked_grad<T, kVecIO, kRelu>(dy, y, off, t.valid, g);
      load8<kVecIO>(x + off, t.valid, v);
      row(g, v, ty + m * kLanesR);
    }
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

// K6's arguments, as the wrapper passes them
struct BwdArgs {
  const void *dy, *x, *y;
  const float *gamma, *mean, *var;
  void *dx, *dres;
  float *dgamma, *dbeta, *ws;
  int R, C, chunks, rows_per_chunk, hold_rows, ctas;
  float eps;
  cudaStream_t stream;
};

// The grid (the CTAs the card holds at once) and the dynamic shared memory
// a CTA keeps rows in, found once per instantiation: an SM's shared memory
// split between its kBwdCtasPerSm CTAs (fewer where the registers allow
// fewer), less the per-block reservation and the static arrays, in whole
// held rows (g and x of 64 channels)
template <typename T, bool kVecIO, bool kRelu, bool kRes>
cudaError_t bwd_resources(int* ctas, int* hold_bytes) {
  static int s_ctas = 0, s_hold = 0;
  if (!s_ctas) {
    auto kernel = bn_bwd_fused_kernel<T, kVecIO, kRelu, kRes>;
    int dev = 0, per_sm = 0, reserved = 0, optin = 0, sms = 0, occ = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    // CTAs an SM: kBwdCtasPerSm, or fewer if the registers allow fewer
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    const int per = max(1, min(occ, kBwdCtasPerSm));
    const int row = 2 * kTileC * (int)sizeof(T);
    int dyn = min(per_sm / per - reserved, optin) - (int)fa.sharedSizeBytes;
    dyn = max(0, dyn / row * row);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, dyn);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    s_ctas = occ * sms;
    s_hold = dyn;
  }
  *ctas = s_ctas;
  *hold_bytes = s_hold;
  return cudaSuccess;
}

// one cooperative launch of the persistent grid; the plan must be the one
// the wrapper made from bwd_resources (the grid, the held rows, the chunks
// covering R)
template <typename T, bool kVecIO, bool kRelu, bool kRes>
cudaError_t bwd_launch(const BwdArgs& a) {
  int ctas = 0, hold = 0;
  cudaError_t err = bwd_resources<T, kVecIO, kRelu, kRes>(&ctas, &hold);
  if (err != cudaSuccess) return err;
  if (a.ctas != ctas || a.hold_rows < 0 || a.hold_rows * 2 * kTileC * (int)sizeof(T) > hold ||
      a.chunks < 1 || a.rows_per_chunk < 1 || (long long)a.chunks * a.rows_per_chunk < a.R ||
      (long long)(a.chunks - 1) * a.rows_per_chunk >= a.R)
    return cudaErrorInvalidValue;
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const T* y = static_cast<const T*>(a.y);
  const float *gamma = a.gamma, *mean = a.mean, *var = a.var;
  T* dx = static_cast<T*>(a.dx);
  T* dres = static_cast<T*>(a.dres);
  float *dgamma = a.dgamma, *dbeta = a.dbeta, *ws = a.ws;
  int R = a.R, C = a.C, chunks = a.chunks, rows = a.rows_per_chunk, hold_rows = a.hold_rows;
  float inv_n = 1.0f / (float)a.R, eps = a.eps;
  void* args[] = {&dy,     &x,     &y,  &gamma, &mean,   &var,  &dx,        &dres,  &dgamma,
                  &dbeta,  &ws,    &R,  &C,     &chunks, &rows, &hold_rows, &inv_n, &eps};
  err = cudaLaunchCooperativeKernel(bn_bwd_fused_kernel<T, kVecIO, kRelu, kRes>, dim3(ctas),
                                    dim3(kThreads), args, (size_t)hold, a.stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// with ctas non-null: the resources; else the launch
template <typename T, bool kVecIO, bool kRelu, bool kRes>
cudaError_t bwd_entry(const BwdArgs* a, int* ctas, int* hold_bytes) {
  if (ctas) return bwd_resources<T, kVecIO, kRelu, kRes>(ctas, hold_bytes);
  return bwd_launch<T, kVecIO, kRelu, kRes>(*a);
}
template <typename T, bool kVecIO, bool kRelu>
cudaError_t bwd_res(int res, const BwdArgs* a, int* ctas, int* hold_bytes) {
  return res ? bwd_entry<T, kVecIO, kRelu, true>(a, ctas, hold_bytes)
             : bwd_entry<T, kVecIO, kRelu, false>(a, ctas, hold_bytes);
}
template <typename T, bool kVecIO>
cudaError_t bwd_relu(int relu, int res, const BwdArgs* a, int* ctas, int* hold_bytes) {
  return relu ? bwd_res<T, kVecIO, true>(res, a, ctas, hold_bytes)
              : bwd_res<T, kVecIO, false>(res, a, ctas, hold_bytes);
}
cudaError_t bwd_dispatch(int dtype, int vec, int relu, int res, const BwdArgs* a, int* ctas,
                         int* hold_bytes) {
  if (dtype == 1)
    return vec ? bwd_relu<__nv_bfloat16, true>(relu, res, a, ctas, hold_bytes)
               : bwd_relu<__nv_bfloat16, false>(relu, res, a, ctas, hold_bytes);
  return vec ? bwd_relu<float, true>(relu, res, a, ctas, hold_bytes)
             : bwd_relu<float, false>(relu, res, a, ctas, hold_bytes);
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

// K6's grid (the CTAs the card holds at once) and the dynamic shared memory
// each CTA keeps rows in, for one instantiation (res: 1 with a residual).
// Returns the CUDA error code (0 = found).
extern "C" int fused_batchnorm_bwd_resources(int dtype, int vec, int relu, int res, int* ctas,
                                             int* hold_bytes) {
  return (int)bwd_dispatch(dtype, vec, relu, res, nullptr, ctas, hold_bytes);
}

// y may be null when relu is 0; dres may be null (no residual).  ws holds
// (2 * chunks + 2) * C floats; ctas and hold_rows come from
// fused_batchnorm_bwd_resources (hold_rows at most hold_bytes / (128 *
// sizeof(x))).  Returns the CUDA error code of the cooperative launch (0 =
// launched); a grid the card cannot hold at once is refused, not shrunk.
extern "C" int fused_batchnorm_bwd_launch(const void* dy, const void* x, const void* y,
                                          const void* gamma, const void* mean,
                                          const void* var, void* dx, void* dres,
                                          void* dgamma, void* dbeta, void* ws, int dtype,
                                          int vec, int relu, int R, int C, int chunks,
                                          int rows_per_chunk, int hold_rows, int ctas,
                                          float eps, void* stream) {
  const BwdArgs a{dy,
                  x,
                  y,
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(var),
                  dx,
                  dres,
                  static_cast<float*>(dgamma),
                  static_cast<float*>(dbeta),
                  static_cast<float*>(ws),
                  R,
                  C,
                  chunks,
                  rows_per_chunk,
                  hold_rows,
                  ctas,
                  eps,
                  static_cast<cudaStream_t>(stream)};
  return (int)bwd_dispatch(dtype, vec, relu, dres != nullptr, &a, nullptr, nullptr);
}
