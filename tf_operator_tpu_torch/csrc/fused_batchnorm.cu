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
// tiles)), reading x twice in the forward.  On the card one CTA per channel
// tile would give 1 CTA to the stem's 64 channels, walking 802,816 rows
// alone.  So R is split across CTAs, with no atomics, so that the result
// does not change from run to run.  A CTA of 256 threads is 8 lanes along C
// (8 channels each, one 16-byte load of bf16 or two of float32) by 32 lanes
// down the rows; each thread keeps 4 rows of loads in flight in bf16, 2 in
// float32 (the same 64 bytes of each input), within the registers two CTAs
// an SM leave.  Where C % 8 != 0 or a pointer is not 16-byte aligned (only
// the tests' ragged shapes; every ResNet C is a multiple of 64) every load
// is a masked scalar load, one row in flight.
//
// K5 and K6 are each one cooperative launch (cudaLaunchCooperativeKernel)
// of a persistent grid of exactly the CTAs the card holds at once (the
// occupancy query times the SMs: two CTAs of 256 threads an SM, each with
// half of the SM's shared memory).  The work items are (channel tile of 64,
// row chunk) pairs, one per CTA wherever C / 64 tiles fit the grid (every
// ResNet layer), the chunks as many as fill it; where the tiles exceed the
// grid a CTA takes several items.  Three phases, the same in both:
//
// 1. sums.  Each CTA streams its chunk's rows in order and adds its two
//    sums per thread (K5: x and x^2; K6: g and g * xhat, g = dy masked by
//    the saved y under ReLU).  Its warps' row lanes meet by shuffles and in
//    shared memory in a fixed order, and the CTA writes its partials to a
//    [chunks, C] workspace.  The chunk's last rows, as many as the dynamic
//    shared memory holds, stay on chip in x's dtype (exact): K5 keeps x
//    (872 rows of 64 channels in bf16, 436 in float32), K6 keeps g and x
//    (436 and 218; the ReLU mask is spent and y is not kept).
// 2. grid barrier (cooperative_groups::this_grid().sync()).  Each CTA then
//    adds the partials of its own slices of 8 channels, over all chunks, in
//    a fixed order (32 strided groups of chunks, then the groups in order),
//    and writes the totals once: K5 mean, var and the per-channel
//    constants (mean, rsqrt(var + eps) * gamma), K6 dbeta, dgamma and a
//    copy in the workspace.  The L2 reads are the partials once, not once
//    per CTA.  K5 takes this phase only where the plan has more than 132
//    chunks; with fewer, every CTA adds its own tile's partials (4 strided
//    groups of chunks, then the groups in order: the same bits in every CTA
//    of the tile) at the start of phase 3, which saves phase 2 and a
//    barrier.
// 3. grid barrier, then the elementwise pass over each CTA's rows in
//    reverse: first the rows it holds on chip, then the rest from the one
//    read last (most likely still in L2) down to the chunk's first.  A CTA
//    reads its tile's constants from L2 once, into shared memory: every
//    warp of the grid reading the same few lines of L2 cost about 3 us a
//    call on an H100 (0.18 ms over a ResNet-50 step's 53 calls of K6).  K5
//    reads the residual here, once.
//
// At batch 64 in bf16, 42 of ResNet-50's 53 norms fit K5's grid (264 CTAs
// of 111,616 bytes) whole and read x from device memory once: [200704, 64],
// [50176, 128], [50176, 256] and every [12544, C] and [3136, C] layer.  The
// stem and [200704, 256] re-read at most 71 % of x, [200704, 128] and
// [50176, 512] at most 43 % (less what L2 kept).  So a step moves at most
// 4.05 GB against the 3.55 GB bound.  K6 keeps every [3136, C] layer,
// [12544, 256], [12544, 512] and [50176, 128] whole.  On an H100
// (chip_smoke.py phase 4c) K5 takes 1.77 ms a ResNet-50 step, 60 % of its
// bound, and K6 3.49 ms, 53 %.
//
// Alternatives tried on an H100 and dropped.  K5 as two launches (partial
// sums; then an elementwise pass whose every CTA re-added its tile's
// partials, on a grid of 2 x 132 CTAs fixed by a constant): x read twice
// (at best 71 % of the bound), the L2 reads of the partials growing with
// the square of the chunk count, 2.20 ms a ResNet-50 step (47.6 % of the
// bound).  In this design: 8 or 16 rows of loads in flight for the sums,
// or 8 in the elementwise pass, moved nothing (the sums are not short of
// loads in flight); the last step's loads predicated instead of a row at a
// time made a step slower by about a quarter; prefetching the held rows'
// residual into L2 before the first barrier was slower; own totals at
// every layer, or at none, were slower than from 132 chunks down.  For
// K6: L2 eviction hints on the held rows (so that L2 keeps the rows before
// them) made a step slower, holding the first rows instead of the last
// moved it within noise, and one CTA an SM with twice the shared memory
// was slower.  What neither does: keep the rest of a large layer
// compressed on chip, or overlap one layer's barriers with another layer's
// work.
//
// Numerics against the plain versions (ops/fused_batchnorm.py), which
// compute the same expressions in the same order: the sums run in another
// order (per-thread sequential, then fixed-order trees); rsqrtf is the
// hardware reciprocal square root (within 2 ulp); nvcc contracts a
// multiply and an add into one fused multiply-add.  Read on the card: the
// moments within 6e-7 relative, a bf16 y within one bf16 ulp of the O(1)
// terms (a y that cancels near 0 can differ by several ulps of itself).
// The row split depends on the grid alone, not on the load width, so the
// 16-byte and the masked scalar paths add the same values in the same order.

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
constexpr int kUnroll = 4;                    // rows of bf16 loads in flight a thread
constexpr int kCtasPerSm = 2;                 // resident CTAs an SM, by design
constexpr int kWarpsCta = kThreads / 32;      // 8
constexpr int kSliceC = 8;                    // channels a CTA totals after barrier 1
constexpr int kSliceGroups = kThreads / kSliceC;  // 32 strided groups of chunks
constexpr int kTileGroups = kThreads / kTileC;    // 4 strided groups of chunks
// K5 plans of at most this many chunks skip phase 2: each CTA totals its
// own tile's partials (chunks x 512 bytes from L2), which saves phase 2
// and its grid barrier (every ResNet-50 layer but the C = 64 ones, whose
// 264 chunks total faster in slices)
constexpr int kOwnTotalsChunks = 132;

// rows of loads in flight a thread, within the registers two CTAs an SM
// leave: 4 of bf16, 2 of float32 (the same 64 bytes of each input), 1 on
// the masked scalar path (ragged C, misaligned pointers)
template <typename T, bool kVecIO>
__host__ __device__ constexpr int rows_in_flight() {
  return !kVecIO ? 1 : sizeof(T) == 2 ? kUnroll : kUnroll / 2;
}

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

// a held row's slot: [which][hold_rows][8 channel lanes][8 values] in T,
// so a warp's 4 rows x 8 lanes are 512 contiguous bytes (bf16); K5 holds
// x (which 0), K6 g (0) and x (1)
template <typename T>
__device__ __forceinline__ T* held(unsigned char* hold, int hold_rows, int slot, int which) {
  return reinterpret_cast<T*>(hold) +
         ((size_t)which * hold_rows * kLanesC + (size_t)slot * kLanesC + threadIdx.x % kLanesC) *
             kVec;
}

// Phase 1's end: the 32 row lanes' sums a[8], b[8] of each thread meet (a
// warp's 4 by shuffles, then the 8 warps in order in shared memory) and
// the CTA writes them to row `chunk` of pa, pb [chunks, C]
__device__ __forceinline__ void write_partials(float (&a)[kVec], float (&b)[kVec],
                                               float (*red)[kWarpsCta][kTileC], int tile,
                                               int chunk, int C, float* pa, float* pb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tx = threadIdx.x % kLanesC;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    a[j] += __shfl_xor_sync(0xffffffffu, a[j], 8);
    a[j] += __shfl_xor_sync(0xffffffffu, a[j], 16);
    b[j] += __shfl_xor_sync(0xffffffffu, b[j], 8);
    b[j] += __shfl_xor_sync(0xffffffffu, b[j], 16);
  }
  if (lane < kLanesC) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[0][warp][tx * kVec + j] = a[j];
      red[1][warp][tx * kVec + j] = b[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kTileC) {
    const int which = threadIdx.x / kTileC, col = threadIdx.x % kTileC;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsCta; ++w) sum += red[which][w][col];
    const int cc = tile * kTileC + col;
    if (cc < C) (which ? pb : pa)[(size_t)chunk * C + cc] = sum;
  }
  __syncthreads();
}

using Slice = float[kSliceC];

// Phase 2: the partials pa, pb [chunks, C] of slice sl's 8 channels added
// over every chunk in a fixed order (32 strided groups of chunks, then the
// groups in order).  Returns the totals [2][8] (Sum a, Sum b) in `scratch`
// (at least 2 * (kThreads + kSliceC) floats of shared memory), which every
// thread may read until the next call.
__device__ __forceinline__ const Slice* slice_totals(const float* pa, const float* pb, int C,
                                                     int chunks, int sl, float* scratch) {
  float (*sred)[kSliceGroups][kSliceC] =
      reinterpret_cast<float (*)[kSliceGroups][kSliceC]>(scratch);
  Slice* tot = reinterpret_cast<Slice*>(scratch + 2 * kThreads);
  const int cc = sl * kSliceC + threadIdx.x % kSliceC, grp = threadIdx.x / kSliceC;
  float a = 0.f, b = 0.f;
  if (cc < C) {
#pragma unroll 4
    for (int k = grp; k < chunks; k += kSliceGroups) {
      a += __ldcg(pa + (size_t)k * C + cc);
      b += __ldcg(pb + (size_t)k * C + cc);
    }
  }
  sred[0][grp][threadIdx.x % kSliceC] = a;
  sred[1][grp][threadIdx.x % kSliceC] = b;
  __syncthreads();
  if (threadIdx.x < 2 * kSliceC) {
    const int which = threadIdx.x / kSliceC, col = threadIdx.x % kSliceC;
    float sum = 0.f;
    for (int g = 0; g < kSliceGroups; ++g) sum += sred[which][g][col];
    tot[which][col] = sum;
  }
  __syncthreads();
  return tot;
}

// ---------------------------------------------------------------------------
// K5

template <typename T, bool kVecIO, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bn_fwd_fused_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, float* __restrict__ mean, float* __restrict__ var,
                    float* ws, int R, int C, int chunks, int rows_per_chunk, int hold_rows,
                    float inv_n, float eps) {
  constexpr int kU = rows_in_flight<T, kVecIO>();
  extern __shared__ __align__(16) unsigned char hold[];
  __shared__ float red[2][kWarpsCta][kTileC];
  cg::grid_group grid = cg::this_grid();
  const int tiles = (C + kTileC - 1) / kTileC;
  const int items = tiles * chunks;
  float* psum = ws;                            // [chunks, C]
  float* psq = ws + (size_t)chunks * C;        // [chunks, C]
  float* cst = ws + 2 * (size_t)chunks * C;    // [2, C]: mean, rsqrt(var + eps) * gamma
  const int ty = threadIdx.x / kLanesC, tx = threadIdx.x % kLanesC;
  // the CTA's items are blockIdx.x, + gridDim.x, ...; the last one keeps
  // its tail on chip
  const int cta = blockIdx.x, n_ctas = gridDim.x;
  const int last = cta < items ? cta + (items - 1 - cta) / n_ctas * n_ctas : -1;

  // 1. sums, rows in order
  for (int it = cta; it < items; it += n_ctas) {
    const Item t = item_at(it, tiles, R, C, rows_per_chunk, hold_rows, it == last);
    float s[kVec] = {}, q[kVec] = {};
    if (t.valid > 0) {
      auto acc = [&](const float (&v)[kVec], int i) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[j] += v[j];
          q[j] += v[j] * v[j];
        }
        if (i >= t.first_held) store8<true>(held<T>(hold, hold_rows, i - t.first_held, 0), kVec, v);
      };
      int i = ty;
      for (; i + (kU - 1) * kLanesR < t.n; i += kU * kLanesR) {
        float v[kU][kVec];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          load8<kVecIO>(x + (size_t)(t.r0 + i + u * kLanesR) * C + t.c, t.valid, v[u]);
#pragma unroll
        for (int u = 0; u < kU; ++u) acc(v[u], i + u * kLanesR);
      }
      for (; i < t.n; i += kLanesR) {
        float v[kVec];
        load8<kVecIO>(x + (size_t)(t.r0 + i) * C + t.c, t.valid, v);
        acc(v, i);
      }
    }
    write_partials(s, q, red, it % tiles, t.chunk, C, psum, psq);
  }
  grid.sync();

  // 2. each CTA totals its slices of 8 channels over every chunk, in a
  // fixed order, and writes mean, var and the constants once; with few
  // chunks each CTA totals its own tile in phase 3 instead
  const bool own_totals = chunks <= kOwnTotalsChunks;
  if (!own_totals) {
    for (int sl = cta; sl * kSliceC < C; sl += n_ctas) {
      const Slice* tot = slice_totals(psum, psq, C, chunks, sl, &red[0][0][0]);
      const int c = sl * kSliceC + threadIdx.x;
      if (threadIdx.x < kSliceC && c < C) {
        const float mu = tot[0][threadIdx.x] * inv_n;
        const float v = fmaxf(tot[1][threadIdx.x] * inv_n - mu * mu, 0.f);
        mean[c] = mu;
        var[c] = v;
        cst[c] = mu;
        cst[(size_t)C + c] = rsqrtf(v + eps) * gamma[c];
      }
    }
    grid.sync();
  }

  // 3. the elementwise pass, items and rows in reverse: the rows held on
  // chip first, then the rest from the one read last
  for (int it = last; it >= cta; it -= n_ctas) {
    const Item t = item_at(it, tiles, R, C, rows_per_chunk, hold_rows, it == last);
    const int col = threadIdx.x % kTileC, cc = (it % tiles) * kTileC + col;
    if (own_totals) {
      // the tile's partials over every chunk in a fixed order (thread t
      // adds chunks t / 64, + 4, ... of channel t % 64, then the 4 groups
      // meet in order), into the constants; the CTA of chunk 0 writes
      // mean and var
      const int grp = threadIdx.x / kTileC;
      float a = 0.f, b = 0.f;
      if (cc < C) {
#pragma unroll 8
        for (int k = grp; k < chunks; k += kTileGroups) {
          a += __ldcg(psum + (size_t)k * C + cc);
          b += __ldcg(psq + (size_t)k * C + cc);
        }
      }
      red[1][grp][col] = a;
      red[1][kTileGroups + grp][col] = b;
      __syncthreads();
      if (threadIdx.x < kTileC) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int g = 0; g < kTileGroups; ++g) {
          sa += red[1][g][col];
          sb += red[1][kTileGroups + g][col];
        }
        float mu = 0.f, mul = 0.f, bt = 0.f;
        if (cc < C) {
          mu = sa * inv_n;
          const float v = fmaxf(sb * inv_n - mu * mu, 0.f);
          mul = rsqrtf(v + eps) * gamma[cc];
          bt = beta[cc];
          if (t.chunk == 0) {
            mean[cc] = mu;
            var[cc] = v;
          }
        }
        red[0][0][col] = mu;
        red[0][1][col] = mul;
        red[0][2][col] = bt;
      }
    } else if (threadIdx.x < 3 * kTileC) {
      // the tile's constants, read from L2 once a CTA into shared memory
      const int which = threadIdx.x / kTileC;
      float v = 0.f;
      if (cc < C) v = which == 2 ? beta[cc] : __ldcg(cst + (size_t)which * C + cc);
      red[0][which][col] = v;
    }
    __syncthreads();
    float mu[kVec], mul[kVec], b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu[j] = red[0][0][tx * kVec + j];
      mul[j] = red[0][1][tx * kVec + j];
      b[j] = red[0][2][tx * kVec + j];
    }
    __syncthreads();  // the next item overwrites them
    if (t.valid <= 0) continue;
    auto load_x = [&](int i, float (&v)[kVec]) {
      if (i >= t.first_held)
        load8<true>(held<T>(hold, hold_rows, i - t.first_held, 0), kVec, v);
      else
        load8<kVecIO>(x + (size_t)(t.r0 + i) * C + t.c, t.valid, v);
    };
    auto row = [&](const float (&v)[kVec], const float (&rv)[kVec], int i) {
      float o[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float u = (v[j] - mu[j]) * mul[j] + b[j];
        if (kRes) u += rv[j];
        if (kRelu) u = fmaxf(u, 0.f);
        o[j] = u;
      }
      store8<kVecIO>(y + (size_t)(t.r0 + i) * C + t.c, t.valid, o);
    };
    // this thread's rows are ty + 32 m
    int m = t.n > ty ? (t.n - ty - 1) / kLanesR : -1;
    for (; m >= kU - 1; m -= kU) {
      float v[kU][kVec], rv[kU][kVec];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = ty + (m - u) * kLanesR;
        load_x(i, v[u]);
        if (kRes) load8<kVecIO>(res + (size_t)(t.r0 + i) * C + t.c, t.valid, rv[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) row(v[u], rv[u], ty + (m - u) * kLanesR);
    }
    for (; m >= 0; --m) {
      const int i = ty + m * kLanesR;
      float v[kVec], rv[kVec];
      load_x(i, v);
      if (kRes) load8<kVecIO>(res + (size_t)(t.r0 + i) * C + t.c, t.valid, rv);
      row(v, rv, i);
    }
  }
}

// ---------------------------------------------------------------------------
// K6

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

template <typename T, bool kVecIO, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bn_bwd_fused_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ gamma, const float* __restrict__ mean,
                    const float* __restrict__ var, T* __restrict__ dx, T* __restrict__ dres,
                    float* __restrict__ dgamma, float* __restrict__ dbeta, float* ws, int R,
                    int C, int chunks, int rows_per_chunk, int hold_rows, float inv_n,
                    float eps) {
  constexpr int kU = rows_in_flight<T, kVecIO>();
  extern __shared__ __align__(16) unsigned char hold[];
  __shared__ float red[2][kWarpsCta][kTileC];
  cg::grid_group grid = cg::this_grid();
  const int tiles = (C + kTileC - 1) / kTileC;
  const int items = tiles * chunks;
  float* psg = ws;                             // [chunks, C]
  float* psgx = ws + (size_t)chunks * C;       // [chunks, C]
  float* tot = ws + 2 * (size_t)chunks * C;    // [2, C]: Sum g, Sum g * xhat
  const int ty = threadIdx.x / kLanesC, tx = threadIdx.x % kLanesC;
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
    write_partials(sg, sgx, red, it % tiles, t.chunk, C, psg, psgx);
  }
  grid.sync();

  // 2. each CTA totals its slices of 8 channels over every chunk, in a
  // fixed order
  for (int sl = cta; sl * kSliceC < C; sl += n_ctas) {
    const Slice* s = slice_totals(psg, psgx, C, chunks, sl, &red[0][0][0]);
    if (threadIdx.x < 2 * kSliceC) {
      const int which = threadIdx.x / kSliceC, col = threadIdx.x % kSliceC;
      const int c = sl * kSliceC + col;
      if (c < C) {
        tot[(size_t)which * C + c] = s[which][col];
        (which ? dgamma : dbeta)[c] = s[which][col];
      }
    }
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

// One call's arguments, as the wrapper passes them.  K5 reads x (and res)
// and writes y, mean and var; K6 reads dy, x, y (under ReLU), mean and var
// and writes dx, dres (or null), dgamma and dbeta.
struct Args {
  const void *x, *res, *dy;
  void *y, *dx, *dres;
  const float *gamma, *beta;
  float *mean, *var, *dgamma, *dbeta, *ws;
  int R, C, chunks, rows_per_chunk, hold_rows, ctas;
  float eps;
  cudaStream_t stream;
};

// The grid (the CTAs the card holds at once) and the dynamic shared memory
// a CTA keeps rows of `row` bytes in, for a kernel built for kCtasPerSm
// CTAs an SM: an SM's shared memory split between its CTAs (fewer where
// the registers allow fewer), less the per-block reservation and the
// static arrays, in whole rows.  Found once per instantiation: `ctas` and
// `hold` are its cache (0 until found).
template <typename Kernel>
cudaError_t find_resources(Kernel kernel, int row, int& ctas, int& hold) {
  if (ctas) return cudaSuccess;
  int dev = 0, per_sm = 0, reserved = 0, optin = 0, sms = 0, occ = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  // CTAs an SM: kCtasPerSm, or fewer if the registers allow fewer
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int per = max(1, min(occ, kCtasPerSm));
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
  ctas = occ * sms;
  hold = dyn;
  return cudaSuccess;
}

// One cooperative launch of the persistent grid.  The plan must be the one
// the wrapper made from the same resources (the grid, at most the rows of
// `row` bytes that fit, chunks covering R with none empty); a grid the card
// cannot hold at once is refused, not shrunk.
template <typename Kernel>
cudaError_t coop_launch(Kernel kernel, int row, int ctas, int hold, const Args& a,
                        void** args) {
  if (a.ctas != ctas || a.hold_rows < 0 || (long long)a.hold_rows * row > hold ||
      a.chunks < 1 || a.rows_per_chunk < 1 || (long long)a.chunks * a.rows_per_chunk < a.R ||
      (long long)(a.chunks - 1) * a.rows_per_chunk >= a.R)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(kThreads), args,
                                                (size_t)hold, a.stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kVecIO, bool kRelu, bool kRes>
struct Fwd {
  static constexpr int kRow = kTileC * (int)sizeof(T);  // a held row: x
  static cudaError_t resources(int* ctas, int* hold) {
    static int s_ctas = 0, s_hold = 0;
    cudaError_t err =
        find_resources(bn_fwd_fused_kernel<T, kVecIO, kRelu, kRes>, kRow, s_ctas, s_hold);
    *ctas = s_ctas;
    *hold = s_hold;
    return err;
  }
  static cudaError_t launch(const Args& a) {
    int ctas = 0, hold = 0;
    cudaError_t err = resources(&ctas, &hold);
    if (err != cudaSuccess) return err;
    const T* x = static_cast<const T*>(a.x);
    const T* res = static_cast<const T*>(a.res);
    T* y = static_cast<T*>(a.y);
    const float *gamma = a.gamma, *beta = a.beta;
    float *mean = a.mean, *var = a.var, *ws = a.ws;
    int R = a.R, C = a.C, chunks = a.chunks, rows = a.rows_per_chunk, hold_rows = a.hold_rows;
    float inv_n = 1.0f / (float)a.R, eps = a.eps;
    void* args[] = {&x, &res, &gamma, &beta, &y,    &mean,      &var,   &ws,
                    &R, &C,   &chunks, &rows, &hold_rows, &inv_n, &eps};
    return coop_launch(bn_fwd_fused_kernel<T, kVecIO, kRelu, kRes>, kRow, ctas, hold, a, args);
  }
};

template <typename T, bool kVecIO, bool kRelu, bool kRes>
struct Bwd {
  static constexpr int kRow = 2 * kTileC * (int)sizeof(T);  // a held row: g and x
  static cudaError_t resources(int* ctas, int* hold) {
    static int s_ctas = 0, s_hold = 0;
    cudaError_t err =
        find_resources(bn_bwd_fused_kernel<T, kVecIO, kRelu, kRes>, kRow, s_ctas, s_hold);
    *ctas = s_ctas;
    *hold = s_hold;
    return err;
  }
  static cudaError_t launch(const Args& a) {
    int ctas = 0, hold = 0;
    cudaError_t err = resources(&ctas, &hold);
    if (err != cudaSuccess) return err;
    const T* dy = static_cast<const T*>(a.dy);
    const T* x = static_cast<const T*>(a.x);
    const T* y = static_cast<const T*>(a.y);
    const float *gamma = a.gamma, *mean = a.mean, *var = a.var;
    T* dx = static_cast<T*>(a.dx);
    T* dres = static_cast<T*>(a.dres);
    float *dgamma = a.dgamma, *dbeta = a.dbeta, *ws = a.ws;
    int R = a.R, C = a.C, chunks = a.chunks, rows = a.rows_per_chunk, hold_rows = a.hold_rows;
    float inv_n = 1.0f / (float)a.R, eps = a.eps;
    void* args[] = {&dy,    &x,     &y,  &gamma, &mean,   &var,  &dx,        &dres,  &dgamma,
                    &dbeta, &ws,    &R,  &C,     &chunks, &rows, &hold_rows, &inv_n, &eps};
    return coop_launch(bn_bwd_fused_kernel<T, kVecIO, kRelu, kRes>, kRow, ctas, hold, a, args);
  }
};

// With `a` null: the instantiation's resources into ctas, hold; else its
// launch.  Op is Fwd or Bwd.
template <template <typename, bool, bool, bool> class Op, typename T, bool kVecIO, bool kRelu>
cudaError_t by_res(int res, const Args* a, int* ctas, int* hold) {
  if (res)
    return a ? Op<T, kVecIO, kRelu, true>::launch(*a)
             : Op<T, kVecIO, kRelu, true>::resources(ctas, hold);
  return a ? Op<T, kVecIO, kRelu, false>::launch(*a)
           : Op<T, kVecIO, kRelu, false>::resources(ctas, hold);
}
template <template <typename, bool, bool, bool> class Op, typename T, bool kVecIO>
cudaError_t by_relu(int relu, int res, const Args* a, int* ctas, int* hold) {
  return relu ? by_res<Op, T, kVecIO, true>(res, a, ctas, hold)
              : by_res<Op, T, kVecIO, false>(res, a, ctas, hold);
}
template <template <typename, bool, bool, bool> class Op>
int dispatch(int dtype, int vec, int relu, int res, const Args* a, int* ctas, int* hold) {
  cudaError_t err;
  if (dtype == 1)
    err = vec ? by_relu<Op, __nv_bfloat16, true>(relu, res, a, ctas, hold)
              : by_relu<Op, __nv_bfloat16, false>(relu, res, a, ctas, hold);
  else
    err = vec ? by_relu<Op, float, true>(relu, res, a, ctas, hold)
              : by_relu<Op, float, false>(relu, res, a, ctas, hold);
  return (int)err;
}

}  // namespace

// The grid (the CTAs the card holds at once) and the dynamic shared memory
// each CTA keeps rows in, for one instantiation of K5 or K6.  dtype: 0 =
// float32, 1 = bfloat16.  vec: 1 when C % 8 == 0 and every [R, C] pointer
// is 16-byte aligned.  res: 1 with a residual.  Returns the CUDA error code
// (0 = found).
extern "C" int fused_batchnorm_fwd_resources(int dtype, int vec, int relu, int res, int* ctas,
                                             int* hold_bytes) {
  return dispatch<Fwd>(dtype, vec, relu, res, nullptr, ctas, hold_bytes);
}
extern "C" int fused_batchnorm_bwd_resources(int dtype, int vec, int relu, int res, int* ctas,
                                             int* hold_bytes) {
  return dispatch<Bwd>(dtype, vec, relu, res, nullptr, ctas, hold_bytes);
}

// K5.  res may be null (no residual).  ws holds (2 * chunks + 2) * C
// floats; ctas and hold_rows come from fused_batchnorm_fwd_resources
// (hold_rows at most hold_bytes / (64 * sizeof(x))), chunks * rows_per_chunk
// covers R with no chunk empty.  Returns the CUDA error code of the
// cooperative launch (0 = launched; cudaErrorInvalidValue for another plan).
extern "C" int fused_batchnorm_fwd_launch(const void* x, const void* res, const void* gamma,
                                          const void* beta, void* y, void* mean, void* var,
                                          void* ws, int dtype, int vec, int relu, int R,
                                          int C, int chunks, int rows_per_chunk, int hold_rows,
                                          int ctas, float eps, void* stream) {
  Args a{};
  a.x = x;
  a.res = res;
  a.y = y;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<float*>(mean);
  a.var = static_cast<float*>(var);
  a.ws = static_cast<float*>(ws);
  a.R = R;
  a.C = C;
  a.chunks = chunks;
  a.rows_per_chunk = rows_per_chunk;
  a.hold_rows = hold_rows;
  a.ctas = ctas;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Fwd>(dtype, vec, relu, res != nullptr, &a, nullptr, nullptr);
}

// K6.  y may be null when relu is 0; dres may be null (no residual).  ws
// holds (2 * chunks + 2) * C floats; ctas and hold_rows come from
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
  Args a{};
  a.dy = dy;
  a.x = x;
  a.y = const_cast<void*>(y);
  a.gamma = static_cast<const float*>(gamma);
  a.mean = static_cast<float*>(const_cast<void*>(mean));
  a.var = static_cast<float*>(const_cast<void*>(var));
  a.dx = dx;
  a.dres = dres;
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.ws = static_cast<float*>(ws);
  a.R = R;
  a.C = C;
  a.chunks = chunks;
  a.rows_per_chunk = rows_per_chunk;
  a.hold_rows = hold_rows;
  a.ctas = ctas;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Bwd>(dtype, vec, relu, dres != nullptr, &a, nullptr, nullptr);
}
