// Paged-attention decode for Hopper (sm_90a): the kernel K4.
//
// Replaces the TPU kernel tf_operator_tpu/ops/paged_attention.py::
// _paged_attn_kernel (line 195; launched by _paged_attention_multi_pallas).
// It computes the same function: S seats x K query rows attend to the
// per-layer KV arenas [NB, Hkv, bs, D] through block tables [S, MB] int32
// and lengths [S] int32.  Query row t of seat s sees positions p <
// lengths[s] - (K-1-t), and positions at or past MB * bs are never read;
// masked logits take no weight, the softmax is online in float32, and the
// finish divides by max(l, 1e-37) before casting to the arena dtype.
//
// Layout: q [S, K, H, D], out [S, K, H, D] in the arena dtype (float or
// bf16), H = Hkv * group.  The G = K * group query rows of a kv head are
// ordered (t, g): row r is head h * group + g of draft token t.
//
// Bound.  Decode attention does 4 D flops per (row, position) pair against
// 2 D sizeof(T) bytes of K and V per position and kv head: it is bound by
// the live K/V bytes at 3.35 TB/s.  The design keeps many loads in flight
// on every SM and every thread busy on the math that hides them.
//
// Design.
//
//   Split context (flash-decoding) in one launch.  The grid is (split, kv
//   head x row group, seat).  The wrapper sizes the splits from MB * bs
//   and the grid alone (`chunk` positions each, up to 8, about as many as
//   fill the CTAs the card holds at once), so the host never reads
//   lengths.  The splits of one (head, row group, seat) form a thread-block
//   cluster along x.  A CTA whose range starts at or past the seat's
//   length leaves at once: nothing reads its shared memory, and a cluster
//   barrier waits only for threads that have not exited.  Rank 0 always
//   runs; after the cluster barrier it reads the live ranks' partials (m,
//   l, acc[rows][D]) through distributed shared memory, adds them in rank
//   order and writes the output.  No atomics and no workspace: the same
//   bits come out every run.  A second barrier keeps every live CTA
//   resident until rank 0 has read it.
//
//   Rows.  A CTA carries GR = 1, 2 or 4 query rows (G rounded up, at most
//   4); G > 4 (GQA groups of draft tokens) takes ceil(G / 4) row groups,
//   each a CTA of its own that streams the same K/V (the second and later
//   readers mostly from L2).  Registers hold each lane's slice of the GR
//   query rows, pre-scaled by log2(e) / sqrt(D), and its accumulators.
//
//   Lanes.  A position's D values are split over L = D sizeof(T) / 16
//   lanes (one 16-byte vector each; 4 to 32 lanes), so a warp scores 32 / L
//   positions at once; a score is reduced over its L lanes by shuffles.
//   A warp tile is 4 such steps (4 KB of K and V whatever D and the dtype),
//   and the CTA's four warps take its range's tiles in turn.
//
//   Ring.  Each warp streams its own tiles through a 3-stage ring in shared
//   memory with 16-byte cp.async copies (zero-filled past the range, the
//   seat's length or MB * bs: those positions are never read), two tiles
//   in flight while it computes on the oldest (50 KB a CTA, four CTAs an
//   SM; a deeper ring, or a grid of more, shorter splits, measured
//   slower).  Each lane copies exactly the 16-byte vectors it later reads,
//   so cp.async.wait_group alone makes a tile ready: no barrier of any
//   kind inside the loop.  A lane reads its own table entries.
//
//   Softmax.  Each lane group keeps its own running (m, l, acc) per row
//   in the log2 domain; a masked position gets weight exactly 0, so a
//   group, warp or split that sees no visible position for a row
//   contributes l = 0 and acc = 0 wherever it is added, even where every
//   m is still the finfo(float32).min fill.  Lane groups merge by
//   shuffles and warps through shared memory once, at the end of the
//   CTA's range, in a fixed order.
//
// What it does not do: the tensor cores (G > 1 takes CUDA-core FMAs), TMA
// boxes for the K/V rows (cp.async per lane; a box would need the block
// index of each row and a tensor map per arena), a split count that
// adapts to the seats' real lengths (that would need the host to read
// them).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // ring depth of a warp
constexpr int kSteps = 4;         // positions a lane group scores per tile
constexpr int kTileBytes = 4096;  // K and V bytes of one warp tile
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr float kNegFill = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Geo {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements of a 16-byte vector
  static constexpr int kLanes = D / kVec;           // lanes of one position
  static constexpr int kGroups = 32 / kLanes;       // positions a warp scores at once
  static constexpr int kTile = kSteps * kGroups;    // positions of a warp tile
  static_assert(kLanes >= 1 && kLanes <= 32 && kTile * D * (int)sizeof(T) * 2 == kTileBytes,
                "a warp tile is 4 KB of K and V");
};

template <int GR, int D>
struct Smem {
  static constexpr size_t kRing = (size_t)kWarps * kStages * kTileBytes;
  // a CTA's partial: acc [GR][D], then m [GR], l [GR]
  static constexpr size_t kPart = (size_t)GR * (D + 2) * sizeof(float);
  static constexpr size_t kTotal = kRing + kPart;
};

// 16 bytes from global to shared memory, asynchronously, bypassing L1
// (zeros, and no read, where !valid)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// a 16-byte vector as floats
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the upper half of its float32
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int GR>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                             const T* __restrict__ v_arena,
                             const int32_t* __restrict__ tables,
                             const int32_t* __restrict__ lengths, T* __restrict__ out,
                             int n_kv_heads, int bs, int max_blocks, int k_new, int group,
                             int row_groups, int chunk, float qscale) {
  using G = Geo<T, D>;
  constexpr int kVec = G::kVec, kLanes = G::kLanes, kGroups = G::kGroups, kTile = G::kTile;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;
  const int h = blockIdx.y / row_groups;
  const int row0 = (blockIdx.y - h * row_groups) * GR;
  const int s = blockIdx.z;
  const int rows = min(GR, k_new * group - row0);
  const int n_heads = n_kv_heads * group;

  // the range of positions this split owns, cut at the seat's length and
  // at the table's end
  const int length = lengths[s];
  const int limit = max(0, min(length, max_blocks * bs));
  const int start = split * chunk;
  const int end = min(limit, start + chunk);
  if (split > 0 && start >= limit) return;  // an empty split: nobody reads it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanes, col = lane % kLanes;

  float qv[GR][kVec], acc[GR][kVec], m[GR], l[GR];
  int vis[GR];  // positions below vis[r] are visible to row r (and loaded)
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int row = row0 + min(r, rows - 1);
    const int t = row / group;
    const T* src = q + (((size_t)s * k_new + t) * n_heads + h * group + (row - t * group)) * D +
                   col * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      qv[r][e] = to_float(src[e]) * qscale;
      acc[r][e] = 0.f;
    }
    m[r] = kNegFill;
    l[r] = 0.f;
    vis[r] = min(end, length - (k_new - 1 - t));
  }

  // this warp's ring; its tiles are the range's tiles warp, warp + 4, ...
  unsigned char* ring = smem + (size_t)warp * kStages * kTileBytes;
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const int32_t* table = tables + (size_t)s * max_blocks;
  const size_t head_off = (size_t)h * bs * D + (size_t)col * kVec;

  auto issue = [&](int i) {
    const int base = start + (warp + i * kWarps) * kTile + grp;
    unsigned char* st = ring + (i % kStages) * kTileBytes;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int pos = base + j * kGroups;
      const bool ok = pos < end;
      size_t off = 0;
      if (ok) {
        const int blk = pos / bs;
        off = (size_t)__ldg(table + blk) * n_kv_heads * bs * D + head_off +
              (size_t)(pos - blk * bs) * D;
      }
      cp_async_16(st + (j * 32 + lane) * 16, k_arena + off, ok);
      cp_async_16(st + kTileBytes / 2 + (j * 32 + lane) * 16, v_arena + off, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    // the stage refilled here was read by this lane alone, in the
    // previous iteration
    if (i + kStages - 1 < my_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile i has landed
    const unsigned char* st = ring + (i % kStages) * kTileBytes;
    const int base = start + (warp + i * kWarps) * kTile + grp;

    float sc[GR][kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      float kf[kVec];
      unpack(*reinterpret_cast<const uint4*>(st + (j * 32 + lane) * 16), kf);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(qv[r][e], kf[e], d);
        sc[r][j] = d;
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < GR; ++r)
#pragma unroll
        for (int j = 0; j < kSteps; ++j) sc[r][j] += __shfl_xor_sync(0xffffffffu, sc[r][j], o);

#pragma unroll
    for (int r = 0; r < GR; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        if (base + j * kGroups < vis[r]) mx = fmaxf(mx, sc[r][j]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        sc[r][j] = base + j * kGroups < vis[r] ? exp2f(sc[r][j] - mx) : 0.f;
        sum += sc[r][j];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      float vf[kVec];
      unpack(*reinterpret_cast<const uint4*>(st + kTileBytes / 2 + (j * 32 + lane) * 16), vf);
#pragma unroll
      for (int r = 0; r < GR; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(sc[r][j], vf[e], acc[r][e]);
    }
  }
  cp_async_wait<0>();

  // the warp's lane groups meet (shuffles, a fixed order)
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mn), b = exp2f(mo - mn);
      l[r] = l[r] * a + lo * b;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * a + ao * b;
      }
      m[r] = mn;
    }
  // lane group 0 leaves the warp's partial in the warp's own (now idle)
  // ring: acc [GR][D], m [GR], l [GR]
  float* wpart = reinterpret_cast<float*>(ring);
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < GR; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) wpart[r * D + col * kVec + e] = acc[r][e];
      if (col == 0) {
        wpart[GR * D + r] = m[r];
        wpart[GR * D + GR + r] = l[r];
      }
    }
  }
  __syncthreads();

  // the CTA's partial: its warps added in order
  float* part = reinterpret_cast<float*>(smem + Smem<GR, D>::kRing);
  for (int idx = threadIdx.x; idx < GR * D; idx += kThreads) {
    const int r = idx / D;
    float mx = kNegFill;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, reinterpret_cast<const float*>(smem + (size_t)w * kStages * kTileBytes)[GR * D + r]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wp = reinterpret_cast<const float*>(smem + (size_t)w * kStages * kTileBytes);
      const float wt = exp2f(wp[GR * D + r] - mx);
      sl += wp[GR * D + GR + r] * wt;
      sa += wp[idx] * wt;
    }
    part[idx] = sa;
    if (idx % D == 0) {
      part[GR * D + r] = mx;
      part[GR * D + GR + r] = sl;
    }
  }

  // the live splits meet in rank 0, through distributed shared memory, in
  // rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    const int live = limit > 0 ? min((int)gridDim.x, (limit + chunk - 1) / chunk) : 1;
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      float mx = kNegFill;
      for (int k = 0; k < live; ++k) mx = fmaxf(mx, cluster.map_shared_rank(part, k)[GR * D + r]);
      float sl = 0.f, sa = 0.f;
      for (int k = 0; k < live; ++k) {
        const float* rp = cluster.map_shared_rank(part, k);
        const float wt = exp2f(rp[GR * D + r] - mx);
        sl += rp[GR * D + GR + r] * wt;
        sa += rp[idx] * wt;
      }
      const int row = row0 + r;
      const int t = row / group;
      out[(((size_t)s * k_new + t) * n_heads + h * group + (row - t * group)) * D + c] =
          from_float<T>(sa / fmaxf(sl, 1e-37f));
    }
  }
  cluster.sync();  // no live CTA leaves while rank 0 may still read it
}

template <typename T, int D, int GR>
cudaError_t launch_split(const void* q, const void* k_arena, const void* v_arena,
                         const void* tables, const void* lengths, void* out, int seats,
                         int n_kv_heads, int bs, int max_blocks, int k_new, int group,
                         int splits, int chunk, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<GR, D>::kTotal;
  auto kernel = paged_attention_split_kernel<T, D, GR>;
  // above 48 KB, dynamic shared memory must be opted into, once
  static bool smem_done = false;
  if (!smem_done) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_done = true;
  }
  const int row_groups = (k_new * group + GR - 1) / GR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_kv_heads * row_groups, seats);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_arena),
      static_cast<const T*>(v_arena), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), n_kv_heads, bs, max_blocks,
      k_new, group, row_groups, chunk, scale * kLog2e);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// GR = 1, 2 or 4 query rows a CTA
template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k_arena, const void* v_arena,
                        const void* tables, const void* lengths, void* out, int seats,
                        int n_kv_heads, int bs, int max_blocks, int k_new, int group, int splits,
                        int chunk, float scale, cudaStream_t st) {
  const int g_rows = k_new * group;
  if (g_rows == 1)
    return launch_split<T, D, 1>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                 bs, max_blocks, k_new, group, splits, chunk, scale, st);
  if (g_rows == 2)
    return launch_split<T, D, 2>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                 bs, max_blocks, k_new, group, splits, chunk, scale, st);
  return launch_split<T, D, 4>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                               bs, max_blocks, k_new, group, splits, chunk, scale, st);
}

// CTAs of one instantiation the card holds at once (occupancy x SMs)
template <typename T, int D, int GR>
cudaError_t resident(int* ctas) {
  auto kernel = paged_attention_split_kernel<T, D, GR>;
  constexpr size_t smem = Smem<GR, D>::kTotal;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  *ctas = occ * sms;
  return err;
}

template <typename T, int D>
cudaError_t resident_rows(int rows, int* ctas) {
  if (rows == 1) return resident<T, D, 1>(ctas);
  if (rows == 2) return resident<T, D, 2>(ctas);
  return resident<T, D, 4>(ctas);
}

template <typename T>
cudaError_t resident_dtype(int d, int rows, int* ctas) {
  switch (d) {
    case 32: return resident_rows<T, 32>(rows, ctas);
    case 64: return resident_rows<T, 64>(rows, ctas);
    case 128: return resident_rows<T, 128>(rows, ctas);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k_arena, const void* v_arena,
                         const void* tables, const void* lengths, void* out, int seats,
                         int n_kv_heads, int bs, int d, int max_blocks, int k_new, int group,
                         int splits, int chunk, float scale, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_rows<T, 32>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                bs, max_blocks, k_new, group, splits, chunk, scale, st);
    case 64:
      return launch_rows<T, 64>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                bs, max_blocks, k_new, group, splits, chunk, scale, st);
    case 128:
      return launch_rows<T, 128>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                 bs, max_blocks, k_new, group, splits, chunk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The CTAs the card holds at once of the kernel for dtype (0 = float32, 1 =
// bfloat16), head_dim and `rows` query rows a CTA (1, 2 or 4), into *ctas.
// Returns the CUDA error code (0 = found).
extern "C" int paged_attention_resident_ctas(int dtype, int head_dim, int rows, int* ctas) {
  if (dtype == 1) return (int)resident_dtype<__nv_bfloat16>(head_dim, rows, ctas);
  return (int)resident_dtype<float>(head_dim, rows, ctas);
}

// dtype: 0 = float32, 1 = bfloat16.  splits (1..8) ranges of `chunk`
// positions must cover max_blocks * block_size.  Returns the CUDA error
// code of the launch (0 = launched); a fault during the run shows at the
// next synchronising call.
extern "C" int paged_attention_launch(const void* q, const void* k_arena,
                                      const void* v_arena, const void* tables,
                                      const void* lengths, void* out, int dtype, int seats,
                                      int n_kv_heads, int block_size, int head_dim,
                                      int max_blocks, int k_new, int group, int splits,
                                      int chunk, float scale, void* stream) {
  if (splits < 1 || splits > kMaxSplits || chunk < 1 ||
      (long long)splits * chunk < (long long)max_blocks * block_size || k_new < 1 ||
      group < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(q, k_arena, v_arena, tables, lengths, out, seats,
                                            n_kv_heads, block_size, head_dim, max_blocks,
                                            k_new, group, splits, chunk, scale, st);
  return (int)launch_dtype<float>(q, k_arena, v_arena, tables, lengths, out, seats, n_kv_heads,
                                  block_size, head_dim, max_blocks, k_new, group, splits, chunk,
                                  scale, st);
}
