// int8 weights-only matmul for Hopper (sm_90a): the kernel K7.
//
// Replaces the TPU kernel tf_operator_tpu/ops/quant_matmul.py::_kernel
// (line 60; launched by _quant_matmul_2d).  It computes the same
// function, out[M, N] = cast((x[M, K] @ bf16(q[K, N])) * s[N]): the int8
// weight converted exactly (|q| <= 127), products accumulated in float32,
// the float32 per-column scale applied to the sum, one cast to x's dtype.
// x is [M, K] row-major (bf16 or float32), q is [K, N] row-major int8 (the
// flax layout, in x out), s is [N] float32, out is [M, N] in x's dtype.
// The wrapper (ops/quant_matmul.py) admits M <= 64, K % 32 == 0 and N a
// multiple of 128; q starts on a 16-byte boundary, and so does bf16 x of
// up to 16 rows (both copied in 16-byte chunks); other x on 4 bytes.
//
// Bound.  2*M flops per int8 weight byte: below the card's ridge for
// every M <= 64, so the bound is the int8 weight bytes at 3.35 TB/s (5.0
// us for a 4096 x 4096 projection, 13.5 us for 4096 x 11008, 39.1 us for
// the 4096 x 32000 head).  The Pallas kernel walks N tiles of 128-512
// columns in order with x resident in VMEM; on Hopper the weight is
// streamed by many CTAs at once instead.
//
// Design (bf16 x).  A weight-streaming GEMV on the tensor cores, on a 2-d
// grid: column tiles of N x splits of K.
//
//   Split-K.  A CTA owns 8 W columns of N (W = 16 or 8, below) and one
//   of `splits` contiguous ranges of K's 16-row steps; its 8 warps take
//   the range's steps in turn.  splits is the most that keep the grid
//   within one wave (the CTAs an SM holds at once, from the occupancy
//   query, times the SMs; a second, partial wave measured slower), at
//   most 8 and no more than leave each warp a step: a 4096 x 4096
//   projection at M = 8 (W = 16, three CTAs an SM) has 32 column tiles, 8
//   splits, 256 CTAs.  The splits of a column tile are one thread-block
//   cluster along K: each CTA adds its warps' partial sums in shared
//   memory, the cluster synchronises, and each CTA then reads the
//   partials of every CTA of the cluster through distributed shared
//   memory, adds them in rank order, scales and casts its share of the
//   outputs.  One launch, no workspace, no atomics: the sums meet in a
//   fixed order, so the result does not depend on scheduling.
//
//   The product is computed transposed, out^T[N, M] = q^T[N, K] x^T[K,
//   M], with mma.sync m16n8k16 (bf16 in, float32 accumulators): the
//   weight is the A operand (16 columns of N a tile) and x the B operand
//   (8 rows of M a tile), so the decode shape M = 8 fills one B tile with
//   no padding.  An A fragment pairs two consecutive K rows of one
//   column, while q is contiguous along N; a lane therefore takes W bytes
//   (W neighbouring columns) of each of its four K rows (2t, 2t + 1, 2t +
//   8, 2t + 9), and the 8 W columns are permuted onto the W / 2 tiles'
//   rows so that each byte lands in a fragment slot of the same lane:
//   tile j's row g is column W g + 2j and its row g + 8 is column W g +
//   2j + 1.  W is 16 for M <= 16 and 8 above (a thread's accumulators,
//   W / 2 tiles x M / 8 tiles x 4 floats, are 64 floats at M = 16 and 32,
//   128 at M = 64, where 4-byte fragments measured slower).  The int8 ->
//   bf16 conversion is exact and costs no conversion instruction: the
//   byte, biased by 128, is placed under the exponent of 2^23 (one byte
//   permute), 2^23 + 128 is subtracted in float32, and two such floats
//   (whose low halves are zero) are packed into one bf16x2 register by a
//   second permute.
//
//   Wide loads through shared memory.  The global reads do not follow
//   the fragment layout: each warp streams its steps through a ring in
//   shared memory with 16-byte cp.async copies (a step's 16 K rows x 8 W
//   columns of the weight, 16 contiguous bytes a lane), 2 KB of the
//   weight in flight (one step at W = 16, two at 8) while it computes on
//   the oldest; the fragment reads from the ring are 16- or 8-byte shared
//   loads, with the 16-byte chunks of the staged tile permuted so that
//   they hit distinct banks.  Deeper rings at W = 16 measured no faster
//   at the 7B shapes: the time goes to the conversion's instructions,
//   which more resident warps (a small ring) hide better.  Up to 16 rows,
//   x's rows of a step are staged beside its weight, so no step waits for
//   x; above that a warp would stage more of x than of the weight, and
//   reads x's fragments through the read-only cache, asked for before it
//   waits for the step's weight.
//
// float32 x (the token-identity checks at float32) takes a plain CUDA-core
// kernel: 32 columns a CTA, one per lane, all of K split across its warps,
// products in float32 FMA, as the JAX float32 dot does.
//
// Not done yet: TMA boxes of the weight (one copy a stage instead of a
// warp's 16-byte copies), x staged once per CTA above 16 rows, wgmma, a
// persistent grid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kF32Cols = 32;     // columns of N a float32 CTA owns
constexpr int kMaxRowTiles = 8;  // M <= 64 in tiles of 8 rows
constexpr int kMaxSplits = 8;    // the portable cluster size

// 16 bytes from global to shared memory, asynchronously, bypassing L1
// (zeros where !valid)
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

// byte b (0..3) of a word whose bytes are int8 values biased by 128,
// as the float32 of the int8 value (exact)
__device__ __forceinline__ float biased_byte_to_float(uint32_t biased, int b) {
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7440 | b);  // 2^23 + u
  return __uint_as_float(bits) - 8388736.0f;                           // - (2^23 + 128)
}

// two floats exact in bf16 (low 16 bits zero) packed as bf16x2, lo first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// red[w][c][r]: warp w's partial sum for column c and row r of a CTA
// owning `cols` columns; the row stride is padded by one float against
// bank conflicts
__device__ __forceinline__ int red_index(int w, int c, int r, int cols, int rows) {
  return (w * cols + c) * (rows + 1) + r;
}

// A step's staged tiles in a warp's ring: the weight's 16 K rows x
// 8 W columns, as 16-byte chunks in 128-byte lines whose chunks are
// permuted (chunk ^ swizzle(line)) so that the fragment reads of a
// quarter or half warp (LDS.128, .64) hit distinct banks; then, up to
// 16 rows, x's 8 MT rows x 16 K values, rows 48 bytes apart (the B
// fragment reads of 8 rows x 4 lanes hit distinct banks).
constexpr int kXLd = 24;  // bf16 a staged x row takes

template <int W>
__device__ __forceinline__ int swizzle(int line) {
  return W == 16 ? line & 6 : (line << 1) & 6;
}

template <int MT, int W>
struct Stage {
  static constexpr int kCols = 8 * W;             // columns of N a CTA owns
  // x is staged beside the weight up to 16 rows; above, each warp would
  // stage more of x than of the weight, and reads it from global memory
  static constexpr bool kStageX = MT <= 2;
  static constexpr int weight = 16 * kCols;       // bytes of a step's weight
  // steps a warp's ring holds: 2 KB of the weight in flight (stages - 1)
  static constexpr int stages = W == 16 ? 2 : 3;
  static constexpr int bytes = weight + (kStageX ? MT * 8 * kXLd * 2 : 0);
  static constexpr int ring = kWarps * stages * bytes;
  static constexpr int red = kWarps * kCols * (MT * 8 + 1) * 4;
  // the ring, reused for the warps' partial sums, then the CTA's sums
  static constexpr int part = ring > red ? ring : red;
  static constexpr int total = part + MT * 8 * kCols * 4;
};

// MT tiles of 8 rows of M (M <= 8 * MT), W weight bytes a lane reads
// from each of its K rows.  grid (N / (8 W), splits), cluster (1, splits)
template <int MT, int W>
__global__ void __launch_bounds__(kThreads)
quant_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                         int m, int k, int n) {
  using L = Stage<MT, W>;
  constexpr int kCols = L::kCols;
  constexpr int kTiles = W / 2;      // mma tiles of 16 columns a lane's W bytes feed
  constexpr int kRows = MT * 8;
  constexpr int kChunks = kCols / 16;  // 16-byte chunks of a weight row
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][kCols][kRows + 1], over the spent ring
  float* part = reinterpret_cast<float*>(smem + L::part);  // [kRows][kCols]: this CTA's sums
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int col0 = blockIdx.x * kCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int steps = k / 16;
  const int step_begin = static_cast<int>(static_cast<long long>(steps) * split / splits);
  const int step_end = static_cast<int>(static_cast<long long>(steps) * (split + 1) / splits);
  // this warp's steps: step_begin + warp, + kWarps, ...
  const int first = step_begin + warp;
  const int nsteps = first < step_end ? (step_end - first + kWarps - 1) / kWarps : 0;
  constexpr int kStages = L::stages;
  unsigned char* ring = smem + warp * kStages * L::bytes;

  // this lane's 16-byte chunks of a step: of the weight tile (from the
  // step's first K row) and of x's rows (from the step's first K
  // column; rows >= m copied as zeros), with their places in a stage
  constexpr int kQCopies = kCols / 32, kXCopies = (2 * kRows + 31) / 32;
  const int8_t* qsrc[kQCopies];
  int qdst[kQCopies];
#pragma unroll
  for (int j = 0; j < kQCopies; ++j) {
    const int c = lane + 32 * j;
    qsrc[j] = q + (size_t)(c / kChunks) * n + col0 + 16 * (c % kChunks);
    qdst[j] = 16 * (c ^ swizzle<W>(c / 8));
  }
  const __nv_bfloat16* xsrc[kXCopies];
  int xdst[kXCopies];
  bool xlive[kXCopies];
#pragma unroll
  for (int j = 0; j < kXCopies; ++j) {
    const int c = lane + 32 * j, r = c / 2;
    xlive[j] = r < m;
    xsrc[j] = x + (size_t)(xlive[j] ? r : 0) * k + 8 * (c % 2);
    xdst[j] = c < 2 * kRows ? L::weight + r * kXLd * 2 + 16 * (c % 2) : -1;
  }

  // the x rows this lane feeds to the B fragments when x is not staged
  const __nv_bfloat16* xrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    xrow[mt] = x + (size_t)(mt * 8 + g < m ? mt * 8 + g : 0) * k + 2 * t;

  // step i of this warp into its stage i % kStages; one commit group a
  // step, empty past the last
  auto stage_in = [&](int i) {
    if (i < nsteps) {
      const int k0 = (first + i * kWarps) * 16;
      unsigned char* st = ring + (i % kStages) * L::bytes;
#pragma unroll
      for (int j = 0; j < kQCopies; ++j) cp_async_16(st + qdst[j], qsrc[j] + (size_t)k0 * n, true);
      if constexpr (L::kStageX) {
#pragma unroll
        for (int j = 0; j < kXCopies; ++j)
          if (xdst[j] >= 0) cp_async_16(st + xdst[j], xsrc[j] + k0, xlive[j]);
      }
    }
    cp_async_commit();
  };

  float acc[kTiles][MT][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.f;

  // where this lane's W bytes of K row r sit in a staged weight tile
  auto wslot = [&](int r) {
    const int c = r * kChunks + (W * g) / 16;
    return 16 * (c ^ swizzle<W>(c / 8)) + (W * g) % 16;
  };
  const int wrow[4] = {wslot(2 * t), wslot(2 * t + 1), wslot(2 * t + 8), wslot(2 * t + 9)};

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage_in(i);
  for (int i = 0; i < nsteps; ++i) {
    stage_in(i + kStages - 1);  // into the stage step i - 1 read
    uint32_t b[MT][2];
    if constexpr (!L::kStageX) {
      // x's B fragments through the read-only cache, asked for before the
      // wait for the weight so that the two latencies overlap
      const int k0 = (first + i * kWarps) * 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xp = xrow[mt] + k0;
        b[mt][0] = mt * 8 + g < m ? __ldg(reinterpret_cast<const unsigned int*>(xp)) : 0u;
        b[mt][1] = mt * 8 + g < m ? __ldg(reinterpret_cast<const unsigned int*>(xp + 8)) : 0u;
      }
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();               // every lane's copies of step i have landed
    const unsigned char* st = ring + (i % kStages) * L::bytes;
    if constexpr (L::kStageX) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr = st + L::weight + (mt * 8 + g) * kXLd * 2 + 4 * t;
        b[mt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[mt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
      }
    }
    // K rows 2t, 2t + 1, 2t + 8, 2t + 9: W / 4 words each
    uint32_t w[4][W / 4];
#pragma unroll
    for (int i2 = 0; i2 < 4; ++i2) {
      const unsigned char* p = st + wrow[i2];
      if constexpr (W == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[i2][0] = v.x, w[i2][1] = v.y, w[i2][2] = v.z, w[i2][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[i2][0] = v.x, w[i2][1] = v.y;
      }
    }
    __syncwarp();               // the stage is free for step i + kStages
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      // word j / 2 of each K row; a0: (row g, K 2t..2t+1) -> column
      // W g + 2j, byte 2 (j % 2) of rows 2t, 2t+1; a1: (row g+8) ->
      // column W g + 2j + 1, the next byte; a2, a3: the same columns at
      // K rows 2t+8, 2t+9
      const int wi = j / 2, by = 2 * (j % 2);
      uint32_t biased[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) biased[r] = w[r][wi] ^ 0x80808080u;
      uint32_t a[4];
      a[0] = pack_bf16x2(biased_byte_to_float(biased[0], by),
                         biased_byte_to_float(biased[1], by));
      a[1] = pack_bf16x2(biased_byte_to_float(biased[0], by + 1),
                         biased_byte_to_float(biased[1], by + 1));
      a[2] = pack_bf16x2(biased_byte_to_float(biased[2], by),
                         biased_byte_to_float(biased[3], by));
      a[3] = pack_bf16x2(biased_byte_to_float(biased[2], by + 1),
                         biased_byte_to_float(biased[3], by + 1));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[j][mt], a, b[mt][0], b[mt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: it holds the partial sums now

  // d0, d1: tile row g (column W g + 2j), M rows 2t, 2t+1; d2, d3: tile
  // row g+8 (column W g + 2j + 1), the same M rows
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = W * g + 2 * j + (r >> 1);
        const int row = mt * 8 + 2 * t + (r & 1);
        red[red_index(warp, c, row, kCols, kRows)] = acc[j][mt][r];
      }
  __syncthreads();
  // this CTA's sums, its warps added in order
  for (int i = threadIdx.x; i < kCols * m; i += kThreads) {
    const int c = i % kCols, r = i / kCols;
    float sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) sum += red[red_index(w2, c, r, kCols, kRows)];
    part[r * kCols + c] = sum;
  }
  // the cluster's CTAs (the splits of this column tile) add each other's
  // sums through distributed shared memory, in rank order; CTA `split`
  // writes every splits-th block of kThreads outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = split * kThreads + threadIdx.x; i < kCols * m; i += splits * kThreads) {
    const int c = i % kCols, r = i / kCols;
    float sum = 0.f;
    for (int rank = 0; rank < splits; ++rank)
      sum += cluster.map_shared_rank(part, rank)[r * kCols + c];
    out[(size_t)r * n + col0 + c] = __float2bfloat16(sum * s[col0 + c]);
  }
  cluster.sync();  // no CTA leaves while another may still read its sums
}

// float32 x: one column per lane, all of K split across the warps,
// products in float32 FMA
template <int MT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out, int m, int k,
                        int n) {
  extern __shared__ float red[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kF32Cols;
  const int rows = MT * 8;
  float acc[MT * 8];
#pragma unroll
  for (int r = 0; r < MT * 8; ++r) acc[r] = 0.f;
  for (int kk = warp; kk < k; kk += kWarps) {
    const float wv = static_cast<float>(q[(size_t)kk * n + col0 + lane]);
#pragma unroll
    for (int r = 0; r < MT * 8; ++r) {
      const int row = r < m ? r : m - 1;  // rows >= m are computed and dropped
      acc[r] = fmaf(__ldg(x + (size_t)row * k + kk), wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < MT * 8; ++r) red[red_index(warp, lane, r, kF32Cols, rows)] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < kF32Cols * m; i += kThreads) {
    const int c = i % kF32Cols, r = i / kF32Cols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[red_index(w, c, r, kF32Cols, rows)];
    out[(size_t)r * n + col0 + c] = sum * s[col0 + c];
  }
}

// above 48 KB a kernel needs its dynamic shared memory raised once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *done = err == cudaSuccess;
  return err;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// K's splits for a grid of `tiles` column tiles: the most that keep the
// grid within one wave (`resident` CTAs an SM), at least 1, at most
// kMaxSplits and no more than leave each warp a step
int auto_splits(int tiles, int steps, int resident) {
  const int wave = resident * sm_count();
  int splits = wave / tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits > steps / kWarps) splits = steps / kWarps;
  return splits > 1 ? splits : 1;
}

template <int MT, int W>
cudaError_t launch_bf16(const void* x, const int8_t* q, const float* s, void* out, int m,
                        int k, int n, cudaStream_t stream) {
  static bool smem_done = false;
  static int resident = 0;  // CTAs an SM holds at once
  constexpr int smem = Stage<MT, W>::total;
  auto kernel = quant_matmul_bf16_kernel<MT, W>;
  cudaError_t err = allow_smem(kernel, smem, &smem_done);
  if (err != cudaSuccess) return err;
  if (!resident) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (resident < 1) resident = 1;
  }
  const int tiles = n / (8 * W);
  const int splits = auto_splits(tiles, k / 16, resident);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x), q, s,
                           static_cast<__nv_bfloat16*>(out), m, k, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_f32(const void* x, const int8_t* q, const float* s, void* out, int m, int k,
                       int n, cudaStream_t stream) {
  static bool smem_done = false;
  const size_t smem = sizeof(float) * kWarps * kF32Cols * (MT * 8 + 1);
  const cudaError_t err = allow_smem(quant_matmul_f32_kernel<MT>, smem, &smem_done);
  if (err != cudaSuccess) return err;
  quant_matmul_f32_kernel<MT><<<n / kF32Cols, kThreads, smem, stream>>>(
      static_cast<const float*>(x), q, s, static_cast<float*>(out), m, k, n);
  return cudaGetLastError();
}

// W = 16 up to 16 rows, 8 above
template <int MT>
cudaError_t launch_mt(const void* x, const int8_t* q, const float* s, void* out, int dtype,
                      int m, int k, int n, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<MT>(x, q, s, out, m, k, n, stream);
  return launch_bf16<MT, MT <= 2 ? 16 : 8>(x, q, s, out, m, k, n, stream);
}

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bf16), q [K, N] int8, s [N] float32,
// out [M, N] in x's dtype, on `stream`.  Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int quant_matmul_launch(const void* x, const void* q, const void* s, void* out,
                                   int dtype, int m, int k, int n, void* stream) {
  if (m < 1 || m > 8 * kMaxRowTiles || k % 32 || n % 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(s);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((m + 7) / 8) {
    case 1: err = launch_mt<1>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 2: err = launch_mt<2>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 3: err = launch_mt<3>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 4: err = launch_mt<4>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 5: err = launch_mt<5>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 6: err = launch_mt<6>(x, qq, ss, out, dtype, m, k, n, st); break;
    case 7: err = launch_mt<7>(x, qq, ss, out, dtype, m, k, n, st); break;
    default: err = launch_mt<8>(x, qq, ss, out, dtype, m, k, n, st); break;
  }
  return (int)err;
}
