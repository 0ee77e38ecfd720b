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
// multiple of 128.
//
// Bound.  2*M flops per int8 weight byte: below the card's ridge for
// every M <= 64, so the bound is the int8 weight bytes at 3.35 TB/s (5.0
// us for a 4096 x 4096 projection, 13.5 us for 4096 x 11008, 39.1 us for
// the 4096 x 32000 head).  The Pallas kernel walks N tiles of 128-512
// columns in order with x resident in VMEM; on Hopper the weight is
// streamed by many CTAs at once instead.
//
// Design (bf16 x).  A weight-streaming GEMV on the tensor cores.  One CTA
// owns 32 columns of N (so N = 4096 already gives 128 CTAs for 132 SMs);
// its 8 warps split K by 16-row steps (step i goes to warp i % 8).  The
// product is computed transposed, out^T[N, M] = q^T[N, K] x^T[K, M], with
// mma.sync m16n8k16 (bf16 in, float32 accumulators): the weight is the A
// operand (16 columns of N per tile, two tiles per warp) and x the B
// operand (8 rows of M per tile), so the decode shape M = 8 fills one B
// tile with no padding.  A fragment pairs two consecutive K rows of one
// column, while q is contiguous along N; a lane therefore reads one
// 4-byte word (4 neighbouring columns) from each of its four K rows, and
// the 32 columns are permuted onto the tiles' rows so that the four bytes
// of a word land in four fragment slots of the same lane: tile j's row g
// is column 4g + 2j and its row g + 8 is column 4g + 2j + 1.  Each warp
// load touches four whole 32-byte sectors.  The int8 -> bf16 conversion
// is exact and costs no conversion instruction: the byte, biased by 128,
// is placed under the exponent of 2^23 (one byte permute), 2^23 + 128 is
// subtracted in float32, and two such floats (whose low halves are zero)
// are packed into one bf16x2 register by a second permute.  The loads of
// kUnroll steps are issued before any of them is used, so each warp keeps
// kUnroll * 512 bytes of the weight in flight.  x is read through the
// read-only cache (every CTA reads all of it).  At the end the eight
// warps' partial sums meet in shared memory and are added in a fixed
// order (the result does not depend on scheduling), scaled and cast.
//
// float32 x (the token-identity checks at float32) takes a plain CUDA-core
// kernel with the same CTA tiling and reduction: products in float32 FMA,
// as the JAX float32 dot does.
//
// Not done yet: split-K across CTAs (N = 4096 gives 128 CTAs, one wave
// with one CTA an SM), 16-byte weight loads, staging x in shared memory,
// TMA and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;      // columns of N a CTA owns
constexpr int kUnroll = 8;     // 16-row steps whose loads a warp keeps in flight
constexpr int kMaxRowTiles = 8;  // M <= 64 in tiles of 8 rows

__device__ __forceinline__ uint32_t load_stream(const int8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// red[w][c][r]: warp w's partial sum for column c (0..31) and row r;
// the row stride is padded by one float against bank conflicts
__device__ __forceinline__ int red_index(int w, int c, int r, int rows) {
  return (w * kCols + c) * (rows + 1) + r;
}

template <typename T>
__device__ __forceinline__ void reduce_scale_store(const float* red, int rows,
                                                   const float* s, T* out, int m,
                                                   int n, int col0) {
  for (int i = threadIdx.x; i < kCols * m; i += kThreads) {
    const int c = i % kCols;
    const int r = i / kCols;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[red_index(w, c, r, rows)];
    store(out + (size_t)r * n + col0 + c, acc * s[col0 + c]);
  }
}

// MT tiles of 8 rows of M (M <= 8 * MT)
template <int MT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                         int m, int k, int n) {
  extern __shared__ float red[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int col0 = blockIdx.x * kCols;
  const int steps = k / 16;
  const int8_t* qcol = q + col0 + 4 * g;

  float acc[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.f;

  // x rows this lane feeds to the B fragments (row >= m reads as zero)
  const __nv_bfloat16* xrow[MT];
  bool xlive[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = mt * 8 + g;
    xlive[mt] = row < m;
    xrow[mt] = x + (size_t)(xlive[mt] ? row : 0) * k + 2 * t;
  }

  for (int base = warp; base < steps; base += kWarps * kUnroll) {
    uint32_t w[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int step = base + u * kWarps;
      if (step < steps) {
        const int8_t* p = qcol + (size_t)(step * 16 + 2 * t) * n;
        w[u][0] = load_stream(p);                   // K row 2t
        w[u][1] = load_stream(p + n);               // 2t + 1
        w[u][2] = load_stream(p + (size_t)8 * n);   // 2t + 8
        w[u][3] = load_stream(p + (size_t)9 * n);   // 2t + 9
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int step = base + u * kWarps;
      if (step >= steps) break;
      const int k0 = step * 16;
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xp = xrow[mt] + k0;
        b[mt][0] = xlive[mt] ? __ldg(reinterpret_cast<const unsigned int*>(xp)) : 0u;
        b[mt][1] = xlive[mt] ? __ldg(reinterpret_cast<const unsigned int*>(xp + 8)) : 0u;
      }
      uint32_t biased[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) biased[i] = w[u][i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // a0: (row g, K 2t..2t+1) -> column 4g+2j, byte 2j of rows 2t, 2t+1
        // a1: (row g+8, K 2t..2t+1) -> column 4g+2j+1, byte 2j+1
        // a2, a3: the same columns at K rows 2t+8, 2t+9
        uint32_t a[4];
        a[0] = pack_bf16x2(biased_byte_to_float(biased[0], 2 * j),
                           biased_byte_to_float(biased[1], 2 * j));
        a[1] = pack_bf16x2(biased_byte_to_float(biased[0], 2 * j + 1),
                           biased_byte_to_float(biased[1], 2 * j + 1));
        a[2] = pack_bf16x2(biased_byte_to_float(biased[2], 2 * j),
                           biased_byte_to_float(biased[3], 2 * j));
        a[3] = pack_bf16x2(biased_byte_to_float(biased[2], 2 * j + 1),
                           biased_byte_to_float(biased[3], 2 * j + 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[j][mt], a, b[mt][0], b[mt][1]);
      }
    }
  }

  // d0, d1: tile row g (column 4g+2j), M rows 2t, 2t+1; d2, d3: tile
  // row g+8 (column 4g+2j+1), the same M rows
  const int rows = MT * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 4 * g + 2 * j + (r >> 1);
        const int row = mt * 8 + 2 * t + (r & 1);
        red[red_index(warp, c, row, rows)] = acc[j][mt][r];
      }
  __syncthreads();
  reduce_scale_store(red, rows, s, out, m, n, col0);
}

// float32 x: one column per lane, K rows split across the warps as in
// the bf16 kernel, products in float32 FMA
template <int MT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, float* __restrict__ out, int m, int k,
                        int n) {
  extern __shared__ float red[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols;
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
  for (int r = 0; r < MT * 8; ++r) red[red_index(warp, lane, r, rows)] = acc[r];
  __syncthreads();
  reduce_scale_store(red, rows, s, out, m, n, col0);
}

size_t red_bytes(int mt) { return sizeof(float) * kWarps * kCols * (mt * 8 + 1); }

// above 48 KB a kernel needs its dynamic shared memory raised once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *done = err == cudaSuccess;
  return err;
}

template <int MT>
cudaError_t launch_mt(const void* x, const int8_t* q, const float* s, void* out, int dtype,
                      int m, int k, int n, cudaStream_t stream) {
  static bool smem_bf16 = false, smem_f32 = false;
  const size_t smem = red_bytes(MT);
  const dim3 grid(n / kCols);
  if (dtype == 1) {
    const cudaError_t err = allow_smem(quant_matmul_bf16_kernel<MT>, smem, &smem_bf16);
    if (err != cudaSuccess) return err;
    quant_matmul_bf16_kernel<MT><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, static_cast<__nv_bfloat16*>(out), m, k, n);
  } else {
    const cudaError_t err = allow_smem(quant_matmul_f32_kernel<MT>, smem, &smem_f32);
    if (err != cudaSuccess) return err;
    quant_matmul_f32_kernel<MT><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), q, s, static_cast<float*>(out), m, k, n);
  }
  return cudaGetLastError();
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
