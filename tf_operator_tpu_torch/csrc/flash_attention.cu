// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three TPU kernels of tf_operator_tpu/ops/flash_attention.py
// and computes the same functions.  Each C entry point launches the bf16
// kernel (the training path, tensor cores) or the float32 one (plain FMA):
//
//   K1 _flash_kernel         flash_fwd_launch:     flash_fwd_bf16_kernel<D>
//                                                  flash_fwd_f32_kernel
//   K2 _flash_bwd_dq_kernel  flash_bwd_dq_launch:  flash_bwd_dq_bf16_kernel<D>
//                                                  flash_bwd_dq_f32_kernel
//   K3 _flash_bwd_dkv_kernel flash_bwd_dkv_launch: flash_bwd_dkv_bf16_kernel<D>
//                                                  flash_bwd_dkv_f32_kernel
//
// Layout: q, dO, out [B, H, Sq, D];
// k, v [B, Hkv, Sk, D] with H = Hkv * group; lse and delta [B, H, Sq]
// float32.  All contiguous.  Logits are (q . k) * scale; the causal mask
// is top-left aligned (qpos >= kpos, both counted from 0, whatever Sq and
// Sk are); a window keeps qpos - kpos < window; masked logits are
// finfo(float32).min, never -inf.  The forward's softmax is online in
// float32, divides by max(l, 1e-37) and writes
// lse = m + log(max(l, 1e-37)).  The backward recomputes
// p = exp(logit - lse) from the saved lse, takes delta = rowsum(dO * O)
// from the caller, and forms ds = p * (dO . v - delta);
// dq = scale * ds . k, dk = ds^T . (q * scale), dv = p^T . dO.
//
// Design.  The TPU grid's sequential block dimension becomes a loop
// inside one CTA:
//   K1, K2: one CTA per (64-row q tile, head, batch) loops over the K/V
//           tiles the causal mask and the window let in;
//   K3:     one CTA per (64-row kv tile, kv head, batch) loops over the
//           group's query heads x the q tiles that can see the kv tile,
//           and accumulates dK and dV in registers: GQA folds into the
//           loop as the JAX kernel folds it into its grid, with no
//           atomics and no group-sum afterwards.
// Tiles are copied into shared memory with 16-byte copies (cp.async on
// the bf16 path, every copy of a tile in flight at once), rows padded by
// 16 bytes against bank conflicts; rows past Sq or Sk load as zeros and
// are masked, so any length works.
//
// bf16 (the training path): 4 warps a CTA, 16 rows a warp; scores,
// probabilities, ds and the output accumulators stay in registers as
// mma.sync m16n8k16 fragments (float32 accumulation), operands come
// from shared memory through ldmatrix, and a p or ds tile becomes the A
// operand of the next product without leaving the registers.  p and ds
// are rounded to bf16 only as operands.
// float32 (exactness, not speed): tile products from shared memory on
// plain FMA (no TF32), 8 warps a CTA.
//
// Bound.  At the training shape (S 2048, D 128, bf16) attention does
// O(S^2 D) flops on O(S D) bytes: it is bound by operations (the tensor
// cores).  What the bf16 design does not yet do: overlap the next
// tile's copies with the current tile's math (double buffering, TMA),
// fewer registers in K3 (254 at D = 128: two CTAs an SM), wgmma, warp
// specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegFill = -3.4028234663852886e38f;  // finfo(float32).min

typedef __nv_bfloat16 bf16;

// q and kv rows of a float32 tile
constexpr int kBM = 32, kBN = 32;

// row stride (floats) of a float32 shared tile: 16 bytes of padding
__host__ __device__ __forceinline__ int pad_ld(int cols) { return cols + 4; }

// ---------------------------------------------------------------------
// float32: tile products from shared memory on FMA.
//
//   C(m, n) = base(m, n) + alpha * sum_k A(m, k) B(k, n)
//   base = C * rs[m] when rs is given, else C when accumulate, else 0
//   A(m, k) = AK ? A[m * lda + k] : A[k * lda + m]
//   B(k, n) = BK ? B[n * ldb + k] : B[k * ldb + n]
//

__device__ __forceinline__ void store_c(float* C, int ldc, int m, int n,
                                        float v, float alpha, const float* rs,
                                        bool accumulate) {
  float* c = C + m * ldc + n;
  const float base = rs ? *c * rs[m] : (accumulate ? *c : 0.f);
  *c = base + alpha * v;
}

template <bool AK, bool BK>
__device__ void tile_gemm(float* C, int ldc, int M, int N, int K,
                          const float* A, int lda, const float* B, int ldb,
                          float alpha, const float* rs, bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int m = idx / N, n = idx - m * N;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = AK ? A[m * lda + k] : A[k * lda + m];
      const float b = BK ? B[n * ldb + k] : B[k * ldb + n];
      acc = fmaf(a, b, acc);
    }
    store_c(C, ldc, m, n, acc, alpha, rs, accumulate);
  }
}

// ---------------------------------------------------------------------
// Global <-> shared copies.

// rows [row0, row0 + rows) of a [S, D] slab into a [rows][ld] tile,
// zeros past S; 16-byte copies (D % 4 == 0)
__device__ void load_tile(float* dst, int ld, const float* src, int row0,
                          int rows, int S, int D) {
  const int chunks = D / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx - r * chunks) * 4;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ void load_rows(float* dst, const float* src, int row0, int rows,
                          int S) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// scale * a [rows][ld] tile -> rows [row0, min(row0+rows, S)) of a
// [S, D] slab
__device__ void store_tile(float* dst, const float* a, int ld, int row0,
                           int rows, int S, int D, float scale) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    if (row0 + r < S) dst[(size_t)(row0 + r) * D + c] = a[r * ld + c] * scale;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal,
                                        int window) {
  if (kpos >= Sk) return false;
  if (!causal) return true;
  if (qpos < kpos) return false;
  return window <= 0 || qpos - kpos < window;
}

// the K/V tiles [kt_begin, kt_end) that q rows [q_lo, q_hi] can see
__device__ __forceinline__ void kv_range(int q_lo, int q_hi, int Sk, int BN,
                                         int causal, int window, int* begin,
                                         int* end) {
  const int nk = (Sk + BN - 1) / BN;
  *begin = 0;
  *end = nk;
  if (causal) {
    *end = min(nk, q_hi / BN + 1);
    if (window > 0) *begin = max(0, q_lo - window + 1) / BN;
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// the shared-memory layout of one float32 kernel kind; buffers a kind
// does not use take no room
struct Smem {
  // offsets in bytes from the start of dynamic shared memory
  int q, k, v, dout, s, dp, p, ds, acc0, acc1, rows0, rows1, rows2, total;
  __host__ __device__ Smem(int D, Kind kind) {
    const int BM = kBM, BN = kBN, ldd = pad_ld(D);
    const int tile_q = BM * ldd * 4, tile_k = BN * ldd * 4;
    const int tile_s = BM * pad_ld(BN) * 4, tile_p = tile_s;
    const bool bwd = kind != kFwd;
    int o = 0;
    q = o;    o += tile_q;
    dout = o; o += bwd ? tile_q : 0;
    k = o;    o += tile_k;
    v = o;    o += tile_k;
    s = o;    o += tile_s;
    dp = o;   o += bwd ? tile_s : 0;
    p = o;    o += kind != kDq ? tile_p : 0;
    ds = o;   o += bwd ? tile_p : 0;
    // fwd and dq accumulate q rows, dkv kv rows
    acc0 = o; o += (kind == kDkv ? BN : BM) * ldd * 4;
    acc1 = o; o += kind == kDkv ? BN * ldd * 4 : 0;
    rows0 = o; o += BM * 4;
    rows1 = o; o += BM * 4;
    rows2 = o; o += BM * 4;
    total = o;
  }
};

// per-row reductions across the kThreads / BM consecutive threads of a row
template <int TPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------
// K1: forward.  grid (q tiles, H, B).

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int group, int Sq,
                     int Sk, int D, int causal, int window, float scale) {
  constexpr int BM = kBM, BN = kBN, TPR = kThreads / BM;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(D, kFwd);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* o_s = reinterpret_cast<float*>(smem + L.acc0);
  float* m_s = reinterpret_cast<float*>(smem + L.rows0);
  float* l_s = reinterpret_cast<float*>(smem + L.rows1);
  float* a_s = reinterpret_cast<float*>(smem + L.rows2);
  const int ldd = pad_ld(D), ldn = pad_ld(BN);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q_lo = qt * BM, q_hi = min(q_lo + BM, Sq) - 1;
  const float* qg = q + ((size_t)b * H + h) * Sq * D;
  const float* kg = k + ((size_t)b * (H / group) + hk) * Sk * D;
  const float* vg = v + ((size_t)b * (H / group) + hk) * Sk * D;

  load_tile(q_s, ldd, qg, q_lo, BM, Sq, D);
  for (int i = threadIdx.x; i < BM * ldd; i += kThreads) o_s[i] = 0.f;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    m_s[r] = kNegFill;
    l_s[r] = 0.f;
  }
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, BN, causal, window, &kt_begin, &kt_end);
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int qpos = q_lo + row;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BN;
    load_tile(k_s, ldd, kg, k_lo, BN, Sk, D);
    load_tile(v_s, ldd, vg, k_lo, BN, Sk, D);
    __syncthreads();
    tile_gemm<true, true>(s_s, ldn, BM, BN, D, q_s, ldd, k_s, ldd, scale,
                          nullptr, false);
    __syncthreads();
    // online softmax over this tile, TPR threads per row
    float mx = kNegFill;
    for (int c = sub; c < BN; c += TPR) {
      float x = s_s[row * ldn + c];
      if (!visible(qpos, k_lo + c, Sk, causal, window)) x = kNegFill;
      s_s[row * ldn + c] = x;
      mx = fmaxf(mx, x);
    }
    mx = row_max<TPR>(mx);
    const float m_prev = m_s[row];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = sub; c < BN; c += TPR) {
      const float p = expf(s_s[row * ldn + c] - m_new);
      p_s[row * ldn + c] = p;
      sum += p;
    }
    sum = row_sum<TPR>(sum);
    __syncwarp();
    if (sub == 0) {
      const float alpha = expf(m_prev - m_new);
      a_s[row] = alpha;
      l_s[row] = l_s[row] * alpha + sum;
      m_s[row] = m_new;
    }
    __syncthreads();
    // o = o * alpha[row] + p . v
    tile_gemm<true, false>(o_s, ldd, BM, D, BN, p_s, ldn, v_s, ldd, 1.f, a_s,
                           false);
    __syncthreads();
  }

  __syncthreads();
  float* og = out + ((size_t)b * H + h) * Sq * D;
  for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    if (q_lo + r >= Sq) continue;
    og[(size_t)(q_lo + r) * D + c] =
        o_s[r * ldd + c] / fmaxf(l_s[r], 1e-37f);
  }
  float* lg = lse + ((size_t)b * H + h) * Sq;
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (q_lo + r < Sq) lg[q_lo + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-37f));
}

// ---------------------------------------------------------------------
// K2: dq.  grid (q tiles, H, B).

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int group, int Sq,
                        int Sk, int D, int causal, int window, float scale) {
  constexpr int BM = kBM, BN = kBN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(D, kDq);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  float* dq_s = reinterpret_cast<float*>(smem + L.acc0);
  float* lse_s = reinterpret_cast<float*>(smem + L.rows0);
  float* delta_s = reinterpret_cast<float*>(smem + L.rows1);
  const int ldd = pad_ld(D), ldn = pad_ld(BN);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q_lo = qt * BM, q_hi = min(q_lo + BM, Sq) - 1;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const float* kg = k + ((size_t)b * (H / group) + hk) * Sk * D;
  const float* vg = v + ((size_t)b * (H / group) + hk) * Sk * D;

  load_tile(q_s, ldd, q + qoff * D, q_lo, BM, Sq, D);
  load_tile(do_s, ldd, dout + qoff * D, q_lo, BM, Sq, D);
  load_rows(lse_s, lse + qoff, q_lo, BM, Sq);
  load_rows(delta_s, delta + qoff, q_lo, BM, Sq);
  for (int i = threadIdx.x; i < BM * ldd; i += kThreads) dq_s[i] = 0.f;
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, BN, causal, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BN;
    load_tile(k_s, ldd, kg, k_lo, BN, Sk, D);
    load_tile(v_s, ldd, vg, k_lo, BN, Sk, D);
    __syncthreads();
    tile_gemm<true, true>(s_s, ldn, BM, BN, D, q_s, ldd, k_s, ldd, scale,
                          nullptr, false);
    tile_gemm<true, true>(dp_s, ldn, BM, BN, D, do_s, ldd, v_s, ldd, 1.f,
                          nullptr, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx - r * BN;
      const int qpos = q_lo + r;
      float ds = 0.f;
      if (qpos < Sq && visible(qpos, k_lo + c, Sk, causal, window)) {
        const float p = expf(s_s[r * ldn + c] - lse_s[r]);
        ds = p * (dp_s[r * ldn + c] - delta_s[r]);
      }
      ds_s[r * ldn + c] = ds;
    }
    __syncthreads();
    tile_gemm<true, false>(dq_s, ldd, BM, D, BN, ds_s, ldn, k_s, ldd, 1.f,
                           nullptr, true);
    __syncthreads();
  }
  __syncthreads();
  store_tile(dq + qoff * D, dq_s, ldd, q_lo, BM, Sq, D, scale);
}

// ---------------------------------------------------------------------
// K3: dk, dv at Hkv width.  grid (kv tiles, Hkv, B).

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
                         int group, int Sq, int Sk, int D, int causal,
                         int window, float scale) {
  constexpr int BM = kBM, BN = kBN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(D, kDkv);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  float* dk_s = reinterpret_cast<float*>(smem + L.acc0);
  float* dv_s = reinterpret_cast<float*>(smem + L.acc1);
  float* lse_s = reinterpret_cast<float*>(smem + L.rows0);
  float* delta_s = reinterpret_cast<float*>(smem + L.rows1);
  const int ldd = pad_ld(D), ldn = pad_ld(BN);

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group;
  const int k_lo = kt * BN, k_hi = min(k_lo + BN, Sk) - 1;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;

  load_tile(k_s, ldd, k + koff, k_lo, BN, Sk, D);
  load_tile(v_s, ldd, v + koff, k_lo, BN, Sk, D);
  for (int i = threadIdx.x; i < BN * ldd; i += kThreads) {
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  // the q tiles [qt_begin, qt_end) that can see kv rows [k_lo, k_hi]
  const int nq = (Sq + BM - 1) / BM;
  int qt_begin = 0, qt_end = nq;
  if (causal) {
    qt_begin = min(nq, k_lo / BM);
    if (window > 0) qt_end = min(nq, (k_hi + window - 1) / BM + 1);
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = ((size_t)b * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * BM;
      load_tile(q_s, ldd, q + qoff * D, q_lo, BM, Sq, D);
      load_tile(do_s, ldd, dout + qoff * D, q_lo, BM, Sq, D);
      load_rows(lse_s, lse + qoff, q_lo, BM, Sq);
      load_rows(delta_s, delta + qoff, q_lo, BM, Sq);
      __syncthreads();
      tile_gemm<true, true>(s_s, ldn, BM, BN, D, q_s, ldd, k_s, ldd, scale,
                            nullptr, false);
      tile_gemm<true, true>(dp_s, ldn, BM, BN, D, do_s, ldd, v_s, ldd, 1.f,
                            nullptr, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
        const int r = idx / BN, c = idx - r * BN;
        const int qpos = q_lo + r;
        float p = 0.f, ds = 0.f;
        if (qpos < Sq && visible(qpos, k_lo + c, Sk, causal, window)) {
          p = expf(s_s[r * ldn + c] - lse_s[r]);
          ds = p * (dp_s[r * ldn + c] - delta_s[r]);
        }
        p_s[r * ldn + c] = p;
        ds_s[r * ldn + c] = ds;
      }
      __syncthreads();
      // dv += p^T . dO;  dk += ds^T . q * scale
      tile_gemm<false, false>(dv_s, ldd, BN, D, BM, p_s, ldn, do_s, ldd, 1.f,
                              nullptr, true);
      tile_gemm<false, false>(dk_s, ldd, BN, D, BM, ds_s, ldn, q_s, ldd,
                              scale, nullptr, true);
      __syncthreads();
    }
  }
  __syncthreads();
  store_tile(dk + koff, dk_s, ldd, k_lo, BN, Sk, D, 1.f);
  store_tile(dv + koff, dv_s, ldd, k_lo, BN, Sk, D, 1.f);
}

// ---------------------------------------------------------------------
// bf16: register-resident tiles on the tensor cores.
//
// A CTA of 4 warps owns 64 rows (q rows in K1 and K2, kv rows in K3),
// 16 per warp.  Each warp keeps its scores, probabilities and output
// accumulators in mma.sync m16n8k16 fragments (float32), so the only
// shared-memory traffic is the operand tiles, read with ldmatrix (its
// .trans form where the contracted index is not the contiguous one).
// A probability or ds tile turns into the A operand of the next product
// in registers (the accumulator layout of two neighbouring n8 tiles is
// the A layout of one k16 step).  Exponentials use __expf.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)

constexpr int kRegThreads = 128;
constexpr int kRegRows = 64;  // rows per CTA, and kv (K1, K2) or q (K3) rows per tile

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; register j of lane l receives row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix j (of its transpose with
// .trans).  Row addresses are 16-byte aligned (16-byte padded rows).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// rows [row0, row0 + 64) of a [S, D] slab into a [64][D + 8] tile with
// asynchronous 16-byte copies (cp.async), rows past S zero-filled: every
// copy of the tile is in flight at once.  tile_wait() ends them.
template <int D>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int row0, int S) {
  constexpr int chunks = D / 8;
  for (int idx = threadIdx.x; idx < kRegRows * chunks; idx += kRegThreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    const bool valid = row0 + r < S;
    const bf16* from = src + (size_t)(valid ? row0 + r : 0) * D + c;
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * (D + 8) + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(valid ? 16 : 0) : "memory");
  }
}

// wait for this thread's copies, then for every thread's
__device__ __forceinline__ void tile_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// A fragment of rows [m0, m0+16), k [k0, k0+16) of a row-major tile:
// matrices (m0, k0) (m0+8, k0) (m0, k0+8) (m0+8, k0+8) are a0..a3
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int ld,
                                       int m0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a, s + (m0 + (lane & 7) + (mi & 1) * 8) * ld + k0 + (mi >> 1) * 8);
}

// B fragments of two n8 tiles [n0, n0+16), k [k0, k0+16), where
// B(k, n) = s[n * ld + k] (k contiguous): b[0..1] for n0, b[2..3] for
// n0 + 8 (matrices (n0, k0) (n0, k0+8) (n0+8, k0) (n0+8, k0+8))
__device__ __forceinline__ void frag_b2_kc(uint32_t b[4], const bf16* s, int ld,
                                           int k0, int n0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(b, s + (n0 + (lane & 7) + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8);
}

// the same where B(k, n) = s[k * ld + n] (n contiguous), transposed by
// ldmatrix: matrices (k0, n0) (k0+8, n0) (k0, n0+8) (k0+8, n0+8)
__device__ __forceinline__ void frag_b2_nc(uint32_t b[4], const bf16* s, int ld,
                                           int k0, int n0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8);
}

// the A fragment of k step kk from a 16 x 64 accumulator c[8][4]
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (*c)[4],
                                         int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c[8][4] (16 x 64) = A (16 rows at m0 of a, k = D) x B (64 columns)
template <int D>
__device__ __forceinline__ void scores(float (*c)[4], const bf16* a, const bf16* b,
                                       int m0, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t fa[4];
    frag_a(fa, a, ld, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t fb[4];
      frag_b2_kc(fb, b, ld, k0, j * 8, lane);
      mma_bf16(c[j], fa, fb[0], fb[1]);
      mma_bf16(c[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[D/8][4] (16 x D) += P (c[8][4] as 16 x 64) x B (64 rows x D of b)
template <int D>
__device__ __forceinline__ void accumulate(float (*acc)[4], const float (*c)[4],
                                           const bf16* b, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    acc_to_a(fa, c, kk);
#pragma unroll
    for (int jd = 0; jd < D / 8; jd += 2) {
      uint32_t fb[4];
      frag_b2_nc(fb, b, ld, kk * 16, jd * 8, lane);
      mma_bf16(acc[jd], fa, fb[0], fb[1]);
      mma_bf16(acc[jd + 1], fa, fb[2], fb[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two neighbouring values of an output slab, as float32 or as bf16
__device__ __forceinline__ void store_pair(void* dst, bool out_f32, size_t off,
                                           float x, float y) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(dst) + off) = make_float2(x, y);
  else
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dst) + off) = pack_f32(x, y);
}

template <int D>
constexpr int reg_smem_bytes(Kind kind) {
  return (kind == kFwd ? 3 : 4) * kRegRows * (D + 8) * 2 +
         (kind == kDkv ? 2 * kRegRows * 4 : 0);
}

// K1.  grid (q tiles, H, B).
template <int D>
__global__ void __launch_bounds__(kRegThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int H, int group, int Sq, int Sk,
                      int causal, int window, float scale) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kRegRows * LD;
  bf16* v_s = k_s + kRegRows * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q_lo = qt * kRegRows, q_hi = min(q_lo + kRegRows, Sq) - 1;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const size_t koff = ((size_t)b * (H / group) + h / group) * Sk * D;
  const int qp[2] = {q_lo + m0 + g, q_lo + m0 + g + 8};

  tile_async<D>(q_s, q + qoff * D, q_lo, Sq);
  float o[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
  // running max (shared by the quad) and this thread's share of the sum
  float m[2] = {kNegFill, kNegFill}, l[2] = {0.f, 0.f};
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, kRegRows, causal, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kRegRows;
    __syncthreads();  // the previous tile's readers are done
    tile_async<D>(k_s, k + koff, k_lo, Sk);
    tile_async<D>(v_s, v + koff, k_lo, Sk);
    tile_wait();
    float s[8][4];
    scores<D>(s, q_s, k_s, m0, lane);
    float mx[2] = {kNegFill, kNegFill};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (!visible(qp[e >> 1], kpos, Sk, causal, window)) x = kNegFill;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] *= alpha[e >> 1];
    accumulate<D>(o, s, v_s, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = fmaxf(quad_sum(l[r]), 1e-37f);
    if (qp[r] >= Sq) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store_pair(out, false, (qoff + qp[r]) * D + jd * 8 + 2 * t,
                 o[jd][2 * r] / lt, o[jd][2 * r + 1] / lt);
    if (t == 0) lse[qoff + qp[r]] = m[r] + logf(lt);
  }
}

// K2.  grid (q tiles, H, B).
template <int D>
__global__ void __launch_bounds__(kRegThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, void* __restrict__ dq,
                         int out_f32, int H, int group, int Sq, int Sk,
                         int causal, int window, float scale) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRegRows * LD;
  bf16* k_s = do_s + kRegRows * LD;
  bf16* v_s = k_s + kRegRows * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q_lo = qt * kRegRows, q_hi = min(q_lo + kRegRows, Sq) - 1;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const size_t koff = ((size_t)b * (H / group) + h / group) * Sk * D;
  const int qp[2] = {q_lo + m0 + g, q_lo + m0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = qp[r] < Sq ? lse[qoff + qp[r]] : 0.f;
    row_delta[r] = qp[r] < Sq ? delta[qoff + qp[r]] : 0.f;
  }

  tile_async<D>(q_s, q + qoff * D, q_lo, Sq);
  tile_async<D>(do_s, dout + qoff * D, q_lo, Sq);
  float acc[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, kRegRows, causal, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kRegRows;
    __syncthreads();
    tile_async<D>(k_s, k + koff, k_lo, Sk);
    tile_async<D>(v_s, v + koff, k_lo, Sk);
    tile_wait();
    float s[8][4], dp[8][4];
    scores<D>(s, q_s, k_s, m0, lane);
    scores<D>(dp, do_s, v_s, m0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k_lo + j * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (qp[r] < Sq && visible(qp[r], kpos, Sk, causal, window))
          ds = __expf(s[j][e] * scale - row_lse[r]) * (dp[j][e] - row_delta[r]);
        s[j][e] = ds;
      }
    accumulate<D>(acc, s, k_s, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= Sq) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      store_pair(dq, out_f32, (qoff + qp[r]) * D + jd * 8 + 2 * t,
                 acc[jd][2 * r] * scale, acc[jd][2 * r + 1] * scale);
  }
}

// K3.  grid (kv tiles, Hkv, B).  The warp's 16 kv rows are the rows of
// every product: s^T = k q^T, dp^T = v dO^T, dv += p^T dO, dk += ds^T q.
template <int D>
__global__ void __launch_bounds__(kRegThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, void* __restrict__ dk,
                          void* __restrict__ dv, int out_f32, int H, int group,
                          int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = D + 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kRegRows * LD;
  bf16* q_s = v_s + kRegRows * LD;
  bf16* do_s = q_s + kRegRows * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kRegRows * LD);
  float* delta_s = lse_s + kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k_lo = kt * kRegRows, k_hi = min(k_lo + kRegRows, Sk) - 1;
  const size_t koff = ((size_t)b * (H / group) + hk) * Sk * D;
  const int kp[2] = {k_lo + m0 + g, k_lo + m0 + g + 8};

  tile_async<D>(k_s, k + koff, k_lo, Sk);
  tile_async<D>(v_s, v + koff, k_lo, Sk);
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[jd][e] = dv_acc[jd][e] = 0.f;
  const int nq = (Sq + kRegRows - 1) / kRegRows;
  int qt_begin = 0, qt_end = nq;
  if (causal) {
    qt_begin = min(nq, k_lo / kRegRows);
    if (window > 0) qt_end = min(nq, (k_hi + window - 1) / kRegRows + 1);
  }

  for (int gi = 0; gi < group; ++gi) {
    const size_t qoff = ((size_t)b * H + hk * group + gi) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * kRegRows;
      __syncthreads();
      tile_async<D>(q_s, q + qoff * D, q_lo, Sq);
      tile_async<D>(do_s, dout + qoff * D, q_lo, Sq);
      load_rows(lse_s, lse + qoff, q_lo, kRegRows, Sq);
      load_rows(delta_s, delta + qoff, q_lo, kRegRows, Sq);
      tile_wait();
      float p[8][4];
      scores<D>(p, k_s, q_s, m0, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          p[j][e] = q_lo + c < Sq && visible(q_lo + c, kp[e >> 1], Sk, causal, window)
                        ? __expf(p[j][e] * scale - lse_s[c])
                        : 0.f;
        }
      accumulate<D>(dv_acc, p, do_s, lane);
      float ds[8][4];
      scores<D>(ds, v_s, do_s, m0, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - delta_s[j * 8 + 2 * t + (e & 1)]);
      accumulate<D>(dk_acc, ds, q_s, lane);
    }
  }
  tile_wait();  // no copy may land after the CTA ends, even with no q tile

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp[r] >= Sk) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const size_t off = koff + (size_t)kp[r] * D + jd * 8 + 2 * t;
      store_pair(dk, out_f32, off, dk_acc[jd][2 * r] * scale, dk_acc[jd][2 * r + 1] * scale);
      store_pair(dv, out_f32, off, dv_acc[jd][2 * r], dv_acc[jd][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// Launchers.

struct Args {
  int B, H, Hkv, Sq, Sk, D, causal, window;
  float scale;
};

// above 48 KB, dynamic shared memory must be opted into; the largest
// size granted so far is remembered per kernel
template <typename Kernel>
int grant(Kernel kernel, int smem, int* granted) {
  if (smem <= *granted) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  *granted = smem;
  return 0;
}

bool shape_ok(const Args& a) {
  return a.B > 0 && a.H > 0 && a.Hkv > 0 && a.H % a.Hkv == 0 && a.Sq > 0 &&
         a.Sk > 0 && a.D % 32 == 0 && a.D >= 32 && a.D <= 128 &&
         a.H <= 65535 && a.B <= 65535;
}

// float32 inputs give float32 gradients, whatever out_f32 asks
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
            const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  const int smem = Smem(a.D, kFwd).total;
  if (int err = grant(flash_fwd_f32_kernel, smem, &granted)) return err;
  dim3 grid((a.Sq + kBM - 1) / kBM, a.H, a.B);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), a.H, a.H / a.Hkv, a.Sq, a.Sk, a.D, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

int bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, const Args& a,
               cudaStream_t st) {
  static int granted = 48 * 1024;
  const int smem = Smem(a.D, kDq).total;
  if (int err = grant(flash_bwd_dq_f32_kernel, smem, &granted)) return err;
  dim3 grid((a.Sq + kBM - 1) / kBM, a.H, a.B);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), a.H, a.H / a.Hkv, a.Sq, a.Sk, a.D, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

int bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  const int smem = Smem(a.D, kDkv).total;
  if (int err = grant(flash_bwd_dkv_f32_kernel, smem, &granted)) return err;
  dim3 grid((a.Sk + kBN - 1) / kBN, a.Hkv, a.B);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.D, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
             const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = reg_smem_bytes<D>(kFwd);
  auto kernel = flash_fwd_bf16_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  dim3 grid((a.Sq + kRegRows - 1) / kRegRows, a.H, a.B);
  kernel<<<grid, kRegThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), a.H, a.H / a.Hkv, a.Sq, a.Sk, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int out_f32,
                const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = reg_smem_bytes<D>(kDq);
  auto kernel = flash_bwd_dq_bf16_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  dim3 grid((a.Sq + kRegRows - 1) / kRegRows, a.H, a.B);
  kernel<<<grid, kRegThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
      out_f32, a.H, a.H / a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv,
                 int out_f32, const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = reg_smem_bytes<D>(kDkv);
  auto kernel = flash_bwd_dkv_bf16_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  dim3 grid((a.Sk + kRegRows - 1) / kRegRows, a.Hkv, a.B);
  kernel<<<grid, kRegThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv,
      out_f32, a.H, a.H / a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dO share it).
// window <= 0: no window.  out_f32: the gradients are written as float32
// (partials for a caller that sums them), else in the input dtype.
// Each returns cudaGetLastError() of its launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take; a fault
// during the run shows at the next synchronising call.

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int dtype, int B, int H,
                                int Hkv, int Sq, int Sk, int D, int causal,
                                int window, float scale, void* stream) {
  const Args a{B, H, Hkv, Sq, Sk, D, causal, window, scale};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return fwd_f32(q, k, v, out, lse, a, st);
  switch (D) {
    case 32: return fwd_bf16<32>(q, k, v, out, lse, a, st);
    case 64: return fwd_bf16<64>(q, k, v, out, lse, a, st);
    case 96: return fwd_bf16<96>(q, k, v, out, lse, a, st);
    default: return fwd_bf16<128>(q, k, v, out, lse, a, st);
  }
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, int dtype,
                                   int out_f32, int B, int H, int Hkv, int Sq,
                                   int Sk, int D, int causal, int window,
                                   float scale, void* stream) {
  const Args a{B, H, Hkv, Sq, Sk, D, causal, window, scale};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return bwd_dq_f32(q, k, v, dout, lse, delta, dq, a, st);
  switch (D) {
    case 32: return bwd_dq_bf16<32>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    case 64: return bwd_dq_bf16<64>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    case 96: return bwd_dq_bf16<96>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    default: return bwd_dq_bf16<128>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
  }
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int dtype, int out_f32,
                                    int B, int H, int Hkv, int Sq, int Sk,
                                    int D, int causal, int window, float scale,
                                    void* stream) {
  const Args a{B, H, Hkv, Sq, Sk, D, causal, window, scale};
  if (!shape_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return bwd_dkv_f32(q, k, v, dout, lse, delta, dk, dv, a, st);
  switch (D) {
    case 32: return bwd_dkv_bf16<32>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    case 64: return bwd_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    case 96: return bwd_dkv_bf16<96>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    default: return bwd_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
  }
}
