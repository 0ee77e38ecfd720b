// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three TPU kernels of tf_operator_tpu/ops/flash_attention.py
// and computes the same functions.  Each C entry point launches the bf16
// kernel (the training path, tensor cores) or the float32 one (plain FMA):
//
//   K1 _flash_kernel (flash_attention.py:165)
//        flash_fwd_launch:     flash_fwd_hopper_kernel<D>      wgmma, TMA
//                              flash_fwd_f32_kernel
//   K2 _flash_bwd_dq_kernel (flash_attention.py:297)
//        flash_bwd_dq_launch:  flash_bwd_dq_hopper_kernel<D>   wgmma, TMA
//                              flash_bwd_dq_f32_kernel
//   K3 _flash_bwd_dkv_kernel (flash_attention.py:343)
//        flash_bwd_dkv_launch: flash_bwd_dkv_hopper_kernel<D>  wgmma, TMA
//                              flash_bwd_dkv_f32_kernel
//
// Head dims: the launchers take D = 32, 64, 96 and 128 (shape_ok) and
// send every one of them, by the switch on D, to the kernels above: the
// Hopper kernels stage D = 64 and 128 as 64-column panels with the
// 128-byte swizzle, D = 32 and 96 as 32-column panels with the 64-byte
// swizzle.
//
// Layout: q, dO, out [B, H, Sq, D];
// k, v [B, Hkv, Sk, D] with H = Hkv * group; lse and delta [B, H, Sq]
// float32.  All contiguous; the bf16 tensors that TMA reads start on a
// 16-byte boundary.  Logits are (q . k) * scale; the causal mask is top-
// left aligned (qpos >= kpos, both counted from 0, whatever Sq and Sk
// are); a window keeps qpos - kpos < window; masked logits are
// finfo(float32).min, never -inf.  The forward's softmax is online in
// float32, divides by max(l, 1e-37) and writes
// lse = m + log(max(l, 1e-37)).  The backward recomputes
// p = exp(logit - lse) from the saved lse, takes delta = rowsum(dO * O)
// from the caller, and forms ds = p * (dO . v - delta);
// dq = scale * ds . k, dk = ds^T . (q * scale), dv = p^T . dO.
//
// Design.  The TPU grid's sequential block dimension becomes a loop
// inside one CTA:
//   K1, K2: a CTA per q tile (and head, batch) loops over the K/V tiles
//           the causal mask and the window let in;
//   K3:     a CTA per kv tile (and kv head, batch) loops over the
//           group's query heads x the q tiles that can see the kv tile,
//           and accumulates dK and dV in registers: GQA folds into the
//           loop as the JAX kernel folds it into its grid, with no
//           atomics and no group-sum afterwards.
// Rows past Sq or Sk load as zeros and are masked, so any length works.
//
// Bound.  At the training shape (B 4, H 16, Hkv 8, S 2048, D 128, bf16,
// causal) attention does O(S^2 D) flops on O(S D) bytes: it is bound by
// operations, at the dense bf16 peak of 989 TFLOPS K1 0.0695 ms (two
// products over the visible pairs), K2 0.1043 ms (three) and K3 0.1390
// ms (four).
//
// bf16 (the Hopper section below), against what held the first mma.sync
// versions back:
//   - mma.sync m16n8k16 reaches about two thirds of the tensor cores'
//     rate: every product is a warpgroup's wgmma.mma_async, operands
//     from swizzled shared memory or, for P, dS, P^T and dS^T, registers;
//   - copies did not overlap math (cp.async, then wait and barrier a
//     tile): a producer warp keeps TMA loads in flight into a ring of
//     four stages with full and empty mbarriers while two consumer
//     warpgroups compute; setmaxnreg moves the producer's registers to
//     them;
//   - K1's and K2's CTAs were 64 q rows in increasing order: now 128 q
//     rows (64 a consumer warpgroup) against kv tiles of 64, the
//     heaviest causal q tiles first; K1 issues S of a tile beside O += P
//     V of the tile before (the tensor cores run that product during the
//     softmax); K2 issues S and dP of a tile together, from Q and dO
//     staged once with their rows' lse and delta; only tiles straddling
//     the diagonal, the window's edge or Sk test each element, and the
//     exponentials are exp2 with the scale folded in;
//   - K3 held 254 registers a thread (dK and dV both, two CTAs an SM)
//     and reloaded lse and delta behind a barrier every q tile: now a
//     CTA of 64 kv rows splits a q tile's work by output, warpgroup 0
//     S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK (P^T handed over
//     in shared memory), so a thread holds one D-wide accumulator; the
//     producer stages each q tile's lse and delta beside Q and dO, and
//     kv tile 0 (which sees every q tile under the causal mask) runs
//     first; Q and dO are loaded once and read both ways (K-major and
//     through the transposing descriptor).
// float32 (exactness, not speed): tile products from shared memory on
// plain FMA (no TF32), 8 warps a CTA.
//
// What the bf16 design does not yet do: K2 and K3 do not overlap one kv
// or q tile's products with the next one's (K3: issuing a step's scores
// behind the last step's product made ptxas serialise every wgmma; K2:
// holding a tile's dS fragments beside the next tile's S and dP adds 16
// registers to the 128 of dQ, S and dP under the 168 a consumer thread
// gets; not tried), and K3's P^T hand-over goes through shared memory;
// the two consumer warpgroups are not scheduled in turn (no ping-pong);
// the grid is not persistent; outputs are written from registers, not
// through TMA stores; the tensor maps are encoded on the host at every
// call.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
// Register helpers of the bf16 kernels.

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------
// Hopper: K1, K2 and K3 on wgmma, fed by TMA through an mbarrier ring.
//
// A CTA is three warpgroups (384 threads).  Warpgroups 0 and 1 are
// the consumers, 64 rows each: they issue wgmma.mma_async on the staged
// tiles and keep every accumulator in registers.  Warpgroup 2 is the
// producer: it gives registers back with setmaxnreg (the consumers ask
// for 232), and one warp of it keeps TMA loads in flight into a ring of
// tile stages in shared memory, each stage with a full barrier (the
// bytes landed) and an empty barrier (every consumer thread is done
// reading).  ptxas (CUDA 12.8) did not give the consumers more than
// the 168 registers a thread of a 384-thread CTA has at launch: designs
// that needed more spilled and had their wgmma serialised, so each
// design below keeps a consumer's live registers under that.

// Tiles are [rows][D] bf16, stored as D / P panels of [rows][P] (P = 64
// columns, 128-byte swizzle, where D is a multiple of 64; else P = 32,
// 64-byte swizzle), each panel one TMA box of a 3-d tensor map (D, S,
// B * heads): TMA zero-fills rows past S of the head's own slab, never
// the next head's rows.  A product reads a tile K-major (the contracted
// index is D: descriptors step 32 bytes along a panel row) or MN-major
// (the contracted index is the row: the transposing descriptor steps 16
// rows), so one staged tile serves both ways.
//
// wgmma fragments (thread i of the warpgroup, warp w = i / 32, g = lane
// / 4, t = lane % 4): accumulator d[4j + e] holds row 16w + g + 8(e / 2),
// column 8j + 2t + e % 2; a register A operand of one k16 step is the
// accumulator of two neighbouring n8 columns, rounded to bf16.

constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kHopThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

template <int D>
struct Panels {
  static constexpr int SW = D % 64 == 0 ? 128 : 64;  // swizzle = panel row bytes
  static constexpr int P = SW / 2;                   // bf16 columns a panel
  static constexpr int N = D / P;                    // panels a tile
  static constexpr uint64_t kLayout = SW == 128 ? 1 : 2;  // descriptor swizzle code
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity.  A
// wait that outlasts 2^28 polls (far beyond any tile's copy) is a fault
// of the pipeline: it traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival for the calling warp, once all its lanes are here (their
// shared-memory reads ordered before it): consumer barriers count warps,
// not threads, so a release is 8 arrivals on one word, not 256
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// arrive, and expect this many bytes of TMA loads before the phase ends
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously (zeros where
// !valid); cp_async_arrive makes the landing of this thread's copies one
// arrival on a barrier (counted in its init)
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one box of a 3-d tensor map at (c0, c1, c2) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the rows [row0, row0 + rows) of one head as a staged tile: one box a panel
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int row0, int slab) {
  using G = Panels<D>;
#pragma unroll
  for (int p = 0; p < G::N; ++p) tma_load(dst + p * rows * G::P, map, bar, p * G::P, row0, slab);
}

// a wgmma shared-memory descriptor: start >> 4, leading and stride byte
// offsets >> 4, the swizzle code in bits 62-63
template <int D>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | Panels<D>::kLayout << 62;
}

// K-major: rows [r0, r0 + 64 or the product's N) of a staged [rows][D]
// tile, columns [16 kk, 16 kk + 16): 8-row groups SW * 8 bytes apart.
// The step along D is a constant added to the start address field, so
// the tile's descriptor is built once
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int r0, int kk) {
  using G = Panels<D>;
  const int col = kk * 16;
  return make_desc<D>(tile + r0 * G::P, 16, 8 * G::SW) +
         static_cast<uint64_t>(((col / G::P) * rows * G::SW + (col % G::P) * 2) >> 4);
}

// MN-major (transposed): rows [16 kk, 16 kk + 16) of a staged tile as
// the contracted index, all D columns as N: panels rows * SW bytes apart
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows, int kk) {
  using G = Panels<D>;
  return make_desc<D>(tile, rows * G::SW, 8 * G::SW) +
         static_cast<uint64_t>((kk * 16 * G::SW) >> 4);
}

// 2^x on the special function unit (ex2.approx.ftz: -inf and very
// negative x give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
// that ends the products writing it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the register A operand of k16 step kk from an m64 x n(16 * steps)
// accumulator
template <int N>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[4], const float (&c)[N], int kk) {
  a[0] = pack_f32(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_f32(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_f32(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_f32(c[8 * kk + 6], c[8 * kk + 7]);
}

// the first 1024-byte boundary (the swizzle atoms' alignment) of dynamic
// shared memory, as an offset from its start: pointers made from the
// array itself stay shared-memory pointers to the compiler, so their
// loads and stores are ld.shared / st.shared, not generic ones
__device__ __forceinline__ unsigned char* align_1024(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// d (m64 x n64) = A (smem, K-major) x B (smem, K-major), scaled into d
// when accumulate != 0, else written
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n32) += A (registers) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64) += A (registers) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n96) += A (registers) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128) += A (registers) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// K1 on Hopper.  1-d grid over (q tile, head, batch), the q tiles
// heaviest first (the last q tile sees the most kv tiles under the
// causal mask).  A CTA owns 128 q rows, 64 a consumer warpgroup, and
// walks the kv tiles of 64 rows the mask lets in:
//   S = Q K^T    wgmma m64n64k16, Q and K from shared memory (K-major)
//   online softmax in float32 on the accumulator, in log2 units
//   O += P V     wgmma m64nDk16, P from registers (bf16), V MN-major
// A consumer holds S (32 floats), P (16 registers) and O (D / 2 floats)
// at once; kv tiles of 128 measured slower (S alone 64 floats: spills).
// Only tiles that straddle the diagonal, the window's edge or Sk test
// each element.
constexpr int kFwdRows = 128, kFwdKv = 64, kFwdStages = 4;

template <int D>
struct FwdSmem {
  static constexpr int q = 0;
  static constexpr int k = q + kFwdRows * D * 2;
  static constexpr int v = k + kFwdStages * kFwdKv * D * 2;
  static constexpr int bars = v + kFwdStages * kFwdKv * D * 2;
  static constexpr int total = bars + 8 * (1 + 4 * kFwdStages) + 1024;  // + alignment
};

// sc = A B^T for a consumer warpgroup's 64 rows of a staged 128-row
// tile A and a 64-row kv tile B, both K-major: K1's S = Q K^T, K2's S
// and dP = dO V^T
template <int D>
__device__ __forceinline__ void tile_scores(float (&sc)[kFwdKv / 2], const bf16* a_s,
                                            const bf16* b_s, int wg) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc, desc_k<D>(a_s, kFwdRows, 64 * wg, kk), desc_k<D>(b_s, kFwdKv, 0, kk), kk > 0);
}

// acc += A B: A from registers (64 rows x 64 kv), B a staged kv tile
// read MN-major: K1's O += P V, K2's dQ += dS K
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[D / 2],
                                                const uint32_t (&a)[kFwdKv / 16][4],
                                                const bf16* b_s) {
#pragma unroll
  for (int kk = 0; kk < kFwdKv / 16; ++kk) wgmma_rs(acc, a[kk], desc_mn<D>(b_s, kFwdKv, kk));
}

// The online softmax of one tile's scores, in place, in log2 units:
// the running max m and this thread's share l of the sum; alpha (when
// asked for) is the factor O is rescaled by.  A tile that straddles the
// diagonal, the window's edge or Sk is scaled and masked element by
// element first; an interior tile folds the scale into the exponent
__device__ __forceinline__ void fwd_softmax(float (&sc)[kFwdKv / 2], float (&m)[2],
                                            float (&l)[2], int k_lo, int r_lo, int r_hi,
                                            const int (&qp)[2], int t, int Sk, int causal,
                                            int window, float scale_log2,
                                            float* alpha = nullptr) {
  const bool straddles = k_lo + kFwdKv > Sk ||
                         (causal && (k_lo + kFwdKv - 1 > r_lo ||
                                     (window > 0 && r_hi - k_lo >= window)));
  float k = scale_log2;
  if (straddles) {
#pragma unroll
    for (int c = 0; c < kFwdKv / 2; ++c) {
      const int kpos = k_lo + (c / 4) * 8 + 2 * t + (c & 1);
      sc[c] = visible(qp[(c >> 1) & 1], kpos, Sk, causal, window) ? sc[c] * scale_log2
                                                                   : kNegFill;
    }
    k = 1.f;
  }
  float mx[2] = {kNegFill, kNegFill};
#pragma unroll
  for (int c = 0; c < kFwdKv / 2; ++c) mx[(c >> 1) & 1] = fmaxf(mx[(c >> 1) & 1], sc[c]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // k > 0, so the max of the scaled scores is the scaled max
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * k);
    const float a = fast_exp2(m[r] - m_new);
    if (alpha) alpha[r] = a;
    m[r] = m_new;
    l[r] *= a;
  }
#pragma unroll
  for (int c = 0; c < kFwdKv / 2; ++c) {
    const float p = fast_exp2(fmaf(sc[c], k, -m[(c >> 1) & 1]));
    sc[c] = p;
    l[(c >> 1) & 1] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                        float* __restrict__ lse, int B, int H, int group, int Sq, int Sk,
                        int causal, int window, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kFwdStages;
  uint64_t* empty_k = full_v + kFwdStages;
  uint64_t* empty_v = empty_k + kFwdStages;
  constexpr int kTile = kFwdKv * D;  // elements of a staged K or V tile

  const int heads = H * B;
  const int nq = (Sq + kFwdRows - 1) / kFwdRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;  // b * H + h
  const int bhk = (bh / H) * (H / group) + (bh % H) / group;
  const int q_lo = qt * kFwdRows, q_hi = min(q_lo + kFwdRows, Sq) - 1;
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, kFwdKv, causal, window, &kt_begin, &kt_end);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumerWarps);
      mbar_init(&empty_v[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // the same across each warp: every wgmma below runs on a path all 128
  // threads of a warpgroup take
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // producer: Q once, then K and V of every tile into the ring
    setmaxnreg_dec();
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_tx(full_q, kFwdRows * D * 2);
      tma_tile<D>(q_s, &tq, full_q, kFwdRows, q_lo, bh);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kFwdStages, free_parity = ((i / kFwdStages) & 1) ^ 1;
        mbar_wait(&empty_k[s], free_parity);
        mbar_arrive_tx(&full_k[s], kTile * 2);
        tma_tile<D>(k_s + s * kTile, &tk, &full_k[s], kFwdKv, kt * kFwdKv, bhk);
        mbar_wait(&empty_v[s], free_parity);
        mbar_arrive_tx(&full_v[s], kTile * 2);
        tma_tile<D>(v_s + s * kTile, &tv, &full_v[s], kFwdKv, kt * kFwdKv, bhk);
      }
    }
  } else {
    setmaxnreg_inc();
    const int wg = role;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = q_lo + 64 * wg, r_hi = r_lo + 63;  // this warpgroup's q rows
    const int qp[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
    float o[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
    // running max (log2 units, shared by the quad) and this thread's share of the sum
    float m[2] = {kNegFill, kNegFill}, l[2] = {0.f, 0.f};
    float sc[kFwdKv / 2];
    uint32_t pa[kFwdKv / 16][4];
    const int n = kt_end - kt_begin;
    mbar_wait(full_q, 0);
    if (n > 0) {
      // kv tile 0: S alone
      mbar_wait(&full_k[0], 0);
      wg_fence();
      tile_scores<D>(sc, q_s, k_s, wg);
      wg_commit();
      wg_wait_all();
      hold(sc);
      warp_arrive(&empty_k[0]);
      fwd_softmax(sc, m, l, kt_begin * kFwdKv, r_lo, r_hi, qp, t, Sk, causal, window,
                  scale_log2);
#pragma unroll
      for (int kk = 0; kk < kFwdKv / 16; ++kk) acc_to_frag(pa[kk], sc, kk);
      // kv tile i: S of tile i is issued beside O += P V of tile i - 1, so
      // the tensor cores run that product while tile i's softmax is computed
      for (int i = 1; i < n; ++i) {
        const int s = i % kFwdStages, sp = (i - 1) % kFwdStages;
        mbar_wait(&full_k[s], (i / kFwdStages) & 1);
        mbar_wait(&full_v[sp], ((i - 1) / kFwdStages) & 1);
        wg_fence();
        tile_scores<D>(sc, q_s, k_s + s * kTile, wg);
        wg_commit();
        tile_accumulate<D>(o, pa, v_s + sp * kTile);
        wg_commit();
        wg_wait_one();  // S of tile i; O += P V of tile i - 1 may still run
        hold(sc);
        warp_arrive(&empty_k[s]);
        float alpha[2];
        fwd_softmax(sc, m, l, (kt_begin + i) * kFwdKv, r_lo, r_hi, qp, t, Sk, causal, window,
                    scale_log2, alpha);
        wg_wait_all();  // O += P V of tile i - 1: O and P are free again
        hold(o);
        warp_arrive(&empty_v[sp]);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) o[c] *= alpha[(c >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < kFwdKv / 16; ++kk) acc_to_frag(pa[kk], sc, kk);
      }
      const int sl = (n - 1) % kFwdStages;
      mbar_wait(&full_v[sl], ((n - 1) / kFwdStages) & 1);
      wg_fence();
      tile_accumulate<D>(o, pa, v_s + sl * kTile);
      wg_commit();
      wg_wait_all();
      hold(o);
      warp_arrive(&empty_v[sl]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = fmaxf(quad_sum(l[r]), 1e-37f);
      if (qp[r] >= Sq) continue;
      const size_t row = static_cast<size_t>(bh) * Sq + qp[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(out, false, row * D + j * 8 + 2 * t, o[4 * j + 2 * r] / lt,
                   o[4 * j + 2 * r + 1] / lt);
      // a row the mask hides entirely keeps the fill, as the plain version
      if (t == 0) lse[row] = (m[r] == kNegFill ? kNegFill : m[r] * kLn2) + logf(lt);
    }
  }
}

// K2 on Hopper.  The grid of K1: 1-d over (q tile, head, batch), the q
// tiles heaviest first, a batch's query heads next to each other (a
// group's heads read the same K/V tiles, which so stay in L2).  A CTA
// owns 128 q rows, 64 a consumer warpgroup; the producer stages Q and dO
// once (TMA) with their rows' lse and delta (its lanes' asynchronous
// copies, counted on the same barrier), then K and V of every kv tile of
// 64 rows the mask lets in through the ring.  lse and delta come from
// outside, so there is no online softmax; per kv tile a consumer runs
//   S = Q K^T, dP = dO V^T   two wgmma m64n64k16 from shared memory
//                            (K-major), issued together
//   dS = exp2(S scale log2e - lse log2e) (dP - delta)   in registers
//   dQ += dS K               wgmma m64nDk16, dS from registers (bf16),
//                            K read MN-major (the transposing descriptor)
// and holds dQ (D / 2 floats), S and dP (32 each) at once.  Only tiles
// that straddle the diagonal, the window's edge or Sk test each element.
constexpr int kDqStages = 4;

template <int D>
struct DqSmem {
  static constexpr int q = 0;
  static constexpr int dout = q + kFwdRows * D * 2;
  static constexpr int k = dout + kFwdRows * D * 2;
  static constexpr int v = k + kDqStages * kFwdKv * D * 2;
  static constexpr int rows = v + kDqStages * kFwdKv * D * 2;  // lse, delta of the q rows
  static constexpr int bars = rows + 2 * kFwdRows * 4;
  static constexpr int total = bars + 8 * (1 + 2 * kDqStages) + 1024;  // + alignment
};

// dS of one kv tile, in place of S, as the register A operand of dQ +=
// dS K.  A tile that straddles the diagonal, the window's edge or Sk
// zeroes what the mask hides, after the product (the exponent of a hidden
// element may overflow; it is replaced, never multiplied)
__device__ __forceinline__ void dq_operand(uint32_t (&frag)[kFwdKv / 16][4],
                                           float (&sc)[kFwdKv / 2], const float (&dp)[kFwdKv / 2],
                                           const float (&lse2)[2], const float (&dlt)[2],
                                           int k_lo, int r_lo, int r_hi, const int (&qp)[2],
                                           int t, int Sk, int causal, int window,
                                           float scale_log2) {
  const bool straddles = k_lo + kFwdKv > Sk ||
                         (causal && (k_lo + kFwdKv - 1 > r_lo ||
                                     (window > 0 && r_hi - k_lo >= window)));
#pragma unroll
  for (int c = 0; c < kFwdKv / 2; ++c) {
    const int r = (c >> 1) & 1;
    sc[c] = fast_exp2(fmaf(sc[c], scale_log2, -lse2[r])) * (dp[c] - dlt[r]);
  }
  if (straddles) {
#pragma unroll
    for (int c = 0; c < kFwdKv / 2; ++c) {
      const int kpos = k_lo + (c / 4) * 8 + 2 * t + (c & 1);
      if (!visible(qp[(c >> 1) & 1], kpos, Sk, causal, window)) sc[c] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kFwdKv / 16; ++kk) acc_to_frag(frag[kk], sc, kk);
}

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           void* __restrict__ dq, int out_f32, int B, int H, int group,
                           int Sq, int Sk, int causal, int window, float scale,
                           float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  float* rows_s = reinterpret_cast<float*>(smem + L::rows);  // lse [128], then delta [128]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kDqStages;
  constexpr int kTile = kFwdKv * D;  // elements of a staged K or V tile

  const int heads = H * B;
  const int nq = (Sq + kFwdRows - 1) / kFwdRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;  // b * H + h
  const int bhk = (bh / H) * (H / group) + (bh % H) / group;
  const int q_lo = qt * kFwdRows, q_hi = min(q_lo + kFwdRows, Sq) - 1;
  int kt_begin, kt_end;
  kv_range(q_lo, q_hi, Sk, kFwdKv, causal, window, &kt_begin, &kt_end);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1 + 32);  // the TMA bytes' arrival and the producer lanes'
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // the same across each warp: every wgmma below runs on a path all 128
  // threads of a warpgroup take
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // producer warp: Q, dO, lse and delta once, then K and V of every
    // tile into the ring
    setmaxnreg_dec();
    if (threadIdx.x < kConsumerThreads + 32) {
      const int lane = threadIdx.x - kConsumerThreads;
      // the rows' lse and delta by asynchronous 4-byte copies (rows past
      // Sq read as zeros), each lane's landing one arrival on full_q
#pragma unroll
      for (int j = 0; j < kFwdRows / 32; ++j) {
        const int r = q_lo + lane + 32 * j;
        const size_t at = static_cast<size_t>(bh) * Sq + (r < Sq ? r : 0);
        cp_async_4(rows_s + lane + 32 * j, lse + at, r < Sq);
        cp_async_4(rows_s + kFwdRows + lane + 32 * j, delta + at, r < Sq);
      }
      cp_async_arrive(full_q);
      if (lane == 0) {
        mbar_arrive_tx(full_q, 2 * kFwdRows * D * 2);
        tma_tile<D>(q_s, &tq, full_q, kFwdRows, q_lo, bh);
        tma_tile<D>(do_s, &tdo, full_q, kFwdRows, q_lo, bh);
        for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
          const int s = i % kDqStages;
          mbar_wait(&empty[s], ((i / kDqStages) & 1) ^ 1);
          mbar_arrive_tx(&full[s], 2 * kTile * 2);
          tma_tile<D>(k_s + s * kTile, &tk, &full[s], kFwdKv, kt * kFwdKv, bhk);
          tma_tile<D>(v_s + s * kTile, &tv, &full[s], kFwdKv, kt * kFwdKv, bhk);
        }
      }
    }
  } else {
    setmaxnreg_inc();
    const int wg = role;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = q_lo + 64 * wg, r_hi = r_lo + 63;  // this warpgroup's q rows
    const int qp[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
    mbar_wait(full_q, 0);
    // this thread's two rows' lse (log2 units) and delta
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + 16 * warp + g + 8 * r;
      lse2[r] = rows_s[row] * kLog2e;
      dlt[r] = rows_s[kFwdRows + row];
    }
    const int n = kt_end - kt_begin;
    for (int i = 0; i < n; ++i) {
      const int s = i % kDqStages;
      float sc[kFwdKv / 2], dp[kFwdKv / 2];
      uint32_t frag[kFwdKv / 16][4];
      mbar_wait(&full[s], (i / kDqStages) & 1);
      wg_fence();
      tile_scores<D>(sc, q_s, k_s + s * kTile, wg);
      tile_scores<D>(dp, do_s, v_s + s * kTile, wg);
      wg_commit();
      wg_wait_all();
      hold(sc);
      hold(dp);
      dq_operand(frag, sc, dp, lse2, dlt, (kt_begin + i) * kFwdKv, r_lo, r_hi, qp, t, Sk,
                 causal, window, scale_log2);
      wg_fence();
      tile_accumulate<D>(acc, frag, k_s + s * kTile);
      wg_commit();
      wg_wait_all();
      hold(acc);
      warp_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      const size_t row = static_cast<size_t>(bh) * Sq + qp[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(dq, out_f32, row * D + j * 8 + 2 * t, acc[4 * j + 2 * r] * scale,
                   acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// K3 on Hopper.  1-d grid over (kv tile, kv head, batch), kv tile 0
// first (under the causal mask it sees every q tile).  A CTA owns 64 kv
// rows and holds their K and V tiles in shared memory; it walks the
// group's query heads x the q tiles of 64 rows that can see them, and
// the producer stages each q tile's Q, dO (TMA) and lse, delta (its
// lanes' asynchronous copies) in the ring.  The two consumer warpgroups split the
// work of a q tile by output, each holding one accumulator:
//   warpgroup 0: S^T = K Q^T (wgmma m64n64k16, smem), P^T = exp(S^T
//                scale - lse), masked, handed to warpgroup 1 through
//                shared memory in float32; dV += P^T dO (wgmma
//                m64nDk16, P^T from registers, dO MN-major);
//   warpgroup 1: dP^T = V dO^T (m64n64k16), dS^T = P^T (dP^T - delta);
//                dK += dS^T Q (m64nDk16, dS^T from registers, Q
//                MN-major).
// So a consumer thread holds one D-wide accumulator, not two (ptxas
// gives each about 168 registers), and Q and dO are loaded once and
// read both ways.  dK and dV stay in registers over the whole walk: GQA
// folds into the loop, with no atomics and no group sum afterwards.
constexpr int kDkvRows = 64, kDkvQ = 64, kDkvStages = 4;

template <int D>
struct DkvSmem {
  static constexpr int k = 0;
  static constexpr int v = k + kDkvRows * D * 2;
  static constexpr int q = v + kDkvRows * D * 2;
  static constexpr int dout = q + kDkvStages * kDkvQ * D * 2;
  static constexpr int p = dout + kDkvStages * kDkvQ * D * 2;  // P^T, float32, two buffers
  static constexpr int rows = p + 2 * kDkvRows * kDkvQ * 4;  // lse, delta
  static constexpr int bars = rows + kDkvStages * 2 * kDkvQ * 4;
  static constexpr int total = bars + 8 * (1 + 2 * kDkvStages + 4) + 1024;  // + alignment
};

// S^T (K, Q) or dP^T (V, dO) of a q tile: wgmma m64n64k16, both K-major
template <int D>
__device__ __forceinline__ void dkv_scores(float (&acc)[32], const bf16* kv_s, const bf16* q_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(acc, desc_k<D>(kv_s, kDkvRows, 0, kk), desc_k<D>(q_s, kDkvQ, 0, kk), kk > 0);
}

// acc += A (registers, 64 kv rows x 64 q) x B (a staged q tile,
// MN-major): issued, not waited for
template <int D>
__device__ __forceinline__ void dkv_accumulate(float (&acc)[D / 2],
                                               const uint32_t (&a)[kDkvQ / 16][4],
                                               const bf16* b_s) {
#pragma unroll
  for (int kk = 0; kk < kDkvQ / 16; ++kk) wgmma_rs(acc, a[kk], desc_mn<D>(b_s, kDkvQ, kk));
}

// A step's register operand from its scores: warpgroup 0 turns S^T
// into P^T = exp(S^T scale - lse), masked, and hands it to warpgroup 1
// through shared memory in float32 (thread tid of both warpgroups holds
// the same elements, so a buffer is [element][thread]); warpgroup 1
// turns dP^T into dS^T = P^T (dP^T - delta).  Both round to bf16.
__device__ __forceinline__ void dkv_operand(uint32_t (&frag)[kDkvQ / 16][4], float (&sc)[32],
                                            int role, int i, int tid, int t, int q_lo,
                                            int k_lo, int k_hi, const int (&kp)[2],
                                            const float* rs, float* p_s, uint64_t* p_full,
                                            uint64_t* p_empty, int Sq, int Sk, int causal,
                                            int window, float scale_log2) {
  const int pb = i & 1, p_parity = (i >> 1) & 1;
  float* pt = p_s + pb * kDkvRows * kDkvQ;
  if (role == 0) {
    const int q_hi = q_lo + kDkvQ - 1;
    const bool straddles = q_hi >= Sq ||
                           (causal && (k_hi > q_lo || (window > 0 && q_hi - k_lo >= window)));
#pragma unroll
    for (int c = 0; c < 32; ++c)
      sc[c] = fast_exp2(fmaf(sc[c], scale_log2, -kLog2e * rs[(c / 4) * 8 + 2 * t + (c & 1)]));
    if (straddles) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int q = q_lo + (c / 4) * 8 + 2 * t + (c & 1);
        if (!(q < Sq && visible(q, kp[(c >> 1) & 1], Sk, causal, window))) sc[c] = 0.f;
      }
    }
    if (i >= 2) mbar_wait(&p_empty[pb], p_parity ^ 1);
#pragma unroll
    for (int c = 0; c < 32; ++c) pt[c * 128 + tid] = sc[c];
    warp_arrive(&p_full[pb]);
  } else {
    mbar_wait(&p_full[pb], p_parity);
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = (c / 4) * 8 + 2 * t + (c & 1);
      sc[c] = pt[c * 128 + tid] * (sc[c] - rs[kDkvQ + col]);
    }
    warp_arrive(&p_empty[pb]);
  }
#pragma unroll
  for (int kk = 0; kk < kDkvQ / 16; ++kk) acc_to_frag(frag[kk], sc, kk);
}

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            void* __restrict__ dk, void* __restrict__ dv, int out_f32, int B,
                            int H, int group, int Sq, int Sk, int causal, int window,
                            float scale, float scale_log2) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  float* p_s = reinterpret_cast<float*>(smem + L::p);
  float* rows_s = reinterpret_cast<float*>(smem + L::rows);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kDkvStages;
  uint64_t* p_full = empty + kDkvStages;  // P^T written (warpgroup 0), two buffers
  uint64_t* p_empty = p_full + 2;      // P^T read (warpgroup 1)
  constexpr int kTile = kDkvQ * D;     // elements of a staged Q or dO tile

  const int Hkv = H / group;
  const int slabs = Hkv * B;
  const int kt = static_cast<int>(blockIdx.x) / slabs;
  const int bhk = static_cast<int>(blockIdx.x) % slabs;  // b * Hkv + hk
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int k_lo = kt * kDkvRows, k_hi = min(k_lo + kDkvRows, Sk) - 1;
  // the q tiles [qt_begin, qt_end) that can see kv rows [k_lo, k_hi]
  const int nq = (Sq + kDkvQ - 1) / kDkvQ;
  int qt_begin = 0, qt_end = nq;
  if (causal) {
    qt_begin = min(nq, k_lo / kDkvQ);
    if (window > 0) qt_end = min(nq, (k_hi + window - 1) / kDkvQ + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes' arrival and the producer lanes'
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&p_full[s], kConsumerWarps / 2);
      mbar_init(&p_empty[s], kConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // the same across each warp: every wgmma below runs on a path all 128
  // threads of a warpgroup take
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // producer warp: K and V once, then Q, dO, lse and delta of every
    // (query head, q tile) into the ring
    setmaxnreg_dec();
    if (threadIdx.x < kConsumerThreads + 32) {
      const int lane = threadIdx.x - kConsumerThreads;
      if (lane == 0) {
        mbar_arrive_tx(full_kv, 2 * kDkvRows * D * 2);
        tma_tile<D>(k_s, &tk, full_kv, kDkvRows, k_lo, bhk);
        tma_tile<D>(v_s, &tv, full_kv, kDkvRows, k_lo, bhk);
      }
      int i = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int bh = b * H + hk * group + gi;
        for (int qt = qt_begin; qt < qt_end; ++qt, ++i) {
          const int s = i % kDkvStages, q_lo = qt * kDkvQ;
          mbar_wait(&empty[s], ((i / kDkvStages) & 1) ^ 1);
          // the rows' lse and delta by asynchronous 4-byte copies (rows
          // past Sq read as zeros), each lane's landing counted as one
          // arrival on the stage's full barrier: the producer never
          // waits for their latency
          float* rs = rows_s + s * 2 * kDkvQ;
#pragma unroll
          for (int j = 0; j < kDkvQ / 32; ++j) {
            const int r = q_lo + lane + 32 * j;
            const size_t at = static_cast<size_t>(bh) * Sq + (r < Sq ? r : 0);
            cp_async_4(rs + lane + 32 * j, lse + at, r < Sq);
            cp_async_4(rs + kDkvQ + lane + 32 * j, delta + at, r < Sq);
          }
          cp_async_arrive(&full[s]);
          if (lane == 0) {
            mbar_arrive_tx(&full[s], 2 * kTile * 2);
            tma_tile<D>(q_s + s * kTile, &tq, &full[s], kDkvQ, q_lo, bh);
            tma_tile<D>(do_s + s * kTile, &tdo, &full[s], kDkvQ, q_lo, bh);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane >> 2, t = lane & 3;
    const int kp[2] = {k_lo + 16 * warp + g, k_lo + 16 * warp + g + 8};
    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
    mbar_wait(full_kv, 0);

    // the walk, flattened: step i is q tile qt_begin + i % nqt of query
    // head i / nqt.  Each step waits for its scores, then for its
    // product: issuing the next step's scores behind this step's product
    // makes ptxas serialize every wgmma (a wait it inserts on the
    // warpgroups' divergent hand-off path), which measured slower
    const int nqt = qt_end - qt_begin, n = group * nqt;
    const bf16* a_s = role == 0 ? k_s : v_s;   // S^T = K Q^T or dP^T = V dO^T
    const bf16* sq_s = role == 0 ? q_s : do_s;
    const bf16* acc_s = role == 0 ? do_s : q_s;  // dV += P^T dO or dK += dS^T Q
    for (int i = 0; i < n; ++i) {
      const int s = i % kDkvStages;
      float sc[32];
      uint32_t frag[kDkvQ / 16][4];
      mbar_wait(&full[s], (i / kDkvStages) & 1);
      wg_fence();
      dkv_scores<D>(sc, a_s, sq_s + s * kTile);
      wg_commit();
      wg_wait_all();
      hold(sc);
      dkv_operand(frag, sc, role, i, tid, t, (qt_begin + i % nqt) * kDkvQ, k_lo, k_hi, kp,
                  rows_s + s * 2 * kDkvQ, p_s, p_full, p_empty, Sq, Sk, causal, window,
                  scale_log2);
      wg_fence();
      dkv_accumulate<D>(acc, frag, acc_s + s * kTile);
      wg_commit();
      wg_wait_all();
      hold(acc);
      warp_arrive(&empty[s]);
    }

    // warpgroup 0 writes dV, warpgroup 1 dK (times the scale)
    void* dst = role == 0 ? dv : dk;
    const float mul = role == 0 ? 1.f : scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kp[r] >= Sk) continue;
      const size_t row = static_cast<size_t>(bhk) * Sk + kp[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(dst, out_f32, row * D + j * 8 + 2 * t, acc[4 * j + 2 * r] * mul,
                   acc[4 * j + 2 * r + 1] * mul);
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

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library links no libcuda of its own
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a contiguous bf16 [slabs, S, D] tensor, boxes of
// [rows, P] (one panel of a tile); rows past S read as zeros
template <int D>
int tile_map(CUtensorMap* map, const void* base, int S, int slabs, int rows) {
  using G = Panels<D>;
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::P, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int fwd_hopper(const void* q, const void* k, const void* v, void* out, void* lse,
               const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = FwdSmem<D>::total;
  auto kernel = flash_fwd_hopper_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  CUtensorMap tq, tk, tv;
  if (int err = tile_map<D>(&tq, q, a.Sq, a.B * a.H, kFwdRows)) return err;
  if (int err = tile_map<D>(&tk, k, a.Sk, a.B * a.Hkv, kFwdKv)) return err;
  if (int err = tile_map<D>(&tv, v, a.Sk, a.B * a.Hkv, kFwdKv)) return err;
  const int nq = (a.Sq + kFwdRows - 1) / kFwdRows;
  kernel<<<nq * a.H * a.B, kHopThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), a.B, a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.causal, a.window, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq_hopper(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int out_f32, const Args& a,
                  cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = DqSmem<D>::total;
  auto kernel = flash_bwd_dq_hopper_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = tile_map<D>(&tq, q, a.Sq, a.B * a.H, kFwdRows)) return err;
  if (int err = tile_map<D>(&tdo, dout, a.Sq, a.B * a.H, kFwdRows)) return err;
  if (int err = tile_map<D>(&tk, k, a.Sk, a.B * a.Hkv, kFwdKv)) return err;
  if (int err = tile_map<D>(&tv, v, a.Sk, a.B * a.Hkv, kFwdKv)) return err;
  const int nq = (a.Sq + kFwdRows - 1) / kFwdRows;
  kernel<<<nq * a.H * a.B, kHopThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
      out_f32, a.B, a.H, a.H / a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int out_f32,
                   const Args& a, cudaStream_t st) {
  static int granted = 48 * 1024;
  constexpr int smem = DkvSmem<D>::total;
  auto kernel = flash_bwd_dkv_hopper_kernel<D>;
  if (int err = grant(kernel, smem, &granted)) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = tile_map<D>(&tq, q, a.Sq, a.B * a.H, kDkvQ)) return err;
  if (int err = tile_map<D>(&tdo, dout, a.Sq, a.B * a.H, kDkvQ)) return err;
  if (int err = tile_map<D>(&tk, k, a.Sk, a.B * a.Hkv, kDkvRows)) return err;
  if (int err = tile_map<D>(&tv, v, a.Sk, a.B * a.Hkv, kDkvRows)) return err;
  const int nk = (a.Sk + kDkvRows - 1) / kDkvRows;
  kernel<<<nk * a.Hkv * a.B, kHopThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv,
      out_f32, a.B, a.H, a.H / a.Hkv, a.Sq, a.Sk, a.causal, a.window, a.scale,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int hopper_smem(int which) {
  switch (which) {
    case 0: return FwdSmem<D>::total;
    case 1: return DqSmem<D>::total;
    case 2: return DkvSmem<D>::total;
    default: return 0;
  }
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
    case 32: return fwd_hopper<32>(q, k, v, out, lse, a, st);
    case 64: return fwd_hopper<64>(q, k, v, out, lse, a, st);
    case 96: return fwd_hopper<96>(q, k, v, out, lse, a, st);
    default: return fwd_hopper<128>(q, k, v, out, lse, a, st);
  }
}

// the dynamic shared memory (bytes) of K1's (which = 0), K2's (1) or
// K3's (2) Hopper kernel at head dim D; 0 for a head dim not taken
extern "C" int flash_hopper_smem_bytes(int which, int D) {
  switch (D) {
    case 32: return hopper_smem<32>(which);
    case 64: return hopper_smem<64>(which);
    case 96: return hopper_smem<96>(which);
    case 128: return hopper_smem<128>(which);
    default: return 0;
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
    case 32: return bwd_dq_hopper<32>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    case 64: return bwd_dq_hopper<64>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    case 96: return bwd_dq_hopper<96>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
    default: return bwd_dq_hopper<128>(q, k, v, dout, lse, delta, dq, out_f32, a, st);
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
    case 32: return bwd_dkv_hopper<32>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    case 64: return bwd_dkv_hopper<64>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    case 96: return bwd_dkv_hopper<96>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
    default: return bwd_dkv_hopper<128>(q, k, v, dout, lse, delta, dk, dv, out_f32, a, st);
  }
}
