// Forward flash attention, batched over (batch, query head), GQA, causal,
// sliding window, tanh softcap: o = softmax(mask(cap(q k^T / sqrt(hd)))) v.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (through
// flash_attention_single and the batched GQA wrapper flash_attention), the
// Pallas kernel whose online-softmax recurrence this kernel keeps:
//
//     m' = max(m, rowmax(S_blk));  c = exp(m - m')
//     l  = l c + rowsum(exp(S_blk - m'));  acc = acc c + exp(S_blk - m') V_blk
//     o  = acc / max(l, 1e-30)
//
// Inputs are in the JAX layout: q (B, S, H, hd), k and v (B, T, KV, hd),
// contiguous, bfloat16 or float32 (one type), output (B, S, H, hd) in q's
// type.  Query head h reads KV head h / (H / KV).  Scores are float32, scaled
// by 1/sqrt(hd), then softcap * tanh(s / softcap), then masked: col <= row
// (top-left aligned, as the Pallas kernel) and, with a window w, col > row - w
// (the model's local layers; the Pallas kernel has no window).  Any S and T
// work: a ragged last block is masked.  Masked entries weigh exactly 0, so a
// row with no unmasked key yet keeps l = 0 and acc = 0 (the Pallas kernel
// never meets such a row under a plain causal mask; with a window or a
// ragged edge it would add exp(0) = 1 per masked entry).
//
// What bounds it on the H100: operations.  It does 4 hd FLOP per unmasked
// (query, key) pair and must move q, k, v and o once: at gemma2-2b's prefill
// (B = 4, S = T = 2048, 8 heads on 4, hd = 256, bf16) 6.9e10 FLOP, 0.069 ms
// at 989 TFLOP/s on the tensor cores, against 50 MB, 0.015 ms at 3.35 TB/s.
// In float32 the CUDA cores' 67 TFLOP/s bound it the same way.
//
// Design (a first kernel; wgmma, TMA and warp specialisation are a later
// PR's work).  Both paths take one block per (64 query rows, query head,
// batch), stage the Q block once and each 64-key block of K and V in shared
// memory, keep the row statistics m and l in registers, skip the causal
// blocks above the diagonal and the blocks wholly left of the window, and
// run the longest (last) query blocks first.
//
// bf16 (the served path): tensor cores through mma.sync m16n8k16 (bf16 in,
// float32 accumulate).  4 warps, each owning 16 query rows.  Q, K and V are
// copied to shared memory as bf16 with cp.async (ragged rows zero-filled);
// ldmatrix feeds the fragments (.trans for V, which is the product's
// k-major operand).  S = Q K^T stays in the warp's accumulator registers;
// the scale, cap, mask and online softmax run there, and P, rounded to
// bf16, is the A operand of P V straight from those registers (the C and A
// fragment layouts match), so neither S nor P touches shared memory.  The
// output accumulator is 16 x hd per warp, hd / 2 floats a thread (128 at
// hd = 256).  Row strides of hd + 8 elements put the 8 rows of an ldmatrix
// phase on distinct banks.  At hd = 256 a block holds 99 KB: two blocks
// (8 warps) per SM.
//
// float32 (the smoke configurations and the tests): float32 FMA on the CUDA
// cores, 256 threads, each owning a 4 x 4 tile of the 64 x 64 score block
// (rows 4 ty + i, columns tx + 16 j) and the same 4 rows of the output
// (columns tx + 16 c); the statistics close with shuffles across a
// half-warp, and P goes through shared memory (transposed, one float4 per
// key) into P V.  Row strides of hd + 4 floats keep the 16-byte reads of 8
// consecutive rows off a shared bank.  At hd = 256 it holds 211 KB: one
// block per SM.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows of one block
constexpr int BK = 64;  // keys of one staged K/V block
constexpr float NEG_INF = -1073741824.0f;  // -2^30, the Pallas kernel's NEG_INF
constexpr size_t MAX_SMEM = 232448;

// -inf: a masked score, whose exp is exactly 0
__device__ __forceinline__ float masked_score() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float cap_scores(float x, float scale, float softcap) {
  x *= scale;
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

__device__ __forceinline__ bool unmasked(int r, int c, int T_len, int causal, int window) {
  return c < T_len && (!causal || c <= r) && (window <= 0 || c > r - window);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int HD>
struct MmaLayout {
  static constexpr int STRIDE = HD + 8;  // bf16 elements per shared row
  static constexpr int q_off = 0;
  static constexpr int k_off = BQ * STRIDE;
  static constexpr int v_off = k_off + BK * STRIDE;
  static constexpr size_t bytes = static_cast<size_t>(v_off + BK * STRIDE) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0 + ROWS - 1 of a (rows, HD) bf16 view into shared memory
// (row stride MmaLayout<HD>::STRIDE); rows at or past n_rows are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ base, long long row_stride,
                                           int r0, int n_rows, __nv_bfloat16* dst) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += MMA_THREADS) {
    const int r = c / CPR, e = (c % CPR) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * MmaLayout<HD>::STRIDE + e,
               ok ? base + static_cast<long long>(r0 + r) * row_stride + e : base, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int T_len, int H,
    int KV, float scale, float softcap, int causal, int window) {
  using L = MmaLayout<HD>;
  constexpr int ST = L::STRIDE;
  constexpr int NT = HD / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* qs = sm + L::q_off;
  __nv_bfloat16* ks = sm + L::k_off;
  __nv_bfloat16* vs = sm + L::v_off;

  const int nq = (S + BQ - 1) / BQ;
  const int row0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const __nv_bfloat16* qh = q + (static_cast<long long>(b) * S * H + h) * HD;
  const __nv_bfloat16* kh = k + (static_cast<long long>(b) * T_len * KV + kvh) * HD;
  const __nv_bfloat16* vh = v + (static_cast<long long>(b) * T_len * KV + kvh) * HD;
  __nv_bfloat16* oh = o + (static_cast<long long>(b) * S * H + h) * HD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wr = warp * 16;               // the warp's first row in the block
  // ldmatrix row addresses: lanes 8 mi .. 8 mi + 7 give the rows of matrix mi
  const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_col = (lane >> 4) * 8;

  stage_bf16<HD, BQ>(qh, q_stride, row0, S, qs);

  int col_lo = 0, col_hi = T_len - 1;
  if (causal) col_hi = min(col_hi, row0 + BQ - 1);
  if (window > 0) col_lo = max(0, row0 - window + 1);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};  // rows g and g + 8

  for (int col0 = (col_lo / BK) * BK; col0 <= col_hi; col0 += BK) {
    __syncthreads();  // every warp is done with the previous K and V
    stage_bf16<HD, BK>(kh, kv_stride, col0, T_len, ks);
    stage_bf16<HD, BK>(vh, kv_stride, col0, T_len, vs);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the block's 64 keys (8 tiles of 8)
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (wr + lm_row) * ST + kk + lm_col);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        // matrices: (keys +0, k +0), (keys +0, k +8), (keys +8, k +0), (keys +8, k +8)
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ST + kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, cap, mask (masked entries -inf, so exp gives 0), online softmax
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + wr + g + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + 8 * n + 2 * t + e;
          const float x = cap_scores(s[n][2 * hr + e], scale, softcap);
          s[n][2 * hr + e] = unmasked(r, c, T_len, causal, window) ? x : masked_score();
          mx = fmaxf(mx, s[n][2 * hr + e]);
        }
      const float m_new = fmaxf(m_i[hr], quad_max(mx));
      const float corr = expf(m_i[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * hr + e] - m_new);
          s[n][2 * hr + e] = p;
          sum += p;
        }
      l_i[hr] = l_i[hr] * corr + quad_sum(sum);
      m_i[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // acc += P V: P's accumulator tiles (2 kc, 2 kc + 1) are the A fragment of keys 16 kc ..
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        // transposed matrices: (keys +0, cols +0), (keys +8, cols +0), (keys +0, cols +8), (keys +8, cols +8)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kc * 16 + lm_row) * ST + np * 16 + lm_col);
        mma_bf16(acc[2 * np], a, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();  // the Q copy, when no key block was visited

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + wr + g + 8 * hr;
    if (r >= S) continue;
    const float denom = fmaxf(l_i[hr], 1e-30f);
    __nv_bfloat16* orow = oh + static_cast<long long>(r) * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * hr] / denom, acc[n][2 * hr + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int HD>
struct F32Layout {
  static constexpr int QK = HD + 4;  // float stride of a Q / K row in shared memory
  static constexpr int P = BQ + 4;   // float stride of a key's row of P^T
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * QK;
  static constexpr int v_off = k_off + BK * QK;
  static constexpr int p_off = v_off + BK * HD;
  static constexpr size_t bytes = static_cast<size_t>(p_off + BK * P) * sizeof(float);
};

// Rows r0 .. r0 + ROWS - 1 of a (rows, HD) float view into shared memory;
// rows at or past n_rows are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_f32(const float* __restrict__ base, long long row_stride, int r0,
                                          int n_rows, float* dst, int dst_stride) {
  constexpr int CPR = HD / 4;  // float4 chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += F32_THREADS) {
    const int r = c / CPR, e = (c % CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) x = __ldg(reinterpret_cast<const float4*>(base + static_cast<long long>(r0 + r) * row_stride + e));
    *reinterpret_cast<float4*>(dst + r * dst_stride + e) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int S, int T_len, int H, int KV, float scale, float softcap, int causal,
    int window) {
  using L = F32Layout<HD>;
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q_off;
  float* ks = smem + L::k_off;
  float* vs = smem + L::v_off;
  float* ps = smem + L::p_off;

  const int nq = (S + BQ - 1) / BQ;
  const int row0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const float* qh = q + (static_cast<long long>(b) * S * H + h) * HD;
  const float* kh = k + (static_cast<long long>(b) * T_len * KV + kvh) * HD;
  const float* vh = v + (static_cast<long long>(b) * T_len * KV + kvh) * HD;
  float* oh = o + (static_cast<long long>(b) * S * H + h) * HD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_f32<HD, BQ>(qh, q_stride, row0, S, qs, L::QK);

  int col_lo = 0, col_hi = T_len - 1;
  if (causal) col_hi = min(col_hi, row0 + BQ - 1);
  if (window > 0) col_lo = max(0, row0 - window + 1);

  float acc[4][NC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int col0 = (col_lo / BK) * BK; col0 <= col_hi; col0 += BK) {
    __syncthreads();  // the previous block's readers of ks, vs and ps are done
    stage_f32<HD, BK>(kh, kv_stride, col0, T_len, ks, L::QK);
    stage_f32<HD, BK>(vh, kv_stride, col0, T_len, vs, HD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * L::QK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * L::QK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv4[j].x, a);
          a = fmaf(qv[i].y, kv4[j].y, a);
          a = fmaf(qv[i].z, kv4[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, a);
        }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        const float x = cap_scores(s[i][j], scale, softcap);
        s[i][j] = unmasked(r, c, T_len, causal, window) ? x : masked_score();
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      l_i[i] = l_i[i] * corr + half_warp_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * L::P + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + kk * L::P + 4 * ty);
      const float* vrow = vs + kk * HD + tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = vrow[16 * c];
        acc[0][c] = fmaf(pv.x, x, acc[0][c]);
        acc[1][c] = fmaf(pv.y, x, acc[1][c]);
        acc[2][c] = fmaf(pv.z, x, acc[2][c]);
        acc[3][c] = fmaf(pv.w, x, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    float* orow = oh + static_cast<long long>(r) * q_stride + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                      int H, int KV, float scale, float softcap, int causal, int window,
                      cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = F32Layout<HD>::bytes;
    static_assert(smem <= MAX_SMEM, "the block's shared memory does not fit one SM");
    const cudaError_t err = allow_smem(flash_f32_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    flash_f32_kernel<HD><<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, T_len, H, KV, scale, softcap, causal, window);
  } else {
    constexpr size_t smem = MmaLayout<HD>::bytes;
    static_assert(smem <= MAX_SMEM, "the block's shared memory does not fit one SM");
    const cudaError_t err = allow_smem(flash_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    flash_mma_kernel<HD><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T_len, H, KV, scale,
        softcap, causal, window);
  }
  return cudaGetLastError();
}

// softcap <= 0: none; window <= 0: none (a window needs causal != 0).
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int H,
           int KV, int hd, double scale, double softcap, int causal, int window, int device,
           void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (T_len <= 0 || KV <= 0 || H % KV != 0 || (window > 0 && !causal)) return cudaErrorInvalidValue;
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, S, T_len, H, KV, sc, cap, causal, window, st);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, S, T_len, H, KV, sc, cap, causal, window, st);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, S, T_len, H, KV, sc, cap, causal, window, st);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, S, T_len, H, KV, sc, cap, causal, window, st);
    case 256: return launch_hd<T, 256>(q, k, v, o, B, S, T_len, H, KV, sc, cap, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                     int S, int T_len, int H, int KV, int hd, double scale,
                                     double softcap, int causal, int window, int device,
                                     void* stream) {
  return launch<float>(q, k, v, o, B, S, T_len, H, KV, hd, scale, softcap, causal, window, device,
                       stream);
}

REPRO_EXPORT int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                      int S, int T_len, int H, int KV, int hd, double scale,
                                      double softcap, int causal, int window, int device,
                                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, hd, scale, softcap, causal, window,
                               device, stream);
}
