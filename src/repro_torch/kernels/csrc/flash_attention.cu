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
// (B = 4, S = T = 2048, 8 heads on 4, hd = 256, bf16) 6.9e10 FLOP, 0.0695 ms
// at 989 TFLOP/s on the tensor cores, against 50 MB, 0.015 ms at 3.35 TB/s.
// In float32 the CUDA cores' 67 TFLOP/s bound it the same way.
//
// bf16 (the served path), flash_wgmma_kernel: only wgmma reaches the tensor
// cores' full rate, so both products run on it, fed by TMA, in a
// warp-specialised CTA of three warpgroups (384 threads, one CTA per SM):
//
//   producer   warpgroup 2 gives its registers away (setmaxnreg 24); one
//              thread loads Q once, then keeps the K and V blocks of 64 keys
//              in flight through a ring of 2 stages (hd = 256; 4 below), each
//              stage with a full and an empty mbarrier for K and for V, so a
//              K block is reloaded as soon as its S product is done;
//   consumers  warpgroups 0 and 1 (setmaxnreg 240) each own 64 query rows:
//              S = Q K^T by wgmma m64n64k16 with Q and K both K-major in
//              shared memory, then O += P V by wgmma m64n{hd}k16 with P, the
//              softmax weights rounded to bf16, as the A operand straight
//              from the registers that held S (the accumulator and A
//              fragment layouts match) and V read MN-major through the
//              descriptor's transpose, never transposed in memory.
//
// GQA packing: a CTA takes the same 64 rows of two query heads of one KV
// head, so each K and V block is loaded once for both (gemma2-2b: 8 heads on
// 4, both heads of a KV head in one CTA, with one mask and one trip count);
// with one query head per KV head it takes 128 rows of that head instead.
// The tiles arrive by TMA as boxes of 64 rows x 128 bytes (hd / 64 boxes a
// row at hd >= 64; 64- and 32-byte boxes at hd 32 and 16) in the swizzle that
// the wgmma descriptors name, so the same bytes serve TMA and the tensor
// cores without a bank conflict.  Q rows past S and keys past T arrive as
// zeros (TMA's out-of-bounds fill); the output leaves through the Q slot of
// shared memory by a TMA store, which drops the rows past S.
//
// Each consumer overlaps its softmax with the tensor cores: while the
// product P_{n-1} V_{n-1} runs, it takes S_n = Q K_n^T (issued first) through
// the cap, the mask and the exponentials, and rescales O once P V is done.
// The softmax runs in base 2 with log2(e) folded into the scale, on
// ex2.approx; the softcap is cap * (1 - 2 / (1 + 2^(2 log2(e) x / cap))),
// exact to float32 rounding (about 1e-7 of cap), not tanh.approx (2^-11).
// The element-wise mask runs only in the blocks that straddle the causal
// diagonal, the window's edge or the ragged end of T; the CTA skips the
// blocks wholly above the diagonal or left of the window, and the CTAs run
// longest query blocks first.
//
// float32 (the smoke configurations and the tests): float32 FMA on the CUDA
// cores, 256 threads, each owning a 4 x 4 tile of the 64 x 64 score block
// (rows 4 ty + i, columns tx + 16 j) and the same 4 rows of the output
// (columns tx + 16 c); the statistics close with shuffles across a
// half-warp, and P goes through shared memory (transposed, one float4 per
// key) into P V.  Row strides of hd + 4 floats keep the 16-byte reads of 8
// consecutive rows off a shared bank.  At hd = 256 it holds 211 KB: one
// block per SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // query rows of one block (float32) or one consumer warpgroup (bf16)
constexpr int BK = 64;  // keys of one staged K/V block
constexpr float NEG_INF = -1073741824.0f;  // -2^30, the Pallas kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
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
// bf16: wgmma and TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG = 128;                         // threads of a warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups, 64 query rows each
constexpr int WS_THREADS = (CONSUMERS + 1) * WG;  // and one producer warpgroup

template <int HD>
struct WsLayout {
  static constexpr int SWB = 2 * HD < 128 ? 2 * HD : 128;  // bytes of a box row (the swizzle span)
  static constexpr int BOXE = SWB / 2;                     // bf16 of a box row
  static constexpr int NBOX = HD / BOXE;                   // boxes across hd
  static constexpr uint32_t LAYOUT = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;  // descriptor layout type
  static constexpr int SWMASK = SWB / 16 - 1;              // 16-byte chunks XORed by the swizzle
  static constexpr int STAGES = HD >= 256 ? 2 : 4;
  static constexpr int BOX_BYTES = 64 * SWB;               // one box of 64 rows
  static constexpr int TILE_BYTES = 64 * HD * 2;           // 64 rows: a Q slot, a K or a V stage
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + CONSUMERS * TILE_BYTES;
  static constexpr int v_off = k_off + STAGES * TILE_BYTES;
  static constexpr int bar_off = v_off + STAGES * TILE_BYTES;
  // q_full, then k_full, v_full, k_empty, v_empty: STAGES each
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr size_t bytes = bar_off + 8 * N_BARS + 1024;  // + alignment of the base to 1024
  static_assert(bytes <= MAX_SMEM, "the CTA's shared memory does not fit one SM");
};

struct Softmax {
  float scale_log2;  // log2(e) / sqrt(hd)
  float cap_in;      // 2 log2(e) / (sqrt(hd) softcap)
  float cap_out;     // softcap log2(e)
  int use_cap, T_len, causal, window;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// One block of 64 keys through the softmax, in base 2: s holds the thread's
// raw scores of rows r and r + 8 (s[4j + {0,1}] and s[4j + {2,3}], keys col0
// + 8j + 2t + {0,1}), and leaves their weights 2^(y - m') there.  m and l
// are the running row max (base 2) and the thread's share of the row sum;
// c the factor that rescales the output.  Without the cap, y = s scale_log2
// is folded into the exponent's FMA (scale_log2 > 0 keeps the max).  MASK:
// test each entry.
template <bool CAP, bool MASK>
__device__ __forceinline__ void softmax_block(float (&s)[32], float (&m)[2], float (&l)[2], float (&c)[2],
                                              const Softmax& sm, int r, int col0, int t) {
  float mx[2] = {masked_score(), masked_score()};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float y = CAP ? fmaf(-2.f * sm.cap_out, rcp(1.f + ex2(s[i] * sm.cap_in)), sm.cap_out) : s[i];
    if (MASK && !unmasked(r + 8 * h, col0 + 8 * (i >> 2) + 2 * t + (i & 1), sm.T_len, sm.causal, sm.window))
      y = masked_score();
    s[i] = y;
    mx[h] = fmaxf(mx[h], y);
  }
  const float k = CAP ? 1.f : sm.scale_log2;
  float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m[h], quad_max(mx[h]) * k);
    c[h] = ex2(m[h] - m_new[h]);
    m[h] = m_new[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], k, -m_new[h]));
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * c[h] + sum[h];
}

__device__ __forceinline__ void softmax_dispatch(float (&s)[32], float (&m)[2], float (&l)[2], float (&c)[2],
                                                 const Softmax& sm, int r, int col0, int t, bool full) {
  if (sm.use_cap) {
    if (full) softmax_block<true, false>(s, m, l, c, sm, r, col0, t);
    else softmax_block<true, true>(s, m, l, c, sm, r, col0, t);
  } else {
    if (full) softmax_block<false, false>(s, m, l, c, sm, r, col0, t);
    else softmax_block<false, true>(s, m, l, c, sm, r, col0, t);
  }
}

// S = Q K^T: 64 rows x 64 keys, depth hd, both operands K-major in shared
// memory.  Each descriptor is formed from an opaque copy of the base address
// just before its wgmma, so the compiler cannot compute them all ahead and
// hold them in registers beside O, S and P.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
  using L = WsLayout<HD>;
  hop::fence_regs(s);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 32 / L::SWB) * L::BOX_BYTES + (kk * 32) % L::SWB;
    hop::wgmma_ss_m64n64k16(s, hop::gmma_desc(hop::opaque(q_addr) + off, 16, 8 * L::SWB, L::LAYOUT),
                            hop::gmma_desc(hop::opaque(k_addr) + off, 16, 8 * L::SWB, L::LAYOUT), kk > 0);
  }
  hop::wgmma_commit();
}

// O += P V: P (64 x 64 keys) from registers, V (64 keys x hd) MN-major in shared memory.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[16], uint32_t v_addr) {
  using L = WsLayout<HD>;
  hop::fence_regs(o);
  hop::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    hop::WgmmaRS<HD>::mma(o, p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3],
                          hop::gmma_desc(hop::opaque(v_addr) + kc * 16 * L::SWB, L::BOX_BYTES, 8 * L::SWB, L::LAYOUT));
  hop::wgmma_commit();
}

// P as bf16 A fragments: keys 16 kc .. 16 kc + 15 are p[4 kc .. 4 kc + 3].
__device__ __forceinline__ void pack_p(uint32_t (&p)[16], const float (&s)[32]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
}

// Lane 0 of each warp arrives, after the warp's wgmma reads of the stage are done.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(bar);
}

// grid: one CTA per (query rows, head unit, batch), the longest query blocks
// first.  A head unit is a KV head's pair of query heads (H / KV >= 2; an odd
// last pair computes its one head twice and stores it once) or one query head
// (H == KV, two blocks of 64 rows).
template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, int S, int H, int KV,
    int n_units, int n_row_blocks, Softmax sm) {
  using L = WsLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - hop::smem_u32(smem_raw));
  const uint32_t q_full = base + L::bar_off;
  auto bar = [&](int kind, int st) { return base + L::bar_off + 8 * (1 + kind * L::STAGES + st); };
  enum { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

  // the work item: rows and head of each consumer's 64-row slot
  const int G = H / KV;
  const int per_rb = gridDim.x / n_row_blocks;
  const int rb = n_row_blocks - 1 - static_cast<int>(blockIdx.x) / per_rb;
  const int rest = static_cast<int>(blockIdx.x) % per_rb;
  const int b = rest / n_units, u = rest % n_units;
  int head0, head1, row0, row1, kvh;
  bool keep1;  // slot 1 holds rows of its own (else it repeats slot 0 and stores nothing)
  if (G == 1) {
    kvh = head0 = head1 = u;
    row0 = rb * 2 * BQ;
    keep1 = row0 + BQ < S;
    row1 = keep1 ? row0 + BQ : row0;
  } else {
    const int pairs = (G + 1) / 2;
    kvh = u / pairs;
    head0 = kvh * G + 2 * (u % pairs);
    keep1 = 2 * (u % pairs) + 1 < G;
    head1 = keep1 ? head0 + 1 : head0;
    row0 = row1 = rb * BQ;
  }
  // the key blocks a kept row needs: causal skipping above the last row, window skipping left of the first
  const int last_row = min(row1 + BQ - 1, S - 1);
  int col_lo = 0, col_hi = sm.T_len - 1;
  if (sm.causal) col_hi = min(col_hi, last_row);
  if (sm.window > 0) col_lo = max(0, row0 - sm.window + 1);
  const int blk_lo = col_lo / BK;
  const int n_blk = col_hi >= col_lo ? col_hi / BK - blk_lo + 1 : 0;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      hop::mbar_init(bar(K_FULL, st), 1);
      hop::mbar_init(bar(V_FULL, st), 1);
      hop::mbar_init(bar(K_EMPTY, st), CONSUMERS * 4);  // lane 0 of every consumer warp
      hop::mbar_init(bar(V_EMPTY, st), CONSUMERS * 4);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    // ---- producer: Q once, then the K and V ring ----------------------------
    hop::reg_dealloc<24>();
    if (threadIdx.x == CONSUMERS * WG) {
      hop::mbar_expect_tx(q_full, CONSUMERS * L::TILE_BYTES);
      for (int slot = 0; slot < CONSUMERS; ++slot)
        for (int bx = 0; bx < L::NBOX; ++bx)
          hop::tma_load_4d(base + L::q_off + slot * L::TILE_BYTES + bx * L::BOX_BYTES, &tq, q_full,
                           bx * L::BOXE, slot ? head1 : head0, slot ? row1 : row0, b);
      for (int n = 0; n < n_blk; ++n) {
        const int st = n % L::STAGES;
        const uint32_t ph = (n / L::STAGES) & 1;
        const int key0 = (blk_lo + n) * BK;
        hop::mbar_wait(bar(K_EMPTY, st), ph ^ 1);
        hop::mbar_expect_tx(bar(K_FULL, st), L::TILE_BYTES);
        for (int bx = 0; bx < L::NBOX; ++bx)
          hop::tma_load_4d(base + L::k_off + st * L::TILE_BYTES + bx * L::BOX_BYTES, &tk, bar(K_FULL, st),
                           bx * L::BOXE, kvh, key0, b);
        hop::mbar_wait(bar(V_EMPTY, st), ph ^ 1);
        hop::mbar_expect_tx(bar(V_FULL, st), L::TILE_BYTES);
        for (int bx = 0; bx < L::NBOX; ++bx)
          hop::tma_load_4d(base + L::v_off + st * L::TILE_BYTES + bx * L::BOX_BYTES, &tv, bar(V_FULL, st),
                           bx * L::BOXE, kvh, key0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------------
    hop::reg_alloc<240>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int ra = wg ? row1 : row0;   // the warpgroup's first row
    const int r = ra + warp * 16 + g;  // the thread's rows r and r + 8
    const uint32_t q_addr = base + L::q_off + wg * L::TILE_BYTES;
    auto k_addr = [&](int st) { return base + L::k_off + st * L::TILE_BYTES; };
    auto v_addr = [&](int st) { return base + L::v_off + st * L::TILE_BYTES; };
    // no entry of the block is masked for any of the warpgroup's rows
    auto full = [&](int key0) {
      return key0 + BK <= sm.T_len && (!sm.causal || key0 + BK - 1 <= ra) &&
             (sm.window <= 0 || key0 > ra + BQ - 1 - sm.window);
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, c[2];
    uint32_t p[16];

    hop::mbar_wait(q_full, 0);
    if (n_blk > 0) {
      hop::mbar_wait(bar(K_FULL, 0), 0);
      issue_qk<HD>(s, q_addr, k_addr(0));
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      warp_arrive(bar(K_EMPTY, 0));
      softmax_dispatch(s, m, l, c, sm, r, blk_lo * BK, t, full(blk_lo * BK));
      pack_p(p, s);
      for (int n = 1; n < n_blk; ++n) {
        const int st = n % L::STAGES, pst = (n - 1) % L::STAGES;
        const uint32_t ph = (n / L::STAGES) & 1, pph = ((n - 1) / L::STAGES) & 1;
        const int key0 = (blk_lo + n) * BK;
        hop::mbar_wait(bar(K_FULL, st), ph);
        issue_qk<HD>(s, q_addr, k_addr(st));
        hop::mbar_wait(bar(V_FULL, pst), pph);
        issue_pv<HD>(o, p, v_addr(pst));
        hop::wgmma_wait<1>();  // S_n is done; P_{n-1} V_{n-1} may still run
        hop::fence_regs(s);
        warp_arrive(bar(K_EMPTY, st));
        softmax_dispatch(s, m, l, c, sm, r, key0, t, full(key0));
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        hop::fence_regs(s);
        warp_arrive(bar(V_EMPTY, pst));
        if (__any_sync(0xffffffffu, c[0] != 1.f || c[1] != 1.f)) {  // a row max of the warp moved
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) o[i] *= c[(i >> 1) & 1];
        }
        pack_p(p, s);
      }
      const int pst = (n_blk - 1) % L::STAGES;
      hop::mbar_wait(bar(V_FULL, pst), ((n_blk - 1) / L::STAGES) & 1);
      issue_pv<HD>(o, p, v_addr(pst));
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
    }

    // O / l in bf16 into the warpgroup's Q slot, in the TMA box layout, then out by TMA
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(quad_sum(l[h]), 1e-30f);
    unsigned char* slot = smem + L::q_off + wg * L::TILE_BYTES;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = warp * 16 + g + 8 * h;
        uint32_t off = (col / L::BOXE) * L::BOX_BYTES + rr * L::SWB + (col % L::BOXE) * 2;
        off ^= (off & (L::SWMASK << 7)) >> 3;
        *reinterpret_cast<uint32_t*>(slot + off) = pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    hop::fence_proxy_async();
    hop::named_barrier(1 + wg, WG);
    if (tid == 0 && (wg == 0 || keep1)) {
      for (int bx = 0; bx < L::NBOX; ++bx)
        hop::tma_store_4d(&to, base + L::q_off + wg * L::TILE_BYTES + bx * L::BOX_BYTES, bx * L::BOXE,
                          wg ? head1 : head0, ra, b);
      hop::bulk_commit();
      hop::bulk_wait_read();
    }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's cudaGetDriverEntryPoint (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 (B, rows, heads, HD) array, in boxes
// of 64 rows x one swizzle span of one head, zero-filled out of bounds.
template <int HD>
cudaError_t tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int rows, int heads) {
  using L = WsLayout<HD>;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * 2ull, HD * 2ull * heads, HD * 2ull * heads * rows};
  const cuuint32_t box[4] = {L::BOXE, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::SWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::SWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int H,
                        int KV, float scale, float softcap, int causal, int window, cudaStream_t stream) {
  using L = WsLayout<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = tensor_map<HD>(encode, &tq, q, B, S, H);
  if (err == cudaSuccess) err = tensor_map<HD>(encode, &tk, k, B, T_len, KV);
  if (err == cudaSuccess) err = tensor_map<HD>(encode, &tv, v, B, T_len, KV);
  if (err == cudaSuccess) err = tensor_map<HD>(encode, &to, o, B, S, H);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const int rows = G == 1 ? 2 * BQ : BQ;  // query rows of a CTA
  const int n_row_blocks = (S + rows - 1) / rows;
  const int n_units = G == 1 ? H : KV * ((G + 1) / 2);
  const long long grid = static_cast<long long>(n_row_blocks) * n_units * B;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  Softmax sm;
  sm.scale_log2 = scale * LOG2E;
  sm.use_cap = softcap > 0.f;
  sm.cap_in = sm.use_cap ? 2.f * LOG2E * scale / softcap : 0.f;
  sm.cap_out = sm.use_cap ? softcap * LOG2E : 0.f;
  sm.T_len = T_len;
  sm.causal = causal;
  sm.window = window;
  err = allow_smem(flash_wgmma_kernel<HD>, L::bytes);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<HD><<<static_cast<int>(grid), WS_THREADS, L::bytes, stream>>>(tq, tk, tv, to, S, H, KV, n_units,
                                                                                   n_row_blocks, sm);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int H,
                       int KV, float scale, float softcap, int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  constexpr size_t smem = F32Layout<HD>::bytes;
  static_assert(smem <= MAX_SMEM, "the block's shared memory does not fit one SM");
  const cudaError_t err = allow_smem(flash_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, T_len, H, KV, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int H,
                      int KV, float scale, float softcap, int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch_f32<HD>(q, k, v, o, B, S, T_len, H, KV, scale, softcap, causal, window, stream);
  else
    return launch_bf16<HD>(q, k, v, o, B, S, T_len, H, KV, scale, softcap, causal, window, stream);
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

// CTAs of the bf16 kernel at head size hd that fit on one SM; a negative CUDA error code on failure.
REPRO_EXPORT int flash_bf16_ctas_per_sm(int hd) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto query = [&](auto kernel, size_t bytes) {
    err = allow_smem(kernel, bytes);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, WS_THREADS, bytes);
  };
  switch (hd) {
    case 16: query(flash_wgmma_kernel<16>, WsLayout<16>::bytes); break;
    case 32: query(flash_wgmma_kernel<32>, WsLayout<32>::bytes); break;
    case 64: query(flash_wgmma_kernel<64>, WsLayout<64>::bytes); break;
    case 128: query(flash_wgmma_kernel<128>, WsLayout<128>::bytes); break;
    case 256: query(flash_wgmma_kernel<256>, WsLayout<256>::bytes); break;
    default: break;
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
