// Register-blocked SIMT product core of the TRAIL and carry kernels.
//
// IEEE FMA on the CUDA cores in the accumulator type (float for float32 and
// bfloat16 operands, double for float64), never TF32: the float32 path
// issues no HMMA or wgmma.  A CTA of TY x TX threads computes a BM x BN
// output tile; each thread owns (2V) x (2V) accumulators as 2 x 2 sub-tiles
// of V x V.  V is one 16-byte vector by default (8 x 8 floats, 4 x 4
// doubles); small tiles halve it.
//
//   rows  hr * BM/2 + ty * V + i,   columns  hc * BN/2 + tx * V + j.
//
// Both operands are staged k-major in shared memory (A[k][row], B[k][col]),
// so each k step reads two V-vectors of A and two of B per thread and does
// (2V)^2 FMAs.  A warp's lanes form a 4 x 8 patch of (ty, tx): its vector
// reads touch 4 distinct A addresses and 8 consecutive B vectors, one
// shared-memory wavefront each, with no bank conflicts: fed from shared
// memory alone, the core keeps the H100's FMA pipes as busy as FMAs on
// registers alone do, so what a kernel loses is in its loads and barriers.
//
// Loaders fill the panels.  RowPanel takes rows of a row-major matrix whose
// k is contiguous (A B^T needs it for both operands): 16-byte global loads
// into registers, written transposed into the panel after the FMAs of the
// current stage, so the load latency hides behind them.  kpanel_async takes
// rows of k (the matrix is already k-major) and copies them with cp.async.
// Each has a vector instantiation (16-byte accesses: needs rows that are
// 16-byte aligned) and a scalar one (any m); both zero-fill past the edges.
#pragma once

#include <cuda_bf16.h>

namespace gemm {

template <typename T, int N>
struct alignas(N * sizeof(T)) VecN {
  T v[N];
};

template <typename T>
using Vec16 = VecN<T, 16 / sizeof(T)>;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes through L2, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

// cp.async of one 4- or 8-byte element, zero-filled when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread tile: who owns which accumulators, and the panel geometry.
// V defaults to one 16-byte vector; a smaller V gives smaller thread tiles.
template <typename TA_, int TY_, int TX_, int V_ = 16 / sizeof(TA_)>
struct Tile {
  using TA = TA_;
  static constexpr int V = V_;
  static constexpr int TY = TY_, TX = TX_, THREADS = TY * TX;
  static constexpr int BM = 2 * V * TY, BN = 2 * V * TX;
  static constexpr int LDA = BM + V, LDB = BN + V;  // panel row pitch (V-vector aligned)
  static_assert(TY % 4 == 0 && TX % 8 == 0, "a warp covers 4 x 8 threads");

  int ty, tx, wx;

  __device__ __forceinline__ explicit Tile(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    wx = warp % (TX / 8);
    ty = (warp / (TX / 8)) * 4 + (lane >> 3);
    tx = wx * 8 + (lane & 7);
  }
  __device__ __forceinline__ int row(int i) const { return (i / V) * (BM / 2) + ty * V + i % V; }
  __device__ __forceinline__ int col(int j) const { return (j / V) * (BN / 2) + tx * V + j % V; }
  // Number of column halves (0, 1 or 2) of this warp that hold a column < n_valid; warp-uniform.
  __device__ __forceinline__ int live_halves(int n_valid) const {
    return (wx * 8 * V < n_valid) + (BN / 2 + wx * 8 * V < n_valid);
  }
};

// N consecutive elements from shared memory as one vector read.
template <int N, typename T>
__device__ __forceinline__ void ldsv(const T* p, T* out) {
  const VecN<T, N> v = *reinterpret_cast<const VecN<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = v.v[e];
}

template <typename T>
__device__ __forceinline__ void lds16(const T* p, T* out) {
  ldsv<16 / sizeof(T)>(p, out);
}

// acc += A^T B over K k-rows of the panels As[k * lda + row] and Bs[k * ldb + col],
// for the first NH column halves (NH = 1 leaves the second half's accumulators alone).
template <class TL, int K, int NH>
__device__ __forceinline__ void mma(const TL& t, const typename TL::TA* __restrict__ as, int lda,
                                    const typename TL::TA* __restrict__ bs, int ldb,
                                    typename TL::TA (&acc)[2 * TL::V][2 * TL::V]) {
  using TA = typename TL::TA;
  constexpr int V = TL::V;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    TA a[2 * V], b[2 * V];
    ldsv<V>(as + k * lda + t.ty * V, a);
    ldsv<V>(as + k * lda + TL::BM / 2 + t.ty * V, a + V);
    ldsv<V>(bs + k * ldb + t.tx * V, b);
    if (NH == 2) ldsv<V>(bs + k * ldb + TL::BN / 2 + t.tx * V, b + V);
#pragma unroll
    for (int i = 0; i < 2 * V; ++i)
#pragma unroll
      for (int j = 0; j < NH * V; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// mma over the column halves that hold a column < n_valid (a warp-uniform branch).
template <class TL, int K>
__device__ __forceinline__ void mma_live(const TL& t, const typename TL::TA* __restrict__ as, int lda,
                                         const typename TL::TA* __restrict__ bs, int ldb,
                                         typename TL::TA (&acc)[2 * TL::V][2 * TL::V], int n_valid) {
  const int halves = t.live_halves(n_valid);
  if (halves == 2) {
    mma<TL, K, 2>(t, as, lda, bs, ldb, acc);
  } else if (halves == 1) {
    mma<TL, K, 1>(t, as, lda, bs, ldb, acc);
  }
}

template <class TL>
__device__ __forceinline__ void zero(typename TL::TA (&acc)[2 * TL::V][2 * TL::V]) {
#pragma unroll
  for (int i = 0; i < 2 * TL::V; ++i)
#pragma unroll
    for (int j = 0; j < 2 * TL::V; ++j) acc[i][j] = typename TL::TA(0);
}

// ROWS rows x BK k of a row-major matrix with k contiguous (src[row * ld + k]),
// held in registers between load() and store(); store() writes the panel
// transposed, dst[k * ldd + row], converted to the accumulator type.
// Chunks of CH = 16 / sizeof(TI) consecutive k; VEC loads a chunk as one
// 16-byte vector (rows 16-byte aligned, kmax a multiple of CH), the scalar
// instantiation element by element.  Past nrows or kmax it holds zeros.
template <typename TI, typename TA, int ROWS, int BK, int THREADS, bool VEC>
struct RowPanel {
  static constexpr int CH = 16 / sizeof(TI);
  static constexpr int KCH = BK / CH;
  static constexpr int CHUNKS = ROWS * KCH;
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static_assert(BK % CH == 0, "a stage holds whole chunks");

  Vec16<TI> r[PER];

  __device__ __forceinline__ void load(const TI* __restrict__ src, int ld, int row0, int nrows, int k0,
                                       int kmax, int tid) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * THREADS;
      const int row = c / KCH, k = k0 + (c % KCH) * CH, grow = row0 + row;
      const TI* s = src + static_cast<size_t>(grow) * ld + k;
      const bool live = (CHUNKS % THREADS == 0 || c < CHUNKS) && grow < nrows;
      if (VEC) {
        if (live && k < kmax) {
          r[p] = *reinterpret_cast<const Vec16<TI>*>(s);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e) r[p].v[e] = TI(0.0f);
        }
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) r[p].v[e] = (live && k + e < kmax) ? s[e] : TI(0.0f);
      }
    }
  }

  __device__ __forceinline__ void store(TA* __restrict__ dst, int ldd, int tid) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * THREADS;
      if (CHUNKS % THREADS == 0 || c < CHUNKS) {
        const int row = c / KCH, kq = (c % KCH) * CH;
#pragma unroll
        for (int e = 0; e < CH; ++e) dst[(kq + e) * ldd + row] = to_acc(r[p].v[e]);
      }
    }
  }
};

// BK rows of k x COLS columns of a k-major matrix (src[k * ld + n]) copied
// with cp.async into dst[k * ldd + n]; zero past kmax rows or nmax columns.
// Chunks of 16 bytes: VEC copies a chunk at once (n0, ld and nmax multiples
// of its length), the scalar instantiation element by element.
template <typename T, int BK, int COLS, int THREADS, bool VEC>
__device__ __forceinline__ void kpanel_async(T* __restrict__ dst, int ldd, const T* __restrict__ src, int ld,
                                             int k0, int kmax, int n0, int nmax, int tid) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int NCH = COLS / CH, CHUNKS = BK * NCH;
#pragma unroll 1
  for (int c = tid; c < CHUNKS; c += THREADS) {
    const int k = c / NCH, n = (c % NCH) * CH;
    const bool row_ok = k0 + k < kmax;
    const T* s = src + static_cast<size_t>(k0 + k) * ld + n0 + n;
    if (VEC) {
      const bool valid = row_ok && n0 + n < nmax;
      cp_async16(dst + k * ldd + n, valid ? s : src, valid);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const bool valid = row_ok && n0 + n + e < nmax;
        cp_async_elem<sizeof(T)>(dst + k * ldd + n + e, valid ? s + e : src, valid);
      }
    }
  }
}

}  // namespace gemm
