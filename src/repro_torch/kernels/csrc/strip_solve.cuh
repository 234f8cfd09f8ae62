// Right triangular solve X C^T = S of independent row strips, shared by the
// carry kernel (carry_update.cu: S = W - L Y) and the TRSM kernel
// (trsm_tile.cu: S = B).  Both instantiate this header; neither keeps a copy.
//
// The rows of X are independent, so a CTA solves a strip of RS rows of one
// task with the strip held in shared memory, and needs only the task's C.
// Two launches on the caller's stream:
//
// prep, one 256-thread block per (task, 32 x 32 block of C on or below the
// diagonal): writes the block transposed into the workspace Ct (row k of Ct
// holds C[:, k], so the solve streams C's rows k-major with 16-byte copies)
// and, on the diagonal, inverts C_jj (padded with the identity past m): lane
// c of one warp runs the forward substitution of column c and writes row c of
// D_j^T = C_jj^{-T} to the workspace Dt.  Every block of the DAG's lower
// triangle is its own CTA, so the prep's critical path is one block deep.
//
// solve, on the strip in shared memory, right-looking, 32 columns at a time:
// X_j = S_j D_j^T (a small product on all threads), then the columns to the
// right take S -= X_j C[>j, j]^T, a product of depth 32 on the register-
// blocked core of gemm_core.cuh, (2V) x (2V) accumulators per thread over an
// RS x BN pass (BN = 256 x 2V / TY), with X_j^T staged in shared memory and
// Ct streamed by cp.async in two stages of DEPTH rows of k (8 or 32): a
// stage is issued while the one before it is used, and the first goes out
// while X_j is formed.  A strip shorter than its type's tallest issues them
// across the passes of a block column; the tall strip, whose 8 x 8
// accumulators leave no registers to spare, issues a pass's first stage when
// the pass begins.  D_{j+1}^T is copied while block j's update runs.  A warp
// skips the FMAs of a column half that lies wholly past m, so the work
// shrinks with the columns left.  float32 is IEEE FFMA on the CUDA cores (no
// TF32); float64 stays float64.
//
// The strip heights are the product core's: 32, 16 or 8 rows (float32), 16
// or 8 (float64), with V = min(RS / 8, one 16-byte vector) so that a warp
// covers 4 x 8 threads.  Strip<T, RS, DEPTH>::bytes(m) is the shared memory a
// CTA takes; the shortest strip with stages of 8 rows fits every tile up to
// m = 6816 (float32) and 3168 (float64), which is the range of both kernels.
#pragma once

#include <climits>
#include <type_traits>

#include "gemm_core.cuh"

namespace {
namespace strip {

constexpr int THREADS = 256;
constexpr int CB = 32;  // the solve's column block
constexpr int BK = 8;   // depth of a streamed stage: carry's phase 1, and the solve's by default
constexpr size_t MAX_SMEM = 232448;

template <typename T>
constexpr int TALLEST = sizeof(T) == 4 ? 32 : 16;

template <typename T, int RS, int DEPTH_ = BK>
struct Strip {
  static constexpr int DEPTH = DEPTH_;                   // rows of k in a stage of the streamed panel
  static constexpr bool AHEAD = RS < TALLEST<T>;         // stages issued across the passes of a block column
  static constexpr int CH = 16 / sizeof(T);               // elements of a 16-byte copy
  static constexpr int V = RS / 8 < CH ? RS / 8 : CH;     // thread-tile vector: TY = RS / (2V) >= 4
  static constexpr int TY = RS / (2 * V);
  using TL = gemm::Tile<T, TY, THREADS / TY, V>;
  static constexpr int BN = TL::BN;
  static constexpr int LDB = BN + CH;               // pitch of the streamed panel (16-byte rows)
  static constexpr int LDX = RS + V;                // pitch of region R: [k][strip row]
  static constexpr int LDD = CB + CH;               // pitch of D_j^T
  static constexpr int B_ELEMS = 2 * DEPTH * LDB;   // two stages of the streamed panel
  static constexpr int R_ELEMS = CB * LDX;          // carry's L stages, then X_j^T
  static constexpr int D_ELEMS = CB * LDD;          // D_j^T
  static_assert(2 * BK <= CB, "carry's two L stages fit in region R");
  static_assert(CB % DEPTH == 0 && DEPTH % BK == 0, "a pass is whole stages");
  static_assert(AHEAD || DEPTH == BK, "the tall strip streams stages of BK rows");
  // pitch of the strip: a multiple of 32 elements plus 4, so the rows that a
  // warp reads in the same column fall in different banks
  __host__ __device__ static int lds(int m) { return (m + 31) / 32 * 32 + 4; }
  __host__ __device__ static size_t bytes(int m) {
    return (static_cast<size_t>(RS) * lds(m) + B_ELEMS + R_ELEMS + D_ELEMS) * sizeof(T);
  }
  static bool fits(int m) { return bytes(m) <= MAX_SMEM; }
};

// f(std::integral_constant<int, RS>) for a strip height of type T; refused otherwise.
template <typename T, typename F>
cudaError_t with_rows(int rs, F&& f) {
  if constexpr (TALLEST<T> == 32) {
    if (rs == 32) return f(std::integral_constant<int, 32>{});
  }
  if (rs == 16) return f(std::integral_constant<int, 16>{});
  if (rs == 8) return f(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

// Whether a strip of rs rows (stages of BK rows) fits tile size m.
template <typename T>
bool fits(int rs, int m) {
  bool ok = false;
  with_rows<T>(rs, [&](auto r) -> cudaError_t {
    ok = Strip<T, decltype(r)::value>::fits(m);
    return cudaSuccess;
  });
  return ok;
}

// The tallest strip that fits tile size m (the carry kernel's choice); 0 if none.
template <typename T>
int tallest_fit(int m) {
  for (int rs = TALLEST<T>; rs >= 8; rs /= 2)
    if (fits<T>(rs, m)) return rs;
  return 0;
}

// The tallest strip that fits m and whose grid, g ceil(m / rs) CTAs, covers
// the card's sms SMs; where none covers them, the shortest that fits; 0 if
// none fits (the TRSM kernel's choice).
template <typename T>
int covering(long long g, int m, int sms) {
  int pick = 0;
  for (int rs = TALLEST<T>; rs >= 8; rs /= 2) {
    if (!fits<T>(rs, m)) continue;
    pick = rs;
    if (g * ((m + rs - 1) / rs) >= sms) return rs;
  }
  return pick;
}

// The largest tile size m that the shortest strip fits.
template <typename T>
int max_m() {
  int m = 1;
  while (Strip<T, 8>::fits(m + 1)) ++m;
  return m;
}

// Ct = C^T on and below the diagonal blocks, Dt[j] = C_jj^{-T}: one block per
// (task, block column j = blockIdx.x % nb, block row i = blockIdx.y >= j).
template <typename T>
__global__ void __launch_bounds__(THREADS) prep(const T* __restrict__ c_stack, T* __restrict__ ct_stack,
                                                T* __restrict__ dt_stack, int m, int nb) {
  const int g = blockIdx.x / nb, j = blockIdx.x % nb, i = blockIdx.y;
  if (i < j) return;
  __shared__ T tile[CB][CB + 1];
  const size_t mm = static_cast<size_t>(m) * m;
  const T* c = c_stack + g * mm;
  T* ct = ct_stack + g * mm;
  const int tid = threadIdx.x, k0 = j * CB, n0 = i * CB;
  const bool diag = i == j;
  for (int e = tid; e < CB * CB; e += THREADS) {
    const int r = e / CB, k = e % CB;
    const bool in = n0 + r < m && k0 + k < m;
    tile[r][k] = in ? c[static_cast<size_t>(n0 + r) * m + k0 + k] : (diag && r == k ? T(1) : T(0));
  }
  __syncthreads();
  for (int e = tid; e < CB * CB; e += THREADS) {
    const int k = e / CB, r = e % CB;
    if (k0 + k < m && n0 + r < m) ct[static_cast<size_t>(k0 + k) * m + n0 + r] = tile[r][k];
  }
  if (diag && tid < 32) {
    // column `lane` of C_jj^{-1} by forward substitution; it is row `lane` of C_jj^{-T}
    const int lane = tid;
    T z[CB];
#pragma unroll
    for (int r = 0; r < CB; ++r) {
      T v = r == lane ? T(1) : T(0);
#pragma unroll
      for (int q = 0; q < r; ++q) v = fma(-tile[r][q], z[q], v);
      z[r] = v / tile[r][r];
    }
    T* d = dt_stack + (static_cast<size_t>(g) * nb + j) * CB * CB + lane * CB;
#pragma unroll
    for (int q = 0; q < CB; q += 16 / sizeof(T)) {
      gemm::Vec16<T> v;
#pragma unroll
      for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) v.v[e] = z[q + e];
      *reinterpret_cast<gemm::Vec16<T>*>(d + q) = v;
    }
  }
}

// Launch prep on n_tiles tasks of C (ct and dt are the caller's workspace).
template <typename T>
cudaError_t launch_prep(const T* c, T* ct, T* dt, int n_tiles, int m, cudaStream_t st) {
  const int nb = (m + CB - 1) / CB;
  const long long blocks = static_cast<long long>(n_tiles) * nb;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  prep<T><<<dim3(static_cast<unsigned>(blocks), nb), THREADS, 0, st>>>(c, ct, dt, m, nb);
  return cudaGetLastError();
}

// The shared-memory regions of a strip CTA, carved from its dynamic shared memory.
template <typename T, int RS, int DEPTH>
struct Smem {
  using S = Strip<T, RS, DEPTH>;
  T* s;   // [RS][lds(m)]: the strip, S and then X; zero in columns [m, 32 ceil(m / 32))
  T* bs;  // [2][DEPTH][LDB]: the streamed panel's stages
  T* rr;  // region R: [CB][LDX], X_j^T (carry stages L here first)
  T* ds;  // [CB][LDD]: D_j^T
  int ld;
  __device__ __forceinline__ Smem(unsigned char* raw, int m) {
    ld = S::lds(m);
    s = reinterpret_cast<T*>(raw);
    bs = s + static_cast<size_t>(RS) * ld;
    rr = bs + S::B_ELEMS;
    ds = rr + S::R_ELEMS;
  }
};

// Rows r0 .. r0 + RS of a row-major (m, m) matrix into the strip by cp.async,
// zero past m rows and in columns [m, 32 ceil(m / 32)).  VEC: 16-byte copies
// (m a multiple of 16 / sizeof(T)); otherwise one element at a time.
template <typename T, int RS, bool VEC>
__device__ __forceinline__ void load_rows(T* __restrict__ s, int ld, const T* __restrict__ src, int m, int r0,
                                          int tid) {
  constexpr int CH = 16 / sizeof(T);
  const int mpad = (m + CB - 1) / CB * CB;
  if (VEC) {
    const int per_row = mpad / CH;
#pragma unroll 1
    for (int e = tid; e < RS * per_row; e += THREADS) {
      const int row = e / per_row, col = (e % per_row) * CH;
      const bool valid = r0 + row < m && col < m;
      const T* p = src + static_cast<size_t>(r0 + row) * m + col;
      gemm::cp_async16(s + row * ld + col, valid ? p : src, valid);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < RS * mpad; e += THREADS) {
      const int row = e / mpad, col = e % mpad;
      const bool valid = r0 + row < m && col < m;
      const T* p = src + static_cast<size_t>(r0 + row) * m + col;
      gemm::cp_async_elem<sizeof(T)>(s + row * ld + col, valid ? p : src, valid);
    }
  }
}

// The strip's valid rows (of r0 .. r0 + RS) into rows of a row-major (m, m) matrix.
template <typename T, int RS, bool VEC>
__device__ __forceinline__ void store_rows(T* __restrict__ o, const T* __restrict__ s, int ld, int m, int r0,
                                           int tid) {
  constexpr int CH = 16 / sizeof(T);
  const int rows = m - r0 < RS ? m - r0 : RS;
  if (VEC) {
    const int per_row = m / CH;
    for (int e = tid; e < rows * per_row; e += THREADS) {
      const int row = e / per_row, col = (e % per_row) * CH;
      *reinterpret_cast<gemm::Vec16<T>*>(o + static_cast<size_t>(r0 + row) * m + col) =
          *reinterpret_cast<const gemm::Vec16<T>*>(s + row * ld + col);
    }
  } else {
    for (int e = tid; e < rows * m; e += THREADS) {
      const int row = e / m, col = e % m;
      o[static_cast<size_t>(r0 + row) * m + col] = s[row * ld + col];
    }
  }
}

// X C^T = S in place on the strip, right-looking by 32-column blocks, for one
// task's Ct (m, m) and Dt (ceil(m / 32), 32, 32).  The caller has the strip
// in sm.s (its copies may still be in flight as cp.async groups) and
// synchronises after; the strip then holds X.
template <typename T, int RS, int DEPTH, bool VEC>
__device__ __forceinline__ void solve(const Smem<T, RS, DEPTH>& sm, const T* __restrict__ ct,
                                      const T* __restrict__ dt, int m, int tid) {
  using S = Strip<T, RS, DEPTH>;
  using TL = typename S::TL;
  constexpr int V = S::V, CH = S::CH, BN = S::BN, LDB = S::LDB, LDX = S::LDX, LDD = S::LDD;
  constexpr int NK = CB / DEPTH;  // stages of a pass
  using VecV = gemm::VecN<T, V>;
  T* s = sm.s;
  T* bs = sm.bs;
  T* rr = sm.rr;
  T* ds = sm.ds;
  const int ld = sm.ld;
  const TL t(tid);
  const int nb = (m + CB - 1) / CB;
  T acc[2 * V][2 * V];

  // D_j^T into ds; one cp.async group, empty past the last block, so that
  // stage 0 of a block column is always followed by one group
  auto load_d = [&](int j) {
    if (j < nb)
      for (int e = tid; e < CB * CB / CH; e += THREADS)
        gemm::cp_async16(ds + (e / (CB / CH)) * LDD + (e % (CB / CH)) * CH, dt + j * CB * CB + e * CH, true);
    gemm::cp_async_commit();
  };

  const int xr = tid / 8, xc = (tid % 8) * 4;
  load_d(0);
  for (int j = 0; j < nb; ++j) {
    const int k0 = j * CB;
    const int n_pass = m > k0 + CB ? (m - k0 - CB + BN - 1) / BN : 0;
    gemm::cp_async_wait<0>();
    __syncthreads();  // D_j^T (and the strip) are in; block j - 1's update of s is done
    // stage q of block column j is k rows k0 + (q % NK) DEPTH of pass q / NK,
    // in buffer q % 2, one cp.async group; the first goes out before X_j is
    // formed
    if (n_pass > 0) {
      gemm::kpanel_async<T, DEPTH, BN, THREADS, VEC>(bs, LDB, ct, m, k0, m, k0 + CB, m, tid);
      gemm::cp_async_commit();
    }
    // X_j = S_j D_j^T, each thread 4 columns of one row (of every 32nd),
    // written to X_j^T in region R; s takes X_j after the barrier
#pragma unroll 1
    for (int row = xr; row < RS; row += 32) {
      T x[4] = {T(0), T(0), T(0), T(0)};
      const T* srow = s + row * ld + k0;
#pragma unroll 4
      for (int kk = 0; kk < CB; ++kk) {
        T d[4];
#pragma unroll
        for (int q = 0; q < 4; q += CH) gemm::lds16(ds + kk * LDD + xc + q, d + q);
        const T sv = srow[kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = fma(sv, d[q], x[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) rr[(xc + q) * LDX + row] = x[q];  // X_j^T, k-major for the update
    }
    __syncthreads();  // every read of S_j and D_j^T is done
    load_d(j + 1);
    for (int row = xr; row < RS; row += 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[row * ld + k0 + xc + q] = rr[(xc + q) * LDX + row];
    }
    // S[:, c] -= sum_k X_j[:, k] C[c, k0 + k] for the columns c >= k0 + CB
    for (int p = 0; p < n_pass; ++p) {
      const int n0 = k0 + CB + p * BN;
      gemm::zero<TL>(acc);
      if (!S::AHEAD && p > 0) {  // the tall strip: a later pass issues its first stage here
        gemm::kpanel_async<T, DEPTH, BN, THREADS, VEC>(bs + ((p * NK) & 1) * DEPTH * LDB, LDB, ct, m, k0, m, n0,
                                                        m, tid);
        gemm::cp_async_commit();
      }
      // two stages an iteration: the tall strip then fits 128 registers without spills
#pragma unroll 2
      for (int kt = 0; kt < NK; ++kt) {
        const int q = p * NK + kt;
        // stage 0 is followed by D_{j+1}^T's group; every later stage was
        // the last group issued
        if (q == 0) {
          gemm::cp_async_wait<1>();
        } else {
          gemm::cp_async_wait<0>();
        }
        __syncthreads();  // stage q (and, first, X_j^T) is in; every thread is done with stage q - 1
        // stage q + 1: the next k rows of this pass or, ahead, the first of the next pass
        const int kn = (kt + 1) % NK, dp = (kt + 1) / NK;
        if (S::AHEAD ? p + dp < n_pass : dp == 0) {
          gemm::kpanel_async<T, DEPTH, BN, THREADS, VEC>(bs + ((q + 1) & 1) * DEPTH * LDB, LDB, ct, m,
                                                          k0 + kn * DEPTH, m, n0 + dp * BN, m, tid);
          gemm::cp_async_commit();
        }
        gemm::mma_live<TL, DEPTH>(t, rr + kt * DEPTH * LDX, LDX, bs + (q & 1) * DEPTH * LDB, LDB, acc, m - n0);
      }
#pragma unroll
      for (int i = 0; i < 2 * V; ++i) {
        const int row = t.row(i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + t.col(h * V);
          if (col < m) {
            VecV* ptr = reinterpret_cast<VecV*>(s + row * ld + col);
            VecV v = *ptr;
#pragma unroll
            for (int e = 0; e < V; ++e) v.v[e] -= acc[i][h * V + e];
            *ptr = v;
          }
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace strip
}  // namespace
