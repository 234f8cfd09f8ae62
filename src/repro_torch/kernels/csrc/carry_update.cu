// Fused carry transform of the blocked rank update: O = (W - L Y) C^{-T}.
//
// Replaces: repro/kernels/downdate_tile.py::_carry_kernel (through
// carry_update / carry_update_batched), which the JAX executor's UCARRY op
// runs once per column of the cholupdate sweep, W_i <- (W_i - L'(i,j) Y_j)
// C_j^{-T}, over a stack of G carry tasks.  Like the Pallas kernel, it
// computes the product and the right triangular solve X C^T = B in one pass
// and never writes the residual B = W - L Y to device memory.  float32 is
// IEEE float32 FMA on the CUDA cores (never TF32); float64 stays float64.
// Edges are masked, so any m works up to the shared-memory limit below.
//
// What bounds it on the H100: FP32 operations.  A task is 3 m^3 FLOP (2 m^3
// for L Y, m^3 for the solve): 4.0e8 at m = 512, over 5 MiB of traffic,
// about 77 FLOP per byte, four times the card's FP32 balance point (data
// sheet: 67 TFLOP/s outside the tensor cores over 3.35 TB/s).  The largest
// launch of an eviction at gp_16k (G = 31) does 1.25e10 FLOP, at least
// 0.19 ms.
//
// Design: two launches on the caller's stream.
//
// carry_prep, one 256-thread block per (task, 32-column block j of C):
// writes C's column block j transposed into the workspace Ct (row j*32 + k
// of Ct holds C[:, j*32 + k], so the solve streams C's rows k-major with
// 16-byte copies), and inverts the diagonal block C_jj (padded with the
// identity past m): lane c of one warp runs the forward substitution of
// column c, and writes row c of D_j^T = C_jj^{-T} to the workspace Dt.
//
// carry_kernel, one 256-thread block per (task, strip of RS rows of W).  The
// rows of X in X C^T = B are independent, so a strip needs only its own rows
// of W and L and the whole of Y and C (read through L2).  Both phases run on
// the register-blocked product core of gemm_core.cuh, (2V) x (2V)
// accumulators per thread (8 x 8 float, 4 x 4 double on the tall strips) over
// an RS x BN pass (BN = 256 x 2V / TY):
//   phase 1  the strip of B = W - L Y into shared memory.  Y is already
//            k-major and streams with cp.async; the strip's L rows go through
//            registers and are written transposed.  Two buffers, 8-deep
//            stages, one barrier per stage;
//   phase 2  right-looking, 32 columns at a time: X_j = S_j D_j^T (a small
//            product on all threads), then the columns to the right take
//            S -= X_j C[>j, j]^T, a product of depth 32 with X_j^T staged in
//            shared memory and Ct streamed like Y.  A warp skips the FMAs of
//            a column half that lies wholly past m, so the update's work
//            shrinks with the columns left.  D_{j+1}^T is copied while block
//            j's update runs, and the update's first C stage while X_j is
//            formed, so neither copy waits in the open.
// The strip is RS rows: 32 (float32) or 16 (float64) wherever it fits in
// shared memory, which takes every tile up to m = 1472 (float32) and 1440
// (float64), and gives two CTAs an SM at m = 512 (float32: 108,288 bytes of
// shared memory and 128 registers per CTA).  A larger tile takes a shorter
// strip, chosen by the launcher from Strip<T, RS>::bytes(m): 16 and then 8
// rows (float32), 8 rows (float64), with thread tiles of (2V) x (2V), V =
// min(RS / 8, one 16-byte vector), so that a warp still covers 4 x 8
// threads of the product core.  That takes m up to 6816 (float32) and 3168
// (float64); carry_update_max_m reports the limit, and the Python wrapper
// refuses a larger tile with ValueError.  The wrapper picks the load width
// (16-byte vectors when m is a multiple of 16 / sizeof(T), else the
// scalar-load instantiation).
#include <climits>
#include <type_traits>

#include "common.cuh"
#include "gemm_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CB = 32;  // the solve's column block
constexpr int BK = 8;   // depth of a streamed stage
constexpr size_t MAX_SMEM = 232448;

template <typename T, int RS>
struct Strip {
  static constexpr int CH = 16 / sizeof(T);              // elements of a 16-byte copy
  static constexpr int V = RS / 8 < CH ? RS / 8 : CH;     // thread-tile vector: TY = RS / (2V) >= 4
  static constexpr int TY = RS / (2 * V);
  using TL = gemm::Tile<T, TY, THREADS / TY, V>;
  static constexpr int BN = TL::BN;
  static constexpr int LDB = BN + CH;               // pitch of the streamed panel (16-byte rows)
  static constexpr int LDX = RS + V;                // pitch of region R: [k][strip row]
  static constexpr int LDD = CB + CH;               // pitch of D_j^T
  static constexpr int B_ELEMS = 2 * BK * LDB;      // two stages of the streamed panel
  static constexpr int R_ELEMS = CB * LDX;          // phase 1's L stages, then X_j^T
  static constexpr int D_ELEMS = CB * LDD;          // D_j^T
  static_assert(2 * BK <= CB, "the L stages fit in region R");
  // pitch of the strip: a multiple of 32 elements plus 4, so the rows that a
  // warp reads in the same column fall in different banks
  __host__ __device__ static int lds(int m) { return (m + 31) / 32 * 32 + 4; }
  __host__ __device__ static size_t bytes(int m) {
    return (static_cast<size_t>(RS) * lds(m) + B_ELEMS + R_ELEMS + D_ELEMS) * sizeof(T);
  }
  static bool fits(int m) { return bytes(m) <= MAX_SMEM; }
};

// Call f(std::integral_constant<int, RS>) with the tallest strip that fits
// tile size m: 32, 16 or 8 rows (float32), 16 or 8 (float64).
template <typename T, typename F>
cudaError_t with_strip(int m, F&& f) {
  constexpr int TALL = sizeof(T) == 4 ? 32 : 16;
  if (Strip<T, TALL>::fits(m)) return f(std::integral_constant<int, TALL>{});
  if constexpr (TALL == 32) {
    if (Strip<T, 16>::fits(m)) return f(std::integral_constant<int, 16>{});
  }
  if (Strip<T, 8>::fits(m)) return f(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

// Ct = C^T on and below the diagonal blocks, Dt[j] = C_jj^{-T}, for one (task, block column j).
template <typename T>
__global__ void __launch_bounds__(THREADS) carry_prep(const T* __restrict__ c_stack, T* __restrict__ ct_stack,
                                                      T* __restrict__ dt_stack, int m, int nb) {
  __shared__ T tile[CB][CB + 1];
  const int g = blockIdx.x / nb, j = blockIdx.x % nb;
  const size_t mm = static_cast<size_t>(m) * m;
  const T* c = c_stack + g * mm;
  T* ct = ct_stack + g * mm;
  const int tid = threadIdx.x, k0 = j * CB;
  for (int n0 = k0; n0 < m; n0 += CB) {
    const bool diag = n0 == k0;
    for (int e = tid; e < CB * CB; e += THREADS) {
      const int i = e / CB, k = e % CB;
      const bool in = n0 + i < m && k0 + k < m;
      tile[i][k] = in ? c[static_cast<size_t>(n0 + i) * m + k0 + k] : (diag && i == k ? T(1) : T(0));
    }
    __syncthreads();
    for (int e = tid; e < CB * CB; e += THREADS) {
      const int k = e / CB, i = e % CB;
      if (k0 + k < m && n0 + i < m) ct[static_cast<size_t>(k0 + k) * m + n0 + i] = tile[i][k];
    }
    if (diag && tid < 32) {
      // column `lane` of C_jj^{-1} by forward substitution; it is row `lane` of C_jj^{-T}
      const int lane = tid;
      T z[CB];
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        T v = i == lane ? T(1) : T(0);
#pragma unroll
        for (int q = 0; q < i; ++q) v = fma(-tile[i][q], z[q], v);
        z[i] = v / tile[i][i];
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
    __syncthreads();
  }
}

template <typename T, int RS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) carry_kernel(
    const T* __restrict__ w_stack, const T* __restrict__ l_stack, const T* __restrict__ y_stack,
    const T* __restrict__ ct_stack, const T* __restrict__ dt_stack, T* __restrict__ o_stack, int m) {
  using S = Strip<T, RS>;
  using TL = typename S::TL;
  constexpr int V = S::V, CH = S::CH, BN = S::BN, LDB = S::LDB, LDX = S::LDX, LDD = S::LDD;
  using VecV = gemm::VecN<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = S::lds(m);
  T* s = reinterpret_cast<T*>(smem_raw);   // [RS][ld]: B, then X
  T* bs = s + static_cast<size_t>(RS) * ld;  // [2][BK][LDB]: Y or Ct stages
  T* rr = bs + S::B_ELEMS;                   // region R: [2][BK][LDX] L stages, then [CB][LDX] X_j^T
  T* ds = rr + S::R_ELEMS;                   // [CB][LDD]: D_j^T

  const int strips = (m + RS - 1) / RS;
  const int g = blockIdx.x / strips, r0 = (blockIdx.x % strips) * RS;
  const int nb = (m + CB - 1) / CB;
  const size_t mm = static_cast<size_t>(m) * m;
  const T* w = w_stack + g * mm;
  const T* l = l_stack + g * mm;
  const T* y = y_stack + g * mm;
  const T* ct = ct_stack + g * mm;
  const T* dt = dt_stack + static_cast<size_t>(g) * nb * CB * CB;
  T* o = o_stack + g * mm;
  const int tid = threadIdx.x;
  const TL t(tid);
  const int mpad = (m + CB - 1) / CB * CB;  // s holds zeros in columns [m, mpad)
  T acc[2 * V][2 * V];

  // ---- phase 1: s = W - L Y on the strip's rows (zero past m) ----------
  using LPanel = gemm::RowPanel<T, T, RS, BK, THREADS, VEC>;
  LPanel pl;
  const int nk = (m + BK - 1) / BK;
  for (int n0 = 0; n0 < mpad; n0 += BN) {
    gemm::zero<TL>(acc);
    pl.load(l, m, r0, m, 0, m, tid);
    gemm::kpanel_async<T, BK, BN, THREADS, VEC>(bs, LDB, y, m, 0, m, n0, m, tid);
    gemm::cp_async_commit();
    pl.store(rr, LDX, tid);
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < nk;
      gemm::cp_async_wait<0>();
      __syncthreads();  // stage kt is in; every thread is done with stage kt - 1
      // the next stage's loads (zeros past the last stage) go out before the
      // FMAs; the fence keeps the compiler from sinking them below
      pl.load(l, m, r0, m, (kt + 1) * BK, m, tid);
      if (more) {
        gemm::kpanel_async<T, BK, BN, THREADS, VEC>(bs + (cur ^ 1) * BK * LDB, LDB, y, m, (kt + 1) * BK, m,
                                                     n0, m, tid);
        gemm::cp_async_commit();
      }
      asm volatile("" ::: "memory");
      gemm::mma_live<TL, BK>(t, rr + cur * BK * LDX, LDX, bs + cur * BK * LDB, LDB, acc, m - n0);
      pl.store(rr + (cur ^ 1) * BK * LDX, LDX, tid);
    }
#pragma unroll
    for (int i = 0; i < 2 * V; ++i) {
      const int row = t.row(i), gr = r0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + t.col(h * V);
        if (col >= mpad) continue;
        VecV v;
        const T* wr = w + static_cast<size_t>(gr) * m + col;
        if (VEC && gr < m && col < m) {
          v = *reinterpret_cast<const VecV*>(wr);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v.v[e] = (gr < m && col + e < m) ? wr[e] : T(0);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) v.v[e] -= acc[i][h * V + e];
        *reinterpret_cast<VecV*>(s + row * ld + col) = v;
      }
      asm volatile("" ::: "memory");  // one row of W in registers at a time, beside acc
    }
    __syncthreads();
  }

  // ---- phase 2: X C^T = s, in place, right-looking by 32-column blocks ----
  // cp.async groups in flight: D_{j+1}^T is copied while block j's update
  // runs, and the update's first C stage while X_j = S_j D_j^T is formed.
  const int xr = tid / 8, xc = (tid % 8) * 4;
  auto load_d = [&](int j) {
    for (int e = tid; e < CB * CB / CH; e += THREADS)
      gemm::cp_async16(ds + (e / (CB / CH)) * LDD + (e % (CB / CH)) * CH, dt + j * CB * CB + e * CH, true);
    gemm::cp_async_commit();
  };
  load_d(0);
  for (int j = 0; j < nb; ++j) {
    const int k0 = j * CB;
    const bool update = k0 + CB < m;
    gemm::cp_async_wait<0>();
    __syncthreads();  // D_j^T is in; block j - 1's update of s is done
    if (update) {
      gemm::kpanel_async<T, BK, BN, THREADS, VEC>(bs, LDB, ct, m, k0, m, k0 + CB, m, tid);
      gemm::cp_async_commit();
    }
    // X_j = S_j D_j^T, each thread 4 columns of one or two rows, written to
    // X_j^T in region R (not read here); s takes X_j after the barrier
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
    const bool next_d = j + 1 < nb;
    if (next_d) load_d(j + 1);
    for (int row = xr; row < RS; row += 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[row * ld + k0 + xc + q] = rr[(xc + q) * LDX + row];
    }
    // S[:, c] -= sum_k X_j[:, k] C[c, k0 + k] for the columns c >= k0 + CB
    for (int n0 = k0 + CB; n0 < m; n0 += BN) {
      const bool first = n0 == k0 + CB;
      gemm::zero<TL>(acc);
      if (!first) {
        gemm::kpanel_async<T, BK, BN, THREADS, VEC>(bs, LDB, ct, m, k0, m, n0, m, tid);
        gemm::cp_async_commit();
      }
#pragma unroll
      for (int kt = 0; kt < CB / BK; ++kt) {
        const int cur = kt & 1;
        if (kt == 0 && first && next_d) {
          gemm::cp_async_wait<1>();  // stage 0, not D_{j+1}^T
        } else {
          gemm::cp_async_wait<0>();
        }
        __syncthreads();  // stage kt (and, at kt = 0, X_j^T) is in; stage kt - 1 is done
        if (kt + 1 < CB / BK) {
          gemm::kpanel_async<T, BK, BN, THREADS, VEC>(bs + (cur ^ 1) * BK * LDB, LDB, ct, m,
                                                       k0 + (kt + 1) * BK, m, n0, m, tid);
          gemm::cp_async_commit();
        }
        gemm::mma_live<TL, BK>(t, rr + kt * BK * LDX, LDX, bs + cur * BK * LDB, LDB, acc, m - n0);
      }
#pragma unroll
      for (int i = 0; i < 2 * V; ++i) {
        const int row = t.row(i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + t.col(h * V);
          if (col < m) {
            VecV* p = reinterpret_cast<VecV*>(s + row * ld + col);
            VecV v = *p;
#pragma unroll
            for (int e = 0; e < V; ++e) v.v[e] -= acc[i][h * V + e];
            *p = v;
          }
        }
      }
      __syncthreads();  // the update is in s, and the C stages are free, before the next pass
    }
  }
  __syncthreads();

  // ---- write the strip's valid rows ------------------------------------
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

// vec: 16-byte loads, which need m to be a multiple of 16 / sizeof(T).  ct
// (G, m, m) and dt (G, ceil(m/32), 32, 32) are the caller's workspace.  The
// strip is the tallest that fits m (with_strip); past the shortest, the
// launch is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const void* w, const void* l, const void* y, const void* c, void* ct, void* dt, void* o,
           int n_tiles, int m, int vec, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  if (vec && m % (16 / static_cast<int>(sizeof(T))) != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_strip<T>(m, [&](auto rs) -> cudaError_t {
    constexpr int RS = decltype(rs)::value;
    const size_t bytes = Strip<T, RS>::bytes(m);
    const int nb = (m + CB - 1) / CB, strips = (m + RS - 1) / RS;
    const long long prep_blocks = static_cast<long long>(n_tiles) * nb;
    const long long blocks = static_cast<long long>(n_tiles) * strips;
    if (blocks > INT_MAX || prep_blocks > INT_MAX) return cudaErrorInvalidValue;
    auto kernel = vec ? carry_kernel<T, RS, true> : carry_kernel<T, RS, false>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    carry_prep<T><<<static_cast<int>(prep_blocks), THREADS, 0, st>>>(
        static_cast<const T*>(c), static_cast<T*>(ct), static_cast<T*>(dt), m, nb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<int>(blocks), THREADS, bytes, st>>>(
        static_cast<const T*>(w), static_cast<const T*>(l), static_cast<const T*>(y),
        static_cast<const T*>(ct), static_cast<const T*>(dt), static_cast<T*>(o), m);
    return cudaGetLastError();
  });
}

// The largest tile size m that some strip fits.
template <typename T>
int max_m() {
  int m = 1;
  while (Strip<T, 8>::fits(m + 1)) ++m;
  return m;
}

}  // namespace

REPRO_EXPORT int carry_update_f32(const void* w, const void* l, const void* y, const void* c, void* ct,
                                  void* dt, void* o, int n_tiles, int m, int vec, int device, void* stream) {
  return launch<float>(w, l, y, c, ct, dt, o, n_tiles, m, vec, device, stream);
}

REPRO_EXPORT int carry_update_f64(const void* w, const void* l, const void* y, const void* c, void* ct,
                                  void* dt, void* o, int n_tiles, int m, int vec, int device, void* stream) {
  return launch<double>(w, l, y, c, ct, dt, o, n_tiles, m, vec, device, stream);
}

// Largest tile size the kernel takes: float32 (f64 == 0) or float64.
REPRO_EXPORT int carry_update_max_m(int f64) { return f64 ? max_m<double>() : max_m<float>(); }

// Strip height (rows) the float32 kernel runs at tile size m; 0 past the limit.
REPRO_EXPORT int carry_update_f32_strip(int m) {
  int rows = 0;
  with_strip<float>(m, [&](auto rs) -> cudaError_t {
    rows = decltype(rs)::value;
    return cudaSuccess;
  });
  return rows;
}

// CTAs of the float32 kernel with 16-byte loads that fit on one SM at tile
// size m; a negative CUDA error code on failure.
REPRO_EXPORT int carry_update_f32_ctas_per_sm(int m) {
  int n = 0;
  const cudaError_t err = with_strip<float>(m, [&](auto rs) -> cudaError_t {
    constexpr int RS = decltype(rs)::value;
    const size_t bytes = Strip<float, RS>::bytes(m);
    auto kernel = carry_kernel<float, RS, true>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, bytes);
    return e;
  });
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
