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
// Design: two launches on the caller's stream, both from strip_solve.cuh
// (shared with the TRSM kernel): strip::prep writes C transposed (Ct) and the
// inverted 32 x 32 diagonal blocks (Dt) into the caller's workspace, then
// carry_kernel runs one 256-thread block per (task, strip of RS rows of W).
// The rows of X in X C^T = B are independent, so a strip needs only its own
// rows of W and L and the whole of Y and C (read through L2).  Both phases
// run on the register-blocked product core of gemm_core.cuh, (2V) x (2V)
// accumulators per thread (8 x 8 float, 4 x 4 double on the tall strips) over
// an RS x BN pass (BN = 256 x 2V / TY):
//   phase 1  the strip of B = W - L Y into shared memory.  Y is already
//            k-major and streams with cp.async; the strip's L rows go through
//            registers and are written transposed.  Two buffers, 8-deep
//            stages, one barrier per stage;
//   phase 2  strip::solve, the right-looking solve of X C^T = B on the strip
//            (X_j = S_j D_j^T, then S -= X_j C[>j, j]^T), with two stages of
//            Ct in flight.
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
#include "common.cuh"
#include "strip_solve.cuh"

namespace {

using strip::BK;
using strip::CB;
using strip::THREADS;

template <typename T, int RS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) carry_kernel(
    const T* __restrict__ w_stack, const T* __restrict__ l_stack, const T* __restrict__ y_stack,
    const T* __restrict__ ct_stack, const T* __restrict__ dt_stack, T* __restrict__ o_stack, int m) {
  using S = strip::Strip<T, RS>;
  using TL = typename S::TL;
  constexpr int V = S::V, BN = S::BN, LDB = S::LDB, LDX = S::LDX;
  using VecV = gemm::VecN<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const strip::Smem<T, RS, BK> sm(smem_raw, m);
  T* s = sm.s;    // [RS][ld]: B, then X
  T* bs = sm.bs;  // [2][BK][LDB]: Y stages
  T* rr = sm.rr;  // region R: [2][BK][LDX] L stages
  const int ld = sm.ld;

  const int strips = (m + RS - 1) / RS;
  const int g = blockIdx.x / strips, r0 = (blockIdx.x % strips) * RS;
  const int nb = (m + CB - 1) / CB;
  const size_t mm = static_cast<size_t>(m) * m;
  const T* w = w_stack + g * mm;
  const T* l = l_stack + g * mm;
  const T* y = y_stack + g * mm;
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

  // ---- phase 2: X C^T = s, in place; then the strip's valid rows out ------
  strip::solve<T, RS, BK, VEC>(sm, ct_stack + g * mm, dt_stack + static_cast<size_t>(g) * nb * CB * CB, m, tid);
  strip::store_rows<T, RS, VEC>(o, s, ld, m, r0, tid);
}

// vec: 16-byte loads, which need m to be a multiple of 16 / sizeof(T).  ct
// (G, m, m) and dt (G, ceil(m/32), 32, 32) are the caller's workspace.  The
// strip is the tallest that fits m (strip::tallest_fit); past the shortest,
// the launch is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const void* w, const void* l, const void* y, const void* c, void* ct, void* dt, void* o,
           int n_tiles, int m, int vec, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  if (vec && m % (16 / static_cast<int>(sizeof(T))) != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return strip::with_rows<T>(strip::tallest_fit<T>(m), [&](auto rs) -> cudaError_t {
    constexpr int RS = decltype(rs)::value;
    const size_t bytes = strip::Strip<T, RS>::bytes(m);
    const long long blocks = static_cast<long long>(n_tiles) * ((m + RS - 1) / RS);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    auto kernel = vec ? carry_kernel<T, RS, true> : carry_kernel<T, RS, false>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    e = strip::launch_prep<T>(static_cast<const T*>(c), static_cast<T*>(ct), static_cast<T*>(dt), n_tiles, m, st);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<int>(blocks), THREADS, bytes, st>>>(
        static_cast<const T*>(w), static_cast<const T*>(l), static_cast<const T*>(y),
        static_cast<const T*>(ct), static_cast<const T*>(dt), static_cast<T*>(o), m);
    return cudaGetLastError();
  });
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
REPRO_EXPORT int carry_update_max_m(int f64) { return f64 ? strip::max_m<double>() : strip::max_m<float>(); }

// Strip height (rows) the float32 kernel runs at tile size m; 0 past the limit.
REPRO_EXPORT int carry_update_f32_strip(int m) { return strip::tallest_fit<float>(m); }

// CTAs of the float32 kernel with 16-byte loads that fit on one SM at tile
// size m; a negative CUDA error code on failure.
REPRO_EXPORT int carry_update_f32_ctas_per_sm(int m) {
  int n = 0;
  const cudaError_t err = strip::with_rows<float>(strip::tallest_fit<float>(m), [&](auto rs) -> cudaError_t {
    constexpr int RS = decltype(rs)::value;
    const size_t bytes = strip::Strip<float, RS>::bytes(m);
    auto kernel = carry_kernel<float, RS, true>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, bytes);
    return e;
  });
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
