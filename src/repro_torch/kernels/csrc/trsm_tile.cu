// Right triangular solve X L^T = B for a stack of (L, B) tile pairs (TRSM).
//
// Replaces: repro/kernels/trsm_tile.py::_trsm_kernel (through trsm), which
// the JAX executor vmaps over the panel tasks of a level with a different
// diagonal factor L_JJ for each task.  This kernel therefore takes a
// (G, m, m) stack of L beside the (G, m, m) stack of B, one call per level.
// The Pallas kernel computes in float32 even for float64 operands; this
// kernel keeps the operand type (float or double), which is at least as
// accurate.  float32 is IEEE FFMA on the CUDA cores (no TF32, no HMMA).
//
// What bounds it on the H100: at the panel of a large level, FP32 issue
// rate.  A tile is m^3 FLOP (134 MFLOP at m = 512) over 3 MiB of traffic, 45
// FLOP per byte, above the 20 FLOP/byte balance point of FP32 on the CUDA
// cores (data sheet: 67 TFLOP/s over 3.35 TB/s).  But most of the main path's
// launches are small: a cold gp_16k call solves panels of G = 31, 30, ..., 1
// tiles and a sliding-window step 32 launches of G = 1, whose bound (2 us at
// G = 1) is far below the latency of a column sweep.  So the design is for
// latency at small G and for throughput at large G, from one code path.
//
// Design: the strip solve of strip_solve.cuh, the carry kernel's phase 2
// without its phase 1.  Two launches on the caller's stream:
//   strip::prep   L transposed (Lt, for k-major streaming) and the inverted
//                 32 x 32 diagonal blocks (Dt) into the caller's workspace,
//                 one CTA per 32 x 32 block of L's lower triangle;
//   trsm_kernel   one 256-thread CTA per (task, strip of RS rows of B): the
//                 strip goes into shared memory by cp.async, is solved in
//                 place right-looking on the register-blocked FFMA core
//                 (X_j = S_j D_j^T, then S -= X_j L[>j, j]^T), and leaves with
//                 16-byte stores.
// The strip height is chosen by the launcher from G and m: the tallest strip
// (32, 16 or 8 rows in float32, 16 or 8 in float64) whose grid G ceil(m / RS)
// still covers the card's SMs, where none does the shortest, among those that
// fit shared memory.  So G = 1 at m = 512 runs 64 CTAs of 8 rows, where one
// tall strip per 64 rows would run 8 CTAs, and G = 31 runs 496 CTAs of 32
// rows, two an SM.  A strip shorter than its type's tallest streams Lt in
// stages of SHORT_DEPTH = 32 rows, one a pass, where they fit (else of 8):
// its FMAs per stage are few, so the barriers and the stream's latency are
// what it waits on, and fewer, deeper stages cut both.  The tile range is the
// strip solve's: m <= 6816 (float32) and 3168 (float64); trsm_max_m reports
// it and the Python wrapper refuses a larger tile with ValueError.
#include "common.cuh"
#include "strip_solve.cuh"

namespace {

using strip::BK;
using strip::CB;
using strip::THREADS;

// Rows of k in a stage of Lt on a strip shorter than its type's tallest.
constexpr int SHORT_DEPTH = 32;

template <typename T, int RS, int DEPTH, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) trsm_kernel(
    const T* __restrict__ b_stack, const T* __restrict__ lt_stack, const T* __restrict__ dt_stack,
    T* __restrict__ x_stack, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const strip::Smem<T, RS, DEPTH> sm(smem_raw, m);
  const int strips = (m + RS - 1) / RS;
  const int g = blockIdx.x / strips, r0 = (blockIdx.x % strips) * RS;
  const int nb = (m + CB - 1) / CB;
  const size_t mm = static_cast<size_t>(m) * m;
  const int tid = threadIdx.x;
  strip::load_rows<T, RS, VEC>(sm.s, sm.ld, b_stack + g * mm, m, r0, tid);
  gemm::cp_async_commit();
  strip::solve<T, RS, DEPTH, VEC>(sm, lt_stack + g * mm, dt_stack + static_cast<size_t>(g) * nb * CB * CB, m, tid);
  strip::store_rows<T, RS, VEC>(x_stack + (blockIdx.x / strips) * mm, sm.s, sm.ld, m, r0, tid);
}

// Whether a strip of RS rows streams Lt in stages of SHORT_DEPTH rows at tile
// size m: shorter than its type's tallest, and they fit.
template <typename T, int RS>
bool deep(int m) {
  if constexpr (RS < strip::TALLEST<T>) return strip::Strip<T, RS, SHORT_DEPTH>::fits(m);
  return false;
}

// Whether strip height rs streams the short strips' pipeline at tile size m.
template <typename T>
bool deep_at(int rs, int m) {
  bool d = false;
  strip::with_rows<T>(rs, [&](auto r) -> cudaError_t {
    d = deep<T, decltype(r)::value>(m);
    return cudaSuccess;
  });
  return d;
}

template <typename T, int RS, int DEPTH>
cudaError_t run(const T* l, const T* b, T* lt, T* dt, T* x, int n_tiles, int m, bool vec, cudaStream_t st) {
  const size_t bytes = strip::Strip<T, RS, DEPTH>::bytes(m);
  const long long blocks = static_cast<long long>(n_tiles) * ((m + RS - 1) / RS);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = vec ? trsm_kernel<T, RS, DEPTH, true> : trsm_kernel<T, RS, DEPTH, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  e = strip::launch_prep<T>(l, lt, dt, n_tiles, m, st);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<int>(blocks), THREADS, bytes, st>>>(b, lt, dt, x, m);
  return cudaGetLastError();
}

// vec: 16-byte copies, which need m to be a multiple of 16 / sizeof(T).  lt
// (G, m, m) and dt (G, ceil(m/32), 32, 32) are the caller's workspace.  Past
// the shortest strip's limit the launch is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const void* l, const void* b, void* lt, void* dt, void* x, int n_tiles, int m, int vec, int device,
           void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  if (vec && m % (16 / static_cast<int>(sizeof(T))) != 0) return cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return strip::with_rows<T>(strip::covering<T>(n_tiles, m, sms), [&](auto rs) -> cudaError_t {
    constexpr int RS = decltype(rs)::value;
    const T* lp = static_cast<const T*>(l);
    const T* bp = static_cast<const T*>(b);
    T *ltp = static_cast<T*>(lt), *dtp = static_cast<T*>(dt), *xp = static_cast<T*>(x);
    if constexpr (RS < strip::TALLEST<T>) {
      if (deep<T, RS>(m)) return run<T, RS, SHORT_DEPTH>(lp, bp, ltp, dtp, xp, n_tiles, m, vec, st);
    }
    return run<T, RS, BK>(lp, bp, ltp, dtp, xp, n_tiles, m, vec, st);
  });
}

}  // namespace

REPRO_EXPORT int trsm_f32(const void* l, const void* b, void* lt, void* dt, void* x, int n_tiles, int m, int vec,
                          int device, void* stream) {
  return launch<float>(l, b, lt, dt, x, n_tiles, m, vec, device, stream);
}

REPRO_EXPORT int trsm_f64(const void* l, const void* b, void* lt, void* dt, void* x, int n_tiles, int m, int vec,
                          int device, void* stream) {
  return launch<double>(l, b, lt, dt, x, n_tiles, m, vec, device, stream);
}

// Largest tile size the kernel takes: float32 (f64 == 0) or float64.
REPRO_EXPORT int trsm_max_m(int f64) { return f64 ? strip::max_m<double>() : strip::max_m<float>(); }

// Strip height (rows) of a launch of g tiles of size m on a card of sms SMs;
// 0 past the limit.
REPRO_EXPORT int trsm_strip(long long g, int m, int f64, int sms) {
  return f64 ? strip::covering<double>(g, m, sms) : strip::covering<float>(g, m, sms);
}

// Rows of k in a stage of Lt at strip height rs and tile size m.
REPRO_EXPORT int trsm_depth(int rs, int m, int f64) {
  return (f64 ? deep_at<double>(rs, m) : deep_at<float>(rs, m)) ? SHORT_DEPTH : BK;
}
