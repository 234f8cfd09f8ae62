// Covariance-tile assembly, batched, for the squared-exponential family.
//
// Replaces: repro/kernels/cov_assembly.py::_cov_tile_kernel (through
// cov_tiles), the Pallas kernel behind the ASSEMBLE, CROSS and PRIOR tasks of
// the fused prediction program.
//
// Computes, for every tile t of a stack, the (m x mb) block
//     K[i, j] = v * exp(coef * max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)),
//     coef = -0.5 / l   (the paper's l enters unsquared)
// with a = xa[t] (m, D), b = xb[t] (mb, D), masked by the global indices
// gi = row0[t] + i, gj = col0[t] + j against nvr[t] / nvc[t]:
//   symmetric: gi == gj -> diagval (bitwise v + sigma^2), invalid -> identity;
//   otherwise: invalid -> 0.
// The distance is the reference's expanded form, clamped at 0 (not
// sum (a - b)^2), so that the ports agree on offset data.  Hyperparameters
// arrive as runtime scalars, not compile-time constants as in the Pallas
// kernel, so one build serves every parameter value.
//
// What bounds it on the H100: the writes.  A tile reads 2*m*D values and
// writes m*mb; at m = 512, D = 16 that is 64 KiB in and 1 MiB out (the
// ASSEMBLE launch of gp_16k writes 528 MiB, its CROSS launch 1 GiB), and the
// arithmetic, 2 D FMA-halves and one exponential an element, stays below the
// FP32 and MUFU rates that the card's 3.35 TB/s write stream (data sheet)
// allows, if it is cheap per element.
//
// Design: a CTA of 256 threads computes a 128 x 128 block (64 x 64 in
// float64) on the register-blocked layout of gemm_core.cuh: each thread owns
// (2V) x (2V) outputs (8 x 8 floats) as 2 x 2 sub-tiles of V x V, and computes
// them one row half at a time (V x 2V accumulators), so that a k step reads
// three 16-byte vectors from shared memory for 32 FMAs and three CTAs fit an
// SM (the product is FMA-bound at D = 16: with two CTAs an SM it did not
// overlap the stores).  The block's feature rows are staged k-major once per
// chunk of up to KC features; the k loop runs over D itself, and the row and
// column norms come out of the same staged features.  The epilogue forms d2
// = na + nb - 2 a.b, clamps it, applies the family's functor (float32:
// ex2.approx of (coef log2 e) d2, the scaled coefficient formed on the host;
// float64: exp), the masks and the diagonal pin (skipped for blocks that are
// wholly valid and off the global diagonal), and writes each thread's V
// consecutive columns with one 16-byte streaming store (st.global.cs), so
// that every warp writes four whole 128-byte lines a store.  mb not a
// multiple of the vector takes the scalar-store instantiation.  The family is
// a template parameter (an epilogue functor of d2): only
// SE is built.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "gemm_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TY = 16, TX = 16;  // the thread grid of the product core
constexpr int KC = 32;           // features staged per chunk

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The squared-exponential family as an epilogue functor of d2.  float32 takes
// v 2^((coef log2 e) d2) on the MUFU; float64 keeps exp.
template <typename T>
struct SquaredExp;

template <>
struct SquaredExp<float> {
  float coef_log2e, vertical;
  static SquaredExp make(double coef, double vertical) {
    return {static_cast<float>(coef * 1.4426950408889634), static_cast<float>(vertical)};
  }
  __device__ __forceinline__ float operator()(float d2) const { return vertical * ex2_approx(coef_log2e * d2); }
};

template <>
struct SquaredExp<double> {
  double coef, vertical;
  static SquaredExp make(double coef, double vertical) { return {coef, vertical}; }
  __device__ __forceinline__ double operator()(double d2) const { return vertical * exp(coef * d2); }
};

// One 16-byte streaming store of V consecutive outputs.
__device__ __forceinline__ void store_cs(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_cs(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// The CTA's block is two halves of BM / 2 rows: each thread owns V rows of
// each half by 2V columns, and computes and stores one half after the other,
// so that 32 accumulators (float32) are live at a time and three CTAs share
// an SM (two for float64 and for the scalar stores, which need more
// registers).  Features are staged once when D fits one chunk; past KC, each
// half stages the chunks again.
template <typename T, class F, bool VEC>
__global__ void __launch_bounds__(THREADS, VEC && sizeof(T) == 4 ? 3 : 2) cov_tiles_kernel(
    const T* __restrict__ xa, const T* __restrict__ xb,
    const int* __restrict__ row0, const int* __restrict__ col0,
    const int* __restrict__ nvr, const int* __restrict__ nvc,
    T* __restrict__ out, int m, int mb, int d, F family, T diagval, int symmetric) {
  using TL = gemm::Tile<T, TY, TX>;
  constexpr int V = TL::V, BM = TL::BM, BN = TL::BN, LDA = TL::LDA, LDB = TL::LDB;
  static_assert(BM + BN <= THREADS, "one thread per row and per column norm");
  __shared__ __align__(16) T as[KC * LDA];  // [k][row]
  __shared__ __align__(16) T bs[KC * LDB];  // [k][col]
  __shared__ T na[BM], nb[BN];

  const int rbs = (m + BM - 1) / BM, cbs = (mb + BN - 1) / BN;
  const int t = blockIdx.x / (rbs * cbs), rb = blockIdx.x / cbs % rbs, cb = blockIdx.x % cbs;
  const int r_base = rb * BM, c_base = cb * BN;
  const int tid = threadIdx.x;
  const TL tl(tid);
  const T* xa_t = xa + static_cast<size_t>(t) * m * d;
  const T* xb_t = xb + static_cast<size_t>(t) * mb * d;
  const int gr0 = row0[t] + r_base, gc0 = col0[t] + c_base;  // global index of the block's first row, column
  const int nr = nvr[t], nc = nvc[t];
  // no mask where every entry is valid and, in a symmetric tile, the global diagonal misses the block
  const bool plain = gr0 + BM <= nr && gc0 + BN <= nc && (!symmetric || gr0 >= gc0 + BN || gc0 >= gr0 + BM);
  T* out_t = out + static_cast<size_t>(t) * m * mb;
  const bool one_chunk = d <= KC;

#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    T acc[V][2 * V];
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int j = 0; j < 2 * V; ++j) acc[i][j] = T(0);
    T nrm = T(0);  // half 0: squared norm of row tid (tid < BM) or of column tid - BM
    for (int d0 = 0; d0 < d; d0 += KC) {
      const int kc = d - d0 < KC ? d - d0 : KC;
      if (half == 0 || !one_chunk) {
        __syncthreads();  // the previous chunk is read
        // the block's rows, kc features each, in memory order (contiguous when kc == d)
        for (int e = tid; e < BM * kc; e += THREADS) {
          const int r = e / kc, k = e % kc;
          as[k * LDA + r] = r_base + r < m ? xa_t[static_cast<size_t>(r_base + r) * d + d0 + k] : T(0);
        }
        for (int e = tid; e < BN * kc; e += THREADS) {
          const int c = e / kc, k = e % kc;
          bs[k * LDB + c] = c_base + c < mb ? xb_t[static_cast<size_t>(c_base + c) * d + d0 + k] : T(0);
        }
        __syncthreads();
      }
      if (half == 0) {
        if (tid < BM) {
          for (int k = 0; k < kc; ++k) nrm = fma(as[k * LDA + tid], as[k * LDA + tid], nrm);
        } else if (tid < BM + BN) {
          for (int k = 0; k < kc; ++k) nrm = fma(bs[k * LDB + tid - BM], bs[k * LDB + tid - BM], nrm);
        }
      }
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        T a[V], b[2 * V];
        gemm::ldsv<V>(as + k * LDA + half * (BM / 2) + tl.ty * V, a);
        gemm::ldsv<V>(bs + k * LDB + tl.tx * V, b);
        gemm::ldsv<V>(bs + k * LDB + BN / 2 + tl.tx * V, b + V);
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < 2 * V; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
      }
    }
    if (half == 0) {
      if (tid < BM) {
        na[tid] = nrm;
      } else if (tid < BM + BN) {
        nb[tid - BM] = nrm;
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int r = tl.row(half * V + i);
      if (r_base + r >= m) continue;
      const T nav = na[r];
      const int gi = gr0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tl.col(h * V);
        T k[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const T d2 = fma(T(-2), acc[i][h * V + e], nav + nb[c + e]);
          k[e] = family(d2 < T(0) ? T(0) : d2);
          if (!plain) {
            const int gj = gc0 + c + e;
            const bool on_diag = gi == gj;
            const bool valid = gi < nr && gj < nc;
            if (symmetric) {
              if (on_diag) k[e] = diagval;
              if (!valid) k[e] = on_diag ? T(1) : T(0);
            } else if (!valid) {
              k[e] = T(0);
            }
          }
        }
        T* p = out_t + static_cast<size_t>(r_base + r) * mb + c_base + c;
        if (VEC) {
          if (c_base + c < mb) store_cs(p, k);  // mb is a multiple of V: the vector is whole
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c_base + c + e < mb) __stcs(p + e, k[e]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* xa, const void* xb, const void* row0, const void* col0,
           const void* nvr, const void* nvc, void* out, int n_tiles, int m,
           int mb, int d, double coef, double vertical, double diagval,
           int symmetric, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0 || mb == 0) return cudaSuccess;
  using TL = gemm::Tile<T, TY, TX>;
  const long long blocks =
      static_cast<long long>(n_tiles) * ((m + TL::BM - 1) / TL::BM) * ((mb + TL::BN - 1) / TL::BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte stores need rows of whole vectors and an aligned base
  const bool vec = mb % TL::V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto family = SquaredExp<T>::make(coef, vertical);
  auto kernel = vec ? cov_tiles_kernel<T, SquaredExp<T>, true> : cov_tiles_kernel<T, SquaredExp<T>, false>;
  kernel<<<static_cast<int>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xa), static_cast<const T*>(xb),
      static_cast<const int*>(row0), static_cast<const int*>(col0),
      static_cast<const int*>(nvr), static_cast<const int*>(nvc),
      static_cast<T*>(out), m, mb, d, family, static_cast<T>(diagval), symmetric);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int cov_tiles_f32(const void* xa, const void* xb, const void* row0,
                               const void* col0, const void* nvr, const void* nvc,
                               void* out, int n_tiles, int m, int mb, int d,
                               double coef, double vertical, double diagval,
                               int symmetric, int device, void* stream) {
  return launch<float>(xa, xb, row0, col0, nvr, nvc, out, n_tiles, m, mb, d,
                       coef, vertical, diagval, symmetric, device, stream);
}

REPRO_EXPORT int cov_tiles_f64(const void* xa, const void* xb, const void* row0,
                               const void* col0, const void* nvr, const void* nvc,
                               void* out, int n_tiles, int m, int mb, int d,
                               double coef, double vertical, double diagval,
                               int symmetric, int device, void* stream) {
  return launch<double>(xa, xb, row0, col0, nvr, nvc, out, n_tiles, m, mb, d,
                        coef, vertical, diagval, symmetric, device, stream);
}
