// Covariance-tile assembly, batched, for every registered kernel family.
//
// Replaces: repro/kernels/cov_assembly.py::_cov_tile_kernel (through
// cov_tiles), the Pallas kernel behind the ASSEMBLE, CROSS and PRIOR tasks of
// the fused prediction program, whose body evaluates any family's
// kernel.kfree with the hyperparameters baked in as constants.
//
// Computes, for every tile t of a stack, the (m x mb) block
//     K[i, j] = k(d2(a_i, b_j)),   a = xa[t] (m, D), b = xb[t] (mb, D),
// masked by the global indices gi = row0[t] + i, gj = col0[t] + j against
// nvr[t] / nvc[t]:
//   symmetric: gi == gj -> diagval (bitwise diag + noise of the whole kernel
//              tree for the tile's problem, summed in float64 and rounded
//              once, from the table), invalid -> identity;
//   otherwise: invalid -> 0.
//
// The family.  The host writes the kernel tree as a short sum of products of
// scaled leaves (Scaled multiplies, Product distributes over Sum, White's
// kfree is zero off the pinned diagonal and drops out):
//     k(d2) = sum_t coef_t prod_f leaf_f(d2)
// and passes it as a descriptor in two parts: its structure (Family: the
// kind, the term and factor counts and the leaf ids, at most MAX_TERMS terms
// of MAX_FACTORS factors) as a __grid_constant__ parameter, read in place from
// the constant bank (no copy to local memory), and its reals as a device
// table of P rows of TABLE_W values, one row per problem of a fleet (P = 1
// when the problems share their hyperparameters):
//     coef[MAX_TERMS] | s[NF] | a[NF] | inv_l[MAX_ARD_D] | diag + noise | pad
// so one build serves every composite, every parameter value and every
// fleet, and the hyperparameters never travel through the host.  A tile
// finds its row as t / tiles_per_problem: the flat dispatch of a fleet
// stacks each problem's G tiles together (B * G tiles, problem-major), so
// the launch puts the problem on the grid's y axis and the tile's row is
// blockIdx.y, with no per-tile problem index to build and read on every
// launch (and no integer division in the kernel: computing t / G there
// cost the float32 kernel 48 bytes of spills at its 80-register cap).  The
// CTA copies its row to shared memory once, before the first barrier; the
// epilogue reads its scalars from there.  The leaves are functions of d2
// alone:
//     SE   exp(-d2 / (2 l))
//     M12  exp(-r),                        r = sqrt(d2 / l)
//     M32  (1 + r) exp(-r),                r = sqrt(3 d2 / l)
//     M52  (1 + r + r^2 / 3) exp(-r),      r = sqrt(5 d2 / l)
//     RQ   exp(-alpha log(1 + d2 / (2 alpha l)))   (the reference's form)
// with sqrt(0) = 0 (the forward of _safe_sqrt).  float32 takes exp, sqrt and
// log on the MUFU (ex2/sqrt/lg2.approx, the SE scale times log2 e formed with
// the table); float64 keeps exp, sqrt and log.  A kernel of one scaled leaf
// takes that leaf's tight epilogue; anything else takes the generic loop
// over the descriptor.
//
// The distance.  Isotropic families use the reference's expanded form
// |a|^2 + |b|^2 - 2 a.b, clamped at 0 (not sum (a - b)^2), so that the ports
// agree on offset data.  ARD (per-dimension lengthscales) computes what the
// Pallas body computes, sum_d (a_d - b_d)^2 / l_d in the difference form, in
// its own instantiation (ARD = true, inverse lengthscales in the table,
// at most MAX_ARD_D features); its leaf is SE with l = 1.  The plain torch
// version scales the features by 1/sqrt(l) and takes the expanded form, so
// on data far from the origin the two differ by the expanded form's
// cancellation (ROADMAP.md section 3).  A composite that mixes an ARD leaf
// with isotropic leaves, or two ARD leaves with different lengthscales, runs
// one launch per distance and the wrapper combines the tiles
// (kernels/cov_assembly.py); every other kernel runs in one launch.
//
// What bounds it on the H100: the writes.  A tile reads 2*m*D values and
// writes m*mb; at m = 512, D = 16 that is 64 KiB in and 1 MiB out (the
// ASSEMBLE launch of gp_16k writes 528 MiB, its CROSS launch 1 GiB), and the
// arithmetic, D FMAs an element plus the family's epilogue (SE: one FMUL and
// one MUFU; Matérn: three MUFU), stays below the FP32 and MUFU rates that the
// card's 3.35 TB/s write stream (data sheet) allows only if it is cheap per
// element.
//
// Design: a CTA of 256 threads computes a 128 x 128 block (64 x 64 in
// float64) on the register-blocked layout of gemm_core.cuh: each thread owns
// (2V) x (2V) outputs (8 x 8 floats) as 2 x 2 sub-tiles of V x V, and computes
// them one row half at a time (V x 2V accumulators), so that a k step reads
// three 16-byte vectors from shared memory for 32 FMAs and three CTAs fit an
// SM (the product is FMA-bound at D = 16: with two CTAs an SM it did not
// overlap the stores).  The block's feature rows are staged k-major once per
// chunk of up to KC features; the k loop runs over D itself, and the row and
// column norms come out of the same staged features.  The epilogue turns the
// accumulators into d2 in place, applies the family to all of them (one
// switch per half on the descriptor's kind, so the tight leaf loops carry no
// per-element branch), then the masks and the diagonal pin (skipped for blocks
// wholly valid and off the global diagonal), and writes each thread's V
// consecutive columns with one 16-byte streaming store (st.global.cs), so
// that every warp writes four whole 128-byte lines a store.  mb not a
// multiple of the vector takes the scalar-store instantiation.  (Fusing the
// family into the store loop, one instantiation per leaf, spilled at the
// 80-register cap of three CTAs an SM.)
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "gemm_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TY = 16, TX = 16;  // the thread grid of the product core
constexpr int KC = 32;           // features staged per chunk

// The descriptor's limits and the leaf ids (core/kernels_math.py writes the same numbers).
constexpr int MAX_TERMS = 4, MAX_FACTORS = 3, MAX_ARD_D = 64;
constexpr int N_INTS = 2 + MAX_TERMS + MAX_TERMS * MAX_FACTORS;
enum Leaf : int { SE = 0, M12 = 1, M32 = 2, M52 = 3, RQ = 4, COMPOSITE = 5 };

// One row of the table of reals (kernels_math.DESC_* write the same columns).
constexpr int NF = MAX_TERMS * MAX_FACTORS;
constexpr int COEF = 0, S = MAX_TERMS, A = S + NF, INV_L = A + NF, DIAG = INV_L + MAX_ARD_D;
constexpr int TABLE_W = 96;  // DIAG + 1, padded to whole 16-byte vectors
static_assert(DIAG < TABLE_W && TABLE_W + 4 <= THREADS, "one thread a column of the row, four for the tile's meta");

// The structure of the kernel tree; its reals are the table's columns
//   coef[t]       the term's coefficient,
//   s[t][q]       the leaf's distance scale (see leaf()),
//   a[t][q]       RQ's -alpha,
//   inv_l[k]      ARD's 1 / l_k,
//   diag          diag + noise, the symmetric tiles' global diagonal.
struct Family {
  int kind;     // a single scaled leaf (SE ... RQ: coef[0], s[0], a[0]) or COMPOSITE
  int n_terms;  // COMPOSITE: sum over n_terms of coef[t] prod_q leaf(fam[t][q])
  int nf[MAX_TERMS];
  int fam[NF];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp, sqrt and log of the leaves: float32 on the MUFU, float64 in IEEE double.
template <typename T>
struct Math;

template <>
struct Math<float> {
  static constexpr bool kLog2 = true;  // scales of exponentials carry log2 e (host)
  __device__ static __forceinline__ float exp_scaled(float x) { return ex2_approx(x); }
  __device__ static __forceinline__ float exp_neg(float r) { return ex2_approx(-1.4426950408889634f * r); }
  __device__ static __forceinline__ float root(float x) { return sqrt_approx(x); }
  __device__ static __forceinline__ float pow_scaled(float base, float a) { return ex2_approx(a * lg2_approx(base)); }
};

template <>
struct Math<double> {
  static constexpr bool kLog2 = false;
  __device__ static __forceinline__ double exp_scaled(double x) { return exp(x); }
  __device__ static __forceinline__ double exp_neg(double r) { return exp(-r); }
  __device__ static __forceinline__ double root(double x) { return sqrt(x); }
  __device__ static __forceinline__ double pow_scaled(double base, double a) { return exp(a * log(base)); }
};

// One leaf at d2, without its coefficient.  s: SE -1/(2 l) (float32: times
// log2 e); Matérn nu: (2 nu) / l, so r = sqrt(s d2); RQ: 1 / (2 alpha l).
template <int L, typename T>
__device__ __forceinline__ T leaf(T d2, T s, T a) {
  using M = Math<T>;
  if (L == SE) return M::exp_scaled(s * d2);
  if (L == RQ) return M::pow_scaled(fma(s, d2, T(1)), a);
  const T r = M::root(s * d2);
  const T e = M::exp_neg(r);
  if (L == M12) return e;
  if (L == M32) return (T(1) + r) * e;
  return fma(r, fma(r, T(1) / T(3), T(1)), T(1)) * e;  // M52
}

// The generic sum of products, for COMPOSITE; tab is the problem's row in shared memory.
template <typename T>
__device__ __forceinline__ T composite(const Family& f, const T* tab, T d2) {
  T sum = T(0);
#pragma unroll 1
  for (int t = 0; t < f.n_terms; ++t) {
    T prod = tab[COEF + t];
#pragma unroll 1
    for (int q = 0; q < f.nf[t]; ++q) {
      const int i = t * MAX_FACTORS + q;
      const T s = tab[S + i], a = tab[A + i];
      switch (f.fam[i]) {
        case SE: prod *= leaf<SE>(d2, s, a); break;
        case M12: prod *= leaf<M12>(d2, s, a); break;
        case M32: prod *= leaf<M32>(d2, s, a); break;
        case M52: prod *= leaf<M52>(d2, s, a); break;
        default: prod *= leaf<RQ>(d2, s, a); break;
      }
    }
    sum += prod;
  }
  return sum;
}

template <int L, typename T, int R, int C>
__device__ __forceinline__ void apply_leaf(const T* tab, T (&k)[R][C]) {
  const T c = tab[COEF], s = tab[S], a = tab[A];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) k[i][j] = c * leaf<L>(k[i][j], s, a);
}

// d2 -> the family's value, in place; one branch on the kind for the whole block.
template <typename T, int R, int C>
__device__ __forceinline__ void apply_family(const Family& f, const T* tab, T (&k)[R][C]) {
  switch (f.kind) {
    case SE: apply_leaf<SE>(tab, k); break;
    case M12: apply_leaf<M12>(tab, k); break;
    case M32: apply_leaf<M32>(tab, k); break;
    case M52: apply_leaf<M52>(tab, k); break;
    case RQ: apply_leaf<RQ>(tab, k); break;
    default:
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) k[i][j] = composite(f, tab, k[i][j]);
  }
}

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
template <typename T, bool VEC, bool ARD>
__global__ void __launch_bounds__(THREADS, VEC && sizeof(T) == 4 ? 3 : 2) cov_tiles_kernel(
    const T* __restrict__ xa, const T* __restrict__ xb,
    const int* __restrict__ row0, const int* __restrict__ col0,
    const int* __restrict__ nvr, const int* __restrict__ nvc,
    T* __restrict__ out, int m, int mb, int d, const __grid_constant__ Family family,
    const T* __restrict__ table, int tiles_per_problem, int symmetric) {
  using TL = gemm::Tile<T, TY, TX>;
  constexpr int V = TL::V, BM = TL::BM, BN = TL::BN, LDA = TL::LDA, LDB = TL::LDB;
  static_assert(BM + BN <= THREADS, "one thread per row and per column norm");
  __shared__ __align__(16) T as[KC * LDA];  // [k][row]
  __shared__ __align__(16) T bs[KC * LDB];  // [k][col]
  __shared__ T na[BM], nb[BN];
  __shared__ __align__(16) T tab[TABLE_W];  // this tile's problem's row of reals
  __shared__ int meta[4];                   // the tile's row0, col0, nvr, nvc

  const int rbs = (m + BM - 1) / BM, cbs = (mb + BN - 1) / BN;
  // blockIdx.y is the tile's problem (its row of the table), blockIdx.x the block within the problem's tiles
  const int t = blockIdx.y * tiles_per_problem + blockIdx.x / (rbs * cbs);
  const int rb = blockIdx.x / cbs % rbs, cb = blockIdx.x % cbs;
  const int r_base = rb * BM, c_base = cb * BN;
  const int tid = threadIdx.x;
  const TL tl(tid);
  // The problem's row of reals and the tile's offsets and frontiers go to shared memory, read after
  // the first barrier below (the d0 loop's, which every CTA passes before any use): held in registers
  // across the product they would push the float32 kernel past its 80-register cap.
  if (tid < TABLE_W) {
    tab[tid] = table[static_cast<size_t>(blockIdx.y) * TABLE_W + tid];
  } else if (tid < TABLE_W + 4) {
    const int w = tid - TABLE_W;
    meta[w] = (w == 0 ? row0 : w == 1 ? col0 : w == 2 ? nvr : nvc)[t];
  }
  const T* xa_t = xa + static_cast<size_t>(t) * m * d;
  const T* xb_t = xb + static_cast<size_t>(t) * mb * d;
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
      if (!ARD && half == 0) {
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
        if (ARD) {
          // sum_d (a_d - b_d)^2 / l_d, the Pallas body's difference form
          const T il = tab[INV_L + d0 + k];
#pragma unroll
          for (int i = 0; i < V; ++i)
#pragma unroll
            for (int j = 0; j < 2 * V; ++j) {
              const T df = a[i] - b[j];
              acc[i][j] = fma(df * il, df, acc[i][j]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
#pragma unroll
            for (int j = 0; j < 2 * V; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
      }
    }
    if (!ARD && half == 0) {
      if (tid < BM) {
        na[tid] = nrm;
      } else if (tid < BM + BN) {
        nb[tid - BM] = nrm;
      }
      __syncthreads();
    }

    if (!ARD) {
      // d2 = |a|^2 + |b|^2 - 2 a.b, clamped at 0, in place (ARD's accumulator already is d2)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const T nav = na[tl.row(half * V + i)];
#pragma unroll
        for (int j = 0; j < 2 * V; ++j) {
          const T d2 = fma(T(-2), acc[i][j], nav + nb[tl.col(j)]);
          acc[i][j] = d2 < T(0) ? T(0) : d2;
        }
      }
    }
    apply_family(family, tab, acc);
    const T diagval = tab[DIAG];
    const int gr0 = meta[0] + r_base, gc0 = meta[1] + c_base;  // global index of the block's first row, column
    const int nr = meta[2], nc = meta[3];
    // no mask where every entry is valid and, in a symmetric tile, the global diagonal misses the block
    const bool plain = gr0 + BM <= nr && gc0 + BN <= nc && (!symmetric || gr0 >= gc0 + BN || gc0 >= gr0 + BM);
    T* out_t = out + static_cast<size_t>(t) * m * mb;

#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int r = tl.row(half * V + i);
      if (r_base + r >= m) continue;
      const int gi = gr0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tl.col(h * V);
        T k[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          k[e] = acc[i][h * V + e];
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

Family make_family(const int* ints) {
  Family f{};
  f.kind = ints[0];
  f.n_terms = ints[1];
  for (int t = 0; t < MAX_TERMS; ++t) f.nf[t] = ints[2 + t];
  for (int i = 0; i < NF; ++i) f.fam[i] = ints[2 + MAX_TERMS + i];
  return f;
}

template <typename T>
int launch(const void* xa, const void* xb, const void* row0, const void* col0,
           const void* nvr, const void* nvc, void* out, int n_tiles, int m,
           int mb, int d, const int* ints, const void* table, int n_problems, int ard,
           int symmetric, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0 || mb == 0) return cudaSuccess;
  if (ard && d > MAX_ARD_D) return cudaErrorInvalidValue;
  if (n_problems < 1 || n_problems > 65535 || n_tiles % n_problems != 0) return cudaErrorInvalidValue;
  using TL = gemm::Tile<T, TY, TX>;
  const int tiles_per_problem = n_tiles / n_problems;
  const long long blocks = static_cast<long long>(tiles_per_problem) * ((m + TL::BM - 1) / TL::BM) *
                           ((mb + TL::BN - 1) / TL::BN);  // a problem's blocks: the grid's x
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte stores need rows of whole vectors and an aligned base
  const bool vec = mb % TL::V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Family family = make_family(ints);
  auto kernel = ard ? (vec ? cov_tiles_kernel<T, true, true> : cov_tiles_kernel<T, false, true>)
                    : (vec ? cov_tiles_kernel<T, true, false> : cov_tiles_kernel<T, false, false>);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_problems));
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xa), static_cast<const T*>(xb),
      static_cast<const int*>(row0), static_cast<const int*>(col0),
      static_cast<const int*>(nvr), static_cast<const int*>(nvc),
      static_cast<T*>(out), m, mb, d, family, static_cast<const T*>(table), tiles_per_problem, symmetric);
  return cudaGetLastError();
}

}  // namespace

// Resident CTAs an SM of the float32 vector-store instantiation (isotropic or ARD distance).
REPRO_EXPORT int cov_tiles_f32_ctas_per_sm(int ard) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ard ? cov_tiles_kernel<float, true, true> : cov_tiles_kernel<float, true, false>, THREADS, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The descriptor's limits, for the wrapper to check against its own.
REPRO_EXPORT int cov_tiles_limits(int which) {
  return which == 0 ? MAX_TERMS : which == 1 ? MAX_FACTORS : which == 2 ? MAX_ARD_D : which == 3 ? N_INTS
         : which == 4 ? TABLE_W : DIAG;
}

REPRO_EXPORT int cov_tiles_f32(const void* xa, const void* xb, const void* row0,
                               const void* col0, const void* nvr, const void* nvc,
                               void* out, int n_tiles, int m, int mb, int d,
                               const int* ints, const void* table, int n_problems, int ard,
                               int symmetric, int device, void* stream) {
  return launch<float>(xa, xb, row0, col0, nvr, nvc, out, n_tiles, m, mb, d,
                       ints, table, n_problems, ard, symmetric, device, stream);
}

REPRO_EXPORT int cov_tiles_f64(const void* xa, const void* xb, const void* row0,
                               const void* col0, const void* nvr, const void* nvc,
                               void* out, int n_tiles, int m, int mb, int d,
                               const int* ints, const void* table, int n_problems, int ard,
                               int symmetric, int device, void* stream) {
  return launch<double>(xa, xb, row0, col0, nvr, nvc, out, n_tiles, m, mb, d,
                        ints, table, n_problems, ard, symmetric, device, stream);
}
