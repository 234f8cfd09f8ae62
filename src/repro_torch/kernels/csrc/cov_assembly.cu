// Covariance-tile assembly for the squared-exponential kernel, batched.
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
// Hyperparameters arrive as runtime scalars, not compile-time constants as in
// the Pallas kernel, so one build serves every parameter value.
//
// What bounds it on the H100: the writes.  A tile reads 2*m*D values and
// writes m*mb; at m = 512, D = 16 that is 64 KiB in and 1 MiB out, and the
// arithmetic (2*D FLOP + one exp per element) stays below the FP32 rate that
// the card's 3.35 TB/s write stream (data sheet) allows.  The design computes each
// 64 x 64 sub-block from feature rows staged once in shared memory (row and
// column norms computed once per block, not per element) and stores each
// output row with 64 consecutive threads, so every warp writes 128 contiguous
// bytes.
#include "common.cuh"

namespace {

constexpr int BR = 64;          // tile rows per block
constexpr int BN = 64;          // tile columns per block (= blockDim.x)
constexpr int TY = 4;           // blockDim.y
constexpr int RPT = BR / TY;    // rows computed by one thread
constexpr int DK = 32;          // feature chunk staged in shared memory

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(BN * TY) cov_tiles_kernel(
    const T* __restrict__ xa, const T* __restrict__ xb,
    const int* __restrict__ row0, const int* __restrict__ col0,
    const int* __restrict__ nvr, const int* __restrict__ nvc,
    T* __restrict__ out, int m, int mb, int d,
    T coef, T vertical, T diagval, int symmetric) {
  const int t = blockIdx.x;
  const int r_base = blockIdx.y * BR;
  const int c_base = blockIdx.z * BN;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BN + tx;
  __shared__ T as[BR][DK + 1];
  __shared__ T bs[BN][DK + 1];
  __shared__ T na[BR];
  __shared__ T nb[BN];
  const T* xa_t = xa + static_cast<size_t>(t) * m * d;
  const T* xb_t = xb + static_cast<size_t>(t) * mb * d;

  T acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = T(0);
  // squared norm of row tid (tid < BR) or of column tid - BR, one owner each
  T nrm = T(0);
  for (int d0 = 0; d0 < d; d0 += DK) {
    __syncthreads();
    for (int e = tid; e < BR * DK; e += BN * TY) {
      const int r = e / DK, k = e % DK;
      const int gr = r_base + r, gk = d0 + k;
      as[r][k] = (gr < m && gk < d) ? xa_t[static_cast<size_t>(gr) * d + gk] : T(0);
    }
    for (int e = tid; e < BN * DK; e += BN * TY) {
      const int c = e / DK, k = e % DK;
      const int gc = c_base + c, gk = d0 + k;
      bs[c][k] = (gc < mb && gk < d) ? xb_t[static_cast<size_t>(gc) * d + gk] : T(0);
    }
    __syncthreads();
    if (tid < BR) {
      for (int k = 0; k < DK; ++k) nrm += as[tid][k] * as[tid][k];
    } else if (tid < BR + BN) {
      for (int k = 0; k < DK; ++k) nrm += bs[tid - BR][k] * bs[tid - BR][k];
    }
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      const T bv = bs[tx][k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] += as[ty + TY * i][k] * bv;
    }
  }
  if (tid < BR) {
    na[tid] = nrm;
  } else if (tid < BR + BN) {
    nb[tid - BR] = nrm;
  }
  __syncthreads();

  const int c = c_base + tx;
  if (c >= mb) return;
  const int gj = col0[t] + c;
  const int r0 = row0[t];
  const int nr = nvr[t], nc = nvc[t];
  T* out_t = out + static_cast<size_t>(t) * m * mb;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_base + ty + TY * i;
    if (r < m) {
      const int gi = r0 + r;
      T d2 = (na[ty + TY * i] + nb[tx]) - T(2) * acc[i];
      d2 = d2 < T(0) ? T(0) : d2;
      T k = vertical * dev_exp(coef * d2);
      const bool on_diag = gi == gj;
      const bool valid = gi < nr && gj < nc;
      if (symmetric) {
        if (on_diag) k = diagval;
        if (!valid) k = on_diag ? T(1) : T(0);
      } else if (!valid) {
        k = T(0);
      }
      out_t[static_cast<size_t>(r) * mb + c] = k;
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
  if (n_tiles == 0) return cudaSuccess;
  const dim3 grid(n_tiles, (m + BR - 1) / BR, (mb + BN - 1) / BN);
  const dim3 block(BN, TY);
  cov_tiles_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xa), static_cast<const T*>(xb),
      static_cast<const int*>(row0), static_cast<const int*>(col0),
      static_cast<const int*>(nvr), static_cast<const int*>(nvc),
      static_cast<T*>(out), m, mb, d, static_cast<T>(coef),
      static_cast<T>(vertical), static_cast<T>(diagval), symmetric);
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
