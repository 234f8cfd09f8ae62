// Batch-invariant tile matvecs and diagonal-tile solves of a fleet's executor.
//
// A fleet (B problems stacked on a leading axis) runs the forward and
// backward substitutions, the predictive mean and the warm tails' matvecs
// as batched plain ops.  cuBLAS's batched GEMV and triangular solves pick
// their algorithm by the batch count, so that one problem's result rounds
// differently when it shares a launch with another number of problems: a
// fleet sharded over ranks (each rank a slice of B) then differs from the
// unsharded fleet.  These two kernels give every problem the same
// arithmetic whatever the launch's width: a CTA works on one (problem,
// tile) and reduces in an order fixed by the tile's shape and strides
// alone.
//
// tile_gemv:  out[z, g, a] = sum_q sum_b A[z, g, q, a, b] X[z, g, q, b]
//             A and X strided (a stride may be 0: X broadcast over g, or a
//             transposed tile read with stride_a = 1).  Row-major tiles
//             (stride_b = 1): one warp a row, lanes over b, each lane's
//             partial in (q, b) order, then a butterfly over the warp.
//             Column-major tiles (stride_a = 1): one thread a row, b in
//             order, so that the warp's reads stay contiguous.
// tile_trsv:  x[z, g] = L[z, g]^-1 r[z, g] (or L^-T r), L lower m x m
//             row-major, r an m vector: one CTA a system, the vector in
//             shared memory, 32-column blocks: warp 0 solves the diagonal
//             block by shuffles, then the rows past it (below for L,
//             above for L^T) subtract the block's contribution, a warp
//             a row (L) or a thread a row (L^T), so that every read of L
//             walks a contiguous row.
//
// Both take float32 or float64 and accumulate in their type.  What bounds
// them: the bytes of A (GEMV) and of the triangle (TRSV), read once; a TRSV
// of m = 512 also takes m / 32 = 16 dependent steps with two barriers
// each.  Neither aims at the bound: the fleet's levels launch them at a few
// hundred (problem, tile) CTAs, where one launch in place of B per-problem
// calls is what the design is for.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 64;     // rows of a CTA, row-major tiles (8 a warp)
constexpr int kThreadRows = 256;  // rows of a CTA, column-major tiles (1 a thread)

struct GemvArgs {
  long long sa_z, sa_g, sa_q, sa_a, sa_b;
  long long sx_z, sx_g, sx_q, sx_b;
  int g, q, m, n;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemv_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                                             T* __restrict__ out, const __grid_constant__ GemvArgs p) {
  const int z = blockIdx.z, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* at = a + z * p.sa_z + g * p.sa_g;
  const T* xt = x + z * p.sx_z + g * p.sx_g;
  T* ot = out + ((long long)z * p.g + g) * p.m;
  for (int r = warp; r < kWarpRows; r += kWarps) {
    const int row = blockIdx.x * kWarpRows + r;
    if (row >= p.m) break;
    T acc = T(0);
    for (int q = 0; q < p.q; ++q) {
      const T* arow = at + q * p.sa_q + row * p.sa_a;
      const T* xq = xt + q * p.sx_q;
      for (int b = lane; b < p.n; b += 32) acc += arow[b * p.sa_b] * __ldg(xq + b * p.sx_b);
    }
    acc = warp_sum(acc);
    if (lane == 0) ot[row] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemv_cols_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                                             T* __restrict__ out, const __grid_constant__ GemvArgs p) {
  const int z = blockIdx.z, g = blockIdx.y;
  const int row = blockIdx.x * kThreadRows + threadIdx.x;
  if (row >= p.m) return;
  const T* at = a + z * p.sa_z + g * p.sa_g + row * p.sa_a;
  const T* xt = x + z * p.sx_z + g * p.sx_g;
  T acc = T(0);
  for (int q = 0; q < p.q; ++q)
    for (int b = 0; b < p.n; ++b) acc += at[q * p.sa_q + b * p.sa_b] * __ldg(xt + q * p.sx_q + b * p.sx_b);
  out[((long long)z * p.g + g) * p.m + row] = acc;
}

struct TrsvArgs {
  long long sl_z, sl_g, sr_z, sr_g;
  int g, m;
};

// L x = r: blocks of 32 columns from the top.
template <typename T>
__global__ void __launch_bounds__(kThreads) trsv_lower_kernel(const T* __restrict__ l, const T* __restrict__ r,
                                                              T* __restrict__ out, const __grid_constant__ TrsvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);
  const int z = blockIdx.y, g = blockIdx.x, m = p.m;
  const T* lt = l + z * p.sl_z + g * p.sl_g;
  const T* rt = r + z * p.sr_z + g * p.sr_g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < m; i += kThreads) v[i] = rt[i];
  __syncthreads();
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int bs = min(32, m - j0);
    if (warp == 0) {
      T val = lane < bs ? v[j0 + lane] : T(0);
      for (int jj = 0; jj < bs; ++jj) {
        const T xj = __shfl_sync(0xffffffffu, val, jj) / lt[(long long)(j0 + jj) * m + j0 + jj];
        if (lane > jj && lane < bs) val -= lt[(long long)(j0 + lane) * m + j0 + jj] * xj;
        if (lane == jj) val = xj;
      }
      if (lane < bs) v[j0 + lane] = val;
    }
    __syncthreads();
    const T xb = lane < bs ? v[j0 + lane] : T(0);
    for (int i = j0 + bs + warp; i < m; i += kWarps) {
      T s = lane < bs ? lt[(long long)i * m + j0 + lane] * xb : T(0);
      s = warp_sum(s);
      if (lane == 0) v[i] -= s;
    }
    __syncthreads();
  }
  T* ot = out + ((long long)z * p.g + g) * m;
  for (int i = threadIdx.x; i < m; i += kThreads) ot[i] = v[i];
}

// L^T x = r: blocks of 32 columns from the bottom.
template <typename T>
__global__ void __launch_bounds__(kThreads) trsv_upper_kernel(const T* __restrict__ l, const T* __restrict__ r,
                                                              T* __restrict__ out, const __grid_constant__ TrsvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);
  const int z = blockIdx.y, g = blockIdx.x, m = p.m;
  const T* lt = l + z * p.sl_z + g * p.sl_g;
  const T* rt = r + z * p.sr_z + g * p.sr_g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < m; i += kThreads) v[i] = rt[i];
  __syncthreads();
  for (int j0 = ((m - 1) / 32) * 32; j0 >= 0; j0 -= 32) {
    const int bs = min(32, m - j0);
    if (warp == 0) {
      T val = lane < bs ? v[j0 + lane] : T(0);
      for (int jj = bs - 1; jj >= 0; --jj) {
        const T xj = __shfl_sync(0xffffffffu, val, jj) / lt[(long long)(j0 + jj) * m + j0 + jj];
        if (lane < jj) val -= lt[(long long)(j0 + jj) * m + j0 + lane] * xj;
        if (lane == jj) val = xj;
      }
      if (lane < bs) v[j0 + lane] = val;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < j0; i += kThreads) {
      T s = T(0);
      for (int jj = 0; jj < bs; ++jj) s += lt[(long long)(j0 + jj) * m + i] * v[j0 + jj];
      v[i] -= s;
    }
    __syncthreads();
  }
  T* ot = out + ((long long)z * p.g + g) * m;
  for (int i = threadIdx.x; i < m; i += kThreads) ot[i] = v[i];
}

template <typename T>
int launch_gemv(const void* a, const void* x, void* out, int nz, int ng, int nq, int m, int n,
                const long long* sa, const long long* sx, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (nz == 0 || ng == 0 || m == 0) return cudaSuccess;
  GemvArgs p{sa[0], sa[1], sa[2], sa[3], sa[4], sx[0], sx[1], sx[2], sx[3], ng, nq, m, n};
  auto st = static_cast<cudaStream_t>(stream);
  if (sa[4] == 1 || sa[3] != 1) {  // row-major tiles (or neither axis unit-stride): a warp a row
    dim3 grid((m + kWarpRows - 1) / kWarpRows, ng, nz);
    gemv_rows_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(x),
                                                    static_cast<T*>(out), p);
  } else {  // column-major tiles (a transposed read): a thread a row
    dim3 grid((m + kThreadRows - 1) / kThreadRows, ng, nz);
    gemv_cols_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(x),
                                                    static_cast<T*>(out), p);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_trsv(const void* l, const void* r, void* out, int nz, int ng, int m, const long long* s, int transpose,
                int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (nz == 0 || ng == 0 || m == 0) return cudaSuccess;
  TrsvArgs p{s[0], s[1], s[2], s[3], ng, m};
  const size_t smem = sizeof(T) * static_cast<size_t>(m);
  auto kernel = transpose ? trsv_upper_kernel<T> : trsv_lower_kernel<T>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(ng, nz);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(r), static_cast<T*>(out), p);
  return cudaGetLastError();
}

}  // namespace

// strides in elements: sa = (z, g, q, a, b) of A, sx = (z, g, q, b) of X
REPRO_EXPORT int tile_gemv_f32(const void* a, const void* x, void* out, int nz, int ng, int nq, int m, int n,
                               const long long* sa, const long long* sx, int device, void* stream) {
  return launch_gemv<float>(a, x, out, nz, ng, nq, m, n, sa, sx, device, stream);
}

REPRO_EXPORT int tile_gemv_f64(const void* a, const void* x, void* out, int nz, int ng, int nq, int m, int n,
                               const long long* sa, const long long* sx, int device, void* stream) {
  return launch_gemv<double>(a, x, out, nz, ng, nq, m, n, sa, sx, device, stream);
}

// strides in elements: s = (z, g) of L (rows of m, row-major), then (z, g) of r (contiguous vectors)
REPRO_EXPORT int tile_trsv_f32(const void* l, const void* r, void* out, int nz, int ng, int m, const long long* s,
                               int transpose, int device, void* stream) {
  return launch_trsv<float>(l, r, out, nz, ng, m, s, transpose, device, stream);
}

REPRO_EXPORT int tile_trsv_f64(const void* l, const void* r, void* out, int nz, int ng, int m, const long long* s,
                               int transpose, int device, void* stream) {
  return launch_trsv<double>(l, r, out, nz, ng, m, s, transpose, device, stream);
}
