// Right triangular solve X L^T = B for a stack of (L, B) tile pairs (TRSM).
//
// Replaces: repro/kernels/trsm_tile.py::_trsm_kernel (through trsm), which
// the JAX executor vmaps over the panel tasks of a level with a different
// diagonal factor L_JJ for each task.  This kernel therefore takes a
// (G, m, m) stack of L beside the (G, m, m) stack of B, one launch per level.
//
// Computes, for every tile g and row i, x_i L^T = b_i, i.e. the forward
// substitution x[c] = (b[c] - sum_{q<c} L[c, q] x[q]) / L[c, c].  The Pallas
// kernel computes in float32 even for float64 operands; this kernel keeps
// the operand type (float or double), which is at least as accurate.
//
// What bounds it on the H100: FP32 issue rate, not bytes.  A tile is m^3
// FLOP (134 MFLOP at m = 512) over 3 MiB of traffic, 45 FLOP per byte, far
// above the 20 FLOP/byte balance point of FP32 on the CUDA cores (data sheet:
// 67 TFLOP/s over 3.35 TB/s).  The rows of X
// are independent (the parallel axis the Pallas column recurrence did not
// use), so each block owns 64 rows of one tile and walks 32-wide column
// blocks: the part of a column block that depends on earlier columns is a
// small GEMM (64 x 32 x k, staged through shared memory, 8 accumulators a
// thread), and the 32 x 32 diagonal part is solved with one thread per row.
#include "common.cuh"

namespace {

constexpr int RB = 64;       // rows of X owned by a block
constexpr int CB = 32;       // column block
constexpr int THREADS = 256;
constexpr int RPT = RB / (THREADS / CB);  // rows accumulated by one thread

template <typename T>
__global__ void __launch_bounds__(THREADS) trsm_kernel(
    const T* __restrict__ l_stack, const T* __restrict__ b_stack, T* x_stack, int m) {
  __shared__ T s[RB][CB + 1];   // the column block being solved
  __shared__ T xs[RB][CB + 1];  // solved columns k0..k0+CB of the block's rows
  __shared__ T ls[CB][CB + 1];  // L[cb.., k0..]
  const size_t mm = static_cast<size_t>(m) * m;
  const T* l = l_stack + blockIdx.x * mm;
  const T* b = b_stack + blockIdx.x * mm;
  T* x = x_stack + blockIdx.x * mm;
  const int r0 = blockIdx.y * RB;
  const int tid = threadIdx.x;
  const int c = tid % CB, rq = tid / CB;

  for (int cb = 0; cb < m; cb += CB) {
    for (int e = tid; e < RB * CB; e += THREADS) {
      const int r = e / CB, cc = e % CB;
      const int gr = r0 + r, gc = cb + cc;
      s[r][cc] = (gr < m && gc < m) ? b[static_cast<size_t>(gr) * m + gc] : T(0);
    }
    T acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = T(0);
    for (int k0 = 0; k0 < cb; k0 += CB) {
      __syncthreads();
      for (int e = tid; e < RB * CB; e += THREADS) {
        const int r = e / CB, kk = e % CB;
        const int gr = r0 + r;
        xs[r][kk] = gr < m ? x[static_cast<size_t>(gr) * m + k0 + kk] : T(0);
      }
      for (int e = tid; e < CB * CB; e += THREADS) {
        const int cc = e / CB, kk = e % CB;
        const int gc = cb + cc;
        ls[cc][kk] = gc < m ? l[static_cast<size_t>(gc) * m + k0 + kk] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < CB; ++kk) {
        const T lv = ls[c][kk];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] += xs[rq + (THREADS / CB) * i][kk] * lv;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[rq + (THREADS / CB) * i][c] -= acc[i];
    for (int e = tid; e < CB * CB; e += THREADS) {
      const int cc = e / CB, kk = e % CB;
      const int gc = cb + cc, gk = cb + kk;
      ls[cc][kk] = (gc < m && gk < m) ? l[static_cast<size_t>(gc) * m + gk]
                                      : (cc == kk ? T(1) : T(0));
    }
    __syncthreads();
    if (tid < RB) {  // diagonal block: one row per thread
      T xr[CB];
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        T v = s[tid][cc];
#pragma unroll
        for (int q = 0; q < cc; ++q) v -= xr[q] * ls[cc][q];
        xr[cc] = v / ls[cc][cc];
      }
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) s[tid][cc] = xr[cc];
    }
    __syncthreads();
    for (int e = tid; e < RB * CB; e += THREADS) {
      const int r = e / CB, cc = e % CB;
      const int gr = r0 + r, gc = cb + cc;
      if (gr < m && gc < m) x[static_cast<size_t>(gr) * m + gc] = s[r][cc];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* l, const void* b, void* x, int n_tiles, int m, int device,
           void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0) return cudaSuccess;
  const dim3 grid(n_tiles, (m + RB - 1) / RB);
  trsm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(x), m);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int trsm_f32(const void* l, const void* b, void* x, int n_tiles,
                          int m, int device, void* stream) {
  return launch<float>(l, b, x, n_tiles, m, device, stream);
}

REPRO_EXPORT int trsm_f64(const void* l, const void* b, void* x, int n_tiles,
                          int m, int device, void* stream) {
  return launch<double>(l, b, x, n_tiles, m, device, stream);
}
