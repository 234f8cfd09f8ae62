// Cholesky factorization of a stack of SPD tiles (POTRF), one block per tile.
//
// Replaces: repro/kernels/potrf_tile.py::_potrf_kernel (through potrf), which
// the JAX executor vmaps over the diagonal tiles of a level.  Here the whole
// (G, m, m) stack is one launch.
//
// Computes out[g] = tril(chol(in[g])).  A non-positive pivot gives NaN (the
// square root of a negative number), as jnp.sqrt does; nothing raises.
// float and double are both kept, as the Pallas kernel keeps float64.
//
// What bounds it on the H100: neither bytes nor FLOP, but latency.  A tile
// is m^3/3 FLOP (45 MFLOP at m = 512) and 1 MiB in f32, and the fused program
// issues one POTRF per level with G = 1, so one SM works while the others
// wait: the kernel is on the critical path of every column.  A 512 x 512 f32
// tile (1 MiB) does not fit the 227 KB of shared memory, so the tile stays in
// global memory (L2-resident) and the design cuts the passes over it: a
// right-looking blocked factorization with 32-wide panels.  Per panel,
//   1. one warp factors the 32 x 32 diagonal block in shared memory,
//   2. each thread solves one row of the panel below it (x L^T = b, the row
//      held in registers),
//   3. the eight warps update the trailing lower triangle in 32 x 32 blocks,
//      each warp staging its two panel slices in its own shared memory,
// so the trailing matrix is read and written once per 32 columns instead of
// once per column as in the unblocked Pallas loop.
#include "common.cuh"

namespace {

constexpr int NB = 32;               // panel width (one warp's lanes)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LD = NB + 1;           // padded shared-memory row stride

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) potrf_kernel(
    const T* __restrict__ in, T* out, int m) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T(*diag)[LD] = reinterpret_cast<T(*)[LD]>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T(*pi)[LD] = reinterpret_cast<T(*)[LD]>(smem + (1 + 2 * warp) * NB * LD);
  T(*pj)[LD] = reinterpret_cast<T(*)[LD]>(smem + (2 + 2 * warp) * NB * LD);
  const size_t mm = static_cast<size_t>(m) * m;
  const T* a_in = in + blockIdx.x * mm;
  T* a = out + blockIdx.x * mm;

  // lower triangle in, strict upper triangle zero
  for (size_t e = tid; e < mm; e += THREADS) {
    const int r = static_cast<int>(e / m), c = static_cast<int>(e % m);
    a[e] = c <= r ? a_in[e] : T(0);
  }
  __syncthreads();

  for (int k0 = 0; k0 < m; k0 += NB) {
    const int kb = min(NB, m - k0);
    // 1. diagonal block -> shared memory (identity past the tile edge)
    for (int e = tid; e < NB * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      diag[r][c] = (r < kb && c < kb) ? a[static_cast<size_t>(k0 + r) * m + k0 + c]
                                       : (r == c ? T(1) : T(0));
    }
    __syncthreads();
    if (warp == 0) {  // lane i owns row i
      for (int j = 0; j < NB; ++j) {
        if (lane == j) diag[j][j] = dev_sqrt(diag[j][j]);
        __syncwarp();
        const T piv = diag[j][j];
        if (lane > j) diag[lane][j] = diag[lane][j] / piv;
        __syncwarp();
        if (lane > j) {
          const T lij = diag[lane][j];
          for (int c = j + 1; c <= lane; ++c) diag[lane][c] -= lij * diag[c][j];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int e = tid; e < NB * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      if (r < kb && c <= r) a[static_cast<size_t>(k0 + r) * m + k0 + c] = diag[r][c];
    }

    // 2. panel rows below the block: x L^T = b, one row per thread
    const int p0 = k0 + kb;
    for (int r = p0 + tid; r < m; r += THREADS) {
      T* row = a + static_cast<size_t>(r) * m + k0;
      T x[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        T s = c < kb ? row[c] : T(0);
#pragma unroll
        for (int q = 0; q < c; ++q) s -= x[q] * diag[c][q];
        x[c] = s / diag[c][c];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < kb) row[c] = x[c];
      }
    }
    __syncthreads();

    // 3. trailing lower triangle -= P P^T, one 32 x 32 block per warp
    const int nt = (m - p0 + NB - 1) / NB;
    const int n_blocks = nt * (nt + 1) / 2;
    for (int blk = warp; blk < n_blocks; blk += WARPS) {
      int bj = 0, rem = blk;
      while (rem >= nt - bj) {
        rem -= nt - bj;
        ++bj;
      }
      const int ri = p0 + (bj + rem) * NB, rj = p0 + bj * NB;
      for (int r = 0; r < NB; ++r) {
        const int gi = ri + r, gj = rj + r;
        pi[r][lane] = (gi < m && lane < kb) ? a[static_cast<size_t>(gi) * m + k0 + lane] : T(0);
        pj[r][lane] = (gj < m && lane < kb) ? a[static_cast<size_t>(gj) * m + k0 + lane] : T(0);
      }
      __syncwarp();
      T acc[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) acc[r] = T(0);
      for (int q = 0; q < NB; ++q) {
        const T pv = pj[lane][q];
#pragma unroll
        for (int r = 0; r < NB; ++r) acc[r] += pi[r][q] * pv;
      }
      const int gc = rj + lane;
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int gr = ri + r;
        if (gr < m && gc <= gr) a[static_cast<size_t>(gr) * m + gc] -= acc[r];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* in, void* out, int n_tiles, int m, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(1 + 2 * WARPS) * NB * LD * sizeof(T);
  err = cudaFuncSetAttribute(potrf_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  potrf_kernel<T><<<n_tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int potrf_f32(const void* in, void* out, int n_tiles, int m,
                           int device, void* stream) {
  return launch<float>(in, out, n_tiles, m, device, stream);
}

REPRO_EXPORT int potrf_f64(const void* in, void* out, int n_tiles, int m,
                           int device, void* stream) {
  return launch<double>(in, out, n_tiles, m, device, stream);
}
