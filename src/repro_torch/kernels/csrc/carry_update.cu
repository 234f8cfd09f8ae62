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
// Design: one block per (task, strip of RS rows of W).  The rows of X in
// X C^T = B are independent, so a strip needs only its own rows of W and L
// and the whole of Y and C (read through L2).  Phase 1 forms the strip of
// B = W - L Y in shared memory (RS x m: 128 KiB for RS = 64, m = 512,
// float32): a register-blocked SIMT product over 64-column passes, staging
// 16-deep panels of the strip's L rows (transposed) and of Y.  Phase 2
// solves the strip in place, 32 columns at a time: the part that depends on
// solved columns is a small product against panels of C staged in shared
// memory, the 32 x 32 diagonal part is solved one thread per row.  RS is 64
// for float32 and 32 for float64, halved (down to 16) while the strip does
// not fit in the 227 KB a block may use.  No wgmma or TMA yet.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BN = 64;  // phase 1: output columns per pass
constexpr int BK = 16;  // phase 1: depth of a staged panel
constexpr int CB = 32;  // phase 2: column block of the solve
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared memory of one block, in elements: the strip [RS][ld] with
// ld = round_up(m, BN) + 1 (odd, so a column read across rows is free of
// bank conflicts), the phase-1 panels of L and Y and the phase-2 block of C.
template <int RS>
__host__ __device__ inline size_t smem_elems(int m) {
  return static_cast<size_t>(RS) * (round_up(m, BN) + 1) + BK * (RS + 4) + BK * (BN + 4) +
         CB * (CB + 1);
}

template <typename T, int RS>
__global__ void __launch_bounds__(THREADS) carry_kernel(
    const T* __restrict__ w_stack, const T* __restrict__ l_stack,
    const T* __restrict__ y_stack, const T* __restrict__ c_stack, T* __restrict__ o_stack,
    int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = round_up(m, BN) + 1;
  T* s = reinterpret_cast<T*>(smem_raw);  // [RS][ld]: B, then X
  T* ls = s + static_cast<size_t>(RS) * ld;  // [BK][RS + 4]: L[r0 + row][k0 + k]
  T* ys = ls + BK * (RS + 4);                // [BK][BN + 4]: Y[k0 + k][n0 + col]
  T* cs = ys + BK * (BN + 4);                // [CB][CB + 1]: a block of C

  const size_t mm = static_cast<size_t>(m) * m;
  const T* w = w_stack + blockIdx.x * mm;
  const T* l = l_stack + blockIdx.x * mm;
  const T* y = y_stack + blockIdx.x * mm;
  const T* c = c_stack + blockIdx.x * mm;
  T* o = o_stack + blockIdx.x * mm;
  const int r0 = blockIdx.y * RS;
  const int tid = threadIdx.x;

  // ---- phase 1: s = W - L Y on the strip's rows (zero past m) ----------
  constexpr int RI = RS / 16;  // rows of the 64-column pass held by a thread
  const int tx = tid % 16, ty = tid / 16;
  for (int n0 = 0; n0 < m; n0 += BN) {
    T acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    for (int k0 = 0; k0 < m; k0 += BK) {
      for (int e = tid; e < RS * BK; e += THREADS) {
        const int row = e / BK, k = e % BK;
        const int gr = r0 + row, gk = k0 + k;
        ls[k * (RS + 4) + row] = (gr < m && gk < m) ? l[static_cast<size_t>(gr) * m + gk] : T(0);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e / BN, col = e % BN;
        const int gk = k0 + k, gc = n0 + col;
        ys[k * (BN + 4) + col] = (gk < m && gc < m) ? y[static_cast<size_t>(gk) * m + gc] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        T av[RI], bv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = ls[k * (RS + 4) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ys[k * (BN + 4) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 16 * i, gr = r0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        const T wv = (gr < m && col < m) ? w[static_cast<size_t>(gr) * m + col] : T(0);
        s[row * ld + col] = wv - acc[i][j];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: X C^T = s, in place, one 32-column block at a time -----
  constexpr int RPT = RS / (THREADS / CB);  // rows of a column block per thread
  const int cc0 = tid % CB, rq = tid / CB;
  for (int cb = 0; cb < m; cb += CB) {
    T acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = T(0);
    for (int k0 = 0; k0 < cb; k0 += CB) {
      for (int e = tid; e < CB * CB; e += THREADS) {
        const int cc = e / CB, kk = e % CB;
        const int gc = cb + cc;
        cs[cc * (CB + 1) + kk] = gc < m ? c[static_cast<size_t>(gc) * m + k0 + kk] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < CB; ++kk) {
        const T cv = cs[cc0 * (CB + 1) + kk];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] += s[(rq + (THREADS / CB) * i) * ld + k0 + kk] * cv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[(rq + (THREADS / CB) * i) * ld + cb + cc0] -= acc[i];
    for (int e = tid; e < CB * CB; e += THREADS) {
      const int cc = e / CB, kk = e % CB;
      const int gc = cb + cc, gk = cb + kk;
      cs[cc * (CB + 1) + kk] = (gc < m && gk < m) ? c[static_cast<size_t>(gc) * m + gk]
                                                  : (cc == kk ? T(1) : T(0));
    }
    __syncthreads();
    if (tid < RS) {  // diagonal block: one row per thread
      T xr[CB];
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        T v = s[tid * ld + cb + cc];
#pragma unroll
        for (int q = 0; q < cc; ++q) v -= xr[q] * cs[cc * (CB + 1) + q];
        xr[cc] = v / cs[cc * (CB + 1) + cc];
      }
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) s[tid * ld + cb + cc] = xr[cc];
    }
    __syncthreads();
  }

  // ---- write the strip's valid rows, coalesced along each row ----------
  for (int row = 0; row < RS && r0 + row < m; ++row) {
    T* orow = o + static_cast<size_t>(r0 + row) * m;
    for (int col = tid; col < m; col += THREADS) orow[col] = s[row * ld + col];
  }
}

template <typename T, int RS>
cudaError_t launch_rs(const void* w, const void* l, const void* y, const void* c, void* o,
                      int n_tiles, int m, cudaStream_t stream) {
  const size_t bytes = smem_elems<RS>(m) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      carry_kernel<T, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (m + RS - 1) / RS);
  carry_kernel<T, RS><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(l), static_cast<const T*>(y),
      static_cast<const T*>(c), static_cast<T*>(o), m);
  return cudaGetLastError();
}

// The widest strip that fits in shared memory, from RS_MAX down to 16.
template <typename T, int RS_MAX>
int launch(const void* w, const void* l, const void* y, const void* c, void* o, int n_tiles,
           int m, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (RS_MAX >= 64) {
    if (smem_elems<64>(m) * sizeof(T) <= MAX_SMEM)
      return launch_rs<T, 64>(w, l, y, c, o, n_tiles, m, st);
  }
  if (smem_elems<32>(m) * sizeof(T) <= MAX_SMEM)
    return launch_rs<T, 32>(w, l, y, c, o, n_tiles, m, st);
  if (smem_elems<16>(m) * sizeof(T) <= MAX_SMEM)
    return launch_rs<T, 16>(w, l, y, c, o, n_tiles, m, st);
  return cudaErrorInvalidValue;  // the strip of 16 rows does not fit
}

}  // namespace

REPRO_EXPORT int carry_update_f32(const void* w, const void* l, const void* y, const void* c,
                                  void* o, int n_tiles, int m, int device, void* stream) {
  return launch<float, 64>(w, l, y, c, o, n_tiles, m, device, stream);
}

REPRO_EXPORT int carry_update_f64(const void* w, const void* l, const void* y, const void* c,
                                  void* o, int n_tiles, int m, int device, void* stream) {
  return launch<double, 32>(w, l, y, c, o, n_tiles, m, device, stream);
}
