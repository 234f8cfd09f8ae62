// Batched trailing update O = C - A B^T (the fused SYRK + GEMM of a level).
//
// Replaces: repro/kernels/trailing_update.py::_update_kernel (through
// trailing_update), reached from the JAX executor's SYRK and GEMM tile ops.
// One launch covers every SYRK and GEMM task of a level: the caller gathers
// C, A and B stacks (SYRK tasks pass the same panel tile as A and B).
//
// Accumulation is float32 for float32 and bfloat16 operands (with
// update_dtype=bfloat16 only A and B are bfloat16; C and O keep the storage
// type) and float64 for float64 operands.  The float32 path is IEEE float32
// FMA on the CUDA cores, never TF32.  Edges are masked, so any m works.
//
// What bounds it on the H100: FP32 operations.  A tile is 2 m^3 FLOP (268
// MFLOP at m = 512) over 4 MiB of traffic, 64 FLOP per byte, three times the
// balance point of the card's FP32 rate and bandwidth (data sheet: 67 TFLOP/s
// outside the tensor cores, 3.35 TB/s); the factorization at n = 16384 with
// m = 512 runs 496 SYRK and 4960 GEMM tiles, about 1.46 TFLOP over about
// 23 GB.  The design is a classic register-blocked
// SIMT GEMM: each 256-thread block computes a 64 x 64 output tile, staging
// 64 x 16 slices of A and B transposed in shared memory, each thread holding
// a 4 x 4 accumulator; rows ty + 16 i and columns tx + 16 j keep shared-memory
// reads conflict-free.  No wgmma or TMA yet.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TPR = 16;  // threads per output row of the block

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename TI, typename TA>
__global__ void __launch_bounds__(THREADS) trail_kernel(
    const TA* __restrict__ c_stack, const TI* __restrict__ a_stack,
    const TI* __restrict__ b_stack, TA* __restrict__ o_stack, int m) {
  __shared__ TA as[BK][BM + 4];  // as[k][row] = A[row, k0 + k]
  __shared__ TA bs[BK][BM + 4];  // bs[k][col] = B[col, k0 + k]
  const size_t mm = static_cast<size_t>(m) * m;
  const TI* a = a_stack + blockIdx.x * mm;
  const TI* b = b_stack + blockIdx.x * mm;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int tx = tid % TPR, ty = tid / TPR;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // loader: one row, 4 consecutive k

  TA acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = TA(0);

  for (int k0 = 0; k0 < m; k0 += BK) {
    const int ga = row0 + lr, gb = col0 + lr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = k0 + lk + e;
      as[lk + e][lr] = (ga < m && gk < m) ? to_acc(a[static_cast<size_t>(ga) * m + gk]) : TA(0);
      bs[lk + e][lr] = (gb < m && gk < m) ? to_acc(b[static_cast<size_t>(gb) * m + gk]) : TA(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      TA av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + TPR * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + TPR * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

  const TA* cm = c_stack + blockIdx.x * mm;
  TA* o = o_stack + blockIdx.x * mm;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + TPR * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + TPR * j;
      if (r < m && c < m) {
        const size_t idx = static_cast<size_t>(r) * m + c;
        o[idx] = cm[idx] - acc[i][j];
      }
    }
  }
}

template <typename TI, typename TA>
int launch(const void* c, const void* a, const void* b, void* o, int n_tiles, int m,
           int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0) return cudaSuccess;
  const dim3 grid(n_tiles, (m + BM - 1) / BM, (m + BM - 1) / BM);
  trail_kernel<TI, TA><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(c), static_cast<const TI*>(a), static_cast<const TI*>(b),
      static_cast<TA*>(o), m);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int trail_f32(const void* c, const void* a, const void* b, void* o,
                           int n_tiles, int m, int device, void* stream) {
  return launch<float, float>(c, a, b, o, n_tiles, m, device, stream);
}

REPRO_EXPORT int trail_bf16(const void* c, const void* a, const void* b, void* o,
                            int n_tiles, int m, int device, void* stream) {
  return launch<__nv_bfloat16, float>(c, a, b, o, n_tiles, m, device, stream);
}

REPRO_EXPORT int trail_f64(const void* c, const void* a, const void* b, void* o,
                           int n_tiles, int m, int device, void* stream) {
  return launch<double, double>(c, a, b, o, n_tiles, m, device, stream);
}
