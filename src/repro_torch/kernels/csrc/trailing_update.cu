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
// outside the tensor cores, 3.35 TB/s); the column-0 launch of gp_16k (496
// tiles) is 1.33e11 FLOP, at least 1.99 ms.
//
// Design: the register-blocked product core of gemm_core.cuh.  A 256-thread
// CTA computes a 128 x 128 output tile (float32 and bf16 operands; 64 x 64
// for float64, whose 4 x 4 double accumulators fill the same registers),
// each thread 8 x 8 accumulators as 2 x 2 sub-tiles of 4 x 4, so a k step is
// four 16-byte shared-memory reads for 64 FMAs; 128 registers, no spills,
// two CTAs per SM.  A B^T contracts on the contiguous dimension of both
// operands, so both are loaded as 16-byte row chunks and written transposed
// (k-major) into shared memory.  Stages are 8 deep (16 for bf16, whose
// 16-byte chunk holds 8 k): while the FMAs run on one stage the next one's
// global loads are in flight in registers; they go to the other of two
// buffers after the FMAs, and one barrier per stage follows.  The loads are
// issued before the FMAs, behind a compiler fence: without it the compiler
// sinks them to the shared-memory stores after the FMAs, and every stage
// waits out a full L2 round trip.  Launches of fewer big tiles than half the
// SMs (the append's G = 1..4 levels) take 64 x 64 tiles of 4 x 4
// accumulators per thread (32 x 32 of 2 x 2 for float64), so that four
// times as many SMs share the work.  When m is not a multiple of the
// 16-byte vector (m = 77, 129; bf16 m = 100) the scalar-load instantiation
// of the same kernel runs.  The Python wrapper (kernels/trailing_update.py)
// picks the tile and the load width.
#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"
#include "gemm_core.cuh"

namespace {

template <typename TI, typename TA, int TY, int TX, int V_, int BK, bool VEC, int MINB>
__global__ void __launch_bounds__(TY * TX, MINB) trail_kernel(
    const TA* __restrict__ c_stack, const TI* __restrict__ a_stack,
    const TI* __restrict__ b_stack, TA* __restrict__ o_stack, int m, int mt, int nt) {
  using TL = gemm::Tile<TA, TY, TX, V_>;
  constexpr int V = TL::V, BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  using PanelA = gemm::RowPanel<TI, TA, BM, BK, THREADS, VEC>;
  using PanelB = gemm::RowPanel<TI, TA, BN, BK, THREADS, VEC>;
  __shared__ __align__(16) TA as[2][BK * TL::LDA];
  __shared__ __align__(16) TA bs[2][BK * TL::LDB];

  const int tid = threadIdx.x;
  const int g = blockIdx.x / (mt * nt), rem = blockIdx.x % (mt * nt);
  const int row0 = (rem / nt) * BM, col0 = (rem % nt) * BN;
  const size_t mm = static_cast<size_t>(m) * m;
  const TI* a = a_stack + g * mm;
  const TI* b = b_stack + g * mm;
  const TL t(tid);

  TA acc[2 * V][2 * V];
  gemm::zero<TL>(acc);
  PanelA pa;
  PanelB pb;
  pa.load(a, m, row0, m, 0, m, tid);
  pb.load(b, m, col0, m, 0, m, tid);
  pa.store(as[0], TL::LDA, tid);
  pb.store(bs[0], TL::LDB, tid);
  __syncthreads();
  const int nk = (m + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    // the next stage's loads (zeros past the last stage) are issued before
    // the FMAs, and the fence keeps the compiler from sinking them below
    pa.load(a, m, row0, m, (kt + 1) * BK, m, tid);
    pb.load(b, m, col0, m, (kt + 1) * BK, m, tid);
    asm volatile("" ::: "memory");
    gemm::mma<TL, BK, 2>(t, as[cur], TL::LDA, bs[cur], TL::LDB, acc);
    pa.store(as[cur ^ 1], TL::LDA, tid);
    pb.store(bs[cur ^ 1], TL::LDB, tid);
    __syncthreads();
  }

  const TA* cm = c_stack + g * mm;
  TA* o = o_stack + g * mm;
#pragma unroll
  for (int i = 0; i < 2 * V; ++i) {
    const int r = row0 + t.row(i);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = col0 + t.col(h * V);
      const size_t idx = static_cast<size_t>(r) * m + cc;
      if (VEC) {
        if (cc < m) {
          gemm::VecN<TA, V> v = *reinterpret_cast<const gemm::VecN<TA, V>*>(cm + idx);
#pragma unroll
          for (int j = 0; j < V; ++j) v.v[j] -= acc[i][h * V + j];
          *reinterpret_cast<gemm::VecN<TA, V>*>(o + idx) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (cc + j < m) o[idx + j] = cm[idx + j] - acc[i][h * V + j];
      }
    }
  }
}

template <typename TI, typename TA, int TY, int TX, int V, int BK, int MINB>
int launch_tile(const void* c, const void* a, const void* b, void* o, int n_tiles, int m, bool vec,
                cudaStream_t stream) {
  using TL = gemm::Tile<TA, TY, TX, V>;
  const int mt = (m + TL::BM - 1) / TL::BM, nt = (m + TL::BN - 1) / TL::BN;
  const long long blocks = static_cast<long long>(n_tiles) * mt * nt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const auto* cp = static_cast<const TA*>(c);
  const auto* ap = static_cast<const TI*>(a);
  const auto* bp = static_cast<const TI*>(b);
  auto* op = static_cast<TA*>(o);
  if (vec) {
    trail_kernel<TI, TA, TY, TX, V, BK, true, MINB><<<static_cast<int>(blocks), TL::THREADS, 0, stream>>>(
        cp, ap, bp, op, m, mt, nt);
  } else {
    trail_kernel<TI, TA, TY, TX, V, BK, false, MINB><<<static_cast<int>(blocks), TL::THREADS, 0, stream>>>(
        cp, ap, bp, op, m, mt, nt);
  }
  return cudaGetLastError();
}

// big: 128 x 128 tiles (64 x 64 for float64), 8 x 8 (4 x 4) accumulators
// per thread, two CTAs per SM; else 64 x 64 tiles (32 x 32) of 4 x 4 (2 x 2)
// accumulators per thread, for launches of fewer tiles than SMs.  Both have
// 256 threads.  vec: 16-byte loads, which need m to be a multiple of
// 16 / sizeof(operand).
template <typename TI, typename TA, int BK>
int launch(const void* c, const void* a, const void* b, void* o, int n_tiles, int m, int big, int vec,
           int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  if (vec && m % (16 / static_cast<int>(sizeof(TI))) != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(TA);
  if (big) return launch_tile<TI, TA, 16, 16, V, BK, 2>(c, a, b, o, n_tiles, m, vec, st);
  return launch_tile<TI, TA, 16, 16, V / 2, BK, 2>(c, a, b, o, n_tiles, m, vec, st);
}

}  // namespace

REPRO_EXPORT int trail_f32(const void* c, const void* a, const void* b, void* o, int n_tiles, int m,
                           int big, int vec, int device, void* stream) {
  return launch<float, float, 8>(c, a, b, o, n_tiles, m, big, vec, device, stream);
}

REPRO_EXPORT int trail_bf16(const void* c, const void* a, const void* b, void* o, int n_tiles, int m,
                            int big, int vec, int device, void* stream) {
  return launch<__nv_bfloat16, float, 16>(c, a, b, o, n_tiles, m, big, vec, device, stream);
}

REPRO_EXPORT int trail_f64(const void* c, const void* a, const void* b, void* o, int n_tiles, int m,
                           int big, int vec, int device, void* stream) {
  return launch<double, double, 8>(c, a, b, o, n_tiles, m, big, vec, device, stream);
}

// CTAs of the float32 kernel with 16-byte loads that fit on one SM: the big
// tile (big != 0) or the small one; a negative CUDA error code on failure.
REPRO_EXPORT int trail_f32_ctas_per_sm(int big) {
  int n = 0;
  const cudaError_t err =
      big ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, trail_kernel<float, float, 16, 16, 4, 8, true, 2>, 256, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, trail_kernel<float, float, 16, 16, 2, 8, true, 2>, 256, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
