// Batch-invariant tile matvecs and diagonal-tile solves of a fleet's executor.
//
// Replaces no TPU kernel: the reference leaves the fleet's GEMV, GEMV_B,
// XGEMV and TRSV steps to XLA (src/repro/core/executor.py:271,275).  On the
// card cuBLAS's batched GEMV and triangular solves pick their algorithm by
// the batch count, so that one problem's result rounds differently when it
// shares a launch with another number of problems: a fleet sharded over
// ranks (each rank a slice of B) then differs from the unsharded fleet.
// Here every decision that sets a problem's arithmetic (rows of a CTA, the
// lanes and accumulators of an element, the reduction tree, the cluster
// size, the variant) is a function of the tile's shape and strides alone,
// never of Z, G or the pointers.
//
// tile_gemv:  out[z, g, a] = sum_q sum_b A[z, g, q, a, b] X[z, g, q, b],
// A and X strided (a stride may be 0: X broadcast over g; a transposed tile
// is read with stride_a = 1).  Bound by the bytes of A, read once.
//   Row-major tiles (stride_b = 1, or neither axis unit-stride): a warp a
//   row, 8 rows a CTA.  The row's (q, b) run as chunks of V = 16 / sizeof(T)
//   columns, t = q * ceil(n / V) + b / V; lane t % 32 takes chunk t, in
//   order of t, into V accumulators (column b % V), kRowUnroll chunks loaded
//   before they are added.  The lane's V partials add as ((0 + 1) + (2 + 3))
//   (float) or (0 + 1) (double), then a butterfly over the warp (xor 16 ...
//   1); lane 0 stores.
//   Column-major tiles (stride_a = 1): a CTA takes a slab of 32 V rows, a
//   lane V consecutive rows, one accumulator each; the Q n columns split
//   into kGemvWarps equal slices, warp w's slice in order of (q, b), the
//   slices added in warp order through shared memory.  Every load of A is
//   a coalesced run of 32 V rows of one column.
//   Both take 16-byte loads when the tile's rows (columns) are contiguous,
//   n (m) is a multiple of V and the base pointers and strides are 16-byte
//   aligned, and scalar loads otherwise.  Alignment is not a property of the
//   shape (a rank's slice of a fleet can move it), so the load width changes
//   only how elements are fetched: both widths add the same products in the
//   same order, zero-filled alike, and give the same bits.
//
// tile_trsv:  x[z, g] = L[z, g]^-1 r[z, g] (or L^-T r), L lower m x m with
// rows of stride m, r an m vector.  Bound by its dependent chain, not its
// bytes: block k of x needs every block before it.  A system is a thread-
// block cluster of C = min(8, nb) CTAs (nb = ceil(m / 32) blocks of 32
// rows); CTA c owns the row blocks i = c, c + C, ...; warp w of a CTA its
// w-th owned block (the next owned block after it, w + 8, ..., when a CTA
// owns more than 8).  For L x = r, the owner of block i stages the blocks
// (i, 0..i) of L in shared memory (cp.async, zero-filled past m, rows padded
// to 32 + 16 bytes so that both a lane's row and a column read without bank
// conflicts) and inverts the diagonal block (padded with the identity past
// m) by forward substitution, lane j column j.  Then, for k = 0 .. i - 1 in
// order, it waits on the mbarrier of block k, which the owner of x_k
// completes, and takes r_i -= L_ik x_k; then x_i = L_ii^-1 r_i.  Lane l
// stores its element of x_i into every CTA's shared memory (distributed
// shared memory) with st.async, whose bytes complete that CTA's mbarrier of
// block i (each expects one block's bytes): the store is the signal.  No
// global load is left in the chain: L is resident before the chain reaches
// it, and x travels SM to SM.  L^T x = r is the same from the
// bottom: block (k, i) read by columns, k = nb - 1 .. i + 1, x_i =
// (L_ii^-1)^T r_i.  A 32-long dot product adds its terms into four partials
// (b % 4) and ((0 + 1) + (2 + 3)).
//   Resident variant: when the blocks of every CTA's rows fit 227 KB (m up
//   to 768 in float32, 512 in float64).  Streaming variant, past that: the
//   same arithmetic, the blocks streamed through a ring of kRing slots a
//   warp (cp.async, issued kRing blocks ahead of the chain) and x through
//   global memory (written, fenced at cluster scope, then the arrive); its
//   shared memory grows only by an mbarrier (8 bytes) a block, so it runs
//   every m up to 479232 (float32) and 77824 (float64).  The variant and C
//   are functions of (m, dtype) alone (trsv_plan), and the two variants give
//   the same bits.
//
// Both take float32 or float64 and accumulate in their type with IEEE FMA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "common.cuh"
#include "gemm_core.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kRowUnroll = 4;  // chunks a lane loads before it adds them (row-major tiles)
constexpr int kColUnroll = 4;  // columns a lane loads before it adds them (column-major tiles)

// tile_gemv's variants: the route (rows or columns) and the load width
constexpr int kRowsScalar = 0, kRowsVector = 1, kColsScalar = 2, kColsVector = 3;

constexpr int kBlock = 32;          // rows of a solve's block
constexpr int kTrsvThreads = 256;   // a CTA of the solve: 8 warps, one owned row block each
constexpr int kTrsvWarps = kTrsvThreads / 32;
constexpr int kMaxCluster = 8;      // CTAs of a system's cluster (the portable maximum)
constexpr int kRing = 2;            // blocks a warp stages ahead of its chain (streaming variant)
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA can opt into on the H100

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
__device__ __forceinline__ T add_partials(const T (&acc)[4]) {
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <typename T>
__device__ __forceinline__ T add_partials(const T (&acc)[2]) {
  return acc[0] + acc[1];
}

// Row-major tiles: a warp a row (see the header for the map).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kGemvThreads) gemv_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                                                 T* __restrict__ out,
                                                                 const __grid_constant__ GemvArgs p) {
  constexpr int V = 16 / sizeof(T);
  using VT = gemm::Vec16<T>;
  const int z = blockIdx.z, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kGemvWarps + warp;
  if (row >= p.m) return;
  const T* arow = a + z * p.sa_z + g * p.sa_g + row * p.sa_a;
  const T* xt = x + z * p.sx_z + g * p.sx_g;
  const int nc = (p.n + V - 1) / V;
  const int total = p.q * nc;
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  for (int t0 = lane; t0 < total; t0 += 32 * kRowUnroll) {
    T av[kRowUnroll][V], xv[kRowUnroll][V];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int t = t0 + 32 * u;
      const int q = t / nc, b0 = (t - q * nc) * V;
      if (VEC) {
        VT va{}, vx{};
        if (t < total) {
          va = *reinterpret_cast<const VT*>(arow + q * p.sa_q + b0);
          vx = *reinterpret_cast<const VT*>(xt + q * p.sx_q + b0);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) av[u][j] = va.v[j], xv[u][j] = vx.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const bool ok = t < total && b0 + j < p.n;
          av[u][j] = ok ? arow[q * p.sa_q + (b0 + j) * p.sa_b] : T(0);
          xv[u][j] = ok ? __ldg(xt + q * p.sx_q + (b0 + j) * p.sx_b) : T(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fma(av[u][j], xv[u][j], acc[j]);
  }
  const T s = warp_sum(add_partials(acc));
  if (lane == 0) out[((long long)z * p.g + g) * p.m + row] = s;
}

// Column-major tiles: a slab of 32 V rows a CTA, the columns split over the warps.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kGemvThreads) gemv_cols_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                                                 T* __restrict__ out,
                                                                 const __grid_constant__ GemvArgs p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kSlab = 32 * V;
  using VT = gemm::Vec16<T>;
  __shared__ T part[kGemvWarps][kSlab];
  const int z = blockIdx.z, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kSlab + lane * V;
  const T* at = a + z * p.sa_z + g * p.sa_g + row0;
  const T* xt = x + z * p.sx_z + g * p.sx_g;
  const int total = p.q * p.n;
  const int per = (total + kGemvWarps - 1) / kGemvWarps;
  const int k0 = warp * per, k1 = min(total, k0 + per);
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  for (int kb = k0; kb < k1; kb += kColUnroll) {
    T av[kColUnroll][V], xv[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      const int k = kb + u;
      const int q = k / p.n, b = k - q * p.n;
      const bool in = k < k1;
      const T* col = at + q * p.sa_q + b * p.sa_b;
      xv[u] = in ? __ldg(xt + q * p.sx_q + b * p.sx_b) : T(0);
      if (VEC) {
        VT va{};
        if (in && row0 < p.m) va = *reinterpret_cast<const VT*>(col);
#pragma unroll
        for (int j = 0; j < V; ++j) av[u][j] = va.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) av[u][j] = in && row0 + j < p.m ? col[j] : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fma(av[u][j], xv[u], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[warp][lane * V + j] = acc[j];
  __syncthreads();
  T* ot = out + ((long long)z * p.g + g) * p.m;
  for (int r = threadIdx.x; r < kSlab; r += kGemvThreads) {
    const int row = blockIdx.x * kSlab + r;
    if (row >= p.m) continue;
    T s = part[0][r];
#pragma unroll
    for (int w = 1; w < kGemvWarps; ++w) s += part[w][r];
    ot[row] = s;
  }
}

// ---- the solve ---------------------------------------------------------------

struct TrsvArgs {
  long long sl_z, sl_g, sr_z, sr_g;
  int g, m, nb, cluster, aligned;
};

// shared-memory pitch of a staged 32 x 32 block: 32 elements and 16 bytes
template <typename T>
__host__ __device__ constexpr int pitch() {
  return kBlock + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int slot_elems() {
  return kBlock * pitch<T>();
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Wait, with acquire at cluster scope, for phase 0 of a local mbarrier that a CTA of the cluster completes.
__device__ __forceinline__ void wait_block(uint32_t bar) {
  uint32_t ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar)
        : "memory");
  } while (!ok);
}

// Arrive, with release at cluster scope, on an mbarrier of a CTA of the cluster (a shared::cluster address).
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Store one element into a CTA of the cluster; the bytes complete that CTA's mbarrier transaction count.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(addr), "d"(v),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void fence_cluster() { asm volatile("fence.acq_rel.cluster;\n" ::: "memory"); }

// Stage block (bi, bk) of a system's L into a slot (pitch<T>()), zero past m; a warp's lanes.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* lt, int m, int bi, int bk, bool aligned, int lane) {
  constexpr int P = pitch<T>();
  constexpr int V = 16 / sizeof(T);
  constexpr int CHUNKS = kBlock / V;
  if (aligned) {
#pragma unroll 4
    for (int e = lane; e < kBlock * CHUNKS; e += 32) {
      const int row = e / CHUNKS, col = (e % CHUNKS) * V;
      const int gr = bi * kBlock + row, gc = bk * kBlock + col;
      const bool ok = gr < m && gc < m;
      gemm::cp_async16(dst + row * P + col, ok ? lt + (long long)gr * m + gc : lt, ok);
    }
  } else {
#pragma unroll 4
    for (int e = lane; e < kBlock * kBlock; e += 32) {
      const int row = e / kBlock, col = e % kBlock;
      const int gr = bi * kBlock + row, gc = bk * kBlock + col;
      const bool ok = gr < m && gc < m;
      gemm::cp_async_elem<sizeof(T)>(dst + row * P + col, ok ? lt + (long long)gr * m + gc : lt, ok);
    }
  }
}

// In place: the staged lower block D (identity past m) becomes D^-1; lane j solves column j.
template <typename T>
__device__ __forceinline__ void invert_block(T* d, int lane) {
  constexpr int P = pitch<T>();
  T y[kBlock];
#pragma unroll
  for (int row = 0; row < kBlock; ++row) {
    T q[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < row; ++b) q[b % 4] = fma(d[row * P + b], y[b], q[b % 4]);
    y[row] = ((row == lane ? T(1) : T(0)) - add_partials(q)) / d[row * P + row];
  }
  __syncwarp();
#pragma unroll
  for (int row = 0; row < kBlock; ++row) d[row * P + lane] = y[row];
  __syncwarp();
}

// sum_b s[lane][b] v[b]: a lane's row of a staged block (16-byte reads), partials by b % 4.
template <typename T>
__device__ __forceinline__ T row_dot(const T* s, const T* v, int lane) {
  constexpr int V = 16 / sizeof(T);
  using VT = gemm::Vec16<T>;
  const T* row = s + lane * pitch<T>();
  T q[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int c = 0; c < kBlock / V; ++c) {
    const VT av = *reinterpret_cast<const VT*>(row + c * V);
    const VT xv = *reinterpret_cast<const VT*>(v + c * V);
#pragma unroll
    for (int j = 0; j < V; ++j) q[(c * V + j) % 4] = fma(av.v[j], xv.v[j], q[(c * V + j) % 4]);
  }
  return add_partials(q);
}

// sum_b s[b][lane] v[b]: a lane's column of a staged block, partials by b % 4.
template <typename T>
__device__ __forceinline__ T col_dot(const T* s, const T* v, int lane) {
  constexpr int P = pitch<T>();
  T q[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int b = 0; b < kBlock; ++b) q[b % 4] = fma(s[b * P + lane], v[b], q[b % 4]);
  return add_partials(q);
}

// Row blocks of L a rank owns, and the staged blocks of one (lower: (i, 0..i); upper: (i..nb-1, i)).
__host__ __device__ __forceinline__ int owned_blocks(int nb, int cluster, int rank) {
  return (nb - rank + cluster - 1) / cluster;
}

__host__ __device__ __forceinline__ int blocks_of_row(int nb, int i, bool upper) { return upper ? nb - i : i + 1; }

// One system a cluster (see the header).  RESIDENT: every block of a CTA's rows stays in shared memory and x
// travels through distributed shared memory; otherwise blocks stream through a ring and x through global memory.
template <typename T, bool UPPER, bool RESIDENT>
__global__ void __launch_bounds__(kTrsvThreads, 1) trsv_cluster_kernel(const T* __restrict__ l,
                                                                       const T* __restrict__ r, T* __restrict__ out,
                                                                       const __grid_constant__ TrsvArgs p) {
  constexpr int SLOT = slot_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = p.m, nb = p.nb, C = p.cluster;
  const int g = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  T* xs = reinterpret_cast<T*>(smem_raw + (static_cast<size_t>(nb) * 8 + 15) / 16 * 16);  // x (resident)
  T* rbuf = xs + (RESIDENT ? nb * kBlock : 0);
  T* xbuf = rbuf + kTrsvWarps * kBlock;
  T* slots = xbuf + kTrsvWarps * kBlock;
  T* rw = rbuf + warp * kBlock;
  T* xw = xbuf + warp * kBlock;
  const T* lt = l + z * p.sl_z + g * p.sl_g;
  const T* rt = r + z * p.sr_z + g * p.sr_g;
  T* ot = out + ((long long)z * p.g + g) * m;

  for (int i = threadIdx.x; i < nb; i += kTrsvThreads) {
    hop::mbar_init(hop::smem_u32(bars + i), 1);
    // resident: the barrier's one arrival is this, and x_i's bytes (st.async from its owner) complete the phase
    if (RESIDENT) hop::mbar_expect_tx(hop::smem_u32(bars + i), kBlock * sizeof(T));
  }
  hop::fence_barrier_init();
  cluster.sync();

  const int owned = owned_blocks(nb, C, rank);
  for (int tt = warp; tt < owned; tt += kTrsvWarps) {
    const int t = UPPER ? owned - 1 - tt : tt;  // a warp's blocks in the order of the chain
    const int i = rank + t * C;
    const int bs = min(kBlock, m - i * kBlock);
    const int nk = UPPER ? nb - 1 - i : i;  // blocks of the update
    T* base;
    T* dinv;
    if (RESIDENT) {
      int before = 0;
      for (int u = 0; u < t; ++u) before += blocks_of_row(nb, rank + u * C, UPPER);
      base = slots + static_cast<size_t>(before) * SLOT;
      dinv = base + (UPPER ? 0 : i) * SLOT;
      for (int k = 0; k < blocks_of_row(nb, i, UPPER); ++k) {
        const int bk = UPPER ? i + k : k;
        stage_block(base + k * SLOT, lt, m, UPPER ? bk : i, UPPER ? i : bk, p.aligned, lane);
      }
    } else {
      base = slots + static_cast<size_t>(warp) * (1 + kRing) * SLOT;
      dinv = base;
      stage_block(dinv, lt, m, i, i, p.aligned, lane);
    }
    gemm::cp_async_commit();
    T acc = lane < bs ? rt[i * kBlock + lane] : T(0);
    gemm::cp_async_wait<0>();
    __syncwarp();
    if (lane >= bs) dinv[lane * pitch<T>() + lane] = T(1);
    __syncwarp();
    invert_block(dinv, lane);
    T* ring = base + SLOT;
    if (!RESIDENT) {
#pragma unroll
      for (int u = 0; u < kRing; ++u) {
        if (u < nk) {
          const int k = UPPER ? nb - 1 - u : u;
          stage_block(ring + u * SLOT, lt, m, UPPER ? k : i, UPPER ? i : k, p.aligned, lane);
        }
        gemm::cp_async_commit();
      }
    }
    for (int u = 0; u < nk; ++u) {
      const int k = UPPER ? nb - 1 - u : u;
      const T* blk;
      const T* xk;
      if (RESIDENT) {
        blk = base + (UPPER ? k - i : k) * SLOT;
        wait_block(hop::smem_u32(bars + k));
        xk = xs + k * kBlock;
      } else {
        gemm::cp_async_wait<kRing - 1>();
        blk = ring + (u % kRing) * SLOT;
        wait_block(hop::smem_u32(bars + k));
        xw[lane] = k * kBlock + lane < m ? __ldcg(ot + k * kBlock + lane) : T(0);
        __syncwarp();
        xk = xw;
      }
      acc -= UPPER ? col_dot(blk, xk, lane) : row_dot(blk, xk, lane);
      if (!RESIDENT) {
        __syncwarp();
        if (u + kRing < nk) {
          const int k2 = UPPER ? nb - 1 - (u + kRing) : u + kRing;
          stage_block(ring + (u % kRing) * SLOT, lt, m, UPPER ? k2 : i, UPPER ? i : k2, p.aligned, lane);
        }
        gemm::cp_async_commit();
      }
    }
    rw[lane] = acc;
    __syncwarp();
    const T xi = UPPER ? col_dot(dinv, rw, lane) : row_dot(dinv, rw, lane);
    if (lane < bs) ot[i * kBlock + lane] = xi;
    if (RESIDENT) {  // lane l hands its element of x_i to every CTA; the bytes complete their barriers of block i
      const uint32_t dst = hop::smem_u32(xs + i * kBlock + lane), bar = hop::smem_u32(bars + i);
      for (int d = 0; d < C; ++d) st_async(map_rank(dst, d), xi, map_rank(bar, d));
    } else {
      fence_cluster();
      __syncwarp();
      if (lane < C) arrive_remote(map_rank(hop::smem_u32(bars + i), lane));
    }
    __syncwarp();
  }
  if (RESIDENT)  // every x block sent here has landed
    for (int k = threadIdx.x; k < nb; k += kTrsvThreads) wait_block(hop::smem_u32(bars + k));
  cluster.sync();  // no CTA leaves while another may still write its shared memory
}

// The solve's plan, a function of (m, element size) alone: cluster size, variant, shared memory a CTA.
struct TrsvPlan {
  int nb, cluster;
  bool resident;
  size_t smem;
};

inline TrsvPlan trsv_plan(int m, int elem) {
  TrsvPlan pl{};
  pl.nb = (m + kBlock - 1) / kBlock;
  pl.cluster = pl.nb < kMaxCluster ? pl.nb : kMaxCluster;
  const size_t slot = static_cast<size_t>(kBlock) * (kBlock + 16 / elem) * elem;
  const size_t head = (static_cast<size_t>(pl.nb) * 8 + 15) / 16 * 16 + 2 * kTrsvWarps * kBlock * elem;
  // the most blocks a rank stages, for the lower or the upper solve
  size_t most = 0;
  bool few = true;
  for (int c = 0; c < pl.cluster; ++c) {
    size_t lower = 0, upper = 0;
    const int owned = owned_blocks(pl.nb, pl.cluster, c);
    few = few && owned <= kTrsvWarps;
    for (int t = 0; t < owned; ++t) {
      lower += blocks_of_row(pl.nb, c + t * pl.cluster, false);
      upper += blocks_of_row(pl.nb, c + t * pl.cluster, true);
    }
    most = most > lower ? most : lower;
    most = most > upper ? most : upper;
  }
  const size_t resident = head + static_cast<size_t>(pl.nb) * kBlock * elem + most * slot;
  pl.resident = few && resident <= kMaxSmem;
  pl.smem = pl.resident ? resident : head + static_cast<size_t>(kTrsvWarps) * (1 + kRing) * slot;
  return pl;
}

template <typename T>
int gemv_variant(const void* a, const void* x, int m, int n, const long long* sa, const long long* sx) {
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const auto whole = [](long long s) { return s % V == 0; };
  if (sa[4] == 1 || sa[3] != 1) {
    const bool vec = sa[4] == 1 && sx[3] == 1 && n % V == 0 && aligned(a) && aligned(x) && whole(sa[0]) &&
                     whole(sa[1]) && whole(sa[2]) && whole(sa[3]) && whole(sx[0]) && whole(sx[1]) && whole(sx[2]);
    return vec ? kRowsVector : kRowsScalar;
  }
  const bool vec = m % V == 0 && aligned(a) && whole(sa[0]) && whole(sa[1]) && whole(sa[2]) && whole(sa[4]);
  return vec ? kColsVector : kColsScalar;
}

template <typename T>
const void* gemv_kernel(int variant) {
  switch (variant) {
    case kRowsScalar: return reinterpret_cast<const void*>(gemv_rows_kernel<T, false>);
    case kRowsVector: return reinterpret_cast<const void*>(gemv_rows_kernel<T, true>);
    case kColsScalar: return reinterpret_cast<const void*>(gemv_cols_kernel<T, false>);
    default: return reinterpret_cast<const void*>(gemv_cols_kernel<T, true>);
  }
}

template <typename T>
int launch_gemv(const void* a, const void* x, void* out, int nz, int ng, int nq, int m, int n,
                const long long* sa, const long long* sx, int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (nz == 0 || ng == 0 || m == 0) return cudaSuccess;
  if (nz > 65535 || ng > 65535 || static_cast<long long>(nq) * n > INT_MAX) return cudaErrorInvalidValue;
  GemvArgs p{sa[0], sa[1], sa[2], sa[3], sa[4], sx[0], sx[1], sx[2], sx[3], ng, nq, m, n};
  auto st = static_cast<cudaStream_t>(stream);
  const T* ap = static_cast<const T*>(a);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const int variant = gemv_variant<T>(a, x, m, n, sa, sx);
  if (variant == kRowsScalar || variant == kRowsVector) {
    dim3 grid((m + kGemvWarps - 1) / kGemvWarps, ng, nz);
    if (variant == kRowsVector)
      gemv_rows_kernel<T, true><<<grid, kGemvThreads, 0, st>>>(ap, xp, op, p);
    else
      gemv_rows_kernel<T, false><<<grid, kGemvThreads, 0, st>>>(ap, xp, op, p);
  } else {
    constexpr int kSlab = 32 * (16 / sizeof(T));
    dim3 grid((m + kSlab - 1) / kSlab, ng, nz);
    if (variant == kColsVector)
      gemv_cols_kernel<T, true><<<grid, kGemvThreads, 0, st>>>(ap, xp, op, p);
    else
      gemv_cols_kernel<T, false><<<grid, kGemvThreads, 0, st>>>(ap, xp, op, p);
  }
  return cudaGetLastError();
}

template <typename T, bool UPPER, bool RESIDENT>
cudaError_t launch_trsv_variant(const T* l, const T* r, T* out, int nz, int ng, const TrsvArgs& p, size_t smem,
                                int device, cudaStream_t st) {
  auto kernel = trsv_cluster_kernel<T, UPPER, RESIDENT>;
  static bool opted_in[64] = {};  // the attribute is set once a device, to the most any m takes
  if (device < 0 || device >= 64 || !opted_in[device]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) opted_in[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, ng, nz);
  cfg.blockDim = dim3(kTrsvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, l, r, out, p);
}

template <typename T>
const void* trsv_kernel(bool upper, bool resident) {
  if (upper)
    return resident ? reinterpret_cast<const void*>(trsv_cluster_kernel<T, true, true>)
                    : reinterpret_cast<const void*>(trsv_cluster_kernel<T, true, false>);
  return resident ? reinterpret_cast<const void*>(trsv_cluster_kernel<T, false, true>)
                  : reinterpret_cast<const void*>(trsv_cluster_kernel<T, false, false>);
}

template <typename T>
int launch_trsv(const void* l, const void* r, void* out, int nz, int ng, int m, const long long* s, int transpose,
                int device, void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (nz == 0 || ng == 0 || m == 0) return cudaSuccess;
  const TrsvPlan pl = trsv_plan(m, sizeof(T));
  if (pl.smem > kMaxSmem || nz > 65535 || ng > 65535) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(l) % 16 == 0 && m % V == 0 && s[0] % V == 0 && s[1] % V == 0;
  TrsvArgs p{s[0], s[1], s[2], s[3], ng, m, pl.nb, pl.cluster, aligned};
  const T* lp = static_cast<const T*>(l);
  const T* rp = static_cast<const T*>(r);
  T* op = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (transpose)
    err = pl.resident ? launch_trsv_variant<T, true, true>(lp, rp, op, nz, ng, p, pl.smem, device, st)
                      : launch_trsv_variant<T, true, false>(lp, rp, op, nz, ng, p, pl.smem, device, st);
  else
    err = pl.resident ? launch_trsv_variant<T, false, true>(lp, rp, op, nz, ng, p, pl.smem, device, st)
                      : launch_trsv_variant<T, false, false>(lp, rp, op, nz, ng, p, pl.smem, device, st);
  if (err != cudaSuccess) return err;
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

// The variant a launch takes: 0 rows scalar, 1 rows vector, 2 columns scalar, 3 columns vector.
REPRO_EXPORT int tile_gemv_variant(const void* a, const void* x, int m, int n, const long long* sa,
                                   const long long* sx, int is_double) {
  return is_double ? gemv_variant<double>(a, x, m, n, sa, sx) : gemv_variant<float>(a, x, m, n, sa, sx);
}

// CTAs of a variant an SM holds.
REPRO_EXPORT int tile_gemv_ctas_per_sm(int variant, int is_double) {
  int n = 0;
  const void* k = is_double ? gemv_kernel<double>(variant) : gemv_kernel<float>(variant);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kGemvThreads, 0) == cudaSuccess ? n : -1;
}

// The solve's plan at (m, type): what 0 the cluster size, 1 the variant (1 resident, 0 streaming), 2 the shared
// memory of a CTA in bytes; -1 where no variant takes m.
REPRO_EXPORT int tile_trsv_plan(int m, int is_double, int what) {
  const TrsvPlan pl = trsv_plan(m, is_double ? 8 : 4);
  if (m <= 0 || pl.smem > kMaxSmem) return -1;
  return what == 0 ? pl.cluster : what == 1 ? static_cast<int>(pl.resident) : static_cast<int>(pl.smem);
}

// CTAs an SM holds (what 0), or clusters the card holds at once (what 1), of the solve at (m, type).
REPRO_EXPORT int tile_trsv_occupancy(int m, int is_double, int transpose, int what) {
  const TrsvPlan pl = trsv_plan(m, is_double ? 8 : 4);
  if (m <= 0 || pl.smem > kMaxSmem) return -1;
  const void* k = is_double ? trsv_kernel<double>(transpose, pl.resident) : trsv_kernel<float>(transpose, pl.resident);
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem)) != cudaSuccess)
    return -1;
  int n = 0;
  if (what == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kTrsvThreads, pl.smem) == cudaSuccess ? n : -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, 1, 1);
  cfg.blockDim = dim3(kTrsvThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&n, k, &cfg) == cudaSuccess ? n : -1;
}
