// Cholesky factorization of a stack of SPD tiles (POTRF): each tile's blocked
// task DAG, run across the card in one launch.
//
// Replaces: repro/kernels/potrf_tile.py::_potrf_kernel (through potrf), which
// the JAX executor vmaps over the diagonal tiles of a level.  Here the whole
// (G, m, m) stack is one launch.
//
// Computes out[g] = tril(chol(in[g])), reading only the lower triangle of
// in[g].  A non-positive pivot d2 gives NaN there (d2 * rsqrt(d2)), as
// jnp.sqrt does for a negative one, and the NaN runs on through the solves
// and updates; nothing raises.  float and double are both
// kept, as the Pallas kernel keeps float64.
//
// What bounds it on the H100: neither bytes nor FLOP, but latency.  A tile is
// m^3/3 FLOP (45 MFLOP at m = 512, 0.67 us at the FP32 peak) and 1 MiB in
// f32, and the fused program issues one POTRF per level with G = 1, so the
// time of a launch is the length of the tile's dependency chain.  The design
// spreads the tile over the card and keeps the chain short: the tile's own
// blocked Cholesky DAG (the paper's HPX tile DAG, moved inside one kernel).
// Its chain is T block steps; each is a 32-pivot factorization, a release,
// an L2 hop to the CTA below, a solve, a release, and the next diagonal
// CTA's hop and last update; the other FLOP run off the chain, on the rest
// of the card.
//
// * Blocks and grid.  Each tile is cut into NB x NB blocks, NB = 32: T =
//   ceil(m / NB) block rows and T(T+1)/2 lower blocks (136 at m = 512, 528 at
//   m = 1024).  One CTA of 64 threads per lower block of every tile: a grid
//   of G T(T+1)/2.  Each CTA owns its block (i, j) for the whole
//   factorization, left-looking ("owner computes"):
//     1. it reads A_ij once into registers (a 4 x 4 patch per thread); past
//        the ragged edge the block is zero, and the diagonal block's pad is
//        the identity, so the pad factors to the identity and never mixes
//        with the valid region;
//     2. for k = 0 .. j-1 it subtracts L_ik L_jk^T;
//     3. i == j: one warp factors the block in shared memory, __syncwarp
//        only (lane r holds row r in registers; column c is broadcast
//        through shared memory at step c);
//        i > j: it waits for L_jj, and one warp solves X L_jj^T = C (lane r
//        solves row r in registers);
//     4. it writes L_ij once to a packed workspace (the copy the consumers
//        read: one NB x NB block each, transposed, zero-padded and 16-byte
//        aligned whatever m is), releases the block's flag, then writes L_ij
//        into out and zeroes out's mirrored strict-upper block (j, i).
// * Tickets, not blockIdx.  Each CTA starts with t = atomicAdd(counter, 1)
//   and maps t to (g, i, j): tile by tile, then column-major through the
//   lower triangle (column j, then i >= j).  Everything (g, i, j) waits on,
//   (i, k) and (j, k) for k < j and (j, j), has a lower ticket, so it is
//   held by a CTA that already runs; spin-waits cannot deadlock for any G or
//   m.  (The argument of CUB's decoupled look-back.  CUDA makes no such
//   promise for the order of blockIdx.)
// * Flags with explicit memory order.  The producing warp writes its block,
//   __syncwarp orders the lanes' stores before lane 0, and lane 0 stores
//   ready[g][i][j] = 1 with release semantics (cuda::atomic_ref, device
//   scope: the store's own fence.acq_rel.gpu is the __threadfence, and it is
//   cumulative over the warp's stores, as in cooperative groups' grid sync).
//   A consumer's thread 0 spins on acquire loads, with no sleep between
//   them, then the CTA syncs.  (A __threadfence by every lane before the
//   release would put a second fence on the chain of every block step.)
//   Flags are released whatever the values, so a NaN never hangs the grid.
//   The wrapper allocates the counter and G T^2 flags zeroed (torch.zeros on
//   the caller's stream) for every call: a memset, not an epoch counter.
//   The kernel allocates nothing.
// * Asynchronous operand loads.  L_ik and L_jk come from the workspace into
//   shared memory with cp.async.cg (16 bytes, through L2: the blocks are
//   written by other SMs), double-buffered: while block k is multiplied, the
//   loads of k+1 are in flight if its flags are already set (a poll that
//   never blocks), so a CTA waits only for the block it multiplies next.
// * Multiply.  Register-tiled FFMA: each thread owns a 4 x 4 patch of C and
//   reads two 4-vectors from shared memory per step of k (8 FMAs per load);
//   float32 stays IEEE FFMA (no TF32), float64 is DFMA.
// * Determinism.  No atomics touch the arithmetic, and every sum runs in a
//   fixed order: two calls on the same input give bitwise-equal output.
//
// A refused launch returns its cudaError_t; the wrapper raises it.  The
// shared memory is static (20,752 bytes in f32, 41,488 in f64).
#include <cuda/atomic>

#include <climits>

#include "common.cuh"

namespace {

constexpr int NB = 32;                // block edge (BLOCK in ../potrf_tile.py)
constexpr int THREADS = 64;           // 8 x 8 threads, one 4 x 4 patch each
constexpr int PATCH = 4;
constexpr int GRID_SIDE = NB / PATCH;
constexpr int BLOCK_ELEMS = NB * NB;
constexpr int LD = NB + 1;            // padded row stride of the staging block

using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(double (&v)[4], const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// one row of NB values from 16-byte aligned shared memory
template <typename T>
__device__ __forceinline__ void load_row(T (&v)[NB], const T* p) {
#pragma unroll
  for (int q = 0; q < NB; q += 4) {
    T w[4];
    load4(w, p + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[q + e] = w[e];
  }
}

__device__ __forceinline__ bool is_set(int* flag) {
  return flag_ref(*flag).load(cuda::memory_order_acquire) != 0;
}

// Thread 0 spins on acquire loads until both flags are set; then the CTA
// syncs.  No sleep between loads: each is an L2 round trip already.
__device__ __forceinline__ void wait_flags(int* f0, int* f1) {
  if (threadIdx.x == 0) {
    while (!(is_set(f0) && is_set(f1))) {
    }
  }
  __syncthreads();
}

// Offset of lower block (i, j) of tile g in the packed workspace: tile by
// tile, column-major through the lower triangle (the ticket order).
__device__ __forceinline__ size_t block_offset(int g, int i, int j, int t_rows) {
  const int per_tile = t_rows * (t_rows + 1) / 2;
  const int p = j * t_rows - j * (j - 1) / 2 + (i - j);
  return (static_cast<size_t>(g) * per_tile + p) * BLOCK_ELEMS;
}

// Lane r holds row r of C (x); factors C = L L^T in place.  f is NB x NB of
// shared scratch: column c of the partly factored block goes to f[c][*] at
// step c, so no step overwrites what another lane may still read.  The
// chain from one pivot to the next is a shared-memory round trip, one
// reciprocal square root and three multiply-adds: rsqrt of a negative pivot
// is NaN, and so is the pivot's square root d2 * rsqrt(d2) when d2 <= 0.
template <typename T>
__device__ __forceinline__ void factor_rows(T (&x)[NB], T* f, int lane) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    f[c * NB + lane] = x[c];
    __syncwarp();
    T col[NB];
    load_row(col, f + c * NB);
    const T rs = dev_rsqrt(col[c]);
    const T l = x[c] * rs;       // L[lane][c] for lane > c
    const T s = l * rs;          // times col[cc]: L[lane][c] L[cc][c]
#pragma unroll
    for (int cc = c + 1; cc < NB; ++cc) x[cc] -= s * col[cc];
    x[c] = lane > c ? l : (lane == c ? col[c] * rs : T(0));
  }
}

// Lane r holds row r of C (x); solves X L^T = C in place.  lt[q][c] = L[c][q];
// inv is NB values of shared scratch for the diagonal's reciprocals.
template <typename T>
__device__ __forceinline__ void solve_rows(T (&x)[NB], const T* lt, T* inv, int lane) {
  inv[lane] = T(1) / lt[lane * NB + lane];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    T row[NB];                   // column c of L: row[cc] = L[cc][c]
    load_row(row, lt + c * NB);
    x[c] *= inv[c];
#pragma unroll
    for (int cc = c + 1; cc < NB; ++cc) x[cc] -= x[c] * row[cc];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) potrf_kernel(
    const T* __restrict__ in, T* __restrict__ out, T* work, int* sync, int m, int t_rows) {
  __shared__ __align__(16) T operand[2][2][BLOCK_ELEMS];   // [buffer][L_ik^T, L_jk^T]
  __shared__ T stage[NB][LD];                               // C_ij, then L_ij, by rows
  __shared__ T s_inv[NB];
  __shared__ int s_block[3];
  __shared__ int s_ready;

  const int tid = threadIdx.x;
  if (tid == 0) {  // ticket -> (g, i, j)
    const int ticket = atomicAdd(sync, 1);
    const int per_tile = t_rows * (t_rows + 1) / 2;
    const int g = ticket / per_tile;
    int r = ticket - g * per_tile, j = 0;
    while (r >= t_rows - j) {
      r -= t_rows - j;
      ++j;
    }
    s_block[0] = g;
    s_block[1] = j + r;
    s_block[2] = j;
  }
  __syncthreads();
  const int g = s_block[0], i = s_block[1], j = s_block[2];
  int* ready = sync + 1 + static_cast<size_t>(g) * t_rows * t_rows;
  auto flag = [&](int bi, int bj) { return ready + bi * t_rows + bj; };

  // 1. A_ij into registers: zero past the edge, identity on the diagonal's pad
  const size_t mm = static_cast<size_t>(m) * m;
  const T* a = in + g * mm;
  const int tr = tid / GRID_SIDE, tc = tid % GRID_SIDE;
  T acc[PATCH][PATCH];
#pragma unroll
  for (int u = 0; u < PATCH; ++u) {
    const int gr = i * NB + PATCH * tr + u;
#pragma unroll
    for (int v = 0; v < PATCH; ++v) {
      const int gc = j * NB + PATCH * tc + v;
      acc[u][v] = (gr < m && gc < m) ? a[static_cast<size_t>(gr) * m + gc]
                                     : (gr == gc ? T(1) : T(0));
    }
  }

  // 2. C_ij = A_ij - sum_k L_ik L_jk^T, operands double-buffered
  constexpr int CHUNKS = BLOCK_ELEMS * static_cast<int>(sizeof(T)) / 16;
  T* const ops = &operand[0][0][0];
  auto buffer = [&](int k, int which) { return ops + (2 * (k & 1) + which) * BLOCK_ELEMS; };
  int* const ready_s = &s_ready;
  auto issue = [&](int k) {
    const char* src_i = reinterpret_cast<const char*>(work + block_offset(g, i, k, t_rows));
    const char* src_j = reinterpret_cast<const char*>(work + block_offset(g, j, k, t_rows));
    char* dst_i = reinterpret_cast<char*>(buffer(k, 0));
    char* dst_j = reinterpret_cast<char*>(buffer(k, 1));
    for (int c = tid; c < CHUNKS; c += THREADS) {
      cp_async16(dst_i + 16 * c, src_i + 16 * c);
      if (i != j) cp_async16(dst_j + 16 * c, src_j + 16 * c);
    }
    cp_async_commit();
  };
  auto poll = [&](int k) {  // both operands of k ready?  (never blocks)
    if (tid == 0) *ready_s = is_set(flag(i, k)) && is_set(flag(j, k));
    __syncthreads();
    return *ready_s != 0;
  };
  int issued = 0;
  for (int k = 0; k < j; ++k) {
    if (issued == k) {
      wait_flags(flag(i, k), flag(j, k));
      issue(k);
      ++issued;
    }
    if (issued < j && poll(issued)) {
      issue(issued);
      ++issued;
    }
    if (issued > k + 1) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* lik = buffer(k, 0);
    const T* ljk = buffer(k, i == j ? 0 : 1);
#pragma unroll 4
    for (int q = 0; q < NB; ++q) {
      T av[PATCH], bv[PATCH];
      load4(av, lik + q * NB + PATCH * tr);
      load4(bv, ljk + q * NB + PATCH * tc);
#pragma unroll
      for (int u = 0; u < PATCH; ++u) {
#pragma unroll
        for (int v = 0; v < PATCH; ++v) acc[u][v] -= av[u] * bv[v];
      }
    }
    __syncthreads();
  }

  // 3. factor (i == j) or solve against L_jj (i > j), one warp
#pragma unroll
  for (int u = 0; u < PATCH; ++u) {
#pragma unroll
    for (int v = 0; v < PATCH; ++v) stage[PATCH * tr + u][PATCH * tc + v] = acc[u][v];
  }
  T* scratch = ops;  // buffer 0, free after the last update
  if (i > j) {
    wait_flags(flag(j, j), flag(j, j));
    const char* src = reinterpret_cast<const char*>(work + block_offset(g, j, j, t_rows));
    for (int c = tid; c < CHUNKS; c += THREADS) {
      cp_async16(reinterpret_cast<char*>(scratch) + 16 * c, src + 16 * c);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    T x[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) x[q] = stage[lane][q];
    if (i == j) {
      factor_rows(x, scratch, lane);
    } else {
      solve_rows(x, scratch, s_inv, lane);
    }
    // 4. the consumers' copy (transposed, coalesced), then the flag
    T* dst = work + block_offset(g, i, j, t_rows);
#pragma unroll
    for (int q = 0; q < NB; ++q) dst[q * NB + lane] = x[q];
    __syncwarp();  // orders the lanes' stores before lane 0's release
    if (lane == 0) flag_ref(*flag(i, j)).store(1, cuda::memory_order_release);
#pragma unroll
    for (int q = 0; q < NB; ++q) stage[lane][q] = x[q];
  }
  __syncthreads();

  // L_ij into out, and zeros into the mirrored block (j, i)
  T* o = out + g * mm;
  for (int e = tid; e < BLOCK_ELEMS; e += THREADS) {
    const int r = e / NB, c = e % NB;
    const int gr = i * NB + r, gc = j * NB + c;
    if (gr < m && gc < m) o[static_cast<size_t>(gr) * m + gc] = stage[r][c];
    if (i != j) {
      const int ur = j * NB + r, uc = i * NB + c;
      if (uc < m) o[static_cast<size_t>(ur) * m + uc] = T(0);
    }
  }
}

template <typename T>
int launch(const void* in, void* out, void* work, void* sync, int n_tiles, int m, int device,
           void* stream) {
  cudaError_t err = repro_set_device(device);
  if (err != cudaSuccess) return err;
  if (n_tiles == 0 || m == 0) return cudaSuccess;
  const int t_rows = (m + NB - 1) / NB;
  const long long blocks = static_cast<long long>(n_tiles) * t_rows * (t_rows + 1) / 2;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  potrf_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<T*>(work),
      static_cast<int*>(sync), m, t_rows);
  return cudaGetLastError();
}

}  // namespace

// in, out: (n_tiles, m, m); work: n_tiles T(T+1)/2 NB^2 values (no init);
// sync: 1 + n_tiles T^2 ints, zeroed (the ticket counter, then the flags).
REPRO_EXPORT int potrf_f32(const void* in, void* out, void* work, void* sync, int n_tiles, int m,
                           int device, void* stream) {
  return launch<float>(in, out, work, sync, n_tiles, m, device, stream);
}

REPRO_EXPORT int potrf_f64(const void* in, void* out, void* work, void* sync, int n_tiles, int m,
                           int device, void* stream) {
  return launch<double>(in, out, work, sync, n_tiles, m, device, stream);
}
