// Schur point-block reduction for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel se2lam_tpu/solver/pallas_schur.py:
// schur_reduce_pallas (body `_kernel`). With A the pose-point coupling
// matrix Hpx viewed as (3K, 3M) (the solver's [k,a],[m,b] layout makes the
// view free) and X the M inverted 3x3 point blocks Hxx⁻¹, it computes
//   S[p, q] = Σ_m Σ_{b,d} A[p, 3m+b] · X[m, b, d] · A[q, 3m+d]
// i.e. S = A · blockdiag(X) · Aᵀ, the (3K, 3K) matrix the local and global
// BA subtract from Hpp. The intermediate T = A · blockdiag(X) is never
// written to device memory.
//
// Bound: operations. S is symmetric, so the function needs T and one
// triangle of S, 2·M·(9·3K + 3·3K(3K+1)/2) f32 operations, against
// 4·(9KM + 9M + 9K²) bytes; at the local-BA shape (K, M) = (48, 2048) that
// is 134 MFLOP (2.0 µs at 67 TFLOP/s) against 3.7 MB (1.1 µs at
// 3.35 TB/s). At that shape the time is set by latency and parallelism,
// not by the FLOP rate: S has only 5x5 tiles of 32x32, and M is a long
// serial sum.
//
// Design. The grid covers the tile pairs (i <= j) of S only: an
// off-diagonal tile is stored at (i, j) and mirrored to (j, i), so S is
// bitwise symmetric outside its diagonal 3x3 blocks (inside a diagonal
// tile, an entry of a lower pose block is the mirror of the upper one) and
// the kernel does half the work of the full S. Each tile pair is one
// thread-block cluster of 8 CTAs that split M: points go in fixed chunks
// of 32 at absolute offsets (chunk c is points 32c..32c+31) and chunk c
// goes to rank c % 8, so the grouping of the sums never depends on M and
// zeroed point columns add exact zeros (a call at M and one at M + zeros
// give the same bits). A rank streams its chunks through 4 shared-memory
// stages with cp.async (the 32x96 A panels of its row and column tiles and
// the 32 Hxx⁻¹ blocks), so 3 chunks load while one computes; forms
// U = X·A_col in place of the column panel (the TPU kernel's T, held only
// on chip); then its 256 threads, 4 groups of 64, each group on 24 of the
// chunk's 96 columns, accumulate a 4x4 register tile of A_row·Uᵀ a
// thread, one chunk partial at a time (a two-level sum, as the f32 error
// of a 3M-term dot product wants), from float4 shared loads: 8 loads feed
// 64 FMAs. Last, the groups' tiles are summed in group order into the
// rank's partial tile in its shared memory, the cluster syncs, and rank r
// sums rows 4r..4r+3 of the tile over ranks 0..7 in rank order through
// distributed shared memory and stores them. One launch, no scratch
// buffer, no atomics: the same bits on every run. At (48, 2048) that is
// 15 tile pairs x 8 = 120 CTAs of 8 warps on 132 SMs, each walking 1/8 of
// M. Rows and columns past 3K and points past M are zero-filled by the
// copies' source size. There is no limit on K. At (256, 8192) the 32x32 tiles re-read
// each A panel from L2 for every tile pair that uses it (1.9 GB in all);
// larger tiles or tensor cores are the global-BA shape's later work.
//
// No tensor cores. TF32 keeps ~3 decimal digits, while the damped local-BA
// system must come within 1e-5 of max|S| of the f64 result, and plain f32
// already reads 4e-6 to 8e-6 there: its products cancel. 3xTF32 would
// recover the digits, but the local-BA shape has ~2 µs of f32 work, so
// latency and parallelism, not the FLOP rate, set its time. Tensor cores
// for the (256, 8192) global-BA shape are later work, once loop closing
// runs it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;                 // S tile edge
constexpr int TD = 8;                    // threads per tile edge; 4x4 outputs each
constexpr int KG = 4;                    // column groups: group g takes a chunk's columns [24g, 24g+24)
constexpr int THREADS = KG * TD * TD;
constexpr int RANKS = 8;                 // CTAs per cluster; chunk c goes to rank c % RANKS
constexpr int MC = 32;                   // points per chunk
constexpr int CW = 3 * MC;               // A columns per chunk
constexpr int LD = CW + 4;               // shared row stride: 16-byte rows, no bank conflicts
constexpr int PANEL = TILE * LD;         // floats in one A panel
constexpr int XCH = 9 * MC;              // floats of Hxx⁻¹ per chunk
constexpr int STAGE = 2 * PANEL + XCH;   // row panel, column panel, Hxx⁻¹ blocks
constexpr int NSTAGE = 4;                // chunks in flight: 3 load while 1 computes
constexpr int SMEM_BYTES = NSTAGE * STAGE * (int)sizeof(float);
constexpr int LDP = TILE + 1;            // partial-tile row stride
constexpr int GW = CW / KG;              // columns per group

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes; `bytes` < 16 reads that many and zero-fills the rest
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes, or a zero when `bytes` is 0
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copies of chunk `chunk` into stage `st`. VEC: 16-byte copies
// (A and X 16-byte aligned and M % 4 == 0, so every row and the ragged
// column edge fall on 16 bytes); otherwise 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* st, const float* __restrict__ A,
                                           const float* __restrict__ X, int R, int M,
                                           int row0, int col0, int chunk, int tid) {
  const long long C = 3LL * M;
  const long long c0 = (long long)CW * chunk;
  const int cw = (int)((C - c0) < CW ? (C - c0) : CW);   // valid columns
  if (VEC) {
    constexpr int Q = CW / 4;
    for (int i = tid; i < 2 * TILE * Q; i += THREADS) {
      const int panel = i / (TILE * Q);
      const int k = i - panel * (TILE * Q);
      const int r = k / Q, q = k - r * Q;
      const int g = (panel ? col0 : row0) + r;
      const bool in = g < R && 4 * q < cw;
      cp16(st + panel * PANEL + r * LD + 4 * q, in ? A + g * C + c0 + 4 * q : A, in ? 16 : 0);
    }
    const long long x0 = (long long)XCH * chunk, xn = 9LL * M;
    for (int i = tid; i < XCH / 4; i += THREADS) {
      const long long e = x0 + 4 * i;
      const int bytes = e >= xn ? 0 : (xn - e >= 4 ? 16 : (int)(4 * (xn - e)));
      cp16(st + 2 * PANEL + 4 * i, bytes ? X + e : X, bytes);
    }
  } else {
    for (int i = tid; i < 2 * TILE * CW; i += THREADS) {
      const int panel = i / (TILE * CW);
      const int k = i - panel * (TILE * CW);
      const int r = k / CW, c = k - r * CW;
      const int g = (panel ? col0 : row0) + r;
      const bool in = g < R && c < cw;
      cp4(st + panel * PANEL + r * LD + c, in ? A + g * C + c0 + c : A, in ? 4 : 0);
    }
    const long long x0 = (long long)XCH * chunk, xn = 9LL * M;
    for (int i = tid; i < XCH; i += THREADS) {
      const bool in = x0 + i < xn;
      cp4(st + 2 * PANEL + i, in ? X + x0 + i : X, in ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(THREADS)
schur_reduce_kernel(const float* __restrict__ A, const float* __restrict__ X,
                    float* __restrict__ S, int R, int M) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, tx = tid % TD, ty = (tid / TD) % TD, grp = tid / (TD * TD);

  // this cluster's tile pair (ti <= tj)
  const int nt = (R + TILE - 1) / TILE;
  int ti = 0, p = blockIdx.x / RANKS;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int row0 = ti * TILE, col0 = tj * TILE;
  const int nchunk = (M + MC - 1) / MC;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // this rank's k-th chunk is chunk rank + 8k, in stage k % NSTAGE, and
  // its copies are commit group k
#pragma unroll
  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (rank + RANKS * k < nchunk)
      load_chunk<VEC>(smem + k * STAGE, A, X, R, M, row0, col0, rank + RANKS * k, tid);
    cp_commit();
  }
  for (int k = 0, chunk = rank; chunk < nchunk; ++k, chunk += RANKS) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();   // chunk k has landed; chunk k-1's stage is no longer read
    const int ahead = chunk + RANKS * (NSTAGE - 1);
    if (ahead < nchunk)
      load_chunk<VEC>(smem + ((k + NSTAGE - 1) % NSTAGE) * STAGE, A, X, R, M, row0, col0,
                      ahead, tid);
    cp_commit();

    float* ar = smem + (k % NSTAGE) * STAGE;
    float* ac = ar + PANEL;
    const float* xs = ar + 2 * PANEL;
    // U[q, 3m+b] = Σ_d X[m, b, d] · A[q, 3m+d], in place of the column panel
    for (int i = tid; i < TILE * MC; i += THREADS) {
      const int q = i / MC, m = i - q * MC;
      float* a = ac + q * LD + 3 * m;
      const float* x = xs + 9 * m;
      const float a0 = a[0], a1 = a[1], a2 = a[2];
      a[0] = x[0] * a0 + x[1] * a1 + x[2] * a2;
      a[1] = x[3] * a0 + x[4] * a1 + x[5] * a2;
      a[2] = x[6] * a0 + x[7] * a1 + x[8] * a2;
    }
    __syncthreads();

    // the chunk's partial first, then into the running total
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll
    for (int k4 = 0; k4 < GW; k4 += 4) {
      const int c = grp * GW + k4;
      float4 r[4], u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const float4*>(ar + (ty + TD * i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[j] = *reinterpret_cast<const float4*>(ac + (tx + TD * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[i][j] += r[i].x * u[j].x;
          part[i][j] += r[i].y * u[j].y;
          part[i][j] += r[i].z * u[j].z;
          part[i][j] += r[i].w * u[j].w;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
  cp_wait<0>();
  __syncthreads();   // every stage is no longer read

  // the groups' partial tiles, then this rank's (their sum in group
  // order, in place of group 0's) in its own shared memory
  float* mine = smem;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mine[grp * TILE * LDP + (ty + TD * i) * LDP + tx + TD * j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int o = (e / TILE) * LDP + e % TILE;
    float v = mine[o];
#pragma unroll
    for (int g = 1; g < KG; ++g) v += mine[g * TILE * LDP + o];
    mine[o] = v;
  }
  cluster.sync();

  // rank r: rows [4r, 4r+4) of the tile, summed over the ranks in rank order
  constexpr int ROWS = TILE / RANKS;
  for (int e = tid; e < ROWS * TILE; e += THREADS) {
    const int rr = rank * ROWS + e / TILE, cc = e % TILE;
    float v = cluster.map_shared_rank(mine, 0)[rr * LDP + cc];
#pragma unroll
    for (int src = 1; src < RANKS; ++src) v += cluster.map_shared_rank(mine, src)[rr * LDP + cc];
    const int pr = row0 + rr, qc = col0 + cc;
    if (pr < R && qc < R) {
      // a diagonal tile keeps its upper pose blocks and mirrors them
      const bool store = ti != tj || pr / 3 <= qc / 3;
      const bool mirror = ti != tj || pr / 3 < qc / 3;
      if (store) S[(long long)pr * R + qc] = v;
      if (mirror) S[(long long)qc * R + pr] = v;
    }
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

template <bool VEC>
cudaError_t launch(const float* A, const float* X, float* S, int R, int M,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      schur_reduce_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const int nt = (R + TILE - 1) / TILE;
  const unsigned grid = (unsigned)RANKS * (unsigned)(nt * (nt + 1) / 2);
  schur_reduce_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(A, X, S, R, M);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. A: (R, 3M) row-major, X: (M, 3, 3), S: (R, R),
// all f32 and contiguous, R = 3K. Launches on `stream`, allocates nothing,
// and returns the launch's cudaError_t so the caller sees a refused launch.
extern "C" int se2lam_schur_reduce(const float* A, const float* X, float* S,
                                   int R, int M, void* stream) {
  if (R <= 0) return 0;
  const bool vec = M % 4 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)X % 16 == 0;
  return (int)(vec ? launch<true>(A, X, S, R, M, (cudaStream_t)stream)
                   : launch<false>(A, X, S, R, M, (cudaStream_t)stream));
}
