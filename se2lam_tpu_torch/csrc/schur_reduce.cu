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
// 3.35 TB/s). This kernel computes the full S, 260 MFLOP there. No tensor
// cores and no TF32: the JAX einsum route is full f32.
//
// Design (simple and right first): one CTA of 16x16 threads owns one
// 32x32 tile of S; each thread owns a 2x2 block of it in registers. The
// CTA walks the points in chunks of 32 (96 columns of A): it stages the
// chunk's A-rows of its row tile and of its column tile and the chunk's
// 32 Hxx⁻¹ blocks in shared memory, forms U[q, 3m+b] = Σ_d X[m,b,d]·
// A[q, 3m+d] for the column tile in shared memory (the TPU kernel's T,
// held only on chip), then accumulates A_rowtile · U_colᵀ. The 3x3 blocks
// are indexed directly: the TPU kernel's 384-column tiles and host-built
// block-diagonal masks exist for Mosaic's lack of gathers and are not
// carried over. Each output has one owner and a fixed summation order, so
// results are the same run to run; there are no atomics. Rows and columns
// past 3K and points past M are zero-filled, so they add exact zeros, as
// do zeroed (invalid) point columns. There is no limit on K. At
// (48, 2048) the grid is only 5x5 CTAs on 132 SMs: splitting M across
// CTAs, wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;        // S tile edge
constexpr int MC = 32;          // points per chunk
constexpr int CW = 3 * MC;      // A columns per chunk
constexpr int LD = CW + 1;      // padded shared row stride (no bank conflicts)
constexpr int TD = 16;          // threads per block edge; 2x2 outputs each

__global__ void __launch_bounds__(TD * TD)
schur_reduce_kernel(const float* __restrict__ A, const float* __restrict__ X,
                    float* __restrict__ S, int R, int M) {
  __shared__ float a_row[TILE][LD];
  __shared__ float a_col[TILE][LD];
  __shared__ float u_col[TILE][LD];
  __shared__ float xs[MC * 9];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TD + tx;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const long long C = 3LL * M;

  float acc00 = 0.0f, acc01 = 0.0f, acc10 = 0.0f, acc11 = 0.0f;

  for (int m0 = 0; m0 < M; m0 += MC) {
    const long long c0 = 3LL * m0;
    const int cw = (int)((C - c0) < CW ? (C - c0) : CW);
    for (int i = tid; i < TILE * CW; i += TD * TD) {
      const int r = i / CW, c = i - r * CW;
      float vr = 0.0f, vc = 0.0f;
      if (c < cw) {
        if (row0 + r < R) vr = A[(long long)(row0 + r) * C + c0 + c];
        if (col0 + r < R) vc = A[(long long)(col0 + r) * C + c0 + c];
      }
      a_row[r][c] = vr;
      a_col[r][c] = vc;
    }
    for (int i = tid; i < MC * 9; i += TD * TD) {
      xs[i] = (9LL * m0 + i < 9LL * M) ? X[9LL * m0 + i] : 0.0f;
    }
    __syncthreads();

    // U[q, 3m+b] = Σ_d X[m, b, d] · A[q, 3m+d], for the column tile
    for (int i = tid; i < TILE * CW; i += TD * TD) {
      const int q = i / CW, c = i - q * CW;
      const int m = c / 3, b = c - 3 * m;
      const float* x = &xs[m * 9 + b * 3];
      const float* a = &a_col[q][3 * m];
      u_col[q][c] = x[0] * a[0] + x[1] * a[1] + x[2] * a[2];
    }
    __syncthreads();

    // the chunk's partial sums first, then into the running total: a
    // two-level sum keeps the f32 rounding error of a 3M-term dot product
    // near that of a 96-term one plus a 3M/96-term one
    float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 8
    for (int c = 0; c < CW; ++c) {
      const float r0 = a_row[ty][c], r1 = a_row[ty + TD][c];
      const float u0 = u_col[tx][c], u1 = u_col[tx + TD][c];
      s00 += r0 * u0;
      s01 += r0 * u1;
      s10 += r1 * u0;
      s11 += r1 * u1;
    }
    acc00 += s00;
    acc01 += s01;
    acc10 += s10;
    acc11 += s11;
    __syncthreads();
  }

  const int p0 = row0 + ty, p1 = row0 + ty + TD;
  const int q0 = col0 + tx, q1 = col0 + tx + TD;
  if (p0 < R && q0 < R) S[(long long)p0 * R + q0] = acc00;
  if (p0 < R && q1 < R) S[(long long)p0 * R + q1] = acc01;
  if (p1 < R && q0 < R) S[(long long)p1 * R + q0] = acc10;
  if (p1 < R && q1 < R) S[(long long)p1 * R + q1] = acc11;
}

}  // namespace

// Plain C entry for ctypes. A: (R, 3M) row-major, X: (M, 3, 3), S: (R, R),
// all f32 and contiguous, R = 3K. Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int se2lam_schur_reduce(const float* A, const float* X, float* S,
                                   int R, int M, void* stream) {
  if (R <= 0) return 0;
  dim3 block(TD, TD);
  dim3 grid((R + TILE - 1) / TILE, (R + TILE - 1) / TILE);
  schur_reduce_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(A, X, S, R, M);
  return (int)cudaGetLastError();
}
