// Gated best/second Hamming match for Hopper (sm_90a).
//
// Replaces the TPU kernel se2lam_tpu/frontend/pallas_match.py:
// windowed_top2 (body `_kernel`). For every row r of N1 (a projected map
// point) against every column c of N2 (a frame feature) it computes
//   dist(r, c) = (256 − <d1[r], d2[c]>) / 2      (±1 int8 descriptors)
// gated by |x2[c] − px[r]| ≤ win[r], |y2[c] − py[r]| ≤ win[r],
// lo[r] ≤ oct2[c] ≤ hi[r], valid1[r] and valid2[c], and returns per row
//   best      = min over gated columns (1e9 if none),
//   argbest   = the lowest column reaching it (0 if none),
//   second    = min over gated columns other than argbest (1e9 if none),
//   argsecond = the lowest such column (0 if there is no second),
// which is exactly the dense two-pass min/argmin of the plain version
// (windowed_match.py:windowed_top2_plain). The N1×N2 matrix never exists.
//
// Bound: operations. The function needs the gate on all N1·N2 pairs
// (~10 f32 operations each) and a dot product of 256 int8 values (512
// operations) for each pair the gate lets through: a few thousand of the
// 8.19 M pairs at (8192, 1000) on a localization frame, which with the
// H100's 67 TFLOP/s f32 and 1,979 TOP/s int8 rates gives ~1.2 µs, against
// ~2.7 MB of inputs and outputs (0.8 µs at 3.35 TB/s). A dot product for
// every pair would take 2.1 µs at the int8 rate. This kernel uses no
// tensor cores: it takes a dot product only for a pair its gate lets
// through.
//
// Design (simple and right first): one thread owns one row and keeps its
// 256-byte descriptor in 64 registers and its running (best, second,
// argbest, argsecond) in four more. A block of 64 rows walks all columns
// in ascending order, in chunks of 64 staged in shared memory (16 KB of
// descriptors plus their attributes); every thread of a warp reads the
// same column at once, a broadcast. A gated pair's dot product is 64
// __dp4a over the int8 words in four independent sums, an exact integer
// even where an invalid slot holds zeros. Strict "<" updates in ascending
// column order give the lowest-column tie order; an old best drops to second with its column,
// which is the lowest column at that distance. The gate is f32 compares
// of f32 differences, no FMA, as in the plain version. A block whose rows
// are all invalid writes the empty result and returns. Each output has one
// owner: results are the same run to run. The TPU's 128-row padding, bf16
// cast and transposed attribute block are not carried over. An int8 MMA
// over the gate's survivors, and splitting columns across blocks, are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;        // rows (threads) per block
constexpr int CCH = 64;         // columns per shared-memory chunk
constexpr int WORDS = 64;       // int32 words in a 256-byte descriptor
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(ROWS)
windowed_top2_kernel(const int8_t* __restrict__ d1, const float* __restrict__ xy1,
                     const float* __restrict__ win, const float* __restrict__ lo,
                     const float* __restrict__ hi, const uint8_t* __restrict__ v1,
                     const int8_t* __restrict__ d2, const float* __restrict__ xy2,
                     const int32_t* __restrict__ oct2, const uint8_t* __restrict__ v2,
                     int N1, int N2, float* __restrict__ best_out,
                     float* __restrict__ second_out, int32_t* __restrict__ arg_out,
                     int32_t* __restrict__ arg2_out) {
  __shared__ int4 s_desc[CCH][WORDS / 4];
  __shared__ float s_x[CCH], s_y[CCH], s_oct[CCH];
  __shared__ int s_ok[CCH];

  const int t = threadIdx.x;
  const int row = blockIdx.x * ROWS + t;
  const bool active = row < N1 && v1[row] != 0;

  float best = BIG, second = BIG;
  int arg = 0, arg2 = 0;

  if (__syncthreads_or(active)) {
    int rd[WORDS];
    float px = 0.0f, py = 0.0f, w = 0.0f, l = 0.0f, h = 0.0f;
    if (active) {
      const int4* src = reinterpret_cast<const int4*>(d1 + (long long)row * 256);
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q) {
        const int4 v = src[q];
        rd[4 * q] = v.x;
        rd[4 * q + 1] = v.y;
        rd[4 * q + 2] = v.z;
        rd[4 * q + 3] = v.w;
      }
      px = xy1[2LL * row];
      py = xy1[2LL * row + 1];
      w = win[row];
      l = lo[row];
      h = hi[row];
    } else {
#pragma unroll
      for (int k = 0; k < WORDS; ++k) rd[k] = 0;
    }

    for (int c0 = 0; c0 < N2; c0 += CCH) {
      const int n = (N2 - c0) < CCH ? (N2 - c0) : CCH;
      __syncthreads();   // the previous chunk is no longer read
      for (int i = t; i < CCH * (WORDS / 4); i += ROWS) {
        const int j = i / (WORDS / 4), q = i - j * (WORDS / 4);
        s_desc[j][q] = j < n
            ? reinterpret_cast<const int4*>(d2 + (long long)(c0 + j) * 256)[q]
            : make_int4(0, 0, 0, 0);
      }
      if (t < CCH) {
        const bool in = t < n;
        s_x[t] = in ? xy2[2LL * (c0 + t)] : 0.0f;
        s_y[t] = in ? xy2[2LL * (c0 + t) + 1] : 0.0f;
        s_oct[t] = in ? (float)oct2[c0 + t] : 0.0f;
        s_ok[t] = in && v2[c0 + t] != 0;
      }
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < n; ++j) {
        const float o = s_oct[j];
        const bool gate = s_ok[j] && fabsf(s_x[j] - px) <= w && fabsf(s_y[j] - py) <= w &&
                          o >= l && o <= h;
        if (!gate) continue;
        // four independent integer sums: exact in any order, and four
        // dependency chains instead of one
        int dot0 = 0, dot1 = 0, dot2 = 0, dot3 = 0;
#pragma unroll
        for (int q = 0; q < WORDS / 4; ++q) {
          const int4 c = s_desc[j][q];
          dot0 = __dp4a(rd[4 * q], c.x, dot0);
          dot1 = __dp4a(rd[4 * q + 1], c.y, dot1);
          dot2 = __dp4a(rd[4 * q + 2], c.z, dot2);
          dot3 = __dp4a(rd[4 * q + 3], c.w, dot3);
        }
        const float d = (float)(256 - ((dot0 + dot1) + (dot2 + dot3))) * 0.5f;
        const int col = c0 + j;
        if (d < best) {
          second = best;
          arg2 = arg;
          best = d;
          arg = col;
        } else if (d < second) {
          second = d;
          arg2 = col;
        }
      }
    }
  }
  if (row < N1) {
    best_out[row] = best;
    second_out[row] = second;
    arg_out[row] = arg;
    arg2_out[row] = arg2;
  }
}

}  // namespace

// Plain C entry for ctypes. d1: (N1, 256) int8, xy1: (N1, 2) f32, win, lo,
// hi: (N1,) f32, v1: (N1,) bool; d2: (N2, 256) int8, xy2: (N2, 2) f32,
// oct2: (N2,) int32, v2: (N2,) bool; outputs (N1,) f32, f32, int32, int32.
// All contiguous, descriptors 16-byte aligned. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int se2lam_windowed_top2(const void* d1, const void* xy1, const void* win,
                                    const void* lo, const void* hi, const void* v1,
                                    const void* d2, const void* xy2, const void* oct2,
                                    const void* v2, int N1, int N2, void* best,
                                    void* second, void* arg, void* arg2, void* stream) {
  if (N1 <= 0) return 0;
  const int grid = (N1 + ROWS - 1) / ROWS;
  windowed_top2_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)d1, (const float*)xy1, (const float*)win, (const float*)lo,
      (const float*)hi, (const uint8_t*)v1, (const int8_t*)d2, (const float*)xy2,
      (const int32_t*)oct2, (const uint8_t*)v2, N1, N2, (float*)best, (float*)second,
      (int32_t*)arg, (int32_t*)arg2);
  return (int)cudaGetLastError();
}
