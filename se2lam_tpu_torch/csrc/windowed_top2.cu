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
// ~2.7 MB of inputs and outputs (0.8 µs at 3.35 TB/s). On a localization
// frame only the map's few hundred points are valid, in the lowest row
// slots, so what bounds this kernel on the card is the serial work of the
// few CTAs that hold them: the gate walk over N2 columns and the latency
// of the gated pairs' descriptor loads.
//
// Design: one warp per row, 8 rows to a 256-thread CTA. A CTA with no
// valid row writes the empty result and exits. Otherwise it stages the
// columns' gate attributes (x, y, octave, valid: 13 B a column) in shared
// memory, 1024 columns a pass, coalesced, once for its 8 warps. A warp
// walks the columns in groups of 32: lane l gates column c0+l with the
// same f32 compares as the plain version (no FMA), and __ballot_sync
// appends the group's gated columns, in ascending order, to the warp's
// queue in shared memory. Once 32 or more are queued (and at the end), the
// lanes take one queued column each and its dot product (16 int4 loads,
// 64 __dp4a against the row descriptor held in registers, an exact
// integer): only gated pairs pay for one, and the descriptor loads of up
// to 32 of them, from many groups, fly together. The warp then walks the
// queue in order, takes each distance and column with __shfl_sync and
// applies the strict "<" update: columns are visited in ascending order,
// a new best drops the old one to second with its column, so the tie
// order of the plain version holds by construction, with no merge across
// lanes. Each output has one owner: results are the same run to run. The
// TPU's 128-row padding, bf16 cast and transposed attribute block are not
// carried over.
//
// No int8 MMA: at the real inputs ~0.08% of the pairs pass the gate, so a
// dense MMA would take ~1,300x the dot products the function needs, and
// keeping the tie order from MMA fragments would need a merge. Worth
// revisiting only if dot products come to dominate the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // rows (warps) per block
constexpr int THREADS = 32 * WARPS;
constexpr int CT = 1024;                // columns staged per pass
constexpr int QCAP = 64;                // a warp's queue of gated columns
constexpr int WORDS = 64;               // int32 words in a 256-byte descriptor
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;

// The queued gated columns q[0..nq) (ascending): lane l takes the distance
// of entry b0 + l, 32 entries a round, so a round's descriptor loads fly
// together; then every lane applies the strict "<" update in queue order.
__device__ __forceinline__ void drain(const int* q, int nq, const int (&rd)[WORDS],
                                      const int8_t* __restrict__ d2, int lane,
                                      float& best, float& second, int& arg, int& arg2) {
  for (int b0 = 0; b0 < nq; b0 += 32) {
    const int n = (nq - b0) < 32 ? (nq - b0) : 32;
    int col = 0;
    float d = 0.0f;
    if (lane < n) {
      col = q[b0 + lane];
      // four independent integer sums: exact in any order
      const int4* src = reinterpret_cast<const int4*>(d2 + (long long)col * 256);
      int dot0 = 0, dot1 = 0, dot2 = 0, dot3 = 0;
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const int4 c = src[k];
        dot0 = __dp4a(rd[4 * k], c.x, dot0);
        dot1 = __dp4a(rd[4 * k + 1], c.y, dot1);
        dot2 = __dp4a(rd[4 * k + 2], c.z, dot2);
        dot3 = __dp4a(rd[4 * k + 3], c.w, dot3);
      }
      d = (float)(256 - ((dot0 + dot1) + (dot2 + dot3))) * 0.5f;
    }
    for (int e = 0; e < n; ++e) {
      const float de = __shfl_sync(FULL, d, e);
      const int ce = __shfl_sync(FULL, col, e);
      if (de < best) {
        second = best;
        arg2 = arg;
        best = de;
        arg = ce;
      } else if (de < second) {
        second = de;
        arg2 = ce;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
windowed_top2_kernel(const int8_t* __restrict__ d1, const float* __restrict__ xy1,
                     const float* __restrict__ win, const float* __restrict__ lo,
                     const float* __restrict__ hi, const uint8_t* __restrict__ v1,
                     const int8_t* __restrict__ d2, const float* __restrict__ xy2,
                     const int32_t* __restrict__ oct2, const uint8_t* __restrict__ v2,
                     int N1, int N2, float* __restrict__ best_out,
                     float* __restrict__ second_out, int32_t* __restrict__ arg_out,
                     int32_t* __restrict__ arg2_out) {
  __shared__ float s_x[CT], s_y[CT], s_oct[CT];
  __shared__ uint8_t s_ok[CT];
  __shared__ int s_q[WARPS][QCAP];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  const bool active = row < N1 && v1[row] != 0;   // uniform over the warp

  float best = BIG, second = BIG;
  int arg = 0, arg2 = 0;

  if (__syncthreads_or(active)) {
    int rd[WORDS];
    float px = 0.0f, py = 0.0f, w = 0.0f, l = 0.0f, h = 0.0f;
    if (active) {
      const int4* src = reinterpret_cast<const int4*>(d1 + (long long)row * 256);
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const int4 v = src[k];
        rd[4 * k] = v.x;
        rd[4 * k + 1] = v.y;
        rd[4 * k + 2] = v.z;
        rd[4 * k + 3] = v.w;
      }
      px = xy1[2LL * row];
      py = xy1[2LL * row + 1];
      w = win[row];
      l = lo[row];
      h = hi[row];
    }
    int* q = s_q[warp];
    int nq = 0;   // uniform over the warp

    for (int t0 = 0; t0 < N2; t0 += CT) {
      const int n = (N2 - t0) < CT ? (N2 - t0) : CT;
      __syncthreads();   // the previous pass is no longer read
      for (int j = threadIdx.x; j < n; j += THREADS) {
        s_x[j] = xy2[2LL * (t0 + j)];
        s_y[j] = xy2[2LL * (t0 + j) + 1];
        s_oct[j] = (float)oct2[t0 + j];
        s_ok[j] = v2[t0 + j] != 0;
      }
      __syncthreads();
      if (!active) continue;
      for (int g = 0; g < n; g += 32) {
        const int j = g + lane;
        bool gate = false;
        if (j < n) {
          const float o = s_oct[j];
          gate = s_ok[j] && fabsf(s_x[j] - px) <= w && fabsf(s_y[j] - py) <= w &&
                 o >= l && o <= h;
        }
        // append the group's gated columns in ascending order
        const unsigned set = __ballot_sync(FULL, gate);
        if (gate) q[nq + __popc(set & ((1u << lane) - 1u))] = t0 + j;
        nq += __popc(set);
        if (nq >= 32) {
          __syncwarp();
          drain(q, nq, rd, d2, lane, best, second, arg, arg2);
          __syncwarp();   // the queue is read before it is written again
          nq = 0;
        }
      }
    }
    __syncwarp();
    if (active) drain(q, nq, rd, d2, lane, best, second, arg, arg2);
  }
  if (row < N1 && lane == 0) {
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
  const int grid = (N1 + WARPS - 1) / WARPS;
  windowed_top2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)d1, (const float*)xy1, (const float*)win, (const float*)lo,
      (const float*)hi, (const uint8_t*)v1, (const int8_t*)d2, (const float*)xy2,
      (const int32_t*)oct2, (const uint8_t*)v2, N1, N2, (float*)best, (float*)second,
      (int32_t*)arg, (int32_t*)arg2);
  return (int)cudaGetLastError();
}
