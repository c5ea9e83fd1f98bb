// Fused FAST-9/16 scoring + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel se2lam_tpu/frontend/pallas_fast.py:fast_nms_pallas
// (body `_kernel`). One launch per pyramid level: (H, W) f32 image in,
// three (H, W) f32 maps out —
//   hi  = NMS of the FAST score gated by the arc test at t_high,
//   lo  = NMS of the FAST score gated by the arc test at t_low,
//   raw = the t_low score before NMS (subpixel refinement reads it).
// Both scores carry the low-threshold margin
//   max( Σ_i max(d_i − t_low, 0), Σ_i max(−d_i − t_low, 0) )
// over the 16 Bresenham circle offsets, d_i = img[p + o_i] − img[p].
//
// Semantics follow the plain version (se2lam_tpu_torch/frontend/fast.py),
// bitwise over the whole map: reads wrap on both axes like `roll`, NMS
// treats neighbours outside the image as −inf, and the margins are added
// one by one in circle order (no multiplies, so FMA contraction cannot
// change a bit). The Pallas kernel agrees with that only inside the 16-px
// border, which keypoint selection masks.
//
// Bound: memory. Each pixel is read once (4 B) and written three times
// (12 B); ~200 f32 operations a pixel is far under the card's compute rate.
// At the bench's five levels (842,491 px) a frame moves 13.5 MB, ~4 µs at
// 3.35 TB/s, so launch overhead dominates at these sizes.
// Design: one thread per output pixel in a 32x8 block. The block stages its
// (8+8) x (32+8) input tile (circle radius 3 + 1 NMS ring on each side) in
// shared memory once, scores the 10 x 34 tile-plus-ring positions into two
// shared score tiles, then each thread takes its 3x3 maxima from shared
// memory and writes its three outputs (coalesced along x). No grid-order
// dependencies; the TPU kernel's 48-row bands are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 32;          // outputs per block along x
constexpr int BY = 8;           // outputs per block along y
constexpr int HALO = 4;         // circle radius 3 + 1 NMS ring
constexpr int TW = BX + 2 * HALO;
constexpr int TH = BY + 2 * HALO;
constexpr int SW = BX + 2;      // score tile: outputs + 1-px NMS ring
constexpr int SH = BY + 2;

// _CIRCLE of frontend/fast.py, in circular order: (dx, dy)
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

// Some run of >= 9 contiguous set bits on the 16-bit circle: the same
// log-doubling as fast.py's _arc_test, on a bit mask doubled to 32 bits so
// the circular shifts become plain ones.
__device__ __forceinline__ bool arc9(unsigned flags) {
  unsigned m = flags | (flags << 16);
  unsigned a2 = m & (m >> 1);
  unsigned a4 = a2 & (a2 >> 2);
  unsigned a8 = a4 & (a4 >> 4);
  unsigned a9 = a8 & (m >> 8);
  return (a9 & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(BX * BY)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out_hi,
                float* __restrict__ out_lo, float* __restrict__ out_raw,
                int H, int W, float t_high, float t_low) {
  __shared__ float tile[TH][TW];
  __shared__ float s_hi[SH][SW];
  __shared__ float s_lo[SH][SW];

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int nthreads = BX * BY;

  // 1. input tile, rows y0-4 .. y0+BY+3 and cols x0-4 .. x0+BX+3, wrapped
  for (int i = tid; i < TH * TW; i += nthreads) {
    const int r = i / TW, c = i % TW;
    const int gy = wrap(y0 - HALO + r, H);
    const int gx = wrap(x0 - HALO + c, W);
    tile[r][c] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. scores on the outputs plus a 1-px ring; -inf outside the image
  for (int i = tid; i < SH * SW; i += nthreads) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float hi = -INFINITY, lo = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int ty = r + HALO - 1, tx = c + HALO - 1;
      const float center = tile[ty][tx];
      float mb = 0.0f, md = 0.0f;
      unsigned bl = 0u, dl = 0u, bh = 0u, dh = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = tile[ty + kCircleDy[k]][tx + kCircleDx[k]] - center;
        const float nd = -d;
        const float pb = fmaxf(d - t_low, 0.0f);
        const float pd = fmaxf(nd - t_low, 0.0f);
        // first term assigned, later ones added: (((m0 + m1) + m2) + ...)
        mb = (k == 0) ? pb : mb + pb;
        md = (k == 0) ? pd : md + pd;
        bl |= (unsigned)(d > t_low) << k;
        dl |= (unsigned)(nd > t_low) << k;
        bh |= (unsigned)(d > t_high) << k;
        dh |= (unsigned)(nd > t_high) << k;
      }
      const float margin = fmaxf(mb, md);
      lo = (arc9(bl) || arc9(dl)) ? margin : 0.0f;
      hi = (arc9(bh) || arc9(dh)) ? margin : 0.0f;
    }
    s_hi[r][c] = hi;
    s_lo[r][c] = lo;
  }
  __syncthreads();

  // 3. NMS: keep s where s >= max3x3(s) and s > 0
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = threadIdx.y + 1, c = threadIdx.x + 1;
  float mh = -INFINITY, ml = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      mh = fmaxf(mh, s_hi[r + dy][c + dx]);
      ml = fmaxf(ml, s_lo[r + dy][c + dx]);
    }
  }
  const float sh = s_hi[r][c], sl = s_lo[r][c];
  const size_t o = (size_t)y * W + x;
  out_hi[o] = (sh >= mh && sh > 0.0f) ? sh : 0.0f;
  out_lo[o] = (sl >= ml && sl > 0.0f) ? sl : 0.0f;
  out_raw[o] = sl;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int se2lam_fast_nms(const float* img, float* out_hi, float* out_lo,
                               float* out_raw, int H, int W, float t_high,
                               float t_low, void* stream) {
  dim3 block(BX, BY);
  dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, out_hi, out_lo, out_raw, H, W, t_high, t_low);
  return (int)cudaGetLastError();
}
