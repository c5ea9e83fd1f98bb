// Fused FAST-9/16 scoring + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel se2lam_tpu/frontend/pallas_fast.py:fast_nms_pallas
// (body `_kernel`). One launch covers every pyramid level of a frame: each
// level's (H, W) f32 image in, three (H, W) f32 maps out —
//   hi  = NMS of the FAST score gated by the arc test at t_high,
//   lo  = NMS of the FAST score gated by the arc test at t_low,
//   raw = the t_low score before NMS (subpixel refinement reads it).
// Both scores carry the low-threshold margin
//   max( Σ_i max(d_i − t_low, 0), Σ_i max(−d_i − t_low, 0) )
// over the 16 Bresenham circle offsets, d_i = img[p + o_i] − img[p].
//
// Semantics follow the plain version (se2lam_tpu_torch/frontend/fast.py),
// bitwise over the whole map of every level for finite images: reads wrap
// on both axes like `roll`, NMS treats neighbours outside the image as
// −inf, and the margins are added one by one in circle order. The Pallas
// kernel agrees with that only inside the 16-px border, which keypoint
// selection masks. Three exact rewrites keep the bits while moving work
// off the card's half-rate integer/compare pipe, which bounds the scoring:
// - each margin term max(x, 0) is summed as |x| − x with x = t − d, that is
//   2·max(d − t, 0) (exact: doubling and +0), and the final max is halved;
//   every partial sum is then exactly twice the plain one, since scaling by
//   2 commutes with rounding. No multiply meets an add, so FMA contraction
//   cannot change a bit.
// - an arc flag d > t is the sign of t − d, computed anyway for the margin
//   (rounding keeps the sign, x − x is +0, and t + 0 turns a −0 threshold
//   into +0), and one funnel shift moves it into its mask, where a compare,
//   a select and an OR did before.
// - FAST's compass pre-test: any 9 contiguous circle points hold two
//   adjacent compass points (0, 4, 8, 12). Where no adjacent pair passes at
//   min(t_high, t_low) on either polarity, neither arc test can pass and
//   both scores are 0, so the full test is skipped; a warp skips it only
//   when all its lanes fail, as in the flat parts of an image.
//
// Bound: memory. Each pixel is read once (4 B) and written three times
// (12 B). At the bench's five levels (842,491 px) a frame moves 13.5 MB,
// ~4 µs at 3.35 TB/s; its ~215 f32 operations a pixel take ~2.7 µs at the
// f32 peak. What limits this kernel is issuing the scoring: ~320
// instructions a warp and 32 positions where the full test runs (~140 f32
// adds, ~130 on the integer/compare pipe, which issues at half the rate).
//
// Design, against a fixed cost per launch and a heavy halo:
// - One launch a frame. The level table (≤ 8 levels: image, output
//   pointers, H, W, tiles per row, first tile) is a kernel parameter passed
//   by value. The grid is 1-D over all levels' tiles; a CTA finds its level
//   by comparing blockIdx.x with the levels' first tiles (unrolled, so the
//   table never leaves the parameter bank). No atomics, no dependency on
//   grid order. The tiles run from the last (smallest) level to level 0:
//   every tile is the same size, and on the bench frame this order measured
//   ~1.2 µs faster than level 0 first.
// - 64x32 outputs per CTA of 256 threads. The CTA stages its 40x72 input
//   tile (circle radius 3 + 1 NMS ring = 4 px a side; 1.41 loads an output)
//   in shared memory, scores the 34x66 outputs-plus-ring positions (1.10
//   scores an output) into two shared score tiles, then each thread walks a
//   column strip of 8 output rows, reusing the horizontal 3-maxima of the
//   rows it shares with the next output row. 29,472 B of static shared
//   memory for the tiles (and 448 B of wrap tables, below); at <= 64
//   registers 4 CTAs fit an SM, so the bench frame's 438 CTAs (150 + 117 +
//   77 + 54 + 40) are one wave on 132 SMs.
// - Interior tiles, whose halo lies inside the image, load without the
//   wrapping modulo. A tile touching an edge first wraps its 40 row and 72
//   column indices into shared memory, one modulo a thread, instead of two
//   a load. Loads and stores are coalesced along x. (TMA is not used: the
//   row pitches of most levels are not multiples of 16 bytes.)

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BX = 64;             // outputs per CTA along x
constexpr int BY = 32;             // outputs per CTA along y
constexpr int STRIP = 8;           // output rows per thread
constexpr int NTHREADS = BX * (BY / STRIP);
constexpr int HALO = 4;            // circle radius 3 + 1 NMS ring
constexpr int TW = BX + 2 * HALO;  // input tile 40 x 72
constexpr int TH = BY + 2 * HALO;
constexpr int SW = BX + 2;         // score tiles 34 x 66: outputs + 1-px ring
constexpr int SH = BY + 2;
constexpr int LOADS = (TH * TW + NTHREADS - 1) / NTHREADS;
constexpr int kMaxLevels = 8;

struct Level {
  const float* img;
  float* hi;
  float* lo;
  float* raw;
  int H, W, tiles_x, tile0;
};

struct LevelTable {
  Level lv[kMaxLevels];
  int n;
};

// Offset in the input tile of circle point k, in fast.py's _CIRCLE order:
// (dx, dy) = (0,-3) (1,-3) (2,-2) (3,-1) (3,0) (3,1) (2,2) (1,3) (0,3)
// (-1,3) (-2,2) (-3,1) (-3,0) (-3,-1) (-2,-2) (-1,-3). Called with a
// constant k, so it folds into the load's immediate offset.
__device__ __forceinline__ int circle_offset(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k] * TW + dx[k];
}

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

// (hi, lo) scores of the pixel at *p in the input tile.
__device__ __forceinline__ void score(const float* p, float t_high, float t_low,
                                      float& hi, float& lo) {
  const float center = p[0];
  {  // compass pre-test
    const float t = fminf(t_low, t_high);
    const float q0 = p[circle_offset(0)] - center, q4 = p[circle_offset(4)] - center;
    const float q8 = p[circle_offset(8)] - center, q12 = p[circle_offset(12)] - center;
    const bool b0 = q0 > t, b4 = q4 > t, b8 = q8 > t, b12 = q12 > t;
    const bool d0 = -q0 > t, d4 = -q4 > t, d8 = -q8 > t, d12 = -q12 > t;
    if (!((b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0) ||
          (d0 && d4) || (d4 && d8) || (d8 && d12) || (d12 && d0))) {
      hi = 0.0f;
      lo = 0.0f;
      return;
    }
  }
  const float tl = t_low + 0.0f, th = t_high + 0.0f;   // -0 -> +0
  float mb = 0.0f, md = 0.0f;   // twice the bright and dark margins
  // arc flags: bit 15 - k holds circle point k (the reversed circle has the
  // same runs), shifted in from the sign of t - d (set <=> d > t) or of
  // d + t (set <=> -d > t)
  unsigned bl = 0u, dl = 0u, bh = 0u, dh = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = p[circle_offset(k)] - center;
    const float nb = tl - d, nd = d + tl;
    const float pb = fabsf(nb) - nb;   // 2·max(d − t_low, 0), exactly
    const float pd = fabsf(nd) - nd;   // 2·max(−d − t_low, 0), exactly
    // first term assigned, later ones added: (((m0 + m1) + m2) + ...)
    mb = (k == 0) ? pb : mb + pb;
    md = (k == 0) ? pd : md + pd;
    bl = __funnelshift_l(__float_as_uint(nb), bl, 1);
    dl = __funnelshift_l(__float_as_uint(nd), dl, 1);
    bh = __funnelshift_l(__float_as_uint(th - d), bh, 1);
    dh = __funnelshift_l(__float_as_uint(d + th), dh, 1);
  }
  const float margin = 0.5f * fmaxf(mb, md);
  lo = (arc9(bl) || arc9(dl)) ? margin : 0.0f;
  hi = (arc9(bh) || arc9(dh)) ? margin : 0.0f;
}

__device__ __forceinline__ float hmax3(const float (*s)[SW], int r, int c) {
  return fmaxf(fmaxf(s[r][c - 1], s[r][c]), s[r][c + 1]);
}

__global__ void __launch_bounds__(NTHREADS, 4)
fast_nms_levels_kernel(const LevelTable tab, float t_high, float t_low) {
  __shared__ float tile[TH][TW];
  __shared__ float s_hi[SH][SW];
  __shared__ float s_lo[SH][SW];
  __shared__ int s_row[TH];   // an edge tile's wrapped rows and columns
  __shared__ int s_col[TW];

  // this CTA's level: the last whose first tile is <= blockIdx.x
  Level L = tab.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < tab.n && (int)blockIdx.x >= tab.lv[i].tile0) L = tab.lv[i];
  }
  const int H = L.H, W = L.W;
  const int t = (int)blockIdx.x - L.tile0;
  const int ty = t / L.tiles_x;
  const int x0 = (t - ty * L.tiles_x) * BX;
  const int y0 = ty * BY;
  const int tid = threadIdx.x;

  // 1. input tile, rows y0-4 .. y0+BY+3 and cols x0-4 .. x0+BX+3, wrapped
  //    where the tile touches an edge; all loads issued before the first
  //    shared store
  const bool interior = x0 >= HALO && x0 + BX + HALO <= W &&
                        y0 >= HALO && y0 + BY + HALO <= H;
  if (!interior) {   // the same for the whole CTA
    if (tid < TH) s_row[tid] = wrap(y0 - HALO + tid, H);
    else if (tid < TH + TW) s_col[tid - TH] = wrap(x0 - HALO + tid - TH, W);
    __syncthreads();
  }
  float v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * NTHREADS;
    if (i < TH * TW) {
      const int r = i / TW, c = i % TW;
      v[k] = interior ? L.img[(size_t)(y0 - HALO + r) * W + (x0 - HALO + c)]
                      : L.img[(size_t)s_row[r] * W + s_col[c]];
    }
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * NTHREADS;
    if (i < TH * TW) (&tile[0][0])[i] = v[k];
  }
  __syncthreads();

  // 2. scores on the outputs plus a 1-px ring; -inf outside the image
  for (int i = tid; i < SH * SW; i += NTHREADS) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float hi = -INFINITY, lo = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      score(&tile[r + HALO - 1][c + HALO - 1], t_high, t_low, hi, lo);
    s_hi[r][c] = hi;
    s_lo[r][c] = lo;
  }
  __syncthreads();

  // 3. NMS down this thread's column strip: keep s where s >= max3x3(s) and
  //    s > 0. Score row r holds output row r - 1; the horizontal maxima of
  //    rows r and r + 1 carry over to the next output row.
  const int c = tid % BX + 1;
  const int r0 = (tid / BX) * STRIP;
  const int x = x0 + c - 1;
  if (x >= W) return;
  float h0 = hmax3(s_hi, r0, c), l0 = hmax3(s_lo, r0, c);
  float h1 = hmax3(s_hi, r0 + 1, c), l1 = hmax3(s_lo, r0 + 1, c);
#pragma unroll
  for (int k = 0; k < STRIP; ++k) {
    const int r = r0 + k + 1;
    const int y = y0 + r - 1;
    if (y >= H) return;
    const float h2 = hmax3(s_hi, r + 1, c), l2 = hmax3(s_lo, r + 1, c);
    const float mh = fmaxf(fmaxf(h0, h1), h2), ml = fmaxf(fmaxf(l0, l1), l2);
    const float sh = s_hi[r][c], sl = s_lo[r][c];
    const size_t o = (size_t)y * W + x;
    L.hi[o] = (sh >= mh && sh > 0.0f) ? sh : 0.0f;
    L.lo[o] = (sl >= ml && sl > 0.0f) ? sl : 0.0f;
    L.raw[o] = sl;
    h0 = h1; h1 = h2;
    l0 = l1; l1 = l2;
  }
}

}  // namespace

// One level of the host's table: the image and its three output maps, each
// (H, W) f32, contiguous.
struct Se2lamFastLevel {
  const float* img;
  float* hi;
  float* lo;
  float* raw;
  int H;
  int W;
};

// Plain C entry for ctypes: all `n_levels` levels (1..8) in one launch on
// `stream`. Allocates nothing, and returns cudaGetLastError() so the caller
// sees a refused launch (cudaErrorInvalidValue for a table it cannot take).
extern "C" int se2lam_fast_nms_levels(int n_levels, const Se2lamFastLevel* levels,
                                      float t_high, float t_low, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  LevelTable tab = {};
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {   // the last level first
    const Se2lamFastLevel& s = levels[n_levels - 1 - l];
    if (s.H < 1 || s.W < 1) return (int)cudaErrorInvalidValue;
    Level& d = tab.lv[l];
    d.img = s.img;
    d.hi = s.hi;
    d.lo = s.lo;
    d.raw = s.raw;
    d.H = s.H;
    d.W = s.W;
    d.tiles_x = (s.W + BX - 1) / BX;
    d.tile0 = (int)tiles;
    tiles += (long long)d.tiles_x * ((s.H + BY - 1) / BY);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  tab.n = n_levels;
  fast_nms_levels_kernel<<<(unsigned)tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      tab, t_high, t_low);
  return (int)cudaGetLastError();
}
