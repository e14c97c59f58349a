// K1: fused FAST-9/16 score + two-threshold 3x3 NMS + 7x7 Gaussian blur
// over a whole image pyramid in one launch.
//
// Replaces the TPU kernel orb_slam3_study_kr_tpu/ops/pallas_fast.py
// (fast_nms_blur_pallas, kernel _kernel), which streamed 64-row strips of a
// 128-lane-padded level through VMEM, one call per level.  Semantics follow
// the reference's jnp path instead (ops/orb.py fast_score_map + _nms3x3 +
// gaussian_blur7): the true level width with no lane padding, FAST and NMS
// shifts that wrap around the image like jnp.roll, and an edge-clamped blur
// everywhere.
//
// Bound on the H100: memory.  Per pixel the kernel reads 4 bytes and writes
// 16 (s_raw, s20, s7, blur): the 8 levels of a 752x480 pyramid hold
// 1,117,367 pixels, 22.3 MB, 6.7 us at 3.35 TB/s.  The arithmetic as this
// kernel does it (175 operations a pixel: FAST 133, NMS 16, blur 26; 0.2 G
// in all) needs 2.9 us at 67 T/s.  The measured time is about 4x the
// memory bound and does not move with the bytes: a CTA's FAST stage is a
// long dependent chain of min/max, and about 9 CTAs per SM run in two
// waves (PERF.md).
//
// Design:
// - One launch for all levels.  The levels sit in one flat f32 arena; a
//   level table (offset, height, width, first tile) is passed by value,
//   the 1-D grid covers every 32x32 tile of every level (1,182 CTAs for
//   the 752x480 pyramid: two waves at the 5 CTAs of 256 threads that fit
//   an SM), and each CTA looks its level up in the table.  One launch in
//   place of eight removes seven launch latencies and the small levels'
//   underfilled grids.  A single level is the same launch with a
//   one-entry table.
// - A CTA stages its tile plus a 4-pixel halo (FAST ring 3 + NMS 1) in
//   shared memory.  Interior tiles, more than 4 pixels from every edge,
//   read straight rows with no index arithmetic, and their clamped blur
//   window is a sub-window of that stage.  Border tiles stage a wrapped
//   40x40 window (FAST, NMS) and an edge-clamped 38x38 window (blur) with
//   the modulo and clamp index math.  Staging uses the block's 2-D thread
//   index, so no division per element.
// - The raw score is computed for the tile plus a 1-pixel ring, and both
//   NMS maps read their neighbours from that shared score tile.  The arc
//   minima share partial minima (block prefix and suffix minima, arcs9
//   below): 42 min per polarity in place of 128.  The dark polarity is the
//   negated arc maximum of the bright differences.  min, max and negation
//   are exact, so the score and NMS maps are bit-exact against the plain
//   version.  (Pairs, then quads, then eights take 64 per polarity; they
//   measured 6 % slower on the card.)
// - Both NMS maps share one 8-neighbour maximum: thresholding is monotone
//   (th_ini >= 0, which the wrapper checks), so the s20 map's neighbour
//   maximum is the thresholded raw one.
// - The blur runs a horizontal then a vertical pass in shared memory;
//   products and sums use __fmul_rn/__fadd_rn in the reference's tap
//   order, so no fused multiply-add changes its rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int BY = 8;               // block is TX x BY threads
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;   // wrapped staging width (40)
constexpr int SCW = TX + 2;         // score tile width (34)
constexpr int CW = TX + 6;          // clamped staging width (38)
constexpr int MAX_LEVELS = 16;

struct Pyramid {
  int n;                    // levels
  int total;                // pixels over all levels
  int off[MAX_LEVELS];      // first pixel of each level in the arena
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];  // 32x32 tiles per row of each level
  int tile0[MAX_LEVELS];    // first tile (CTA) of each level
};

struct G7 {
  float k[7];
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool MAX>
__device__ __forceinline__ float ext(float a, float b) {
  return MAX ? fmaxf(a, b) : fminf(a, b);
}

// The 16 circular 9-arc minima (maxima with MAX) of d[0..15], shared the
// van Herk / Gil-Werman way: over d extended to e[0..23] (e[i] = d[i % 16])
// in blocks [0, 8], [9, 17], [18, 23], an arc [j, j + 8] is the block
// suffix extremum at j joined with the next block's prefix extremum at
// j + 8.  42 operations in place of 128 for 16 separate arcs.
template <bool MAX>
__device__ __forceinline__ void arcs9(const float* d, float* arc) {
  float suf[16], pre[24];
  suf[8] = d[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) suf[i] = ext<MAX>(d[i], suf[i + 1]);
  float s = ext<MAX>(d[0], d[1]);  // e[16], e[17]
#pragma unroll
  for (int i = 15; i >= 9; --i) suf[i] = s = ext<MAX>(d[i], s);
  pre[9] = d[9];
#pragma unroll
  for (int i = 10; i <= 16; ++i) pre[i] = ext<MAX>(pre[i - 1], d[i & 15]);
  pre[18] = d[2];
#pragma unroll
  for (int i = 19; i <= 23; ++i) pre[i] = ext<MAX>(pre[i - 1], d[i - 16]);
  arc[0] = suf[0];
  arc[9] = suf[9];
#pragma unroll
  for (int j = 1; j <= 8; ++j) arc[j] = ext<MAX>(suf[j], pre[j + 8]);
#pragma unroll
  for (int j = 10; j <= 15; ++j) arc[j] = ext<MAX>(suf[j], pre[j + 8]);
}

// FAST-9/16 score of the pixel at (wr, wc) of the staged window: the max
// over the 16 contiguous 9-arcs of the arc minimum of ring - centre, for
// both polarities.
__device__ __forceinline__ float fast_score(const float (*win)[SW], int wr,
                                            int wc) {
  const float cv = win[wr][wc];
  float d[16];
#define RING(k, dy, dx) d[k] = win[wr + (dy)][wc + (dx)] - cv
  RING(0, -3, 0);  RING(1, -3, 1);  RING(2, -2, 2);   RING(3, -1, 3);
  RING(4, 0, 3);   RING(5, 1, 3);   RING(6, 2, 2);    RING(7, 3, 1);
  RING(8, 3, 0);   RING(9, 3, -1);  RING(10, 2, -2);  RING(11, 1, -3);
  RING(12, 0, -3); RING(13, -1, -3); RING(14, -2, -2); RING(15, -3, -1);
#undef RING
  float lo9[16], hi9[16];
  arcs9<false>(d, lo9);
  arcs9<true>(d, hi9);
  float bright = lo9[0], dark = hi9[0];
#pragma unroll
  for (int j = 1; j < 16; ++j) {
    bright = fmaxf(bright, lo9[j]);
    dark = fminf(dark, hi9[j]);
  }
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(TX * BY)
    fast_nms_blur_kernel(const __grid_constant__ Pyramid P,
                         const float* __restrict__ arena,
                         float* __restrict__ out,  // (4, total)
                         float th_min, float th_ini, G7 g) {
  __shared__ float win[TY + 2 * HALO][SW];
  __shared__ float sc[TY + 2][SCW];
  __shared__ float cin[TY + 6][CW];
  __shared__ float hb[TY + 6][TX];

  const int bid = blockIdx.x;
  int l = 0;
  for (int k = 1; k < P.n; ++k)
    if (bid >= P.tile0[k]) l = k;
  const int H = P.h[l], W = P.w[l];
  const int t = bid - P.tile0[l];
  const int by = t / P.tiles_x[l];
  const int x0 = (t - by * P.tiles_x[l]) * TX;
  const int y0 = by * TY;
  const float* img = arena + P.off[l];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;

  const bool interior = x0 >= HALO && y0 >= HALO && x0 + TX + HALO <= W &&
                        y0 + TY + HALO <= H;
  if (interior) {
    const float* src = img + (y0 - HALO) * W + (x0 - HALO);
    for (int r = ty; r < TY + 2 * HALO; r += BY)
      for (int c = tx; c < SW; c += TX) win[r][c] = src[r * W + c];
  } else {
    for (int r = ty; r < TY + 2 * HALO; r += BY) {
      const float* row = img + wrap(y0 - HALO + r, H) * W;
      for (int c = tx; c < SW; c += TX) win[r][c] = row[wrap(x0 - HALO + c, W)];
    }
    for (int r = ty; r < TY + 6; r += BY) {
      const float* row = img + clampi(y0 - 3 + r, 0, H - 1) * W;
      for (int c = tx; c < CW; c += TX) cin[r][c] = row[clampi(x0 - 3 + c, 0, W - 1)];
    }
  }
  __syncthreads();

  // Raw FAST score on the tile plus a 1-pixel ring (positions -1..TX).
  for (int i = tid; i < (TY + 2) * SCW; i += TX * BY) {
    const int r = i / SCW, c = i - r * SCW;
    const float s = fast_score(win, r + HALO - 1, c + HALO - 1);
    sc[r][c] = s > th_min ? s : 0.0f;
  }
  // Horizontal blur pass over the clamped rows; an interior tile's clamped
  // window is its staged window without the outer pixel.
  const float* bsrc = interior ? &win[1][1] : &cin[0][0];
  const int bstride = interior ? SW : CW;
  for (int r = ty; r < TY + 6; r += BY) {
    const float* row = bsrc + r * bstride + tx;
    float acc = __fmul_rn(g.k[0], row[0]);
#pragma unroll
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.k[k], row[k]));
    hb[r][tx] = acc;
  }
  __syncthreads();

  float* o_raw = out + P.off[l];
  float* o_s20 = o_raw + P.total;
  float* o_s7 = o_s20 + P.total;
  float* o_blur = o_s7 + P.total;
  const int x = x0 + tx;
#pragma unroll
  for (int rr = 0; rr < TY; rr += BY) {
    const int r = rr + ty;
    const int y = y0 + r;
    if (y >= H || x >= W) continue;
    const float s = sc[r + 1][tx + 1];
    const float ts = s > th_ini ? s : 0.0f;
    float n7 = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy != 0 || dx != 0) n7 = fmaxf(n7, sc[r + 1 + dy][tx + 1 + dx]);
      }
    }
    // v -> (v > th_ini ? v : 0) is non-decreasing for th_ini >= 0, so the
    // neighbours' maximum after the threshold is the threshold of their
    // maximum.
    const float n20 = n7 > th_ini ? n7 : 0.0f;
    float acc = __fmul_rn(g.k[0], hb[r][tx]);
#pragma unroll
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.k[k], hb[r + k][tx]));
    const int o = y * W + x;
    o_raw[o] = s;
    o_s7[o] = (s >= n7 && s > 0.0f) ? s : 0.0f;
    o_s20[o] = (ts >= n20 && ts > 0.0f) ? ts : 0.0f;
    o_blur[o] = acc;
  }
}

}  // namespace

// levels[3 * l + {0, 1, 2}] = (offset, height, width) of level l in the
// arena; out is (4, total) f32: s_raw, s20, s7, blur.
extern "C" int fast_nms_blur_pyramid(const void* arena, void* out,
                                     const int* levels, int n_levels,
                                     float th_min, float th_ini,
                                     const void* g7, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid P{};
  P.n = n_levels;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    P.off[l] = levels[3 * l];
    P.h[l] = levels[3 * l + 1];
    P.w[l] = levels[3 * l + 2];
    P.tiles_x[l] = (P.w[l] + TX - 1) / TX;
    P.tile0[l] = tiles;
    tiles += P.tiles_x[l] * ((P.h[l] + TY - 1) / TY);
    P.total = P.off[l] + P.h[l] * P.w[l];
  }
  G7 g;
  for (int k = 0; k < 7; ++k) g.k[k] = static_cast<const float*>(g7)[k];
  fast_nms_blur_kernel<<<tiles, dim3(TX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const float*>(arena), static_cast<float*>(out), th_min,
      th_ini, g);
  return static_cast<int>(cudaGetLastError());
}
