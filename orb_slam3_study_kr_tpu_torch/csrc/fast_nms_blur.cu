// K1: fused FAST-9/16 score + two-threshold 3x3 NMS + 7x7 Gaussian blur.
//
// Replaces the TPU kernel orb_slam3_study_kr_tpu/ops/pallas_fast.py
// (fast_nms_blur_pallas, kernel _kernel), which streamed 64-row strips of a
// 128-lane-padded level through VMEM.  Semantics follow the reference's jnp
// path instead (ops/orb.py fast_score_map + _nms3x3 + gaussian_blur7): the
// true level width with no lane padding, FAST and NMS shifts that wrap
// around the image like jnp.roll, and an edge-clamped blur everywhere.
//
// Bound on the H100: memory.  Per pixel the kernel reads 4 bytes and writes
// 16 (s_raw, s20, s7, blur) and spends a few hundred min/max/compare
// operations, far below the card's compute-to-bandwidth ratio.  A level of
// 480x752 moves ~7 MB, a few microseconds at HBM rate, so launch latency
// dominates each call at these sizes.
//
// Design: one CTA per 32x32 output tile.  The tile plus a 4-pixel halo
// (FAST ring 3 + NMS 1) is staged once in shared memory with wrapped
// indexing, the raw score is computed for the tile plus a 1-pixel ring, and
// both NMS maps read their neighbours from that shared score tile.  The
// blur stages a separate edge-clamped tile plus 3-pixel halo and runs a
// horizontal then a vertical pass in shared memory.  Products and sums of
// the blur use __fmul_rn/__fadd_rn in the reference's tap order, so no
// fused multiply-add changes its rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;   // wrapped staging width (40)
constexpr int SCW = TX + 2;         // score tile width (34)
constexpr int CW = TX + 6;          // clamped staging width (38)

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

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

__device__ __forceinline__ float arc_score(const float* d) {
  // max over the 16 contiguous 9-arcs of the arc minimum
  float best = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float m = d[j];
#pragma unroll
    for (int k = 1; k < 9; ++k) m = fminf(m, d[(j + k) & 15]);
    best = fmaxf(best, m);
  }
  return best;
}

__global__ void fast_nms_blur_kernel(const float* __restrict__ img,
                                     float* __restrict__ s_raw,
                                     float* __restrict__ s20,
                                     float* __restrict__ s7,
                                     float* __restrict__ blur, int H, int W,
                                     float th_min, float th_ini, G7 g) {
  __shared__ float win[TY + 2 * HALO][SW];
  __shared__ float sc[TY + 2][SCW];
  __shared__ float cin[TY + 6][CW];
  __shared__ float hb[TY + 6][TX];

  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  for (int i = tid; i < (TY + 2 * HALO) * SW; i += nt) {
    const int r = i / SW, c = i % SW;
    win[r][c] = img[wrap(y0 - HALO + r, H) * W + wrap(x0 - HALO + c, W)];
  }
  for (int i = tid; i < (TY + 6) * CW; i += nt) {
    const int r = i / CW, c = i % CW;
    cin[r][c] = img[clampi(y0 - 3 + r, 0, H - 1) * W + clampi(x0 - 3 + c, 0, W - 1)];
  }
  __syncthreads();

  // Raw FAST score on the tile plus a 1-pixel ring (positions -1..TX).
  for (int i = tid; i < (TY + 2) * SCW; i += nt) {
    const int r = i / SCW, c = i % SCW;
    const int wr = r + HALO - 1, wc = c + HALO - 1;
    const float cv = win[wr][wc];
    float bright[16], dark[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      bright[k] = win[wr + kDy[k]][wc + kDx[k]] - cv;
      dark[k] = -bright[k];
    }
    const float s = fmaxf(arc_score(bright), arc_score(dark));
    sc[r][c] = s > th_min ? s : 0.0f;
  }
  // Horizontal blur pass over the clamped rows.
  for (int i = tid; i < (TY + 6) * TX; i += nt) {
    const int r = i / TX, c = i % TX;
    float acc = __fmul_rn(g.k[0], cin[r][c]);
#pragma unroll
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.k[k], cin[r][c + k]));
    hb[r][c] = acc;
  }
  __syncthreads();

  for (int i = tid; i < TY * TX; i += nt) {
    const int r = i / TX, c = i % TX;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float s = sc[r + 1][c + 1];
    const float t = s > th_ini ? s : 0.0f;
    float n7 = -INFINITY, n20 = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float v = sc[r + 1 + dy][c + 1 + dx];
        n7 = fmaxf(n7, v);
        n20 = fmaxf(n20, v > th_ini ? v : 0.0f);
      }
    }
    float acc = __fmul_rn(g.k[0], hb[r][c]);
#pragma unroll
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.k[k], hb[r + k][c]));
    const int o = y * W + x;
    s_raw[o] = s;
    s7[o] = (s >= n7 && s > 0.0f) ? s : 0.0f;
    s20[o] = (t >= n20 && t > 0.0f) ? t : 0.0f;
    blur[o] = acc;
  }
}

}  // namespace

extern "C" int fast_nms_blur(const void* img, void* s_raw, void* s20, void* s7,
                             void* blur, int H, int W, float th_min,
                             float th_ini, const void* g7, void* stream) {
  G7 g;
  for (int k = 0; k < 7; ++k) g.k[k] = static_cast<const float*>(g7)[k];
  dim3 block(32, 8);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fast_nms_blur_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(s_raw),
      static_cast<float*>(s20), static_cast<float*>(s7),
      static_cast<float*>(blur), H, W, th_min, th_ini, g);
  return static_cast<int>(cudaGetLastError());
}
