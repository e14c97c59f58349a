// K2: projection-gated Hamming nearest neighbour.
//
// Replaces the TPU kernel orb_slam3_study_kr_tpu/ops/pallas_matching.py
// (gated_nn_pallas, kernel _gated_nn_kernel).  For each frame keypoint q it
// returns the best and second-best Hamming distance and the first-index
// argmin over all landmarks t passing the gates |du|,|dv| <= radius_t,
// |level_q - level_t| <= slack, visible_t and valid_q; gated pairs score
// BIG = 1e9.  The second-best leaves out only the argmin index, so a tie at
// another index gives second == best.  When every landmark is gated the
// result is idx 0 and best = second = BIG, as argmin over all-BIG gives.
// None of the TPU workarounds carry over: no f32 (distance, index) key
// packing, no bound on L, no tile limit; any L >= 1 is taken.
//
// Bound on the H100: on-chip bandwidth and integer issue.  N x L pairs
// (1000 x 4096 per call on the main path) each cost a few gate compares and,
// when the gates pass, 8 popcounts on 32 bytes; descriptors live in L2
// (128 KB per 4096 landmarks).  Device memory traffic is small.
//
// Design: one warp per query, 8 warps per CTA.  The CTA stages tiles of
// 256 landmarks (packed 8 x u32 descriptors plus gate fields) in shared
// memory, so each landmark is read from L2 once per 8 queries.  Lanes
// stride over the tile in ascending index, evaluate the gates in registers
// and popcount only pairs that pass; each lane keeps a running
// (best, idx, second), and a shuffle reduction with the index as tie-break
// merges the 32 lanes.  An optional leading batch dimension (grid.y) serves
// the fuse step's many-keyframe call; the landmark descriptors are shared
// across the batch, the projected gates are per batch row.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 256;
constexpr int GATED = 1 << 20;  // > any Hamming distance of 256 bits
constexpr float BIG = 1e9f;

__device__ __forceinline__ void merge(int& b, int& i, int& s, int ob, int oi,
                                      int os) {
  if (ob < b || (ob == b && oi < i)) {
    s = min(b, os);
    b = ob;
    i = oi;
  } else {
    s = min(s, ob);
  }
}

__global__ void gated_nn_kernel(const uint32_t* __restrict__ q_desc,  // (B,N,8)
                                const float* __restrict__ q_uv,       // (B,N,2)
                                const int* __restrict__ q_level,      // (B,N)
                                const uint8_t* __restrict__ q_valid,  // (B,N)
                                const uint32_t* __restrict__ t_desc,  // (L,8)
                                const float* __restrict__ t_uv,       // (B,L,2)
                                const float* __restrict__ t_radius,   // (B,L)
                                const int* __restrict__ t_level,      // (B,L)
                                const uint8_t* __restrict__ t_valid,  // (B,L)
                                float* __restrict__ best_out,         // (B,N)
                                float* __restrict__ second_out,       // (B,N)
                                int* __restrict__ idx_out,            // (B,N)
                                int N, int L, int slack) {
  __shared__ uint4 s_desc[TILE][2];
  __shared__ float s_x[TILE], s_y[TILE], s_r[TILE];
  __shared__ int s_l[TILE];
  __shared__ uint8_t s_v[TILE];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const bool has_q = q < N;
  const long qo = static_cast<long>(b) * N + (has_q ? q : 0);

  uint32_t qd[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) qd[k] = q_desc[qo * 8 + k];
  const float qx = q_uv[qo * 2], qy = q_uv[qo * 2 + 1];
  const int ql = q_level[qo];
  const bool qv = has_q && q_valid[qo] != 0;

  int best = INT_MAX, bidx = INT_MAX, second = INT_MAX;
  const long tb = static_cast<long>(b) * L;
  for (int t0 = 0; t0 < L; t0 += TILE) {
    const int n = min(TILE, L - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int t = t0 + j;
      const uint4* src = reinterpret_cast<const uint4*>(t_desc + static_cast<long>(t) * 8);
      s_desc[j][0] = src[0];
      s_desc[j][1] = src[1];
      s_x[j] = t_uv[(tb + t) * 2];
      s_y[j] = t_uv[(tb + t) * 2 + 1];
      s_r[j] = t_radius[tb + t];
      s_l[j] = t_level[tb + t];
      s_v[j] = t_valid[tb + t];
    }
    __syncthreads();
    if (!has_q) continue;
    for (int j = lane; j < n; j += 32) {
      const float r = s_r[j];
      const int dl = ql - s_l[j];
      const bool ok = qv && s_v[j] != 0 && fabsf(qx - s_x[j]) <= r &&
                      fabsf(qy - s_y[j]) <= r && dl >= -slack && dl <= slack;
      int d = GATED;
      if (ok) {
        const uint4 a = s_desc[j][0], c = s_desc[j][1];
        d = __popc(qd[0] ^ a.x) + __popc(qd[1] ^ a.y) + __popc(qd[2] ^ a.z) +
            __popc(qd[3] ^ a.w) + __popc(qd[4] ^ c.x) + __popc(qd[5] ^ c.y) +
            __popc(qd[6] ^ c.z) + __popc(qd[7] ^ c.w);
      }
      // Ascending index within a lane: a tie with the running best is a
      // later index and becomes the second-best.
      if (d < best) {
        second = best;
        best = d;
        bidx = t0 + j;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (!has_q) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
    const int os = __shfl_down_sync(0xffffffffu, second, off);
    merge(best, bidx, second, ob, oi, os);
  }
  if (lane == 0) {
    best_out[qo] = best >= GATED ? BIG : static_cast<float>(best);
    second_out[qo] = second >= GATED ? BIG : static_cast<float>(second);
    idx_out[qo] = bidx;
  }
}

}  // namespace

extern "C" int gated_nn(const void* q_desc, const void* q_uv, const void* q_level,
                        const void* q_valid, const void* t_desc, const void* t_uv,
                        const void* t_radius, const void* t_level,
                        const void* t_valid, void* best, void* second, void* idx,
                        int B, int N, int L, int slack, void* stream) {
  dim3 block(WARPS * 32);
  dim3 grid((N + WARPS - 1) / WARPS, B);
  gated_nn_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_desc), static_cast<const float*>(q_uv),
      static_cast<const int*>(q_level), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint32_t*>(t_desc), static_cast<const float*>(t_uv),
      static_cast<const float*>(t_radius), static_cast<const int*>(t_level),
      static_cast<const uint8_t*>(t_valid), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<int*>(idx), N, L, slack);
  return static_cast<int>(cudaGetLastError());
}
