// K3: masked Hamming nearest neighbour.
//
// Replaces the TPU kernel orb_slam3_study_kr_tpu/ops/pallas_matching.py
// (hamming_nn_pallas, kernel _nn_kernel).  For each query row q it returns
// the best and second-best Hamming distance and the first-index argmin over
// all targets t, where a pair counts only when q_valid[q] && t_valid[t];
// every other pair scores BIG = 1e9.  The second-best leaves out only the
// argmin index, so a tie at another index gives second == best.  A row with
// no valid pair returns idx 0 and best = second = BIG, as argmin over an
// all-BIG row gives.  With q_valid all true the result is hamming_nn_pallas's.
// None of the TPU workarounds carry over: no f32 (distance, index) key
// packing, no T % 256 requirement, no T * 512 < 2^24 bound; any T >= 1.
//
// Callers: ops/track_match.match_by_descriptor, two launches per call (the
// row pass for the ratio test, the column pass for the mutual check), for
// relocalization, reference-keyframe tracking and the loop-closing window.
//
// Bound on the H100: launch overhead and integer throughput, not memory.
// Q x T pairs (1000 x 1000 per pass on the main path, x 11 for the loop
// window) cost 8 popcounts each; a target set is 32 KB of packed
// descriptors and stays in L2.  At these sizes the wrapper's packing and
// the launch dominate.
//
// Design: one warp per query row, 8 warps per CTA.  The CTA stages tiles of
// 256 targets (packed 8 x u32 descriptors and validity) in shared memory, so
// each target is read from L2 once per 8 queries.  Lanes stride over the
// tile in ascending index and popcount only valid pairs; each lane keeps a
// running (best, idx, second), and a shuffle reduction with the index as
// tie-break merges the 32 lanes.  grid.y is a batch: either side may be
// shared across it (batch stride 0), which serves the loop window's shared
// query set against up to 11 target keyframes, and its column pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

__global__ void hamming_nn_kernel(const uint32_t* __restrict__ q_desc,  // (Bq,Q,8)
                                  const uint8_t* __restrict__ q_valid,  // (Bq,Q)
                                  const uint32_t* __restrict__ t_desc,  // (Bt,T,8)
                                  const uint8_t* __restrict__ t_valid,  // (Bt,T)
                                  float* __restrict__ best_out,         // (B,Q)
                                  float* __restrict__ second_out,       // (B,Q)
                                  int* __restrict__ idx_out,            // (B,Q)
                                  int Q, int T, long q_bstride, long t_bstride) {
  __shared__ uint4 s_desc[TILE][2];
  __shared__ uint8_t s_v[TILE];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const bool has_q = q < Q;
  const long qo = static_cast<long>(b) * q_bstride + (has_q ? q : 0);

  uint32_t qd[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) qd[k] = q_desc[qo * 8 + k];
  const bool qv = has_q && q_valid[qo] != 0;

  int best = INT_MAX, bidx = INT_MAX, second = INT_MAX;
  const long tb = static_cast<long>(b) * t_bstride;
  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int n = min(TILE, T - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const long t = tb + t0 + j;
      const uint4* src = reinterpret_cast<const uint4*>(t_desc + t * 8);
      s_desc[j][0] = src[0];
      s_desc[j][1] = src[1];
      s_v[j] = t_valid[t];
    }
    __syncthreads();
    if (!has_q) continue;
    for (int j = lane; j < n; j += 32) {
      int d = GATED;
      if (qv && s_v[j] != 0) {
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
    const long o = static_cast<long>(b) * Q + q;
    best_out[o] = best >= GATED ? BIG : static_cast<float>(best);
    second_out[o] = second >= GATED ? BIG : static_cast<float>(second);
    idx_out[o] = bidx;
  }
}

}  // namespace

// q_shared / t_shared: that side has no batch axis and is reused by every
// batch row (batch stride 0).
extern "C" int hamming_nn(const void* q_desc, const void* q_valid,
                          const void* t_desc, const void* t_valid, void* best,
                          void* second, void* idx, int B, int Q, int T,
                          int q_shared, int t_shared, void* stream) {
  dim3 block(WARPS * 32);
  dim3 grid((Q + WARPS - 1) / WARPS, B);
  hamming_nn_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_desc), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint32_t*>(t_desc), static_cast<const uint8_t*>(t_valid),
      static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int*>(idx), Q, T, q_shared ? 0L : static_cast<long>(Q),
      t_shared ? 0L : static_cast<long>(T));
  return static_cast<int>(cudaGetLastError());
}
