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
// Bound on the H100: operations.  On the main path N = 1000 queries meet
// L = 4096 landmarks: 4.1 M pairs.  Counting every pair as passing the
// gates, a pair costs about 10 gate operations plus 24 for 8 xor, 8
// popcounts and 8 adds: 139 M operations, 2.1 us at 67 T/s.  The bytes
// are small (the inputs and outputs move 0.4 MB, 0.12 us at 3.35 TB/s).
// On real data only a few pairs per query pass the gates, so the gate
// compares dominate.
//
// Design, for a card with 132 SMs:
// - A thread-block cluster of S = 4 CTAs shares one tile of Qt = 8
//   queries and splits the landmark axis: CTA r scans chunk r of L / S
//   landmarks.  At N = 1000, L = 4096 that is 125 clusters, 500 CTAs of
//   1024 landmarks each, so every SM has work.
// - Each of the 8 warps holds one query in registers (words and gates);
//   its lanes walk the chunk in ascending index.  Only pairs that pass the
//   gates pay the popcounts.  Validity is folded into the gates: an
//   invalid landmark gets radius -1, an invalid query a NaN coordinate, so
//   every comparison fails exactly where the reference masks.
// - The chunk's descriptors (32 bytes a landmark) arrive in passes of
//   TILE = 512 landmarks, each with one bulk asynchronous copy
//   (cp.async.bulk, completion on an mbarrier) while the threads stage the
//   gate fields.
// - A warp merges its lanes with shuffles and writes the query's partial
//   (best, idx, second) straight into the shared memory of the CTA that
//   merges that query (distributed shared memory); one cluster barrier
//   later, each CTA merges its Qt / S queries from the S partials and
//   writes them.  A split barrier arrived at the start makes sure every
//   peer has started before the first remote write.  Ties go to the lower
//   index and the second-best leaves out only the argmin index, so the
//   result is exact whatever the merge order.
// - Only passing pairs enter the running (best, idx, second); a query
//   with no passing pair resolves to idx 0 and best = second = BIG, and a
//   missing second-best to BIG, which is what the all-BIG gated entries
//   give in the reference.
// - An optional leading batch dimension (grid.y) serves the fuse step's
//   many-keyframe call; the landmark descriptors are shared across the
//   batch, the projected gates are per batch row.
// Tuning on the H100 (utils/kernel_sweep.py; numbers in PERF.md): the
// first cut, Qt = 32 with 4 queries a warp and S = 8 with a two-barrier
// pull merge, spent half its time at N = 1000, L = 4096 in cost that does
// not scale with L.  A cluster of 4 in place of 8, one query a warp in
// place of 2 or 4, and one barrier in place of two each cut the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 4;         // S: CTAs sharing one query tile
constexpr int WARPS = 8;
constexpr int QPW = 1;             // queries per warp
constexpr int QT = WARPS * QPW;    // queries per tile (32)
constexpr int TILE = 512;          // landmarks staged per pass
constexpr int NONE = INT_MAX;      // no passing pair yet
constexpr float BIG = 1e9f;
constexpr int PER_CTA = QT / CLUSTER;  // queries each CTA merges
static_assert(QT % CLUSTER == 0, "each CTA merges QT / CLUSTER queries");

struct Part {
  int best, idx, second;
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: announce `bytes` on the barrier and start the bulk copy.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Split cluster barrier: arriving at the start and waiting before the first
// write to a peer CTA's shared memory guarantees every CTA of the cluster
// has started, at no cost on the critical path.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WARPS * 32)
    gated_nn_kernel(const uint32_t* __restrict__ q_desc,  // (B,N,8)
                    const float* __restrict__ q_uv,       // (B,N,2)
                    const int* __restrict__ q_level,      // (B,N)
                    const uint8_t* __restrict__ q_valid,  // (B,N)
                    const uint32_t* __restrict__ t_desc,  // (L,8), 16B aligned
                    const float* __restrict__ t_uv,       // (B,L,2)
                    const float* __restrict__ t_radius,   // (B,L)
                    const int* __restrict__ t_level,      // (B,L)
                    const uint8_t* __restrict__ t_valid,  // (B,L)
                    float* __restrict__ best_out,         // (B,N)
                    float* __restrict__ second_out,       // (B,N)
                    int* __restrict__ idx_out,            // (B,N)
                    int N, int L, int slack) {
  __shared__ __align__(128) uint4 s_desc[TILE][2];
  __shared__ float4 s_gate[TILE];  // x, y, radius (-1: invalid), level bits
  __shared__ Part s_part[CLUSTER][PER_CTA];  // [source rank][query]
  __shared__ __align__(8) uint64_t s_bar;

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = (blockIdx.x / CLUSTER) * QT;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  uint32_t qd[QPW][8];
  float qx[QPW], qy[QPW];
  int ql[QPW], best[QPW], bidx[QPW], second[QPW];
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
    const int q = q0 + warp * QPW + k;
    const bool has = q < N;
    const long qo = static_cast<long>(b) * N + (has ? q : 0);
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[k][w] = q_desc[qo * 8 + w];
    qx[k] = (has && q_valid[qo]) ? q_uv[qo * 2] : __int_as_float(0x7fffffff);
    qy[k] = q_uv[qo * 2 + 1];
    ql[k] = q_level[qo];
    best[k] = bidx[k] = second[k] = NONE;
  }

  const int chunk = (L + CLUSTER - 1) / CLUSTER;
  const int c0 = min(L, rank * chunk);
  const int c1 = min(L, c0 + chunk);
  const long gb = static_cast<long>(b) * L;
  if (threadIdx.x == 0) mbar_init(&s_bar, 1);
  __syncthreads();

  uint32_t parity = 0;
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    const int n = min(TILE, c1 - t0);
    if (threadIdx.x == 0)
      bulk_load(s_desc, t_desc + static_cast<long>(t0) * 8, n * 32, &s_bar);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const long g = gb + t0 + j;
      const float r = t_valid[g] ? t_radius[g] : -1.0f;
      s_gate[j] = make_float4(t_uv[g * 2], t_uv[g * 2 + 1], r,
                              __int_as_float(t_level[g]));
    }
    __syncthreads();
    mbar_wait(&s_bar, parity);
    parity ^= 1;
    for (int j = lane; j < n; j += 32) {
      const float4 gt = s_gate[j];
      const int tl = __float_as_int(gt.w);
      bool ok[QPW];
      bool any = false;
#pragma unroll
      for (int k = 0; k < QPW; ++k) {
        const int dl = ql[k] - tl;
        ok[k] = fabsf(qx[k] - gt.x) <= gt.z && fabsf(qy[k] - gt.y) <= gt.z &&
                dl >= -slack && dl <= slack;
        any |= ok[k];
      }
      if (!any) continue;
      const uint4 a = s_desc[j][0], c = s_desc[j][1];
      const int t = t0 + j;
#pragma unroll
      for (int k = 0; k < QPW; ++k) {
        if (!ok[k]) continue;
        const int d = __popc(qd[k][0] ^ a.x) + __popc(qd[k][1] ^ a.y) +
                      __popc(qd[k][2] ^ a.z) + __popc(qd[k][3] ^ a.w) +
                      __popc(qd[k][4] ^ c.x) + __popc(qd[k][5] ^ c.y) +
                      __popc(qd[k][6] ^ c.z) + __popc(qd[k][7] ^ c.w);
        // Ascending index within a lane: a tie with the running best is a
        // later index and becomes the second-best.
        if (d < best[k]) {
          second[k] = best[k];
          best[k] = d;
          bidx[k] = t;
        } else if (d < second[k]) {
          second[k] = d;
        }
      }
    }
    __syncthreads();  // every read of this pass ends before the next copy
  }

  // Each warp's partial for query qi goes to the shared memory of the CTA
  // that merges qi (rank qi / PER_CTA), in this CTA's row.
  cluster_wait();
#pragma unroll
  for (int k = 0; k < QPW; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(0xffffffffu, best[k], off);
      const int oi = __shfl_down_sync(0xffffffffu, bidx[k], off);
      const int os = __shfl_down_sync(0xffffffffu, second[k], off);
      merge(best[k], bidx[k], second[k], ob, oi, os);
    }
    if (lane == 0) {
      const int qi = warp * QPW + k;
      Part* dst = cluster.map_shared_rank(&s_part[0][0], qi / PER_CTA);
      dst[rank * PER_CTA + qi % PER_CTA] = Part{best[k], bidx[k], second[k]};
    }
  }
  cluster.sync();  // every partial has landed; after this, reads are local

  if (threadIdx.x < PER_CTA) {
    int bb = NONE, bi = NONE, bs = NONE;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const Part p = s_part[r][threadIdx.x];
      merge(bb, bi, bs, p.best, p.idx, p.second);
    }
    const int q = q0 + rank * PER_CTA + threadIdx.x;
    if (q < N) {
      const long o = static_cast<long>(b) * N + q;
      best_out[o] = bb == NONE ? BIG : static_cast<float>(bb);
      second_out[o] = bs == NONE ? BIG : static_cast<float>(bs);
      idx_out[o] = bb == NONE ? 0 : bi;
    }
  }
}

}  // namespace

extern "C" int gated_nn(const void* q_desc, const void* q_uv, const void* q_level,
                        const void* q_valid, const void* t_desc, const void* t_uv,
                        const void* t_radius, const void* t_level,
                        const void* t_valid, void* best, void* second, void* idx,
                        int B, int N, int L, int slack, void* stream) {
  dim3 block(WARPS * 32);
  dim3 grid(((N + QT - 1) / QT) * CLUSTER, B);
  gated_nn_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_desc), static_cast<const float*>(q_uv),
      static_cast<const int*>(q_level), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint32_t*>(t_desc), static_cast<const float*>(t_uv),
      static_cast<const float*>(t_radius), static_cast<const int*>(t_level),
      static_cast<const uint8_t*>(t_valid), static_cast<float*>(best),
      static_cast<float*>(second), static_cast<int*>(idx), N, L, slack);
  return static_cast<int>(cudaGetLastError());
}
