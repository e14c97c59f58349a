// K3: masked Hamming nearest neighbour, by rows and by columns in one launch.
//
// Replaces the TPU kernel orb_slam3_study_kr_tpu/ops/pallas_matching.py
// (hamming_nn_pallas, kernel _nn_kernel).  For each query row q it returns
// the best and second-best Hamming distance and the first-index argmin over
// all targets t, where a pair counts only when q_valid[q] && t_valid[t];
// every other pair scores BIG = 1e9.  The second-best leaves out only the
// argmin index, so a tie at another index gives second == best.  A row with
// no valid pair returns idx 0 and best = second = BIG, as argmin over an
// all-BIG row gives.  With q_valid all true the rows are hamming_nn_pallas's.
// When asked (back != null), the same launch also returns for each target
// the first-index argmin over queries of the same masked matrix (0 for a
// column with no valid pair): match_by_descriptor's mutual check.  None of
// the TPU workarounds carry over: no f32 (distance, index) key packing, no
// T % 256 requirement; any Q, T >= 1.
//
// Callers: ops/track_match.match_by_descriptor, one launch per call, for
// relocalization, reference-keyframe tracking and the loop-closing window
// (one shared query set against up to 11 target keyframes, grid.y).
//
// Bound on the H100: at the main path's sizes, latency, not work.
// Q = T = 1000 (x 11 for the loop window) is 10^6 pairs; their distances
// are 5.1e8 int8 tensor-core operations (0.26 us at 1,979 T/s), their row
// and column compares about 6e6 integer operations (0.09 us at 67 T/s),
// and the bytes (257 per descriptor and validity in, 16 per row and
// column out) 0.16 us at 3.35 TB/s.  An empty launch of this grid, the
// memset of the column keys, the staging of each CTA's rows from L2 and
// one cluster barrier each cost more than that (PERF.md has the sweep).
//
// Design:
// - Distances on the tensor cores, as the TPU kernel takes them from its
//   matrix unit: the 0/1 descriptor bytes are the int8 operands of
//   mma.sync m16n8k32 (s8 x s8 -> s32; both sides are K-contiguous
//   (., 256) rows, "row.col" as they stand) and d = |q| + |t| - 2 q.t,
//   exact in int32.  The callers' (., 256) uint8 bits go in unpacked.
// - A CTA of 4 warps owns 64 queries; each warp stages its 16 query rows
//   and keeps their A fragments (all 8 k-steps, 32 registers) for the
//   whole launch.  A cluster of 8 CTAs splits the target axis in tiles of
//   128: CTA r takes tiles r, r + 8, ...  At Q = T = 1000 that is
//   16 x 8 = 128 CTAs, one tile each.  Rows are staged with cp.async, two
//   rows (512 contiguous bytes) an instruction, into padded shared-memory
//   rows of 272 bytes, so that ldmatrix.x4 reads the A and B fragments
//   without bank conflicts.  When a CTA has more than one tile, a second
//   buffer takes the next tile while the warps work on the current one;
//   with one, a single buffer keeps four CTAs on an SM.  Each warp keeps
//   4 n-tiles of 8 targets in flight (independent accumulator chains).
// - |q| and |t| are byte-lane sums of the 0/1 bytes (no carries up to 255
//   a lane) finished by one dp4a: popc runs at a quarter of the add rate.
// - Masking is folded into those counts: an invalid or padded row or
//   column adds 2^24 to its |q| or |t|, and d = min(|q| + |t| - 2 q.t,
//   GATED) then gives exactly GATED there (GATED = 512 > any distance).
//   Gated pairs enter every reduction at GATED with their index, so the
//   first-index rules hold unchanged and GATED maps to BIG on output.
// - Rows: each thread walks its columns in ascending index with a running
//   (best, idx, second); the 4 lanes of a row and the 8 CTAs of the
//   cluster merge with merge(), exact in any order because ties go by
//   index.  The CTA partials meet in the merging CTA's shared memory
//   (distributed shared memory, one cluster barrier).
// - Columns: per tile, the (d << 8 | row) key of each thread's two rows
//   goes to shared memory; one thread a column takes the minimum over the
//   CTA's 64 rows and merges across query tiles with a 64-bit atomicMin on
//   (d << 32 | q) per (batch, target), order-free and exactly first-index.
//   The entry point sets the keys to all ones first (a memset on the same
//   stream); the wrapper reads q from their low words.
// - grid.y is a batch: either side may be shared across it (batch stride
//   0), which serves the loop window's shared query set against up to 11
//   target keyframes, and batched queries against shared targets.
// Measured on the H100 and dropped (PERF.md): the same tiling with __popc
// on packed words in place of the tensor cores; a cluster of 4, a cluster
// sized at run time, 8 warps a CTA; one bulk copy per target row; staging
// through registers; a self-restoring key workspace in place of the
// memset; CTAs that loop over several batch rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;              // CTAs splitting the target axis
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * 16;          // queries per CTA: one m16 tile a warp
constexpr int TT = THREADS;             // targets per tile: one row a thread
constexpr int DESC = 256;               // bytes of one descriptor (0/1 each)
constexpr int PITCH = DESC + 16;        // padded shared-memory row
constexpr int BUF_BYTES = TT * PITCH;
constexpr int COLP = TT + 8;            // padded row of the column keys
constexpr int NJ = 4;                   // n-tiles of 8 targets in flight a warp
constexpr int PER_CTA = QT / CLUSTER;   // queries each CTA merges and writes
constexpr int GATED = 512;              // > any distance of 256 bits
constexpr int OFF = 1 << 24;            // |q| or |t| offset of a gated row
constexpr int NONE = INT_MAX;
constexpr float BIG = 1e9f;
static_assert(QT % CLUSTER == 0, "each CTA merges QT / CLUSTER queries");
static_assert(QT <= 256, "a column key keeps the local row in 8 bits");
static_assert(TT % (8 * NJ) == 0, "a tile holds whole groups of NJ n-tiles");
static_assert(WARPS * 8 * COLP * 4 <= QT * PITCH, "column keys fit the query rows");

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

// One more column, in ascending index: a tie with the running best is a
// later index and becomes the second-best.
__device__ __forceinline__ void push(int& b, int& i, int& s, int d, int col) {
  s = min(s, max(b, d));
  i = d < b ? col : i;
  b = min(b, d);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous (no registers), in the current
// commit group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    hamming_nn_kernel(const uint8_t* __restrict__ q_desc,   // (Bq,Q,256)
                      const uint8_t* __restrict__ q_valid,  // (Bq,Q)
                      const uint8_t* __restrict__ t_desc,   // (Bt,T,256)
                      const uint8_t* __restrict__ t_valid,  // (Bt,T)
                      float* __restrict__ best_out,         // (B,Q)
                      float* __restrict__ second_out,       // (B,Q)
                      int* __restrict__ idx_out,            // (B,Q)
                      unsigned long long* __restrict__ back,  // (B,T) or null
                      int Q, int T, long q_bstride, long t_bstride, int nbuf) {
  extern __shared__ __align__(128) uint8_t s_buf[];  // nbuf x TT x PITCH
  // The CTA's query rows, padded; once the warps hold their A fragments
  // the same bytes take the column keys, [warp, group][column].
  __shared__ __align__(128) uint8_t s_q[QT * PITCH];
  uint32_t(*s_col)[COLP] = reinterpret_cast<uint32_t(*)[COLP]>(s_q);
  __shared__ __align__(8) int s_nt[TT];               // |t| (+ OFF when gated)
  __shared__ Part s_part[CLUSTER * PER_CTA];          // [source rank][query]

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = (blockIdx.x / CLUSTER) * QT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: rows g and g + 8, column g of B
  const int tig = lane & 3;  // thread in group: columns 2 tig, 2 tig + 1
  const long qb = static_cast<long>(b) * q_bstride;
  const long tb = static_cast<long>(b) * t_bstride;
  const int n_tiles = (T + TT - 1) / TT;

  // Tile `it` of this CTA is target tile rank + it * CLUSTER.  Warp w
  // copies rows 32 w .. 32 w + 31, two rows (512 contiguous bytes) per
  // instruction, into padded rows, in one commit group.
  // The validity of row tid of each staged tile is read as the tile is
  // issued, so that its latency overlaps the copies'.
  int tv = 0;  // bit k: row tid of the tile in buffer k is valid
  auto issue = [&](int it) {
    const int t0 = (rank + it * CLUSTER) * TT;
    uint8_t* buf = s_buf + (it % nbuf) * BUF_BYTES;
    const int bit = 1 << (it % nbuf);
    tv = (t0 + tid < T && t_valid[tb + t0 + tid]) ? tv | bit : tv & ~bit;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int r = warp * 32 + k * 2 + (lane >> 4);
      if (t0 + r < T)
        cp_async16(buf + r * PITCH + (lane & 15) * 16,
                   t_desc + (tb + t0 + r) * DESC + (lane & 15) * 16);
    }
    cp_async_commit();
  };
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // local rows of this thread
  const bool h0 = q0 + lr0 < Q, h1 = q0 + lr1 < Q;
  const bool qv0 = h0 && q_valid[qb + q0 + lr0];
  const bool qv1 = h1 && q_valid[qb + q0 + lr1];

  // Warp w stages its own 16 query rows, two rows per instruction, and
  // reads its A fragments back with ldmatrix.x4: matrix m holds rows
  // 8 (m & 1) .. + 7, bytes 16 (m >> 1) .. + 15 of a k-step.  Rows past Q
  // stay stale; their |q| is OFF, so they score GATED.
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = warp * 16 + k * 2 + (lane >> 4);
    if (q0 + r < Q)
      cp_async16(s_q + r * PITCH + (lane & 15) * 16,
                 q_desc + (qb + q0 + r) * DESC + (lane & 15) * 16);
  }
  cp_async_commit();
  if (rank < n_tiles) {
    issue(0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncwarp();

  // The warp's 16 query rows as A fragments, and their popcounts.
  const uint32_t lda = smem_addr(s_q) +
                       (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                       (lane >> 4) * 16;
  uint32_t a[8][4];
  uint32_t w0 = 0, w1 = 0;  // byte-lane sums of 0/1 bytes: no carries
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    ldsm_x4(a[kc], lda + kc * 32);
    w0 += a[kc][0] + a[kc][2];
    w1 += a[kc][1] + a[kc][3];
  }
  int p0 = static_cast<int>(__dp4a(w0, 0x01010101u, 0u));
  int p1 = static_cast<int>(__dp4a(w1, 0x01010101u, 0u));
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  const int nq0 = p0 + (qv0 ? 0 : OFF);
  const int nq1 = p1 + (qv1 ? 0 : OFF);

  int b0 = NONE, i0 = NONE, s0 = NONE;  // row lr0's running (best, idx, second)
  int b1 = NONE, i1 = NONE, s1 = NONE;  // row lr1's
  // ldmatrix.x4 row addresses: lanes 8m..8m+7 give the 8 target rows of
  // matrix m, which holds bytes 16 m..16 m + 15 of a pair of k-steps.
  const uint32_t lds_lane = (lane & 7) * PITCH + (lane >> 3) * 16;

  for (int it = 0; rank + it * CLUSTER < n_tiles; ++it) {
    const int t0 = (rank + it * CLUSTER) * TT;
    const int n = min(TT, T - t0);
    const bool has_next = rank + (it + 1) * CLUSTER < n_tiles;
    const uint8_t* buf = s_buf + (it % nbuf) * BUF_BYTES;
    // The next tile's copies go to the other buffer, read last in
    // iteration it - 1, which every thread has left.
    if (nbuf == 2 && has_next) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed
    int nt = OFF;
    if (tid < n) {
      const uint4* row = reinterpret_cast<const uint4*>(buf + tid * PITCH);
      // |t| as byte-lane sums of the 0/1 bytes (at most 64 a lane).
      uint4 w = row[0];
#pragma unroll
      for (int k = 1; k < DESC / 16; ++k) {
        const uint4 v = row[k];
        w.x += v.x;
        w.y += v.y;
        w.z += v.z;
        w.w += v.w;
      }
      const int p = static_cast<int>(__dp4a(w.x + w.y + w.z + w.w, 0x01010101u, 0u));
      nt = p + ((tv >> (it % nbuf)) & 1 ? 0 : OFF);
    }
    s_nt[tid] = nt;
    __syncthreads();  // s_nt is ready

    // NJ n-tiles at a time: independent accumulator chains keep the
    // tensor cores busy with one warp per scheduler.  Rows past n read
    // stale shared memory; their |t| is OFF, so they score GATED.
    const uint32_t base = smem_addr(buf) + lds_lane;
    const int n8 = (n + 7) / 8;
    for (int j = 0; j < n8; j += NJ) {
      int c[NJ][4] = {};
#pragma unroll
      for (int kc = 0; kc < 8; kc += 2) {
        uint32_t f[NJ][4];
#pragma unroll
        for (int u = 0; u < NJ; ++u)
          ldsm_x4(f[u], base + (j + u) * 8 * PITCH + kc * 32);
#pragma unroll
        for (int u = 0; u < NJ; ++u) mma_s8(c[u], a[kc], f[u][0], f[u][1]);
#pragma unroll
        for (int u = 0; u < NJ; ++u) mma_s8(c[u], a[kc + 1], f[u][2], f[u][3]);
      }
#pragma unroll
      for (int u = 0; u < NJ; ++u) {
        const int col = (j + u) * 8 + tig * 2;
        const int2 ntc = *reinterpret_cast<const int2*>(&s_nt[col]);
        const int d0 = min(nq0 + ntc.x - 2 * c[u][0], GATED);
        const int d1 = min(nq0 + ntc.y - 2 * c[u][1], GATED);
        const int d2 = min(nq1 + ntc.x - 2 * c[u][2], GATED);
        const int d3 = min(nq1 + ntc.y - 2 * c[u][3], GATED);
        push(b0, i0, s0, d0, t0 + col);
        push(b0, i0, s0, d1, t0 + col + 1);
        push(b1, i1, s1, d2, t0 + col);
        push(b1, i1, s1, d3, t0 + col + 1);
        if (back != nullptr) {
          // Row lr0 < lr1: the minimum key keeps the lower row on a tie.
          const uint32_t k0 = min(static_cast<uint32_t>(d0 << 8 | lr0),
                                  static_cast<uint32_t>(d2 << 8 | lr1));
          const uint32_t k1 = min(static_cast<uint32_t>(d1 << 8 | lr0),
                                  static_cast<uint32_t>(d3 << 8 | lr1));
          *reinterpret_cast<uint2*>(&s_col[warp * 8 + g][col]) = make_uint2(k0, k1);
        }
      }
    }
    __syncthreads();  // every read of buf and every column key of this tile
    if (nbuf == 1 && has_next) issue(it + 1);
    if (back != nullptr && tid < n) {
      uint32_t k = UINT_MAX;
#pragma unroll 8
      for (int w = 0; w < WARPS * 8; ++w) k = min(k, s_col[w][tid]);
      const unsigned long long key =
          (static_cast<unsigned long long>(k >> 8) << 32) |
          static_cast<unsigned long long>(q0 + (k & 0xff));
      atomicMin(&back[static_cast<long>(b) * T + t0 + tid], key);
    }
  }

  // Rows: merge the 4 lanes of each row, then push the CTA's partial for
  // local row lr into the shared memory of the CTA that writes it (rank
  // lr / PER_CTA), in this CTA's slot.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    int ob = __shfl_xor_sync(0xffffffffu, b0, off);
    int oi = __shfl_xor_sync(0xffffffffu, i0, off);
    int os = __shfl_xor_sync(0xffffffffu, s0, off);
    merge(b0, i0, s0, ob, oi, os);
    ob = __shfl_xor_sync(0xffffffffu, b1, off);
    oi = __shfl_xor_sync(0xffffffffu, i1, off);
    os = __shfl_xor_sync(0xffffffffu, s1, off);
    merge(b1, i1, s1, ob, oi, os);
  }
  cluster_wait();  // every CTA of the cluster has started
  if (tig == 0) {
    Part* dst0 = cluster.map_shared_rank(s_part, lr0 / PER_CTA);
    dst0[rank * PER_CTA + lr0 % PER_CTA] = Part{b0, i0, s0};
    Part* dst1 = cluster.map_shared_rank(s_part, lr1 / PER_CTA);
    dst1[rank * PER_CTA + lr1 % PER_CTA] = Part{b1, i1, s1};
  }
  cluster.sync();  // every partial has landed; after this, reads are local

  if (tid < PER_CTA) {
    int bb = NONE, bi = NONE, bs = NONE;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const Part p = s_part[r * PER_CTA + tid];
      merge(bb, bi, bs, p.best, p.idx, p.second);
    }
    const int q = q0 + rank * PER_CTA + tid;
    if (q < Q) {
      const long o = static_cast<long>(b) * Q + q;
      best_out[o] = bb >= GATED ? BIG : static_cast<float>(bb);
      second_out[o] = bs >= GATED ? BIG : static_cast<float>(bs);
      idx_out[o] = bb == NONE ? 0 : bi;
    }
  }
}

}  // namespace

// q_shared / t_shared: that side has no batch axis and is reused by every
// batch row (batch stride 0).  back: null for the rows alone, else (B, T)
// 64-bit keys whose low words become the column argmin.  Descriptor rows
// must start 16-byte aligned (they are copied 16 bytes at a time).
extern "C" int hamming_nn(const void* q_desc, const void* q_valid,
                          const void* t_desc, const void* t_valid, void* best,
                          void* second, void* idx, void* back, int B, int Q,
                          int T, int q_shared, int t_shared, void* stream) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(hamming_nn_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * BUF_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (back != nullptr) {
    err = cudaMemsetAsync(back, 0xff, sizeof(unsigned long long) *
                                          static_cast<size_t>(B) * T, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (T + TT - 1) / TT;
  const int nbuf = n_tiles > CLUSTER ? 2 : 1;
  dim3 grid(((Q + QT - 1) / QT) * CLUSTER, B);
  hamming_nn_kernel<<<grid, THREADS, nbuf * BUF_BYTES, s>>>(
      static_cast<const uint8_t*>(q_desc), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint8_t*>(t_desc), static_cast<const uint8_t*>(t_valid),
      static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int*>(idx), static_cast<unsigned long long*>(back), Q, T,
      q_shared ? 0L : static_cast<long>(Q), t_shared ? 0L : static_cast<long>(T),
      nbuf);
  return static_cast<int>(cudaGetLastError());
}
