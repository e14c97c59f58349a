// K4: the global BA's block-Jacobi PCG loop on the reduced camera system.
//
// Replaces no TPU kernel: the reference's matrix-free solve
// (orb_slam3_study_kr_tpu/solvers/local_ba.py, the PCG assembly) is plain
// jnp.  It was added because the loop holds four fifths of a large global
// BA on the card: as PyTorch ops every CG iteration handed two products of
// 1.2 M tiny matrices to cuBLAS as batched gemv, plus two fixed-order
// segment sums and a dozen elementwise passes (3.3 ms an iteration at
// K = 2048 poses, M = 153,600 landmarks, O = 1,228,800 observations).
//
// One call runs n_cg iterations of
//   Ap = freeK (Hpp_d v - W Hll_inv W^T v),  v = freeK p
//   alpha = rz / (p . Ap)  (0 unless |p . Ap| > 1e-20, so NaN gives 0)
//   x += alpha p;  r -= alpha Ap;  z = Minv r;  rz' = r . z
//   beta = rz' / rz  (0 unless |rz| > 1e-20);  p = z + beta p
// as three kernels an iteration, queued on the caller's stream with no
// sync.  W is never formed: its blocks are the observations' E (6x3).
//   A  landmark_sweep, landmark-major: for each landmark m
//        t_m = sum_{n in m} E_n^T v[pose(n)],  z_m = Hll_inv_m t_m,
//        y_n = E_n z_m for each of its observations;
//   B  pose_sweep, one block per pose k: u2_k = sum of y over the pose's
//        observations, Ap_k and the pose's partial of p . Ap; the last
//        block to finish sums the partials in index order and sets alpha;
//   C  cg_update, one thread per pose: x, r, z = Minv r and the block's
//        partial of r . z; the last block sums them in index order and
//        sets beta and rz.
// p is never written by C: A and B both form p = z + beta p_prev with one
// fma from the same operands (so the same bits), and B stores it for C
// and for the next iteration (two buffers, alternating).
//
// The full inertial BA (solvers/inertial_ba.py, the PCG assembly; its
// reference is the dense jnp solve of orb_slam3_study_kr_tpu/solvers/
// inertial_ba.py) runs the same loop on 15-wide states [phi, p, v, bg,
// ba]: A and C are the same kernels at a state width S = 15 (A reads the
// pose slice), and B is pose_sweep_vi, which adds each state's 15x15
// diagonal block D and its chain neighbours' couplings U (a keyframe's
// inertial edges reach only the previous and the next keyframe).  The
// 6-wide instances compile to the code they had before S was a template
// parameter.  An inertial iteration moves 171 MB at the long map's size
// (the visual bytes plus 15-wide vectors and D, U and Minv at 225 values
// a state; portbench/vipcg.py), 0.051 ms at 3.35 TB/s.
//
// Bound on the H100: bytes.  An iteration reads E once (18 floats an
// observation, 88.5 MB), Hll_inv (5.5 MB), the landmark offsets and the
// observations' poses (5.5 MB), the pose-ordered positions (4.9 MB), and
// writes and reads y (6 floats an observation, 29.5 MB each way): about
// 165 MB, 0.049 ms at 3.35 TB/s; the pose-space vectors and the 6x6 blocks
// are under 1 MB.  The work is about 90 flops an observation (0.11 GFLOP).
// What the design does about it:
// - E is gathered once per LM step into landmark-sorted order as 18
//   planes of O values, so the 8 lanes that share a landmark read
//   consecutive addresses of each plane; its loads are streaming
//   (evict-first), so y, written with normal priority, mostly stays in the
//   50 MB L2 until B reads it;
// - E is read once an iteration: a lane keeps its observation's 18 values
//   in registers from the sum t_m to the product y_n;
// - y rows are padded to 8 values (one 32-byte sector a row in float32),
//   written and read with 16-byte vector accesses;
// - the pose-space update runs on the card, so Python leaves the loop.
//
// Sums: no float atomics.  Every sum has an order fixed by the index
// arrays alone (a lane's observations in order, then a shuffle tree over
// the 8 lanes; a pose's observations strided over the block's threads,
// then shuffle trees and the warps in order; the partials in index order),
// so two runs of one solve give the same bits.  Integer atomics only count
// finished blocks.
//
// Ranges: lm_off and pose_off cover only the live observations.  A
// bucketed map pads O up to a multiple of 8192 with masked observations of
// pose 0 and landmark 0; their E is 0, so the index puts them in a tail
// that no range covers (ops/cuda_schur.schur_index).  Left in, they would
// make landmark 0's group walk up to 1,024 serial steps per lane, twice,
// and pose 0's block sum up to 8,191 extra rows, in every launch.  A
// landmark's own track is walked G observations at a time, so the longest
// live track sets A's tail.
//
// Float32 is what the port runs.  No program caller passes float64: the
// float64 instance serves the tests and chip_smoke.py, which check the
// kernel's arithmetic there against the plain loop to 1e-10 (in float32 a
// step's cancellation in Hpp_d v - u2 leaves no tight bar), and keeps a
// float64 CUDA caller of the PCG assembly off the einsum path.

#include <cuda_runtime.h>

namespace {

constexpr int G = 8;               // lanes per landmark in A
constexpr int A_THREADS = 256;     // 32 landmarks a block
constexpr int LM_PER_BLOCK = A_THREADS / G;
constexpr int B_THREADS = 128;     // one block per pose
constexpr int C_THREADS = 64;      // one thread per pose
constexpr int YS = 8;              // y row stride (6 used)

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// The solver's guarded quotient: 0 unless |den| > 1e-20 (false for NaN).
template <typename T>
__device__ __forceinline__ T guarded_div(T num, T den) {
  return abs_(den) > T(1e-20) ? num / den : T(0);
}

// p = z + beta p_prev, one rounding; A and B must agree to the bit.
template <typename T>
__device__ __forceinline__ T direction(T z, T beta, T p_prev) {
  return fma_(beta, p_prev, z);
}

__device__ __forceinline__ void store_row(float* y, const float (&v)[6]) {
  float4* q = reinterpret_cast<float4*>(y);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], 0.f, 0.f);
}
__device__ __forceinline__ void store_row(double* y, const double (&v)[6]) {
  double2* q = reinterpret_cast<double2*>(y);
  q[0] = make_double2(v[0], v[1]);
  q[1] = make_double2(v[2], v[3]);
  q[2] = make_double2(v[4], v[5]);
  q[3] = make_double2(0.0, 0.0);
}
__device__ __forceinline__ void add_row(float (&u)[6], const float* y) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(y));
  const float4 b = __ldg(reinterpret_cast<const float4*>(y) + 1);
  u[0] += a.x; u[1] += a.y; u[2] += a.z; u[3] += a.w; u[4] += b.x; u[5] += b.y;
}
__device__ __forceinline__ void add_row(double (&u)[6], const double* y) {
  const double2* q = reinterpret_cast<const double2*>(y);
  const double2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  u[0] += a.x; u[1] += a.y; u[2] += b.x; u[3] += b.y; u[4] += c.x; u[5] += c.y;
}

// Sums v over the block in a fixed order: a shuffle tree in each warp,
// then the warps in order.  The result is valid in thread 0.
template <typename T, int N, int THREADS>
__device__ __forceinline__ void block_sum(T (&v)[N]) {
  constexpr int WARPS = THREADS / 32;
  __shared__ T sh[WARPS][N];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) sh[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = sh[0][i];
      for (int w = 1; w < WARPS; ++w) s += sh[w][i];
      v[i] = s;
    }
}

// Whether this block is the last of the grid to finish.  Thread 0 has
// written the block's results; every thread's writes are fenced first.
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// Observation n's E as 18 values e[a * 3 + b], streamed (read once).
template <typename T>
__device__ __forceinline__ void load_obs(T (&e)[18], const T* __restrict__ Ep,
                                         int n, int O) {
#pragma unroll
  for (int j = 0; j < 18; ++j) e[j] = __ldcs(Ep + (size_t)j * O + n);
}

// t += E^T v for an observation of pose k, v = freeK (z + beta p_prev)
// over the pose slice (the first 6) of a state S values wide.
template <typename T, int S>
__device__ __forceinline__ void accumulate(T (&t)[3], const T (&e)[18],
                                           int k, const T* __restrict__ freeK,
                                           const T* __restrict__ z,
                                           const T* __restrict__ p_prev,
                                           T beta) {
  const T fr = __ldg(freeK + k);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const T v = direction(__ldg(z + k * S + a), beta,
                          __ldg(p_prev + k * S + a)) * fr;
#pragma unroll
    for (int b = 0; b < 3; ++b) t[b] += e[a * 3 + b] * v;
  }
}

template <typename T>
__device__ __forceinline__ void write_y(T* __restrict__ y, const T (&e)[18],
                                        const T (&zm)[3], int n) {
  T row[6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
    row[a] = e[a * 3] * zm[0] + e[a * 3 + 1] * zm[1] + e[a * 3 + 2] * zm[2];
  store_row(y + (size_t)n * YS, row);
}

template <typename T, int S>
__global__ void __launch_bounds__(A_THREADS) landmark_sweep(
    const T* __restrict__ Ep, const int* __restrict__ lm_off,
    const int* __restrict__ op_lm, const T* __restrict__ Hll_inv,
    const T* __restrict__ freeK, const T* __restrict__ z,
    const T* __restrict__ p_prev, const T* __restrict__ scal,
    T* __restrict__ y, int M, int O) {
  const int lane = threadIdx.x % G;
  const int m = blockIdx.x * LM_PER_BLOCK + threadIdx.x / G;
  if (m >= M) return;                       // the whole group
  const int start = __ldg(lm_off + m), end = __ldg(lm_off + m + 1);
  if (start == end) return;                 // the whole group
  const unsigned gmask = 0xffu << (threadIdx.x % 32 / G * G);
  const T beta = __ldg(scal + 1);
  T t[3] = {T(0), T(0), T(0)};
  T e[18];
  const int n = start + lane;
  const bool mine = n < end;
  if (mine) {
    load_obs(e, Ep, n, O);
    accumulate<T, S>(t, e, __ldcs(op_lm + n), freeK, z, p_prev, beta);
  }
  for (int q = n + G; q < end; q += G) {    // tracks longer than G
    T f[18];
    load_obs(f, Ep, q, O);
    accumulate<T, S>(t, f, __ldcs(op_lm + q), freeK, z, p_prev, beta);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int b = 0; b < 3; ++b) t[b] += __shfl_xor_sync(gmask, t[b], off, G);
  const T* H = Hll_inv + (size_t)m * 9;
  T zm[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    zm[a] = __ldg(H + a * 3) * t[0] + __ldg(H + a * 3 + 1) * t[1]
            + __ldg(H + a * 3 + 2) * t[2];
  if (mine) write_y(y, e, zm, n);
  for (int q = n + G; q < end; q += G) {
    T f[18];
    load_obs(f, Ep, q, O);
    write_y(y, f, zm, q);
  }
}

template <typename T>
__global__ void __launch_bounds__(B_THREADS) pose_sweep(
    const T* __restrict__ y, const int* __restrict__ pose_pos,
    const int* __restrict__ pose_off, const T* __restrict__ Hpp,
    const T* __restrict__ freeK, const T* __restrict__ z,
    const T* __restrict__ p_prev, T* __restrict__ p_cur, T* __restrict__ Ap,
    T* part, T* scal, unsigned* counter, int K) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  T u2[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int end = __ldg(pose_off + k + 1);
  for (int q = __ldg(pose_off + k) + tid; q < end; q += B_THREADS)
    add_row(u2, y + (size_t)__ldcs(pose_pos + q) * YS);
  block_sum<T, 6, B_THREADS>(u2);
  if (tid == 0) {
    const T beta = scal[1];
    const T fr = freeK[k];
    T p[6], v[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      p[a] = direction(z[k * 6 + a], beta, p_prev[k * 6 + a]);
      v[a] = p[a] * fr;
      p_cur[k * 6 + a] = p[a];
    }
    T d = T(0);
    for (int a = 0; a < 6; ++a) {
      T u = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) u += Hpp[k * 36 + a * 6 + b] * v[b];
      const T ap = (u - u2[a]) * fr;
      Ap[k * 6 + a] = ap;
      d += p[a] * ap;
    }
    part[k] = d;
  }
  if (!last_block(counter)) return;
  // p . Ap over the poses: thread i sums a run of consecutive partials,
  // then the block sums the runs in order.
  const int run = (K + B_THREADS - 1) / B_THREADS;
  T s[1] = {T(0)};
  const int hi = min(K, (tid + 1) * run);
  for (int i = tid * run; i < hi; ++i) s[0] += __ldcg(part + i);
  block_sum<T, 1, B_THREADS>(s);
  if (tid == 0) {
    scal[0] = guarded_div(scal[2], s[0]);
    *counter = 0u;
  }
}

// B of the inertial BA's reduced system, one block per state k of VS = 15
// values [phi, p, v, bg, ba]: u2_k as in pose_sweep, then row a of
//   Ap_k = freeD_k (D_k v_k + U_k v_nxt(k) + U_prv(k)^T v_prv(k) - P^T u2_k)
// on thread a < VS, with v = freeD (z + beta p_prev) formed from the same
// operands as the neighbours' own blocks form it (so the same bits), P^T
// placing u2 on the pose slice.  D_k holds the visual Hpp, the inertial
// blocks and the damping; U_k couples state k to the next state of the
// chain (nxt[k] < 0: none).  Then p . Ap as pose_sweep has it.
constexpr int VS = 15;

template <typename T>
__global__ void __launch_bounds__(B_THREADS) pose_sweep_vi(
    const T* __restrict__ y, const int* __restrict__ pose_pos,
    const int* __restrict__ pose_off, const T* __restrict__ D,
    const T* __restrict__ U, const int* __restrict__ nxt,
    const int* __restrict__ prv, const T* __restrict__ freeD,
    const T* __restrict__ z, const T* __restrict__ p_prev,
    T* __restrict__ p_cur, T* __restrict__ Ap, T* part, T* scal,
    unsigned* counter, int K) {
  __shared__ T su2[6];
  __shared__ T sv[3][VS];
  __shared__ T sprod[VS];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  T u2[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int end = __ldg(pose_off + k + 1);
  for (int q = __ldg(pose_off + k) + tid; q < end; q += B_THREADS)
    add_row(u2, y + (size_t)__ldcs(pose_pos + q) * YS);
  block_sum<T, 6, B_THREADS>(u2);
  if (tid == 0)
#pragma unroll
    for (int a = 0; a < 6; ++a) su2[a] = u2[a];
  const T beta = scal[1];
  const int kn = __ldg(nxt + k), kp = __ldg(prv + k);
  T p = T(0);
  if (tid < VS) {
    p = direction(z[k * VS + tid], beta, p_prev[k * VS + tid]);
    p_cur[k * VS + tid] = p;
    sv[0][tid] = p * freeD[k * VS + tid];
    sv[1][tid] = kn < 0 ? T(0)
        : direction(z[kn * VS + tid], beta, p_prev[kn * VS + tid])
              * freeD[kn * VS + tid];
    sv[2][tid] = kp < 0 ? T(0)
        : direction(z[kp * VS + tid], beta, p_prev[kp * VS + tid])
              * freeD[kp * VS + tid];
  }
  __syncthreads();
  if (tid < VS) {
    const int a = tid;
    const T* Dk = D + (size_t)k * VS * VS + a * VS;
    T u = T(0);
#pragma unroll
    for (int b = 0; b < VS; ++b) u += __ldg(Dk + b) * sv[0][b];
    if (kn >= 0) {
      const T* Uk = U + (size_t)k * VS * VS + a * VS;
#pragma unroll
      for (int b = 0; b < VS; ++b) u += __ldg(Uk + b) * sv[1][b];
    }
    if (kp >= 0) {
      const T* Up = U + (size_t)kp * VS * VS + a;
#pragma unroll
      for (int b = 0; b < VS; ++b) u += __ldg(Up + b * VS) * sv[2][b];
    }
    if (a < 6) u -= su2[a];
    const T ap = u * freeD[k * VS + a];
    Ap[k * VS + a] = ap;
    sprod[a] = p * ap;
  }
  __syncthreads();
  if (tid == 0) {
    T d = T(0);
    for (int a = 0; a < VS; ++a) d += sprod[a];
    part[k] = d;
  }
  if (!last_block(counter)) return;
  const int run = (K + B_THREADS - 1) / B_THREADS;
  T s[1] = {T(0)};
  const int hi = min(K, (tid + 1) * run);
  for (int i = tid * run; i < hi; ++i) s[0] += __ldcg(part + i);
  block_sum<T, 1, B_THREADS>(s);
  if (tid == 0) {
    scal[0] = guarded_div(scal[2], s[0]);
    *counter = 0u;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(C_THREADS) cg_update(
    const T* __restrict__ Minv, const T* __restrict__ p_cur,
    const T* __restrict__ Ap, T* __restrict__ x, T* __restrict__ r,
    T* __restrict__ z, T* part, T* scal, unsigned* counter, int K) {
  const int k = blockIdx.x * C_THREADS + threadIdx.x;
  const T alpha = scal[0];
  T rz[1] = {T(0)};
  if (k < K) {
    T rr[S];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      x[k * S + a] += alpha * p_cur[k * S + a];
      rr[a] = r[k * S + a] - alpha * Ap[k * S + a];
      r[k * S + a] = rr[a];
    }
#pragma unroll
    for (int a = 0; a < S; ++a) {
      T za = T(0);
#pragma unroll
      for (int b = 0; b < S; ++b) za += Minv[k * S * S + a * S + b] * rr[b];
      z[k * S + a] = za;
      rz[0] += rr[a] * za;
    }
  }
  block_sum<T, 1, C_THREADS>(rz);
  if (threadIdx.x == 0) part[blockIdx.x] = rz[0];
  if (!last_block(counter)) return;
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int i = 0; i < (int)gridDim.x; ++i) s += __ldcg(part + i);
    const T rz_old = scal[2];
    scal[1] = guarded_div(s, rz_old);
    scal[2] = s;
    *counter = 0u;
  }
}

template <typename T>
int schur_pcg(const T* Ep, const int* lm_off, const int* op_lm,
              const T* Hll_inv, const int* pose_pos, const int* pose_off,
              const T* Hpp, const T* freeK, const T* Minv, T* x, T* r, T* z,
              T* pa, T* pb, T* Ap, T* y, T* part, T* scal, unsigned* counters,
              int K, int M, int O, int n_cg, cudaStream_t stream) {
  if (K < 1 || M < 1 || O < 0 || n_cg < 0) return (int)cudaErrorInvalidValue;
  const int grid_a = (M + LM_PER_BLOCK - 1) / LM_PER_BLOCK;
  const int grid_c = (K + C_THREADS - 1) / C_THREADS;
  for (int i = 0; i < n_cg; ++i) {
    const T* p_prev = (i & 1) ? pb : pa;
    T* p_cur = (i & 1) ? pa : pb;
    landmark_sweep<T, 6><<<grid_a, A_THREADS, 0, stream>>>(
        Ep, lm_off, op_lm, Hll_inv, freeK, z, p_prev, scal, y, M, O);
    pose_sweep<T><<<K, B_THREADS, 0, stream>>>(
        y, pose_pos, pose_off, Hpp, freeK, z, p_prev, p_cur, Ap, part, scal,
        counters, K);
    cg_update<T, 6><<<grid_c, C_THREADS, 0, stream>>>(
        Minv, p_cur, Ap, x, r, z, part, scal, counters + 1, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The inertial BA's loop: A over the pose slice of 15-wide states, B as
// pose_sweep_vi, C on 15-wide states and 15x15 Minv blocks.
template <typename T>
int vi_schur_pcg(const T* Ep, const int* lm_off, const int* op_lm,
                 const T* Hll_inv, const int* pose_pos, const int* pose_off,
                 const T* D, const T* U, const int* nxt, const int* prv,
                 const T* freeK, const T* freeD, const T* Minv, T* x, T* r,
                 T* z, T* pa, T* pb, T* Ap, T* y, T* part, T* scal,
                 unsigned* counters, int K, int M, int O, int n_cg,
                 cudaStream_t stream) {
  if (K < 1 || M < 1 || O < 0 || n_cg < 0) return (int)cudaErrorInvalidValue;
  const int grid_a = (M + LM_PER_BLOCK - 1) / LM_PER_BLOCK;
  const int grid_c = (K + C_THREADS - 1) / C_THREADS;
  for (int i = 0; i < n_cg; ++i) {
    const T* p_prev = (i & 1) ? pb : pa;
    T* p_cur = (i & 1) ? pa : pb;
    landmark_sweep<T, VS><<<grid_a, A_THREADS, 0, stream>>>(
        Ep, lm_off, op_lm, Hll_inv, freeK, z, p_prev, scal, y, M, O);
    pose_sweep_vi<T><<<K, B_THREADS, 0, stream>>>(
        y, pose_pos, pose_off, D, U, nxt, prv, freeD, z, p_prev, p_cur, Ap,
        part, scal, counters, K);
    cg_update<T, VS><<<grid_c, C_THREADS, 0, stream>>>(
        Minv, p_cur, Ap, x, r, z, part, scal, counters + 1, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Ep (18, O) landmark-sorted E planes; lm_off (M+1); op_lm (O); Hll_inv
// (M, 3, 3); pose_pos (O); pose_off (K+1); Hpp and Minv (K, 6, 6); freeK
// (K); x, r, z, pa, pb, Ap (K, 6); y (O, 8) and part (K) scratch; scal
// (alpha, beta, rz); counters (2) zero.  On entry: x, r, z = Minv r, pa =
// 0 and scal = (0, 0, r . z); an even n_cg leaves the last p in pa, so a
// second call continues the same iteration.  Returns a cudaError_t.
extern "C" int schur_pcg_f32(const float* Ep, const int* lm_off,
                             const int* op_lm, const float* Hll_inv,
                             const int* pose_pos, const int* pose_off,
                             const float* Hpp, const float* freeK,
                             const float* Minv, float* x, float* r, float* z,
                             float* pa, float* pb, float* Ap, float* y,
                             float* part, float* scal, unsigned* counters,
                             int K, int M, int O, int n_cg, void* stream) {
  return schur_pcg<float>(Ep, lm_off, op_lm, Hll_inv, pose_pos, pose_off, Hpp,
                          freeK, Minv, x, r, z, pa, pb, Ap, y, part, scal,
                          counters, K, M, O, n_cg, (cudaStream_t)stream);
}

extern "C" int schur_pcg_f64(const double* Ep, const int* lm_off,
                             const int* op_lm, const double* Hll_inv,
                             const int* pose_pos, const int* pose_off,
                             const double* Hpp, const double* freeK,
                             const double* Minv, double* x, double* r,
                             double* z, double* pa, double* pb, double* Ap,
                             double* y, double* part, double* scal,
                             unsigned* counters, int K, int M, int O, int n_cg,
                             void* stream) {
  return schur_pcg<double>(Ep, lm_off, op_lm, Hll_inv, pose_pos, pose_off,
                           Hpp, freeK, Minv, x, r, z, pa, pb, Ap, y, part,
                           scal, counters, K, M, O, n_cg,
                           (cudaStream_t)stream);
}

// The inertial BA's loop over 15-wide states [phi, p, v, bg, ba]: as
// schur_pcg_f32 with D and U (K, 15, 15) in place of Hpp, nxt and prv (K)
// the chain's neighbours (-1: none), freeK (K) the poses' and freeD (K,
// 15) every value's free flag, Minv (K, 15, 15), x, r, z, pa, pb, Ap (K,
// 15).
extern "C" int vi_schur_pcg_f32(const float* Ep, const int* lm_off,
                                const int* op_lm, const float* Hll_inv,
                                const int* pose_pos, const int* pose_off,
                                const float* D, const float* U, const int* nxt,
                                const int* prv, const float* freeK,
                                const float* freeD, const float* Minv,
                                float* x, float* r, float* z, float* pa,
                                float* pb, float* Ap, float* y, float* part,
                                float* scal, unsigned* counters, int K, int M,
                                int O, int n_cg, void* stream) {
  return vi_schur_pcg<float>(Ep, lm_off, op_lm, Hll_inv, pose_pos, pose_off,
                             D, U, nxt, prv, freeK, freeD, Minv, x, r, z, pa,
                             pb, Ap, y, part, scal, counters, K, M, O, n_cg,
                             (cudaStream_t)stream);
}

extern "C" int vi_schur_pcg_f64(const double* Ep, const int* lm_off,
                                const int* op_lm, const double* Hll_inv,
                                const int* pose_pos, const int* pose_off,
                                const double* D, const double* U,
                                const int* nxt, const int* prv,
                                const double* freeK, const double* freeD,
                                const double* Minv, double* x, double* r,
                                double* z, double* pa, double* pb, double* Ap,
                                double* y, double* part, double* scal,
                                unsigned* counters, int K, int M, int O,
                                int n_cg, void* stream) {
  return vi_schur_pcg<double>(Ep, lm_off, op_lm, Hll_inv, pose_pos, pose_off,
                              D, U, nxt, prv, freeK, freeD, Minv, x, r, z, pa,
                              pb, Ap, y, part, scal, counters, K, M, O, n_cg,
                              (cudaStream_t)stream);
}
