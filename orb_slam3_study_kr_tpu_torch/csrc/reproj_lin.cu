// K5: the global BA's reprojection pass.  One launch linearizes every
// observation (camera point, pinhole projection, the stereo third row,
// cheirality, chi2, the Huber weight, the 2- or 3-row Jacobians) and sums
// the normal equations' blocks Hpp, bp, Hll, bl and the cross blocks E;
// a second kernel, the cost pass, gives the Huber cost and, when asked,
// each observation's chi2.
//
// Replaces no TPU kernel: the reference's linearization (`compute` in
// orb_slam3_study_kr_tpu/solvers/local_ba.py, `vis_terms` in
// orb_slam3_study_kr_tpu/solvers/inertial_ba.py) is plain jnp.  It was
// added because, as PyTorch ops, the pass handed 1.2 M tiny 3x3, 3x6 and
// 6x6 products to cuBLAS and materialised (O, 6, 6), (O, 3, 3) and
// (O, 6, 3) outer products before four segment sums: about 20 ms an LM
// step at K = 2048 poses, M = 153,600 landmarks, O = 1,228,800
// observations, and the trial cost built every Jacobian again.
//
// Two pose parametrisations, a template parameter:
//   BODY = false, left-multiplicative T_cw (solvers/local_ba.bundle_adjust):
//     p = R X + t, dp/dxi = [-hat(p) | I], dp/dX = R;
//   BODY = true, a right-multiplicative body state and the rig's camera
//     <- body extrinsic (solvers/inertial_ba.inertial_bundle_adjust):
//     q = R_wb^T (X - p_wb), p = R_cb q + t_cb, dp/dphi = R_cb hat(q),
//     dp/dp_wb = -R_cb R_wb^T, dp/dX = R_cb R_wb^T.
//
// The linearize launch has two kinds of block, which read the same
// inputs and share no data, so one launch serves both:
//   blocks [0, K): one a pose.  The block's threads walk the pose's live
//     observations (pose_pos[pose_off[k]:pose_off[k + 1]], strided), form
//     each observation's pose Jacobian, weight and residual, and sum Hpp
//     (6x6) and bp; they also write each observation's E row in
//     observation order, which the Schur terms and the back-substitution
//     read (the map stores observations pose by pose, so a warp's rows are
//     consecutive: staged in shared memory, they leave as whole lines);
//   blocks [K, K + ceil(M / 32)): 8 lanes a landmark.  The lanes walk the
//     landmark's live run lm_off[m]:lm_off[m + 1] of the landmark-sorted
//     order, sum Hll (3x3) and bl, and write E into K4's 18
//     landmark-sorted planes, which K4 (csrc/schur_pcg.cu) reads.
// The pose blocks recompute the Jacobians rather than read them from the
// landmark blocks: a pose Jacobian, weight and residual are 22 values an
// observation to write and read again, against a 32-byte record and a
// landmark's 12 bytes (from L2) to recompute them.
//
// Inputs: each observation's constants gathered once per solve into the
// landmark-sorted order as one 32-byte record [u, v, ur, inv_sigma2,
// mask, pose, landmark, observation] (the last three as integer bits),
// so a landmark's lanes read consecutive records and a pose's scattered
// reads take whole sectors; ur < 0 marks a mono observation (the third
// row is then 0); the camera block [fx, fy, cx, cy, bf, the two chi2
// gates, their square roots, R_cb, t_cb].
//
// Bound on the H100: bytes.  At the long map's size a linearize launch
// reads the records (39.3 MB), pose_pos (4.9 MB), the landmarks, their
// offsets and masks, the poses (3 MB), and writes E twice (88.5 MB each),
// Hll and bl (7.4 MB): about 232 MB, 0.069 ms at 3.35 TB/s.  A cost
// launch reads the records and writes chi2: about 47 MB.  The work is
// about 400 flops an observation (0.5 GFLOP).
//
// Sums: no float atomics.  Every sum has an order fixed by the index
// arrays (a lane's or a thread's observations in order, then a shuffle
// tree, then the warps in order; the cost's block partials in index
// order), and every arithmetic step rounds once (the _rn intrinsics, which
// the compiler never fuses into a multiply-add).  So two runs give the
// same bits, and the plain twin (ops/cuda_reproj.py), one PyTorch
// operation a step in the same order, gives the kernel's bits.
//
// Three blocks an SM (at most 85 registers a thread): the pass waits on
// dependent loads (record, pose or landmark), so resident warps set its
// pace; at two blocks (110-128 registers) it took 1.13-1.19 times as long.
//
// Float32 is what the port runs; the float64 instance serves the tests.

#include <cuda_runtime.h>

namespace {

constexpr int G = 8;                 // lanes a landmark
constexpr int THREADS = 256;
constexpr int LM_PER_BLOCK = THREADS / G;
constexpr int REC = 8;               // record width, values

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
template <typename T>
__device__ __forceinline__ T sub(T a, T b) { return add(a, -b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// (a0 b0 + a1 b1) + a2 b2, each step rounded.
template <typename T>
__device__ __forceinline__ T dot3(T a0, T b0, T a1, T b1, T a2, T b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// torch.clamp(a, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T a, T lo) { return a < lo ? lo : a; }

template <typename T>
struct Rec {
  T u, v, ur, isig, mask;
  int pose, lm, obs;
};

__device__ __forceinline__ void load_rec(Rec<float>& o, const float* rec, int n) {
  const float4* p = reinterpret_cast<const float4*>(rec + (size_t)n * REC);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  o.u = a.x; o.v = a.y; o.ur = a.z; o.isig = a.w; o.mask = b.x;
  o.pose = __float_as_int(b.y); o.lm = __float_as_int(b.z);
  o.obs = __float_as_int(b.w);
}
__device__ __forceinline__ void load_rec(Rec<double>& o, const double* rec,
                                         int n) {
  const double2* p = reinterpret_cast<const double2*>(rec + (size_t)n * REC);
  const double2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2),
                d = __ldg(p + 3);
  o.u = a.x; o.v = a.y; o.ur = b.x; o.isig = b.y; o.mask = c.x;
  o.pose = (int)__double_as_longlong(c.y);
  o.lm = (int)__double_as_longlong(d.x);
  o.obs = (int)__double_as_longlong(d.y);
}

// The camera block: fx, fy, cx, cy, bf, gate (mono, stereo), delta (mono,
// stereo), R_cb (row-major), t_cb.
enum { FX, FY, CX, CY, BF, GATE, DELTA = GATE + 2, RCB = DELTA + 2,
       TCB = RCB + 9, NCAM = TCB + 3 };

// One observation's residual and what the Jacobians need of it.
template <typename T>
struct Obs {
  T p[3];        // camera point
  T q[3];        // body mode: the point in the body frame
  T z;           // the clamped depth
  T h;           // 1 for a stereo observation, else 0
  T r[3];
  T chi2, valid, gate, delta;
};

template <typename T>
__device__ __forceinline__ void load_pose(T (&R)[9], T (&t)[3],
                                          const T* __restrict__ R_all,
                                          const T* __restrict__ t_all, int k) {
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = __ldg(R_all + k * 9 + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = __ldg(t_all + k * 3 + i);
}

template <typename T, bool BODY>
__device__ __forceinline__ void residual(Obs<T>& s, const T* cam,
                                         const T (&R)[9], const T (&t)[3],
                                         const T (&X)[3], const Rec<T>& o,
                                         T lmk) {
  if (BODY) {
    T d[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = sub(X[j], t[j]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s.q[i] = dot3(R[i], d[0], R[3 + i], d[1], R[6 + i], d[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s.p[i] = add(dot3(cam[RCB + 3 * i], s.q[0], cam[RCB + 3 * i + 1], s.q[1],
                        cam[RCB + 3 * i + 2], s.q[2]), cam[TCB + i]);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s.p[i] = add(dot3(R[3 * i], X[0], R[3 * i + 1], X[1], R[3 * i + 2], X[2]),
                   t[i]);
  }
  s.z = clamp_min(s.p[2], T(1e-6));
  const T u = add(mul(cam[FX], quo(s.p[0], s.z)), cam[CX]);
  const T v = add(mul(cam[FY], quo(s.p[1], s.z)), cam[CY]);
  const bool stereo = o.ur >= T(0);
  s.h = stereo ? T(1) : T(0);
  s.r[0] = sub(u, o.u);
  s.r[1] = sub(v, o.v);
  s.r[2] = mul(sub(sub(u, quo(cam[BF], s.z)), o.ur), s.h);
  s.chi2 = mul(dot3(s.r[0], s.r[0], s.r[1], s.r[1], s.r[2], s.r[2]), o.isig);
  s.valid = mul(mul(o.mask, lmk), s.p[2] > T(1e-3) ? T(1) : T(0));
  s.gate = stereo ? cam[GATE + 1] : cam[GATE];
  s.delta = stereo ? cam[DELTA + 1] : cam[DELTA];
}

// sqrt(max(chi2, 1e-12)), robust.huber_weight's and huber_rho's r.
template <typename T>
__device__ __forceinline__ T huber_r(T chi2) {
  return root(clamp_min(chi2, T(1e-12)));
}

template <typename T>
__device__ __forceinline__ T weight(const Obs<T>& s, const Rec<T>& o,
                                    int huber) {
  const T w = mul(o.isig, s.valid);
  if (!huber) return w;
  const T r = huber_r(s.chi2);
  return mul(w, r <= s.delta ? T(1) : quo(s.delta, r));
}

// The cost's term: huber_rho(chi2) valid, or chi2 valid without Huber.
template <typename T>
__device__ __forceinline__ T cost_term(const Obs<T>& s, int huber) {
  T rho = s.chi2;
  if (huber && !(s.chi2 <= s.gate))
    rho = sub(mul(mul(T(2), s.delta), huber_r(s.chi2)), s.gate);
  return mul(rho, s.valid);
}

// Jp (3x6, times the pose's free flag) and Jl (3x3): the rows of
// d(u, v, ur)/d(pose) and d(u, v, ur)/dX.
template <typename T, bool BODY>
__device__ __forceinline__ void jacobians(const Obs<T>& s, const T* cam,
                                          const T (&R)[9], T fr,
                                          T (&Jp)[3][6], T (&Jl)[3][3]) {
  const T zi = quo(T(1), s.z);
  const T zi2 = mul(zi, zi);
  T c[3][3];
  c[0][0] = mul(cam[FX], zi);
  c[0][1] = T(0);
  c[0][2] = mul(mul(-cam[FX], s.p[0]), zi2);
  c[1][0] = T(0);
  c[1][1] = mul(cam[FY], zi);
  c[1][2] = mul(mul(-cam[FY], s.p[1]), zi2);
  c[2][0] = mul(c[0][0], s.h);
  c[2][1] = T(0);
  c[2][2] = mul(add(c[0][2], quo(cam[BF], mul(s.z, s.z))), s.h);
  if (BODY) {
    T A[3][3];                        // R_cb R_wb^T
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        A[a][b] = dot3(cam[RCB + 3 * a], R[3 * b], cam[RCB + 3 * a + 1],
                       R[3 * b + 1], cam[RCB + 3 * a + 2], R[3 * b + 2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T d[3];                         // c_i R_cb
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Jl[i][j] = dot3(c[i][0], A[0][j], c[i][1], A[1][j], c[i][2], A[2][j]);
        d[j] = dot3(c[i][0], cam[RCB + j], c[i][1], cam[RCB + 3 + j], c[i][2],
                    cam[RCB + 6 + j]);
      }
      Jp[i][0] = sub(mul(d[1], s.q[2]), mul(d[2], s.q[1]));
      Jp[i][1] = sub(mul(d[2], s.q[0]), mul(d[0], s.q[2]));
      Jp[i][2] = sub(mul(d[0], s.q[1]), mul(d[1], s.q[0]));
#pragma unroll
      for (int j = 0; j < 3; ++j) Jp[i][3 + j] = -Jl[i][j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Jp[i][0] = sub(mul(c[i][2], s.p[1]), mul(c[i][1], s.p[2]));
      Jp[i][1] = sub(mul(c[i][0], s.p[2]), mul(c[i][2], s.p[0]));
      Jp[i][2] = sub(mul(c[i][1], s.p[0]), mul(c[i][0], s.p[1]));
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Jp[i][3 + j] = c[i][j];
        Jl[i][j] = dot3(c[i][0], R[j], c[i][1], R[3 + j], c[i][2], R[6 + j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 6; ++a) Jp[i][a] = mul(Jp[i][a], fr);
}

// E[a][b] = sum_i Jp[i][a] w Jl[i][b], from wJl = w Jl.
template <typename T>
__device__ __forceinline__ T cross_block(const T (&Jp)[3][6],
                                         const T (&wJl)[3][3], int a, int b) {
  return dot3(Jp[0][a], wJl[0][b], Jp[1][a], wJl[1][b], Jp[2][a], wJl[2][b]);
}

// Sums v over the block in a fixed order: a shuffle tree in each warp,
// then the warps in order.  The result is valid in thread 0.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N]) {
  constexpr int WARPS = THREADS / 32;
  __shared__ T sh[WARPS][N];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = add(v[i], __shfl_down_sync(0xffffffffu, v[i], off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) sh[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = sh[0][i];
      for (int w = 1; w < WARPS; ++w) s = add(s, sh[w][i]);
      v[i] = s;
    }
}

template <typename T, bool BODY>
__device__ __forceinline__ void by_pose(
    const T* cam, const T* __restrict__ rec, const int* __restrict__ pose_pos,
    const int* __restrict__ pose_off, const T* __restrict__ R_all,
    const T* __restrict__ t_all, const T* __restrict__ X_all,
    const T* __restrict__ lm_mask, const T* __restrict__ free_k,
    T* __restrict__ Hpp, T* __restrict__ bp, T* __restrict__ E, int huber) {
  // A warp's E rows pass through shared memory and leave as consecutive
  // words: a pose's observations are consecutive rows of E when the map
  // stores them pose by pose.
  __shared__ T stage[THREADS / 32][32 * 18];
  __shared__ int rows[THREADS / 32][32];
  const int k = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T R[9], t[3];
  load_pose(R, t, R_all, t_all, k);
  const T fr = __ldg(free_k + k);
  T s[27];                            // Hpp's upper triangle by rows, bp
#pragma unroll
  for (int i = 0; i < 27; ++i) s[i] = T(0);
  const int end = __ldg(pose_off + k + 1);
  // Thread i takes positions start + i, + THREADS, ...; a warp's lanes
  // step together so that they stage their rows together.
  for (int q0 = __ldg(pose_off + k) + warp * 32; q0 < end; q0 += THREADS) {
    const int q = q0 + lane;
    int obs = -1;
    if (q < end) {
      Rec<T> o;
      load_rec(o, rec, __ldg(pose_pos + q));
      obs = o.obs;
      const T X[3] = {__ldg(X_all + o.lm * 3), __ldg(X_all + o.lm * 3 + 1),
                      __ldg(X_all + o.lm * 3 + 2)};
      Obs<T> ob;
      residual<T, BODY>(ob, cam, R, t, X, o, __ldg(lm_mask + o.lm));
      T Jp[3][6], Jl[3][3];
      jacobians<T, BODY>(ob, cam, R, fr, Jp, Jl);
      const T w = weight(ob, o, huber);
      T wr[3], wJp[3][6], wJl[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wr[i] = mul(w, ob.r[i]);
#pragma unroll
        for (int a = 0; a < 6; ++a) wJp[i][a] = mul(w, Jp[i][a]);
#pragma unroll
        for (int b = 0; b < 3; ++b) wJl[i][b] = mul(w, Jl[i][b]);
      }
      int j = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b, ++j)
          s[j] = add(s[j], dot3(Jp[0][a], wJp[0][b], Jp[1][a], wJp[1][b],
                                Jp[2][a], wJp[2][b]));
#pragma unroll
      for (int a = 0; a < 6; ++a)
        s[21 + a] = add(s[21 + a], dot3(Jp[0][a], wr[0], Jp[1][a], wr[1],
                                        Jp[2][a], wr[2]));
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          stage[warp][lane * 18 + a * 3 + b] = cross_block(Jp, wJl, a, b);
    }
    rows[warp][lane] = obs;
    __syncwarp();
    for (int i = lane; i < 32 * 18; i += 32) {
      const int r = i / 18;
      const int row = rows[warp][r];
      if (row >= 0) __stcs(E + (size_t)row * 18 + (i - r * 18), stage[warp][i]);
    }
    __syncwarp();
  }
  block_sum<T, 27>(s);
  if (threadIdx.x == 0) {
    T* H = Hpp + (size_t)k * 36;
    int j = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b, ++j) {
        H[a * 6 + b] = s[j];
        H[b * 6 + a] = s[j];
      }
#pragma unroll
    for (int a = 0; a < 6; ++a) bp[k * 6 + a] = s[21 + a];
  }
}

template <typename T, bool BODY>
__device__ __forceinline__ void by_landmark(
    const T* cam, const T* __restrict__ rec, const int* __restrict__ lm_off,
    const T* __restrict__ R_all, const T* __restrict__ t_all,
    const T* __restrict__ X_all, const T* __restrict__ lm_mask,
    const T* __restrict__ free_k, T* __restrict__ Hll, T* __restrict__ bl,
    T* __restrict__ Ep, int K, int M, int O, int huber) {
  const int lane = threadIdx.x % G;
  const int m = (blockIdx.x - K) * LM_PER_BLOCK + threadIdx.x / G;
  if (m >= M) return;                 // the whole group
  const unsigned gmask = 0xffu << (threadIdx.x % 32 / G * G);
  const T X[3] = {__ldg(X_all + m * 3), __ldg(X_all + m * 3 + 1),
                  __ldg(X_all + m * 3 + 2)};
  const T lmk = __ldg(lm_mask + m);
  T s[9];                             // Hll 00 01 02 11 12 22, then bl
#pragma unroll
  for (int i = 0; i < 9; ++i) s[i] = T(0);
  const int end = __ldg(lm_off + m + 1);
  for (int n = __ldg(lm_off + m) + lane; n < end; n += G) {
    Rec<T> o;
    load_rec(o, rec, n);
    T R[9], t[3];
    load_pose(R, t, R_all, t_all, o.pose);
    Obs<T> ob;
    residual<T, BODY>(ob, cam, R, t, X, o, lmk);
    T Jp[3][6], Jl[3][3];
    jacobians<T, BODY>(ob, cam, R, __ldg(free_k + o.pose), Jp, Jl);
    const T w = weight(ob, o, huber);
    T wr[3], wJl[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      wr[i] = mul(w, ob.r[i]);
#pragma unroll
      for (int b = 0; b < 3; ++b) wJl[i][b] = mul(w, Jl[i][b]);
    }
    int j = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b, ++j)
        s[j] = add(s[j], dot3(Jl[0][a], wJl[0][b], Jl[1][a], wJl[1][b],
                              Jl[2][a], wJl[2][b]));
#pragma unroll
    for (int a = 0; a < 3; ++a)
      s[6 + a] = add(s[6 + a], dot3(Jl[0][a], wr[0], Jl[1][a], wr[1],
                                    Jl[2][a], wr[2]));
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        __stcs(Ep + (size_t)(a * 3 + b) * O + n, cross_block(Jp, wJl, a, b));
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 9; ++i)
      s[i] = add(s[i], __shfl_xor_sync(gmask, s[i], off, G));
  if (lane == 0) {
    T* H = Hll + (size_t)m * 9;
    H[0] = s[0]; H[1] = s[1]; H[2] = s[2];
    H[3] = s[1]; H[4] = s[3]; H[5] = s[4];
    H[6] = s[2]; H[7] = s[4]; H[8] = s[5];
#pragma unroll
    for (int a = 0; a < 3; ++a) bl[m * 3 + a] = s[6 + a];
  }
}

template <typename T, bool BODY>
__global__ void __launch_bounds__(THREADS, 3) reproj_linearize(
    const T* __restrict__ cam_g, const T* __restrict__ rec,
    const int* __restrict__ lm_off, const int* __restrict__ pose_pos,
    const int* __restrict__ pose_off, const T* __restrict__ R_all,
    const T* __restrict__ t_all, const T* __restrict__ X_all,
    const T* __restrict__ lm_mask, const T* __restrict__ free_k,
    T* __restrict__ Hpp, T* __restrict__ bp, T* __restrict__ Hll,
    T* __restrict__ bl, T* __restrict__ E, T* __restrict__ Ep, int K, int M,
    int O, int huber) {
  T cam[NCAM];
#pragma unroll
  for (int i = 0; i < NCAM; ++i) cam[i] = __ldg(cam_g + i);
  if ((int)blockIdx.x < K)
    by_pose<T, BODY>(cam, rec, pose_pos, pose_off, R_all, t_all, X_all,
                     lm_mask, free_k, Hpp, bp, E, huber);
  else
    by_landmark<T, BODY>(cam, rec, lm_off, R_all, t_all, X_all, lm_mask,
                         free_k, Hll, bl, Ep, K, M, O, huber);
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

// The cost over every observation position (the masked ones weigh 0), one
// a thread: the block's partial into part[block]; the last block sums the
// partials in index order into out[0].  chi2 (optional): each
// observation's chi2 in observation order.
template <typename T, bool BODY>
__global__ void __launch_bounds__(THREADS) reproj_cost(
    const T* __restrict__ cam_g, const T* __restrict__ rec,
    const T* __restrict__ R_all, const T* __restrict__ t_all,
    const T* __restrict__ X_all, const T* __restrict__ lm_mask,
    T* __restrict__ chi2, T* part, T* out, unsigned* counter, int O,
    int huber) {
  T c[1] = {T(0)};
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n < O) {
    T cam[NCAM];
#pragma unroll
    for (int i = 0; i < NCAM; ++i) cam[i] = __ldg(cam_g + i);
    Rec<T> o;
    load_rec(o, rec, n);
    T R[9], t[3];
    load_pose(R, t, R_all, t_all, o.pose);
    const T X[3] = {__ldg(X_all + o.lm * 3), __ldg(X_all + o.lm * 3 + 1),
                    __ldg(X_all + o.lm * 3 + 2)};
    Obs<T> ob;
    residual<T, BODY>(ob, cam, R, t, X, o, __ldg(lm_mask + o.lm));
    c[0] = cost_term(ob, huber);
    if (chi2 != nullptr) chi2[o.obs] = ob.chi2;
  }
  block_sum<T, 1>(c);
  if (threadIdx.x == 0) part[blockIdx.x] = c[0];
  if (!last_block(counter)) return;
  // Thread i sums a run of consecutive partials, then the block sums the
  // runs in order.
  const int nb = (int)gridDim.x;
  const int run = (nb + THREADS - 1) / THREADS;
  T s[1] = {T(0)};
  const int hi = min(nb, ((int)threadIdx.x + 1) * run);
  for (int i = threadIdx.x * run; i < hi; ++i) s[0] = add(s[0], __ldcg(part + i));
  block_sum<T, 1>(s);
  if (threadIdx.x == 0) {
    out[0] = s[0];
    *counter = 0u;
  }
}

template <typename T>
int linearize(const T* cam, const T* rec, const int* lm_off,
              const int* pose_pos, const int* pose_off, const T* R,
              const T* t, const T* X, const T* lm_mask, const T* free_k,
              T* Hpp, T* bp, T* Hll, T* bl, T* E, T* Ep, int K, int M, int O,
              int body, int huber, cudaStream_t stream) {
  if (K < 1 || M < 1 || O < 0) return (int)cudaErrorInvalidValue;
  const int grid = K + (M + LM_PER_BLOCK - 1) / LM_PER_BLOCK;
  if (body)
    reproj_linearize<T, true><<<grid, THREADS, 0, stream>>>(
        cam, rec, lm_off, pose_pos, pose_off, R, t, X, lm_mask, free_k, Hpp,
        bp, Hll, bl, E, Ep, K, M, O, huber);
  else
    reproj_linearize<T, false><<<grid, THREADS, 0, stream>>>(
        cam, rec, lm_off, pose_pos, pose_off, R, t, X, lm_mask, free_k, Hpp,
        bp, Hll, bl, E, Ep, K, M, O, huber);
  return (int)cudaGetLastError();
}

template <typename T>
int cost(const T* cam, const T* rec, const T* R, const T* t, const T* X,
         const T* lm_mask, T* chi2, T* part, T* out, unsigned* counter, int O,
         int body, int huber, cudaStream_t stream) {
  if (O < 0) return (int)cudaErrorInvalidValue;
  const int grid = O > 0 ? (O + THREADS - 1) / THREADS : 1;
  if (body)
    reproj_cost<T, true><<<grid, THREADS, 0, stream>>>(
        cam, rec, R, t, X, lm_mask, chi2, part, out, counter, O, huber);
  else
    reproj_cost<T, false><<<grid, THREADS, 0, stream>>>(
        cam, rec, R, t, X, lm_mask, chi2, part, out, counter, O, huber);
  return (int)cudaGetLastError();
}

}  // namespace

// cam (21) the camera block; rec (O, 8) the landmark-sorted records;
// lm_off (M+1), pose_pos (O), pose_off (K+1) of ops/cuda_schur.SchurIndex;
// R (K, 3, 3) and t (K, 3) the poses (R_cw, t_cw; with body: R_wb, p_wb);
// X (M, 3); lm_mask (M); free_k (K) 1 - fixed.  Writes Hpp (K, 6, 6), bp
// (K, 6), Hll (M, 3, 3), bl (M, 3), E (O, 6, 3) at the live observations
// and Ep (18, O) at the live positions.  Returns a cudaError_t.
extern "C" int reproj_linearize_f32(
    const float* cam, const float* rec, const int* lm_off, const int* pose_pos,
    const int* pose_off, const float* R, const float* t, const float* X,
    const float* lm_mask, const float* free_k, float* Hpp, float* bp,
    float* Hll, float* bl, float* E, float* Ep, int K, int M, int O, int body,
    int huber, void* stream) {
  return linearize<float>(cam, rec, lm_off, pose_pos, pose_off, R, t, X,
                          lm_mask, free_k, Hpp, bp, Hll, bl, E, Ep, K, M, O,
                          body, huber, (cudaStream_t)stream);
}

extern "C" int reproj_linearize_f64(
    const double* cam, const double* rec, const int* lm_off,
    const int* pose_pos, const int* pose_off, const double* R, const double* t,
    const double* X, const double* lm_mask, const double* free_k, double* Hpp,
    double* bp, double* Hll, double* bl, double* E, double* Ep, int K, int M,
    int O, int body, int huber, void* stream) {
  return linearize<double>(cam, rec, lm_off, pose_pos, pose_off, R, t, X,
                           lm_mask, free_k, Hpp, bp, Hll, bl, E, Ep, K, M, O,
                           body, huber, (cudaStream_t)stream);
}

// chi2 (O) or null; part (max(1, ceil(O / 256))) scratch; out (1) the
// cost; counter (1) zero, left zero.  Returns a cudaError_t.
extern "C" int reproj_cost_f32(const float* cam, const float* rec,
                               const float* R, const float* t, const float* X,
                               const float* lm_mask, float* chi2, float* part,
                               float* out, unsigned* counter, int O, int body,
                               int huber, void* stream) {
  return cost<float>(cam, rec, R, t, X, lm_mask, chi2, part, out, counter, O,
                     body, huber, (cudaStream_t)stream);
}

extern "C" int reproj_cost_f64(const double* cam, const double* rec,
                               const double* R, const double* t,
                               const double* X, const double* lm_mask,
                               double* chi2, double* part, double* out,
                               unsigned* counter, int O, int body, int huber,
                               void* stream) {
  return cost<double>(cam, rec, R, t, X, lm_mask, chi2, part, out, counter, O,
                      body, huber, (cudaStream_t)stream);
}
