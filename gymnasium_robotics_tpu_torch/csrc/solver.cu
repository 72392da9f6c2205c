// Per-env dense solves of the constraint pipeline.
//
// chol_solve_kernel<2> (one env per thread) and chol_tile_kernel<NV,
//   COL_BACK> (GRT_CHOL_TILES: NV = 3, 4, 5, 6, 9, 11, 14, 15, 18, 21, 23, 24,
//   29, 30, 33, 36; a tile of 16 envs a block, 8 past NV = 32, a half-warp
//   or a warp an env, below) replace the TPU kernel
//   gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel_chol (entered
//   through solve_pos_soa): the batched SPD solve M x = b by an unrolled
//   LL^T with the diagonal floored at sqrt(max(s, 1e-20)).
// newton2_kernel<G, CHOL> (NV = 2; a group of G lanes an env, below) and
// newton_tile_kernel<NV, WPE, RPL, ET> (GRT_NEWTON_TILES: NV = 3, 4, 5, 6,
//   9, 11, 14 (two row caps), 15, 18, 21, 23, 24, 29, 30, 33, 36; a tile of
//   ET = 8 envs a block up to NV = 21 and 4 from NV = 23 on, one warp an
//   env up to NV = 14, two at 15, 18 and 21, three from 23 on, below) replace
//   the TPU kernel gymnasium_robotics_tpu/physics/solver_pallas.py::
//   _kernel_nv (entered through solve_small_soa): the warm-started primal
//   Newton solve of the soft-constraint problem with exact line search.
//   newton2_kernel<G, false> also replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel (entered
//   through _solve_block / solve_small_nv2): the same Newton solve at
//   nv = 2 with each 2x2 system solved in closed form, by determinant.
//
// Layout. The kernels read the port's own batch-last arrays where they lie,
// through their element strides, so the caller copies nothing: M is the
// full (NV, NV, B) matrix, read on and below the diagonal (the nv = 2
// determinant route reads (0, 1) for (1, 0), as its TPU kernel); J is
// (ne, NV, B); active and is_eq are (ne, B) bool (is_eq has batch stride 0
// when it is one flag per model row). Where the batch stride is 1 the 32
// threads of a warp read one row as 128 contiguous bytes (the counterpart
// of the TPU kernels' 128-lane blocks). Outputs are written contiguous,
// element (r, b) at r * B + b. There is no padding: the ragged edge is
// masked.
//
// What bounds them. At the PointMaze shapes (NV = 2, ne = 19, 6 Newton and
// 4 line-search iterations, B = 8192) neither has enough work to fill the
// card. The Cholesky kernel moves 7 floats per env (0.23 MB, 0.07 us at
// the H100's 3.35 TB/s), so the launch itself bounds it. The Newton
// function reads 102 floats and 19 mask bytes and writes 21 floats per env
// (3.56 MB, 1.06 us) and does about 9.0k float operations per env (1.10 us
// at 67 TFLOP/s float32); newton2_kernel's note below says how its design
// spreads that over the card. NV is a template parameter of the larger
// kernels so every loop over it unrolls into registers, as Pallas unrolls
// them; ne, n_iter and n_ls are runtime values. chip_smoke.py measures
// each kernel against these bounds.
// At the AntMaze shapes (NV = 14, ne = 72, 5 Newton and 4 line-search
// iterations, B = 2048) the Newton function reads 1285 floats and 72 mask
// bytes and writes 86 floats per env (11.2 MB, 3.4 us) and does about 148k
// float operations per env (4.5 us at 67 TFLOP/s float32), so operations
// bound it (chip_smoke.py counts both); one thread per env would need far
// more than 255 registers, hence newton_tile_kernel, which spreads each
// env over a warp or two and keeps J in shared memory (its note below).
// At the FetchPush shapes (NV = 21, ne = 255, 4 and 4 iterations,
// B = 2048) the Newton function reads 6393 floats and 255 mask bytes and
// writes 276 floats per env (54.8 MB, 16 us) and does about 0.74M float
// operations per env (22 us), so operations bound it, bytes close behind.
// The Cholesky solve at NV = 14 and 21 moves 133 and 273 floats an env
// (1.1 and 2.2 MB) and does 1.4k and 4.2k operations an env: neither rate
// bounds it, the chain of each env does (chol_tile_kernel's note below).
// At the HandManipulateBlock shapes (NV = 36, ne = 272, 5 and 4
// iterations, B = 1024) the Newton function reads 11.7k floats and 272
// mask bytes and writes 308 floats an env (49 MB, 15 us) and does about
// 2.4M float operations an env (37 us), so operations bound it; the
// Cholesky moves 1368 floats an env (5.6 MB, 1.7 us) and does 19k
// operations an env (0.29 us): its chain bounds it. The Adroit hands run
// the same shape at NV = 30 (door, pen; 278 and 272 rows) and NV = 33
// (hammer, 275 rows): three warps an env over the 288-row cap, one of the
// 55 or 66 3x3 blocks of H a lane, and a lane holding two rows of the
// Cholesky past NV = 32. HandReach (NV = 24, 272 rows: the Block hand's
// 24 joint limits, 88 tendon-limit rows and 16 + 16 capped contacts) and
// the Franka Kitchen (NV = 29, 188 rows: 5 joint equalities, 23 joint
// limits, 8 contacts each of condim 3, 4 and 6; 8 Newton iterations) run
// it too: 272 rows need the 288-row cap, and at NV = 29 a tile of eight
// envs or of two warps an env over 256 rows would pass the 227 KB of
// shared memory a block, so both keep NV = 30's three warps and 4 envs.
// The locomotion models run it at NV = 3 (the double pendulum, 1 row), 4
// (Reacher, 3), 5 (Swimmer, 2), 6 (Hopper, 38), 9 (HalfCheetah and
// Walker2d, 70 and 62), 11 (Pusher, 22), 14 (Ant, 108: past AntMaze's
// 96-row cap, hence a second instantiation at 128 rows; AntMaze keeps
// <14, 1, 3, 8>) and 23 (the humanoids, 244): each the smallest shape of
// one warp an env (three at NV = 23, as at 24) whose rows hold the
// model's. At NV <= 6 one warp an env leaves most lanes idle over 1-38
// rows; the design is kept for them for now. MaMuJoCo's CoupledHalfCheetah
// (NV = 18, 142 rows: two HalfCheetahs' 12 joint limits and 2 x 16
// plane-capsule slots of 4 rows, and the spatial tendon's two limit rows)
// runs two warps an env as NV = 15 and 21 do, three rows a lane (a
// 192-row cap): its 21 3x3 blocks of H leave 11 lanes of each warp idle
// over the rows, one row slice a warp, so the two warps halve the
// stream over the rows; 17.9 KB of shared memory an env, one 8-env block
// an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsolver.so solver.cu
// Each entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused), or -1 for an
// nv or ne with no instantiation or too little shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Element strides of a batch-last operand: (row, batch) or
// (row, column, batch).
struct Str2 {
  long long r, b;
  __device__ long long at(int i, int e) const { return i * r + e * b; }
};
struct Str3 {
  long long r, c, b;
  __device__ long long at(int i, int j, int e) const {
    return i * r + j * c + e * b;
  }
};
struct NewtonStrides {
  Str3 M;
  Str2 a_smooth, a_warm;
  Str3 J;
  Str2 aref, D, active, is_eq;
};

// max that propagates NaN like jnp.maximum / torch.clamp (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The lower triangle of one env's (NV, NV) matrix, packed in row order
// (i, j <= i) as solver_pallas._pack_tril_soa.
template <int NV>
__device__ __forceinline__ void load_tril(const float* __restrict__ M,
                                          Str3 s, int e,
                                          float (&H)[tri(NV, 0)]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) H[tri(i, j)] = M[s.at(i, j, e)];
}

// Solve H x = rhs for one env; H packed lower triangle, factored in place
// (left-looking: every sum runs over k in ascending order, as the plain
// version's).
template <int NV>
__device__ __forceinline__ void chol_solve(float (&L)[tri(NV, 0)],
                                           const float (&rhs)[NV],
                                           float (&x)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = L[tri(i, i)];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * L[tri(i, k)];
    L[tri(i, i)] = sqrtf(nan_max(s, 1e-20f));
#pragma unroll
    for (int j = i + 1; j < NV; ++j) {
      float t = L[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) t = t - L[tri(j, k)] * L[tri(i, k)];
      L[tri(j, i)] = t / L[tri(i, i)];
    }
  }
  float y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NV; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

// NV = 2: one env per thread (at 7 floats an env the launch bounds it).
template <int NV>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ M, Str3 sM,
                  const float* __restrict__ b, Str2 sb,
                  float* __restrict__ x, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t sB = (size_t)B;
  float H[tri(NV, 0)], rhs[NV], out[NV];
  load_tril<NV>(M, sM, e, H);
#pragma unroll
  for (int i = 0; i < NV; ++i) rhs[i] = b[sb.at(i, e)];
  chol_solve<NV>(H, rhs, out);
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i * sB + e] = out[i];
}

// ---------------------------------------------------------------------------
// newton2_kernel<G, CHOL>: the nv = 2 Newton solve of both routes, one
// template. CHOL picks the 2x2 solve, and with it each route's own
// arithmetic:
// - CHOL = true, the batched route (solve_newton at nv = 2), as
//   solver_pallas._kernel_nv computes it: M read on and below the
//   diagonal; x = -aref + J a; the gradient -(M da + J^T Dw x) and
//   H = M + J^T diag(Dw) J from packed rows; the step by the floored
//   Cholesky (chol_solve<2>); qacc = a_smooth + M^-1 J^T f by the same.
// - CHOL = false, the per-env route (solve_newton_nv2: the single env), as
//   solver_pallas._kernel computes it: M read at (0,0), (0,1) and (1,1),
//   as the TPU kernel's M3 rows; x = J0 a0 + J1 a1 - aref; the gradient and
//   the Hessian entries h00, h01, h11 written out; the step and the final
//   M solve by determinant.
// Both then take n_ls exact line-search steps on the piecewise-quadratic
// 1-D restriction (ddphi floored at 1e-12), clip alpha to [0, 4] (NaN
// carried), and compute the forces on the final active set with
// unilateral rows clamped at 0.
//
// What bounds it. At B = 8192, 6 Newton and 4 line-search iterations, the
// function reads 83 floats and 19 mask bytes and writes 21 floats an env
// at the U-maze's 19 rows (3.6 MB, 1.1 us at 3.35 TB/s; ~9k operations an
// env, 1.1 us at 67 TFLOP/s float32), and at the Medium and Large mazes'
// 39 and 63 rows about twice and three times that. One thread an env made
// it 8192 threads, two warps an SM: its time was the latency of each
// thread's chain over all of its rows, with J read from memory twice an
// iteration, and at 64 rows the per-row register arrays spilled.
//
// Layout and design. A group of G consecutive lanes takes one env (G = 4
// up to 32 rows, G = 8 up to 64: 1024 and 2048 warps at B = 8192), lane j
// of the group rows j, j + G, ..., kNv2Rows of them. Each lane loads its
// rows' J (2 floats), aref, weight (active ? D : 0) and equality flag once
// a call into registers, and keeps their x and J p there. Each iteration's
// five row sums (the gradient's two, H's three) and each line-search
// step's two are summed over the lane's rows in order (rows past ne
// dropped by select, not branch) and then over the group by
// __shfl_xor_sync butterflies: partners add the same two values,
// so every lane ends with the same bits, solves the 2x2 system itself and
// carries the same a; nothing is broadcast. Loads are per row: with batch
// stride 1, the 32 / G envs of a warp read each row as 32 / G contiguous
// floats. Lanes past B compute env B - 1's rows and store nothing.
// Against the one-thread-an-env kernels this replaced, only the order of
// the row sums differs (each lane's rows, then the butterfly).
// Measured on the H100 against the alternatives (PERF.md §6): lane = env
// across a warp, the warps of a block on row slices and the sums through
// shared memory, loads fully coalesced, was slower at 19 and 63 rows on
// both routes: its loads happen once a call, its barriers at every sum.
// Dead rows skipped by branches (a convergence barrier a row) were slower
// than the selects, and pairwise row sums slower than the in-order ones
// (and spilled). What remains is latency: each line-search step waits on
// its sums' shuffles and an IEEE division, each Cholesky-route step on a
// chain of two square roots and four divisions.
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNv2Rows = 8;        // newton2_kernel: rows a lane
constexpr int kNv2Threads = 128;   // newton2_kernel: threads a block

// The sum of v over an aligned group of G lanes, the same bits on each.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int G, bool CHOL>
__global__ void __launch_bounds__(kNv2Threads)
newton2_kernel(const float* __restrict__ M, const float* __restrict__ a_smooth,
               const float* __restrict__ a_warm, const float* __restrict__ J,
               const float* __restrict__ aref, const float* __restrict__ D,
               const unsigned char* __restrict__ active,
               const unsigned char* __restrict__ is_eq, NewtonStrides s,
               float* __restrict__ qacc, float* __restrict__ f, int ne, int B,
               int n_iter, int n_ls) {
  constexpr int R = kNv2Rows;
  const int t = blockIdx.x * kNv2Threads + threadIdx.x;
  const int e = t / G, j = t % G;
  const bool valid = e < B;
  const int ec = valid ? e : B - 1;
  const size_t sB = (size_t)B;
  const float m00 = M[s.M.at(0, 0, ec)], m11 = M[s.M.at(1, 1, ec)];
  const float m01 = CHOL ? M[s.M.at(1, 0, ec)] : M[s.M.at(0, 1, ec)];
  const float as0 = a_smooth[s.a_smooth.at(0, ec)];
  const float as1 = a_smooth[s.a_smooth.at(1, ec)];
  float a0 = a_warm[s.a_warm.at(0, ec)], a1 = a_warm[s.a_warm.at(1, ec)];

  // this lane's rows r = j + G i: J, aref, weight, equality flag; x, J p.
  // Rows past ne load row 0 (every load issued at once, no branch) and
  // are dropped by selects below, so each sum takes the live rows only.
  float j0[R], j1[R], ar[R], w[R], x[R], Jp[R];
  bool eq[R], live[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = j + G * i;
    live[i] = r < ne;
    const int rr = live[i] ? r : 0;
    float vj0 = 0.f, vj1 = 0.f, va = 0.f, vd = 0.f;
    bool act = false, veq = false;
    if (ne > 0) {
      vj0 = J[s.J.at(rr, 0, ec)];
      vj1 = J[s.J.at(rr, 1, ec)];
      va = aref[s.aref.at(rr, ec)];
      vd = D[s.D.at(rr, ec)];
      act = active[s.active.at(rr, ec)] != 0;
      veq = is_eq[s.is_eq.at(rr, ec)] != 0;
    }
    j0[i] = live[i] ? vj0 : 0.f;
    j1[i] = live[i] ? vj1 : 0.f;
    ar[i] = live[i] ? va : 0.f;
    w[i] = live[i] && act ? vd : 0.f;
    eq[i] = live[i] && veq;
    x[i] = Jp[i] = 0.f;
  }
  // s + v on a live row, s on a dead one
  auto add = [&](int i, float acc, float v) { return live[i] ? acc + v : acc; };
  // D on the active set at x: equality rows always, the others where x < 0
  auto dw_of = [&](int i, float xr) { return (eq[i] || xr < 0.f) ? w[i] : 0.f; };
  auto x_of = [&](int i) {
    if (CHOL) {
      float xr = -ar[i];
      xr += j0[i] * a0;
      xr += j1[i] * a1;
      return xr;
    }
    return j0[i] * a0 + j1[i] * a1 - ar[i];
  };

  for (int it = 0; it < n_iter; ++it) {
    float g0 = 0.f, g1 = 0.f, s00 = 0.f, s01 = 0.f, s11 = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float xr = x_of(i);
      x[i] = xr;
      const float Dw = dw_of(i, xr);
      const float gx = Dw * xr;
      g0 = add(i, g0, j0[i] * gx);
      g1 = add(i, g1, j1[i] * gx);
      if (CHOL) {
        const float DJ0 = Dw * j0[i], DJ1 = Dw * j1[i];
        s00 = add(i, s00, DJ0 * j0[i]);
        s01 = add(i, s01, DJ1 * j0[i]);
        s11 = add(i, s11, DJ1 * j1[i]);
      } else {
        s00 = add(i, s00, Dw * j0[i] * j0[i]);
        s01 = add(i, s01, Dw * j0[i] * j1[i]);
        s11 = add(i, s11, Dw * j1[i] * j1[i]);
      }
    }
    g0 = group_sum<G>(g0);
    g1 = group_sum<G>(g1);
    s00 = group_sum<G>(s00);
    s01 = group_sum<G>(s01);
    s11 = group_sum<G>(s11);
    const float da0 = a0 - as0, da1 = a1 - as1;
    float p0, p1, pMp, pMa;
    if (CHOL) {
      float Mp[3] = {m00, m01, m11};
      const float Mda[2] = {m00 * da0 + m01 * da1, m01 * da0 + m11 * da1};
      float H[3] = {Mp[0] + s00, Mp[1] + s01, Mp[2] + s11};
      const float mgrad[2] = {-(Mda[0] + g0), -(Mda[1] + g1)};
      float p[2];
      chol_solve<2>(H, mgrad, p);
      p0 = p[0];
      p1 = p[1];
      const float Mpv0 = m00 * p0 + m01 * p1, Mpv1 = m01 * p0 + m11 * p1;
      pMp = p0 * Mpv0 + p1 * Mpv1;
      pMa = p0 * Mda[0] + p1 * Mda[1];
    } else {
      const float grad0 = m00 * da0 + m01 * da1 + g0;
      const float grad1 = m01 * da0 + m11 * da1 + g1;
      const float h00 = m00 + s00, h01 = m01 + s01, h11 = m11 + s11;
      const float det = h00 * h11 - h01 * h01;
      p0 = -(h11 * grad0 - h01 * grad1) / det;
      p1 = -(-h01 * grad0 + h00 * grad1) / det;
      pMp = p0 * (m00 * p0 + m01 * p1) + p1 * (m01 * p0 + m11 * p1);
      pMa = p0 * (m00 * da0 + m01 * da1) + p1 * (m01 * da0 + m11 * da1);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) Jp[i] = j0[i] * p0 + j1[i] * p1;

    // exact line search on the piecewise-quadratic 1-D restriction
    float alpha = 1.f;
    for (int l = 0; l < n_ls; ++l) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x2 = x[i] + alpha * Jp[i];
        const float Dw2 = dw_of(i, x2);
        s1 = add(i, s1, Dw2 * x2 * Jp[i]);
        s2 = add(i, s2, Dw2 * Jp[i] * Jp[i]);
      }
      s1 = group_sum<G>(s1);
      s2 = group_sum<G>(s2);
      const float dphi = alpha * pMp + pMa + s1;
      const float ddphi = pMp + s2;
      alpha = alpha - dphi / nan_max(ddphi, 1e-12f);
    }
    alpha = alpha < 0.f ? 0.f : (alpha > 4.f ? 4.f : alpha);
    a0 += alpha * p0;
    a1 += alpha * p1;
  }

  // forces on the final active set; unilateral rows pushed to f >= 0
  float qfc0 = 0.f, qfc1 = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float xr = CHOL ? (j0[i] * a0 + j1[i] * a1) - ar[i] : x_of(i);
    float fr = -dw_of(i, xr) * xr;
    if (!eq[i]) fr = nan_max(fr, 0.f);
    if (valid && live[i]) f[(j + G * i) * sB + e] = fr;
    qfc0 = add(i, qfc0, j0[i] * fr);
    qfc1 = add(i, qfc1, j1[i] * fr);
  }
  qfc0 = group_sum<G>(qfc0);
  qfc1 = group_sum<G>(qfc1);
  float q0, q1;
  if (CHOL) {
    float Mp[3] = {m00, m01, m11};
    const float qfc[2] = {qfc0, qfc1};
    float dq[2];
    chol_solve<2>(Mp, qfc, dq);
    q0 = as0 + dq[0];
    q1 = as1 + dq[1];
  } else {
    const float detM = m00 * m11 - m01 * m01;
    q0 = as0 + (m11 * qfc0 - m01 * qfc1) / detM;
    q1 = as1 + (-m01 * qfc0 + m00 * qfc1) / detM;
  }
  if (valid && j == 0) {
    qacc[e] = q0;
    qacc[sB + e] = q1;
  }
}

// Lanes an env of newton2_kernel at ne rows: 4 up to 32 rows, 8 up to 64;
// 0 past that (physics/solver.py::newton2_geometry).
constexpr int nv2_lanes(int ne) { return ne <= 4 * kNv2Rows ? 4 : ne <= 8 * kNv2Rows ? 8 : 0; }

template <bool CHOL>
int launch_newton2(const float* M, const float* a_smooth, const float* a_warm,
                   const float* J, const float* aref, const float* D,
                   const unsigned char* active, const unsigned char* is_eq,
                   const NewtonStrides& st, float* qacc, float* f, int ne,
                   int B, int n_iter, int n_ls, cudaStream_t s) {
  const int G = nv2_lanes(ne);
  const long long threads = static_cast<long long>(B) * G;
  const dim3 grid(static_cast<unsigned>((threads + kNv2Threads - 1) / kNv2Threads));
  if (G == 4)
    newton2_kernel<4, CHOL><<<grid, kNv2Threads, 0, s>>>(
        M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
        n_iter, n_ls);
  else if (G == 8)
    newton2_kernel<8, CHOL><<<grid, kNv2Threads, 0, s>>>(
        M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
        n_iter, n_ls);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// newton_tile_kernel<NV, WPE, RPL, ET>: the Newton solve for the larger
// systems (AntMaze: NV = 14, ne = 72 of a 96-row cap; FetchReach: NV = 15,
// ne = 255 of 256, in NV = 21's shape (two warps an env, four rows a lane),
// its 15 blocks of H two row slices a warp and no zero column; FetchPush
// and FetchSlide: NV = 21, ne = 255 of 256; HandManipulateBlock: NV = 36,
// ne = 272 of 288), a block a tile of ET consecutive envs, WPE warps an
// env.
//
// What bounds it on this card. Per env and iteration the function forms
// H = M + J^T diag(Dw) J over every row (59k multiply-adds at NV = 21, 255
// rows; 7.6k at NV = 14, 72 rows), three row products (x, J p, and J^T of a
// row vector) and an NV x NV Cholesky; J itself (21.4 KB an env at
// NV = 21) is read once per call. The operation bound is 22 us at
// FetchPush's shapes, the byte bound 16 us. Held in every lane of a warp,
// the NV-vectors alone would take ~8 NV registers a lane; read one env at
// a time at batch stride, J would cost a sector per element; built entry
// by entry, H would cost three shared loads per multiply-add.
//
// What this design does about it:
// - Staging: consecutive threads take consecutive envs of the tile, so with
//   batch stride 1 each 8-env run of an element is one full 32-byte
//   sector. Where the batch stride is 1 and the rows are 16-byte aligned a
//   thread loads an element of 4 envs at once (LDG.128, 4 in flight) and
//   stores it into the 4 envs' regions; other views (strides, B % 4 != 0)
//   take a 4-byte cp.async an element. J is kept transposed, J^T with its
//   columns contiguous over rows (NECP = NEC + 4 floats apart, 4 mod 32),
//   for every iteration; M's lower triangle, a_warm, a_smooth, each row's
//   weight (active ? D : 0), aref and equality flag are staged alike (the
//   equality flags' batch stride 0 included).
// - H by 3x3 register blocks: each lane owns one 3x3 block of the lower
//   triangle (28 blocks at NV = 21, 15 at NV = 14; a zero column stands in
//   past NV) and streams the rows four at a time: one float4 load a column
//   brings 4 rows (the 7 columns a warp asks at once lie in distinct banks),
//   two bring the 4 rows' (Dw, Dw x), for 36 multiply-adds of H and 12 of
//   the gradient J^T (Dw x) (kept by the diagonal blocks). The rows are
//   split in interleaved slices of four, one per warp at NV = 21 (WPE = 2)
//   and one per half-warp at NV = 14 (WPE = 1); the slices' sums are added
//   by shuffle within a warp and through shared memory across warps.
// - Rows over lanes: each of the env's 32 WPE lanes owns RPL rows (row
//   u + 32 WPE q) and keeps their weight, aref, x, J p and equality flag in
//   registers for x, the line search and the forces.
// - Vectors held once: a, a_smooth, p, the gradient and M (a - a_smooth)
//   live in shared memory, one component per lane where computed; the
//   Cholesky solve (warp_chol_solve<NV>, below) takes and returns
//   one component a lane, keeps each lane's row in registers and
//   substitutes with reciprocals. No NV-array is replicated in registers.
// - Outputs go through shared memory and are written coalesced.
// - NV = 36 (WPE = 3, RPL = 3, ET = 4): its 78 blocks of H outnumber a
//   warp's lanes, so each of the env's first 78 lanes owns one block and
//   streams every row (one slice, no cross-lane sums), the env's warps
//   meeting at a barrier before the lead warp reads H; each lane of the
//   lead warp holds two components of every vector (i and i + 32) and two
//   rows in warp_chol_solve; a tile of 4 envs keeps the block's shared
//   memory under the SM's 227 KB.
// Shared memory per env: (NJC NECP + 2 NEC + 2 NT + 5 VW + 16 + NEC / 4)
// floats (NEC = 32 WPE RPL rows, NJC = NV, or NV + 1 with the zero column,
// NT = NV (NV + 1) / 2, VW = 32 or 64 floats a vector), padded to 4 mod 32 so the staging stores spread
// over the banks: 26.8 KB at NV = 21 (214 KB a block, one block an SM),
// 19.1 KB at NV = 15 (153 KB a block, one an SM),
// 8.5 KB at NV = 14 (67.7 KB a block, two an SM), 50.1 KB at NV = 36
// (200.6 KB a block of 4, one an SM). What bounds it then is
// latency: one block of 8 envs takes about as long alone as in a full
// wave, and NV = 21 runs two waves of 132 blocks, each a chain of staging,
// n_iter x (rows, H, Cholesky, line search) and the forces.
// The semantics are the TPU kernel's: the 1e-20 Cholesky floor, ddphi
// floored at 1e-12, alpha clipped to [0, 4], NaN carried through nan_max,
// and every row computed every iteration; only the order of some sums
// (the slices of H, the warp sums, J^T f) and the substitutions'
// reciprocals differ from the plain version.
// ---------------------------------------------------------------------------

constexpr int BS = 3;         // newton_tile_kernel: side of a lane's block of H

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// cp.async of 4 bytes into shared memory; the host pass (which never runs
// a kernel) sees a plain copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}
// bar.sync on named barrier id for n threads (whole warps): the warps of
// one env wait for each other only. The host pass sees __syncthreads.
__device__ __forceinline__ void bar_sync(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#else
  __syncthreads();
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Rows (or vector components) a lane of warp_chol_solve and of
// newton_tile_kernel's vectors: lane l owns l, l + 32, ...
template <int NV>
__host__ __device__ constexpr int lane_rows() { return (NV + 31) / 32; }

// Solve H x = rhs with H's packed lower triangle in shared memory (factored
// in place); lane l holds rhs_i and gets x_i for i = l + 32 q (q < R, rows
// past NV: 0). Left-looking factor with the same 1e-20 diagonal floor and
// the same order of every sum as chol_solve, lane l keeping its rows of H
// and of the factor as they are made in registers, so each product of a
// pivot's sum loads only the pivot row's entry (one broadcast). Each
// substitution step multiplies by the reciprocal of the diagonal, which the
// row's lane keeps from the factor, instead of dividing by it, so the chain
// of the two substitutions holds no division; the back substitution
// subtracts in descending order. R = 2 (NV = 36) doubles each lane's work
// per pivot, not the pivots.
template <int NV>
__device__ void warp_chol_solve(float* L, const float (&rhs)[lane_rows<NV>()],
                                float (&x)[lane_rows<NV>()], int lane) {
  constexpr int R = lane_rows<NV>();
  float inv[R];       // 1 / L_ii on the lane of row i
  float row[R][NV];   // H's rows, then L_j,k as each pivot k makes it
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = lane + 32 * q < NV ? lane + 32 * q : NV - 1;
    inv[q] = 0.f;
#pragma unroll
    for (int m = 0; m < NV; ++m) row[q][m] = m <= j ? L[tri(j, m)] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      t[q] = row[q][i];
#pragma unroll
      for (int k = 0; k < i; ++k) t[q] = t[q] - row[q][k] * L[tri(i, k)];
    }
    const float dii =
        sqrtf(nan_max(__shfl_sync(kFull, t[i / 32], i % 32), 1e-20f));
    const float rc = 1.f / dii;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = lane + 32 * q;
      const float v = t[q] / dii;
      // one predicated store a row: the diagonal on row i, L_j,i below
      if (j >= i && j < NV) L[tri(j, i)] = j == i ? dii : v;
      inv[q] = j == i ? rc : inv[q];
      row[q][i] = v;
    }
    __syncwarp();
  }
  float r[R], y[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    r[q] = lane + 32 * q < NV ? rhs[q] : 0.f;
    y[q] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float yi = __shfl_sync(kFull, r[i / 32] * inv[i / 32], i % 32);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = lane + 32 * q;
      if (j == i) y[q] = yi;
      if (j > i && j < NV) r[q] = r[q] - L[tri(j, i)] * yi;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    r[q] = y[q];
    x[q] = 0.f;
  }
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    const float xi = __shfl_sync(kFull, r[i / 32] * inv[i / 32], i % 32);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = lane + 32 * q;
      if (j == i) x[q] = xi;
      if (j < i) r[q] = r[q] - L[tri(i, j)] * xi;
    }
  }
  __syncwarp();
}

// One env's region of newton_tile_kernel's shared memory, in floats, and
// the block's bytes at ET envs a tile. physics/solver.py::newton_geometry
// computes the same.
template <int NV, int WPE, int RPL, int ET>
struct TileLayout {
  static constexpr int NB = (NV + BS - 1) / BS, NT = tri(NV, 0);
  static constexpr int NJC = NB * BS > NV ? NV + 1 : NV;  // + a zero column
  static constexpr int LPE = 32 * WPE, NEC = LPE * RPL;
  static constexpr int NECP = NEC + 4;         // column stride, 4 mod 32
  static constexpr int VW = 32 * lane_rows<NV>();  // a vector's floats
  static constexpr int J = 0;                  // J^T: (NJC, NECP)
  static constexpr int DG = J + NJC * NECP;    // (NEC) float2: Dw, Dw x
  static constexpr int M = DG + 2 * NEC;       // packed lower triangle
  static constexpr int L = M + NT;             // H, factored in place
  static constexpr int V = L + NT;             // a, a_smooth, p, g, M da
  static constexpr int S = V + 5 * VW;         // p'Mp, p'M da, ls sums
  static constexpr int EQ = S + 16;            // NEC equality bytes
  static constexpr int used = EQ + NEC / 4;
  static constexpr int total = used + (36 - used % 32) % 32;  // 4 mod 32
  static constexpr int block_bytes = total * 4 * ET;
  static_assert(NEC % 32 == 0 && NECP % 32 == 4 && DG % 4 == 0 &&
                    lane_rows<NV>() <= 2 && (ET == 4 || ET == 8) &&
                    2 + 4 * WPE <= 16,
                "layout");
};

template <int NV, int WPE, int RPL, int ET>
__global__ void __launch_bounds__(ET * WPE * 32, WPE == 1 ? 2 : 1)
newton_tile_kernel(const float* __restrict__ M,
                   const float* __restrict__ a_smooth,
                   const float* __restrict__ a_warm,
                   const float* __restrict__ J, const float* __restrict__ aref,
                   const float* __restrict__ D,
                   const unsigned char* __restrict__ active,
                   const unsigned char* __restrict__ is_eq, NewtonStrides s,
                   float* __restrict__ qacc, float* __restrict__ f, int ne,
                   int B, int n_iter, int n_ls) {
  using TL = TileLayout<NV, WPE, RPL, ET>;
  constexpr int NT = TL::NT, LPE = TL::LPE, NEC = TL::NEC, NECP = TL::NECP;
  constexpr int R = lane_rows<NV>(), VW = TL::VW;
  constexpr int NBLK = TL::NB * (TL::NB + 1) / 2;  // BS x BS blocks of H
  // the blocks over a warp's lanes, SPW row slices a warp; or, past 32
  // blocks (NV = 36: 78), over the env's lanes, each over every row
  constexpr bool SPAN = NBLK > 32;
  constexpr int SPW = SPAN ? 1 : 32 / NBLK;        // row slices a warp
  constexpr int NSL = SPAN ? 1 : SPW * WPE;        // row slices an env
  static_assert(SPAN ? NBLK <= LPE : SPW >= 1, "one block a lane");
  extern __shared__ __align__(16) float tsm[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int u = tid % LPE, lane = tid & 31;
  const bool lead = u < 32;   // the env's first warp: Cholesky and vectors
  const int b0 = blockIdx.x * ET;
  const size_t sB = (size_t)B;
  float* base = tsm + (tid / LPE) * TL::total;
  const float* Js = base + TL::J;     // J^T: J[r][k] at Js[k * NECP + r]
  float2* DG = reinterpret_cast<float2*>(base + TL::DG);
  const float* Ms = base + TL::M;
  float* Ls = base + TL::L;
  float* A = base + TL::V;
  const float* AS = A + VW;
  float* P = A + 2 * VW;
  float* G = A + 3 * VW;
  float* MDA = A + 4 * VW;
  float* S = base + TL::S;
  // the env's warps wait for each other (named barrier 1 + env), so the
  // envs of a block do not run their phases in lockstep
  const int env_bar = 1 + tid / LPE;
  auto env_sync = [&] {
    if constexpr (WPE == 1) __syncwarp();
    else bar_sync(env_bar, LPE);
  };
  auto msym = [&](int i, int j) { return Ms[j <= i ? tri(i, j) : tri(j, i)]; };

  // --- staging: consecutive threads take consecutive envs of the tile.
  // J^T: rows past ne, the zero column and envs past B as 0. Where the
  // batch stride is 1 and every 4-env run is 16-byte aligned, a thread
  // loads 4 envs' entry at once (LDG.128, U in flight) and stores it into
  // the 4 envs' regions; otherwise a 4-byte cp.async an element.
  const bool vec4 = s.J.b == 1 && s.J.r % 4 == 0 && s.J.c % 4 == 0 &&
                    B % 4 == 0 && (reinterpret_cast<size_t>(J) & 15) == 0;
  if (vec4) {
    constexpr int U = 4;
    constexpr int Q4 = ET / 4, SH = Q4 == 2 ? 1 : 0;   // 4-env runs a tile
    constexpr int N4 = Q4 * NEC * TL::NJC;   // (4-env run, row, column)
    for (int i0 = tid; i0 < N4; i0 += U * nthr) {
      float4 v[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int idx = i0 + q * nthr, t = 4 * (idx & (Q4 - 1));
        const int r = (idx >> SH) % NEC, k = (idx >> SH) / NEC, b = b0 + t;
        v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < N4 && r < ne && k < NV && b < B)
          v[q] = __ldg(reinterpret_cast<const float4*>(J + s.J.at(r, k, b)));
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int idx = i0 + q * nthr, t = 4 * (idx & (Q4 - 1));
        const int r = (idx >> SH) % NEC, k = (idx >> SH) / NEC;
        if (idx < N4) {
          float* d = tsm + t * TL::total + TL::J + k * NECP + r;
          d[0] = v[q].x;
          d[TL::total] = v[q].y;
          d[2 * TL::total] = v[q].z;
          d[3 * TL::total] = v[q].w;
        }
      }
    }
  } else {
    for (int idx = tid; idx < ET * NEC * TL::NJC; idx += nthr) {
      const int t = idx % ET, r = (idx / ET) % NEC, k = idx / (ET * NEC),
                b = b0 + t;
      float* d = tsm + t * TL::total + TL::J + k * NECP + r;
      if (r < ne && k < NV && b < B) cp_async4(d, J + s.J.at(r, k, b));
      else *d = 0.f;
    }
  }
  // M's lower triangle, from the (i, j) square
#pragma unroll 4
  for (int idx = tid; idx < ET * NV * NV; idx += nthr) {
    const int t = idx % ET, i = (idx / ET) / NV, j = (idx / ET) % NV,
              b = b0 + t;
    if (j <= i)
      tsm[t * TL::total + TL::M + tri(i, j)] = b < B ? M[s.M.at(i, j, b)] : 0.f;
  }
  for (int idx = tid; idx < ET * VW; idx += nthr) {
    const int t = idx % ET, i = idx / ET, b = b0 + t;
    float* v = tsm + t * TL::total + TL::V;
    const bool ok = i < NV && b < B;
    v[i] = ok ? a_warm[s.a_warm.at(i, b)] : 0.f;
    v[VW + i] = ok ? a_smooth[s.a_smooth.at(i, b)] : 0.f;
    v[2 * VW + i] = v[3 * VW + i] = v[4 * VW + i] = 0.f;
  }
#pragma unroll 4
  for (int idx = tid; idx < ET * NEC; idx += nthr) {
    const int t = idx % ET, r = idx / ET, b = b0 + t;
    float* e = tsm + t * TL::total;
    float wr = 0.f, ar = 0.f;
    bool eq = false;
    if (r < ne && b < B) {   // independent loads, then the weight
      const float d = D[s.D.at(r, b)];
      const bool act = active[s.active.at(r, b)] != 0;
      ar = aref[s.aref.at(r, b)];
      eq = is_eq[s.is_eq.at(r, b)] != 0;
      wr = act ? d : 0.f;
    }
    reinterpret_cast<float2*>(e + TL::DG)[r] = make_float2(wr, ar);
    reinterpret_cast<unsigned char*>(e + TL::EQ)[r] = eq;
  }
  cp_async_wait_all();
  __syncthreads();
  // this lane's rows r = u + LPE q: weight, aref and equality flag
  float w[RPL], ar[RPL], x[RPL], jp[RPL];
  unsigned eqm = 0;
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int r = u + LPE * q;
    const float2 v = DG[r];
    w[q] = v.x;
    ar[q] = v.y;
    if (reinterpret_cast<const unsigned char*>(base + TL::EQ)[r]) eqm |= 1u << q;
  }
  env_sync();   // DG is rewritten below
  // D on the active set at x: equality rows always, the others where x < 0
  auto dw_of = [&](int q, float xr) {
    return (((eqm >> q) & 1u) || xr < 0.f) ? w[q] : 0.f;
  };
  // x = J v - aref on this lane's rows (v: a vector in shared memory)
  auto rows_x = [&](const float* v, float (&out)[RPL]) {
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const float* Jr = Js + u + LPE * q;
      float xr = -ar[q];
#pragma unroll
      for (int k = 0; k < NV; ++k) xr += Jr[k * NECP] * v[k];
      out[q] = xr;
    }
  };

  // this lane's BS x BS block of H (bi, bj) and row slice: slice s_in of
  // its warp (lanes s_in NBLK ...), sl of the env; lanes past SPW NBLK idle
  const int s_in = SPAN ? 0 : lane / NBLK, blk = SPAN ? u : lane % NBLK;
  const bool own = SPAN ? u < NBLK : s_in < SPW;
  const int sl = SPAN ? 0 : (u >> 5) * SPW + s_in;
  int bi = 0;
  while (tri(bi + 1, 0) <= blk) ++bi;
  const int bj = blk - tri(bi, 0);
  // column c of J^T (the zero column past NV)
  auto col = [&](int c) { return Js + (c < NV ? c : TL::NJC - 1) * NECP; };

  for (int it = 0; it < n_iter; ++it) {
    // (1) rows: x, Dw and Dw x; M (a - a_smooth) by component
    rows_x(A, x);
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const float dw = dw_of(q, x[q]);
      DG[u + LPE * q] = make_float2(dw, dw * x[q]);
    }
    if (lead) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = lane + 32 * c;
        if (i < NV) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) acc += msym(i, j) * (A[j] - AS[j]);
          MDA[i] = acc;
        }
      }
    }
    env_sync();

    // (2) H = M + J^T diag(Dw) J and g = J^T (Dw x), every row, by blocks
    {
      float h[BS][BS], gs[BS];
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        gs[a] = 0.f;
#pragma unroll
        for (int c = 0; c < BS; ++c) h[a][c] = 0.f;
      }
      // four rows a step: J^T's columns are contiguous over rows, so each
      // float4 load brings one column of four rows, and (Dw, Dw x) of four
      // rows are two float4 loads
      const float* ci[BS];
      const float* cj[BS];
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        ci[a] = col(BS * bi + a);
        cj[a] = col(BS * bj + a);
      }
      const float* DGf = base + TL::DG;
      for (int r = own ? 4 * sl : ne; r < ne; r += 4 * NSL) {
        const float4 d01 = *reinterpret_cast<const float4*>(DGf + 2 * r);
        const float4 d23 = *reinterpret_cast<const float4*>(DGf + 2 * r + 4);
        float4 i4[BS], j4[BS];
#pragma unroll
        for (int a = 0; a < BS; ++a) {
          i4[a] = *reinterpret_cast<const float4*>(ci[a] + r);
          j4[a] = *reinterpret_cast<const float4*>(cj[a] + r);
        }
        const float dw[4] = {d01.x, d01.z, d23.x, d23.z};
        const float gx[4] = {d01.y, d01.w, d23.y, d23.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float iv[BS], jv[BS];
#pragma unroll
          for (int a = 0; a < BS; ++a) {
            iv[a] = q == 0 ? i4[a].x : q == 1 ? i4[a].y : q == 2 ? i4[a].z : i4[a].w;
            jv[a] = q == 0 ? j4[a].x : q == 1 ? j4[a].y : q == 2 ? j4[a].z : j4[a].w;
          }
#pragma unroll
          for (int a = 0; a < BS; ++a) {
            const float wi = dw[q] * iv[a];
#pragma unroll
            for (int c = 0; c < BS; ++c) h[a][c] += wi * jv[c];
            gs[a] += iv[a] * gx[q];
          }
        }
      }
      // the slices' sums in slice 0: first the warp's, then the env's
      auto warp_slices = [&](float& v) {
        const float own_sum = v;
#pragma unroll
        for (int q = 1; q < SPW; ++q)
          v += __shfl_sync(kFull, own_sum, lane + q * NBLK);
      };
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        warp_slices(gs[a]);
#pragma unroll
        for (int c = 0; c < BS; ++c) warp_slices(h[a][c]);
      }
      const bool first = s_in == 0;   // slice 0 of its warp
      auto each = [&](auto fn) {        // the block's entries of the triangle
#pragma unroll
        for (int a = 0; a < BS; ++a) {
          const int i = BS * bi + a;
#pragma unroll
          for (int c = 0; c < BS; ++c)
            if (i < NV && BS * bj + c <= i) fn(a, c, tri(i, BS * bj + c));
        }
      };
      if constexpr (WPE > 1 && !SPAN) {   // the other warps' sums via Ls, G
        static_assert(WPE == 2, "two warps an env");
        if (!lead && first) {
          each([&](int a, int c, int q) { Ls[q] = h[a][c]; });
          if (bi == bj)
#pragma unroll
            for (int a = 0; a < BS; ++a)
              if (BS * bi + a < NV) G[BS * bi + a] = gs[a];
        }
        env_sync();
        if (lead && first) {
          each([&](int a, int c, int q) { h[a][c] += Ls[q]; });
          if (bi == bj)
#pragma unroll
            for (int a = 0; a < BS; ++a)
              if (BS * bi + a < NV) gs[a] += G[BS * bi + a];
        }
      }
      if (SPAN ? own : lead && first) {
        each([&](int a, int c, int q) { Ls[q] = Ms[q] + h[a][c]; });
        if (bi == bj)
#pragma unroll
          for (int a = 0; a < BS; ++a)
            if (BS * bi + a < NV) G[BS * bi + a] = gs[a];
      }
    }

    if constexpr (SPAN) env_sync();   // H and g came from every warp
    // (3) the lead warp: p = -H^-1 (M da + g), then p'Mp and p'M da
    if (lead) {
      __syncwarp();
      float mg[R], pl[R];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = lane + 32 * c;
        mg[c] = i < NV ? -(MDA[i] + G[i]) : 0.f;
      }
      warp_chol_solve<NV>(Ls, mg, pl, lane);
#pragma unroll
      for (int c = 0; c < R; ++c)
        if (lane + 32 * c < NV) P[lane + 32 * c] = pl[c];
      __syncwarp();
      float pmp = 0.f, pma = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int i = lane + 32 * c;
        if (i < NV) {
          float mp = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) mp += msym(i, j) * P[j];
          pmp += pl[c] * mp;
          pma += pl[c] * MDA[i];
        }
      }
      const float pMp = warp_sum(pmp);
      const float pMa = warp_sum(pma);
      if (lane == 0) {
        S[0] = pMp;
        S[1] = pMa;
      }
    }
    env_sync();

    // (4) J p on this lane's rows, then the exact line search on the
    // piecewise-quadratic 1-D restriction
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const float* Jr = Js + u + LPE * q;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) acc += Jr[k * NECP] * P[k];
      jp[q] = acc;
    }
    const float pMp = S[0], pMa = S[1];
    float alpha = 1.f;
    for (int l = 0; l < n_ls; ++l) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const float x2 = x[q] + alpha * jp[q];
        const float dw2 = dw_of(q, x2);
        s1 += dw2 * x2 * jp[q];
        s2 += dw2 * jp[q] * jp[q];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if constexpr (WPE > 1) {   // the env's warps' sums, double-buffered
        float* ss = S + 2 + 2 * WPE * (l & 1);
        if (lane == 0) {
          ss[2 * (u >> 5)] = s1;
          ss[2 * (u >> 5) + 1] = s2;
        }
        env_sync();
        s1 = ss[0];
        s2 = ss[1];
#pragma unroll
        for (int v = 1; v < WPE; ++v) {
          s1 += ss[2 * v];
          s2 += ss[2 * v + 1];
        }
      }
      const float dphi = alpha * pMp + pMa + s1;
      const float ddphi = pMp + s2;
      alpha = alpha - dphi / nan_max(ddphi, 1e-12f);
    }
    alpha = alpha < 0.f ? 0.f : (alpha > 4.f ? 4.f : alpha);
    // (5) a += alpha p
    if (lead) {
#pragma unroll
      for (int c = 0; c < R; ++c)
        if (lane + 32 * c < NV) A[lane + 32 * c] += alpha * P[lane + 32 * c];
    }
    env_sync();
  }

  // forces on the final active set; unilateral rows pushed to f >= 0
  float* F = base + TL::DG;   // (NEC) floats, for the coalesced store
  rows_x(A, x);
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    float fr = -dw_of(q, x[q]) * x[q];
    if (!((eqm >> q) & 1u)) fr = nan_max(fr, 0.f);
    F[u + LPE * q] = fr;
  }
  env_sync();
  if (lead) {
    float qfc[R];   // J^T f, four rows a step (rows past ne give 0)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = lane + 32 * c;
      qfc[c] = 0.f;
      if (i < NV) {
        const float* Jc = Js + i * NECP;
        for (int r = 0; r < ne; r += 4) {
          const float4 j4 = *reinterpret_cast<const float4*>(Jc + r);
          const float4 f4 = *reinterpret_cast<const float4*>(F + r);
          qfc[c] += j4.x * f4.x;
          qfc[c] += j4.y * f4.y;
          qfc[c] += j4.z * f4.z;
          qfc[c] += j4.w * f4.w;
        }
      }
    }
    for (int q = lane; q < NT; q += 32) Ls[q] = Ms[q];
    __syncwarp();
    float dq[R];
    warp_chol_solve<NV>(Ls, qfc, dq, lane);
#pragma unroll
    for (int c = 0; c < R; ++c)   // qacc
      if (lane + 32 * c < NV) G[lane + 32 * c] = AS[lane + 32 * c] + dq[c];
  }
  __syncthreads();
  for (int idx = tid; idx < ET * ne; idx += nthr) {
    const int t = idx % ET, r = idx / ET, b = b0 + t;
    if (b < B) f[r * sB + b] = tsm[t * TL::total + TL::DG + r];
  }
  for (int idx = tid; idx < ET * NV; idx += nthr) {
    const int t = idx % ET, i = idx / ET, b = b0 + t;
    if (b < B) qacc[i * sB + b] = tsm[t * TL::total + TL::V + 3 * VW + i];
  }
}

template <int NV, int WPE, int RPL, int ET>
int launch_newton_tile(const float* M, const float* a_smooth,
                       const float* a_warm, const float* J, const float* aref,
                       const float* D, const unsigned char* active,
                       const unsigned char* is_eq, const NewtonStrides& st,
                       float* qacc, float* f, int ne, int B, int n_iter,
                       int n_ls, int smem, cudaStream_t s) {
  using TL = TileLayout<NV, WPE, RPL, ET>;
  if (ne > TL::NEC || smem < TL::block_bytes) return -1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      newton_tile_kernel<NV, WPE, RPL, ET>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TL::block_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  newton_tile_kernel<NV, WPE, RPL, ET>
      <<<(B + ET - 1) / ET, ET * WPE * 32, TL::block_bytes, s>>>(
          M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
          n_iter, n_ls);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of newton_tile_kernel<NV, WPE, RPL, ET> one SM holds.
template <int NV, int WPE, int RPL, int ET>
int newton_tile_blocks_per_sm() {
  using TL = TileLayout<NV, WPE, RPL, ET>;
  cudaFuncSetAttribute(newton_tile_kernel<NV, WPE, RPL, ET>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TL::block_bytes);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, newton_tile_kernel<NV, WPE, RPL, ET>, ET * WPE * 32,
      TL::block_bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// chol_tile_kernel<NV, COL_BACK>: the Cholesky solve M x = b at NV >= 3
// (AntMaze NV = 14, FetchPush NV = 21, HandManipulateBlock NV = 36), a
// block a tile of TILE consecutive envs (kCholTile; kCholTileWide at two
// rows a lane, so that 256 threads a block leave a thread up to 255
// registers for its 72-float rows and 1024 envs span 128 SMs, not 64), LPE
// lanes an env (a half-warp where NV <= 16, else a warp), lane u owning
// rows u and u + LPE (RPL rows).
//
// What bounds it on this card. At B = 2048 it moves 2.2 MB (NV = 21: 0.7
// us at 3.35 TB/s) and does ~4.2k float operations an env (0.13 us), so
// neither rate: what costs is each env's dependent chain (NV pivots, each
// a square root and a division, then 2 NV substitution steps, each a
// division) and, for the kernels this one replaces, how envs were laid on
// threads: one thread an env held the NV = 14 triangle in 255 registers
// with spill on 32 blocks; one warp an env read each element of M at batch
// stride, a sector a float, and took both operands of every product from
// shared memory.
//
// What this design does about it:
// - Staging: the tile's envs are contiguous for each element (i, j <= i)
//   of M and each row of b where the batch stride is 1, so a thread copies
//   four envs' element with one 16-byte cp.async (B % 4 == 0, 16-byte
//   aligned rows), else four 4-byte ones (strided views, any B); envs past
//   B are zeros. The tile's region holds, for each group of four envs,
//   element e of env t at 4 e + t % 4: (NT + NV) floats an env.
// - The factor in registers: lane u loads its rows of M's triangle and
//   makes L's rows in place; pivot i's row comes from its owner by shuffle
//   (no shared memory, no barrier), and the next pivot's sums over the
//   entries already made are taken before this pivot's square root and
//   division, so the chain of a pivot is one multiply-subtract, two
//   shuffles, the square root and the division. Every lane keeps each
//   L_ii. The kernel is latency-bound (2048 envs are 16 an SM). Where NV
//   exceeds 16, a warp an env (lanes past NV idle) keeps twice the warps
//   in flight that a half-warp with two rows a lane would, and measured
//   faster at NV = 21; at NV = 14 a half-warp (two envs a warp, half the
//   shuffles) measured faster.
// - Substitutions: the forward one inside the factor, column by column
//   (pivot i's owner divides r_i by L_ii in the division that makes L's
//   column i, y_i goes to the lanes by shuffle and every lower row
//   subtracts L_ji y_i: each y_j's subtractions in ascending i); L goes
//   back to the tile's region for the back substitution's reads of L's
//   columns.
//   Each element's arithmetic is chol_solve's, operation for operation:
//   t - a * b in ascending k for every entry of the factor and of y, the
//   1e-20 floor through nan_max, divisions by L_ii (no reciprocals). The
//   back substitution has two orders, each instantiation keeping the one
//   of the kernel it replaced, so that its results stay bit for bit what
//   they were: COL_BACK = false (NV = 14, as chol_solve; NV = 15 and 24,
//   new, take the plain version's order too):
//   x_i = (y_i - sum over k > i of L_ki x_k, in ascending k) / L_ii, every
//   lane of the env computing each x_i from L's columns in shared memory;
//   COL_BACK = true (NV = 21, as the one-warp-an-env kernel before it;
//   NV = 29, 30, 33, 36): column by column, x_i by shuffle from its owner
//   and every upper row subtracting L_ij x_i, so each x's subtractions run
//   in descending k. At NV = 24 the column order compiled to 64 registers
//   with 16 bytes of spill (ptxas trading them for two blocks an SM).
// - Outputs through the tile's region, written with 16-byte stores where
//   B % 4 == 0.
// The locomotion nv (3, 4, 5, 6, 9, 11, 23) are new and take the plain
// version's order, COL_BACK = false. At NV = 18 (MaMuJoCo's
// CoupledHalfCheetah) that order compiled to 64 registers with 12 bytes
// of spill, so NV = 18 takes the column order, COL_BACK = true.
// Shared memory: TILE (NT + NV) floats a block: 7.6 KB at NV = 14, 8.4 KB
// at NV = 15,
// 16.1 KB at NV = 21, 22.5 KB at NV = 36 (RPL = 2, 8 envs), under the 48 KB of
// static launch. physics/solver.py::chol_geometry computes the same.
// ---------------------------------------------------------------------------

constexpr int kCholTile = 16;      // chol_tile_kernel: envs a block
constexpr int kCholTileWide = 8;   // the same past NV = 32 (two rows a lane)

template <int NV>
struct CholLayout {
  static constexpr int LPE = NV <= 16 ? 16 : 32;    // lanes an env
  static constexpr int RPL = (NV + LPE - 1) / LPE;  // rows a lane
  static constexpr int TILE = RPL > 1 ? kCholTileWide : kCholTile;
  static constexpr int NT = tri(NV, 0);
  static constexpr int NE = NT + NV;                // floats an env
  static constexpr int threads = TILE * LPE;
  static constexpr int block_bytes = TILE * NE * 4;
  static_assert(NV >= 3 && NV <= 36 && RPL <= 2 && TILE % 4 == 0,
                "chol_tile_kernel takes 3 <= NV <= 36");
  static_assert(block_bytes <= 48 * 1024, "static shared memory limit");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

// row i of the packed triangle that holds element e: tri(i, 0) <= e < tri(i + 1, 0)
__device__ __forceinline__ int tri_row(int e) {
  int i = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  if (tri(i + 1, 0) <= e) ++i;
  else if (tri(i, 0) > e) --i;
  return i;
}

template <int NV, bool COL_BACK>
__global__ void __launch_bounds__(CholLayout<NV>::threads)
chol_tile_kernel(const float* __restrict__ M, Str3 sM,
                 const float* __restrict__ b, Str2 sb, float* __restrict__ x,
                 int B) {
  using CL = CholLayout<NV>;
  constexpr int LPE = CL::LPE, RPL = CL::RPL, NT = CL::NT, NE = CL::NE;
  constexpr int NQ = CL::TILE / 4;   // groups of four envs
  extern __shared__ __align__(16) float csm[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * CL::TILE;
  const size_t sB = (size_t)B;

  // --- staging: element e of a group of four envs, one copy a thread
  const bool vM = sM.b == 1 && sM.r % 4 == 0 && sM.c % 4 == 0 && B % 4 == 0 &&
                  (reinterpret_cast<size_t>(M) & 15) == 0;
  const bool vb = sb.b == 1 && sb.r % 4 == 0 && B % 4 == 0 &&
                  (reinterpret_cast<size_t>(b) & 15) == 0;
  for (int idx = tid; idx < NQ * NE; idx += nthr) {
    const int g = idx % NQ, e = idx / NQ, e0 = b0 + 4 * g;
    float* d = csm + g * 4 * NE + 4 * e;
    const float* src;
    long long sbt;
    bool vec;
    if (e < NT) {
      const int i = tri_row(e);
      src = M + i * sM.r + (e - tri(i, 0)) * sM.c;
      sbt = sM.b;
      vec = vM;
    } else {
      src = b + (e - NT) * sb.r;
      sbt = sb.b;
      vec = vb;
    }
    if (vec) {
      if (e0 < B) cp_async16(d, src + e0);
      else d[0] = d[1] = d[2] = d[3] = 0.f;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e0 + q < B) cp_async4(d + q, src + (e0 + q) * sbt);
        else d[q] = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int t = tid / LPE, u = tid % LPE;
  float* E = csm + (t >> 2) * 4 * NE + (t & 3);   // element e at E[4 e]
  auto shfl = [](float v, int src) { return __shfl_sync(kFull, v, src, LPE); };
  // this lane's rows j = u + LPE q of M's triangle (0 past row j and NV)
  float row[RPL][NV], r[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int j = u + LPE * q, jc = j < NV ? j : NV - 1;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const float v = E[4 * tri(jc, m < jc ? m : jc)];
      row[q][m] = (j < NV && m <= j) ? v : 0.f;
    }
    r[q] = E[4 * (NT + jc)];
  }

  // --- the factor, left-looking, with the forward substitution: pivot
  // i's row L_ik (k < i) from its owner; each row's entry t - L_jk L_ik in
  // ascending k, then / L_ii. The next pivot's sums over k < i are taken
  // before this pivot's square root and division (whose slow paths end
  // the straight-line code), so only their last term waits for it. The
  // owner of row i divides r_i (its y_i) in the same division as the rows
  // below divide t_ji, and every lower row then subtracts L_ji y_i, so
  // each y_j's subtractions run in ascending i, as in a separate pass.
  float dg[NV], tv[RPL], y[NV], own[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) tv[q] = row[q][0];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int qi = i / LPE, ui = i % LPE;
    const int n1 = i + 1 < NV ? i + 1 : i, qn = n1 / LPE, un = n1 % LPE;
    const float ti = shfl(tv[qi], ui);
    float tn[RPL];
    if (i + 1 < NV) {
#pragma unroll
      for (int q = 0; q < RPL; ++q) tn[q] = row[q][i + 1];
#pragma unroll
      for (int k = 0; k < i; ++k) {
        const float lk = shfl(row[qn][k], un);
#pragma unroll
        for (int q = 0; q < RPL; ++q) tn[q] = tn[q] - row[q][k] * lk;
      }
    }
    const float dii = sqrtf(nan_max(ti, 1e-20f));
    dg[i] = dii;
    float quot[RPL];
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int j = u + LPE * q;
      quot[q] = (j == i ? r[q] : tv[q]) / dii;
      if (j == i) {
        row[q][i] = dii;
        own[q] = quot[q];   // y_i
      } else if (j > i) {
        row[q][i] = quot[q];
      }
    }
    if (i + 1 < NV) {
      const float li = shfl(row[qn][i], un);
#pragma unroll
      for (int q = 0; q < RPL; ++q) tv[q] = tn[q] - row[q][i] * li;
    }
    const float yi = shfl(quot[qi], ui);
    y[i] = yi;
#pragma unroll
    for (int q = 0; q < RPL; ++q)
      if (u + LPE * q > i) r[q] = r[q] - row[q][i] * yi;
  }

  // L into the env's region (M's triangle is in registers), for its columns
  __syncwarp();
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int j = u + LPE * q;
#pragma unroll
    for (int m = 0; m < NV; ++m)
      if (j < NV && m <= j) E[4 * tri(j, m)] = row[q][m];
  }
  __syncwarp();

  // --- back substitution, x_j into the env's rhs slots
  if constexpr (COL_BACK) {
#pragma unroll
    for (int q = 0; q < RPL; ++q) r[q] = own[q];
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      const int qi = i / LPE, ui = i % LPE;
      const float xi = shfl(r[qi], ui) / dg[i];
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int j = u + LPE * q;
        if (j == i) own[q] = xi;
        if (j < i) r[q] = r[q] - E[4 * tri(i, j)] * xi;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int j = u + LPE * q;
      if (j < NV) E[4 * (NT + j)] = own[q];
    }
  } else {
    float xs[NV];
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < NV; ++k) s = s - E[4 * tri(k, i)] * xs[k];
      xs[i] = s / dg[i];
    }
    __syncwarp();
    if (u == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) E[4 * (NT + i)] = xs[i];
    }
  }
  __syncthreads();
  const bool vx = B % 4 == 0;   // x is (NV, B), contiguous
  for (int idx = tid; idx < NQ * NV; idx += nthr) {
    const int g = idx % NQ, i = idx / NQ, e0 = b0 + 4 * g;
    const float* s = csm + g * 4 * NE + 4 * (NT + i);
    if (vx) {
      if (e0 < B)
        *reinterpret_cast<float4*>(x + i * sB + e0) =
            *reinterpret_cast<const float4*>(s);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e0 + q < B) x[i * sB + e0 + q] = s[q];
    }
  }
}

template <int NV, bool COL_BACK>
int launch_chol_tile(const float* M, Str3 sM, const float* b, Str2 sb,
                     float* x, int B, int smem, cudaStream_t s) {
  using CL = CholLayout<NV>;
  if (smem < CL::block_bytes) return -1;
  chol_tile_kernel<NV, COL_BACK>
      <<<(B + CL::TILE - 1) / CL::TILE, CL::threads, CL::block_bytes, s>>>(
          M, sM, b, sb, x, B);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of chol_tile_kernel<NV, COL_BACK> one SM holds.
template <int NV, bool COL_BACK>
int chol_tile_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, chol_tile_kernel<NV, COL_BACK>, CholLayout<NV>::threads,
      CholLayout<NV>::block_bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

// newton_tile_kernel's instantiations X(NV, WPE, RPL, ET), each nv's in
// ascending row cap (32 WPE RPL rows): the entry points take the first of
// nv whose rows hold ne. physics/solver.py::NEWTON_TILE_SHAPES lists the
// same.
#define GRT_NEWTON_TILES(X)                                                \
  X(3, 1, 2, 8) X(4, 1, 2, 8) X(5, 1, 2, 8) X(6, 1, 2, 8) X(9, 1, 3, 8)    \
  X(11, 1, 1, 8) X(14, 1, 3, 8) X(14, 1, 4, 8) X(15, 2, 4, 8)               \
  X(18, 2, 3, 8) X(21, 2, 4, 8) X(23, 3, 3, 4) X(24, 3, 3, 4)               \
  X(29, 3, 3, 4) X(30, 3, 3, 4) X(33, 3, 3, 4) X(36, 3, 3, 4)

// chol_tile_kernel's instantiations X(NV, COL_BACK) (its note above);
// physics/solver.py::CHOL_TILE_NV lists the same nv.
#define GRT_CHOL_TILES(X)                                                  \
  X(3, false) X(4, false) X(5, false) X(6, false) X(9, false) X(11, false) \
  X(14, false) X(15, false) X(18, true) X(21, true) X(23, false)           \
  X(24, false) X(29, true) X(30, true) X(33, true) X(36, true)

Str2 str2(const long long* p) { return {p[0], p[1]}; }
Str3 str3(const long long* p) { return {p[0], p[1], p[2]}; }

}  // namespace

extern "C" {

// strides: the element strides of M (3) and b (2), in that order. nv = 2
// runs chol_solve_kernel (one env per thread), the nv of GRT_CHOL_TILES
// chol_tile_kernel; smem: the latter's block shared memory bytes
// (physics/solver.py::chol_geometry), at least grt_chol_smem_bytes(nv).
int grt_chol_solve_f32(const float* M, const float* b, float* x,
                       const long long* strides, int nv, int B, int smem,
                       void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Str3 sM = str3(strides);
  const Str2 sb = str2(strides + 3);
  if (nv == 2) {
    chol_solve_kernel<2><<<grid_for(B), kThreads, 0, s>>>(M, sM, b, sb, x, B);
    return static_cast<int>(cudaGetLastError());
  }
#define GRT_LAUNCH(NV_, CB_) \
  if (nv == NV_) return launch_chol_tile<NV_, CB_>(M, sM, b, sb, x, B, smem, s);
  GRT_CHOL_TILES(GRT_LAUNCH)
#undef GRT_LAUNCH
  return -1;
}

// Shared memory bytes of a chol_tile_kernel block at nv (GRT_CHOL_TILES),
// and the blocks one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// -1 for another nv.
int grt_chol_smem_bytes(int nv) {
#define GRT_SMEM(NV_, CB_) \
  if (nv == NV_) return CholLayout<NV_>::block_bytes;
  GRT_CHOL_TILES(GRT_SMEM)
#undef GRT_SMEM
  return -1;
}
int grt_chol_blocks_per_sm(int nv) {
#define GRT_BLOCKS(NV_, CB_) \
  if (nv == NV_) return chol_tile_blocks_per_sm<NV_, CB_>();
  GRT_CHOL_TILES(GRT_BLOCKS)
#undef GRT_BLOCKS
  return -1;
}

// strides: the element strides of M (3), a_smooth, a_warm (2 each), J (3),
// aref, D, active and is_eq (2 each), in that order. nv = 2 runs
// newton2_kernel<G, true> (G lanes an env, up to 64 rows), the nv of
// GRT_NEWTON_TILES newton_tile_kernel, the first instantiation of nv whose
// rows hold ne; smem: its block's shared memory bytes
// (physics/solver.py::newton_geometry), at least grt_newton_smem_bytes(nv,
// ne).
int grt_newton_f32(const float* M, const float* a_smooth, const float* a_warm,
                   const float* J, const float* aref, const float* D,
                   const unsigned char* active, const unsigned char* is_eq,
                   float* qacc, float* f, const long long* strides, int nv,
                   int ne, int B, int n_iter, int n_ls, int smem,
                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = strides;
  const NewtonStrides st{str3(p), str2(p + 3), str2(p + 5), str3(p + 7),
                         str2(p + 10), str2(p + 12), str2(p + 14),
                         str2(p + 16)};
  if (nv == 2) {
    return launch_newton2<true>(M, a_smooth, a_warm, J, aref, D, active,
                                is_eq, st, qacc, f, ne, B, n_iter, n_ls, s);
  }
#define GRT_LAUNCH(NV_, W_, R_, E_)                                          \
  if (nv == NV_ && ne <= TileLayout<NV_, W_, R_, E_>::NEC)                  \
    return launch_newton_tile<NV_, W_, R_, E_>(M, a_smooth, a_warm, J, aref, \
                                               D, active, is_eq, st, qacc, f, \
                                               ne, B, n_iter, n_ls, smem, s);
  GRT_NEWTON_TILES(GRT_LAUNCH)
#undef GRT_LAUNCH
  return -1;
}

// Shared memory bytes of the newton_tile_kernel block that takes ne rows
// at nv (GRT_NEWTON_TILES), and the blocks one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 for another nv or
// more rows.
int grt_newton_smem_bytes(int nv, int ne) {
#define GRT_SMEM(NV_, W_, R_, E_)                              \
  if (nv == NV_ && ne <= TileLayout<NV_, W_, R_, E_>::NEC)    \
    return TileLayout<NV_, W_, R_, E_>::block_bytes;
  GRT_NEWTON_TILES(GRT_SMEM)
#undef GRT_SMEM
  return -1;
}
int grt_newton_blocks_per_sm(int nv, int ne) {
#define GRT_BLOCKS(NV_, W_, R_, E_)                            \
  if (nv == NV_ && ne <= TileLayout<NV_, W_, R_, E_>::NEC)    \
    return newton_tile_blocks_per_sm<NV_, W_, R_, E_>();
  GRT_NEWTON_TILES(GRT_BLOCKS)
#undef GRT_BLOCKS
  return -1;
}

// The nv = 2 solve of the per-env route (newton2_kernel<G, false>: the
// 2x2 systems by determinant); strides and arguments as grt_newton_f32
// without nv. Up to 64 rows.
int grt_newton2_f32(const float* M, const float* a_smooth, const float* a_warm,
                    const float* J, const float* aref, const float* D,
                    const unsigned char* active, const unsigned char* is_eq,
                    float* qacc, float* f, const long long* strides, int ne,
                    int B, int n_iter, int n_ls, void* stream) {
  if (B <= 0) return 0;
  const long long* p = strides;
  const NewtonStrides st{str3(p), str2(p + 3), str2(p + 5), str3(p + 7),
                         str2(p + 10), str2(p + 12), str2(p + 14),
                         str2(p + 16)};
  return launch_newton2<false>(M, a_smooth, a_warm, J, aref, D, active,
                               is_eq, st, qacc, f, ne, B, n_iter, n_ls,
                               static_cast<cudaStream_t>(stream));
}

// Lanes an env of newton2_kernel at ne rows (0 past its 64-row cap), and
// the blocks of newton2_kernel<lanes, chol> one SM holds.
int grt_newton2_lanes(int ne) { return nv2_lanes(ne); }
int grt_newton2_blocks_per_sm(int lanes, int chol) {
  int n = 0;
  cudaError_t e = cudaSuccess;
  if (lanes == 4 && chol)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, newton2_kernel<4, true>, kNv2Threads, 0);
  else if (lanes == 4)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, newton2_kernel<4, false>, kNv2Threads, 0);
  else if (lanes == 8 && chol)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, newton2_kernel<8, true>, kNv2Threads, 0);
  else if (lanes == 8)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, newton2_kernel<8, false>, kNv2Threads, 0);
  else
    return -1;
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // extern "C"
