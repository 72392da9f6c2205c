// Per-env dense solves of the constraint pipeline.
//
// chol_solve_kernel<NV> (NV = 2, 14; one env per thread) and
// chol_warp_kernel<NV> (NV = 21; one env per warp, below) replace the TPU
//   kernel gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel_chol
//   (entered through solve_pos_soa): the batched SPD solve M x = b by an
//   unrolled LL^T with the diagonal floored at sqrt(max(s, 1e-20)).
// newton_kernel<NV, NE_CAP> (NV = 2; one env per thread) and
// newton_warp_kernel<NV, RPL> (NV = 14, 21; one env per warp, below) replace
//   the TPU kernel gymnasium_robotics_tpu/physics/solver_pallas.py::
//   _kernel_nv (entered through solve_small_soa): the warm-started primal
//   Newton solve of the soft-constraint problem with exact line search.
// newton2_closed_kernel<NE_CAP> (one env per thread, below) replaces the TPU
//   kernel gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel
//   (entered through _solve_block / solve_small_nv2): the same Newton solve
//   at nv = 2 with each 2x2 system solved in closed form, by determinant.
//
// Layout. The kernels read the port's own batch-last arrays where they lie,
// through their element strides, so the caller copies nothing: M is the
// full (NV, NV, B) matrix, read on and below the diagonal; J is
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
// at 67 TFLOP/s float32). One thread per env is 8192 threads, two warps
// per SM, so its time is the latency of each thread's dependent chain, not
// either rate. Its design keeps that chain short and out of device memory:
// a, p, the gradient, the packed Hessian and its factor live in registers,
// and so do each row's x = J a - aref, J p, weight and equality flag
// (NE_CAP of each), so the line search reads no memory at all; each Newton
// iteration reads J (152 B per env at ne = 19) twice and aref (76 B) once,
// from L2.
// NV and NE_CAP are template parameters so every loop over them unrolls
// into registers, as Pallas unrolls them; ne <= NE_CAP, n_iter and n_ls are
// runtime values. chip_smoke.py measures both against these bounds.
// At the AntMaze shapes (NV = 14, ne = 72, 5 Newton and 4 line-search
// iterations, B = 2048) the Newton function reads 1285 floats and 72 mask
// bytes and writes 86 floats per env (11.2 MB, 3.4 us) and does about 148k
// float operations per env (4.5 us at 67 TFLOP/s float32), so operations
// bound it (chip_smoke.py counts both); one thread per env would need far
// more than 255 registers, hence the warp-per-env layout of
// newton_warp_kernel (its note below). The Cholesky at NV = 14 keeps its
// 105-entry triangle and factor in one thread's registers (in place).
// At the FetchPush shapes (NV = 21, ne = 255, 4 and 4 iterations,
// B = 2048) the Newton function reads 6393 floats and 255 mask bytes and
// writes 276 floats per env (54.8 MB, 16 us) and does about 0.6M float
// operations per env (18 us), so bytes and operations bound it about
// equally; the Cholesky moves 273 floats per env (2.2 MB, 0.7 us).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsolver.so solver.cu
// Each entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused), or -1 for an
// nv or ne with no instantiation.

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

// Symmetric product from the packed lower triangle.
template <int NV>
__device__ __forceinline__ void sym_mul(const float (&Mp)[tri(NV, 0)],
                                        const float (&v)[NV], float (&out)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      s += Mp[j <= i ? tri(i, j) : tri(j, i)] * v[j];
    out[i] = s;
  }
}

template <int NV, int NE_CAP>
__global__ void __launch_bounds__(kThreads)
newton_kernel(const float* __restrict__ M, const float* __restrict__ a_smooth,
              const float* __restrict__ a_warm, const float* __restrict__ J,
              const float* __restrict__ aref, const float* __restrict__ D,
              const unsigned char* __restrict__ active,
              const unsigned char* __restrict__ is_eq, NewtonStrides s,
              float* __restrict__ qacc, float* __restrict__ f,
              int ne, int B, int n_iter, int n_ls) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t sB = (size_t)B;
  float Mp[tri(NV, 0)], as[NV], a[NV];
  load_tril<NV>(M, s.M, e, Mp);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    as[i] = a_smooth[s.a_smooth.at(i, e)];
    a[i] = a_warm[s.a_warm.at(i, e)];
  }

  // Per-row state in registers: w = D on active rows (0 elsewhere), the
  // equality flag, and each Newton iteration's x and J p.
  float w[NE_CAP], x[NE_CAP], Jp[NE_CAP];
  bool eq[NE_CAP];
#pragma unroll
  for (int r = 0; r < NE_CAP; ++r) {
    if (r >= ne) break;
    w[r] = active[s.active.at(r, e)] ? D[s.D.at(r, e)] : 0.f;
    eq[r] = is_eq[s.is_eq.at(r, e)] != 0;
  }
  // D on the active set at x: equality rows always, the others where x < 0
  auto dw_of = [&](int r, float xr) { return (eq[r] || xr < 0.f) ? w[r] : 0.f; };
  auto row_dot = [&](int r, const float (&v)[NV]) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc += J[s.J.at(r, k, e)] * v[k];
    return acc;
  };

  for (int it = 0; it < n_iter; ++it) {
    float da[NV], Mda[NV], gs[NV], Hs[tri(NV, 0)];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      da[i] = a[i] - as[i];
      gs[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < tri(NV, 0); ++r) Hs[r] = 0.f;
    sym_mul<NV>(Mp, da, Mda);
#pragma unroll
    for (int r = 0; r < NE_CAP; ++r) {
      if (r >= ne) break;
      float Jr[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) Jr[k] = J[s.J.at(r, k, e)];
      float xr = -aref[s.aref.at(r, e)];
#pragma unroll
      for (int k = 0; k < NV; ++k) xr += Jr[k] * a[k];
      x[r] = xr;
      const float Dw = dw_of(r, xr);
      const float gx = Dw * xr;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        gs[i] += Jr[i] * gx;
        const float DJi = Dw * Jr[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) Hs[tri(i, j)] += DJi * Jr[j];
      }
    }
    float H[tri(NV, 0)], mgrad[NV], p[NV], Mpv[NV];
#pragma unroll
    for (int r = 0; r < tri(NV, 0); ++r) H[r] = Mp[r] + Hs[r];
#pragma unroll
    for (int i = 0; i < NV; ++i) mgrad[i] = -(Mda[i] + gs[i]);
    chol_solve<NV>(H, mgrad, p);

    // exact line search on the piecewise-quadratic 1-D restriction
#pragma unroll
    for (int r = 0; r < NE_CAP; ++r) {
      if (r >= ne) break;
      Jp[r] = row_dot(r, p);
    }
    sym_mul<NV>(Mp, p, Mpv);
    float pMp = 0.f, pMa = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      pMp += p[i] * Mpv[i];
      pMa += p[i] * Mda[i];
    }
    float alpha = 1.f;
    for (int l = 0; l < n_ls; ++l) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < NE_CAP; ++r) {
        if (r >= ne) break;
        const float x2 = x[r] + alpha * Jp[r];
        const float Dw2 = dw_of(r, x2);
        s1 += Dw2 * x2 * Jp[r];
        s2 += Dw2 * Jp[r] * Jp[r];
      }
      const float dphi = alpha * pMp + pMa + s1;
      const float ddphi = pMp + s2;
      alpha = alpha - dphi / nan_max(ddphi, 1e-12f);
    }
    alpha = alpha < 0.f ? 0.f : (alpha > 4.f ? 4.f : alpha);
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] += alpha * p[i];
  }

  // forces on the final active set; unilateral rows pushed to f >= 0
  float qfc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) qfc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < NE_CAP; ++r) {
    if (r >= ne) break;
    const float xr = row_dot(r, a) - aref[s.aref.at(r, e)];
    float fr = -dw_of(r, xr) * xr;
    if (!eq[r]) fr = nan_max(fr, 0.f);
    f[r * sB + e] = fr;
#pragma unroll
    for (int i = 0; i < NV; ++i) qfc[i] += J[s.J.at(r, i, e)] * fr;
  }
  float dq[NV];
  chol_solve<NV>(Mp, qfc, dq);
#pragma unroll
  for (int i = 0; i < NV; ++i) qacc[i * sB + e] = as[i] + dq[i];
}

// ---------------------------------------------------------------------------
// newton2_closed_kernel<NE_CAP>: the nv = 2 Newton solve of the per-env path
// (constraint.solve_constraints with Option.soa False; the JAX package's
// single env), as solver_pallas._kernel computes it: per iteration
// x = J0 a0 + J1 a1 - aref, the active set (equality rows, or x < 0, on
// active rows), the gradient and the three Hessian entries h00, h01, h11 as
// row sums, the step p by the 2x2 determinant, n_ls exact line-search steps
// (ddphi floored at 1e-12), alpha clipped to [0, 4]; then the forces on the
// final active set with unilateral rows clamped at 0, and
// qacc = a_smooth + M^-1 J^T f by M's determinant. M is read at (0,0),
// (0,1) and (1,1), as the TPU kernel's M3 rows.
//
// What bounds it. At the single env's shapes (B = 1) nothing but the launch
// and the thread's dependent chain. At B = 8192 and the U-maze's 19 rows
// (6 Newton, 4 line-search iterations) it reads 83 floats and 19 mask
// bytes and writes 21 floats per env (3.6 MB, 1.1 us at 3.35 TB/s) and
// does ~7.3k float operations per env (0.9 us at 67 TFLOP/s), so bytes
// and operations bound it about equally; one thread per env is again
// latency-bound. The design is newton_kernel<2, NE_CAP>'s: each row's x, J p, weight and equality flag
// live in registers (NE_CAP of each), so the line search reads no memory;
// each iteration reads J twice and aref once, from L2. Without a Cholesky
// the chain per iteration is shorter than newton_kernel<2>'s.
// ---------------------------------------------------------------------------

template <int NE_CAP>
__global__ void __launch_bounds__(kThreads)
newton2_closed_kernel(const float* __restrict__ M,
                      const float* __restrict__ a_smooth,
                      const float* __restrict__ a_warm,
                      const float* __restrict__ J,
                      const float* __restrict__ aref,
                      const float* __restrict__ D,
                      const unsigned char* __restrict__ active,
                      const unsigned char* __restrict__ is_eq, NewtonStrides s,
                      float* __restrict__ qacc, float* __restrict__ f, int ne,
                      int B, int n_iter, int n_ls) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const size_t sB = (size_t)B;
  const float m00 = M[s.M.at(0, 0, e)], m01 = M[s.M.at(0, 1, e)],
              m11 = M[s.M.at(1, 1, e)];
  const float as0 = a_smooth[s.a_smooth.at(0, e)];
  const float as1 = a_smooth[s.a_smooth.at(1, e)];
  float a0 = a_warm[s.a_warm.at(0, e)], a1 = a_warm[s.a_warm.at(1, e)];

  float w[NE_CAP], x[NE_CAP], Jp[NE_CAP];
  bool eq[NE_CAP];
#pragma unroll
  for (int r = 0; r < NE_CAP; ++r) {
    if (r >= ne) break;
    w[r] = active[s.active.at(r, e)] ? D[s.D.at(r, e)] : 0.f;
    eq[r] = is_eq[s.is_eq.at(r, e)] != 0;
  }
  auto dw_of = [&](int r, float xr) { return (eq[r] || xr < 0.f) ? w[r] : 0.f; };
  auto J0 = [&](int r) { return J[s.J.at(r, 0, e)]; };
  auto J1 = [&](int r) { return J[s.J.at(r, 1, e)]; };

  for (int it = 0; it < n_iter; ++it) {
    float sg0 = 0.f, sg1 = 0.f, s00 = 0.f, s01 = 0.f, s11 = 0.f;
#pragma unroll
    for (int r = 0; r < NE_CAP; ++r) {
      if (r >= ne) break;
      const float j0 = J0(r), j1 = J1(r);
      const float xr = j0 * a0 + j1 * a1 - aref[s.aref.at(r, e)];
      x[r] = xr;
      const float Dw = dw_of(r, xr);
      const float gx = Dw * xr;
      sg0 += j0 * gx;
      sg1 += j1 * gx;
      s00 += Dw * j0 * j0;
      s01 += Dw * j0 * j1;
      s11 += Dw * j1 * j1;
    }
    const float da0 = a0 - as0, da1 = a1 - as1;
    const float grad0 = m00 * da0 + m01 * da1 + sg0;
    const float grad1 = m01 * da0 + m11 * da1 + sg1;
    const float h00 = m00 + s00, h01 = m01 + s01, h11 = m11 + s11;
    const float det = h00 * h11 - h01 * h01;
    const float p0 = -(h11 * grad0 - h01 * grad1) / det;
    const float p1 = -(-h01 * grad0 + h00 * grad1) / det;

    // exact line search on the piecewise-quadratic 1-D restriction
#pragma unroll
    for (int r = 0; r < NE_CAP; ++r) {
      if (r >= ne) break;
      Jp[r] = J0(r) * p0 + J1(r) * p1;
    }
    const float pMp = p0 * (m00 * p0 + m01 * p1) + p1 * (m01 * p0 + m11 * p1);
    const float pMa = p0 * (m00 * da0 + m01 * da1) + p1 * (m01 * da0 + m11 * da1);
    float alpha = 1.f;
    for (int l = 0; l < n_ls; ++l) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < NE_CAP; ++r) {
        if (r >= ne) break;
        const float x2 = x[r] + alpha * Jp[r];
        const float Dw2 = dw_of(r, x2);
        s1 += Dw2 * x2 * Jp[r];
        s2 += Dw2 * Jp[r] * Jp[r];
      }
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
  for (int r = 0; r < NE_CAP; ++r) {
    if (r >= ne) break;
    const float j0 = J0(r), j1 = J1(r);
    const float xr = j0 * a0 + j1 * a1 - aref[s.aref.at(r, e)];
    float fr = -dw_of(r, xr) * xr;
    if (!eq[r]) fr = nan_max(fr, 0.f);
    f[r * sB + e] = fr;
    qfc0 += j0 * fr;
    qfc1 += j1 * fr;
  }
  const float detM = m00 * m11 - m01 * m01;
  qacc[e] = as0 + (m11 * qfc0 - m01 * qfc1) / detM;
  qacc[sB + e] = as1 + (-m01 * qfc0 + m00 * qfc1) / detM;
}

template <int NE_CAP>
void launch_newton2(const float* M, const float* a_smooth, const float* a_warm,
                    const float* J, const float* aref, const float* D,
                    const unsigned char* active, const unsigned char* is_eq,
                    const NewtonStrides& st, float* qacc, float* f, int ne,
                    int B, int n_iter, int n_ls, cudaStream_t s) {
  newton2_closed_kernel<NE_CAP><<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
      n_iter, n_ls);
}

// ---------------------------------------------------------------------------
// newton_warp_kernel<NV, RPL>: one warp per env, for the larger systems
// (AntMaze: NV = 14, ne = 72; FetchPush: NV = 21, ne = 255). One thread per
// env would hold each row's x, J p, weight and flag (4 ne values) plus H's
// triangle, far past 255 registers. Here rows are striped over the lanes
// (row r = lane + 32 q, RPL rows a lane); J, the per-iteration weights and
// M's triangle are staged once in dynamic shared memory, and where they fit
// (RPL * NV <= 48: NV = 14) each lane also keeps its rows of J in
// registers; at NV = 21 with 8 rows a lane (168 floats) J is read from
// shared memory only (row stride 21 floats: the 32 lanes hit 32 banks). The
// lanes own the entries of M + J^T D J, the warp factors the NV x NV system
// in shared memory (lane j owns row j) and the sums over rows (gradient,
// line-search derivatives, J^T f) are warp reductions by __shfl_xor_sync.
// Vectors of length NV are replicated in every lane. Shared memory per env:
// (32 RPL (NV + 1) + NV (NV + 1)) floats, 6.1 KB at NV = 14 and 24.4 KB at
// NV = 21 (97.5 KB per block of 4 envs, past the 48 KB of static shared
// memory, hence dynamic).
// chol_warp_kernel<NV> (NV = 21): the Cholesky solve with one warp per env
// (a thread's registers cannot hold the 231-entry triangle): the lanes stage
// M's lower triangle in shared memory and the warp factors it as above.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;  // envs per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Solve H x = rhs with H's packed lower triangle in shared memory (factored
// in place); rhs and x replicated in every lane. Left-looking factor with
// the same 1e-20 diagonal floor and the same order of every sum as
// chol_solve; the back substitution subtracts in descending order.
template <int NV>
__device__ void warp_chol_solve(float* L, const float (&rhs)[NV],
                                float (&x)[NV], int lane) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t = 0.f;
    if (lane >= i && lane < NV) {
      t = L[tri(lane, i)];
      for (int k = 0; k < i; ++k) t = t - L[tri(lane, k)] * L[tri(i, k)];
    }
    const float dii = sqrtf(nan_max(__shfl_sync(kFull, t, i), 1e-20f));
    if (lane == i) L[tri(i, i)] = dii;
    else if (lane > i && lane < NV) L[tri(lane, i)] = t / dii;
    __syncwarp();
  }
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) r = rhs[i];
  float y[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    y[i] = __shfl_sync(kFull, r, i) / L[tri(i, i)];
    if (lane > i && lane < NV) r = r - L[tri(lane, i)] * y[i];
  }
  r = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) r = y[i];
#pragma unroll
  for (int i = NV - 1; i >= 0; --i) {
    x[i] = __shfl_sync(kFull, r, i) / L[tri(i, i)];
    if (lane < i) r = r - L[tri(i, lane)] * x[i];
  }
  __syncwarp();
}

// Symmetric product from a packed lower triangle in shared memory.
template <int NV>
__device__ __forceinline__ void sym_mul_s(const float* Mp, const float (&v)[NV],
                                          float (&out)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      s += Mp[j <= i ? tri(i, j) : tri(j, i)] * v[j];
    out[i] = s;
  }
}

template <int NV, int RPL>
struct WarpSmem {  // floats of shared memory per env (warp)
  static constexpr int NEC = 32 * RPL, NT = tri(NV, 0);
  static constexpr int J = 0, DW = NEC * NV, M = DW + NEC, L = M + NT,
                       total = L + NT;
  static constexpr size_t block_bytes = sizeof(float) * total * kWarps;
};

// Where J sits in registers, 3 blocks an SM (at most 170 registers a
// thread), as at NV = 14 before J moved to dynamic shared memory; at NV = 21
// the 97.5 KB of shared memory a block allows 2 blocks an SM anyway.
template <int NV, int RPL>
__global__ void __launch_bounds__(kWarps * 32, RPL * NV <= 48 ? 3 : 1)
newton_warp_kernel(const float* __restrict__ M,
                   const float* __restrict__ a_smooth,
                   const float* __restrict__ a_warm,
                   const float* __restrict__ J, const float* __restrict__ aref,
                   const float* __restrict__ D,
                   const unsigned char* __restrict__ active,
                   const unsigned char* __restrict__ is_eq, NewtonStrides s,
                   float* __restrict__ qacc, float* __restrict__ f, int ne,
                   int B, int n_iter, int n_ls) {
  using SM = WarpSmem<NV, RPL>;
  constexpr int NT = SM::NT;
  constexpr int OWN = (NT + 31) / 32;    // triangle entries per lane
  constexpr bool kJReg = RPL * NV <= 48;  // this lane's rows of J in registers
  extern __shared__ float smem[];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + wid;
  if (e >= B) return;  // e is uniform across the warp
  const size_t sB = (size_t)B;
  float* base = smem + wid * SM::total;
  float* Js = base + SM::J;  // (NEC, NV), row-major
  float* Dws = base + SM::DW;
  float* Ms = base + SM::M;
  float* Ls = base + SM::L;

  // the triangle entries this lane owns, and M's triangle in shared memory
  int oi[OWN], oj[OWN];
#pragma unroll
  for (int q = 0; q < OWN; ++q) oi[q] = oj[q] = -1;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      if ((tri(i, j) & 31) == lane) {
        oi[tri(i, j) >> 5] = i;
        oj[tri(i, j) >> 5] = j;
        Ms[tri(i, j)] = M[s.M.at(i, j, e)];
      }
  float as[NV], a[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    as[i] = a_smooth[s.a_smooth.at(i, e)];
    a[i] = a_warm[s.a_warm.at(i, e)];
  }
  // this lane's rows: J in shared memory (and registers where they fit)
  float Jr[kJReg ? RPL : 1][kJReg ? NV : 1];
  float w[RPL], ar[RPL], x[RPL], Jp[RPL];
  bool eq[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int r = lane + 32 * q;
    const bool ok = r < ne;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float v = ok ? J[s.J.at(r, k, e)] : 0.f;
      Js[r * NV + k] = v;
      if constexpr (kJReg) Jr[q][k] = v;
    }
    w[q] = ok && active[s.active.at(r, e)] ? D[s.D.at(r, e)] : 0.f;
    eq[q] = ok && is_eq[s.is_eq.at(r, e)] != 0;
    ar[q] = ok ? aref[s.aref.at(r, e)] : 0.f;
  }
  __syncwarp();
  auto Jq = [&](int q, int k) {
    if constexpr (kJReg) return Jr[q][k];
    else return Js[(lane + 32 * q) * NV + k];
  };
  auto dw_of = [&](int q, float xr) { return (eq[q] || xr < 0.f) ? w[q] : 0.f; };

  for (int it = 0; it < n_iter; ++it) {
    float da[NV], Mda[NV], g[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      da[i] = a[i] - as[i];
      g[i] = 0.f;
    }
    sym_mul_s<NV>(Ms, da, Mda);
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      float xr = -ar[q];
#pragma unroll
      for (int k = 0; k < NV; ++k) xr += Jq(q, k) * a[k];
      x[q] = xr;
      const float Dw = dw_of(q, xr);
      Dws[lane + 32 * q] = Dw;
      const float gx = Dw * xr;
#pragma unroll
      for (int i = 0; i < NV; ++i) g[i] += Jq(q, i) * gx;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) g[i] = warp_sum(g[i]);
    __syncwarp();
    // H = M + J^T D J, entry by entry over the rows in order
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      if (oi[q] < 0) continue;
      const int i = oi[q], j = oj[q];
      float acc = 0.f;
      for (int r = 0; r < ne; ++r) acc += (Dws[r] * Js[r * NV + i]) * Js[r * NV + j];
      Ls[tri(i, j)] = Ms[tri(i, j)] + acc;
    }
    __syncwarp();
    float mgrad[NV], p[NV], Mpv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) mgrad[i] = -(Mda[i] + g[i]);
    warp_chol_solve<NV>(Ls, mgrad, p, lane);

    // exact line search on the piecewise-quadratic 1-D restriction
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) acc += Jq(q, k) * p[k];
      Jp[q] = acc;
    }
    sym_mul_s<NV>(Ms, p, Mpv);
    float pMp = 0.f, pMa = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      pMp += p[i] * Mpv[i];
      pMa += p[i] * Mda[i];
    }
    float alpha = 1.f;
    for (int l = 0; l < n_ls; ++l) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const float x2 = x[q] + alpha * Jp[q];
        const float Dw2 = dw_of(q, x2);
        s1 += Dw2 * x2 * Jp[q];
        s2 += Dw2 * Jp[q] * Jp[q];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float dphi = alpha * pMp + pMa + s1;
      const float ddphi = pMp + s2;
      alpha = alpha - dphi / nan_max(ddphi, 1e-12f);
    }
    alpha = alpha < 0.f ? 0.f : (alpha > 4.f ? 4.f : alpha);
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] += alpha * p[i];
  }

  // forces on the final active set; unilateral rows pushed to f >= 0
  float qfc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) qfc[i] = 0.f;
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int r = lane + 32 * q;
    float xr = -ar[q];
#pragma unroll
    for (int k = 0; k < NV; ++k) xr += Jq(q, k) * a[k];
    float fr = -dw_of(q, xr) * xr;
    if (!eq[q]) fr = nan_max(fr, 0.f);
    if (r < ne) f[r * sB + e] = fr;
#pragma unroll
    for (int i = 0; i < NV; ++i) qfc[i] += Jq(q, i) * fr;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) qfc[i] = warp_sum(qfc[i]);
#pragma unroll
  for (int q = 0; q < OWN; ++q)
    if (oi[q] >= 0) Ls[tri(oi[q], oj[q])] = Ms[tri(oi[q], oj[q])];
  __syncwarp();
  float dq[NV];
  warp_chol_solve<NV>(Ls, qfc, dq, lane);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) qacc[i * sB + e] = as[i] + dq[i];
}

template <int NV, int RPL>
int launch_newton_warp(const float* M, const float* a_smooth,
                       const float* a_warm, const float* J, const float* aref,
                       const float* D, const unsigned char* active,
                       const unsigned char* is_eq, const NewtonStrides& st,
                       float* qacc, float* f, int ne, int B, int n_iter,
                       int n_ls, cudaStream_t s) {
  constexpr size_t bytes = WarpSmem<NV, RPL>::block_bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      newton_warp_kernel<NV, RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  newton_warp_kernel<NV, RPL><<<(B + kWarps - 1) / kWarps, kWarps * 32, bytes, s>>>(
      M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
      n_iter, n_ls);
  return 0;
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
chol_warp_kernel(const float* __restrict__ M, Str3 sM,
                 const float* __restrict__ b, Str2 sb, float* __restrict__ x,
                 int B) {
  constexpr int NT = tri(NV, 0);
  __shared__ float sL[kWarps][NT];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + wid;
  if (e >= B) return;  // e is uniform across the warp
  float* Ls = sL[wid];
  for (int t = lane; t < NT; t += 32) {
    int i = 0;
    while (tri(i + 1, 0) <= t) ++i;
    Ls[t] = M[sM.at(i, t - tri(i, 0), e)];
  }
  float rhs[NV], out[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) rhs[i] = b[sb.at(i, e)];
  __syncwarp();
  warp_chol_solve<NV>(Ls, rhs, out, lane);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) x[i * (size_t)B + e] = out[i];
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

template <int NV, int NE_CAP>
void launch_newton(const float* M, const float* a_smooth, const float* a_warm,
                   const float* J, const float* aref, const float* D,
                   const unsigned char* active, const unsigned char* is_eq,
                   const NewtonStrides& st, float* qacc, float* f, int ne,
                   int B, int n_iter, int n_ls, cudaStream_t s) {
  newton_kernel<NV, NE_CAP><<<grid_for(B), kThreads, 0, s>>>(
      M, a_smooth, a_warm, J, aref, D, active, is_eq, st, qacc, f, ne, B,
      n_iter, n_ls);
}

Str2 str2(const long long* p) { return {p[0], p[1]}; }
Str3 str3(const long long* p) { return {p[0], p[1], p[2]}; }

}  // namespace

extern "C" {

// strides: the element strides of M (3) and b (2), in that order.
int grt_chol_solve_f32(const float* M, const float* b, float* x,
                       const long long* strides, int nv, int B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 2:
      chol_solve_kernel<2><<<grid_for(B), kThreads, 0, s>>>(
          M, str3(strides), b, str2(strides + 3), x, B);
      break;
    case 14:
      chol_solve_kernel<14><<<grid_for(B), kThreads, 0, s>>>(
          M, str3(strides), b, str2(strides + 3), x, B);
      break;
    case 21:
      chol_warp_kernel<21><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
          M, str3(strides), b, str2(strides + 3), x, B);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// strides: the element strides of M (3), a_smooth, a_warm (2 each), J (3),
// aref, D, active and is_eq (2 each), in that order. Row caps are
// instantiated per nv: ne is rounded up to the first that holds it. nv = 2
// runs newton_kernel (one env per thread), nv = 14 and 21
// newton_warp_kernel (one env per warp, up to 96 and 256 rows).
int grt_newton_f32(const float* M, const float* a_smooth, const float* a_warm,
                   const float* J, const float* aref, const float* D,
                   const unsigned char* active, const unsigned char* is_eq,
                   float* qacc, float* f, const long long* strides, int nv,
                   int ne, int B, int n_iter, int n_ls, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = strides;
  const NewtonStrides st{str3(p), str2(p + 3), str2(p + 5), str3(p + 7),
                         str2(p + 10), str2(p + 12), str2(p + 14),
                         str2(p + 16)};
  if (nv == 2 && ne <= 32) {
    launch_newton<2, 32>(M, a_smooth, a_warm, J, aref, D, active, is_eq, st,
                         qacc, f, ne, B, n_iter, n_ls, s);
  } else if (nv == 2 && ne <= 64) {
    launch_newton<2, 64>(M, a_smooth, a_warm, J, aref, D, active, is_eq, st,
                         qacc, f, ne, B, n_iter, n_ls, s);
  } else if (nv == 14 && ne <= 96) {
    const int rc = launch_newton_warp<14, 3>(M, a_smooth, a_warm, J, aref, D,
                                             active, is_eq, st, qacc, f, ne, B,
                                             n_iter, n_ls, s);
    if (rc) return rc;
  } else if (nv == 21 && ne <= 256) {
    const int rc = launch_newton_warp<21, 8>(M, a_smooth, a_warm, J, aref, D,
                                             active, is_eq, st, qacc, f, ne, B,
                                             n_iter, n_ls, s);
    if (rc) return rc;
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// The nv = 2 closed-form solve (newton2_closed_kernel); strides and
// arguments as grt_newton_f32 without nv. Row caps 32 and 64.
int grt_newton2_f32(const float* M, const float* a_smooth, const float* a_warm,
                    const float* J, const float* aref, const float* D,
                    const unsigned char* active, const unsigned char* is_eq,
                    float* qacc, float* f, const long long* strides, int ne,
                    int B, int n_iter, int n_ls, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = strides;
  const NewtonStrides st{str3(p), str2(p + 3), str2(p + 5), str3(p + 7),
                         str2(p + 10), str2(p + 12), str2(p + 14),
                         str2(p + 16)};
  if (ne <= 32) {
    launch_newton2<32>(M, a_smooth, a_warm, J, aref, D, active, is_eq, st,
                       qacc, f, ne, B, n_iter, n_ls, s);
  } else if (ne <= 64) {
    launch_newton2<64>(M, a_smooth, a_warm, J, aref, D, active, is_eq, st,
                       qacc, f, ne, B, n_iter, n_ls, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
