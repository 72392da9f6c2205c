// Per-env dense solves of the constraint pipeline, one env per thread.
//
// chol_solve_kernel<NV> replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel_chol
//   (entered through solve_pos_soa): the batched SPD solve M x = b by an
//   unrolled LL^T with the diagonal floored at sqrt(max(s, 1e-20)).
// newton_kernel<NV, NE_CAP> replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/solver_pallas.py::_kernel_nv
//   (entered through solve_small_soa): the warm-started primal Newton
//   solve of the soft-constraint problem with exact line search.
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

// Solve H x = rhs for one env; H packed lower triangle.
template <int NV>
__device__ __forceinline__ void chol_solve(const float (&H)[tri(NV, 0)],
                                           const float (&rhs)[NV],
                                           float (&x)[NV]) {
  float L[tri(NV, 0)];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = H[tri(i, i)];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * L[tri(i, k)];
    L[tri(i, i)] = sqrtf(nan_max(s, 1e-20f));
#pragma unroll
    for (int j = i + 1; j < NV; ++j) {
      float t = H[tri(j, i)];
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
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// strides: the element strides of M (3), a_smooth, a_warm (2 each), J (3),
// aref, D, active and is_eq (2 each), in that order. Row caps are
// instantiated per nv: ne is rounded up to the first that holds it.
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
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
