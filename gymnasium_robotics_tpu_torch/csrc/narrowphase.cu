// The pruned narrowphase's two kernels, one thread per (row, env).
//
// topk_select_kernel<KCAP> replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/narrowphase_pallas.py::topk_select
//   (K rounds of masked min + first-index argmin over the pair axis): per
//   (group, env), the indices of the K smallest ranks in ascending order,
//   first index first on ties, masked entries counting as +inf. Once every
//   finite rank is taken, the remaining rounds of the TPU kernel give
//   index 0 (the first +inf entry), and a lane with a NaN rank gives maxk in
//   every round; this kernel returns the same.
// narrowphase_kernel replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/narrowphase_pallas.py::
//   narrowphase_megakernel (with GroupSpec/_emit_group) for the primitive
//   groups plane-sphere, plane-capsule, sphere-box and capsule-box: the
//   contact formulas of collision_vec.py (_plane_sphere :88,
//   _plane_capsule :95, _sphere_box_at :221, _capsule_box :375) and the
//   frame of _contact_frame_soa :806, written out for one pair.
//
// Layout. Every array is batch-last and contiguous, element (r, ..., b) at
// r * (...) * B + b, so the 32 threads of a warp, one env each, read and
// write 128 contiguous bytes. topk_select reads rank (G, maxk, B) float32
// and mask (G, maxk) bool and writes (G, K, B) int32. narrowphase reads
// geom_xpos (ngeom, 3, B), geom_xmat (ngeom, 3, 3, B), geom_size
// (ngeom, 3, Bm) through its strides, and the pruned groups' picks sel
// (G, K, B) int32; it writes the compact table dist (ncon, B),
// pos (ncon, 3, B) and frame (ncon, 3, 3, B), rows group-major and
// pair-major (row = pair * S + slot). Its static group table is one int32
// column per evaluated pair (kind, first row, row of sel or -1, offset of
// the group's pair list) plus the lists of geom ids.
//
// What bounds them. At the AntMaze shapes (B = 2048) both move a few MB at
// most and do a few hundred operations per thread, so neither fills the
// card: 2 x 2048 and 29 x 2048 threads. The TPU kernel rescanned the
// VMEM-resident table K times; here one pass over maxk keeps a sorted
// K-list in registers (strict (rank, index) order), so the table is read
// once, coalesced. Where the TPU kernel took operand blocks gathered by
// XLA (Mosaic serialises per-lane gathers), each thread here reads its
// pair's geom ids and gathers the 12 floats of each geom's pose itself.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnarrowphase.so narrowphase.cu
// Each entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused), or -1 for a
// shape with no instantiation.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// topk_select
// ---------------------------------------------------------------------------

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ rank,
                   const unsigned char* __restrict__ mask,
                   int* __restrict__ out, int maxk, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const float* r = rank + (size_t)g * maxk * sB + b;
  const unsigned char* mk = mask + (size_t)g * maxk;
  float vals[KCAP];
  int idxs[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    vals[j] = INFINITY;
    idxs[j] = INT_MAX;
  }
  bool nan = false;
  for (int i = 0; i < maxk; ++i) {
    if (!mk[i]) continue;                 // masked: +inf, never taken
    const float v = r[i * sB];
    if (v != v) {                         // NaN: every round gives maxk
      nan = true;
      break;
    }
    if (!(v < vals[KCAP - 1])) continue;  // +inf, or not among the KCAP
    // insert by carrying the displaced entry down the sorted list; ties
    // keep the smaller index first
    float cv = v;
    int ci = i;
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (cv < vals[j] || (cv == vals[j] && ci < idxs[j])) {
        const float tv = vals[j];
        const int ti = idxs[j];
        vals[j] = cv;
        idxs[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }
  int* o = out + (size_t)g * K * sB + b;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    if (j >= K) break;
    o[j * sB] = nan ? maxk : (idxs[j] == INT_MAX ? 0 : idxs[j]);
  }
}

// ---------------------------------------------------------------------------
// narrowphase: the contact formulas for one pair
// ---------------------------------------------------------------------------

struct V {
  float x, y, z;
};
__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float comp(V a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }

// jnp.maximum / jnp.minimum propagate NaN (fmaxf and fminf drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// jnp.sign: -1, 0 or 1, NaN for NaN
__device__ __forceinline__ float jsign(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : a);
}

struct Mat {  // rows x cols
  float m[3][3];
  __device__ V col(int j) const { return {m[0][j], m[1][j], m[2][j]}; }
  __device__ V mul(V v) const {
    return {m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
            m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
            m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z};
  }
  __device__ V mulT(V v) const { return {dot(col(0), v), dot(col(1), v), dot(col(2), v)}; }
};

// a / max(|a|, eps) and |a| (collision_vec._normalize)
__device__ __forceinline__ V normalize(V a, float* n) {
  *n = sqrtf(jmax(dot(a, a), 0.f));
  const float d = jmax(*n, 1e-12f);
  return {a.x / d, a.y / d, a.z / d};
}

struct Slot {
  float dist;
  V pos, n, t;  // t: explicit tan1, NaN where the formula gives none
};

__device__ __forceinline__ V nan3() { return {NAN, NAN, NAN}; }

__device__ Slot plane_sphere(V p1, const Mat& R1, V p2, V s2) {
  const V n = R1.col(2);
  const float dist = dot(n, p2 - p1) - s2.x;
  return {dist, p2 - n * (s2.x + 0.5f * dist), n, nan3()};
}

__device__ void plane_capsule(V p1, const Mat& R1, V p2, const Mat& R2, V s2,
                              Slot* out) {
  const V n = R1.col(2);
  const V axis = R2.col(2);
  const float pn = dot(p1, n);
  // tan1 = capsule +z axis projected onto the plane; NaN when the capsule
  // stands on the plane (the frame then takes the generic tangent)
  const V proj = axis - n * dot(n, axis);
  float nrm;
  const V t1n = normalize(proj, &nrm);
  const V tan = nrm > 1e-8f ? t1n : nan3();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const V e = p2 + axis * ((s == 0 ? 1.f : -1.f) * s2.y);
    const float dist = dot(e, n) - pn - s2.x;
    out[s] = {dist, e - n * (s2.x + 0.5f * dist), n, tan};
  }
}

__device__ Slot sphere_box_at(V c1, float r1, V p2, const Mat& R2, V s2) {
  const V lv = R2.mulT(c1 - p2);  // sphere centre in the box frame
  const float loc[3] = {lv.x, lv.y, lv.z};
  const float s[3] = {s2.x, s2.y, s2.z};
  float clamped[3], fd[3];
  bool inside = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    clamped[i] = jmin(jmax(loc[i], -s[i]), s[i]);
    inside = inside && fabsf(loc[i]) < s[i];
    fd[i] = s[i] - fabsf(loc[i]);
  }
  // jnp.argmin: first index of the minimum, a NaN counting as smallest
  int k = 0;
#pragma unroll
  for (int i = 1; i < 3; ++i)
    if (fd[k] == fd[k] && (fd[i] < fd[k] || fd[i] != fd[i])) k = i;
  // selects rather than loc[k]: a runtime index would put the arrays in
  // local memory
  const float loc_k = k == 0 ? loc[0] : (k == 1 ? loc[1] : loc[2]);
  const float s_k = k == 0 ? s[0] : (k == 1 ? s[1] : s[2]);
  const float sgn = jsign(loc_k);
  float surf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    surf[i] = inside ? (i == k ? sgn * s_k : loc[i]) : clamped[i];
  const V world = p2 + R2.mul({surf[0], surf[1], surf[2]});
  float d0;
  const V nrm = normalize(world - c1, &d0);
  const V n_out = d0 > 1e-9f ? nrm : R2.col(2);
  const float dist_out = d0 - r1;
  const float dist_in = -(jmin(jmin(fd[0], fd[1]), fd[2]) + r1);
  const V n_in = (k == 0 ? R2.col(0) : (k == 1 ? R2.col(1) : R2.col(2))) * (-sgn);
  const V n = inside ? n_in : n_out;
  const float dist = inside ? dist_in : dist_out;
  return {dist, c1 + n * (r1 + 0.5f * dist), n, nan3()};
}

// Rows (normal, tan1, tan2) of one slot: tan1 the explicit one where it is
// finite, else mju_makeFrame's generic tangent.
__device__ void frame_of(V n, V t1, V (&F)[3]) {
  V t;
  if (isfinite(t1.x) && isfinite(t1.y) && isfinite(t1.z)) {
    t = t1;
  } else {
    const V cy = {-(n.x * n.y), 1.f - n.y * n.y, -(n.z * n.y)};
    const V cz = {-(n.x * n.z), -(n.y * n.z), 1.f - n.z * n.z};
    float tn;
    t = normalize(fabsf(n.y) < 0.99f ? cy : cz, &tn);
  }
  F[0] = n;
  F[1] = t;
  F[2] = {n.y * t.z - n.z * t.y, n.z * t.x - n.x * t.z, n.x * t.y - n.y * t.x};
}

__device__ __forceinline__ V load_v(const float* __restrict__ P, int g, int b,
                                    size_t sB) {
  const float* p = P + (size_t)g * 3 * sB + b;
  return {p[0], p[sB], p[2 * sB]};
}

__device__ __forceinline__ void load_m(const float* __restrict__ Rm, int g,
                                       int b, size_t sB, Mat& R) {
  const float* p = Rm + (size_t)g * 9 * sB + b;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R.m[i][j] = p[(i * 3 + j) * sB];
}

__global__ void __launch_bounds__(kThreads)
narrowphase_kernel(const float* __restrict__ P, const float* __restrict__ Rm,
                   const float* __restrict__ size, long long ss0,
                   long long ss1, long long ssb, const int* __restrict__ sel,
                   const int* __restrict__ pairs, const int* __restrict__ lens,
                   const int* __restrict__ lists, int L, int C,
                   float* __restrict__ dist, float* __restrict__ pos,
                   float* __restrict__ frame, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int kind = pairs[c];
  const int row = pairs[C + c];
  const int srow = pairs[2 * C + c];
  const int base = pairs[3 * C + c];
  int j = 0;
  if (srow >= 0) {  // a pruned group: this env's pick, kept in range
    j = sel[srow * sB + b];
    j = j < 0 ? 0 : (j >= lens[c] ? lens[c] - 1 : j);
  }
  const int g1 = lists[base + j];
  const int g2 = lists[L + base + j];
  const V p1 = load_v(P, g1, b, sB), p2 = load_v(P, g2, b, sB);
  Mat R1, R2;
  load_m(Rm, g1, b, sB, R1);
  load_m(Rm, g2, b, sB, R2);
  const V s1 = {size[g1 * ss0 + b * ssb], size[g1 * ss0 + ss1 + b * ssb],
                size[g1 * ss0 + 2 * ss1 + b * ssb]};
  const V s2 = {size[g2 * ss0 + b * ssb], size[g2 * ss0 + ss1 + b * ssb],
                size[g2 * ss0 + 2 * ss1 + b * ssb]};

  Slot out[3];
  int S;
  switch (kind) {
    case 0:  // plane-sphere
      out[0] = plane_sphere(p1, R1, p2, s2);
      S = 1;
      break;
    case 1:  // plane-capsule
      plane_capsule(p1, R1, p2, R2, s2, out);
      S = 2;
      break;
    case 2:  // sphere-box
      out[0] = sphere_box_at(p1, s1.x, p2, R2, s2);
      S = 1;
      break;
    default: {  // capsule-box: spheres at the capsule's ends and centre
      const V ax = R1.col(2);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        out[s] = sphere_box_at(p1 + ax * ((float)(s - 1) * s1.y), s1.x, p2,
                               R2, s2);
      S = 3;
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s >= S) break;
    const size_t r = (size_t)(row + s);
    dist[r * sB + b] = out[s].dist;
    float* po = pos + r * 3 * sB + b;
    po[0] = out[s].pos.x;
    po[sB] = out[s].pos.y;
    po[2 * sB] = out[s].pos.z;
    V F[3];
    frame_of(out[s].n, out[s].t, F);
    float* fo = frame + r * 9 * sB + b;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q) fo[(i * 3 + q) * sB] = comp(F[i], q);
  }
}

inline dim3 grid_for(int B, int rows) {
  return dim3((B + kThreads - 1) / kThreads, rows);
}

}  // namespace

extern "C" {

int grt_topk_select_f32(const float* rank, const unsigned char* mask, int* out,
                        int G, int maxk, int B, int K, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0 && K <= 8) {
    topk_select_kernel<8><<<grid_for(B, G), kThreads, 0, s>>>(rank, mask, out,
                                                              maxk, B, K);
  } else if (K > 8 && K <= 16) {
    topk_select_kernel<16><<<grid_for(B, G), kThreads, 0, s>>>(rank, mask, out,
                                                               maxk, B, K);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// size strides: geom, component and batch (0 for a model table of Bm = 1).
// pairs: (4, C) int32, lens: (C,), lists: (2, L).
int grt_narrowphase_f32(const float* P, const float* Rm, const float* size,
                        long long ss0, long long ss1, long long ssb,
                        const int* sel, const int* pairs, const int* lens,
                        const int* lists, int L, int C, float* dist, float* pos,
                        float* frame, int B, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  narrowphase_kernel<<<grid_for(B, C), kThreads, 0, s>>>(
      P, Rm, size, ss0, ss1, ssb, sel, pairs, lens, lists, L, C, dist, pos,
      frame, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
