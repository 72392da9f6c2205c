// The pruned narrowphase's two kernels.
//
// topk_select_kernel<KCAP> (KCAP = 8, 16, 24) replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/narrowphase_pallas.py::topk_select
//   (K rounds of masked min + first-index argmin over the pair axis): per
//   (group, env), the indices of the K smallest ranks in ascending order,
//   first index first on ties, masked entries counting as +inf. Once every
//   finite rank is taken, the remaining rounds of the TPU kernel give
//   index 0 (the first +inf entry), and a lane with an unmasked NaN rank
//   gives maxk in every round; this kernel returns the same.
// narrowphase_kernel replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/narrowphase_pallas.py::
//   narrowphase_megakernel (with GroupSpec/_emit_group) for the groups
//   plane-sphere, plane-capsule, sphere-box, capsule-box, plane-box,
//   box-box, plane-hull, plane-cylinder, cylinder-box, cylinder-hull,
//   capsule-capsule, capsule-cylinder, cylinder-cylinder, sphere-capsule
//   and capsule-hull: the contact formulas of collision_vec.py
//   (_plane_sphere :88, _plane_capsule :95, _plane_box :152 with
//   _take_smallest :135, _plane_cylinder :163, _sphere_sphere_at :188,
//   _sphere_capsule :213, _sphere_box_at :221, _point_cylinder :252 with
//   _sphere_cylinder_at :301, _capsule_cylinder :313,
//   _cylinder_cylinder :332, _capsule_capsule :366, _capsule_box :375
//   (also cylinder-box, _dispatch :800), _box_box :388 with
//   _box_box_edge :427 and _seg_seg_closest :344, _point_hull_depth :510
//   and _sphere_hull_probe :603 (cylinder-hull and capsule-hull,
//   _make_capsule_hull :624),
//   _make_plane_hull :673) and the frame of _contact_frame_soa :806, a
//   block taking 32 envs (one a lane) and a task of the group table (four
//   warp items, below). The box-hull and hull-hull groups run with MPR
//   outside both the TPU kernel and this one.
//
// Layout. Every array is batch-last and contiguous, element (r, ..., b) at
// r * (...) * B + b, so the 32 threads of a warp, one env each, read and
// write 128 contiguous bytes. topk_select reads rank (G, maxk, B) float32
// and mask (G, maxk) bool and writes (G, K, B) int32. narrowphase reads
// geom_xpos (ngeom, 3, B), geom_xmat (ngeom, 3, 3, B), geom_size
// (ngeom, 3, Bm) through its strides, the pruned groups' picks sel
// (G, K, B) int32 and the hull vertex and face tables (nhull, V, 3) and
// (nhull, F, 4); it writes its
// groups' rows of the compact table dist (ncon, B), pos (ncon, 3, B) and
// frame (ncon, 3, 3, B), rows group-major and pair-major (row = pair * S +
// slot), in place. Its static group table is one int32 column per
// evaluated pair (kind, first row, row of sel or -1, offset of the group's
// pair list) plus the lists of geom ids and each geom's hull id.
//
// What bounds topk_select on this card. Its table is small (2.8 MB at
// (2, 169, 2048)), so bytes bound it at 0.2-1.1 us; what costs is latency.
// One thread per (group, env) walking all maxk rows in turn would pay one
// row's load and insertion per row, in sequence, on 32 blocks for 132 SMs
// at (2, 169). So a block takes one group and a tile of 32 envs (one lane
// each) and 8 warps that
// split the rows (warp w takes rows w, w + 8, ...): 128 blocks at
// (2, 169). The rows stream through a two-stage ring of 128-row chunks in
// shared memory, each chunk staged with cp.async (16 bytes a thread when
// B % 4 == 0, else 4) while the warps scan the other; masked rows and envs
// past B are written as +inf while staging, so shared memory stays under
// 33 KB whatever maxk. Each thread keeps a sorted KCAP-list of its env's
// rows in its slice, in strict (rank, index) order, in registers (one
// compare-and-carry chain an insertion). Then the 8 lists of each env go
// to shared memory (aliasing the ring) and warp 0 merges them: K rounds of
// the strict minimum over the 8 heads, which is exactly the K-round result,
// ties included, since the lists hold disjoint indices. A NaN seen by any
// slice flags the env, which then gives maxk in every round; an empty place
// gives 0. The K indices are written coalesced.
// What bounds narrowphase: at the AntMaze and FetchPush shapes (B = 2048)
// it moves 1-3 MB (1-4.5 us at the card's memory rate) and does a few
// hundred (primitives) to a few thousand (box-box) operations a pair, so
// the card's rates are not what bounds it: a launch lasts as long as its
// longest chain of dependent instructions. With one thread a (pair, env),
// that chain was a box-box pair's (its 8 corners both ways, each picking
// 4 of 8, then 9 edge axes in turn) and every kind ran at box-box's
// registers. So the work is cut finer than a pair, into warp items of a
// 32-env block, listed in the table's ``tasks`` with the longest first
// (tools/narrowphase_kinds.py times each kind alone and the other
// assignments below):
// - solo items, four to a block, one a warp: plane-sphere, plane-capsule,
//   sphere-box, plane-cylinder, each of capsule-box's and cylinder-box's
//   three spheres, each of cylinder-hull's two end-sphere probes,
//   sphere-capsule, capsule-capsule and capsule-cylinder (its 24-round
//   ternary search, the longest item of the kernel: 48 point-cylinder
//   distances in a chain, so its tasks go first);
// - cylinder-cylinder, cooperative: its two searches (each cylinder as a
//   capsule against the other) on warps 0 and 1, joined by warp 0;
// - plane-hull, solo: its 24 vertices on one warp measured faster than
//   on four (a cooperative task holds four warps through warp 0's picks),
//   and plane-box and box-box's corners faster on four than on one;
// - cooperative items, the block's four warps on one pair: plane-box and
//   box-box in three tasks (box 2's corners in box 1, box 1's in box 2:
//   each warp makes a quarter of the candidates' depths, warp 0 picks the
//   4 smallest in the formula's order, each warp writes one slot; the edge
//   slot: each warp makes 1-2 face axes and 2-3 of the 9 edge axes, warp 0
//   runs the formula's in-order selection);
// - the 4-of-N picks (take_smallest) as a tree of pairwise first-index
//   argmins, log2 N deep, where the formula scans in order;
// - two instantiations, launched one or the other: narrowphase_kernel<false>
//   holds the primitive kinds alone (56 registers on sm_90a), <true> the
//   candidate formulas and the cylinder kinds too (111), so the AntMaze
//   table runs at the former.
// Every row's arithmetic is unchanged: the same helpers and operand order,
// candidates and picks passed through shared memory as exact floats, the edge
// slot's selection (not associative: the first axis is always taken, a NaN
// never) in order on one lane; the compact table is bit for bit the one-
// thread-a-pair kernel's (tools/narrowphase_kinds.py --parent). Where the TPU
// kernel took operand blocks gathered by XLA (Mosaic serialises per-lane
// gathers), each thread reads its pair's geom ids and gathers the 12 floats
// of each geom's pose (and a hull's vertices) itself. Every array a formula
// indexes at a runtime face, axis or corner is written as selects or
// recomputed at the picked index, so it stays in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnarrowphase.so narrowphase.cu
// Each entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused), or -1 for a
// shape with no instantiation or too little shared memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

// ---------------------------------------------------------------------------
// topk_select
// ---------------------------------------------------------------------------

constexpr int kTopkTile = 32;     // envs a block, one lane each
constexpr int kTopkWarps = 8;     // warps a block, each a slice of the rows
constexpr int kTopkChunk = 128;   // rows a stage of the ring

// Bytes of dynamic shared memory of a block: the ring of two chunks,
// aliased after the scan by the warps' lists (KCAP values and indices for
// each of the tile's envs), then one NaN flag per env and the merge's next
// place in each list per env.
// physics/narrowphase.py::topk_geometry computes the same.
__host__ __device__ inline int topk_lists_bytes(int maxk, int kcap) {
  const int ch = maxk < kTopkChunk ? (maxk > 0 ? maxk : 1) : kTopkChunk;
  const int ring = 2 * ch * kTopkTile * 4;
  const int lists = kTopkWarps * kcap * kTopkTile * 8;
  return ring > lists ? ring : lists;
}
__host__ __device__ inline int topk_smem_bytes(int maxk, int kcap) {
  return topk_lists_bytes(maxk, kcap) + (1 + kTopkWarps) * kTopkTile * 4;
}

// cp.async of 4 or 16 bytes into shared memory; the host pass (which never
// runs a kernel) sees plain copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *static_cast<float*>(dst) = *static_cast<const float*>(src);
#endif
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  *static_cast<float4*>(dst) = *static_cast<const float4*>(src);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Stage rows [r0, r0 + n) of the block's (maxk, tile) slice of rank into
// dst (n rows of kTopkTile floats), masked rows and envs past B as +inf.
__device__ __forceinline__ void topk_stage(const float* __restrict__ rg,
                                           const unsigned char* __restrict__ mk,
                                           float* dst, int r0, int n, int b0,
                                           int B, bool vec4) {
  const size_t sB = (size_t)B;
  if (vec4) {  // B % 4 == 0 and rank 16-byte aligned: 8 threads a row
    for (int i = threadIdx.x; i < n * 8; i += blockDim.x) {
      const int r = i >> 3, q = (i & 7) * 4;
      float* d = dst + r * kTopkTile + q;
      if (mk[r0 + r] && b0 + q < B) {
        cp_async16(d, rg + (r0 + r) * sB + b0 + q);
      } else {
        d[0] = d[1] = d[2] = d[3] = INFINITY;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * kTopkTile; i += blockDim.x) {
      const int r = i / kTopkTile, q = i % kTopkTile;
      float* d = dst + r * kTopkTile + q;
      if (mk[r0 + r] && b0 + q < B) {
        cp_async4(d, rg + (r0 + r) * sB + b0 + q);
      } else {
        *d = INFINITY;
      }
    }
  }
  cp_async_commit();
}

template <int KCAP>
__global__ void __launch_bounds__(kTopkWarps * 32)
topk_select_kernel(const float* __restrict__ rank,
                   const unsigned char* __restrict__ mask,
                   int* __restrict__ out, int maxk, int B, int K, int vec4) {
  extern __shared__ __align__(16) unsigned char topk_smem[];
  float* ring = reinterpret_cast<float*>(topk_smem);
  float* lval = ring;                                   // after the scan
  int* lidx = reinterpret_cast<int*>(topk_smem) + kTopkWarps * KCAP * kTopkTile;
  int* nanf = reinterpret_cast<int*>(topk_smem + topk_lists_bytes(maxk, KCAP));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.y, b0 = blockIdx.x * kTopkTile, b = b0 + lane;
  const size_t sB = (size_t)B;
  const float* rg = rank + (size_t)g * maxk * sB;
  const unsigned char* mk = mask + (size_t)g * maxk;
  const int ch = maxk < kTopkChunk ? maxk : kTopkChunk;
  const int nch = (maxk + ch - 1) / ch;
  if (threadIdx.x < kTopkTile) nanf[threadIdx.x] = 0;

  float vals[KCAP];
  int idxs[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    vals[j] = INFINITY;
    idxs[j] = INT_MAX;
  }
  bool nan = false;
  topk_stage(rg, mk, ring, 0, ch, b0, B, vec4 != 0);
  for (int c = 0; c < nch; ++c) {
    const int r0 = c * ch, n = min(ch, maxk - r0);
    if (c + 1 < nch) {
      topk_stage(rg, mk, ring + ((c + 1) & 1) * ch * kTopkTile, r0 + ch,
                 min(ch, maxk - r0 - ch), b0, B, vec4 != 0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* src = ring + (c & 1) * ch * kTopkTile;
    for (int r = w; r < n; r += kTopkWarps) {
      const float v = src[r * kTopkTile + lane];
      if (v != v) {                          // NaN: every round gives maxk
        nan = true;
        continue;
      }
      // +inf (masked or not) is never taken; the rows of a slice come in
      // ascending order, so a tie with the last entry ranks after it
      if (!(v < vals[KCAP - 1])) continue;
      // insert by carrying the displaced entry down the sorted list
      float cv = v;
      int ci = r0 + r;
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
    __syncthreads();   // the stage is refilled next
  }

  // the slices' lists to shared memory, then warp 0 merges them per env
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    lval[(w * KCAP + j) * kTopkTile + lane] = vals[j];
    lidx[(w * KCAP + j) * kTopkTile + lane] = idxs[j];
  }
  if (nan) nanf[lane] = 1;
  __syncthreads();
  if (w != 0 || b >= B) return;
  const bool lane_nan = nanf[lane] != 0;
  int* head = nanf + kTopkTile;            // [slice][env]: next list place
#pragma unroll
  for (int s = 0; s < kTopkWarps; ++s) head[s * kTopkTile + lane] = 0;
  int* o = out + (size_t)g * K * sB + b;
  for (int k = 0; k < K; ++k) {
    int best = 0, bi = INT_MAX;
    float bv = INFINITY;
#pragma unroll
    for (int s = 0; s < kTopkWarps; ++s) {
      const int p = head[s * kTopkTile + lane];
      if (p < KCAP) {
        const float v = lval[(s * KCAP + p) * kTopkTile + lane];
        const int i = lidx[(s * KCAP + p) * kTopkTile + lane];
        if (v < bv || (v == bv && i < bi)) {
          best = s;
          bv = v;
          bi = i;
        }
      }
    }
    o[k * sB] = lane_nan ? maxk : (bi == INT_MAX ? 0 : bi);
    ++head[best * kTopkTile + lane];
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
  __device__ V mul_rn(V v) const;
  __device__ V mulT_rn(V v) const;
};

// The _rn forms round every product on its own (__fmul_rn is never fused
// into a multiply-add), as the plain version's separate PyTorch operators
// do. The box and hull formulas order candidates that tie in exact
// arithmetic (the corners of a box resting flat, an edge axis along a face
// axis), and a fused multiply-add would order them otherwise; sphere-box
// (and so capsule-box and cylinder-box) normalises the short vector from
// the sphere's centre to the box surface, which a fused multiply-add
// would move by more than the tolerance for a sphere pressed into the box.
// The plane-sphere and plane-capsule formulas keep it.
__device__ __forceinline__ V scale_rn(V a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}
__device__ __forceinline__ float dot_rn(V a, V b) {
  return __fmul_rn(a.x, b.x) + __fmul_rn(a.y, b.y) + __fmul_rn(a.z, b.z);
}
__device__ __forceinline__ V cross_rn(V a, V b) {
  return {__fmul_rn(a.y, b.z) - __fmul_rn(a.z, b.y),
          __fmul_rn(a.z, b.x) - __fmul_rn(a.x, b.z),
          __fmul_rn(a.x, b.y) - __fmul_rn(a.y, b.x)};
}
__device__ V Mat::mul_rn(V v) const {
  return {dot_rn({m[0][0], m[0][1], m[0][2]}, v), dot_rn({m[1][0], m[1][1], m[1][2]}, v),
          dot_rn({m[2][0], m[2][1], m[2][2]}, v)};
}
__device__ V Mat::mulT_rn(V v) const {
  return {dot_rn(col(0), v), dot_rn(col(1), v), dot_rn(col(2), v)};
}

// a / max(|a|, eps) and |a| (collision_vec._normalize)
__device__ __forceinline__ V normalize(V a, float* n) {
  *n = sqrtf(jmax(dot(a, a), 0.f));
  const float d = jmax(*n, 1e-12f);
  return {a.x / d, a.y / d, a.z / d};
}
__device__ __forceinline__ V normalize_rn(V a, float* n) {
  *n = sqrtf(jmax(dot_rn(a, a), 0.f));
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
  const V lv = R2.mulT_rn(c1 - p2);  // sphere centre in the box frame
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
  const V world = p2 + R2.mul_rn({surf[0], surf[1], surf[2]});
  float d0;
  const V nrm = normalize_rn(world - c1, &d0);
  const V n_out = d0 > 1e-9f ? nrm : R2.col(2);
  const float dist_out = d0 - r1;
  const float dist_in = -(jmin(jmin(fd[0], fd[1]), fd[2]) + r1);
  const V n_in = (k == 0 ? R2.col(0) : (k == 1 ? R2.col(1) : R2.col(2))) * (-sgn);
  const V n = inside ? n_in : n_out;
  const float dist = inside ? dist_in : dist_out;
  return {dist, c1 + scale_rn(n, r1 + 0.5f * dist), n, nan3()};
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

// One slot of the compact table: dist (ncon, B), pos (ncon, 3, B) and the
// frame (ncon, 3, 3, B) of row r, env b.
struct Out {
  float *dist, *pos, *frame;
  size_t sB;
  int b;
  __device__ void store(int r, float d, V p, V n, V t) const {
    const size_t rr = (size_t)r;
    dist[rr * sB + b] = d;
    float* po = pos + rr * 3 * sB + b;
    po[0] = p.x;
    po[sB] = p.y;
    po[2 * sB] = p.z;
    V F[3];
    frame_of(n, t, F);
    float* fo = frame + rr * 9 * sB + b;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int q = 0; q < 3; ++q) fo[(i * 3 + q) * sB] = comp(F[i], q);
  }
};

constexpr float kBig = 1e10f;

// collision_vec._take_smallest on N values held in registers: M rounds of
// jnp.argmin (the first index of the minimum, the first NaN before all),
// each pick pushed up by 2 * _BIG. pick[r] is the index, val[r] the value
// before the push (a NaN is picked in every later round, as there). The
// argmin orders (NaN first, then value, then index), a total order, so a
// tree of pairwise picks (the right one where the left is not NaN and the
// right is NaN or smaller) gives the sequential scan's index in log2 N
// steps.
template <int N, int M>
__device__ __forceinline__ void take_smallest(const float (&d)[N], int (&pick)[M],
                                              float (&val)[M]) {
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = d[i];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float bv[N];
    int bi[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      bv[i] = w[i];
      bi[i] = i;
    }
#pragma unroll
    for (int h = 1; h < N; h *= 2) {
#pragma unroll
      for (int i = 0; i + h < N; i += 2 * h) {
        if (bv[i] == bv[i] && (bv[i + h] < bv[i] || bv[i + h] != bv[i + h])) {
          bv[i] = bv[i + h];
          bi[i] = bi[i + h];
        }
      }
    }
    const int k = bi[0];
    pick[r] = k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) {
        val[r] = d[i];
        w[i] = w[i] + 2.f * kBig;
      }
    }
  }
}

// A pair's operands for one env: its kind, first compact row, the two geoms'
// poses and sizes, and the second geom's id (a hull's vertex table).
struct Pair {
  int kind, row, g2;
  V p1, p2, s1, s2;
  Mat R1, R2;
};

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

// Column c of the group table (kind, first row, row of sel, list offset)
// for env b: a pruned group's pick is kept in range.
__device__ __forceinline__ void load_pair(
    int c, int b, size_t sB, const float* __restrict__ P,
    const float* __restrict__ Rm, const float* __restrict__ size,
    long long ss0, long long ss1, long long ssb, const int* __restrict__ sel,
    const int* __restrict__ pairs, const int* __restrict__ lens,
    const int* __restrict__ lists, int L, int C, Pair& q) {
  q.kind = pairs[c];
  q.row = pairs[C + c];
  const int srow = pairs[2 * C + c];
  const int base = pairs[3 * C + c];
  int j = 0;
  if (srow >= 0) {
    j = sel[srow * sB + b];
    j = j < 0 ? 0 : (j >= lens[c] ? lens[c] - 1 : j);
  }
  const int g1 = lists[base + j];
  q.g2 = lists[L + base + j];
  q.p1 = load_v(P, g1, b, sB);
  q.p2 = load_v(P, q.g2, b, sB);
  load_m(Rm, g1, b, sB, q.R1);
  load_m(Rm, q.g2, b, sB, q.R2);
  q.s1 = {size[g1 * ss0 + b * ssb], size[g1 * ss0 + ss1 + b * ssb],
          size[g1 * ss0 + 2 * ss1 + b * ssb]};
  q.s2 = {size[q.g2 * ss0 + b * ssb], size[q.g2 * ss0 + ss1 + b * ssb],
          size[q.g2 * ss0 + 2 * ss1 + b * ssb]};
}

// ---------------------------------------------------------------------------
// The cooperative items: a block's four warps (32 envs, one a lane) share
// one pair's formula. Shared scratch, row r of 32 floats at S[32 r] for the
// lane's env: up to kHullV candidate values, then the 4 picked values.
// ---------------------------------------------------------------------------

constexpr int kHullV = 32;   // largest hull vertex count
constexpr int kHullF = 64;   // largest hull face count
constexpr int kNpWarps = 4;  // warps a block
constexpr int kNpEnvs = 32;  // envs a block, one a lane
constexpr int kCoop = 1 << 28;         // a task item all four warps share
constexpr int kPlaneBox = 4;           // the kinds the switches name
constexpr int kPlaneCylinder = 7, kCylinderBox = 8, kCylinderHull = 9;
constexpr int kCapsuleCapsule = 10, kCapsuleCylinder = 11;
constexpr int kCylinderCylinder = 12, kSphereCapsule = 13;
constexpr int kCapsuleHull = 14;
constexpr int kShRows = 6 + 7 * 9;     // the edge slot's face and axis rows

// The 4 smallest of N candidates (collision_vec._take_smallest) and their
// slots, cand(c) making candidate c and store(s, pick, value) writing slot
// s. Solo (COOP false): one thread does it all. Cooperative: warp w makes
// candidates w, w + 4, ...; warp 0 picks; warp s writes slot s; every
// thread of the block calls it.
template <bool COOP, int N, class Cand, class Store>
__device__ __forceinline__ void smallest4(float* S, int* picks, int w,
                                          bool live, Cand cand, Store store) {
  if constexpr (!COOP) {
    float d[N];
#pragma unroll
    for (int c = 0; c < N; ++c) d[c] = cand(c);
    int pick[4];
    float val[4];
    take_smallest<N, 4>(d, pick, val);
#pragma unroll
    for (int s = 0; s < 4; ++s) store(s, pick[s], val[s]);
  } else {
    if (live)
      for (int c = w; c < N; c += kNpWarps) S[32 * c] = cand(c);
    __syncthreads();
    if (w == 0 && live) {
      float d[N];
#pragma unroll
      for (int c = 0; c < N; ++c) d[c] = S[32 * c];
      int pick[4];
      float val[4];
      take_smallest<N, 4>(d, pick, val);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        picks[32 * s] = pick[s];
        S[32 * (N + s)] = val[s];
      }
    }
    __syncthreads();
    if (live) store(w, picks[32 * w], S[32 * (N + w)]);
  }
}

// Corner c of a box in its own frame: sign -1/+1 per component from the
// bits of c (x the high bit), as collision_vec._CORNER_SIGNS orders them.
__device__ __forceinline__ V corner_off(int c, V s) {
  return {(c & 4 ? 1.f : -1.f) * s.x, (c & 2 ? 1.f : -1.f) * s.y,
          (c & 1 ? 1.f : -1.f) * s.z};
}

// plane-box (collision_vec._plane_box): the 4 deepest box corners.
__device__ void plane_box(const Pair& q, float* S, int* picks, int w,
                          bool live, const Out& o) {
  const V n = q.R1.col(2);
  const float pn = dot_rn(q.p1, n);
  smallest4<true, 8>(
      S, picks, w, live,
      [&](int c) { return dot_rn(q.p2 + q.R2.mul_rn(corner_off(c, q.s2)), n) - pn; },
      [&](int s, int pick, float val) {
        const V wv = q.p2 + q.R2.mul(corner_off(pick, q.s2));
        o.store(q.row + s, val, wv - n * (0.5f * val), n, nan3());
      });
}

// plane-hull (collision_vec._make_plane_hull): the 4 deepest of the hull's
// nv <= kHullV vertices, hv = (nv, 3) in the mesh geom's frame; solo.
__device__ void plane_hull(const Pair& q, const float* __restrict__ hv,
                           int nv, const Out& o) {
  const V n = q.R1.col(2);
  const float pn = dot_rn(q.p1, n);
  smallest4<false, kHullV>(
      nullptr, nullptr, 0, true,
      [&](int v) {
        if (v >= nv) return INFINITY;
        const V l = {hv[3 * v], hv[3 * v + 1], hv[3 * v + 2]};
        return dot_rn(q.p2 + q.R2.mul_rn(l), n) - pn;
      },
      [&](int s, int v, float val) {
        const V wv = q.p2 + q.R2.mul({hv[3 * v], hv[3 * v + 1], hv[3 * v + 2]});
        o.store(q.row + s, val, wv - n * (0.5f * val), n, nan3());
      });
}

// plane-cylinder (collision_vec._plane_cylinder): a rim point on each end
// cap, the deepest along the plane's normal. An upright cylinder's axis is
// along the normal: there |perp| and |proj| are a rounding away from the
// 1e-6 and 1e-8 that pick the fallback rim point and the NaN tangent, so
// every product is rounded on its own, as the plain version's are; a
// fused multiply-add (1 - a_z a_z) would move them across.
__device__ void plane_cylinder(const Pair& q, Slot* out) {
  const V n = q.R1.col(2), axis = q.R2.col(2);
  const float na = dot_rn(n, axis);
  float nrm;
  const V pn_v = normalize_rn(n - scale_rn(axis, na), &nrm);
  const V rad = nrm > 1e-6f ? scale_rn(pn_v, -q.s2.x) : scale_rn(q.R2.col(0), q.s2.x);
  const float pn = dot_rn(q.p1, n);
  float tn;
  const V t1n = normalize_rn(axis - scale_rn(n, na), &tn);
  const V tan = tn > 1e-8f ? t1n : nan3();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const V e = q.p2 + scale_rn(axis, (s == 0 ? 1.f : -1.f) * q.s2.y) + rad;
    const float dist = dot_rn(e, n) - pn;
    out[s] = {dist, e - scale_rn(n, 0.5f * dist), n, tan};
  }
}

// One end-sphere probe of a cylinder (or capsule) against a hull
// (collision_vec._sphere_hull_probe with _point_hull_depth): the sphere of
// radius s1.x at t s1.y along geom 1's axis (t = -1 or 1), its centre in
// the hull's frame, the first-index argmax of n.x + d over the hull's nf
// face rows hf = (nf, 4) (a NaN first; padding rows have d = -1e10 and
// never win), then the distance, the normal from the sphere into the hull
// and the point. Rounded as the plain version's separate operators are.
__device__ Slot sphere_hull_probe(const Pair& q, float t,
                                  const float* __restrict__ hf, int nf) {
  const V c = q.p1 + scale_rn(q.R1.col(2), t * q.s1.y);
  const V cl = q.R2.mulT_rn(c - q.p2);
  float best = 0.f;
  int bi = 0;
  for (int f = 0; f < nf; ++f) {
    const float4 h = __ldg(reinterpret_cast<const float4*>(hf) + f);
    const float d = dot_rn({h.x, h.y, h.z}, cl) + h.w;
    if (f == 0 || (best == best && (d > best || d != d))) {
      best = d;
      bi = f;
    }
  }
  const float4 h = __ldg(reinterpret_cast<const float4*>(hf) + bi);
  const V n = q.R2.mul_rn({h.x, h.y, h.z}) * -1.f;
  const float r = q.s1.x, dist = best - r;
  return {dist, c + scale_rn(n, r + 0.5f * dist), n, nan3()};
}

// One corner of box a against box b's faces: the face distance (positive
// inside), and the normal of the nearest face (first index, NaN first).
__device__ __forceinline__ float corner_in_box(V w, V pb, const Mat& Rb, V sb,
                                               V* n_world) {
  const V l = Rb.mulT_rn(w - pb);
  const float fd[3] = {sb.x - fabsf(l.x), sb.y - fabsf(l.y), sb.z - fabsf(l.z)};
  int k = 0;
#pragma unroll
  for (int i = 1; i < 3; ++i)
    if (fd[k] == fd[k] && (fd[i] < fd[k] || fd[i] != fd[i])) k = i;
  const float sgn = jsign(k == 0 ? l.x : (k == 1 ? l.y : l.z));
  *n_world = (k == 0 ? Rb.col(0) : (k == 1 ? Rb.col(1) : Rb.col(2))) * sgn;
  return jmin(jmin(fd[0], fd[1]), fd[2]);
}

// Corners of box a inside box b, the 4 deepest: vertex-face contacts with
// normals sign * box b's outward face normal (collision_vec._box_box).
__device__ void verts_in_box(V pa, const Mat& Ra, V sa, V pb, const Mat& Rb,
                             V sb, float sign, int row, float* S, int* picks,
                             int w, bool live, const Out& o) {
  smallest4<true, 8>(
      S, picks, w, live,
      [&](int c) {
        V nw;
        const float pen =
            corner_in_box(pa + Ra.mul_rn(corner_off(c, sa)), pb, Rb, sb, &nw);
        return pen > 0.f ? -pen : kBig;
      },
      [&](int s, int pick, float val) {
        const V wv = pa + Ra.mul_rn(corner_off(pick, sa));
        V nw;
        corner_in_box(wv, pb, Rb, sb, &nw);
        const V n = nw * sign;
        const float depth = val < 0.f ? val : 0.f;
        o.store(row + s, val, wv - n * (0.5f * depth), n, nan3());
      });
}

__device__ __forceinline__ float clip01(float x) { return jmin(jmax(x, 0.f), 1.f); }

// collision_vec._seg_seg_closest
__device__ void seg_seg_closest(V a1, V b1, V a2, V b2, V* q1, V* q2) {
  const V d1 = b1 - a1, d2 = b2 - a2, r = a1 - a2;
  const float A = dot_rn(d1, d1), e = dot_rn(d2, d2), f = dot_rn(d2, r);
  const float c = dot_rn(d1, r), b = dot_rn(d1, d2);
  const float denom = __fmul_rn(A, e) - __fmul_rn(b, b);
  float s = fabsf(denom) > 1e-12f
                ? (__fmul_rn(b, f) - __fmul_rn(c, e)) / (denom == 0.f ? 1.f : denom)
                : 0.f;
  s = clip01(s);
  float t = e > 1e-12f ? (__fmul_rn(b, s) + f) / jmax(e, 1e-12f) : 0.f;
  t = clip01(t);
  s = clip01(A > 1e-12f ? (__fmul_rn(b, t) - c) / jmax(A, 1e-12f) : 0.f);
  *q1 = a1 + scale_rn(d1, s);
  *q2 = a2 + scale_rn(d2, t);
}

__device__ __forceinline__ float support(const Mat& R, V s, V a) {
  return __fmul_rn(fabsf(dot_rn(a, R.col(0))), s.x) +
         __fmul_rn(fabsf(dot_rn(a, R.col(1))), s.y) +
         __fmul_rn(fabsf(dot_rn(a, R.col(2))), s.z);
}

// Edge axis (i, j) of box-box, box 1's edge i across box 2's edge j: its
// separation (-_BIG where the edges are parallel) and the midpoint of the
// supporting edges' closest points; the axis points from box 1 into box 2.
__device__ void edge_axis(const Pair& q, V d12, int i, int j, float* sep_out,
                          V* pos, V* n) {
  const V e1 = q.R1.col(i), e2 = q.R2.col(j);
  float alen;
  V a = normalize_rn(cross_rn(e1, e2), &alen);
  a = a * (dot_rn(a, d12) >= 0.f ? 1.f : -1.f);  // from box1 into box2
  float sep = dot_rn(a, d12) - (support(q.R1, q.s1, a) + support(q.R2, q.s2, a));
  sep = alen > 1e-6f ? sep : -kBig;
  // supporting edge centres (zero-sign components stay centred)
  V c1 = q.p1, c2 = q.p2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k != i) c1 = c1 + scale_rn(q.R1.col(k), jsign(dot_rn(a, q.R1.col(k))) * comp(q.s1, k));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k != j) c2 = c2 - scale_rn(q.R2.col(k), jsign(dot_rn(a, q.R2.col(k))) * comp(q.s2, k));
  }
  const V o1 = scale_rn(e1, comp(q.s1, i)), o2 = scale_rn(e2, comp(q.s2, j));
  V q1, q2;
  seg_seg_closest(c1 - o1, c1 + o1, c2 - o2, c2 + o2, &q1, &q2);
  *sep_out = sep;
  *pos = (q1 + q2) * 0.5f;
  *n = a;
}

// The edge-edge slot of box-box (collision_vec._box_box_edge): SAT over the
// 9 edge cross axes, kept only where an edge axis separates no less than
// every face axis. All in the _rn forms: an edge axis along a face axis
// ties with it in exact arithmetic. Warp w makes face axes w, w + 4 and
// edge axes w, w + 4, w + 8 (edge axis 3 i + j); warp 0 then takes the
// face separation as the running jnp.maximum over the 6 in order and the
// edge axes in order as the formula does (the first always, a later one
// where it separates more, NaN never): the comparison is neither
// associative nor NaN-symmetric, so it is not a tree reduction.
__device__ void box_box_edge(const Pair& q, int row, float* S, int w,
                             bool live, const Out& o) {
  const V d12 = q.p2 - q.p1;
  if (live) {
    for (int f = w; f < 6; f += kNpWarps) {
      const V a = f < 3 ? q.R1.col(f) : q.R2.col(f - 3);
      S[32 * f] = fabsf(dot_rn(a, d12)) - (support(q.R1, q.s1, a) + support(q.R2, q.s2, a));
    }
    for (int x = w; x < 9; x += kNpWarps) {
      float sep;
      V p, n;
      edge_axis(q, d12, x / 3, x % 3, &sep, &p, &n);
      float* e = S + 32 * (6 + 7 * x);
      e[0] = sep;
      e[32] = p.x;
      e[64] = p.y;
      e[96] = p.z;
      e[128] = n.x;
      e[160] = n.y;
      e[192] = n.z;
    }
  }
  __syncthreads();
  if (w != 0 || !live) return;
  float face_sep = 0.f;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float sep = S[32 * f];
    face_sep = f == 0 ? sep : jmax(face_sep, sep);
  }
  float best_sep = 0.f;
  V best_pos = {0.f, 0.f, 0.f}, best_n = {0.f, 0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 9; ++x) {
    const float* e = S + 32 * (6 + 7 * x);
    const float sep = e[0];
    if (x == 0 || sep > best_sep) {
      best_sep = sep;
      best_pos = {e[32], e[64], e[96]};
      best_n = {e[128], e[160], e[192]};
    }
  }
  float dist = best_sep >= face_sep ? best_sep : kBig;
  dist = best_sep <= -kBig / 2.f ? kBig : dist;
  o.store(row, dist, best_pos, best_n, nan3());
}

// box-box's part: 0 box 2's corners in box 1, 1 box 1's in box 2, 2 the
// edge slot
__device__ __forceinline__ void box_box_part(const Pair& q, int part,
                                             float* S, int* picks, int w,
                                             bool live, const Out& o) {
  if (part == 0)
    verts_in_box(q.p2, q.R2, q.s2, q.p1, q.R1, q.s1, 1.f, q.row, S, picks, w,
                 live, o);
  else if (part == 1)
    verts_in_box(q.p1, q.R1, q.s1, q.p2, q.R2, q.s2, -1.f, q.row + 4, S,
                 picks, w, live, o);
  else
    box_box_edge(q, q.row + 8, S, w, live, o);
}

// ---------------------------------------------------------------------------
// The sphere, capsule and cylinder pairs (kinds 10-13), every product
// rounded on its own as the plain version's operators round them.
// ---------------------------------------------------------------------------

// collision_vec._sphere_sphere_at: the normal from c1 to c2, +z where the
// centres coincide (d0 <= 1e-9).
__device__ Slot sphere_sphere_at(V c1, float r1, V c2, float r2) {
  float d0;
  const V nrm = normalize_rn(c2 - c1, &d0);
  const V n = d0 > 1e-9f ? nrm : V{0.f, 0.f, 1.f};
  const float dist = d0 - r1 - r2;
  return {dist, c1 + scale_rn(n, r1 + 0.5f * dist), n, nan3()};
}

// sphere-capsule (collision_vec._sphere_capsule with _closest_on_seg): the
// sphere against the closest point of the capsule's segment a-b.
__device__ Slot sphere_capsule(const Pair& q) {
  const V ax = scale_rn(q.R2.col(2), q.s2.y);
  const V a = q.p2 - ax, ab = (q.p2 + ax) - a;
  const float t = clip01(dot_rn(q.p1 - a, ab) / jmax(dot_rn(ab, ab), 1e-12f));
  return sphere_sphere_at(q.p1, q.s1.x, a + scale_rn(ab, t), q.s2.x);
}

// capsule-capsule (collision_vec._capsule_capsule): the segments' closest
// points (seg_seg_closest, also box-box's edge slot's) as spheres.
__device__ Slot capsule_capsule(const Pair& q) {
  const V o1 = scale_rn(q.R1.col(2), q.s1.y), o2 = scale_rn(q.R2.col(2), q.s2.y);
  V c1, c2;
  seg_seg_closest(q.p1 - o1, q.p1 + o1, q.p2 - o2, q.p2 + o2, &c1, &c2);
  return sphere_sphere_at(c1, q.s1.x, c2, q.s2.x);
}

// collision_vec._point_cylinder: the signed distance of point P to the
// cylinder at (pc, Rc) of radius s.x and half height s.y; with FULL also
// the closest surface point and the outward normal there. The branches
// keep the formula's thresholds: rlen > 1e-9 (else the radial direction is
// the x axis), z >= 0 for the cap's side, dn > 1e-9 at the rim, dr > dz
// inside.
struct CylPoint {
  float sd;
  V surf, n;
};
template <bool FULL>
__device__ __forceinline__ CylPoint point_cylinder(V P, V pc, const Mat& Rc,
                                                   V s) {
  const V q = Rc.mulT_rn(P - pc);
  const float z = q.z;
  const float rlen = sqrtf(jmax(__fmul_rn(q.x, q.x) + __fmul_rn(q.y, q.y), 0.f));
  const float safe = jmax(rlen, 1e-12f);
  const bool on_r = rlen > 1e-9f;
  const float rx = on_r ? q.x / safe : 1.f, ry = on_r ? q.y / safe : 0.f;
  const float dr = rlen - s.x, dz = fabsf(z) - s.y;
  const bool out_r = dr > 0.f, out_z = dz > 0.f, both = out_r && out_z;
  CylPoint o;
  o.sd = both ? sqrtf(__fmul_rn(dr, dr) + __fmul_rn(dz, dz))
              : (out_r ? dr : (out_z ? dz : jmax(dr, dz)));
  if constexpr (FULL) {
    const float zs = z >= 0.f ? 1.f : -1.f;
    const bool lat_wins = dr > dz;
    const float rmin = jmin(rlen, s.x);
    const V lat = {__fmul_rn(rx, s.x), __fmul_rn(ry, s.x), jmin(jmax(z, -s.y), s.y)};
    const V cap = {__fmul_rn(rx, rmin), __fmul_rn(ry, rmin), zs * s.y};
    const V rim = {lat.x, lat.y, zs * s.y};
    const V loc = both ? rim : (out_r ? lat : (out_z ? cap : (lat_wins ? lat : cap)));
    o.surf = pc + Rc.mul_rn(loc);
    const V n_lat = Rc.mul_rn({rx, ry, 0.f});
    const V n_cap = Rc.col(2) * zs;
    float dn;
    const V n_away = normalize_rn(P - o.surf, &dn);
    o.n = both ? (dn > 1e-9f ? n_away : n_lat)
               : (out_r ? n_lat : (out_z ? n_cap : (lat_wins ? n_lat : n_cap)));
  }
  return o;
}

// capsule-cylinder (collision_vec._capsule_cylinder): a ternary search of
// 24 rounds for t along the capsule's axis (two point-cylinder distances a
// round, the right third dropped on a tie), then the sphere of the
// capsule's radius at t against the cylinder (_sphere_cylinder_at). The
// comparison sd(m1) > sd(m2) is decided by rounding wherever sd is flat
// along the axis (a capsule parallel to the cylinder's side, or across a
// cap), where a flip moves the point by up to the capsule's half length:
// so the probes, the distances and (hi - lo) / 3 are rounded as the plain
// version's operators round them (IEEE division and square root).
__device__ Slot capsule_cylinder(V p1, const Mat& R1, V s1, V p2,
                                 const Mat& R2, V s2) {
  const V ax = R1.col(2);
  float lo = -1.f, hi = 1.f;
#pragma unroll 1
  for (int it = 0; it < 24; ++it) {
    const float m1 = lo + (hi - lo) / 3.f;
    const float m2 = hi - (hi - lo) / 3.f;
    const float f1 = point_cylinder<false>(p1 + scale_rn(ax, __fmul_rn(m1, s1.y)), p2, R2, s2).sd;
    const float f2 = point_cylinder<false>(p1 + scale_rn(ax, __fmul_rn(m2, s1.y)), p2, R2, s2).sd;
    const bool go_right = f1 > f2;
    lo = go_right ? m1 : lo;
    hi = go_right ? hi : m2;
  }
  const float t = 0.5f * (lo + hi);
  const V c = p1 + scale_rn(ax, __fmul_rn(t, s1.y));
  const CylPoint cp = point_cylinder<true>(c, p2, R2, s2);
  const V n = cp.n * -1.f;
  return {cp.sd - s1.x, ((c + scale_rn(n, s1.x)) + cp.surf) * 0.5f, n, nan3()};
}

// cylinder-cylinder (collision_vec._cylinder_cylinder), a cooperative
// item: warp 0 searches cylinder 1 as a capsule against cylinder 2, warp 1
// cylinder 2 against cylinder 1 (its normal turned into cylinder 2), each
// into shared rows (dist, pos, normal); warp 0 keeps a's where d_a >= d_b.
__device__ void cylinder_cylinder(const Pair& q, float* S, int w, bool live,
                                  const Out& o) {
  if (live && w < 2) {
    const Slot s = w == 0 ? capsule_cylinder(q.p1, q.R1, q.s1, q.p2, q.R2, q.s2)
                          : capsule_cylinder(q.p2, q.R2, q.s2, q.p1, q.R1, q.s1);
    const V n = w == 0 ? s.n : s.n * -1.f;
    float* e = S + 32 * 7 * w;
    e[0] = s.dist;
    e[32] = s.pos.x;
    e[64] = s.pos.y;
    e[96] = s.pos.z;
    e[128] = n.x;
    e[160] = n.y;
    e[192] = n.z;
  }
  __syncthreads();
  if (w != 0 || !live) return;
  const float* e = S[0] >= S[32 * 7] ? S : S + 32 * 7;
  o.store(q.row, e[0], {e[32], e[64], e[96]}, {e[128], e[160], e[192]}, nan3());
}

// A block: 32 envs (one a lane) and one task of the table, four warp items
// (8 column + part, -1 idle; plane-sphere, plane-capsule, sphere-box, a
// sphere (part) of capsule-box or cylinder-box, plane-hull,
// plane-cylinder, an end-sphere probe (part) of cylinder-hull or
// capsule-hull, capsule-capsule, capsule-cylinder, sphere-capsule), or one cooperative
// item that every warp holds plus kCoop (plane-box, a part of box-box,
// cylinder-cylinder). The kinds are numbered as physics/narrowphase.py's
// KINDS. BOXES = false compiles the primitive kinds alone (plane-sphere,
// plane-capsule, sphere-box, capsule-box): a table of those only then
// runs at their registers, not at those of the candidate formulas.
// Capsule-hull is cylinder-hull's formula (the reference's
// _make_capsule_hull reads a capsule's size as a cylinder's: radius, half
// length): one more kind on the kCylinderHull case.
template <bool BOXES>
__global__ void __launch_bounds__(kNpWarps * 32)
narrowphase_kernel(const float* __restrict__ P, const float* __restrict__ Rm,
                   const float* __restrict__ size, long long ss0,
                   long long ss1, long long ssb, const int* __restrict__ sel,
                   const int* __restrict__ pairs, const int* __restrict__ lens,
                   const int* __restrict__ lists, int L, int C,
                   const int* __restrict__ tasks,
                   const int* __restrict__ geom_hull,
                   const float* __restrict__ hull_vert, int nhv,
                   const float* __restrict__ hull_face, int nhf,
                   float* __restrict__ dist, float* __restrict__ pos,
                   float* __restrict__ frame, int B) {
  __shared__ float sh[kShRows * kNpEnvs];
  __shared__ int spick[4 * kNpEnvs];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kNpEnvs + lane;
  const int* task = tasks + kNpWarps * blockIdx.y;
  const int item = task[w];
  const size_t sB = (size_t)B;
  const Out o{dist, pos, frame, sB, b};
  Pair q;
  if (task[0] < kCoop) {   // four solo items (uniform in the block)
    if (b >= B || item < 0) return;
    load_pair(item >> 3, b, sB, P, Rm, size, ss0, ss1, ssb, sel, pairs, lens,
              lists, L, C, q);
    const int part = item & 7;
    switch (q.kind) {
      case 0: {  // plane-sphere
        const Slot s = plane_sphere(q.p1, q.R1, q.p2, q.s2);
        o.store(q.row, s.dist, s.pos, s.n, s.t);
        break;
      }
      case 1: {  // plane-capsule
        Slot s[2];
        plane_capsule(q.p1, q.R1, q.p2, q.R2, q.s2, s);
        o.store(q.row, s[0].dist, s[0].pos, s[0].n, s[0].t);
        o.store(q.row + 1, s[1].dist, s[1].pos, s[1].n, s[1].t);
        break;
      }
      case 2: {  // sphere-box
        const Slot s = sphere_box_at(q.p1, q.s1.x, q.p2, q.R2, q.s2);
        o.store(q.row, s.dist, s.pos, s.n, s.t);
        break;
      }
      case 3:  // capsule-box: sphere k at the capsule's ends and centre
      case kCylinderBox: {  // cylinder-box: the same (collision_vec._dispatch)
        const V ax = q.R1.col(2);
        const Slot s = sphere_box_at(q.p1 + scale_rn(ax, (float)(part - 1) * q.s1.y),
                                     q.s1.x, q.p2, q.R2, q.s2);
        o.store(q.row + part, s.dist, s.pos, s.n, s.t);
        break;
      }
      case kPlaneCylinder:
        if constexpr (BOXES) {
          Slot s[2];
          plane_cylinder(q, s);
          o.store(q.row, s[0].dist, s[0].pos, s[0].n, s[0].t);
          o.store(q.row + 1, s[1].dist, s[1].pos, s[1].n, s[1].t);
        }
        break;
      case kCylinderHull:  // the probe at the axis' -end (part 0) or +end
      case kCapsuleHull:
        if constexpr (BOXES) {
          const Slot s = sphere_hull_probe(
              q, part == 0 ? -1.f : 1.f,
              hull_face + (size_t)geom_hull[q.g2] * nhf * 4, nhf);
          o.store(q.row + part, s.dist, s.pos, s.n, s.t);
        }
        break;
      case kCapsuleCapsule:
        if constexpr (BOXES) {
          const Slot s = capsule_capsule(q);
          o.store(q.row, s.dist, s.pos, s.n, s.t);
        }
        break;
      case kCapsuleCylinder:
        if constexpr (BOXES) {
          const Slot s = capsule_cylinder(q.p1, q.R1, q.s1, q.p2, q.R2, q.s2);
          o.store(q.row, s.dist, s.pos, s.n, s.t);
        }
        break;
      case kSphereCapsule:
        if constexpr (BOXES) {
          const Slot s = sphere_capsule(q);
          o.store(q.row, s.dist, s.pos, s.n, s.t);
        }
        break;
      default:  // plane-hull
        if constexpr (BOXES)
          plane_hull(q, hull_vert + (size_t)geom_hull[q.g2] * nhv * 3, nhv, o);
    }
    return;
  }
  if constexpr (BOXES) {   // a cooperative task
    const int c = (item - kCoop) >> 3, part = (item - kCoop) & 7;
    const bool live = b < B;
    if (live)
      load_pair(c, b, sB, P, Rm, size, ss0, ss1, ssb, sel, pairs, lens, lists,
                L, C, q);
    float* S = sh + lane;
    int* picks = spick + lane;
    if (pairs[c] == kPlaneBox)
      plane_box(q, S, picks, w, live, o);
    else if (pairs[c] == kCylinderCylinder)
      cylinder_cylinder(q, S, w, live, o);
    else
      box_box_part(q, part, S, picks, w, live, o);
  }
}

// Raise topk_select_kernel<KCAP>'s dynamic shared memory limit to smem
// bytes where it is lower (once per new maximum).
template <int KCAP>
cudaError_t topk_allow_smem(int smem) {
  static int allowed = 48 * 1024;   // the default limit
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      topk_select_kernel<KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <int KCAP>
int topk_blocks_per_sm(int smem) {
  int n = 0;
  cudaError_t e = topk_allow_smem<KCAP>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, topk_select_kernel<KCAP>, kTopkWarps * 32, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int KCAP>
int launch_topk(const float* rank, const unsigned char* mask, int* out, int G,
                int maxk, int B, int K, int vec4, int smem, cudaStream_t s) {
  if (smem < topk_smem_bytes(maxk, KCAP)) return -1;
  const cudaError_t e = topk_allow_smem<KCAP>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kTopkTile - 1) / kTopkTile, G);
  topk_select_kernel<KCAP><<<grid, kTopkWarps * 32, smem, s>>>(
      rank, mask, out, maxk, B, K, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory bytes topk_select_kernel<kcap> needs at maxk rows.
int grt_topk_smem_bytes(int maxk, int kcap) {
  return topk_smem_bytes(maxk, kcap);
}

// Blocks of topk_select_kernel<kcap> one SM holds at smem bytes a block.
int grt_topk_blocks_per_sm(int kcap, int smem) {
  return kcap == 8 ? topk_blocks_per_sm<8>(smem)
         : kcap == 16 ? topk_blocks_per_sm<16>(smem)
         : kcap == 24 ? topk_blocks_per_sm<24>(smem) : -1;
}

// vec4: B % 4 == 0 and rank 16-byte aligned (16-byte staging copies); smem:
// the block's shared memory bytes (physics/narrowphase.py::topk_geometry),
// at least grt_topk_smem_bytes(maxk, KCAP).
int grt_topk_select_f32(const float* rank, const unsigned char* mask, int* out,
                        int G, int maxk, int B, int K, int vec4, int smem,
                        void* stream) {
  if (B <= 0 || G <= 0 || maxk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0 && K <= 8) {
    return launch_topk<8>(rank, mask, out, G, maxk, B, K, vec4, smem, s);
  } else if (K > 8 && K <= 16) {
    return launch_topk<16>(rank, mask, out, G, maxk, B, K, vec4, smem, s);
  } else if (K > 16 && K <= 24) {
    return launch_topk<24>(rank, mask, out, G, maxk, B, K, vec4, smem, s);
  }
  return -1;
}

// Blocks of narrowphase_kernel<boxes> one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int grt_narrowphase_blocks_per_sm(int boxes) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, boxes ? narrowphase_kernel<true> : narrowphase_kernel<false>,
      kNpWarps * 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// size strides: geom, component and batch (0 for a model table of Bm = 1).
// pairs: (4, C) int32, lens: (C,), lists: (2, L), tasks: (T, 4) int32
// (physics/narrowphase.py::GroupTable), boxes: whether the table holds a
// kind past the primitive four, geom_hull: (ngeom,) hull id per geom,
// hull_vert: (nhull, nhv, 3) (null without plane-hull groups), hull_face:
// (nhull, nhf, 4), 16-byte aligned (null without cylinder-hull groups).
int grt_narrowphase_f32(const float* P, const float* Rm, const float* size,
                        long long ss0, long long ss1, long long ssb,
                        const int* sel, const int* pairs, const int* lens,
                        const int* lists, int L, int C, const int* tasks,
                        int T, int boxes, const int* geom_hull,
                        const float* hull_vert, int nhv,
                        const float* hull_face, int nhf, float* dist,
                        float* pos, float* frame, int B, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (nhv > kHullV || nhf > kHullF ||
      (reinterpret_cast<size_t>(hull_face) & 15) != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kNpEnvs - 1) / kNpEnvs, T);
  if (boxes)
    narrowphase_kernel<true><<<grid, kNpWarps * 32, 0, s>>>(
        P, Rm, size, ss0, ss1, ssb, sel, pairs, lens, lists, L, C, tasks,
        geom_hull, hull_vert, nhv, hull_face, nhf, dist, pos, frame, B);
  else
    narrowphase_kernel<false><<<grid, kNpWarps * 32, 0, s>>>(
        P, Rm, size, ss0, ss1, ssb, sel, pairs, lens, lists, L, C, tasks,
        geom_hull, hull_vert, nhv, hull_face, nhf, dist, pos, frame, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
