// Forward kinematics of the whole body tree in one launch.
//
// fk_kernel replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/kinematics_pallas.py::_build_kernel
//   (launched by _fk_call, entered through kinematics): the world frames of
//   every body, joint, geom and site from qpos and the mocap poses.
//
// What it computes, per env: each body's frame in its parent's, then its
// joints in body_jntadr order (free: position and normalised quaternion
// from qpos; ball: a normalised quaternion about the joint's anchor; slide:
// along the axis by qpos - qpos0; hinge: the half-angle quaternion about
// the local axis, about the anchor), each writing its world anchor and
// axis; then the mocap override (position and normalised quaternion). Then
// every body's rotation matrix, inertial frame, and the geom and site
// frames, each a quaternion turned into a 3x3 matrix. The arithmetic
// follows the plain version, physics/kinematics.py::kinematics_plain (the
// level pass of soa.kinematics), operation for operation; every frame is
// computed by the same expressions (child_frame, qrot, qmul, qnormalize,
// put_mat) as the one-thread-an-env kernel this design replaced, with
// their roundings pinned (Rounding, below), so its outputs are that
// kernel's bit for bit.
//
// Where the TPU kernel folds the model's constants into its code as
// immediates, this kernel reads the model's small tables: body
// pos/quat/ipos/iquat, joint pos/axis, qpos0, geom and site pos/quat
// (floats), and the tree's parent, joint range, mocap id, joint type,
// qpos address, geom body and site body (ints), with a task schedule.
//
// What bounds it. At FetchPush (nbody 33, njnt 16, ngeom 24, nsite 3,
// nq 22, one mocap body; B = 2048) the function reads 29 floats and writes
// 1344 floats per env (11.2 MB, 3.4 us at the H100's 3.35 TB/s) and does
// about 10k float operations per env (0.3 us at 67 TFLOP/s float32), so
// bytes bound it. Walked one thread an env, its time was the latency of
// each thread's chain: 32 bodies one after the other, each reading its
// parent's pose back from device memory, then 93 frames in series.
//
// Layout and design. A block takes a tile of kFkTile = 32 consecutive envs
// (lane = env) and kFkSlots = 16 task slots, a warp each (512 threads).
// The outputs are one batch-last buffer (rows, B), element (r, e) at
// r * B + e, so a slot writes each row as 32 contiguous floats. (A tile of
// 16 envs, 128 blocks at B = 2048 with two slots a warp, was slower.)
// - Staging: the block first copies the model's tables, the tile's qpos
//   and its mocap poses (through their element strides, so the caller
//   copies nothing) into shared memory, one coalesced pass.
// - The walk goes by tree level, from a schedule built once on the host
//   (physics/kinematics.py::_KernelTables): step s holds the bodies at
//   depth s, one task a body with its joints in body_jntadr order, so the
//   chain is the tree's depth (13 body steps at FetchPush, not 32). The
//   tile's body poses (xpos 3 + xquat 4 a body) live in shared memory and
//   a barrier ends each step.
// - The frames (xmat, inertial, geom and site: 93 at FetchPush) are
//   independent tasks, each reading its body's pose from shared memory.
//   The schedule puts each into the first step after its body's with a
//   slot to spare, then the rest in one last step, so they fill the slots
//   the narrow levels leave idle.
// Shared memory: (7 nbody + nq + 7 nmocap) 32 floats and the two tables
// (FkLayout): 37.7 KB a block at FetchPush.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkinematics.so kinematics.cu
// The entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused), or -1 for
// too little shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kFkTile = 32;   // envs a block, one a lane
constexpr int kFkSlots = 16;  // task slots a block, a warp each

enum { FREE = 0, BALL = 1, SLIDE = 2, HINGE = 3 };

// The kinds of the schedule's tasks (physics/kinematics.py::TASK_KINDS).
struct FkTask {
  enum { BODY = 0, XMAT = 1, INERTIAL = 2, GEOM = 3, SITE = 4 };
};

// The model's sizes, the tables' lengths (floats, ints) and the
// schedule's steps and tasks.
struct FkDims {
  int nbody, njnt, nq, ngeom, nsite, nmocap, nfloat, nint, nsteps, ntasks;
};

// Element strides of qpos (row, batch) and of the mocap poses (mocap,
// component, batch).
struct FkStrides {
  long long q_r, q_b, mp_m, mp_c, mp_b, mq_m, mq_c, mq_b;
};

// Row offsets of the eleven outputs in the (rows, B) buffer, in the order
// xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, geom_xpos, geom_xmat,
// site_xpos, site_xmat.
struct FkRows {
  int xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, gpos, gmat, spos, smat;
};

// Rounding. Each sum of products below (and the slide joint's
// pos + axis qv) is written with intrinsics (__fmaf_rn, __fmul_rn,
// __fadd_rn, __fsub_rn), which the compiler never contracts or reorders,
// in the form nvcc's contraction gave the one-thread-an-env kernel this
// design replaced (read from its SASS): a + b c fused; a b + c d and
// a b - c d one fused multiply-add of a b on the rounded c d, then each
// further product fused in turn; in put_mat, whose products are shared,
// as its comment says. Written as plain expressions, the same arithmetic
// in this kernel compiled to other contractions (1-ulp differences in the
// quaternions and matrices); pinned, the outputs are that kernel's bit
// for bit whatever code surrounds these helpers.

// a x b
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// v rotated by q: v + w t + qv x t with t = 2 qv x v
__device__ __forceinline__ void qrot(const float q[4], const float v[3],
                                     float out[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float t[3], c[3];
  cross(qv, v, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = __fadd_rn(t[i], t[i]);
  cross(qv, t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = __fadd_rn(__fmaf_rn(q[0], t[i], v[i]), c[i]);
}

// a b (math.quat_mul)
__device__ __forceinline__ void qmul(const float a[4], const float b[4],
                                     float out[4]) {
  out[0] = __fmaf_rn(-a[3], b[3], __fmaf_rn(-a[2], b[2],
           __fmaf_rn(a[0], b[0], -__fmul_rn(a[1], b[1]))));
  out[1] = __fmaf_rn(-a[3], b[2], __fmaf_rn(a[2], b[3],
           __fmaf_rn(a[0], b[1], __fmul_rn(a[1], b[0]))));
  out[2] = __fmaf_rn(a[3], b[1], __fmaf_rn(a[2], b[0],
           __fmaf_rn(a[0], b[2], -__fmul_rn(a[1], b[3]))));
  out[3] = __fmaf_rn(a[3], b[0], __fmaf_rn(-a[2], b[1],
           __fmaf_rn(a[0], b[3], __fmul_rn(a[1], b[2]))));
}

// q / max(|q|, 1e-12) (math.normalize; NaN propagates)
__device__ __forceinline__ void qnormalize(float q[4]) {
  const float n = sqrtf(__fmaf_rn(q[3], q[3], __fmaf_rn(q[2], q[2],
                        __fmaf_rn(q[0], q[0], __fmul_rn(q[1], q[1])))));
  const float d = (n > 1e-12f || n != n) ? n : 1e-12f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / d;
}

// One env's column of the output buffer; stores past B are dropped.
class Env {
 public:
  __device__ Env(float* out, int B, int e) : out_(out), B_(B), e_(e) {}
  __device__ void put(int row, float v) const {
    if (e_ < B_) out_[(size_t)row * B_ + e_] = v;
  }
  __device__ void put3(int row, const float v[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) put(row + c, v[c]);
  }
  // The rotation matrix of q, row-major (math.quat_to_mat), rounded as the
  // note above says: yy + zz unfused, each other sum one fused
  // multiply-add; doubling is exact.
  __device__ void put_mat(int row, const float q[4]) const {
    const float w = q[0], x = q[1], y = q[2], z = q[3];
    auto twice = [](float v) { return __fadd_rn(v, v); };
    auto one_minus_twice = [](float v) {
      return __fsub_rn(1.f, __fadd_rn(v, v));
    };
    put(row + 0, one_minus_twice(__fadd_rn(__fmul_rn(y, y), __fmul_rn(z, z))));
    put(row + 1, twice(__fmaf_rn(x, y, -__fmul_rn(w, z))));
    put(row + 2, twice(__fmaf_rn(w, y, __fmul_rn(x, z))));
    put(row + 3, twice(__fmaf_rn(x, y, __fmul_rn(w, z))));
    put(row + 4, one_minus_twice(__fmaf_rn(x, x, __fmul_rn(z, z))));
    put(row + 5, twice(__fmaf_rn(y, z, -__fmul_rn(w, x))));
    put(row + 6, twice(__fmaf_rn(-w, y, __fmul_rn(x, z))));
    put(row + 7, twice(__fmaf_rn(y, z, __fmul_rn(w, x))));
    put(row + 8, one_minus_twice(__fmaf_rn(x, x, __fmul_rn(y, y))));
  }

 private:
  float* out_;
  int B_, e_;
};

template <int N>
__device__ __forceinline__ void load(const float* t, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i];
}

// The frame (pos + q p_local, q q_local) of a child of (pos, q): geoms,
// sites and inertial frames on their body, a body on its parent.
__device__ __forceinline__ void child_frame(const float pos[3], const float q[4],
                                            const float* lpos,
                                            const float* lquat,
                                            float cpos[3], float cq[4]) {
  float lp[3], lq[4], r[3];
  load(lpos, lp);
  load(lquat, lq);
  qrot(q, lp, r);
#pragma unroll
  for (int c = 0; c < 3; ++c) cpos[c] = pos[c] + r[c];
  qmul(q, lq, cq);
}

// Shared memory of one block (4-byte words), in this order: the tile's
// body poses (xpos 3 + xquat 4 a body, word (7 b + c) kFkTile + e), its
// qpos (i kFkTile + e) and mocap poses ((7 m + c) kFkTile + e), the float
// table and the int table. With a warp's lanes on consecutive envs, a
// warp's loads and stores of one row never share a bank.
struct FkLayout {
  static constexpr int threads = kFkSlots * kFkTile;
  __host__ __device__ static int q(const FkDims& n) {
    return 7 * n.nbody * kFkTile;
  }
  __host__ __device__ static int mocap(const FkDims& n) {
    return q(n) + n.nq * kFkTile;
  }
  __host__ __device__ static int ftab(const FkDims& n) {
    return mocap(n) + 7 * n.nmocap * kFkTile;
  }
  __host__ __device__ static int itab(const FkDims& n) {
    return ftab(n) + n.nfloat;
  }
  __host__ __device__ static int words(const FkDims& n) {
    return itab(n) + n.nint;
  }
};

// Float table, per-entity records in this order: body (pos 3, quat 4,
// ipos 3, iquat 4), joint (pos 3, axis 3), qpos0, geom (pos 3, quat 4),
// site (pos 3, quat 4). Int table: body (parent, jntadr, jntnum, mocapid),
// joint (type, qposadr), geom body, site body, then the schedule: the
// nsteps + 1 offsets of each step's tasks, and the tasks, each
// kind << 16 | index (FkTask).
__global__ void __launch_bounds__(kFkSlots * kFkTile)
fk_kernel(const float* __restrict__ qpos, const float* __restrict__ mpos,
          const float* __restrict__ mquat, FkStrides s,
          const float* __restrict__ ftab_g, const int* __restrict__ itab_g,
          FkDims n, FkRows r, float* __restrict__ out, int B) {
  using L = FkLayout;
  extern __shared__ __align__(16) float fsm[];
  float* pose = fsm;
  float* qs = fsm + L::q(n);
  float* ms = fsm + L::mocap(n);
  float* ftab = fsm + L::ftab(n);
  int* itab = reinterpret_cast<int*>(fsm + L::itab(n));
  const int tid = threadIdx.x, slot = tid / kFkTile, lane = tid % kFkTile;
  auto at = [&](int row) { return row * kFkTile + lane; };  // this env's word
  const int e0 = blockIdx.x * kFkTile;
  const int e = e0 + lane;

  // staging: the tables, the tile's qpos and mocap poses (envs past B: 0)
  for (int i = tid; i < n.nfloat; i += L::threads) ftab[i] = __ldg(ftab_g + i);
  for (int i = tid; i < n.nint; i += L::threads) itab[i] = __ldg(itab_g + i);
  for (int i = tid; i < n.nq * kFkTile; i += L::threads) {
    const int row = i / kFkTile, ee = e0 + i % kFkTile;
    qs[i] = ee < B ? qpos[row * s.q_r + ee * s.q_b] : 0.f;
  }
  for (int i = tid; i < 7 * n.nmocap * kFkTile; i += L::threads) {
    const int mc = i / kFkTile, m = mc / 7, c = mc % 7;
    const int ee = e0 + i % kFkTile;
    float v = 0.f;
    if (ee < B)
      v = c < 3 ? mpos[m * s.mp_m + c * s.mp_c + ee * s.mp_b]
                : mquat[m * s.mq_m + (c - 3) * s.mq_c + ee * s.mq_b];
    ms[i] = v;
  }
  const Env o(out, B, e);
  if (slot == 0) {  // the world body
    const float p0[3] = {0.f, 0.f, 0.f}, q0[4] = {1.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) pose[at(c)] = p0[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) pose[at(3 + c)] = q0[c];
    o.put3(r.xpos, p0);
#pragma unroll
    for (int c = 0; c < 4; ++c) o.put(r.xquat + c, q0[c]);
  }
  __syncthreads();

  const float* fbody = ftab;
  const float* fjnt = fbody + 14 * n.nbody;
  const float* fq0 = fjnt + 6 * n.njnt;
  const float* fgeom = fq0 + n.nq;
  const float* fsite = fgeom + 7 * n.ngeom;
  const int* ibody = itab;
  const int* ijnt = ibody + 4 * n.nbody;
  const int* igeom = ijnt + 2 * n.njnt;
  const int* isite = igeom + n.ngeom;
  const int* steps = isite + n.nsite;
  const int* tasks = steps + n.nsteps + 1;
  auto q_at = [&](int i) { return qs[at(i)]; };
  auto get_pose = [&](int b, float pos[3], float q[4]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pos[c] = pose[at(7 * b + c)];
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = pose[at(7 * b + 3 + c)];
  };

  for (int st = 0; st < n.nsteps; ++st) {
    for (int t = steps[st] + slot; t < steps[st + 1]; t += kFkSlots) {
      const int task = tasks[t], kind = task >> 16, idx = task & 0xffff;
      if (kind == FkTask::BODY) {
        const int b = idx;
        const int* ib = ibody + 4 * b;
        const int p = ib[0];
        float ppos[3], pq[4], pos[3], q[4];
        get_pose(p, ppos, pq);
        child_frame(ppos, pq, fbody + 14 * b, fbody + 14 * b + 3, pos, q);

        const int j0 = ib[1], nj = ib[2];
        for (int j = j0; j < j0 + nj; ++j) {
          const int jt = ijnt[2 * j], qa = ijnt[2 * j + 1];
          float jp[3], ax[3], anchor[3], axw[3];
          load(fjnt + 6 * j, jp);
          load(fjnt + 6 * j + 3, ax);
          if (jt == FREE) {
#pragma unroll
            for (int c = 0; c < 3; ++c) pos[c] = q_at(qa + c);
#pragma unroll
            for (int c = 0; c < 4; ++c) q[c] = q_at(qa + 3 + c);
            qnormalize(q);
#pragma unroll
            for (int c = 0; c < 3; ++c) anchor[c] = pos[c];
            qrot(q, ax, axw);
          } else if (jt == BALL) {
            float dq[4], nq[4], a[3], back[3];
#pragma unroll
            for (int c = 0; c < 4; ++c) dq[c] = q_at(qa + c);
            qnormalize(dq);
            qrot(q, jp, a);
#pragma unroll
            for (int c = 0; c < 3; ++c) anchor[c] = pos[c] + a[c];
            qmul(q, dq, nq);
            qrot(nq, jp, back);
#pragma unroll
            for (int c = 0; c < 3; ++c) pos[c] = anchor[c] - back[c];
#pragma unroll
            for (int c = 0; c < 4; ++c) q[c] = nq[c];
            qrot(q, ax, axw);
          } else if (jt == SLIDE) {
            const float qv = q_at(qa) - fq0[qa];
            float a[3];
            qrot(q, ax, axw);
#pragma unroll
            for (int c = 0; c < 3; ++c) pos[c] = __fmaf_rn(axw[c], qv, pos[c]);
            qrot(q, jp, a);
#pragma unroll
            for (int c = 0; c < 3; ++c) anchor[c] = pos[c] + a[c];
          } else {  // HINGE
            const float qv = q_at(qa) - fq0[qa];
            const float half = 0.5f * qv;
            const float sn = sinf(half);
            const float dq[4] = {cosf(half), ax[0] * sn, ax[1] * sn, ax[2] * sn};
            float a[3], nq[4], back[3];
            qrot(q, ax, axw);
            qrot(q, jp, a);
#pragma unroll
            for (int c = 0; c < 3; ++c) anchor[c] = pos[c] + a[c];
            qmul(q, dq, nq);
            qrot(nq, jp, back);
#pragma unroll
            for (int c = 0; c < 3; ++c) pos[c] = anchor[c] - back[c];
#pragma unroll
            for (int c = 0; c < 4; ++c) q[c] = nq[c];
          }
          o.put3(r.xanchor + 3 * j, anchor);
          o.put3(r.xaxis + 3 * j, axw);
        }

        const int mid = ib[3];
        if (mid >= 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) pos[c] = ms[at(7 * mid + c)];
#pragma unroll
          for (int c = 0; c < 4; ++c) q[c] = ms[at(7 * mid + 3 + c)];
          qnormalize(q);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) pose[at(7 * b + c)] = pos[c];
#pragma unroll
        for (int c = 0; c < 4; ++c) pose[at(7 * b + 3 + c)] = q[c];
        o.put3(r.xpos + 3 * b, pos);
#pragma unroll
        for (int c = 0; c < 4; ++c) o.put(r.xquat + 4 * b + c, q[c]);
      } else if (kind == FkTask::XMAT) {  // a body's rotation matrix
        float pos[3], q[4];
        get_pose(idx, pos, q);
        o.put_mat(r.xmat + 9 * idx, q);
      } else {  // an inertial, geom or site frame on its body
        const float* f;
        int b, prow, mrow;
        if (kind == FkTask::INERTIAL) {
          b = idx;
          f = fbody + 14 * idx + 7;
          prow = r.xipos;
          mrow = r.ximat;
        } else if (kind == FkTask::GEOM) {
          b = igeom[idx];
          f = fgeom + 7 * idx;
          prow = r.gpos;
          mrow = r.gmat;
        } else {
          b = isite[idx];
          f = fsite + 7 * idx;
          prow = r.spos;
          mrow = r.smat;
        }
        float pos[3], q[4], cp[3], cq[4];
        get_pose(b, pos, q);
        child_frame(pos, q, f, f + 3, cp, cq);
        o.put3(prow + 3 * idx, cp);
        o.put_mat(mrow + 9 * idx, cq);
      }
    }
    __syncthreads();
  }
}

int launch_fk(const float* qpos, const float* mpos, const float* mquat,
              const FkStrides& st, const float* ftab, const int* itab,
              const FkDims& n, const FkRows& r, float* out, int B, int smem,
              cudaStream_t s) {
  using L = FkLayout;
  if (smem < 4 * L::words(n)) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fk_kernel<<<(B + kFkTile - 1) / kFkTile, L::threads, smem, s>>>(
      qpos, mpos, mquat, st, ftab, itab, n, r, out, B);
  return static_cast<int>(cudaGetLastError());
}

int fk_blocks_per_sm(int smem) {
  int nb = 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, fk_kernel, FkLayout::threads, smem);
  return e == cudaSuccess ? nb : -static_cast<int>(e);
}

FkDims dims_of(const int* d) {
  return FkDims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9]};
}

}  // namespace

extern "C" {

// strides: the element strides of qpos (2), mocap_pos (3) and mocap_quat
// (3), in that order. dims: nbody, njnt, nq, ngeom, nsite, nmocap, the
// float and int tables' lengths, the schedule's steps and tasks (FkDims).
// rows: the row offsets of the eleven outputs in out (see FkRows). smem:
// the block's shared memory bytes (physics/kinematics.py::fk_geometry),
// at least grt_fk_smem_bytes.
int grt_fk_f32(const float* qpos, const float* mocap_pos,
               const float* mocap_quat, const long long* strides,
               const float* ftab, const int* itab, const int* dims,
               const int* rows, float* out, int B, int smem, void* stream) {
  if (B <= 0) return 0;
  const long long* p = strides;
  const FkStrides st{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const FkRows r{rows[0], rows[1], rows[2], rows[3], rows[4], rows[5],
                 rows[6], rows[7], rows[8], rows[9], rows[10]};
  return launch_fk(qpos, mocap_pos, mocap_quat, st, ftab, itab, dims_of(dims),
                   r, out, B, smem, static_cast<cudaStream_t>(stream));
}

// Shared memory bytes of an fk_kernel block for the dims (as grt_fk_f32
// takes them), and the blocks one SM holds at smem bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int grt_fk_smem_bytes(const int* dims) {
  return 4 * FkLayout::words(dims_of(dims));
}
int grt_fk_blocks_per_sm(int smem) { return fk_blocks_per_sm(smem); }

}  // extern "C"
