// Forward kinematics of the whole body tree in one launch.
//
// fk_kernel replaces the TPU kernel
//   gymnasium_robotics_tpu/physics/kinematics_pallas.py::_build_kernel
//   (launched by _fk_call, entered through kinematics): the world frames of
//   every body, joint, geom and site from qpos and the mocap poses.
//
// What it computes, per env, bodies in index order (a parent's index is
// below its child's): the body's frame in its parent's, then its joints in
// body_jntadr order (free: position and normalised quaternion from qpos;
// ball: a normalised quaternion about the joint's anchor; slide: along the
// axis by qpos - qpos0; hinge: the half-angle quaternion about the local
// axis, about the anchor), each writing its world anchor and axis; then the
// mocap override (position and normalised quaternion). Then every body's
// rotation matrix, inertial frame, and the geom and site frames, each a
// quaternion turned into a 3x3 matrix. The arithmetic follows the plain
// version, physics/kinematics.py::kinematics_plain (the level pass of
// soa.kinematics), operation for operation.
//
// Where the TPU kernel folds the model's constants into its code as
// immediates, this kernel reads the model's small tables: body
// pos/quat/ipos/iquat, joint pos/axis, qpos0, geom and site pos/quat
// (floats), and the tree's parent, joint range, mocap id, joint type,
// qpos address, geom body and site body (ints). Every thread of a warp
// reads the same entry, so those loads are broadcasts from L1.
//
// Layout and design. One thread per env; the outputs are one batch-last
// buffer (rows, B), element (r, e) at r * B + e, so the 32 threads of a
// warp write each row as 128 contiguous bytes. qpos and the mocap poses
// are read through their element strides, so the caller copies nothing. A
// parent's pose is read back from the xpos/xquat rows this thread has
// already written (parents come first): nothing is held in dynamically
// indexed registers, and no local memory is used.
//
// What bounds it. At FetchPush (nbody 33, njnt 16, ngeom 24, nsite 3,
// nq 22, one mocap body; B = 2048) the function reads 29 floats and writes
// 1344 floats per env (11.2 MB, 3.4 us at the H100's 3.35 TB/s) and does
// about 10k float operations per env (0.3 us at 67 TFLOP/s float32), so
// bytes bound it. One thread per env is 2048 threads, 64 warps over 132
// SMs, so its time is the latency of each thread's dependent chain
// (the depth of the tree times a quaternion product and rotation, then
// ~60 frames), not either rate; raising the parallelism (a warp per env,
// or bodies of a level across lanes) is later work. chip_smoke.py
// measures it against this bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libkinematics.so kinematics.cu
// The entry point launches on the given stream and returns
// cudaGetLastError() (non-zero when the launch was refused).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp a block: 2048 envs spread over 64 SMs

enum { FREE = 0, BALL = 1, SLIDE = 2, HINGE = 3 };

struct FkDims {
  int nbody, njnt, nq, ngeom, nsite;
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

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// v rotated by q: v + w t + qv x t with t = 2 qv x v
__device__ __forceinline__ void qrot(const float q[4], const float v[3],
                                     float out[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float t[3], c[3];
  cross(qv, v, t);
  t[0] *= 2.f;
  t[1] *= 2.f;
  t[2] *= 2.f;
  cross(qv, t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + c[i];
}

__device__ __forceinline__ void qmul(const float a[4], const float b[4],
                                     float out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// q / max(|q|, 1e-12) (math.normalize; NaN propagates)
__device__ __forceinline__ void qnormalize(float q[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float d = (n > 1e-12f || n != n) ? n : 1e-12f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / d;
}

class Env {
 public:
  __device__ Env(float* out, int B, int e) : out_(out), B_(B), e_(e) {}
  __device__ float get(int row) const { return out_[(size_t)row * B_ + e_]; }
  __device__ void put(int row, float v) const { out_[(size_t)row * B_ + e_] = v; }
  __device__ void put3(int row, const float v[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) put(row + c, v[c]);
  }
  // the rotation matrix of q, row-major (math.quat_to_mat)
  __device__ void put_mat(int row, const float q[4]) const {
    const float w = q[0], x = q[1], y = q[2], z = q[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    put(row + 0, 1.f - 2.f * (yy + zz));
    put(row + 1, 2.f * (xy - wz));
    put(row + 2, 2.f * (xz + wy));
    put(row + 3, 2.f * (xy + wz));
    put(row + 4, 1.f - 2.f * (xx + zz));
    put(row + 5, 2.f * (yz - wx));
    put(row + 6, 2.f * (xz - wy));
    put(row + 7, 2.f * (yz + wx));
    put(row + 8, 1.f - 2.f * (xx + yy));
  }

 private:
  float* out_;
  int B_, e_;
};

template <int N>
__device__ __forceinline__ void load(const float* __restrict__ t, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldg(t + i);
}

// The frame (pos + q p_local, q q_local) of a child of (pos, q): geoms,
// sites and inertial frames on their body, a body on its parent.
__device__ __forceinline__ void child_frame(const float pos[3], const float q[4],
                                            const float* __restrict__ lpos,
                                            const float* __restrict__ lquat,
                                            float cpos[3], float cq[4]) {
  float lp[3], lq[4], r[3];
  load(lpos, lp);
  load(lquat, lq);
  qrot(q, lp, r);
#pragma unroll
  for (int c = 0; c < 3; ++c) cpos[c] = pos[c] + r[c];
  qmul(q, lq, cq);
}

// Float table, per-entity records in this order: body (pos 3, quat 4,
// ipos 3, iquat 4), joint (pos 3, axis 3), qpos0, geom (pos 3, quat 4),
// site (pos 3, quat 4). Int table: body (parent, jntadr, jntnum, mocapid),
// joint (type, qposadr), geom body, site body.
__global__ void __launch_bounds__(kThreads)
fk_kernel(const float* __restrict__ qpos, const float* __restrict__ mpos,
          const float* __restrict__ mquat, FkStrides s,
          const float* __restrict__ ftab, const int* __restrict__ itab,
          FkDims n, FkRows r, float* __restrict__ out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const float* fbody = ftab;
  const float* fjnt = fbody + 14 * n.nbody;
  const float* fq0 = fjnt + 6 * n.njnt;
  const float* fgeom = fq0 + n.nq;
  const float* fsite = fgeom + 7 * n.ngeom;
  const int* ibody = itab;
  const int* ijnt = ibody + 4 * n.nbody;
  const int* igeom = ijnt + 2 * n.njnt;
  const int* isite = igeom + n.ngeom;
  const Env o(out, B, e);
  auto q_at = [&](int i) { return qpos[i * s.q_r + e * s.q_b]; };

  {  // the world body
    const float p0[3] = {0.f, 0.f, 0.f}, q0[4] = {1.f, 0.f, 0.f, 0.f};
    o.put3(r.xpos, p0);
#pragma unroll
    for (int c = 0; c < 4; ++c) o.put(r.xquat + c, q0[c]);
  }
  for (int b = 1; b < n.nbody; ++b) {
    const int* ib = ibody + 4 * b;
    const int p = __ldg(ib);
    float ppos[3], pq[4], pos[3], q[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) ppos[c] = o.get(r.xpos + 3 * p + c);
#pragma unroll
    for (int c = 0; c < 4; ++c) pq[c] = o.get(r.xquat + 4 * p + c);
    child_frame(ppos, pq, fbody + 14 * b, fbody + 14 * b + 3, pos, q);

    const int j0 = __ldg(ib + 1), nj = __ldg(ib + 2);
    for (int j = j0; j < j0 + nj; ++j) {
      const int jt = __ldg(ijnt + 2 * j), qa = __ldg(ijnt + 2 * j + 1);
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
        const float qv = q_at(qa) - __ldg(fq0 + qa);
        float a[3];
        qrot(q, ax, axw);
#pragma unroll
        for (int c = 0; c < 3; ++c) pos[c] = pos[c] + axw[c] * qv;
        qrot(q, jp, a);
#pragma unroll
        for (int c = 0; c < 3; ++c) anchor[c] = pos[c] + a[c];
      } else {  // HINGE
        const float qv = q_at(qa) - __ldg(fq0 + qa);
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

    const int mid = __ldg(ib + 3);
    if (mid >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pos[c] = mpos[mid * s.mp_m + c * s.mp_c + e * s.mp_b];
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = mquat[mid * s.mq_m + c * s.mq_c + e * s.mq_b];
      qnormalize(q);
    }
    o.put3(r.xpos + 3 * b, pos);
#pragma unroll
    for (int c = 0; c < 4; ++c) o.put(r.xquat + 4 * b + c, q[c]);
  }

  // rotation matrices and inertial frames of every body
  for (int b = 0; b < n.nbody; ++b) {
    float pos[3], q[4], ip[3], iq[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) pos[c] = o.get(r.xpos + 3 * b + c);
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = o.get(r.xquat + 4 * b + c);
    o.put_mat(r.xmat + 9 * b, q);
    child_frame(pos, q, fbody + 14 * b + 7, fbody + 14 * b + 10, ip, iq);
    o.put3(r.xipos + 3 * b, ip);
    o.put_mat(r.ximat + 9 * b, iq);
  }

  // geom and site frames on their bodies
  for (int k = 0; k < n.ngeom + n.nsite; ++k) {
    const bool geom = k < n.ngeom;
    const int i = geom ? k : k - n.ngeom;
    const int b = __ldg(geom ? igeom + i : isite + i);
    const float* f = geom ? fgeom + 7 * i : fsite + 7 * i;
    float pos[3], q[4], gp[3], gq[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) pos[c] = o.get(r.xpos + 3 * b + c);
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = o.get(r.xquat + 4 * b + c);
    child_frame(pos, q, f, f + 3, gp, gq);
    o.put3((geom ? r.gpos : r.spos) + 3 * i, gp);
    o.put_mat((geom ? r.gmat : r.smat) + 9 * i, gq);
  }
}

}  // namespace

extern "C" {

// strides: the element strides of qpos (2), mocap_pos (3) and mocap_quat
// (3), in that order. dims: nbody, njnt, nq, ngeom, nsite. rows: the row
// offsets of the eleven outputs in out (see FkRows).
int grt_fk_f32(const float* qpos, const float* mocap_pos,
               const float* mocap_quat, const long long* strides,
               const float* ftab, const int* itab, const int* dims,
               const int* rows, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  const long long* p = strides;
  const FkStrides st{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const FkDims n{dims[0], dims[1], dims[2], dims[3], dims[4]};
  const FkRows r{rows[0], rows[1], rows[2], rows[3], rows[4], rows[5],
                 rows[6], rows[7], rows[8], rows[9], rows[10]};
  fk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      qpos, mocap_pos, mocap_quat, st, ftab, itab, n, r, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
