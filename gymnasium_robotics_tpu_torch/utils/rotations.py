"""Rotation math the env observations and goals read (port of
gymnasium_robotics_tpu/utils/rotations.py ``euler2mat`` :21,
``euler2quat`` :40, ``mat2euler`` :58, ``quat2mat`` :78, ``quat2euler``
:87, ``quat_conjugate`` :100, ``quat_mul`` :105 and
``get_parallel_rotations`` :206; intrinsic 'xyz' Euler angles, wxyz
quaternions, leading batch dimensions)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

# float32 eps * 4 in every dtype, as the reference's constant
_EPS = float(torch.finfo(torch.float32).eps) * 4.0


def euler2mat(euler):
    """(..., 3) Euler angles -> (..., 3, 3) rotation matrices."""
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    out = torch.stack([
        cj * ci, cj * si, -sj,
        sj * cs - sc, sj * ss + cc, cj * sk,
        sj * cc + ss, sj * sc - cs, cj * ck,
    ], dim=-1)
    return out.reshape(euler.shape[:-1] + (3, 3))


def euler2quat(euler):
    """(..., 3) Euler angles -> (..., 4) quaternions."""
    ai, aj, ak = euler[..., 2] / 2, -euler[..., 1] / 2, euler[..., 0] / 2
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack([cj * cc + sj * ss, cj * cs - sj * sc,
                        -(cj * ss + sj * cc), cj * sc - sj * cs], dim=-1)


def mat2euler(mat):
    """(..., 3, 3) rotation matrices -> (..., 3) Euler angles."""
    cy = torch.sqrt(mat[..., 2, 2] ** 2 + mat[..., 1, 2] ** 2)
    cond = cy > _EPS
    ez = torch.where(cond, -torch.atan2(mat[..., 0, 1], mat[..., 0, 0]),
                     -torch.atan2(-mat[..., 1, 0], mat[..., 1, 1]))
    ey = -torch.atan2(-mat[..., 0, 2], cy)
    ex = torch.where(cond, -torch.atan2(mat[..., 1, 2], mat[..., 2, 2]),
                     torch.zeros_like(cy))
    return torch.stack([ex, ey, ez], dim=-1)


def quat2mat(quat):
    """(..., 4) quaternions, normalised (norm floored at _EPS) -> (..., 3, 3)
    rotation matrices."""
    n = torch.sum(quat * quat, dim=-1, keepdim=True)
    q = quat / torch.sqrt(torch.clamp(n, min=_EPS))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat2euler(quat):
    return mat2euler(quat2mat(quat))


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(q0, q1):
    w0, x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    return torch.stack([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], dim=-1)


def get_parallel_rotations():
    """The 24 axis-aligned rotations as Euler angles (numpy (3,) each), in
    the reference's order (its rotations.py:394-408), for 'parallel' goal
    sampling. Host-side helper."""
    mult90 = [0, np.pi / 2, -np.pi / 2, np.pi]
    parallel_rotations = []
    for euler in itertools.product(mult90, repeat=3):
        e = torch.tensor(euler, dtype=torch.float64)
        canonical = mat2euler(euler2mat(e)).numpy()
        canonical = np.round(canonical / (np.pi / 2))
        if canonical[0] == -2:
            canonical[0] = 2
        if canonical[2] == -2:
            canonical[2] = 2
        canonical = canonical * (np.pi / 2)
        if all((canonical != r).any() for r in parallel_rotations):
            parallel_rotations.append(canonical)
    assert len(parallel_rotations) == 24
    return parallel_rotations
