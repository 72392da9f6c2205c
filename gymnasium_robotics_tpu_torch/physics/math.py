"""Batch-last math (port of gymnasium_robotics_tpu/physics/soa.py:53-200).

Component axis at -2, batch axis at -1: vectors (..., 3, B), quaternions
(..., 4, B), matrices (..., 3, 3, B) (rows, cols), spatial 6-vectors
(..., 6, B), cinert (..., 10, B). Model constants carry a trailing axis
Bm in {1, B} and broadcast.
"""

from __future__ import annotations

import torch


def bB(x, B):
    """Broadcast a trailing-Bm tensor to a full batch (a view)."""
    return x.expand(*x.shape[:-1], B)


def cross3(a, b):
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2
    )


def quat_mul(u, v):
    w1, x1, y1, z1 = u[..., 0, :], u[..., 1, :], u[..., 2, :], u[..., 3, :]
    w2, x2, y2, z2 = v[..., 0, :], v[..., 1, :], v[..., 2, :], v[..., 3, :]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-2,
    )


def quat_conj(q):
    return torch.cat([q[..., :1, :], -q[..., 1:, :]], dim=-2)


def quat_rot(q, v):
    qv = q[..., 1:, :]
    w = q[..., 0:1, :]
    t = 2.0 * cross3(qv, v)
    return v + w * t + cross3(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-2)
    r1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-2)
    r2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-2)
    return torch.stack([r0, r1, r2], dim=-3)


def normalize(v, eps=1e-12):
    n = torch.sqrt(torch.sum(v * v, dim=-2, keepdim=True))
    return v / torch.clamp(n, min=eps), n[..., 0, :]


def axis_angle_to_quat(axis, angle):
    half = 0.5 * angle
    return torch.cat(
        [torch.cos(half)[..., None, :], axis * torch.sin(half)[..., None, :]],
        dim=-2,
    )


def quat_integrate(q, omega, dt):
    """Rotate q by the angular velocity omega (..., 3, B) over dt, and
    renormalise."""
    angle = torch.sqrt(torch.sum(omega * omega, dim=-2, keepdim=True))
    axis = omega / torch.where(angle > 1e-12, angle, torch.ones_like(angle))
    out = quat_mul(q, axis_angle_to_quat(axis, (angle * dt)[..., 0, :]))
    return out / torch.sqrt(torch.sum(out * out, dim=-2, keepdim=True))


def motion_cross(v, u):
    ang = cross3(v[..., :3, :], u[..., :3, :])
    lin = cross3(v[..., :3, :], u[..., 3:, :]) + cross3(
        v[..., 3:, :], u[..., :3, :]
    )
    return torch.cat([ang, lin], dim=-2)


def motion_cross_force(v, f):
    trq = cross3(v[..., :3, :], f[..., :3, :]) + cross3(
        v[..., 3:, :], f[..., 3:, :]
    )
    frc = cross3(v[..., :3, :], f[..., 3:, :])
    return torch.cat([trq, frc], dim=-2)


def inert_mul(ci, v):
    ixx, iyy, izz = ci[..., 0, :], ci[..., 1, :], ci[..., 2, :]
    ixy, ixz, iyz = ci[..., 3, :], ci[..., 4, :], ci[..., 5, :]
    h = ci[..., 6:9, :]
    m_ = ci[..., 9:10, :]
    w = v[..., :3, :]
    lin = v[..., 3:, :]
    iw = torch.stack(
        [
            ixx * w[..., 0, :] + ixy * w[..., 1, :] + ixz * w[..., 2, :],
            ixy * w[..., 0, :] + iyy * w[..., 1, :] + iyz * w[..., 2, :],
            ixz * w[..., 0, :] + iyz * w[..., 1, :] + izz * w[..., 2, :],
        ],
        dim=-2,
    )
    trq = iw + cross3(h, lin)
    frc = m_ * lin - cross3(h, w)
    return torch.cat([trq, frc], dim=-2)


def inertia_about_point(mass, inertia_diag, ipos, iquat, point):
    """10D com-frame spatial inertia: mass (..., Bm), inertia_diag
    (..., 3, Bm), ipos/point (..., 3, B), iquat (..., 4, B) -> (..., 10, B)."""
    B = iquat.shape[-1]
    R = quat_to_mat(iquat)
    I_com = torch.einsum("...ikb,...kb,...jkb->...ijb", R, bB(inertia_diag, B), R)
    d = ipos - point
    dd = torch.sum(d * d, dim=-2)
    outer = d[..., :, None, :] * d[..., None, :, :]
    eye = torch.eye(3, dtype=I_com.dtype, device=I_com.device)[:, :, None]
    I_o = I_com + mass[..., None, None, :] * (dd[..., None, None, :] * eye - outer)
    h = mass[..., None, :] * d
    six = torch.stack(
        [
            I_o[..., 0, 0, :], I_o[..., 1, 1, :], I_o[..., 2, 2, :],
            I_o[..., 0, 1, :], I_o[..., 0, 2, :], I_o[..., 1, 2, :],
        ],
        dim=-2,
    )
    return torch.cat([six, h, bB(mass[..., None, :], B)], dim=-2)
