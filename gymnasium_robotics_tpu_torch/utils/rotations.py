"""Rotation math the Fetch observations read (port of
gymnasium_robotics_tpu/utils/rotations.py ``mat2euler`` :58; intrinsic
'xyz' Euler angles, leading batch dimensions)."""

from __future__ import annotations

import torch

# float32 eps * 4 in every dtype, as the reference's constant
_EPS = float(torch.finfo(torch.float32).eps) * 4.0


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
