"""Forward-locomotion envs with Gymnasium-MuJoCo v5 semantics (port of
gymnasium_robotics_tpu/envs/locomotion/locomotion.py: ``LocoConfig``,
``LocomotionEnv``, ``make_ant``, ``make_half_cheetah``, ``make_hopper``,
``make_walker2d`` and ``make_swimmer``).

Each env is config-driven: obs = qpos[skip:] ++ qvel (++ the clipped
contact forces of the bodies but the world), reward = forward velocity +
healthy bonus - control cost - contact cost, terminated when unhealthy
where the config says so. The models are gymnasium's MuJoCo XMLs compiled
on the host into the port's own model files (mjcf/build_locomotion.py);
the envs read those files and import neither ``mujoco`` nor
``gymnasium``. Physics: the model's own options (the unpruned contact
table, the XML's integrator and iterations; the solve takes at most 20
Newton and 8 line-search iterations).

Every method acts on the whole batch: observations (B, obs_dim), rewards
and flags (B,), info a dict of (B,) tensors, ``goal`` (B, 0). A reset
draws qpos0 + U(-s, s) and qvel (normal or uniform, scale s) from the
caller's ``torch.Generator``; ``reset_with_values`` takes qpos and qvel
given by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.mjcf import serialize
from gymnasium_robotics_tpu_torch.physics import pipeline


@dataclasses.dataclass
class LocoConfig:
    xml: str                            # the model file's name (locomotion/<xml>)
    frame_skip: int
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 0.0
    contact_cost_weight: float = 0.0
    contact_force_range: tuple = (-1.0, 1.0)
    healthy_reward: float = 0.0
    terminate_when_unhealthy: bool = True
    healthy_z_range: Optional[tuple] = None
    healthy_angle_range: Optional[tuple] = None
    healthy_state_range: Optional[tuple] = None
    reset_noise_scale: float = 0.1
    reset_qvel_mode: str = "normal"     # "normal" | "uniform" | "none"
    exclude_xy: int = 2                 # leading qpos entries dropped from obs
    include_cfrc: bool = False
    clip_qvel_obs: Optional[float] = None
    main_body: int = 1
    vel_from: str = "qpos_xy"  # "qpos_xy" (free root) | "qpos_x" (planar) | "body"


def _sumsq(x):
    return torch.sum(torch.square(x), dim=-1)


def _flat(x):
    """(n, k, B) batch-last per-body rows -> (B, n k), body-major."""
    return x.reshape(-1, x.shape[-1]).T


class LocomotionEnv:
    """Generic forward-locomotion env (its class docstring in the JAX
    package: obs = qpos[skip:] ++ qvel (++ cfrc), reward = fwd_vel +
    healthy - ctrl_cost - contact_cost)."""

    # parity mode draws no reset values on the host (utils/parity.py has no
    # sampler of this family): the resets are the device's, as in the JAX
    # package
    host_reset_values = False

    def __init__(self, cfg: LocoConfig, max_episode_steps=None,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.device = dev = _device.resolve(device)
        self.dtype = dtype
        self.model, _ = serialize.load_asset(f"locomotion/{cfg.xml}", dtype, dev,
                                             root=serialize.OWN_ASSETS_DIR)
        self.max_episode_steps = max_episode_steps
        mt = self.model.meta
        self.dt = mt.opt.timestep * cfg.frame_skip
        # the action Box's bounds (the model's ctrlrange, float32 as the
        # reference's spaces): GymAdapter builds its action space from them
        cr = self.model.actuator_ctrlrange[..., 0].double().cpu().numpy()
        self.action_low = cr[:, 0].astype(np.float32)
        self.action_high = cr[:, 1].astype(np.float32)
        self.obs_dim = self._obs_dim()
        self.action_dim = mt.nu
        self.metadata = {"render_modes": [],
                         "render_fps": int(round(1.0 / self.dt))}

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _obs_dim(self):
        mt = self.model.meta
        n = (mt.nq - self.cfg.exclude_xy) + mt.nv
        if self.cfg.include_cfrc:
            n += (mt.nbody - 1) * 6
        return n

    # --- obs / reward hooks (overridden per env) ---
    def _get_obs(self, data):
        qvel = data.qvel
        if self.cfg.clip_qvel_obs is not None:
            c = self.cfg.clip_qvel_obs
            qvel = torch.clamp(qvel, -c, c)
        parts = [data.qpos[self.cfg.exclude_xy:].T, qvel.T]
        if self.cfg.include_cfrc:
            lo, hi = self.cfg.contact_force_range
            parts.append(_flat(torch.clamp(data.cfrc_ext[1:], lo, hi)))
        return torch.cat(parts, dim=-1)

    def _finite(self, data, obs):
        return (torch.isfinite(obs).all(dim=-1)
                & torch.isfinite(data.qpos).all(dim=0)
                & torch.isfinite(data.qvel).all(dim=0))

    def _is_healthy(self, data, obs):
        cfg = self.cfg
        healthy = self._finite(data, obs)
        if cfg.healthy_z_range is not None:
            z = data.qpos[self._z_index()]
            healthy &= (z >= cfg.healthy_z_range[0]) & (z <= cfg.healthy_z_range[1])
        if cfg.healthy_angle_range is not None:
            ang = data.qpos[self._angle_index()]
            healthy &= (ang >= cfg.healthy_angle_range[0]) & (
                ang <= cfg.healthy_angle_range[1])
        if cfg.healthy_state_range is not None:
            # gymnasium hopper_v5: state_vector()[2:], strict inequalities
            lo, hi = cfg.healthy_state_range
            state = torch.cat([data.qpos[2:], data.qvel])
            healthy &= ((state > lo) & (state < hi)).all(dim=0)
        return healthy

    def _z_index(self):
        return 2 if self.cfg.exclude_xy == 2 else 1

    def _angle_index(self):
        return 2

    def _xy(self, data):
        """(B, 2) position whose change is the forward velocity: the planar
        root's x (y 0), a body's xpos (v5 ant: the last RK4 stage's, as
        the pipeline's RK4 keeps it) or the free root's qpos xy."""
        cfg = self.cfg
        if cfg.vel_from == "qpos_x":
            x = data.qpos[0]
            return torch.stack([x, torch.zeros_like(x)], dim=-1)
        if cfg.vel_from == "body":
            return data.xpos[cfg.main_body, :2].T
        return data.qpos[:2].T

    def _reward(self, data_before, data_after, action, obs):
        cfg = self.cfg
        vel = (self._xy(data_after) - self._xy(data_before)) / self.dt
        forward = cfg.forward_reward_weight * vel[:, 0]
        healthy = self._is_healthy(data_after, obs)
        reward = forward + cfg.healthy_reward * healthy
        reward = reward - cfg.ctrl_cost_weight * _sumsq(action)
        if cfg.contact_cost_weight:
            lo, hi = cfg.contact_force_range
            cf = torch.clamp(data_after.cfrc_ext, lo, hi)
            reward = reward - cfg.contact_cost_weight * torch.sum(
                torch.square(cf), dim=(0, 1))
        info = {
            "x_position": data_after.qpos[0],
            "y_position": (data_after.qpos[1] if self.model.meta.nq > 1
                           else torch.zeros_like(data_after.qpos[0])),
            "x_velocity": vel[:, 0],
            "y_velocity": vel[:, 1],
        }
        terminated = ~healthy & cfg.terminate_when_unhealthy
        return reward, terminated, info

    def _zero_info(self, data):
        """Reset-time info with the step's keys (auto_reset picks each key
        per env)."""
        z = torch.zeros_like(data.qpos[0])
        return {"x_position": data.qpos[0],
                "y_position": data.qpos[1] if self.model.meta.nq > 1 else z,
                "x_velocity": z, "y_velocity": z.clone()}

    # --- resets ---
    def _uniform(self, shape, lo, hi, generator):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           dtype=self.dtype, device=self.device)

    def _draw(self, n, generator):
        """(qpos (n, nq), qvel (n, nv)) of n fresh episodes."""
        cfg = self.cfg
        mt = self.model.meta
        s = cfg.reset_noise_scale
        qpos = self.model.qpos0[:, 0] + self._uniform((n, mt.nq), -s, s, generator)
        if cfg.reset_qvel_mode == "normal":
            qvel = s * torch.randn((n, mt.nv), generator=generator,
                                   dtype=self.dtype, device=self.device)
        elif cfg.reset_qvel_mode == "uniform":
            qvel = self._uniform((n, mt.nv), -s, s, generator)
        else:
            qvel = torch.zeros((n, mt.nv), dtype=self.dtype, device=self.device)
        return qpos, qvel

    def _reset_state(self, qpos, qvel) -> core.EnvState:
        n = qpos.shape[0]
        data = dataclasses.replace(pipeline.make_data(self.model, n),
                                   qpos=qpos.T.contiguous(), qvel=qvel.T.contiguous())
        data = pipeline.refresh_kin(self.model, data, com=False)
        dev = self.device
        zeros = torch.zeros(n, dtype=torch.bool, device=dev)
        return core.EnvState(
            data=data, obs=self._get_obs(data),
            reward=torch.zeros(n, dtype=self.dtype, device=dev),
            terminated=zeros, truncated=zeros.clone(),
            info=self._zero_info(data),
            goal=torch.zeros((n, 0), dtype=self.dtype, device=dev),
            steps=torch.zeros(n, dtype=torch.int32, device=dev))

    def initial(self, num_envs: int, generator) -> core.EnvState:
        return self._reset_state(*self._draw(num_envs, generator))

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """A reset to the given ``qpos`` (B, nq) and ``qvel`` (B, nv): the
        kinematics refreshed, the observation and the reset's info made."""
        return self._reset_state(self._t(values["qpos"]), self._t(values["qvel"]))

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch: ``frame_skip`` substeps with the
        action (B, nu) as the control (clamped to ctrlrange by the
        actuators)."""
        action = torch.as_tensor(action, dtype=self.dtype, device=self.device)
        data_before = state.data
        data = pipeline.step_n(self.model, data_before, action.T.contiguous(),
                               self.cfg.frame_skip)
        obs = self._get_obs(data)
        reward, terminated, info = self._reward(data_before, data, action, obs)
        return core.EnvState(
            data=data, obs=obs, reward=reward.to(self.dtype),
            terminated=terminated, truncated=torch.zeros_like(terminated),
            info=info, goal=state.goal, steps=state.steps + 1, aux=state.aux)


# --- per-env configs (gymnasium *_v5.py defaults) ---

def make_ant(**over):
    cfg = LocoConfig(
        xml="ant", frame_skip=5,
        ctrl_cost_weight=0.5, contact_cost_weight=5e-4,
        healthy_reward=1.0, healthy_z_range=(0.2, 1.0),
        reset_noise_scale=0.1, reset_qvel_mode="normal",
        exclude_xy=2, include_cfrc=True, vel_from="body",
    )
    return LocomotionEnv(cfg, **over)


def make_half_cheetah(**over):
    cfg = LocoConfig(
        xml="half_cheetah", frame_skip=5,
        ctrl_cost_weight=0.1, reset_noise_scale=0.1,
        reset_qvel_mode="normal", exclude_xy=1, vel_from="qpos_x",
        terminate_when_unhealthy=False,
    )
    return LocomotionEnv(cfg, **over)


def make_hopper(**over):
    cfg = LocoConfig(
        xml="hopper", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        healthy_z_range=(0.7, float(np.inf)),
        healthy_angle_range=(-0.2, 0.2),
        healthy_state_range=(-100.0, 100.0),
        reset_noise_scale=5e-3, reset_qvel_mode="uniform",
        exclude_xy=1, vel_from="qpos_x", clip_qvel_obs=10.0,
    )
    return LocomotionEnv(cfg, **over)


def make_walker2d(**over):
    cfg = LocoConfig(
        xml="walker2d_v5", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        healthy_z_range=(0.8, 2.0), healthy_angle_range=(-1.0, 1.0),
        reset_noise_scale=5e-3, reset_qvel_mode="uniform",
        exclude_xy=1, vel_from="qpos_x", clip_qvel_obs=10.0,
    )
    return LocomotionEnv(cfg, **over)


def make_swimmer(**over):
    cfg = LocoConfig(
        xml="swimmer", frame_skip=4,
        ctrl_cost_weight=1e-4, reset_noise_scale=0.1,
        reset_qvel_mode="uniform", exclude_xy=2,
        terminate_when_unhealthy=False,
    )
    return LocomotionEnv(cfg, **over)
