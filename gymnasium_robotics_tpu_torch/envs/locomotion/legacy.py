"""Frozen legacy v2/v3 locomotion semantics (port of
gymnasium_robotics_tpu/envs/locomotion/legacy.py).

The reference re-registers 17 mujoco_py-era IDs with their own frozen
observation and reward conventions (gymnasium_robotics/__init__.py
:1123-1261, envs/mujoco/*_v{2,3}.py), on the same compiled models:

- Ant v2/v3 observe the clipped contact forces of every body, the world's
  row included; Humanoid(+Standup) v2/v3 cinert, cvel, qfrc_actuator and
  cfrc_ext of every body and dof.
- Humanoid v2 and v3 reward the mass centre's x velocity; v3 also reports
  xy.
- Reacher and Pusher v2 reward the pre-step state.
- InvertedDoublePendulum v2 observes the whole clipped qvel and all three
  constraint forces.
- The v2/v3 alive bonus is paid while the episode runs
  (``is_healthy or terminate_when_unhealthy``).
- v3 takes the documented option kwargs (forward_reward_weight,
  ctrl_cost_weight, reset_noise_scale,
  exclude_current_positions_from_observation and the healthy_* family);
  v2 is fixed. Each version has its own info keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch.envs.locomotion import classic as C
from gymnasium_robotics_tpu_torch.envs.locomotion.locomotion import (
    LocoConfig, LocomotionEnv, _flat, _sumsq)


def _merge_cfg(cfg: LocoConfig, kwargs: dict, exclude_default: int):
    """Map the reference v3 kwargs onto LocoConfig fields: (cfg, the
    kwargs left over)."""
    kw = dict(kwargs)
    repl = {}
    direct = (
        "forward_reward_weight", "ctrl_cost_weight", "contact_cost_weight",
        "healthy_reward", "terminate_when_unhealthy", "healthy_z_range",
        "healthy_angle_range", "healthy_state_range", "reset_noise_scale",
        "contact_force_range",
    )
    for k in direct:
        if k in kw:
            repl[k] = kw.pop(k)
    if "exclude_current_positions_from_observation" in kw:
        repl["exclude_xy"] = (
            exclude_default
            if kw.pop("exclude_current_positions_from_observation")
            else 0
        )
    kw.pop("contact_cost_range", None)  # humanoid v3: the cost cap stays 10
    kw.pop("xml_file", None)
    return dataclasses.replace(cfg, **repl), kw


def _alive(cfg, healthy):
    """The v2/v3 alive bonus: paid while healthy, or always where an
    unhealthy state ends the episode (hopper_v3.py:87-91)."""
    return cfg.healthy_reward * (healthy | cfg.terminate_when_unhealthy).to(
        torch.float64)


class LegacyRunnerEnv(LocomotionEnv):
    """HalfCheetah, Hopper, Walker2d, Swimmer and Ant, v2 and v3."""

    def __init__(self, cfg, family, version, **kw):
        self.family = family
        self.version = version
        super().__init__(cfg, **kw)

    def _obs_dim(self):
        mt = self.model.meta
        n = (mt.nq - self.cfg.exclude_xy) + mt.nv
        if self.cfg.include_cfrc:
            n += mt.nbody * 6  # legacy ant: every body, the world's too
        return n

    @property
    def observation_structure(self):
        mt = self.model.meta
        return {
            "skipped_qpos": self.cfg.exclude_xy,
            "qpos": mt.nq - self.cfg.exclude_xy,
            "qvel": mt.nv,
            "cfrc_ext": mt.nbody * 6 if self.cfg.include_cfrc else 0,
        }

    def _get_obs(self, data):
        qvel = data.qvel
        if self.cfg.clip_qvel_obs is not None:
            c = self.cfg.clip_qvel_obs
            qvel = torch.clamp(qvel, -c, c)
        parts = [data.qpos[self.cfg.exclude_xy:].T, qvel.T]
        if self.cfg.include_cfrc:
            lo, hi = self.cfg.contact_force_range
            parts.append(_flat(torch.clamp(data.cfrc_ext, lo, hi)))
        return torch.cat(parts, dim=-1)

    def _info_keys(self):
        fam, ver = self.family, self.version
        if fam == "HalfCheetah":
            if ver == "v2":  # half_cheetah_v2.py:44
                return ("reward_run", "reward_ctrl")
            return ("x_position", "x_velocity", "reward_run", "reward_ctrl")
        if fam == "Swimmer":
            if ver == "v2":
                return ("reward_fwd", "reward_ctrl")
            return (
                "reward_fwd", "reward_ctrl", "x_position", "y_position",
                "distance_from_origin", "x_velocity", "y_velocity",
                "forward_reward",
            )
        if fam == "Ant":
            if ver == "v2":
                return (
                    "reward_forward", "reward_ctrl", "reward_contact",
                    "reward_survive",
                )
            return (
                "reward_forward", "reward_ctrl", "reward_contact",
                "reward_survive", "x_position", "y_position",
                "distance_from_origin", "x_velocity", "y_velocity",
                "forward_reward",
            )
        if ver == "v2":  # hopper_v2.py:46 / walker2d_v2.py: info == {}
            return ()
        return ("x_position", "x_velocity")  # hopper/walker2d v3

    def _reward(self, data_before, data_after, action, obs):
        cfg = self.cfg
        if cfg.vel_from == "qpos_x":
            x_b, x_a = data_before.qpos[0], data_after.qpos[0]
            z = torch.zeros_like(x_a)
            vel = torch.stack([(x_a - x_b) / self.dt, z], dim=-1)
            pos_after = torch.stack([x_a, z], dim=-1)
        else:  # ant: the torso body's position
            xy_b = data_before.xpos[cfg.main_body, :2].T
            pos_after = data_after.xpos[cfg.main_body, :2].T
            vel = (pos_after - xy_b) / self.dt
        forward = cfg.forward_reward_weight * vel[:, 0]
        healthy = self._is_healthy(data_after, obs)
        alive = _alive(cfg, healthy).to(forward.dtype)
        ctrl_cost = cfg.ctrl_cost_weight * _sumsq(action)
        contact_cost = torch.zeros_like(forward)
        if cfg.contact_cost_weight:
            lo, hi = cfg.contact_force_range
            cf = torch.clamp(data_after.cfrc_ext, lo, hi)
            contact_cost = cfg.contact_cost_weight * torch.sum(
                torch.square(cf), dim=(0, 1))
        reward = forward + alive - ctrl_cost - contact_cost
        terminated = ~healthy & cfg.terminate_when_unhealthy
        full = {
            "x_position": pos_after[:, 0],
            "y_position": pos_after[:, 1],
            "distance_from_origin": torch.linalg.vector_norm(pos_after, dim=-1),
            "x_velocity": vel[:, 0],
            "y_velocity": vel[:, 1],
            "forward_reward": forward,
            "reward_forward": forward,
            "reward_run": forward,
            "reward_fwd": forward,
            "reward_ctrl": -ctrl_cost,
            "reward_contact": -contact_cost,
            "reward_survive": alive,
        }
        return reward, terminated, {k: full[k] for k in self._info_keys()}

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        return {k: z.clone() for k in self._info_keys()}


class LegacyHumanoidEnv(C.HumanoidEnv):
    """Humanoid v2/v3 and HumanoidStandup v2: the observation of every body
    and dof (humanoid_v2.py:33-46); the mass centre's x velocity
    rewarded (humanoid_v2.py:47-55), v3 also reporting xy."""

    def __init__(self, version="v3", standup=False, **kw):
        self.version = version
        cfg = LocoConfig(
            xml="humanoidstandup" if standup else "humanoid", frame_skip=5,
            forward_reward_weight=1.25, ctrl_cost_weight=0.1,
            contact_cost_weight=5e-7, healthy_reward=5.0,
            healthy_z_range=(1.0, 2.0), reset_noise_scale=1e-2,
            reset_qvel_mode="uniform", exclude_xy=2, include_cfrc=True,
            terminate_when_unhealthy=not standup,
        )
        if version == "v3":
            cfg, kw = _merge_cfg(cfg, kw, exclude_default=2)
        self.standup = standup
        LocomotionEnv.__init__(self, cfg, **kw)

    def _obs_dim(self):
        mt = self.model.meta
        return (
            (mt.nq - self.cfg.exclude_xy) + mt.nv
            + mt.nbody * 10 + mt.nbody * 6 + mt.nv + mt.nbody * 6
        )

    @property
    def observation_structure(self):
        mt = self.model.meta
        return {
            "skipped_qpos": self.cfg.exclude_xy,
            "qpos": mt.nq - self.cfg.exclude_xy, "qvel": mt.nv,
            "cinert": mt.nbody * 10, "cvel": mt.nbody * 6,
            "qfrc_actuator": mt.nv, "cfrc_ext": mt.nbody * 6,
        }

    def _get_obs(self, data):
        return torch.cat([data.qpos[self.cfg.exclude_xy:].T, data.qvel.T,
                          _flat(data.cinert), _flat(data.cvel),
                          data.qfrc_actuator.T, _flat(data.cfrc_ext)], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        cfg = self.cfg
        if self.standup:
            reward, uph, quad_ctrl, quad_impact = self._standup_reward(
                data_after, action)
            info = {"reward_linup": uph, "reward_quadctrl": -quad_ctrl,
                    "reward_impact": -quad_impact}
            return reward, torch.zeros_like(reward, dtype=torch.bool), info
        xy_a = C._mass_center_xy(self.model, data_after)
        vel = (xy_a - C._mass_center_xy(self.model, data_before)) / self.dt
        forward = cfg.forward_reward_weight * vel[:, 0]
        healthy = self._is_healthy(data_after, obs)
        alive = _alive(cfg, healthy).to(forward.dtype)
        quad_ctrl = cfg.ctrl_cost_weight * _sumsq(action)
        quad_impact = torch.clamp(
            cfg.contact_cost_weight * torch.sum(
                torch.square(data_after.cfrc_ext), dim=(0, 1)), max=10.0)
        reward = forward - quad_ctrl - quad_impact + alive
        terminated = ~healthy & cfg.terminate_when_unhealthy
        info = {"reward_linvel": forward, "reward_quadctrl": -quad_ctrl,
                "reward_alive": alive, "reward_impact": -quad_impact}
        if self.version == "v3":
            info.update({
                "x_position": xy_a[:, 0], "y_position": xy_a[:, 1],
                "distance_from_origin": torch.linalg.vector_norm(xy_a, dim=-1),
                "x_velocity": vel[:, 0], "y_velocity": vel[:, 1],
                "forward_reward": forward})
        return reward, terminated, info

    def _is_healthy(self, data, obs):
        # humanoid_v2.py:57: the z bounds only, no finiteness test (v3 adds
        # that of qpos and qvel)
        z = data.qpos[2]
        lo, hi = self.cfg.healthy_z_range
        ok = (z >= lo) & (z <= hi)
        if self.version == "v3":
            ok &= (torch.isfinite(data.qpos).all(dim=0)
                   & torch.isfinite(data.qvel).all(dim=0))
        return ok

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        if self.standup:
            keys = ["reward_linup", "reward_quadctrl", "reward_impact"]
        else:
            keys = ["reward_linvel", "reward_quadctrl", "reward_alive",
                    "reward_impact"]
            if self.version == "v3":
                keys += ["x_position", "y_position", "distance_from_origin",
                         "x_velocity", "y_velocity", "forward_reward"]
        return {k: z.clone() for k in keys}


class LegacyReacherEnv(C.ReacherEnv):
    """Reacher v2: the reward of the pre-step state (reacher_v2.py:25-33)
    and the whole fingertip-target vector in the observation (11-dim,
    reacher_v2.py:66-77)."""

    def _obs_dim(self):
        return 11

    def _get_obs(self, data):
        theta = data.qpos[:2]
        return torch.cat([torch.cos(theta).T, torch.sin(theta).T,
                          data.qpos[2:].T, data.qvel[:2].T,
                          self._tip_vec(data)], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        return super()._reward(None, data_before, action, obs)


class LegacyPusherEnv(C.PusherEnv):
    """Pusher v2: the reward of the pre-step state (pusher_v2.py:25-33)."""

    def _reward(self, data_before, data_after, action, obs):
        near, dist = self._dists(data_before)
        reward_near, reward_dist = -near, -dist
        reward_ctrl = -_sumsq(action)
        reward = reward_dist + 0.1 * reward_ctrl + 0.5 * reward_near
        info = {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl}
        return reward, torch.zeros_like(reward, dtype=torch.bool), info

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        return {"reward_dist": z, "reward_ctrl": z.clone()}


class LegacyIDPEnv(C.InvertedDoublePendulumEnv):
    """InvertedDoublePendulum v2: 11-dim observation with the whole clipped
    qvel and every constraint force (inverted_double_pendulum_v2.py
    :47-58); info == {}."""

    def _obs_dim(self):
        return 11

    def _get_obs(self, data):
        return torch.cat([
            data.qpos[:1].T, torch.sin(data.qpos[1:]).T, torch.cos(data.qpos[1:]).T,
            torch.clamp(data.qvel, -10, 10).T,
            torch.clamp(data.qfrc_constraint, -10, 10).T], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        r, term, _ = super()._reward(data_before, data_after, action, obs)
        return r, term, {}

    def _zero_info(self, data):
        return {}


class LegacyIPEnv(C.InvertedPendulumEnv):
    """InvertedPendulum v2: the same 4-dim observation; info == {}
    (inverted_pendulum_v2.py)."""

    def _reward(self, data_before, data_after, action, obs):
        r, term, _ = super()._reward(data_before, data_after, action, obs)
        return r, term, {}

    def _zero_info(self, data):
        return {}


# --- per-family version configs (reference envs/mujoco/*_v{2,3}.py) ---

def make_legacy_half_cheetah(version="v3", **kw):
    cfg = LocoConfig(
        xml="half_cheetah", frame_skip=5,
        ctrl_cost_weight=0.1, reset_noise_scale=0.1,
        reset_qvel_mode="normal", exclude_xy=1, vel_from="qpos_x",
        terminate_when_unhealthy=False,
    )
    if version == "v3":
        cfg, kw = _merge_cfg(cfg, kw, exclude_default=1)
    return LegacyRunnerEnv(cfg, "HalfCheetah", version, **kw)


def make_legacy_hopper(version="v3", **kw):
    cfg = LocoConfig(
        xml="hopper", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        healthy_z_range=(0.7, float(np.inf)),
        healthy_angle_range=(-0.2, 0.2),
        healthy_state_range=(-100.0, 100.0),
        reset_noise_scale=5e-3, reset_qvel_mode="uniform",
        exclude_xy=1, vel_from="qpos_x", clip_qvel_obs=10.0,
    )
    if version == "v3":
        cfg, kw = _merge_cfg(cfg, kw, exclude_default=1)
    return LegacyRunnerEnv(cfg, "Hopper", version, **kw)


def make_legacy_walker2d(version="v3", **kw):
    cfg = LocoConfig(
        # the legacy walker2d keeps the original model, not the v5 one
        xml="walker2d", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        healthy_z_range=(0.8, 2.0), healthy_angle_range=(-1.0, 1.0),
        reset_noise_scale=5e-3, reset_qvel_mode="uniform",
        exclude_xy=1, vel_from="qpos_x", clip_qvel_obs=10.0,
    )
    if version == "v3":
        cfg, kw = _merge_cfg(cfg, kw, exclude_default=1)
    return LegacyRunnerEnv(cfg, "Walker2d", version, **kw)


def make_legacy_swimmer(version="v3", **kw):
    cfg = LocoConfig(
        xml="swimmer", frame_skip=4,
        ctrl_cost_weight=1e-4, reset_noise_scale=0.1,
        reset_qvel_mode="uniform", exclude_xy=2, vel_from="qpos_x",
        terminate_when_unhealthy=False,
    )
    if version == "v3":
        cfg, kw = _merge_cfg(cfg, kw, exclude_default=2)
    return LegacyRunnerEnv(cfg, "Swimmer", version, **kw)


def make_legacy_ant(version="v3", **kw):
    cfg = LocoConfig(
        xml="ant", frame_skip=5,
        ctrl_cost_weight=0.5, contact_cost_weight=5e-4,
        healthy_reward=1.0, healthy_z_range=(0.2, 1.0),
        reset_noise_scale=0.1, reset_qvel_mode="normal",
        exclude_xy=2, include_cfrc=True, vel_from="body",
    )
    if version == "v3":
        cfg, kw = _merge_cfg(cfg, kw, exclude_default=2)
    return LegacyRunnerEnv(cfg, "Ant", version, **kw)


def make_legacy_humanoid(version="v3", **kw):
    return LegacyHumanoidEnv(version=version, standup=False, **kw)


def make_legacy_humanoid_standup(version="v2", **kw):
    return LegacyHumanoidEnv(version=version, standup=True, **kw)


def make_legacy_reacher(version="v2", **kw):
    return LegacyReacherEnv(**kw)


def make_legacy_pusher(version="v2", **kw):
    return LegacyPusherEnv(**kw)


def make_legacy_inverted_pendulum(version="v2", **kw):
    return LegacyIPEnv(**kw)


def make_legacy_inverted_double_pendulum(version="v2", **kw):
    return LegacyIDPEnv(**kw)


# family -> (maker, versions, max_episode_steps): the reference's 17 legacy
# IDs (gymnasium_robotics/__init__.py:1123-1261)
LEGACY_REGISTRY = {
    "Reacher": (make_legacy_reacher, ("v2",), 50),
    "Pusher": (make_legacy_pusher, ("v2",), 100),
    "InvertedPendulum": (make_legacy_inverted_pendulum, ("v2",), 1000),
    "InvertedDoublePendulum": (
        make_legacy_inverted_double_pendulum, ("v2",), 1000),
    "HalfCheetah": (make_legacy_half_cheetah, ("v2", "v3"), 1000),
    "Hopper": (make_legacy_hopper, ("v2", "v3"), 1000),
    "Swimmer": (make_legacy_swimmer, ("v2", "v3"), 1000),
    "Walker2d": (make_legacy_walker2d, ("v2", "v3"), 1000),
    "Ant": (make_legacy_ant, ("v2", "v3"), 1000),
    "Humanoid": (make_legacy_humanoid, ("v2", "v3"), 1000),
    "HumanoidStandup": (make_legacy_humanoid_standup, ("v2",), 1000),
}
