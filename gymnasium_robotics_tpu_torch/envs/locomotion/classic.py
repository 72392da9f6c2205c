"""Humanoid (and HumanoidStandup), the pendulums, Reacher and Pusher with
Gymnasium v5 semantics (port of
gymnasium_robotics_tpu/envs/locomotion/classic.py).

Reacher and Pusher draw their goal or object position by masked fixed-K
resampling (the reference's rejection loops, reacher_v5 and pusher_v5):
K = 8 candidates a reset, the first that passes taken. The draws come from
the caller's ``torch.Generator``; every method acts on the whole batch.
"""

from __future__ import annotations

import torch

from gymnasium_robotics_tpu_torch.envs.locomotion.locomotion import (
    LocoConfig, LocomotionEnv, _flat, _sumsq)

K_DRAWS = 8   # candidates of the masked fixed-K goal and object draws


def _mass_center_xy(model, data):
    """(B, 2) mass centre of every body."""
    m = model.body_mass[:, None]                       # (nbody, 1, 1)
    return (torch.sum(m * data.xipos, dim=0) / torch.sum(m))[:2].T


def _first_ok(cands, ok):
    """The first candidate of each env that passes, else candidate 0:
    cands (B, K, 2), ok (B, K) -> (B, 2), and whether any passed."""
    pick = torch.argmax(ok.to(torch.int8), dim=1)
    return cands[torch.arange(cands.shape[0], device=cands.device), pick], ok.any(dim=1)


class HumanoidEnv(LocomotionEnv):
    """gymnasium humanoid_v5: obs = qpos[2:] ++ qvel ++ cinert[1:] ++
    cvel[1:] ++ qfrc_actuator[6:] ++ cfrc_ext[1:]; forward velocity of the
    mass center. With ``standup`` humanoidstandup_v5: the reward is the
    torso's height over the timestep, and it never terminates."""

    def __init__(self, standup=False, max_episode_steps=None,
                 dtype=torch.float32, device=None):
        cfg = LocoConfig(
            xml="humanoidstandup" if standup else "humanoid", frame_skip=5,
            forward_reward_weight=1.25, ctrl_cost_weight=0.1,
            contact_cost_weight=5e-7, healthy_reward=5.0,
            healthy_z_range=(1.0, 2.0), reset_noise_scale=1e-2,
            reset_qvel_mode="uniform", exclude_xy=2, include_cfrc=True,
            terminate_when_unhealthy=not standup,
        )
        self.standup = standup
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)

    def _obs_dim(self):
        mt = self.model.meta
        nb = mt.nbody - 1
        return (mt.nq - 2) + mt.nv + nb * 10 + nb * 6 + (mt.nv - 6) + nb * 6

    def _get_obs(self, data):
        return torch.cat([data.qpos[2:].T, data.qvel.T, _flat(data.cinert[1:]),
                          _flat(data.cvel[1:]), data.qfrc_actuator[6:].T,
                          _flat(data.cfrc_ext[1:])], dim=-1)

    def _standup_reward(self, data_after, action):
        """(reward, uph, quad_ctrl, quad_impact) of humanoidstandup."""
        uph = data_after.qpos[2] / self.model.meta.opt.timestep
        quad_ctrl = 0.1 * _sumsq(action)
        quad_impact = torch.clamp(
            0.5e-6 * torch.sum(torch.square(data_after.cfrc_ext), dim=(0, 1)),
            max=10.0)
        return uph - quad_ctrl - quad_impact + 1.0, uph, quad_ctrl, quad_impact

    def _reward(self, data_before, data_after, action, obs):
        cfg = self.cfg
        if self.standup:
            reward = self._standup_reward(data_after, action)[0]
            z = torch.zeros_like(reward)
            info = {"x_position": data_after.qpos[0],
                    "y_position": data_after.qpos[1],
                    "x_velocity": z, "y_velocity": z.clone()}
            return reward, torch.zeros_like(reward, dtype=torch.bool), info
        xy_b = _mass_center_xy(self.model, data_before)
        xy_a = _mass_center_xy(self.model, data_after)
        vel = (xy_a - xy_b) / self.dt
        healthy = self._is_healthy(data_after, obs)
        reward = cfg.forward_reward_weight * vel[:, 0] + cfg.healthy_reward * healthy
        reward = reward - cfg.ctrl_cost_weight * _sumsq(action)
        # humanoid_v5 contact cost: raw cfrc_ext, the cost clipped to <= 10
        reward = reward - torch.clamp(
            cfg.contact_cost_weight * torch.sum(
                torch.square(data_after.cfrc_ext), dim=(0, 1)), max=10.0)
        info = {"x_position": data_after.qpos[0],
                "y_position": data_after.qpos[1],
                "x_velocity": vel[:, 0], "y_velocity": vel[:, 1]}
        terminated = ~healthy & cfg.terminate_when_unhealthy
        return reward, terminated, info


class InvertedPendulumEnv(LocomotionEnv):
    def __init__(self, max_episode_steps=None, dtype=torch.float32, device=None):
        cfg = LocoConfig(
            xml="inverted_pendulum", frame_skip=2,
            reset_noise_scale=0.01, reset_qvel_mode="uniform", exclude_xy=0,
        )
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)

    def _obs_dim(self):
        return self.model.meta.nq + self.model.meta.nv

    def _get_obs(self, data):
        return torch.cat([data.qpos.T, data.qvel.T], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        terminated = (torch.abs(data_after.qpos[1]) > 0.2) | ~torch.isfinite(
            obs).all(dim=-1)
        reward = torch.ones_like(data_after.qpos[1])
        return reward, terminated, {"reward_survive": reward}

    def _zero_info(self, data):
        return {"reward_survive": torch.zeros_like(data.qpos[0])}


class InvertedDoublePendulumEnv(LocomotionEnv):
    def __init__(self, max_episode_steps=None, dtype=torch.float32, device=None):
        cfg = LocoConfig(
            xml="inverted_double_pendulum", frame_skip=5,
            healthy_reward=10.0, reset_noise_scale=0.1,
            reset_qvel_mode="normal", exclude_xy=0,
        )
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)

    def _obs_dim(self):
        # 1 cart position + sin/cos of 2 hinges + 3 qvel + 1 constraint force
        # (gymnasium v5's documented 9-dim obs)
        return 9

    def _get_obs(self, data):
        return torch.cat([
            data.qpos[:1].T, torch.sin(data.qpos[1:]).T, torch.cos(data.qpos[1:]).T,
            torch.clamp(data.qvel, -10, 10).T,
            torch.clamp(data.qfrc_constraint, -10, 10)[:1].T], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        x, y = data_after.site_xpos[0, 0], data_after.site_xpos[0, 2]
        terminated = y <= 1.0
        v1, v2 = data_after.qvel[1], data_after.qvel[2]
        dist_penalty = 0.01 * x ** 2 + (y - 2) ** 2
        vel_penalty = 1e-3 * v1 ** 2 + 5e-3 * v2 ** 2
        alive = 10.0 * (~terminated)
        reward = alive - dist_penalty - vel_penalty
        return reward, terminated, {"reward_survive": alive.to(x.dtype)}

    def _zero_info(self, data):
        return {"reward_survive": torch.zeros_like(data.qpos[0])}


class ReacherEnv(LocomotionEnv):
    def __init__(self, max_episode_steps=None, dtype=torch.float32, device=None):
        cfg = LocoConfig(xml="reacher", frame_skip=2, reset_noise_scale=0.1,
                         exclude_xy=0)
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)
        names = self.model.meta.body_names
        self._fingertip = names.index("fingertip")
        self._target = names.index("target")

    def _obs_dim(self):
        return 10

    def _tip_vec(self, data):
        """(B, 3) fingertip - target."""
        return (data.xpos[self._fingertip] - data.xpos[self._target]).T

    def _get_obs(self, data):
        theta = data.qpos[:2]
        return torch.cat([torch.cos(theta).T, torch.sin(theta).T,
                          data.qpos[2:].T, data.qvel[:2].T,
                          self._tip_vec(data)[:, :2]], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        reward_dist = -torch.linalg.vector_norm(self._tip_vec(data_after), dim=-1)
        reward_ctrl = -_sumsq(action)
        info = {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl}
        return (reward_dist + reward_ctrl,
                torch.zeros_like(reward_dist, dtype=torch.bool), info)

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        return {"reward_dist": z, "reward_ctrl": z.clone()}

    def _draw(self, n, generator):
        """qpos0 + U(-0.1, 0.1); the goal (qpos[-2:]) the first of K_DRAWS
        candidates in U(-0.2, 0.2)^2 inside the disk of radius 0.2, or
        candidate 0 halved if none is (reacher_v5's rejection loop);
        qvel U(-0.005, 0.005), the goal's 0."""
        mt = self.model.meta
        qpos = self.model.qpos0[:, 0] + self._uniform((n, mt.nq), -0.1, 0.1,
                                                      generator)
        cands = self._uniform((n, K_DRAWS, 2), -0.2, 0.2, generator)
        goal, any_ok = _first_ok(
            cands, torch.linalg.vector_norm(cands, dim=-1) < 0.2)
        qpos[:, -2:] = goal * torch.where(any_ok, 1.0, 0.5)[:, None]
        qvel = self._uniform((n, mt.nv), -0.005, 0.005, generator)
        qvel[:, -2:] = 0.0
        return qpos, qvel


class PusherEnv(LocomotionEnv):
    def __init__(self, max_episode_steps=None, dtype=torch.float32, device=None):
        cfg = LocoConfig(xml="pusher_v5", frame_skip=5, reset_noise_scale=0.005,
                         exclude_xy=0)
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)
        names = self.model.meta.body_names
        self._tips = names.index("tips_arm")
        self._object = names.index("object")
        self._goal = names.index("goal")

    def _obs_dim(self):
        return 23

    def _get_obs(self, data):
        return torch.cat([data.qpos[:7].T, data.qvel[:7].T,
                          data.xpos[self._tips].T, data.xpos[self._object].T,
                          data.xpos[self._goal].T], dim=-1)

    def _dists(self, data):
        """(|object - tips|, |object - goal|), (B,) each."""
        obj = data.xpos[self._object]
        return (torch.linalg.vector_norm(obj - data.xpos[self._tips], dim=0),
                torch.linalg.vector_norm(obj - data.xpos[self._goal], dim=0))

    def _reward(self, data_before, data_after, action, obs):
        near, dist = self._dists(data_after)
        reward_near = -near * 0.5
        reward_dist = -dist
        reward_ctrl = -_sumsq(action) * 0.1
        info = {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl,
                "reward_near": reward_near}
        return (reward_dist + reward_ctrl + reward_near,
                torch.zeros_like(reward_dist, dtype=torch.bool), info)

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        return {"reward_dist": z, "reward_ctrl": z.clone(),
                "reward_near": z.clone()}

    def _draw(self, n, generator):
        """qpos0 with the object (qpos[-4:-2]) the first of K_DRAWS
        candidates, x in U(-0.3, 0) and y in U(-0.2, 0.2), at least 0.17
        from the goal at the origin (candidate 0 if none is; pusher_v5's
        rejection loop), the goal's joints 0; qvel U(-0.005, 0.005), the
        object's and the goal's 0."""
        mt = self.model.meta
        qpos = self.model.qpos0[:, 0].expand(n, -1).clone()
        cx = self._uniform((n, K_DRAWS, 1), -0.3, 0.0, generator)
        cy = self._uniform((n, K_DRAWS, 1), -0.2, 0.2, generator)
        cands = torch.cat([cx, cy], dim=-1)
        obj, _ = _first_ok(cands, torch.linalg.vector_norm(cands, dim=-1) > 0.17)
        qpos[:, -4:-2] = obj
        qpos[:, -2:] = 0.0
        qvel = self._uniform((n, mt.nv), -0.005, 0.005, generator)
        qvel[:, -4:] = 0.0
        return qpos, qvel


def make_humanoid(**kw):
    return HumanoidEnv(standup=False, **kw)


def make_humanoid_standup(**kw):
    return HumanoidEnv(standup=True, **kw)


def make_inverted_pendulum(**kw):
    return InvertedPendulumEnv(**kw)


def make_inverted_double_pendulum(**kw):
    return InvertedDoublePendulumEnv(**kw)


def make_reacher(**kw):
    return ReacherEnv(**kw)


def make_pusher(**kw):
    return PusherEnv(**kw)
