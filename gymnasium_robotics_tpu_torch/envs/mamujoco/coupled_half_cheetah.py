"""CoupledHalfCheetah: two half-cheetahs joined by an elastic spatial
tendon (port of gymnasium_robotics_tpu/envs/mamujoco/coupled_half_cheetah.py
``CoupledHalfCheetahEnv`` :81-140).

The scene (mjcf/build_locomotion.py ``coupled_cheetah_xml``: gymnasium's
half_cheetah.xml cloned, the cheetahs at y = -1 and +1, a site-to-site
tendon between their torsos, limited to 1.5-3.5, stiffness 0.1) is
compiled on the host into the port's own model file
``assets/locomotion/coupled_half_cheetah.npz``, which the env reads. The
reward is the average of the two cheetahs' HalfCheetah rewards; the
episode never terminates. Observation (40 wide): both cheetahs' qpos but
their root x, qvel, the tendon Jacobian's columns 0, 1, 9 and 10, its
length and its velocity. Every method acts on the whole batch, as the
locomotion envs' do.
"""

from __future__ import annotations

import torch

from gymnasium_robotics_tpu_torch.envs.locomotion.locomotion import (
    LocoConfig, LocomotionEnv, _sumsq)
from gymnasium_robotics_tpu_torch.mjcf.build_locomotion import COUPLED

TEN_J_COLS = (0, 1, 9, 10)   # the tendon Jacobian's columns in the observation


class CoupledHalfCheetahEnv(LocomotionEnv):
    def __init__(self, max_episode_steps=None, dtype=torch.float32, device=None):
        cfg = LocoConfig(
            xml=COUPLED, frame_skip=5, ctrl_cost_weight=0.1,
            reset_noise_scale=0.1, reset_qvel_mode="normal",
            exclude_xy=1, terminate_when_unhealthy=False, vel_from="qpos_x",
        )
        super().__init__(cfg, max_episode_steps=max_episode_steps, dtype=dtype,
                         device=device)
        self._half_nq = self.model.meta.nq // 2
        self._ten_cols = torch.tensor(TEN_J_COLS, device=self.device)

    def _obs_dim(self):
        mt = self.model.meta
        return (mt.nq - 2) + mt.nv + len(TEN_J_COLS) + 1 + 1

    def _get_obs(self, data):
        h = self._half_nq
        return torch.cat([data.qpos[1:h].T, data.qpos[h + 1:].T, data.qvel.T,
                          data.ten_J[0, self._ten_cols].T, data.ten_length.T,
                          data.ten_velocity.T], dim=-1)

    def _reward(self, data_before, data_after, action, obs):
        h = self._half_nq
        xv1 = (data_after.qpos[0] - data_before.qpos[0]) / self.dt
        xv2 = (data_after.qpos[h] - data_before.qpos[h]) / self.dt
        na = self.model.meta.nu // 2
        ctrl1 = 0.1 * _sumsq(action[:, :na])
        ctrl2 = 0.1 * _sumsq(action[:, na:])
        forward = (xv1 + xv2) / 2.0
        reward = forward - (ctrl1 + ctrl2) / 2.0
        info = {"x_position1": data_after.qpos[0],
                "x_position2": data_after.qpos[h],
                "x_velocity1": xv1, "x_velocity2": xv2,
                "reward_run": forward,
                "reward_ctrl1": ctrl1, "reward_ctrl2": ctrl2}
        return reward, torch.zeros_like(reward, dtype=torch.bool), info

    def _zero_info(self, data):
        z = torch.zeros_like(data.qpos[0])
        return {"x_position1": data.qpos[0],
                "x_position2": data.qpos[self._half_nq],
                "x_velocity1": z, "x_velocity2": z.clone(),
                "reward_run": z.clone(), "reward_ctrl1": z.clone(),
                "reward_ctrl2": z.clone()}


def make_coupled_half_cheetah(**kw):
    return CoupledHalfCheetahEnv(**kw)
