"""Adroit hand family: Door, Hammer, Pen and Relocate (port of
gymnasium_robotics_tpu/envs/adroit/adroit.py; the reference's
adroit_door.py, adroit_hammer.py, adroit_pen.py and adroit_relocate.py).

A 24-joint hand on a 2-6 DoF arm, 24-30 position actuators whose gain and
bias are re-tuned at construction (adroit_door.py:225-252); action (B, nu)
in [-1, 1] scaled about the centre of each actuator's ctrlrange
(adroit_door.py:281-283); 5 Euler substeps an env step. The observation is
a flat vector (door 39, hammer 46, pen 45, relocate 39), the reward staged
and dense or sparse (10 on success, else -0.1), and an episode never
terminates. Physics: the pair-topk pruned contact table (16 pairs a group,
24 for the pen), capped at 16 rows a condim group, 5 Newton and 4
line-search iterations, the contact forces decoded for the touch sensors
only (the hammer reads ``S_nail``).

Each reset draws a scene the reference writes into its model (the door's
position, the nail board's height, the pen's target orientation, the
ball's and the target's positions, adroit_door.py:359-371 and siblings).
Here the scene is per-env state, ``EnvState.aux`` (B-leading), and every
step rebinds it into a per-env copy of the model (``Model.rebind``: the
scene fields gain a trailing batch axis, the static tables are shared).
Every method acts on the whole batch; the randomness comes from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.mjcf import serialize
from gymnasium_robotics_tpu_torch.physics import pipeline
from gymnasium_robotics_tpu_torch.utils import rotations


def _norm(v):
    """|v| of vectors (3, B) -> (B,)."""
    return torch.linalg.vector_norm(v, dim=0)


def _bonus(cond, value):
    """value where cond, else 0 (a staged reward term)."""
    return torch.where(cond, value, 0.0)


class AdroitEnv:
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 100}
    task = "door"
    frame_skip = 5
    obs_dim = 39

    def __init__(self, reward_type="dense", max_episode_steps=None,
                 dtype=torch.float32, device=None):
        self.device = dev = _device.resolve(device)
        self.dtype = dtype
        self.sparse_reward = reward_type.lower() == "sparse"
        self.max_episode_steps = max_episode_steps
        model, extra = serialize.load_asset(f"adroit/{self.task}", dtype, dev)
        # pair_topk: 16 pairs a group, 24 for the pen's 33-pair finger-pen
        # group (the JAX package's C-engine rollouts)
        model = model.with_options(
            contact_cap=16, iterations=5, ls_iterations=4,
            pair_topk=24 if self.task == "pen" else 16, need_cfrc_ext=False)
        # the actuators' sensitivity (adroit_door.py:225-252), the same for
        # every env: the wrist's gain 10 and bias -10 on position, the
        # fingers' 1 and -1
        names = model.meta.actuator_names
        iw1, iw0 = names.index("A_WRJ1"), names.index("A_WRJ0")
        if3, it0 = names.index("A_FFJ3"), names.index("A_THJ0")
        gain = model.actuator_gainprm.clone()
        bias = model.actuator_biasprm.clone()
        gain[iw1:iw0 + 1, :3, 0] = self._t([10.0, 0.0, 0.0])
        gain[if3:it0 + 1, :3, 0] = self._t([1.0, 0.0, 0.0])
        bias[iw1:iw0 + 1, :3, 0] = self._t([0.0, -10.0, 0.0])
        bias[if3:it0 + 1, :3, 0] = self._t([0.0, -1.0, 0.0])
        self.model = dataclasses.replace(model, actuator_gainprm=gain,
                                         actuator_biasprm=bias)
        cr = model.actuator_ctrlrange[..., 0].cpu().numpy()
        self._act_mean = self._t(cr.mean(axis=1))[:, None]          # (nu, 1)
        self._act_rng = self._t(0.5 * (cr[:, 1] - cr[:, 0]))[:, None]
        self._init_qpos = self._t(extra["initial_qpos"])
        self._init_qvel = self._t(extra["initial_qvel"])
        self.action_dim = model.meta.nu
        self._setup_ids()

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _id(self, kind, name):
        names = {"body": self.model.meta.body_names,
                 "site": self.model.meta.site_names,
                 "joint": self.model.meta.joint_names}[kind]
        return names.index(name)

    def _uniform(self, generator, n, lo, hi):
        """(n, len(lo)) draws, column i uniform in [lo[i], hi[i])."""
        lo, hi = self._t(lo), self._t(hi)
        u = torch.rand((n, lo.numel()), generator=generator, dtype=self.dtype,
                       device=self.device)
        return lo + (hi - lo) * u

    def _per_env(self, field, n):
        """A model field (rows, ..., 1) as a fresh per-env copy (rows, ..., n)."""
        return getattr(self.model, field).expand(
            *getattr(self.model, field).shape[:-1], n).clone()

    def _sparse(self, success):
        like = success.to(self.dtype)
        return torch.where(success, like.new_full((), 10.0),
                           like.new_full((), -0.1))

    # --- per-task hooks ---
    def _setup_ids(self):
        raise NotImplementedError

    def _sample_aux(self, n, generator):
        raise NotImplementedError

    def _model_for(self, aux):
        raise NotImplementedError

    def _task_obs_reward(self, data):
        raise NotImplementedError

    def _aux_to_state_dict(self, state):
        raise NotImplementedError

    def _state_dict_to_aux(self, state_dict, aux):
        raise NotImplementedError

    # --- env API ---
    def initial(self, num_envs: int, generator) -> core.EnvState:
        """A reset state for each of num_envs envs, its scene drawn."""
        return self._reset_with_aux(self._sample_aux(num_envs, generator))

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch: a new scene
        drawn, the hand at its initial pose."""
        return self._reset_with_aux(self._sample_aux(state.steps.shape[0],
                                                     generator))

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: the scene's values (B-leading arrays, the
        keys of ``aux``) drawn on the host in the reference's order
        (utils/parity.py)."""
        return self._reset_with_aux({k: self._t(v) for k, v in values.items()})

    def _reset_with_aux(self, aux) -> core.EnvState:
        n = next(iter(aux.values())).shape[0]
        m = self._model_for(aux)
        data = dataclasses.replace(
            pipeline.make_data(self.model, n),
            qpos=self._init_qpos[:, None].expand(-1, n).clone(),
            qvel=self._init_qvel[:, None].expand(-1, n).clone())
        data = pipeline.refresh_kin(m, data)
        obs, _, _ = self._task_obs_reward(data)
        false = torch.zeros(n, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=obs,
            reward=torch.zeros(n, dtype=self.dtype, device=self.device),
            terminated=false, truncated=false.clone(),
            info={"success": false.clone()},
            goal=torch.zeros((n, 0), dtype=self.dtype, device=self.device),
            steps=torch.zeros(n, dtype=torch.int32, device=self.device),
            aux=aux)

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch (frame_skip Euler substeps)."""
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        ctrl = self._act_mean + action.T * self._act_rng
        m = self._model_for(state.aux)
        data = pipeline.step_n(m, state.data, ctrl, self.frame_skip)
        obs, reward, success = self._task_obs_reward(data)
        false = torch.zeros_like(success)
        return core.EnvState(
            data=data, obs=obs, reward=reward.to(self.dtype),
            terminated=false, truncated=false.clone(),
            info={"success": success}, goal=state.goal,
            steps=state.steps + 1, aux=state.aux)

    # --- the reference's state dicts (adroit_door.py:373-392; per-task
    # keys below), B-leading ---
    def get_env_state(self, state: core.EnvState) -> dict:
        """qpos, qvel and the task's scene fields, under the reference's
        keys."""
        d = {"qpos": state.data.qpos.T, "qvel": state.data.qvel.T}
        d.update(self._aux_to_state_dict(state))
        return d

    def set_env_state(self, state: core.EnvState, state_dict) -> core.EnvState:
        """qpos, qvel and the scene written from a state dict, the
        kinematics and the observation recomputed."""
        aux = self._state_dict_to_aux(state_dict, dict(state.aux))
        m = self._model_for(aux)
        data = dataclasses.replace(
            state.data, qpos=self._t(state_dict["qpos"]).T.contiguous(),
            qvel=self._t(state_dict["qvel"]).T.contiguous())
        data = pipeline.refresh_kin(m, data)
        obs, _, _ = self._task_obs_reward(data)
        return dataclasses.replace(state, data=data, obs=obs, aux=aux)


class AdroitHandDoorEnv(AdroitEnv):
    task = "door"
    obs_dim = 39

    def _setup_ids(self):
        mt = self.model.meta
        hinge = self._id("joint", "door_hinge")
        self._door_hinge_qadr = mt.jnt_qposadr[hinge]
        self._grasp_site = self._id("site", "S_grasp")
        self._handle_site = self._id("site", "S_handle")
        self._door_body = self._id("body", "frame")

    def _sample_aux(self, n, generator):
        return {"door_body_pos": self._uniform(
            generator, n, [-0.3, 0.25, 0.252], [-0.2, 0.35, 0.35])}

    def _model_for(self, aux):
        pos = aux["door_body_pos"]
        bp = self._per_env("body_pos", pos.shape[0])
        bp[self._door_body] = pos.T.to(bp.dtype)
        return self.model.rebind(body_pos=bp)

    def _aux_to_state_dict(self, state):
        return {"door_body_pos": state.aux["door_body_pos"]}

    def _state_dict_to_aux(self, state_dict, aux):
        aux["door_body_pos"] = self._t(state_dict["door_body_pos"])
        return aux

    def _task_obs_reward(self, data):
        qpos = data.qpos
        door_pos = qpos[self._door_hinge_qadr]
        handle_pos = data.site_xpos[self._handle_site]
        palm_pos = data.site_xpos[self._grasp_site]
        latch_pos = qpos[-1]
        door_open = torch.where(door_pos > 1.0, 1.0, -1.0).to(self.dtype)
        obs = torch.cat([qpos[1:-2].T, latch_pos[:, None], door_pos[:, None],
                         palm_pos.T, handle_pos.T, (palm_pos - handle_pos).T,
                         door_open[:, None]], dim=1)
        success = door_pos >= 1.35
        if self.sparse_reward:
            return obs, self._sparse(success), success
        reward = -0.1 * _norm(palm_pos - handle_pos)
        reward = reward + -0.1 * (door_pos - 1.57) ** 2
        reward = reward + -1e-5 * torch.sum(data.qvel ** 2, dim=0)
        reward = reward + _bonus(door_pos > 0.2, 2.0)
        reward = reward + _bonus(door_pos > 1.0, 8.0)
        reward = reward + _bonus(door_pos > 1.35, 10.0)
        return obs, reward, success


class AdroitHandHammerEnv(AdroitEnv):
    task = "hammer"
    obs_dim = 46

    def _setup_ids(self):
        mt = self.model.meta
        self._obj_body = self._id("body", "Object")
        self._grasp_site = self._id("site", "S_grasp")
        self._tool_site = self._id("site", "tool")
        self._nail_site = self._id("site", "S_target")
        self._goal_site = self._id("site", "nail_goal")
        self._board_body = self._id("body", "nail_board")
        self._nail_sensor_adr = mt.sensor_adr[mt.sensor_names.index("S_nail")]

    def _sample_aux(self, n, generator):
        return {"board_z": self._uniform(generator, n, [0.1], [0.25])[:, 0]}

    def _model_for(self, aux):
        z = aux["board_z"]
        bp = self._per_env("body_pos", z.shape[0])
        bp[self._board_body, 2] = z.to(bp.dtype)
        return self.model.rebind(body_pos=bp)

    def _aux_to_state_dict(self, state):
        z = state.aux["board_z"]
        board_pos = self.model.body_pos[self._board_body, :, 0].to(
            self.dtype).expand(z.shape[0], 3).clone()
        board_pos[:, 2] = z
        return {"board_pos": board_pos,
                "target_pos": state.data.site_xpos[self._nail_site].T}

    def _state_dict_to_aux(self, state_dict, aux):
        aux["board_z"] = self._t(state_dict["board_pos"])[:, 2]
        return aux

    def _task_obs_reward(self, data):
        qp = data.qpos
        qv = torch.clamp(data.qvel, -1.0, 1.0)
        obj_pos = data.xpos[self._obj_body]
        obj_rot = rotations.quat2euler(data.xquat[self._obj_body].T)
        palm_pos = data.site_xpos[self._grasp_site]
        nail_pos = data.site_xpos[self._nail_site]
        goal_pos = data.site_xpos[self._goal_site]
        head_pos = data.site_xpos[self._tool_site]
        # the touch sensor at the nail head (adroit_hammer.py:344-346)
        nail_impact = torch.clamp(data.sensordata[self._nail_sensor_adr],
                                  -1.0, 1.0).to(self.dtype)
        obs = torch.cat([qp[:-6].T, qv[-6:].T, palm_pos.T, obj_pos.T, obj_rot,
                         nail_pos.T, nail_impact[:, None]], dim=1)
        goal_distance = _norm(nail_pos - goal_pos)
        success = goal_distance < 0.01
        if self.sparse_reward:
            return obs, self._sparse(success), success
        reward = -0.1 * _norm(palm_pos - obj_pos)
        reward = reward - _norm(head_pos - nail_pos)
        reward = reward - 10.0 * goal_distance
        reward = reward - 1e-2 * _norm(data.qvel)
        reward = reward + _bonus((obj_pos[2] > 0.04) & (head_pos[2] > 0.04), 2.0)
        reward = reward + _bonus(goal_distance < 0.020, 25.0)
        reward = reward + _bonus(goal_distance < 0.010, 75.0)
        return obs, reward, success


class AdroitHandPenEnv(AdroitEnv):
    task = "pen"
    obs_dim = 45

    def _setup_ids(self):
        self._obj_body = self._id("body", "Object")
        self._target_body = self._id("body", "target")
        self._eps_ball = self._id("site", "eps_ball")
        self._obj_t = self._id("site", "object_top")
        self._obj_b = self._id("site", "object_bottom")
        self._tar_t = self._id("site", "target_top")
        self._tar_b = self._id("site", "target_bottom")
        sp = self.model.site_pos[..., 0].cpu().numpy()
        self._pen_length = float(np.linalg.norm(sp[self._obj_t] - sp[self._obj_b]))
        self._tar_length = float(np.linalg.norm(sp[self._tar_t] - sp[self._tar_b]))

    def _sample_aux(self, n, generator):
        euler = self._uniform(generator, n, [-1.0, -1.0, 0.0], [1.0, 1.0, 0.0])
        return {"target_quat": rotations.euler2quat(euler)}

    def _model_for(self, aux):
        quat = aux["target_quat"]
        bq = self._per_env("body_quat", quat.shape[0])
        bq[self._target_body] = quat.T.to(bq.dtype)
        return self.model.rebind(body_quat=bq)

    def _aux_to_state_dict(self, state):
        return {"desired_orien": state.aux["target_quat"]}

    def _state_dict_to_aux(self, state_dict, aux):
        aux["target_quat"] = self._t(state_dict["desired_orien"])
        return aux

    def _task_obs_reward(self, data):
        qpos = data.qpos
        obj_vel = data.qvel[-6:]
        obj_pos = data.xpos[self._obj_body]
        desired_pos = data.site_xpos[self._eps_ball]
        sx = data.site_xpos
        obj_orien = (sx[self._obj_t] - sx[self._obj_b]) / self._pen_length
        desired_orien = (sx[self._tar_t] - sx[self._tar_b]) / self._tar_length
        obs = torch.cat([qpos[:-6].T, obj_pos.T, obj_vel.T, obj_orien.T,
                         desired_orien.T, (obj_pos - desired_pos).T,
                         (obj_orien - desired_orien).T], dim=1)
        goal_distance = _norm(obj_pos - desired_pos)
        orien_similarity = torch.sum(obj_orien * desired_orien, dim=0)
        success = (goal_distance < 0.075) & (orien_similarity > 0.95)
        if self.sparse_reward:
            return obs, self._sparse(success), success
        near = goal_distance < 0.075
        reward = -goal_distance + orien_similarity
        reward = reward + _bonus(near & (orien_similarity > 0.9), 10.0)
        reward = reward + _bonus(near & (orien_similarity > 0.95), 50.0)
        reward = reward - _bonus(obj_pos[2] < 0.075, 5.0)
        return obs, reward, success


class AdroitHandRelocateEnv(AdroitEnv):
    task = "relocate"
    obs_dim = 39

    def _setup_ids(self):
        self._obj_body = self._id("body", "Object")
        self._grasp_site = self._id("site", "S_grasp")
        self._target_site = self._id("site", "target")

    def _sample_aux(self, n, generator):
        return {"obj_xy": self._uniform(generator, n, [-0.15, -0.15], [0.15, 0.3]),
                "target_pos": self._uniform(generator, n, [-0.2, -0.2, 0.15],
                                            [0.2, 0.2, 0.35])}

    def _model_for(self, aux):
        xy, target = aux["obj_xy"], aux["target_pos"]
        bp = self._per_env("body_pos", xy.shape[0])
        bp[self._obj_body, :2] = xy.T.to(bp.dtype)
        sp = self._per_env("site_pos", xy.shape[0])
        sp[self._target_site] = target.T.to(sp.dtype)
        return self.model.rebind(body_pos=bp, site_pos=sp)

    def _aux_to_state_dict(self, state):
        xy = state.aux["obj_xy"]
        obj_pos = self.model.body_pos[self._obj_body, :, 0].to(
            self.dtype).expand(xy.shape[0], 3).clone()
        obj_pos[:, :2] = xy
        return {"hand_qpos": state.data.qpos[:30].T, "obj_pos": obj_pos,
                "palm_pos": state.data.site_xpos[self._grasp_site].T,
                "target_pos": state.aux["target_pos"]}

    def _state_dict_to_aux(self, state_dict, aux):
        aux["obj_xy"] = self._t(state_dict["obj_pos"])[:, :2]
        aux["target_pos"] = self._t(state_dict["target_pos"])
        return aux

    def _task_obs_reward(self, data):
        qpos = data.qpos
        obj_pos = data.xpos[self._obj_body]
        palm_pos = data.site_xpos[self._grasp_site]
        target_pos = data.site_xpos[self._target_site]
        obs = torch.cat([qpos[:-6].T, (palm_pos - obj_pos).T,
                         (palm_pos - target_pos).T, (obj_pos - target_pos).T],
                        dim=1)
        goal_distance = _norm(obj_pos - target_pos)
        success = goal_distance < 0.1
        if self.sparse_reward:
            return obs, self._sparse(success), success
        reward = -0.1 * _norm(palm_pos - obj_pos)
        lifted = obj_pos[2] > 0.04
        reward = reward + torch.where(
            lifted, 1.0 - 0.5 * _norm(palm_pos - target_pos)
            - 0.5 * _norm(obj_pos - target_pos), torch.zeros_like(reward))
        reward = reward + _bonus(goal_distance < 0.1, 10.0)
        reward = reward + _bonus(goal_distance < 0.05, 20.0)
        return obs, reward, success


CLASSES = {
    "AdroitHandDoor": AdroitHandDoorEnv,
    "AdroitHandHammer": AdroitHandHammerEnv,
    "AdroitHandPen": AdroitHandPenEnv,
    "AdroitHandRelocate": AdroitHandRelocateEnv,
}
