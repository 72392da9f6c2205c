"""Fetch family: the 7-DoF arm with mocap-welded Cartesian control (port of
gymnasium_robotics_tpu/envs/fetch/fetch.py: reach, push, slide and
pick-and-place).

action (B, 4) = dxyz * 0.05 and the gripper; the mocap body snaps to the
welded gripper link's pose and is displaced (fetch.py:239-260); the finger
position actuators, where the model has them, get ctrl = qpos + gripper
(the reach and slide models have none); 20 substeps per env step; with a
blocked gripper the fingers are pinned at 0 after the substeps and the
kinematics refreshed (:262-268); the observation (:156-181): 25 wide with
an object (whose position is the achieved goal), 10 without (the grip
position is); the goal (:131-143): the gripper's start plus a uniform
offset, with an object also plus ``target_offset`` and then at the
table's height (lifted at random where the target may be in the air);
sparse reward -(d > 0.05), dense -d. Physics:
Euler with implicit damping, pair-topk pruned contacts (pair_topk=8)
capped at 24 per condim group, 4 Newton and 4 line-search iterations.
Every method acts on the whole batch; goals and object positions are drawn
from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.mjcf import serialize
from gymnasium_robotics_tpu_torch.physics import pipeline, smooth
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.utils import rotations

_FINGERS = ("robot0:l_gripper_finger_joint", "robot0:r_gripper_finger_joint")


class FetchEnv:
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 25}
    task: str = "push"
    has_object: bool = True
    block_gripper: bool = True
    target_in_the_air: bool = False
    target_offset = (0.0, 0.0, 0.0)
    obj_range: float = 0.15
    target_range: float = 0.15
    distance_threshold: float = 0.05
    n_substeps: int = 20

    def __init__(self, reward_type: str = "sparse", max_episode_steps=None,
                 dtype=torch.float32, device=None):
        self.device = dev = _device.resolve(device)
        self.reward_type = reward_type
        self.max_episode_steps = max_episode_steps
        self.dtype = dtype
        model, extra = serialize.load_asset(f"fetch/{self.task}", dtype, dev)
        # pair_topk=8: the arm's 85-pair mesh-mesh group never has more than
        # a few near pairs; push's 905-slot table compacts to 277 slots
        self.model = m = model.with_options(
            contact_cap=24, pair_topk=8, iterations=4, ls_iterations=4,
            need_cfrc_ext=False)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self._init_qpos = t(extra["initial_qpos"])            # (nq,)
        self._init_qvel = t(extra["initial_qvel"])            # (nv,)
        self._init_mocap_pos = t(extra["initial_mocap_pos"])  # (nmocap, 3)
        self._init_mocap_quat = t(extra["initial_mocap_quat"])
        self._init_grip = t(extra["initial_gripper_xpos"])    # (3,)
        self._height_offset = float(extra.get("height_offset", 0.0))
        mt = m.meta
        self._grip_site = mt.site_names.index("robot0:grip")
        self._grip_body = mt.site_bodyid[self._grip_site]
        self._gripper_link = mt.body_names.index("robot0:gripper_link")
        bodies = {self._grip_body}
        if self.has_object:
            self._obj_site = mt.site_names.index("object0")
            self._obj_body = mt.site_bodyid[self._obj_site]
            self._obj_qadr = mt.jnt_qposadr[mt.joint_names.index("object0:joint")]
            bodies.add(self._obj_body)
        self._target_offset = t(self.target_offset)
        self._act_qadr = [mt.jnt_qposadr[mt.actuator_trnid[u]]
                          for u in range(mt.nu)]
        fingers = [mt.joint_names.index(n) for n in _FINGERS]
        self._finger_qadr = [mt.jnt_qposadr[j] for j in fingers]
        self._finger_dofadr = [mt.jnt_dofadr[j] for j in fingers]
        masks = smooth.body_dof_masks(mt)
        self._dof_mask = {b: t(masks[b])[:, None, None] for b in bodies}
        self.dt = mt.opt.timestep * self.n_substeps
        self.obs_dim = 25 if self.has_object else 10
        self.goal_dim, self.action_dim = 3, 4

    # --- GoalEnv contract (fetch_env.py:74-80 in the reference) ---
    def compute_reward(self, achieved_goal, desired_goal, info=None):
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        if self.reward_type == "sparse":
            return -(d > self.distance_threshold).to(self.dtype)
        return -d

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        return torch.zeros(achieved_goal.shape[:-1], dtype=torch.bool,
                           device=achieved_goal.device)

    # --- helpers ---
    def _site_jacs(self, data, site, body):
        """Batch-last (jacp, jacr) (nv, 3, B) of a site on ``body``, from the
        Data's kinematics (mujoco_utils.get_site_xvelp in the reference)."""
        mask = self._dof_mask[body]
        o = data.subtree_com[self.model.meta.body_rootid[body]]
        cdof_r = data.cdof[:, :3]
        jacp = (data.cdof[:, 3:] + M.cross3(cdof_r, (data.site_xpos[site] - o)[None]))
        return jacp * mask, cdof_r * mask

    def _site_vel(self, data, site, body):
        """(velp, velr) (3, B) of a site: its Jacobians times qvel."""
        jacp, jacr = self._site_jacs(data, site, body)
        return (torch.einsum("vcb,vb->cb", jacp, data.qvel),
                torch.einsum("vcb,vb->cb", jacr, data.qvel))

    def _get_obs(self, data, goal):
        grip_pos = data.site_xpos[self._grip_site]                  # (3, B)
        grip_velp = self._site_vel(data, self._grip_site, self._grip_body)[0] * self.dt
        gripper_state = data.qpos[self._finger_qadr]
        gripper_vel = data.qvel[self._finger_dofadr] * self.dt
        if not self.has_object:
            parts = [grip_pos, gripper_state, grip_velp, gripper_vel]
            return dict(observation=torch.cat(parts).T.contiguous(),
                        achieved_goal=grip_pos.T.contiguous(), desired_goal=goal)
        object_pos = data.site_xpos[self._obj_site]
        object_rot = rotations.mat2euler(
            data.site_xmat[self._obj_site].permute(2, 0, 1)).T
        velp, velr = self._site_vel(data, self._obj_site, self._obj_body)
        parts = [grip_pos, object_pos, object_pos - grip_pos, gripper_state,
                 object_rot, velp * self.dt - grip_velp, velr * self.dt,
                 grip_velp, gripper_vel]
        return dict(observation=torch.cat(parts).T.contiguous(),
                    achieved_goal=object_pos.T.contiguous(), desired_goal=goal)

    def _uniform(self, generator, shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=self.device)
        return lo + (hi - lo) * u

    def _sample_goal(self, n, generator):
        goal = self._init_grip + self._uniform(
            generator, (n, 3), -self.target_range, self.target_range)
        if not self.has_object:
            return goal
        goal = goal + self._target_offset
        goal[:, 2] = self._height_offset
        if self.target_in_the_air:
            lift = self._uniform(generator, (n,), 0.0, 0.45)
            use = self._uniform(generator, (n,), 0.0, 1.0) < 0.5
            goal[:, 2] += torch.where(use, lift, torch.zeros_like(lift))
        return goal

    def _sample_object_xy(self, n, generator):
        """The first of 16 candidates >= 0.1 from the gripper (the first
        candidate where none is): the reference's fixed-K retry."""
        grip = self._init_grip[:2]
        cands = grip + self._uniform(generator, (n, 16, 2), -self.obj_range,
                                     self.obj_range)
        ok = torch.linalg.vector_norm(cands - grip, dim=-1) >= 0.1
        pick = torch.argmax(ok.to(self.dtype), dim=1)
        return cands[torch.arange(n, device=self.device), pick]

    def _reset_state(self, n, goal, object_xy) -> core.EnvState:
        data = pipeline.make_data(self.model, n)
        qpos = self._init_qpos[:, None].expand(-1, n).clone()
        if object_xy is not None:   # else the object stays where the model has it
            qpos[self._obj_qadr:self._obj_qadr + 2] = object_xy.T
        data = dataclasses.replace(
            data, qpos=qpos,
            qvel=self._init_qvel[:, None].expand(-1, n).clone(),
            mocap_pos=self._init_mocap_pos[..., None].expand(-1, -1, n).clone(),
            mocap_quat=self._init_mocap_quat[..., None].expand(-1, -1, n).clone())
        data = pipeline.refresh_kin(self.model, data)
        zeros = torch.zeros(n, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=self._get_obs(data, goal),
            reward=torch.zeros(n, dtype=self.dtype, device=self.device),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": torch.zeros(n, dtype=self.dtype,
                                            device=self.device)},
            goal=goal, steps=torch.zeros(n, dtype=torch.int32, device=self.device),
        )

    # --- env API ---
    def initial(self, num_envs: int, generator) -> core.EnvState:
        object_xy = (self._sample_object_xy(num_envs, generator)
                     if self.has_object else None)
        return self._reset_state(num_envs, self._sample_goal(num_envs, generator),
                                 object_xy)

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: the goal (B, 3) and, where given (a task with
        an object), the object's xy (B, 2) drawn on the host, under
        ``goal`` and ``object_xy``."""

        def t(x):
            return torch.tensor(np.asarray(x), dtype=self.dtype, device=self.device)

        object_xy = (t(values["object_xy"])
                     if self.has_object and "object_xy" in values else None)
        return self._reset_state(state.steps.shape[0], t(values["goal"]), object_xy)

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch (20 Euler substeps)."""
        m = self.model
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        pos_ctrl = action[:, :3].T * 0.05                            # (3, B)
        data = state.data
        gripper = 0.0 if self.block_gripper else action[:, 3]
        ctrl = data.qpos[self._act_qadr] + gripper                 # (nu, B)
        rot_ctrl = torch.tensor([1.0, 0.0, 1.0, 0.0], dtype=self.dtype,
                                device=self.device)
        data = dataclasses.replace(
            data, mocap_pos=(data.xpos[self._gripper_link] + pos_ctrl)[None],
            mocap_quat=(data.xquat[self._gripper_link] + rot_ctrl[:, None])[None])
        data = pipeline.step_n(m, data, ctrl, self.n_substeps)
        if self.block_gripper:
            qpos = data.qpos.clone()
            qpos[self._finger_qadr] = 0.0
            data = pipeline.refresh_kin(m, dataclasses.replace(data, qpos=qpos))
        obs = self._get_obs(data, state.goal)
        achieved = obs["achieved_goal"]
        dist = torch.linalg.vector_norm(achieved - state.goal, dim=-1)
        zeros = torch.zeros_like(dist, dtype=torch.bool)
        return core.EnvState(
            data=data, obs=obs, reward=self.compute_reward(achieved, state.goal),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": (dist < self.distance_threshold).to(self.dtype)},
            goal=state.goal, steps=state.steps + 1,
        )


class FetchReachEnv(FetchEnv):
    task = "reach"
    has_object = False
    block_gripper = True
    target_in_the_air = True


class FetchPushEnv(FetchEnv):
    task = "push"
    block_gripper = True
    target_in_the_air = False


class FetchSlideEnv(FetchEnv):
    task = "slide"
    block_gripper = True
    target_in_the_air = False
    target_offset = (0.4, 0.0, 0.0)
    obj_range = 0.1
    target_range = 0.3


class FetchPickAndPlaceEnv(FetchEnv):
    task = "pick_and_place"
    block_gripper = False
    target_in_the_air = True
