"""Shadow Dexterous Hand: reach and manipulation (port of
gymnasium_robotics_tpu/envs/hand/hand.py ``HandBaseEnv``,
``HandReachEnv``, ``HandManipulateEnv`` and ``HandManipulateBlockEnv``;
the reference's reach.py, manipulate.py and manipulate_touch_sensors.py).

HandReach: the five fingertips reach a goal pattern (15-D: the tips'
positions) in which the thumb and one other finger meet near a point
over the palm; the observation is the 24 joint positions and velocities
and the tips' positions (63-D); reward -1/0 by the 0.01 threshold or the
negative distance; never terminated. A reset restores the initial pose
and draws a new goal.

20 position actuators over 24 joints, the J1/J0 couplings as tendon-limit
rows; action (B, 20) in [-1, 1] mapped into the actuators' ctrlrange,
absolute or relative to the joints' positions (hand_env.py:42-61); 20 Euler
substeps an env step. The goal is the block's 7-D pose (position and
quaternion): position offset and rotation drawn by the target modes, the
distance split into position and angle (manipulate.py:87-115). The
observation is the hand's 24 joint positions and velocities, the block's
velocity and pose, then the touch sensors' readings where asked
(``sensordata``, ``boolean`` or ``log``). Physics: the unpruned contact
table capped at 16 rows per condim group, 5 Newton and 4 line-search
iterations, the contact forces decoded for the touch sensors only.

Manipulation resets: ``initial`` settles a pool of ``reset_pool_size`` randomized block
poses per env (10 x 20 substeps with zero action; a block that fell off
the palm keeps its unsettled pose), all of them as one batch, and each
reset restores one pool entry and draws a new goal. Every method acts on
the whole batch; the randomness comes from the caller's
``torch.Generator``.
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

FINGERTIP_SITES = ["robot0:S_fftip", "robot0:S_mftip", "robot0:S_rftip",
                   "robot0:S_lftip", "robot0:S_thtip"]


def _normalize(v):
    """v (..., n) over its last axis, the norm floored at 1e-12."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def quat_from_angle_and_axis(angle, axis):
    """angle (n,), axis (n, 3) -> (n, 4)."""
    axis = _normalize(axis)
    return torch.cat([torch.cos(angle / 2.0)[:, None],
                      torch.sin(angle / 2.0)[:, None] * axis], dim=-1)


class HandBaseEnv:
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 25}
    n_substeps = 20
    relative_control = False

    def _load(self, asset, dtype, device):
        self.device = dev = _device.resolve(device)
        self.dtype = dtype
        model, extra = serialize.load_asset(asset, dtype, dev)
        self.model = m = model.with_options(
            contact_cap=16, iterations=5, ls_iterations=4,
            need_cfrc_ext=False)   # the touch sensors read con_force only
        self._init_qpos = self._t(extra["initial_qpos"])      # (nq,)
        self._init_qvel = self._t(extra["initial_qvel"])      # (nv,)
        self._extra = extra
        mt = m.meta
        # the robot's joints, named robot0:* (the first 24)
        self._robot_nq = sum(1 for n in mt.joint_names if n.startswith("robot0:"))
        cr = m.actuator_ctrlrange                              # (nu, 2, 1)
        self._ctrl_lo, self._ctrl_hi = cr[:, 0], cr[:, 1]
        self._act_range = (cr[:, 1] - cr[:, 0]) / 2.0
        self._act_center = (cr[:, 1] + cr[:, 0]) / 2.0
        # relative control: each actuator's joint, and for a J1 actuator its
        # coupled J0 joint, whose positions sum to the centre
        q1, q0 = [], []
        for u in range(mt.nu):
            jname = mt.actuator_names[u].replace(":A_", ":")
            q1.append(mt.jnt_qposadr[mt.joint_names.index(jname)])
            j0 = jname[:-2] + "J0"
            q0.append(mt.jnt_qposadr[mt.joint_names.index(j0)]
                      if jname.endswith("J1") else -1)
        self._rel_q = torch.as_tensor(q1, device=dev)
        self._rel_j0 = torch.as_tensor([max(q, 0) for q in q0], device=dev)
        self._rel_has_j0 = torch.as_tensor([q >= 0 for q in q0], device=dev)[:, None]

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _apply_action(self, data, action):
        """ctrl (nu, B) of actions (B, nu) in [-1, 1] (hand_env.py:42-61)."""
        if self.relative_control:
            q = data.qpos
            center = q[self._rel_q] + torch.where(
                self._rel_has_j0, q[self._rel_j0], torch.zeros_like(q[self._rel_j0]))
        else:
            center = self._act_center
        ctrl = center + action.T * self._act_range
        return torch.clamp(ctrl, self._ctrl_lo, self._ctrl_hi)


class HandReachEnv(HandBaseEnv):
    """reach.py:55-431: the five fingertip sites reach a sampled meeting
    pattern, batched."""

    distance_threshold = 0.01

    def __init__(self, reward_type="sparse", relative_control=False,
                 max_episode_steps=None, dtype=torch.float32, device=None):
        self.reward_type = reward_type
        self.relative_control = relative_control
        self.max_episode_steps = max_episode_steps
        self._load("hand/reach", dtype, device)
        extra = self._extra
        self._initial_goal = self._t(extra["initial_goal"]).reshape(5, 3)
        self._palm_xpos = self._t(extra["palm_xpos"])
        self._meeting0 = self._palm_xpos + self._t([0.0, -0.09, 0.05])
        mt = self.model.meta
        self._tip_sites = [mt.site_names.index(s) for s in FINGERTIP_SITES]
        self.obs_dim, self.goal_dim, self.action_dim = 63, 15, 20

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        if self.reward_type == "sparse":
            return -(d > self.distance_threshold).to(d.dtype)
        return -d

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        return torch.zeros(achieved_goal.shape[:-1], dtype=torch.bool,
                           device=achieved_goal.device)

    def _sample_goal(self, n, generator):
        """(n, 15) goals (reach.py:99-126): the thumb and one of the four
        other fingers (drawn) moved to 0.005 short of a meeting point, the
        palm's point plus normal noise of 0.005; one goal in ten (drawn)
        the initial pattern."""
        dev = self.device
        finger = torch.randint(4, (n,), generator=generator, device=dev)
        meeting = self._meeting0 + 0.005 * torch.randn(
            (n, 3), generator=generator, dtype=self.dtype, device=dev)
        goal = self._initial_goal.expand(n, 5, 3).clone()
        env = torch.arange(n, device=dev)
        for idx in (torch.full_like(finger, 4), finger):
            direction = _normalize(meeting - goal[env, idx])
            goal[env, idx] = meeting - 0.005 * direction
        revert = torch.rand((n,), generator=generator, dtype=self.dtype,
                            device=dev) < 0.1
        goal = torch.where(revert[:, None, None], self._initial_goal, goal)
        return goal.reshape(n, 15)

    def _achieved(self, data):
        return data.site_xpos[self._tip_sites].permute(2, 0, 1).reshape(-1, 15)

    def _get_obs(self, data, goal):
        nq = self._robot_nq
        achieved = self._achieved(data)
        obs = torch.cat([data.qpos[:nq].T, data.qvel[:nq].T, achieved], dim=-1)
        return dict(observation=obs, achieved_goal=achieved, desired_goal=goal)

    def _reset_state(self, goal) -> core.EnvState:
        """The initial pose of every env, kinematics refreshed, with goals
        goal (n, 15)."""
        n = goal.shape[0]
        data = dataclasses.replace(
            pipeline.make_data(self.model, n),
            qpos=self._init_qpos[:, None].expand(-1, n).clone(),
            qvel=self._init_qvel[:, None].expand(-1, n).clone())
        data = pipeline.refresh_kin(self.model, data)
        zeros = torch.zeros(n, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=self._get_obs(data, goal),
            reward=torch.zeros(n, dtype=self.dtype, device=self.device),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": torch.zeros(n, dtype=self.dtype,
                                            device=self.device)},
            goal=goal, steps=torch.zeros(n, dtype=torch.int32, device=self.device))

    def initial(self, num_envs: int, generator) -> core.EnvState:
        return self._reset_state(self._sample_goal(num_envs, generator))

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: the goals (B, 15) drawn on the host in the
        reference's order (reach.py:99-126 via utils/parity.py), under
        ``goal``."""
        return self._reset_state(self._t(values["goal"]))

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch (20 Euler substeps)."""
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        ctrl = self._apply_action(state.data, action)
        data = pipeline.step_n(self.model, state.data, ctrl, self.n_substeps)
        obs = self._get_obs(data, state.goal)
        achieved = obs["achieved_goal"]
        d = torch.linalg.vector_norm(achieved - state.goal, dim=-1)
        zeros = torch.zeros(d.shape[0], dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=obs,
            reward=self.compute_reward(achieved, state.goal),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": (d < self.distance_threshold).to(self.dtype)},
            goal=state.goal, steps=state.steps + 1)


class HandManipulateEnv(HandBaseEnv):
    """manipulate.py:18-315 semantics, batched (the module docstring)."""

    object_name = "block"
    distance_threshold = 0.01
    rotation_threshold = 0.1

    def __init__(self, target_position="random", target_rotation="xyz",
                 reward_type="sparse", touch_obs=None,
                 ignore_z_target_rotation=False,
                 randomize_initial_rotation=True,
                 randomize_initial_position=True, relative_control=False,
                 max_episode_steps=None, reset_pool_size=16,
                 dtype=torch.float32, device=None):
        self.reset_pool_size = int(reset_pool_size)
        self.target_position = target_position
        self.target_rotation = target_rotation
        self.reward_type = reward_type
        self.touch_obs = touch_obs      # None, "sensordata", "boolean", "log"
        self.ignore_z_target_rotation = ignore_z_target_rotation
        self.randomize_initial_rotation = randomize_initial_rotation
        self.randomize_initial_position = randomize_initial_position
        self.relative_control = relative_control
        self.max_episode_steps = max_episode_steps
        asset = f"hand/manipulate_{self.object_name}"
        if touch_obs is not None:
            asset += "_touch"
        self._load(asset, dtype, device)
        self.target_position_range = self._t(
            [(-0.04, 0.04), (-0.06, 0.02), (0.0, 0.06)])
        mt = self.model.meta
        obj = mt.joint_names.index("object:joint")
        self._obj_qadr = mt.jnt_qposadr[obj]
        self._obj_dadr = mt.jnt_dofadr[obj]
        self._target_qadr = mt.jnt_qposadr[mt.joint_names.index("target:joint")]
        self._obj_center_site = mt.site_names.index("object:center")
        self._parallel_quats = rotations.euler2quat(self._t(
            np.stack(rotations.get_parallel_rotations())))     # (24, 4)
        # the touch sensors' addresses (manipulate_touch_sensors.py:66-88)
        self._touch_adr = torch.as_tensor([
            mt.sensor_adr[s] for s in range(mt.nsensor)
            if mt.sensor_type[s] == 0 and mt.sensor_names[s].startswith("robot0:TS_")
        ], dtype=torch.int64, device=self.device)
        n_touch = len(self._touch_adr) if touch_obs else 0
        self.obs_dim, self.goal_dim, self.action_dim = 61 + n_touch, 7, 20

    # --- goal distance (manipulate.py:87-115) ---
    def _goal_distance(self, goal_a, goal_b):
        zero = torch.zeros(goal_a.shape[:-1], dtype=goal_a.dtype,
                           device=goal_a.device)
        d_pos, d_rot = zero, zero
        if self.target_position != "ignore":
            d_pos = torch.linalg.vector_norm(goal_a[..., :3] - goal_b[..., :3],
                                             dim=-1)
        if self.target_rotation != "ignore":
            quat_a, quat_b = goal_a[..., 3:], goal_b[..., 3:]
            if self.ignore_z_target_rotation:
                euler_a = rotations.quat2euler(quat_a)
                euler_b = rotations.quat2euler(quat_b)
                euler_a = torch.cat([euler_a[..., :2], euler_b[..., 2:]], dim=-1)
                quat_a = rotations.euler2quat(euler_a)
            quat_diff = rotations.quat_mul(quat_a, rotations.quat_conjugate(quat_b))
            d_rot = 2.0 * torch.arccos(torch.clamp(quat_diff[..., 0], -1.0, 1.0))
        return d_pos, d_rot

    def _is_success(self, achieved, desired):
        d_pos, d_rot = self._goal_distance(achieved, desired)
        return ((d_pos < self.distance_threshold)
                & (d_rot < self.rotation_threshold)).to(achieved.dtype)

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        if self.reward_type == "sparse":
            return self._is_success(achieved_goal, desired_goal) - 1.0
        d_pos, d_rot = self._goal_distance(achieved_goal, desired_goal)
        return -(10.0 * d_pos + d_rot)

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        return torch.zeros(achieved_goal.shape[:-1], dtype=torch.bool,
                           device=achieved_goal.device)

    # --- sampling ---
    def _uniform(self, generator, shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=self.device)
        return lo + (hi - lo) * u

    def _random_quat_offset(self, n, generator):
        """(n, 4) rotations of the target mode: about z, about z after one of
        the 24 axis-aligned rotations, or about a random axis."""
        angle = self._uniform(generator, (n,), -np.pi, np.pi)
        z = self._t([0.0, 0.0, 1.0]).expand(n, 3)
        if self.target_rotation == "z":
            return quat_from_angle_and_axis(angle, z)
        if self.target_rotation == "parallel":
            pick = torch.randint(len(self._parallel_quats), (n,),
                                 generator=generator, device=self.device)
            return rotations.quat_mul(quat_from_angle_and_axis(angle, z),
                                      self._parallel_quats[pick])
        axis = self._uniform(generator, (n, 3), -1.0, 1.0)   # xyz / ignore
        return quat_from_angle_and_axis(angle, axis)

    def _sample_goal(self, obj, generator):
        """(n, 7) goals of blocks at poses obj (n, 7)."""
        n = obj.shape[0]
        pos = obj[:, :3]
        if self.target_position == "random":
            r = self.target_position_range
            pos = pos + self._uniform(generator, (n, 3), r[:, 0], r[:, 1])
        if self.target_rotation in ("ignore", "fixed"):
            quat = obj[:, 3:7]
        else:
            quat = self._random_quat_offset(n, generator)
        return torch.cat([pos, _normalize(quat)], dim=-1)

    # --- obs ---
    def _get_obs(self, data, goal):
        nq, oq, od = self._robot_nq, self._obj_qadr, self._obj_dadr
        achieved = data.qpos[oq:oq + 7].T
        # touch values last (manipulate_touch_sensors.py:124-132)
        parts = [data.qpos[:nq].T, data.qvel[:nq].T, data.qvel[od:od + 6].T,
                 achieved]
        if self.touch_obs is not None:
            touch = data.sensordata[self._touch_adr].T
            if self.touch_obs == "boolean":
                touch = (touch > 0.0).to(touch.dtype)
            elif self.touch_obs == "log":
                touch = torch.log(touch + 1.0)
            parts.append(touch)
        return dict(observation=torch.cat(parts, dim=-1),
                    achieved_goal=achieved.contiguous(), desired_goal=goal)

    # --- states ---
    def _rest_data(self, n, obj=None):
        """Fresh Data of n envs at the initial pose, the block at obj
        (n, 7) where given."""
        data = pipeline.make_data(self.model, n)
        qpos = self._init_qpos[:, None].expand(-1, n).clone()
        if obj is not None:
            qpos[self._obj_qadr:self._obj_qadr + 7] = obj.T
        return dataclasses.replace(
            data, qpos=qpos,
            qvel=self._init_qvel[:, None].expand(-1, n).clone())

    def _settle(self, data):
        """10 x n_substeps with zero action (manipulate.py:217-222)."""
        n = data.qpos.shape[-1]
        zero = torch.zeros((n, self.action_dim), dtype=self.dtype,
                           device=self.device)
        return pipeline.step_n(self.model, data, self._apply_action(data, zero),
                               10 * self.n_substeps)

    def _settle_pool(self, n, generator):
        """(qpos (n, nq), qvel (n, nv)) of n randomized, settled block poses
        (manipulate.py:154-224); a block that fell off the palm keeps its
        unsettled pose."""
        oq = self._obj_qadr
        pos = self._init_qpos[oq:oq + 3].expand(n, 3)
        quat = self._init_qpos[oq + 3:oq + 7].expand(n, 4)
        if self.randomize_initial_rotation:
            quat = rotations.quat_mul(quat, self._random_quat_offset(n, generator))
        if self.randomize_initial_position and self.target_position != "fixed":
            pos = pos + 0.005 * torch.randn((n, 3), generator=generator,
                                            dtype=self.dtype, device=self.device)
        data = self._rest_data(n, torch.cat([pos, _normalize(quat)], dim=-1))
        settled = self._settle(data)
        on_palm = settled.site_xpos[self._obj_center_site, 2] > 0.04
        return (torch.where(on_palm, settled.qpos, data.qpos).T,
                torch.where(on_palm, settled.qvel, data.qvel).T)

    def _state(self, data, goal, aux) -> core.EnvState:
        """The reset state of ``data`` (the target joint parked at the goal,
        kinematics refreshed) with goals (n, 7)."""
        qpos = data.qpos.clone()
        qpos[self._target_qadr:self._target_qadr + 7] = goal.T
        data = pipeline.refresh_kin(self.model, dataclasses.replace(data, qpos=qpos))
        n = goal.shape[0]
        zeros = torch.zeros(n, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=self._get_obs(data, goal),
            reward=torch.zeros(n, dtype=self.dtype, device=self.device),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": torch.zeros(n, dtype=self.dtype,
                                            device=self.device)},
            goal=goal, steps=torch.zeros(n, dtype=torch.int32, device=self.device),
            aux=aux)

    # --- env API ---
    def initial(self, num_envs: int, generator) -> core.EnvState:
        """Settle each env's pool of ``reset_pool_size`` poses (all envs' pools
        as one batch), then reset from it."""
        P = self.reset_pool_size
        pq, pv = self._settle_pool(num_envs * P, generator)
        aux = {"pool_qpos": pq.reshape(num_envs, P, -1),
               "pool_qvel": pv.reshape(num_envs, P, -1)}
        template = core.EnvState(
            None, None, None, None, None, {}, None,
            torch.zeros(num_envs, dtype=torch.int32, device=self.device), aux)
        return self.reset(template, generator)

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch: a pool entry
        restored, a new goal drawn."""
        pool_q, pool_v = state.aux["pool_qpos"], state.aux["pool_qvel"]
        n, pool = pool_q.shape[:2]
        j = torch.randint(pool, (n,), generator=generator, device=self.device)
        env = torch.arange(n, device=self.device)
        data = dataclasses.replace(pipeline.make_data(self.model, n),
                                   qpos=pool_q[env, j].T.contiguous(),
                                   qvel=pool_v[env, j].T.contiguous())
        oq = self._obj_qadr
        goal = self._sample_goal(data.qpos[oq:oq + 7].T, generator)
        return self._state(data, goal, state.aux)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: the block's randomized pose (``obj_qpos7``
        (B, 7)) and the goal draws (``goal_offset`` (B, 3), ``goal_quat``
        (B, 4)) drawn on the host in the reference's order; the block
        settles here and the goal offset applies to its settled position,
        as the reference's _sample_goal after _reset_sim."""
        data = self._settle(self._rest_data(state.steps.shape[0],
                                            self._t(values["obj_qpos7"])))
        oq = self._obj_qadr
        obj = data.qpos[oq:oq + 7].T
        pos = obj[:, :3]
        if self.target_position == "random":
            pos = pos + self._t(values["goal_offset"])
        if self.target_rotation in ("ignore", "fixed"):
            quat = obj[:, 3:7]
        else:
            quat = self._t(values["goal_quat"])
        goal = torch.cat([pos, _normalize(quat)], dim=-1)
        return self._state(data, goal, state.aux)

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch (20 Euler substeps)."""
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        ctrl = self._apply_action(state.data, action)
        data = pipeline.step_n(self.model, state.data, ctrl, self.n_substeps)
        obs = self._get_obs(data, state.goal)
        achieved = obs["achieved_goal"]
        zeros = torch.zeros(achieved.shape[0], dtype=torch.bool,
                            device=self.device)
        return core.EnvState(
            data=data, obs=obs,
            reward=self.compute_reward(achieved, state.goal),
            terminated=zeros, truncated=zeros.clone(),
            info={"is_success": self._is_success(achieved, state.goal)},
            goal=state.goal, steps=state.steps + 1, aux=state.aux)


class HandManipulateBlockEnv(HandManipulateEnv):
    object_name = "block"
