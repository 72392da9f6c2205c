"""Franka Kitchen (port of gymnasium_robotics_tpu/envs/kitchen/kitchen.py
``KitchenEnv``; the reference's franka_env.py and kitchen_env.py).

A 9-DoF Franka arm in a kitchen with seven tasks (the burners, the light
switch, the slide and hinge cabinets, the microwave, the kettle), each a
target configuration of some of the scene's joints (OBS_ELEMENT_INDICES /
OBS_ELEMENT_GOALS, kitchen_env.py:27-45). The action (B, 9) in [-1, 1] is
a joint velocity (2 rad/s at 1), clipped to the velocity bounds and
integrated over the step's 40 substeps against the last *noisy* robot
position, which ``aux`` carries (franka_env.py:141-171; the reference's
non-Markov quirk is kept). Every observation, at reset and at each step,
adds uniform noise to the positions and velocities, the robot's at 0.01
of their amplitudes and the objects' at 0.0005 (franka_env.py:118-127,
kitchen_env.py:376-385; the object amplitudes are read from the same
slices as the reference's, ``pos_amp[8:29]`` and ``vel_amp[9:30]``).
Goals are dicts by task; reward is the number of tasks newly within 0.3
of their goal on this step; a completed task leaves
``tasks_to_complete``, and the episode terminates once every task has
been completed. Physics: the pair-topk pruned table (8 pairs a group),
8 contacts a condim group, 8 Newton and 4 line-search iterations (the
kitchen needs all eight, kitchen.py:80-82 of the JAX package), Euler.

Every method acts on the whole batch; the noise comes from the caller's
``torch.Generator``, or from the host under parity (``reset_with_values``
and ``step_with_values``, utils/parity.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.mjcf import serialize
from gymnasium_robotics_tpu_torch.physics import pipeline

OBS_ELEMENT_INDICES = {
    "bottom burner": [11, 12],
    "top burner": [15, 16],
    "light switch": [17, 18],
    "slide cabinet": [19],
    "hinge cabinet": [20, 21],
    "microwave": [22],
    "kettle": [23, 24, 25, 26, 27, 28, 29],
}
OBS_ELEMENT_GOALS = {
    "bottom burner": [-0.88, -0.01],
    "top burner": [-0.92, -0.01],
    "light switch": [-0.69, -0.05],
    "slide cabinet": [0.37],
    "hinge cabinet": [0.0, 1.45],
    "microwave": [-0.75],
    "kettle": [-0.23, 0.75, 1.62, 0.99, 0.0, 0.0, -0.06],
}
BONUS_THRESH = 0.3
NOISE_KEYS = ("robot_pos", "robot_vel", "obj_pos", "obj_vel")


class KitchenEnv:
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 12}
    frame_skip = 40

    def __init__(self, tasks_to_complete=None,
                 terminate_on_tasks_completed=True,
                 remove_task_when_completed=True, object_noise_ratio=0.0005,
                 robot_noise_ratio=0.01, max_episode_steps=None,
                 dtype=torch.float32, device=None):
        if tasks_to_complete is None:
            tasks_to_complete = tuple(OBS_ELEMENT_GOALS)   # every task
        self.tasks = tuple(tasks_to_complete)
        for t in self.tasks:
            if t not in OBS_ELEMENT_GOALS:
                raise ValueError(f"Unknown task {t}")
        self.terminate_on_tasks_completed = terminate_on_tasks_completed
        self.remove_task_when_completed = remove_task_when_completed
        self.object_noise_ratio = object_noise_ratio
        self.robot_noise_ratio = robot_noise_ratio
        self.max_episode_steps = max_episode_steps
        self.device = dev = _device.resolve(device)
        self.dtype = dtype
        model, extra = serialize.load_asset("kitchen/kitchen", dtype, dev)
        # pair_topk=8 compacts the 3,698-pair table (11,003 static slots)
        # to 760 slots; with contact_cap=8 the rows (188 at nv = 29) fit
        # the fused Newton; iterations=8 as the reference needs them
        self.model = model.with_options(
            contact_cap=8, pair_topk=8, iterations=8, ls_iterations=4,
            need_cfrc_ext=False)
        self._init_qpos = self._t(extra["initial_qpos"])     # (nq,)
        self._init_qvel = self._t(extra["initial_qvel"])     # (nv,)
        pos_bound, vel_bound = self._t(extra["pos_bound"]), self._t(extra["vel_bound"])
        self._pos_lo, self._pos_hi = pos_bound[:9, 0], pos_bound[:9, 1]
        self._vel_lo, self._vel_hi = vel_bound[:9, 0], vel_bound[:9, 1]
        pos_amp, vel_amp = self._t(extra["pos_noise_amp"]), self._t(extra["vel_noise_amp"])
        # the noise scales of the robot's and the objects' positions and
        # velocities, ratio times amplitude as the reference multiplies them
        self._amp = {"robot_pos": robot_noise_ratio * pos_amp[:9],
                     "robot_vel": robot_noise_ratio * vel_amp[:9],
                     "obj_pos": object_noise_ratio * pos_amp[8:29],
                     "obj_vel": object_noise_ratio * vel_amp[9:30]}
        # action -> joint velocity: the reference fixes act_mid = 0 and
        # act_rng = 2 rad/s (franka_env.py:80-81), not the ctrlrange
        self._act_rng = 2.0
        mt = self.model.meta
        self.dt = mt.opt.timestep * self.frame_skip
        self._noise_sizes = {"robot_pos": 9, "robot_vel": 9,
                             "obj_pos": mt.nq - 9, "obj_vel": mt.nv - 9}
        self._goal = {t: self._t(OBS_ELEMENT_GOALS[t]) for t in self.tasks}
        self._goal_idx = {t: torch.as_tensor(OBS_ELEMENT_INDICES[t], device=dev)
                          for t in self.tasks}
        self.goal_shapes = {t: len(OBS_ELEMENT_GOALS[t]) for t in self.tasks}
        self.obs_dim, self.action_dim = 59, 9

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # --- GoalEnv contract: goals are dicts by task (kitchen_env.py:356-369)
    def _completions(self, achieved, desired):
        return torch.stack([
            torch.linalg.vector_norm(achieved[t] - desired[t], dim=-1) < BONUS_THRESH
            for t in self.tasks], dim=-1)

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        comp = self._completions(achieved_goal, desired_goal)
        if info and "tasks_to_complete" in info:
            comp = comp & torch.as_tensor(info["tasks_to_complete"],
                                          device=comp.device)
        return torch.sum(comp, dim=-1).to(self.dtype)

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        done = torch.all(self._completions(achieved_goal, desired_goal), dim=-1)
        return done if self.terminate_on_tasks_completed else torch.zeros_like(done)

    # --- observation ---
    def _draw_noise(self, n, generator):
        """The four raw U(-1, 1) noise draws (n, size), in the reference's
        order."""
        return {k: 2.0 * torch.rand((n, self._noise_sizes[k]), generator=generator,
                                    dtype=self.dtype, device=self.device) - 1.0
                for k in NOISE_KEYS}

    def _get_obs(self, data, noise):
        """(obs, noisy robot qpos (B, 9)): the noisy positions and
        velocities (B, 59) and the goal dicts."""
        qpos, qvel = data.qpos.T, data.qvel.T
        a = self._amp
        robot_qpos = qpos[:, :9] + a["robot_pos"] * noise["robot_pos"]
        robot_qvel = qvel[:, :9] + a["robot_vel"] * noise["robot_vel"]
        obj_qpos = qpos[:, 9:] + a["obj_pos"] * noise["obj_pos"]
        obj_qvel = qvel[:, 9:] + a["obj_vel"] * noise["obj_vel"]
        n = qpos.shape[0]
        obs = dict(
            observation=torch.cat([robot_qpos, robot_qvel, obj_qpos, obj_qvel], dim=-1),
            achieved_goal={t: qpos[:, i] for t, i in self._goal_idx.items()},
            desired_goal={t: g.expand(n, -1) for t, g in self._goal.items()})
        return obs, robot_qpos

    # --- env API ---
    def initial(self, num_envs: int, generator) -> core.EnvState:
        return self._reset_with_noise(self._draw_noise(num_envs, generator))

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: the four U(-1, 1) noise draws (B, size) came
        from the host in the reference's order (utils/parity.py)."""
        return self._reset_with_noise({k: self._t(values[k]) for k in NOISE_KEYS})

    def _reset_with_noise(self, noise) -> core.EnvState:
        n = noise["robot_pos"].shape[0]
        data = dataclasses.replace(
            pipeline.make_data(self.model, n),
            qpos=self._init_qpos[:, None].expand(-1, n).clone(),
            qvel=self._init_qvel[:, None].expand(-1, n).clone())
        data = pipeline.refresh_kin(self.model, data, com=False)
        obs, last_qpos = self._get_obs(data, noise)
        dev = self.device
        ones = torch.ones((n, len(self.tasks)), dtype=torch.bool, device=dev)
        zeros = torch.zeros(n, dtype=torch.bool, device=dev)
        return core.EnvState(
            data=data, obs=obs,
            reward=torch.zeros(n, dtype=self.dtype, device=dev),
            terminated=zeros, truncated=zeros.clone(),
            info={"tasks_to_complete": ones,
                  "step_task_completions": ~ones,
                  "episode_task_completions": ~ones},
            goal=torch.zeros((n, 0), dtype=self.dtype, device=dev),
            steps=torch.zeros(n, dtype=torch.int32, device=dev),
            aux={"last_robot_qpos": last_qpos, "tasks_to_complete": ones.clone(),
                 "episode_task_completions": ~ones})

    def step(self, state: core.EnvState, action, generator=None) -> core.EnvState:
        """One env step of the batch (40 Euler substeps), its observation
        noise drawn from ``generator``."""
        n = state.steps.shape[0]
        return self._step_with_noise(state, action, self._draw_noise(n, generator))

    def step_with_values(self, state: core.EnvState, action, values) -> core.EnvState:
        """Parity-mode step: the observation noise (four U(-1, 1) draws
        (B, size)) came from the host in the reference's order."""
        return self._step_with_noise(state, action,
                                     {k: self._t(values[k]) for k in NOISE_KEYS})

    def _step_with_noise(self, state, action, noise) -> core.EnvState:
        action = torch.clamp(torch.as_tensor(action, dtype=self.dtype,
                                             device=self.device), -1.0, 1.0)
        vel = torch.clamp(action * self._act_rng, self._vel_lo, self._vel_hi)
        ctrl = torch.clamp(state.aux["last_robot_qpos"] + vel * self.dt,
                           self._pos_lo, self._pos_hi)
        data = pipeline.step_n(self.model, state.data, ctrl.T, self.frame_skip)
        obs, last_qpos = self._get_obs(data, noise)
        comp = self._completions(obs["achieved_goal"], obs["desired_goal"])
        todo = state.aux["tasks_to_complete"]
        step_comp = comp & todo
        if self.remove_task_when_completed:
            todo = todo & ~step_comp
        episode_comp = state.aux["episode_task_completions"] | step_comp
        terminated = (torch.all(episode_comp, dim=-1)
                      if self.terminate_on_tasks_completed
                      else torch.zeros_like(episode_comp[:, 0]))
        return core.EnvState(
            data=data, obs=obs, reward=torch.sum(step_comp, dim=-1).to(self.dtype),
            terminated=terminated, truncated=torch.zeros_like(terminated),
            info={"tasks_to_complete": todo, "step_task_completions": step_comp,
                  "episode_task_completions": episode_comp},
            goal=state.goal, steps=state.steps + 1,
            aux={"last_robot_qpos": last_qpos, "tasks_to_complete": todo,
                 "episode_task_completions": episode_comp})
