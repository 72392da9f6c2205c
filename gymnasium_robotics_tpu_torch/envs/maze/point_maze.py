"""PointMaze family: a 2-DoF force-actuated ball in a compiled maze (port of
gymnasium_robotics_tpu/envs/maze/point_maze.py).

obs = [qpos(2), qvel(2)], achieved_goal = qpos[:2]; actions clipped to
[-1, 1] and velocity clipped to +-5 before each step; dense reward exp(-d)
or sparse (d <= 0.45); continuing-task goal respawn; the reset position is
drawn >= 0.5*scale from the goal by masked fixed-K resampling. Every method
acts on the whole batch; the reset noise comes from a ``torch.Generator``
on the env's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.envs.maze import maps, maze_core
from gymnasium_robotics_tpu_torch.physics import pipeline


class PointMazeEnv(maze_core.MazeTask):
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 50}

    def __init__(self, maze_map=None, reward_type: str = "sparse",
                 continuing_task: bool = True, reset_target: bool = False,
                 position_noise_range: float = 0.25, max_episode_steps=None,
                 dtype=torch.float32, device=None):
        self.device = _device.resolve(device)
        maze_map = maze_map if maze_map is not None else maps.U_MAZE
        model, self.maze = maze_core.build_point_maze_model(
            maze_map, size_scaling=1.0, height=0.4, dtype=dtype,
            device=self.device,
        )
        # the ball meets a handful of walls at most: a few Newton
        # iterations converge, and nothing reads contact forces
        self.model = model.with_options(
            iterations=6, ls_iterations=4, need_cfrc_ext=False
        )
        self.reward_type = reward_type
        self.continuing_task = continuing_task
        self.reset_target = reset_target
        self.position_noise_range = position_noise_range
        self.max_episode_steps = max_episode_steps
        self.dtype = dtype
        self.obs_dim, self.goal_dim, self.action_dim = 4, 2, 2
        self._init_locations()

    # --- env API ---
    def _get_obs(self, data, goal):
        return dict(
            observation=torch.cat([data.qpos, data.qvel]).T.contiguous(),
            achieved_goal=data.qpos[:2].T.contiguous(),
            desired_goal=goal,
        )

    def _reset_state(self, B, goal, reset_xy) -> core.EnvState:
        data = pipeline.make_data(self.model, B)
        data.qpos[:2] = reset_xy.T
        zeros_b = torch.zeros(B, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=self._get_obs(data, goal),
            reward=torch.zeros(B, dtype=self.dtype, device=self.device),
            terminated=zeros_b, truncated=zeros_b.clone(),
            info={"success": zeros_b.clone()},
            goal=goal,
            steps=torch.zeros(B, dtype=torch.int32, device=self.device),
        )

    def initial(self, num_envs: int, generator) -> core.EnvState:
        goal = self._sample_goal(num_envs, generator)
        return self._reset_state(
            num_envs, goal, self._sample_reset(generator, goal)
        )

    def initial_with_options(self, num_envs: int, generator,
                             options) -> core.EnvState:
        """A reset with explicit ``goal_cell`` / ``reset_cell`` (row, col)
        options (maze_v4.py:299-358 in the reference): each given cell's
        centre with the usual position noise, the rest drawn as by
        ``initial``."""
        state = self.initial(num_envs, generator)
        goal, reset_xy = state.goal, state.data.qpos[:2].T

        def cell(key):
            xy = self.maze.cell_rowcol_to_xy(options[key])
            return self._add_noise(generator, torch.as_tensor(
                xy, dtype=self.dtype, device=self.device).expand(num_envs, 2))

        if options.get("goal_cell") is not None:
            goal = cell("goal_cell")
        if options.get("reset_cell") is not None:
            reset_xy = cell("reset_cell")
        return self._reset_state(num_envs, goal, reset_xy)

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: goal and reset positions drawn on the host
        ((B, 2) each, under ``goal_xy`` / ``reset_xy``) are injected."""

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                   device=self.device)

        return self._reset_state(
            state.steps.shape[0], t(values["goal_xy"]), t(values["reset_xy"])
        )

    def step(self, state: core.EnvState, action, generator) -> core.EnvState:
        """One env step of the batch; ``generator`` draws a respawned goal
        (continuing task with ``reset_target``)."""
        action = torch.clamp(
            torch.as_tensor(action, dtype=self.dtype, device=self.device),
            -1.0, 1.0,
        )
        # the inner PointEnv clips qvel to +-5 before stepping
        data = dataclasses.replace(
            state.data, qvel=torch.clamp(state.data.qvel, -5.0, 5.0)
        )
        data = pipeline.step_n(self.model, data, action.T.contiguous(), 1)

        achieved = data.qpos[:2].T
        reached = torch.linalg.vector_norm(achieved - state.goal, dim=-1) <= 0.45
        goal = self._respawn_goal(generator, achieved, state.goal, reached)

        return core.EnvState(
            data=data, obs=self._get_obs(data, goal),
            reward=self.compute_reward(achieved, state.goal),
            terminated=self.compute_terminated(achieved, state.goal),
            truncated=torch.zeros_like(reached),
            info={"success": reached},
            goal=goal,
            steps=state.steps + 1,
        )
