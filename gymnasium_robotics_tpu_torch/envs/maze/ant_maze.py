"""AntMaze family: the Ant in a compiled maze (port of
gymnasium_robotics_tpu/envs/maze/ant_maze.py, v3/v4/v5 semantics).

The inner ant has exclude_current_positions_from_observation=False and
reset_noise_scale=0: achieved_goal = torso xy = ant_obs[:2], observation =
ant_obs[2:], where ant_obs = [qpos, qvel] and, for v5 only, the clipped
contact forces cfrc_ext[1:] (a 105-dim observation; 27 for v3/v4). The
inner env's reward and termination are discarded; the maze goal logic
(maze_core.MazeTask) gives them. Physics: RK4, 5 substeps per env step,
pair-topk pruned contacts (pair_topk=8) capped at 16 per env, 5 Newton and
4 line-search iterations. Every method acts on the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.envs.maze import maps, maze_core
from gymnasium_robotics_tpu_torch.physics import pipeline


class AntMazeEnv(maze_core.MazeTask):
    # the reference's frame rate; no render mode until rendering is ported
    metadata = {"render_modes": [], "render_fps": 50}

    def __init__(self, maze_map=None, reward_type: str = "sparse",
                 continuing_task: bool = True, reset_target: bool = False,
                 position_noise_range: float = 0.25, version: str = "v5",
                 max_episode_steps=None, dtype=torch.float32, device=None):
        self.device = _device.resolve(device)
        maze_map = maze_map if maze_map is not None else maps.U_MAZE
        model, self.maze = maze_core.build_ant_maze_model(
            maze_map, size_scaling=4.0, height=0.5, dtype=dtype,
            device=self.device,
        )
        # at most ~16 simultaneous contacts; the 216-pair leg x wall group
        # is pruned to its 8 nearest pairs per env; only v5 observes
        # contact forces (ant_maze_v5.py:244-253 in the reference)
        self.model = model.with_options(
            contact_cap=16, iterations=5, ls_iterations=4, pair_topk=8,
            need_cfrc_ext=version == "v5",
        )
        self.version = version
        # the inner ant's settings that the maze task reads
        self.frame_skip = 5
        self.include_cfrc = include_cfrc = version == "v5"
        self.contact_force_range = (-1.0, 1.0)
        self.reward_type = reward_type
        self.continuing_task = continuing_task
        self.reset_target = reset_target
        self.position_noise_range = position_noise_range
        self.max_episode_steps = max_episode_steps
        self.dtype = dtype
        self._init_locations()
        mt = self.model.meta
        self.obs_dim = mt.nq + mt.nv - 2 + (
            (mt.nbody - 1) * 6 if include_cfrc else 0)
        self.goal_dim, self.action_dim = 2, 8

    def _ant_obs(self, data):
        """(B, nq + nv [+ (nbody - 1) * 6]) inner-ant observation."""
        parts = [data.qpos, data.qvel]
        if self.include_cfrc:
            lo, hi = self.contact_force_range
            cfrc = torch.clamp(data.cfrc_ext[1:], lo, hi)
            parts.append(cfrc.reshape(-1, cfrc.shape[-1]))
        return torch.cat(parts).T

    def _get_obs(self, data, goal):
        ant = self._ant_obs(data)
        return dict(
            observation=ant[:, 2:].contiguous(),
            achieved_goal=ant[:, :2].contiguous(),
            desired_goal=goal,
        )

    def _reset_state(self, B, goal, reset_xy) -> core.EnvState:
        data = pipeline.make_data(self.model, B)
        data.qpos[:2] = reset_xy.T                 # reset_noise_scale = 0
        data = pipeline.refresh_kin(self.model, data, com=False)
        obs = self._get_obs(data, goal)
        success = torch.linalg.vector_norm(
            obs["achieved_goal"] - goal, dim=-1) <= 0.45
        zeros_b = torch.zeros(B, dtype=torch.bool, device=self.device)
        return core.EnvState(
            data=data, obs=obs,
            reward=torch.zeros(B, dtype=self.dtype, device=self.device),
            terminated=zeros_b, truncated=zeros_b.clone(),
            info={"success": success}, goal=goal,
            steps=torch.zeros(B, dtype=torch.int32, device=self.device),
        )

    def initial(self, num_envs: int, generator) -> core.EnvState:
        goal = self._sample_goal(num_envs, generator)
        return self._reset_state(
            num_envs, goal, self._sample_reset(generator, goal)
        )

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        """A freshly reset state for every env of the batch."""
        return self.initial(state.steps.shape[0], generator)

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """Parity-mode reset: goal and torso positions drawn on the host
        ((B, 2) each, under ``goal_xy`` / ``reset_xy``) are injected."""

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                   device=self.device)

        return self._reset_state(
            state.steps.shape[0], t(values["goal_xy"]), t(values["reset_xy"])
        )

    def step(self, state: core.EnvState, action, generator) -> core.EnvState:
        """One env step of the batch (5 RK4 substeps); ``generator`` draws a
        respawned goal (continuing task with ``reset_target``)."""
        action = torch.clamp(
            torch.as_tensor(action, dtype=self.dtype, device=self.device),
            -1.0, 1.0,
        )
        data = pipeline.step_n(self.model, state.data, action.T.contiguous(),
                               self.frame_skip)
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
