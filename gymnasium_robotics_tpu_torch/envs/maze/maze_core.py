"""Maze bookkeeping, model loading and the maze task shared by the
PointMaze and AntMaze families (port of
gymnasium_robotics_tpu/envs/maze/maze_core.py: ``MazeSpec``,
``analyze_maze``, ``maze_asset_key`` :143, ``build_point_maze_model`` :153,
of ``ant_maze.build_ant_maze_model`` :28, and of the goal functions and
sampling both maze envs carry).

Every registered map ships a compiled model; the port loads it by the same
content key. A map with no shipped model raises: compiling MJCF at run time
(mjcf/import_mjcf.py in the JAX package) is a later slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Tuple, Union

import numpy as np
import torch

from gymnasium_robotics_tpu_torch.envs.maze import maps
from gymnasium_robotics_tpu_torch.mjcf import serialize


@dataclasses.dataclass(frozen=True)
class MazeSpec:
    maze_map: Tuple[Tuple[Union[int, str], ...], ...]
    size_scaling: float
    height: float
    map_length: int
    map_width: int
    x_center: float
    y_center: float
    goal_locations: Tuple[Tuple[float, float], ...]
    reset_locations: Tuple[Tuple[float, float], ...]

    def cell_rowcol_to_xy(self, rowcol):
        i, j = rowcol
        return np.array(
            [
                (j + 0.5) * self.size_scaling - self.x_center,
                self.y_center - (i + 0.5) * self.size_scaling,
            ]
        )


def analyze_maze(maze_map: List[List], size_scaling: float, height: float) -> MazeSpec:
    """r/g/c cells feed the goal and reset candidate sets; with none
    present, empty cells do."""
    length, width = len(maze_map), len(maze_map[0])
    x_center = width / 2 * size_scaling
    y_center = length / 2 * size_scaling
    goals, resets, combined, empty = [], [], [], []
    for i in range(length):
        for j in range(width):
            struct = maze_map[i][j]
            x = (j + 0.5) * size_scaling - x_center
            y = y_center - (i + 0.5) * size_scaling
            if struct == 1:
                continue
            elif struct == maps.RESET:
                resets.append((x, y))
            elif struct == maps.GOAL:
                goals.append((x, y))
            elif struct == maps.COMBINED:
                combined.append((x, y))
            else:
                empty.append((x, y))
    if not goals and not resets and not combined:
        combined = empty
    elif not resets and not combined:
        resets = empty
    elif not goals and not combined:
        goals = empty
    return MazeSpec(
        maze_map=tuple(tuple(r) for r in maze_map),
        size_scaling=size_scaling,
        height=height,
        map_length=length,
        map_width=width,
        x_center=x_center,
        y_center=y_center,
        goal_locations=tuple(goals + combined),
        reset_locations=tuple(resets + combined),
    )


def maze_asset_key(prefix: str, maze_map, size_scaling, height) -> str:
    h = hashlib.sha1(
        json.dumps([maze_map, size_scaling, height]).encode()
    ).hexdigest()[:12]
    return f"{prefix}/{h}"


def _load_maze_model(prefix, maze_map, size_scaling, height, dtype, device):
    spec = analyze_maze(maze_map, size_scaling, height)
    path = serialize.asset_path(
        maze_asset_key(prefix, maze_map, size_scaling, height)
    )
    if not os.path.exists(path):
        raise NotImplementedError(
            f"no shipped model for this maze map ({path}); compiling a custom "
            "map (mjcf/import_mjcf.py) is not ported yet (ROADMAP A.8)"
        )
    model, _ = serialize.load_model(path, dtype=dtype, device=device)
    return model, spec


def build_point_maze_model(maze_map, size_scaling=1.0, height=0.4,
                           dtype=torch.float32, device=None):
    """(Model, MazeSpec) for a maze: the shipped compiled model of the map."""
    return _load_maze_model("point_maze", maze_map, size_scaling, height,
                            dtype, device)


def build_ant_maze_model(maze_map, size_scaling=4.0, height=0.5,
                         dtype=torch.float32, device=None):
    """(Model, MazeSpec) of the ant in a maze: the shipped compiled model of
    the map (the JAX package injects the maze's wall boxes into gymnasium's
    ant.xml and compiles it)."""
    return _load_maze_model("ant_maze", maze_map, size_scaling, height,
                            dtype, device)


_K = 16  # candidates of the fixed-K resampling


class MazeTask:
    """The maze goal logic both maze envs share (maze_v4.py:381-418 in the
    reference): dense exp(-d) or sparse d <= 0.45 reward, termination on
    reaching the goal unless the task continues, goals and resets drawn
    around the maze's cells with uniform noise of +-position_noise_range
    cells. Every method acts on a batch; the noise comes from a
    ``torch.Generator`` on the env's device. The env sets ``maze``,
    ``device``, ``dtype``, ``reward_type``, ``continuing_task`` and
    ``position_noise_range``, then calls ``_init_locations``."""

    def _init_locations(self):
        def locs(xy):
            return torch.as_tensor(np.array(xy, dtype=np.float64),
                                   dtype=self.dtype, device=self.device)

        self._goal_locs = locs(self.maze.goal_locations)
        self._reset_locs = locs(self.maze.reset_locations)

    # --- GoalEnv functions ---
    def compute_reward(self, achieved_goal, desired_goal, info=None):
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        if self.reward_type == "dense":
            return torch.exp(-d)
        return (d <= 0.45).to(self.dtype)

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        if self.continuing_task:
            return torch.zeros_like(d, dtype=torch.bool)
        return d <= 0.45

    # --- sampling ---
    def _add_noise(self, gen, xy):
        r = self.position_noise_range
        u = torch.rand(xy.shape, generator=gen, dtype=self.dtype,
                       device=self.device)
        return xy + (u * (2 * r) - r) * self.maze.size_scaling

    def _sample_goal(self, B, gen):
        idx = torch.randint(len(self._goal_locs), (B,), generator=gen,
                            device=self.device)
        return self._add_noise(gen, self._goal_locs[idx])

    @staticmethod
    def _first_valid(cands, dists, valid):
        """Per env: the first valid candidate, else the farthest."""
        first = torch.argmax(valid.to(torch.int8), dim=1)
        pick = torch.where(valid.any(dim=1), first, torch.argmax(dists, dim=1))
        return cands[torch.arange(cands.shape[0], device=cands.device), pick]

    def _sample_reset(self, gen, goal):
        """Masked fixed-K retry of the reference rejection loop: a candidate
        must lie >= 0.5*scale from the goal."""
        idxs = torch.randint(len(self._reset_locs), (goal.shape[0], _K),
                             generator=gen, device=self.device)
        cands = self._reset_locs[idxs]                      # (B, K, 2)
        dists = torch.linalg.vector_norm(cands - goal[:, None], dim=-1)
        pick = self._first_valid(
            cands, dists, dists > 0.5 * self.maze.size_scaling
        )
        return self._add_noise(gen, pick)

    def _resample_far_goal(self, gen, achieved):
        idxs = torch.randint(len(self._goal_locs), (achieved.shape[0], _K),
                             generator=gen, device=self.device)
        cands = self._add_noise(gen, self._goal_locs[idxs])
        dists = torch.linalg.vector_norm(cands - achieved[:, None], dim=-1)
        return self._first_valid(cands, dists, dists > 0.45)

    def _respawn_goal(self, gen, achieved, goal, reached):
        """Continuing task with reset_target: a reached goal is redrawn far
        from the agent."""
        if (self.continuing_task and self.reset_target
                and len(self.maze.goal_locations) > 1):
            new_goal = self._resample_far_goal(gen, achieved)
            goal = torch.where(reached[:, None], new_goal, goal)
        return goal
