"""Maze bookkeeping and model loading (port of
gymnasium_robotics_tpu/envs/maze/maze_core.py: ``MazeSpec``,
``analyze_maze``, ``maze_asset_key`` :143, ``build_point_maze_model`` :153).

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


def build_point_maze_model(maze_map, size_scaling=1.0, height=0.4,
                           dtype=torch.float32, device=None):
    """(Model, MazeSpec) for a maze: the shipped compiled model of the map."""
    spec = analyze_maze(maze_map, size_scaling, height)
    path = serialize.asset_path(
        maze_asset_key("point_maze", maze_map, size_scaling, height)
    )
    if not os.path.exists(path):
        raise NotImplementedError(
            f"no shipped model for this maze map ({path}); compiling a custom "
            "map (mjcf/import_mjcf.py) is not ported yet"
        )
    model, _ = serialize.load_model(path, dtype=dtype, device=device)
    return model, spec
