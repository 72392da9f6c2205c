"""Reference-exact reset randomness (port of
gymnasium_robotics_tpu/utils/parity.py for the families the port has).

The reference seeds one ``numpy.random.Generator`` per env and draws its
reset randomness in a family-specific order (maze ``generate_target_goal``
/ ``generate_reset_pos`` / ``add_xy_position_noise``, maze_v4.py:276-368;
fetch ``_reset_sim`` then ``_sample_goal``, fetch_env.py:153-166 and
:376-402). These families draw nothing during a step, so the step needs
no sampler here (the kitchen's observation noise, franka_env.py:118-127,
is the first that will). No on-device generator reproduces those sequences, so parity
mode draws them on the host with a real NumPy Generator in the reference's
order and injects the values through the env's ``reset_with_values``.
Host-side numpy only: this module imports neither torch nor the JAX
package.
"""

from __future__ import annotations

import numpy as np


def sample_reset_values(env, np_random: np.random.Generator, options=None):
    """The reset randomness of one ``env`` instance, drawn from
    ``np_random`` in the reference's order: the value dict for
    ``env.reset_with_values`` (unbatched arrays). Raises for a family the
    port does not have."""
    name = type(env).__name__
    if name in ("PointMazeEnv", "AntMazeEnv"):
        return _maze_values(env, np_random, options)
    if name in ("FetchPushEnv", "FetchPickAndPlaceEnv"):
        return _fetch_values(env, np_random)
    raise NotImplementedError(
        f"no parity sampler for {name}: the port has the maze and "
        "FetchPush/FetchPickAndPlace families so far")


def _maze_values(env, rng: np.random.Generator, options=None):
    """maze_v4.py:276-368: the goal cell and its xy noise, then the
    rejection-sampled reset cell and its xy noise; goal_cell / reset_cell
    options replace the cell draws (maze_v4.py:299-358) and keep the noise
    draws."""
    maze = env.maze
    goal_locs = [np.array(g, np.float64) for g in maze.goal_locations]
    reset_locs = [np.array(r, np.float64) for r in maze.reset_locations]
    scale = maze.size_scaling
    nr = env.position_noise_range
    options = options or {}

    def add_noise(xy):
        xy = xy.copy()
        xy[0] += rng.uniform(-nr, nr) * scale
        xy[1] += rng.uniform(-nr, nr) * scale
        return xy

    if options.get("goal_cell") is not None:
        goal = np.asarray(maze.cell_rowcol_to_xy(options["goal_cell"]),
                          np.float64)
    else:
        goal = goal_locs[rng.integers(low=0, high=len(goal_locs))].copy()
    goal = add_noise(goal)
    if options.get("reset_cell") is not None:
        reset_pos = np.asarray(maze.cell_rowcol_to_xy(options["reset_cell"]),
                               np.float64)
    else:
        reset_pos = goal.copy()
        while np.linalg.norm(reset_pos - goal) <= 0.5 * scale:
            reset_pos = reset_locs[
                rng.integers(low=0, high=len(reset_locs))].copy()
    reset_pos = add_noise(reset_pos)
    return {"goal_xy": goal, "reset_xy": reset_pos}


def _fetch_values(env, rng: np.random.Generator):
    """fetch_env.py:376-402 (the object placement, redrawn until 0.1 from
    the gripper) then :153-166 (the goal): the object's draws come first.
    Both ported tasks have an object and no target offset."""
    grip0 = np.asarray(env._init_grip.detach().cpu().numpy(), np.float64)
    object_xpos = grip0[:2]
    while np.linalg.norm(object_xpos - grip0[:2]) < 0.1:
        object_xpos = grip0[:2] + rng.uniform(-env.obj_range, env.obj_range,
                                              size=2)
    goal = grip0[:3] + rng.uniform(-env.target_range, env.target_range,
                                   size=3)
    goal[2] = float(env._height_offset)
    if env.target_in_the_air and rng.uniform() < 0.5:
        goal[2] += rng.uniform(0, 0.45)
    return {"object_xy": object_xpos, "goal": goal}
