"""Reference-exact reset randomness (port of
gymnasium_robotics_tpu/utils/parity.py for the families the port has).

The reference seeds one ``numpy.random.Generator`` per env and draws its
reset randomness in a family-specific order (maze ``generate_target_goal``
/ ``generate_reset_pos`` / ``add_xy_position_noise``, maze_v4.py:276-368;
fetch ``_reset_sim`` then ``_sample_goal``, fetch_env.py:153-166 and
:376-402; hand reach ``_sample_goal``, reach.py:99-126; hand manipulation
``_reset_sim`` then ``_sample_goal``, manipulate.py:154-279; Adroit
``reset_model``, adroit_door.py:359-371 and its siblings; the kitchen's
observation noise, franka_env.py:118-127 and kitchen_env.py:376-385). The
kitchen alone also draws during a step: its observation noise, at every
step. No on-device generator reproduces those sequences, so parity mode
draws them on the host with a real NumPy Generator in the reference's
order and injects the values through the env's ``reset_with_values``
(and the kitchen's ``step_with_values``).
The draws are host-side numpy: this module reads the env's tensors as
numpy arrays and imports nothing of the JAX package.
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
    if name in ("FetchReachEnv", "FetchPushEnv", "FetchSlideEnv",
                "FetchPickAndPlaceEnv"):
        return _fetch_values(env, np_random)
    if name == "HandReachEnv":
        return _hand_reach_values(env, np_random)
    if name == "HandManipulateBlockEnv":
        return _hand_manipulate_values(env, np_random)
    if name.startswith("AdroitHand"):
        return _adroit_values(env, np_random)
    if name == "KitchenEnv":
        return _kitchen_noise(env, np_random)
    raise NotImplementedError(
        f"no parity sampler for {name}: the port has the maze, Fetch, "
        "HandReach, HandManipulateBlock, Adroit and Kitchen families so "
        "far; each other family's sampler comes with its slice (ROADMAP "
        "queue A)")


def sample_step_values(env, np_random: np.random.Generator):
    """The randomness one ``env`` instance draws during a step, from
    ``np_random`` in the reference's order: the value dict for
    ``env.step_with_values``, or None for a family that draws nothing
    there (every ported family but the kitchen)."""
    if type(env).__name__ == "KitchenEnv":
        return _kitchen_noise(env, np_random)
    return None


def _kitchen_noise(env, rng: np.random.Generator):
    """franka_env.py:118-127 then kitchen_env.py:376-385: the robot's
    position and velocity noise, then the objects' position and velocity
    noise, as raw U(-1, 1) vectors (the env scales them)."""
    nq, nv = env.model.meta.nq, env.model.meta.nv
    return {
        "robot_pos": rng.uniform(low=-1.0, high=1.0, size=9),
        "robot_vel": rng.uniform(low=-1.0, high=1.0, size=9),
        "obj_pos": rng.uniform(low=-1.0, high=1.0, size=nq - 9),
        "obj_vel": rng.uniform(low=-1.0, high=1.0, size=nv - 9),
    }


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
    the gripper; only a task with an object draws it) then :153-166 (the
    goal; with an object it is moved by the target offset and put at the
    table's height, then lifted at random where the target may be in the
    air): the object's draws come first."""
    grip0 = np.asarray(env._init_grip.detach().cpu().numpy(), np.float64)
    values = {}
    if env.has_object:
        object_xpos = grip0[:2]
        while np.linalg.norm(object_xpos - grip0[:2]) < 0.1:
            object_xpos = grip0[:2] + rng.uniform(-env.obj_range,
                                                  env.obj_range, size=2)
        values["object_xy"] = object_xpos
    goal = grip0[:3] + rng.uniform(-env.target_range, env.target_range,
                                   size=3)
    if env.has_object:
        goal += np.asarray(env.target_offset, np.float64)
        goal[2] = float(env._height_offset)
        if env.target_in_the_air and rng.uniform() < 0.5:
            goal[2] += rng.uniform(0, 0.45)
    values["goal"] = goal
    return values


# --- host-side float64 rotation helpers, formula for formula the
# reference's utils/rotations.py:140-160 (euler2quat, 'xyz' convention, wxyz
# quaternions) and :280-304 (quat_mul) ---

def _euler2quat(euler):
    euler = np.asarray(euler, np.float64)
    ai, aj, ak = euler[2] / 2, -euler[1] / 2, euler[0] / 2
    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return np.array([cj * cc + sj * ss, cj * cs - sj * sc,
                     -(cj * ss + sj * cc), cj * sc - sj * cs])


def _quat_mul(q1, q0):
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array([
        w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
        w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
        w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
        w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
    ])


def _quat_from_angle_and_axis(angle, axis):
    """manipulate.py:12-18: normalized axis, normalized quat."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    quat = np.concatenate([[np.cos(angle / 2.0)], np.sin(angle / 2.0) * axis])
    return quat / np.linalg.norm(quat)


def _parallel_quats():
    """euler2quat over the 24 axis-aligned rotations, in the reference's
    order (manipulate.py; its rotations.py:394-408)."""
    from gymnasium_robotics_tpu_torch.utils import rotations

    return [_euler2quat(r) for r in rotations.get_parallel_rotations()]


def _hand_reach_values(env, rng: np.random.Generator):
    """reach.py:99-126: the finger's draw, the meeting point's normal
    noise, then the 10 % revert to the initial pattern; the palm and the
    initial pattern as the env holds them."""
    finger_names = ["robot0:S_fftip", "robot0:S_mftip", "robot0:S_rftip",
                    "robot0:S_lftip"]
    finger_idx = finger_names.index(rng.choice(finger_names))
    thumb_idx = 4
    palm = np.asarray(env._palm_xpos.cpu().numpy(), np.float64)
    initial_goal = np.asarray(env._initial_goal.cpu().numpy(), np.float64)
    meeting = palm + np.array([0.0, -0.09, 0.05])
    meeting = meeting + rng.normal(scale=0.005, size=3)
    goal = initial_goal.copy().reshape(-1, 3)
    for idx in (thumb_idx, finger_idx):
        direction = meeting - goal[idx]
        direction /= np.linalg.norm(direction)
        goal[idx] = meeting - 0.005 * direction
    if rng.uniform() < 0.1:
        goal = initial_goal.copy().reshape(-1, 3)
    return {"goal": goal.reshape(-1)}


def _hand_manipulate_values(env, rng: np.random.Generator):
    """manipulate.py:172-202 (_reset_sim's block randomization: the rotation
    by target_rotation mode, then the position's normal noise) followed by
    :226-279 (_sample_goal: the position offset, then the goal quaternion's
    draws). The settle between them draws nothing."""
    init_q = np.asarray(env._init_qpos.cpu().numpy(), np.float64)
    qadr = int(env._obj_qadr)
    pos0 = init_q[qadr:qadr + 3].copy()
    quat0 = init_q[qadr + 3:qadr + 7].copy()
    tr = env.target_rotation
    if env.randomize_initial_rotation:
        if tr == "z":
            angle = rng.uniform(-np.pi, np.pi)
            quat0 = _quat_mul(
                quat0, _quat_from_angle_and_axis(angle, [0.0, 0.0, 1.0]))
        elif tr == "parallel":
            angle = rng.uniform(-np.pi, np.pi)
            zq = _quat_from_angle_and_axis(angle, [0.0, 0.0, 1.0])
            pqs = _parallel_quats()
            pq = pqs[rng.integers(len(pqs))]
            quat0 = _quat_mul(quat0, _quat_mul(zq, pq))
        elif tr in ("xyz", "ignore"):
            angle = rng.uniform(-np.pi, np.pi)
            axis = rng.uniform(-1.0, 1.0, size=3)
            quat0 = _quat_mul(quat0, _quat_from_angle_and_axis(angle, axis))
    if env.randomize_initial_position and env.target_position != "fixed":
        pos0 = pos0 + rng.normal(size=3, scale=0.005)
    quat0 /= np.linalg.norm(quat0)

    goal_offset = np.zeros(3)
    if env.target_position == "random":
        tpr = np.asarray(env.target_position_range.cpu().numpy(), np.float64)
        goal_offset = rng.uniform(tpr[:, 0], tpr[:, 1])
    goal_quat = np.array([1.0, 0.0, 0.0, 0.0])
    if tr == "z":
        goal_quat = _quat_from_angle_and_axis(
            rng.uniform(-np.pi, np.pi), [0.0, 0.0, 1.0])
    elif tr == "parallel":
        goal_quat = _quat_from_angle_and_axis(
            rng.uniform(-np.pi, np.pi), [0.0, 0.0, 1.0])
        pqs = _parallel_quats()
        goal_quat = _quat_mul(goal_quat, pqs[rng.integers(len(pqs))])
    elif tr == "xyz":
        angle = rng.uniform(-np.pi, np.pi)
        axis = rng.uniform(-1.0, 1.0, size=3)
        goal_quat = _quat_from_angle_and_axis(angle, axis)
    return {"obj_qpos7": np.concatenate([pos0, quat0]),
            "goal_offset": goal_offset, "goal_quat": goal_quat}


def _adroit_values(env, rng: np.random.Generator):
    """reset_model's draws, one value dict of the env's scene (the keys of
    its ``aux``): adroit_door.py:359-371 (the door's position),
    adroit_hammer.py:374 (the board's height), adroit_pen.py:380-383 (the
    target's Euler angles about x and y, as a quaternion) and
    adroit_relocate.py:354-369 (the ball's xy, then the target)."""
    task = env.task
    if task == "door":
        return {"door_body_pos": np.array([
            rng.uniform(low=-0.3, high=-0.2), rng.uniform(low=0.25, high=0.35),
            rng.uniform(low=0.252, high=0.35)])}
    if task == "hammer":
        return {"board_z": rng.uniform(low=0.1, high=0.25)}
    if task == "pen":
        desired_orien = np.zeros(3)
        desired_orien[0] = rng.uniform(low=-1, high=1)
        desired_orien[1] = rng.uniform(low=-1, high=1)
        return {"target_quat": _euler2quat(desired_orien)}
    return {"obj_xy": np.array([rng.uniform(low=-0.15, high=0.15),
                                rng.uniform(low=-0.15, high=0.3)]),
            "target_pos": np.array([rng.uniform(low=-0.2, high=0.2),
                                    rng.uniform(low=-0.2, high=0.2),
                                    rng.uniform(low=0.15, high=0.35)])}
