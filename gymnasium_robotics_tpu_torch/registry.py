"""Environment registry (port of gymnasium_robotics_tpu/registry.py ``make``,
``make_gym`` and ``remake``, of envs/__init__.py ``_register_point_maze``,
``_register_ant_maze`` and ``_register_fetch`` :53-109, of
envs/hand/hand.py ``register_hand_envs`` :540-586 for HandReach and
HandManipulateBlock, of envs/adroit/adroit.py ``register_adroit_envs``
:479-496, of envs/kitchen/kitchen.py ``register_kitchen_envs`` and of
envs/__init__.py ``_register_locomotion`` :112-150).

The port registers the PointMaze, AntMaze, Fetch (reach, push, slide,
pick-and-place), HandReach, HandManipulateBlock, Adroit, FrankaKitchen-v1
and locomotion (the 11 v5 and 17 legacy v2/v3) IDs; any other ID raises
``KeyError`` naming the slice of the port that brings its family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from gymnasium_robotics_tpu_torch import device as _device


@dataclasses.dataclass
class EnvSpec:
    id: str
    entry_point: Callable[..., Any]
    kwargs: Dict[str, Any]
    max_episode_steps: Optional[int]


def _maze_sets():
    """{name: (map, PointMaze step limit, AntMaze step limit)}."""
    from gymnasium_robotics_tpu_torch.envs.maze import maps

    return {
        "UMaze": (maps.U_MAZE, 300, 700),
        "Open": (maps.OPEN, 300, 700),
        "Open_Diverse_G": (maps.OPEN_DIVERSE_G, 300, 700),
        "Open_Diverse_GR": (maps.OPEN_DIVERSE_GR, 300, 700),
        "Medium": (maps.MEDIUM_MAZE, 600, 1000),
        "Medium_Diverse_G": (maps.MEDIUM_MAZE_DIVERSE_G, 600, 1000),
        "Medium_Diverse_GR": (maps.MEDIUM_MAZE_DIVERSE_GR, 600, 1000),
        "Large": (maps.LARGE_MAZE, 800, 1000),
        "Large_Diverse_G": (maps.LARGE_MAZE_DIVERSE_G, 800, 1000),
        "Large_Diverse_GR": (maps.LARGE_MAZE_DIVERSE_GR, 800, 1000),
    }


_REWARDS = (("", "sparse"), ("Dense", "dense"))


def _point_maze_specs() -> Dict[str, EnvSpec]:
    from gymnasium_robotics_tpu_torch.envs.maze.point_maze import PointMazeEnv

    out = {}
    for name, (mmap, steps, _) in _maze_sets().items():
        for suffix, reward_type in _REWARDS:
            id_ = f"PointMaze_{name}{suffix}-v3"
            out[id_] = EnvSpec(
                id=id_, entry_point=PointMazeEnv,
                kwargs={"maze_map": mmap, "reward_type": reward_type},
                max_episode_steps=steps,
            )
    return out


def _ant_maze_specs() -> Dict[str, EnvSpec]:
    from gymnasium_robotics_tpu_torch.envs.maze.ant_maze import AntMazeEnv

    out = {}
    for ver in ("v3", "v4", "v5"):
        for name, (mmap, _, steps) in _maze_sets().items():
            for suffix, reward_type in _REWARDS:
                id_ = f"AntMaze_{name}{suffix}-{ver}"
                out[id_] = EnvSpec(
                    id=id_, entry_point=AntMazeEnv,
                    kwargs={"maze_map": mmap, "reward_type": reward_type,
                            "version": ver},
                    max_episode_steps=steps,
                )
    return out


def _fetch_specs() -> Dict[str, EnvSpec]:
    """FetchReach, FetchPush, FetchSlide and FetchPickAndPlace, v1 (the
    reference's mujoco_py twin of v4) and v4, sparse and dense, 50 steps an
    episode."""
    from gymnasium_robotics_tpu_torch.envs.fetch.fetch import (
        FetchPickAndPlaceEnv, FetchPushEnv, FetchReachEnv, FetchSlideEnv)

    out = {}
    for name, cls in (("FetchReach", FetchReachEnv), ("FetchPush", FetchPushEnv),
                      ("FetchSlide", FetchSlideEnv),
                      ("FetchPickAndPlace", FetchPickAndPlaceEnv)):
        for ver in ("v1", "v4"):
            for suffix, reward_type in _REWARDS:
                id_ = f"{name}{suffix}-{ver}"
                out[id_] = EnvSpec(id=id_, entry_point=cls,
                                   kwargs={"reward_type": reward_type},
                                   max_episode_steps=50)
    return out


# the Block's target modes (hand.py:556-568): (target_position,
# target_rotation); Full and "" share theirs, and only the other modes have
# touch-sensor variants
_BLOCK_MODES = {
    "RotateZ": ("ignore", "z"), "RotateParallel": ("ignore", "parallel"),
    "RotateXYZ": ("ignore", "xyz"), "Full": ("random", "xyz"),
    "": ("random", "xyz"),
}
_TOUCH = (("", None), ("_BooleanTouchSensors", "boolean"),
          ("_ContinuousTouchSensors", "sensordata"))


def _hand_specs() -> Dict[str, EnvSpec]:
    """HandReach, sparse and dense x v0 and v3, 50 steps an episode;
    HandManipulateBlock: 4 target modes x 3 touch variants, plus Full,
    x sparse and dense x v0 and v1, 100 steps an episode."""
    from gymnasium_robotics_tpu_torch.envs.hand.hand import (
        HandManipulateBlockEnv, HandReachEnv)

    out = {}
    for ver in ("v0", "v3"):
        for suffix, reward_type in _REWARDS:
            id_ = f"HandReach{suffix}-{ver}"
            out[id_] = EnvSpec(id=id_, entry_point=HandReachEnv,
                               kwargs={"reward_type": reward_type},
                               max_episode_steps=50)
    for mode, (pos, rot) in _BLOCK_MODES.items():
        touch = _TOUCH if mode != "Full" else _TOUCH[:1]
        for tsuffix, touch_obs in touch:
            for ver in ("v0", "v1"):
                for suffix, reward_type in _REWARDS:
                    id_ = f"HandManipulateBlock{mode}{tsuffix}{suffix}-{ver}"
                    out[id_] = EnvSpec(
                        id=id_, entry_point=HandManipulateBlockEnv,
                        kwargs={"reward_type": reward_type,
                                "touch_obs": touch_obs,
                                "target_position": pos,
                                "target_rotation": rot},
                        max_episode_steps=100)
    return out


def _adroit_specs() -> Dict[str, EnvSpec]:
    """AdroitHandDoor, Hammer, Pen and Relocate, dense and sparse, v1 and v2
    (v2 the reference's registered version, v1 its alias), 200 steps an
    episode (adroit.py:479-496)."""
    from gymnasium_robotics_tpu_torch.envs.adroit.adroit import CLASSES

    out = {}
    for name, cls in CLASSES.items():
        for suffix, reward_type in (("", "dense"), ("Sparse", "sparse")):
            for ver in ("v1", "v2"):
                id_ = f"{name}{suffix}-{ver}"
                out[id_] = EnvSpec(id=id_, entry_point=cls,
                                   kwargs={"reward_type": reward_type},
                                   max_episode_steps=200)
    return out


def _kitchen_specs() -> Dict[str, EnvSpec]:
    """FrankaKitchen-v1, every task, 280 steps an episode."""
    from gymnasium_robotics_tpu_torch.envs.kitchen.kitchen import KitchenEnv

    return {"FrankaKitchen-v1": EnvSpec(id="FrankaKitchen-v1",
                                        entry_point=KitchenEnv, kwargs={},
                                        max_episode_steps=280)}


def _locomotion_specs() -> Dict[str, EnvSpec]:
    """The 11 locomotion IDs of v5 semantics and the 17 legacy v2/v3 IDs,
    with their step limits (JAX envs/__init__.py:127-150)."""
    from gymnasium_robotics_tpu_torch.envs.locomotion import classic as C
    from gymnasium_robotics_tpu_torch.envs.locomotion import legacy as LG
    from gymnasium_robotics_tpu_torch.envs.locomotion import locomotion as L

    makers = {
        "Ant": (L.make_ant, 1000),
        "HalfCheetah": (L.make_half_cheetah, 1000),
        "Hopper": (L.make_hopper, 1000),
        "Walker2d": (L.make_walker2d, 1000),
        "Swimmer": (L.make_swimmer, 1000),
        "Humanoid": (C.make_humanoid, 1000),
        "HumanoidStandup": (C.make_humanoid_standup, 1000),
        "InvertedPendulum": (C.make_inverted_pendulum, 1000),
        "InvertedDoublePendulum": (C.make_inverted_double_pendulum, 1000),
        "Reacher": (C.make_reacher, 50),
        "Pusher": (C.make_pusher, 100),
    }
    out = {f"{name}-v5": EnvSpec(id=f"{name}-v5", entry_point=maker,
                                 kwargs={}, max_episode_steps=steps)
           for name, (maker, steps) in makers.items()}
    for name, (maker, versions, steps) in LG.LEGACY_REGISTRY.items():
        for ver in versions:
            id_ = f"{name}-{ver}"
            out[id_] = EnvSpec(id=id_, entry_point=maker,
                               kwargs={"version": ver}, max_episode_steps=steps)
    return out


def _specs() -> Dict[str, EnvSpec]:
    return {**_point_maze_specs(), **_ant_maze_specs(), **_fetch_specs(),
            **_hand_specs(), **_adroit_specs(), **_kitchen_specs(),
            **_locomotion_specs()}


_SLICES = (
    ("HandManipulateEgg", "the HandManipulateEgg slice (ellipsoid pairs)"),
    ("HandManipulatePen", "the HandManipulatePen slice (capsule-hull "
                          "pairs on the unpruned table)"),
)


def spec(id: str) -> EnvSpec:
    specs = _specs()
    if id not in specs:
        brings = next(
            (s for prefix, s in _SLICES if id.startswith(prefix)),
            "a later slice (ROADMAP queue A)",
        )
        raise KeyError(
            f"{id!r} is not in the port: it registers only the PointMaze, "
            f"AntMaze, Fetch, HandReach, HandManipulateBlock, Adroit, "
            f"FrankaKitchen-v1 and locomotion IDs so far; this family comes "
            f"with {brings}"
        )
    return specs[id]


def ids():
    return sorted(_specs())


def make(id: str, num_envs: Optional[int] = None, device=None, **kwargs):
    """Create an env on ``device`` (the CUDA card unless named; raises when
    there is none). With ``num_envs``: a ``BatchedEnv`` stepping that many
    instances in lockstep. Without: the env itself, whose methods act on a
    batch given to them."""
    s = spec(id)
    dev = _device.resolve(device)
    env = s.entry_point(**{**s.kwargs, **kwargs}, device=dev)
    if s.max_episode_steps is not None and env.max_episode_steps is None:
        env.max_episode_steps = s.max_episode_steps
    if num_envs is None:
        return env
    from gymnasium_robotics_tpu_torch.envs.batched import BatchedEnv

    return BatchedEnv(env, num_envs)


def make_gym(id: str, parity: bool = False, render_mode=None, device=None,
             **kwargs):
    """A Gymnasium-API env (numpy in and out, one instance, stateful) on
    ``device`` (the CUDA card unless named): envs/adapters.GymAdapter.
    ``parity=True`` draws the reset randomness on the host in the
    reference's NumPy order (utils/parity.py), so a seeded reset gives the
    reference's state."""
    from gymnasium_robotics_tpu_torch.envs.adapters import GymAdapter

    env = GymAdapter(make(id, device=device, **kwargs), render_mode=render_mode,
                     parity=parity)
    env._make_spec = (id, dict(kwargs), parity, render_mode,
                      None if device is None else str(device))
    return env


def remake(spec):
    """The env a ``make_gym`` spec (id, kwargs, parity, render_mode, device)
    describes: the pickle path, where such envs pickle as their arguments
    and are rebuilt on load."""
    id, kwargs, parity, render_mode, device = spec
    return make_gym(id, parity=parity, render_mode=render_mode, device=device,
                    **kwargs)
