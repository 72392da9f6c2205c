"""Gymnasium-API adapter (port of gymnasium_robotics_tpu/envs/adapters.py):
one env instance, stateful, with numpy in and out, so code written against
the reference (``gym.make`` -> ``reset``/``step``, the GoalEnv dict
observations, seeding through ``np_random``) runs unchanged on the port.
``metadata`` is the env's (its frame rate; no render mode yet).

The instance is a batch of one of the port's env, on the env's device.
Its model runs the per-env path (``Option.soa=False``), as the JAX
package's single env does; there the nv = 2 constraint solve is the closed
form (solver.solve_newton_nv2). Observations are the GoalEnv dict (for
the kitchen with goals that are dicts by task) or, for Adroit, one flat
vector. With ``parity`` the reset randomness, and the kitchen's
observation noise at every step, are drawn on the host in the
reference's order (utils/parity.py). A step does not auto-reset: it reports
``truncated`` once ``max_episode_steps`` steps have passed, as gymnasium's
TimeLimit does. Rendering is not ported yet (ROADMAP A.12), so a
``render_mode`` other than None raises.

gymnasium is optional: with it installed the adapter is a ``gymnasium.Env``
with Box spaces; without it the spaces are None and observations are cast
to the dtype those spaces declare.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.utils import parity as P

try:
    import gymnasium as gym
except ImportError:  # an optional dependency of the adapter only
    gym = None

# the dtypes every ported family's spaces declare (the reference's)
OBS_DTYPE, ACTION_DTYPE = np.float64, np.float32


def _spaces(env):
    """(observation_space, action_space) of ``env``: for a goal env (one
    with ``goal_dim``) a Dict of observation / achieved_goal /
    desired_goal Boxes, for the kitchen (``goal_shapes``) goals that are
    Dicts of a Box by task, else one flat Box (Adroit, locomotion); the
    action Box of the env's ``action_low``/``action_high`` where it has
    them (locomotion: the model's ctrlrange), else [-1, 1]; (None, None)
    without gymnasium."""
    if gym is None:
        return None, None
    from gymnasium import spaces

    def box(n):
        return spaces.Box(-np.inf, np.inf, (n,), OBS_DTYPE)

    def goal():
        if hasattr(env, "goal_shapes"):
            return spaces.Dict({t: box(n) for t, n in env.goal_shapes.items()})
        return box(env.goal_dim)

    obs = box(env.obs_dim)
    if hasattr(env, "goal_dim") or hasattr(env, "goal_shapes"):
        obs = spaces.Dict(dict(observation=obs, achieved_goal=goal(),
                               desired_goal=goal()))
    if hasattr(env, "action_low"):
        return obs, spaces.Box(env.action_low, env.action_high,
                               dtype=ACTION_DTYPE)
    return obs, spaces.Box(-1.0, 1.0, (env.action_dim,), ACTION_DTYPE)


def _np_leaves(x, fn):
    """fn on every leaf of a tensor or a dict of them, nested at any
    depth."""
    if isinstance(x, dict):
        return {k: _np_leaves(v, fn) for k, v in x.items()}
    return fn(x)


class GymAdapter(gym.Env if gym else object):
    def __init__(self, env, render_mode: Optional[str] = None,
                 parity: bool = False):
        if render_mode is not None:
            raise NotImplementedError(
                f"render_mode={render_mode!r}: rendering (render/) is not "
                "ported yet (ROADMAP A.12)")
        env.model = env.model.with_options(soa=False)
        self.env = env
        # the env's own frame rate, as the reference adapter copies it
        self.metadata = dict(env.metadata)
        self.parity = parity
        self.render_mode = None
        self.device = env.device
        self.observation_space, self.action_space = _spaces(env)
        self._state = None
        self._np_random = None
        self._gen = torch.Generator(device=env.device)

    @property
    def np_random(self) -> np.random.Generator:
        """The instance's NumPy generator (gymnasium's: PCG64 from the reset
        seed's SeedSequence); an unseeded one until reset(seed=...)."""
        if self._np_random is None:
            self._np_random = np.random.default_rng()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator):
        self._np_random = value

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        """A fresh episode: with ``parity`` the reset values are drawn from
        ``np_random`` in the reference's order (utils/parity.py) where the
        family has a sampler (an env whose ``host_reset_values`` is False,
        locomotion's, has none, as in the JAX package), else from a torch
        Generator seeded from it; ``options`` may name a maze
        ``goal_cell`` / ``reset_cell`` and an ``initial_state_dict`` (a
        ``get_env_state`` result) to start from."""
        if seed is not None:
            self._np_random = np.random.default_rng(seed)
        else:
            seed = int(self.np_random.integers(2 ** 31))
        self._gen.manual_seed(seed)
        options = dict(options or {})
        init_state = options.pop("initial_state_dict", None)
        if self.parity and getattr(self.env, "host_reset_values", True):
            values = P.sample_reset_values(self.env, self.np_random, options)
            self._state = self.env.reset_with_values(
                self.env.initial(1, self._gen),
                {k: np.asarray(v)[None] for k, v in values.items()})
        elif options and hasattr(self.env, "initial_with_options"):
            self._state = self.env.initial_with_options(1, self._gen, options)
        else:
            self._state = self.env.initial(1, self._gen)
        if init_state is not None:
            self.set_env_state(init_state)
        return self._obs(), self._info()

    def step(self, action):
        """One step; with ``parity``, a family that draws during a step
        (the kitchen's observation noise) takes the draws from
        ``np_random`` in the reference's order."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        a = torch.as_tensor(np.asarray(action, np.float64), dtype=self.env.dtype,
                            device=self.device).reshape(1, -1)
        values = (P.sample_step_values(self.env, self.np_random)
                  if self.parity else None)
        if values is not None:
            self._state = s = self.env.step_with_values(
                self._state, a, {k: np.asarray(v)[None] for k, v in values.items()})
        else:
            self._state = s = self.env.step(self._state, a, self._gen)
        limit = self.env.max_episode_steps
        truncated = bool(s.truncated[0]) or (
            limit is not None and int(s.steps[0]) >= limit)
        return (self._obs(), float(s.reward[0]), bool(s.terminated[0]),
                truncated, self._info())

    def _obs(self):
        """The instance's observation as numpy in its space's dtypes (every
        ported family's spaces are float64)."""
        return _np_leaves(self._state.obs, lambda v: np.asarray(
            v[0].detach().cpu().numpy(), OBS_DTYPE))

    def _info(self):
        return {k: v[0].detach().cpu().numpy()
                for k, v in self._state.info.items()}

    # GoalEnv contract, numpy in and out
    def _goal_fn(self, fn, achieved_goal, desired_goal, info):
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=self.env.dtype, device=self.device)

        return fn(_np_leaves(achieved_goal, t), _np_leaves(desired_goal, t),
                  info).cpu().numpy()

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        return self._goal_fn(self.env.compute_reward, achieved_goal,
                             desired_goal, info)

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        return self._goal_fn(self.env.compute_terminated, achieved_goal,
                             desired_goal, info)

    def compute_truncated(self, achieved_goal, desired_goal, info=None):
        """No ported family truncates on its goal (GoalEnv's default)."""
        return np.zeros(np.shape(achieved_goal)[:-1], bool)

    def render(self):
        return None  # render_mode is None

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self

    def __reduce__(self):
        # envs made by registry.make_gym pickle as their make_gym arguments
        # and are rebuilt on load; the live episode is not carried
        spec = getattr(self, "_make_spec", None)
        if spec is None:
            raise TypeError("only envs made by registry.make_gym pickle")
        from gymnasium_robotics_tpu_torch import registry

        return (registry.remake, (spec,))

    # env-state checkpointing: a family with the reference's state dicts
    # (Adroit: qpos, qvel and the scene) speaks them, one env's numpy
    # arrays; for the others the whole EnvState round-trips
    def get_env_state(self) -> dict:
        """The reference's state dict where the env has one, else the
        instance's EnvState as B-leading numpy leaves (B = 1)."""
        if hasattr(self.env, "get_env_state"):
            return {k: v[0].detach().cpu().numpy()
                    for k, v in self.env.get_env_state(self._state).items()}
        return convert.env_state_to_numpy(self._state)

    def set_env_state(self, state: dict):
        if hasattr(self.env, "set_env_state"):
            self._state = self.env.set_env_state(
                self._state, {k: np.asarray(v)[None] for k, v in state.items()})
        else:
            self._state = convert.env_state_from_numpy(state, self.device)
