"""Every PointMaze ID of the port's registry (the 20 of the JAX
registry) resets and steps 3 envs on the CPU: observations finite, the
episode limit of its maze, rewards non-negative (the JAX comparison of
the PointMaze env is in tests/test_torch_pointmaze.py)."""

import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch import registry


@pytest.mark.parametrize(
    "env_id", [i for i in registry.ids() if i.startswith("PointMaze")])
def test_every_point_maze_id_steps(env_id):
    env = registry.make(env_id, num_envs=3, device="cpu")
    env.reset(seed=0)
    obs, reward, _, truncated, _ = env.step(torch.ones(3, 2))
    assert obs["observation"].shape == (3, 4)
    assert torch.isfinite(obs["observation"]).all()
    assert env.env.max_episode_steps in (300, 600, 800)
    assert (reward >= 0).all() and not truncated.any()
