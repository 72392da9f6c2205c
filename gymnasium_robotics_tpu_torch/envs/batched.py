"""BatchedEnv: N env instances stepping in lockstep with masked auto-reset
(port of gymnasium_robotics_tpu/envs/batched.py)."""

from __future__ import annotations

from typing import Optional

import torch

from gymnasium_robotics_tpu_torch import core


class BatchedEnv:
    """step(actions (N, act_dim)) -> (obs, reward, terminated, truncated,
    info), all B-leading tensors on the env's device; the state stays on
    the device between calls."""

    def __init__(self, env, num_envs: int, device=None):
        if device is not None and torch.device(device) != env.device:
            raise ValueError(f"env lives on {env.device}, not {device}")
        self.env = env
        self.num_envs = num_envs
        self.device = env.device
        self.state: Optional[core.EnvState] = None
        self.generator: Optional[torch.Generator] = None

    def reset(self, seed: int = 0):
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = core.with_diverged(
            self.env.initial(self.num_envs, self.generator)
        )
        return self.state.obs, self.state.info

    def step(self, actions):
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        self.state = core.auto_reset(self.env, self.state, actions, self.generator)
        s = self.state
        return s.obs, s.reward, s.terminated, s.truncated, s.info
