"""Public MaMuJoCo entry point (port of gymnasium_robotics_tpu/mamujoco_v1.py)."""
from gymnasium_robotics_tpu_torch.envs.mamujoco.mujoco_multi import (  # noqa: F401
    MultiAgentMujocoEnv, env, parallel_env, raw_parallel_env,
)
