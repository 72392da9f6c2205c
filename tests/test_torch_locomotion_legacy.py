"""The 17 legacy v2/v3 locomotion IDs against the JAX package (their
frozen observation, reward and info conventions on the v5 models; the
legacy Walker2d on walker2d.xml), through the registry's BatchedEnv on
the CPU.

The JAX side runs its batch-last path in float64: the 17 IDs' resets and
env steps compiled as one function (tests/_loco_cases.py). For each ID one env
step from its moving state (after three steps of random actions) is held
at 1e-9 with the port in float64 and at 2e-4 with the port in float32
against the same float64 reference, and the reset's refresh from injected
qpos and qvel at 1e-9; the registry's legacy IDs, kwargs and step limits
and the v3 option kwargs against the JAX package's.

Pusher-v2's JAX BatchedEnv cannot step: its reset builds the v5 Pusher's
info (with reward_near) while its step reports the v2 keys, and
core.auto_reset's pick refuses the two trees. So its JAX step is the
env's own, without the auto-reset; the port's reset reports the step's
keys, and no env resets on the compared step."""

import pytest
import torch

import _port_cpu  # noqa: F401

import _loco_cases as L
from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu_torch import registry

IDS = ["Reacher-v2", "Pusher-v2", "InvertedPendulum-v2",
       "InvertedDoublePendulum-v2", "HalfCheetah-v2", "HalfCheetah-v3",
       "Hopper-v2", "Hopper-v3", "Swimmer-v2", "Swimmer-v3", "Walker2d-v2",
       "Walker2d-v3", "Ant-v2", "Ant-v3", "Humanoid-v2", "Humanoid-v3",
       "HumanoidStandup-v2"]


@pytest.fixture(scope="module")
def jax_runs():
    return L.jax_runs(IDS, env_step_only=("Pusher-v2",))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("id_", IDS)
def test_env_step_matches_jax(jax_runs, id_, dtype):
    done = L.check_step(id_, jax_runs[0][(id_, "moving")], dtype)
    assert not done.any()


@pytest.mark.parametrize("id_", IDS)
def test_reset_with_values_matches_jax(jax_runs, id_):
    L.check_reset(id_, jax_runs[1][id_])


def test_registry_matches_jax():
    """The 17 legacy IDs with the JAX registry's kwargs and step limits,
    197 IDs in all; the v3 option kwargs land where the JAX package puts
    them."""
    import gymnasium_robotics_tpu.envs  # noqa: F401  (registers the IDs)

    families = {i.split("-")[0] for i in IDS}
    legacy = sorted(i for i in registry.ids() if i.split("-")[0] in families
                    and not i.endswith("-v5"))
    assert legacy == sorted(IDS) and len(registry.ids()) == 197
    for id_ in IDS:
        s, js = registry.spec(id_), jreg.spec(id_)
        assert s.kwargs == js.kwargs == {"version": id_[-2:]}
        assert s.max_episode_steps == js.max_episode_steps
    over = dict(forward_reward_weight=2.0, ctrl_cost_weight=0.3,
                healthy_z_range=(0.5, 3.0), reset_noise_scale=0.02,
                exclude_current_positions_from_observation=False)
    for id_ in ("Hopper-v3", "Ant-v3", "Humanoid-v3"):
        env = registry.make(id_, device="cpu", **over)
        jenv = jreg.make(id_, **over)
        jcfg = L.dataclasses.asdict(jenv.cfg)
        assert jcfg.pop("xml").endswith(f"/{env.cfg.xml}.xml")
        assert L.dataclasses.asdict(env.cfg) == {**jcfg, "xml": env.cfg.xml}, id_
        assert env.obs_dim == jenv.observation_space.shape[0], id_
        b = registry.make(id_, num_envs=2, device="cpu", **over)
        obs, _ = b.reset(seed=0)
        assert obs.shape == (2, env.obs_dim)
        assert torch.isfinite(b.step(torch.zeros(2, env.action_dim))[0]).all()
