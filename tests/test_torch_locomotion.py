"""The locomotion models of v5 semantics but the humanoids against the JAX
package: Ant, HalfCheetah, Hopper, Walker2d, Swimmer, InvertedPendulum,
InvertedDoublePendulum, Reacher and Pusher (-v5), through the registry's
BatchedEnv on the CPU.

The JAX side runs its batch-last path (soa="force") in float64: its resets
and env steps of all nine models compiled as one function
(tests/_loco_cases.py). One env step from each model's "moving" state
(and from Hopper's "falling" one, where env 1 terminates and
auto-resets) is held at 1e-9 with the port in float64 and at 2e-4 with the
port in float32 against the same float64 reference; the reset's refresh
from injected qpos and qvel at 1e-9; the fixed-K goal and object draws of
Reacher and Pusher within their ranges; the inertia-box fluid forces
(Swimmer) against the JAX function, float64 1e-12; and the registry,
spaces and metadata against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _loco_cases as L
from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu_torch import registry
from gymnasium_robotics_tpu_torch.physics import pipeline, smooth

IDS = ["Ant-v5", "HalfCheetah-v5", "Hopper-v5", "Walker2d-v5", "Swimmer-v5",
       "InvertedPendulum-v5", "InvertedDoublePendulum-v5", "Reacher-v5",
       "Pusher-v5"]


@pytest.fixture(scope="module")
def jax_runs():
    return L.jax_runs(IDS, falling=("Hopper-v5",))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("id_", IDS)
def test_env_step_matches_jax(jax_runs, id_, dtype):
    done = L.check_step(id_, jax_runs[0][(id_, "moving")], dtype)
    assert not done.any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hopper_falls_and_resets(jax_runs, dtype):
    """Env 1 tilted past 0.2 rad terminates on both sides; the port's
    auto-reset starts it afresh while env 0 steps on."""
    done = L.check_step("Hopper-v5", jax_runs[0][("Hopper-v5", "falling")], dtype)
    assert done.tolist() == [False, True]


@pytest.mark.parametrize("id_", IDS)
def test_reset_with_values_matches_jax(jax_runs, id_):
    L.check_reset(id_, jax_runs[1][id_])


def test_reacher_and_pusher_draws():
    """The masked fixed-K draws (reacher_v5, pusher_v5): Reacher's goal
    inside the disk of radius 0.2 (or a failed draw's candidate halved),
    the arm within 0.1 of qpos0, qvel within 0.005 and the goal's 0;
    Pusher's object x in [-0.3, 0], y in [-0.2, 0.2] and at least 0.17
    from the goal but where all 8 candidates failed (probability 0.378^8,
    4e-4; the JAX package keeps candidate 0 there too), the goal's joints
    and the object's and goal's velocities 0."""
    n = 4000
    gen = torch.Generator().manual_seed(0)
    env = registry.make("Reacher-v5", device="cpu", dtype=torch.float64)
    qpos, qvel = env._draw(n, gen)
    goal = qpos[:, -2:]
    assert float(torch.linalg.vector_norm(goal, dim=-1).max()) < 0.2
    assert float(goal.abs().max()) > 0.15
    q0 = env.model.qpos0[:, 0]
    assert float((qpos[:, :-2] - q0[:-2]).abs().max()) <= 0.1
    assert float(qvel[:, :-2].abs().max()) <= 0.005
    assert float(qvel[:, -2:].abs().max()) == 0.0
    s = env.initial(n, gen)
    np.testing.assert_allclose(s.obs[:, 8:10].numpy(),
                               (s.data.xpos[env._fingertip] -
                                s.data.xpos[env._target])[:2].T.numpy())

    env = registry.make("Pusher-v5", device="cpu", dtype=torch.float64)
    qpos, qvel = env._draw(n, gen)
    obj = qpos[:, -4:-2]
    assert float(obj[:, 0].min()) >= -0.3 and float(obj[:, 0].max()) <= 0.0
    assert float(obj[:, 1].abs().max()) <= 0.2
    far = torch.linalg.vector_norm(obj, dim=-1) > 0.17
    assert int((~far).sum()) <= 8, int((~far).sum())
    assert float(qpos[:, -2:].abs().max()) == 0.0
    np.testing.assert_array_equal(qpos[:, :-4].numpy(),
                                  env.model.qpos0[:-4, 0].expand(n, -1).numpy())
    assert float(qvel[:, -4:].abs().max()) == 0.0
    assert float(qvel.abs().max()) <= 0.005


def test_fluid_matches_jax(jax_runs):
    """The inertia-box fluid forces of Swimmer (density 4000, viscosity
    0.1) on its moving state against soa._inertia_box_fluid, float64."""
    import _jax_ref as R
    from gymnasium_robotics_tpu.physics import soa
    from gymnasium_robotics_tpu.physics import types as jT

    from gymnasium_robotics_tpu_torch import convert

    s0 = jax_runs[0][("Swimmer-v5", "moving")][0]
    jenv = jax_runs[1]["Swimmer-v5"].env
    m = registry.make("Swimmer-v5", device="cpu", dtype=torch.float64).model
    assert (m.opt.density, m.opt.viscosity) == (4000.0, 0.1)
    d = convert.data_from_numpy(s0["data"], "cpu")
    d = pipeline.forward(m, d)
    got = smooth._inertia_box_fluid(m, d, m.plan("passive", smooth._PassivePlan))
    ref = np.asarray(soa._inertia_box_fluid(soa._model_to_soa(jenv.model, None),
                                            R.data_from_port(d, jT)))
    assert np.abs(ref).max() > 1e-3
    assert L.rel_err(got.numpy(), ref) <= 1e-12
    # and the passive force the step uses carries it
    no_fluid = dataclasses.replace(m, meta=dataclasses.replace(
        m.meta, opt=dataclasses.replace(m.meta.opt, density=0.0, viscosity=0.0)))
    diff = smooth.fwd_passive(m, d).qfrc_passive - smooth.fwd_passive(
        no_fluid, d).qfrc_passive
    assert L.rel_err(diff.numpy(), ref) <= 1e-12


def test_registry_spaces_and_metadata_match_jax():
    """The 11 v5 IDs (the humanoids too) with the JAX registry's kwargs and
    step limits; each env's observation width, action bounds (the model's
    ctrlrange) and frame rate as the JAX env's; make_gym's spaces."""
    import gymnasium_robotics_tpu.envs  # noqa: F401  (registers the IDs)

    v5 = sorted(i for i in registry.ids() if i.endswith("-v5") and
                not i.startswith(("AntMaze", "PointMaze")))
    jv5 = sorted(i for i in jreg.ids() if i.endswith("-v5") and
                 not i.startswith(("AntMaze", "PointMaze")))
    assert v5 == jv5 and len(v5) == 11
    for id_ in v5:
        s, js = registry.spec(id_), jreg.spec(id_)
        assert s.kwargs == js.kwargs and s.max_episode_steps == js.max_episode_steps
        env = registry.make(id_, device="cpu")
        jenv = jreg.make(id_)
        assert env.obs_dim == jenv.observation_space.shape[0], id_
        np.testing.assert_array_equal(env.action_low, jenv.action_space.low)
        np.testing.assert_array_equal(env.action_high, jenv.action_space.high)
        assert env.metadata["render_fps"] == jenv.metadata["render_fps"], id_
        genv = registry.make_gym(id_, device="cpu")
        assert genv.observation_space == jenv.observation_space
        assert genv.action_space == jenv.action_space
        assert genv.metadata["render_fps"] == jenv.metadata["render_fps"]
        assert env.max_episode_steps == js.max_episode_steps


def test_make_gym_steps():
    """make_gym on Hopper-v5 (the per-env path) and InvertedPendulum-v5
    (nv = 2: the closed-form Newton of the per-env path): a seeded reset
    and three steps, observations in the space's dtype, parity=True
    drawing as without it (no host sampler for locomotion, as in the JAX
    package)."""
    for id_ in ("Hopper-v5", "InvertedPendulum-v5"):
        env = registry.make_gym(id_, device="cpu")
        penv = registry.make_gym(id_, parity=True, device="cpu")
        o, _ = env.reset(seed=4)
        po, _ = penv.reset(seed=4)
        np.testing.assert_array_equal(o, po)
        assert o.dtype == np.float64 and env.observation_space.contains(o)
        for _ in range(3):
            a = env.action_space.sample()
            o, r, term, trunc, info = env.step(a)
            assert np.isfinite(o).all() and isinstance(r, float)
            assert o.shape == env.observation_space.shape
