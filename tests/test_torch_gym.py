"""The port's Gymnasium-API single env (registry.make_gym,
envs/adapters.GymAdapter) and its parity reset values (utils/parity.py)
against the JAX package's.

- make_gym("PointMaze_UMaze-v3") against the JAX make_gym over 30 steps
  from one parity reset (both draw their reset values from the same NumPy
  seed), in float64: relative error scaled by max(1, |ref|) <= 1e-9. The
  JAX single env runs the per-env path (the generic Newton solve on the
  CPU); the port's runs the closed-form nv = 2 solve (solve_newton_nv2).
- sample_reset_values equal to the JAX package's for the maze and fetch
  families from the same np.random.Generator.
- options resets, truncation at max_episode_steps, the env-state round
  trip, pickling, and the route of the per-env solve.
- AntMaze and FetchPush through the adapter equal the port's BatchedEnv at
  B = 1 from the same state (no JAX FetchPush single env is compiled).
- metadata: the frame rate of every ported family equal to the JAX
  make_gym's (the env's own, which both adapters copy), no render mode.

The test marked ``cuda`` steps make_gym on the card past its time limit,
one newton_nv2 launch a step and no newton launch; it skips where no card
is present. JAX is imported inside the tests."""

import pickle

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.physics import solver
from gymnasium_robotics_tpu_torch.utils import parity

TOL64 = 1e-9


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def test_pointmaze_matches_jax_make_gym():
    import jax.numpy as jnp

    from gymnasium_robotics_tpu import registry as jreg

    je = jreg.make_gym("PointMaze_UMaze-v3", parity=True, dtype=jnp.float64)
    te = registry.make_gym("PointMaze_UMaze-v3", parity=True,
                           dtype=torch.float64, device="cpu")
    jo, _ = je.reset(seed=5)
    to, _ = te.reset(seed=5)
    assert all(np.array_equal(jo[k], to[k]) for k in jo)
    rs = np.random.RandomState(0)
    push = np.array([0.3, -1.0])  # into the U's bottom wall
    touched = 0
    for _ in range(30):
        a = np.clip(push + rs.uniform(-0.3, 0.3, 2), -1, 1)
        jo, jr, jterm, jtrunc, _ = je.step(a)
        to, tr, tterm, ttrunc, _ = te.step(a)
        for k in jo:
            assert to[k].dtype == np.float64
            assert rel_err(to[k], jo[k]) <= TOL64, k
        assert (tr, tterm, ttrunc) == (jr, jterm, jtrunc)
        touched += bool(te._state.data.qfrc_constraint.abs().max() > 0)
    assert touched > 0  # the constraint solve did work


@pytest.mark.parametrize("id_", ["PointMaze_UMaze-v3", "AntMaze_Medium-v4",
                                 "FetchPush-v4", "FetchPickAndPlace-v4"])
def test_reset_values_match_jax(id_):
    from gymnasium_robotics_tpu import registry as jreg
    from gymnasium_robotics_tpu.utils import parity as jparity

    jenv = jreg.make(id_)
    tenv = registry.make(id_, device="cpu")
    for seed in range(20):
        opts = {"goal_cell": (1, 2)} if "Maze" in id_ and seed % 3 == 0 else None
        ref = jparity.sample_reset_values(jenv, np.random.default_rng(seed), opts)
        got = parity.sample_reset_values(tenv, np.random.default_rng(seed), opts)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="no parity sampler"):
        parity.sample_reset_values(object(), np.random.default_rng(0))


@pytest.mark.parametrize("id_", ["PointMaze_UMaze-v3", "AntMaze_UMaze-v5",
                                 "FetchPush-v4", "HandReach-v3",
                                 "HandManipulateBlockRotateXYZ-v1",
                                 "AdroitHandDoor-v1", "FrankaKitchen-v1"])
def test_metadata_matches_jax(id_):
    from gymnasium_robotics_tpu import registry as jreg

    je = jreg.make_gym(id_)
    te = registry.make_gym(id_, device="cpu")
    assert te.metadata["render_fps"] == je.metadata["render_fps"]
    assert te.metadata["render_modes"] == []


def test_options_truncation_state_and_pickle():
    env = registry.make_gym("PointMaze_UMaze-v3", device="cpu")
    assert env.env.max_episode_steps == 300
    assert env.env.model.opt.soa is False
    maze = env.env.maze
    obs, info = env.reset(seed=1, options={"goal_cell": (1, 1),
                                           "reset_cell": (3, 1)})
    for key, cell in (("desired_goal", (1, 1)), ("achieved_goal", (3, 1))):
        off = obs[key] - maze.cell_rowcol_to_xy(cell)
        assert np.all(np.abs(off) <= 0.25 * maze.size_scaling), key
    assert set(obs) == {"observation", "achieved_goal", "desired_goal"}
    assert env.observation_space.contains(obs)

    saved = env.get_env_state()
    first = env.step(np.array([0.5, 0.5]))[0]
    env.step(np.array([-1.0, 0.2]))
    env.set_env_state(saved)
    again = env.step(np.array([0.5, 0.5]))[0]
    assert all(np.array_equal(first[k], again[k]) for k in first)
    obs, _ = env.reset(seed=2, options={"initial_state_dict": saved})
    assert np.array_equal(obs["observation"], saved["obs"]["observation"][0])

    r = env.compute_reward(obs["achieved_goal"], obs["desired_goal"])
    assert r.shape == () and r.dtype == np.float32
    assert env.compute_truncated(np.zeros((5, 2)), np.zeros((5, 2))).shape == (5,)

    short = registry.make_gym("PointMaze_UMaze-v3", device="cpu",
                              max_episode_steps=4)
    short.reset(seed=0)
    truncs = [short.step(np.zeros(2))[3] for _ in range(5)]
    assert truncs == [False, False, False, True, True]  # no auto-reset

    clone = pickle.loads(pickle.dumps(short))
    assert isinstance(clone, type(short)) and clone.env.max_episode_steps == 4
    with pytest.raises(NotImplementedError, match="render"):
        registry.make_gym("PointMaze_UMaze-v3", device="cpu",
                          render_mode="rgb_array")


def test_per_env_path_takes_the_closed_form(monkeypatch):
    """make_gym's per-env model (soa=False) solves nv = 2 in closed form;
    the batched env keeps solve_newton."""
    calls = []
    for name in ("solve_newton", "solve_newton_nv2"):
        fn = getattr(solver, name)
        monkeypatch.setattr(solver, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    env = registry.make_gym("PointMaze_UMaze-v3", device="cpu")
    env.reset(seed=0)
    env.step(np.zeros(2))
    assert calls == ["solve_newton_nv2"]
    calls.clear()
    benv = registry.make("PointMaze_UMaze-v3", num_envs=2, device="cpu")
    benv.reset(seed=0)
    benv.step(torch.zeros(2, 2))
    assert calls == ["solve_newton"]


@pytest.mark.parametrize("id_, nu", [("AntMaze_UMaze-v5", 8),
                                     ("FetchPush-v4", 4)])
def test_adapter_matches_batched_env(id_, nu):
    genv = registry.make_gym(id_, device="cpu", parity=True)
    genv.reset(seed=4)
    benv = registry.make(id_, num_envs=1, device="cpu")
    benv.state = core.with_diverged(
        convert.env_state_from_numpy(genv.get_env_state(), "cpu"))
    a = np.random.RandomState(1).uniform(-1, 1, nu)
    go, gr, *_ = genv.step(a)
    bo, br, *_ = benv.step(torch.tensor(a, dtype=torch.float32)[None])
    for k in go:
        np.testing.assert_array_equal(go[k], bo[k][0].numpy().astype(np.float64))
    assert gr == float(br[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_make_gym_on_card(cuda_device):
    env = registry.make_gym("PointMaze_UMaze-v3")
    assert env.device.type == "cuda"
    env.reset(seed=0)
    n0 = dict(solver.LAUNCHES)
    truncated = [env.step(np.array([1.0, 0.2]))[3] for _ in range(301)]
    torch.cuda.synchronize()
    assert solver.LAUNCHES["newton_nv2"] == n0["newton_nv2"] + 301
    assert solver.LAUNCHES["newton"] == n0["newton"]
    assert truncated.index(True) == 299
