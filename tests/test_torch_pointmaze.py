"""The PointMaze_UMaze-v3 slice as a whole: the port's BatchedEnv against the
JAX BatchedEnv from the very same state (carried across with convert.py),
stepped with the same numpy actions.

The JAX env runs its SoA path with the fused Pallas kernels in interpret
mode (soa="force", fused_solver="force"). Tolerance: relative error scaled
by max(1, |ref|) <= 2e-4 in float32, <= 1e-9 in float64. RNG streams differ
between jax.random and torch, so auto-resets are held by the properties of
the reset distribution, and host-drawn resets through reset_with_values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.maze.point_maze import PointMazeEnv as JPointMaze
from gymnasium_robotics_tpu_torch import convert, registry

B = 8
TOLS = {"float32": 2e-4, "float64": 1e-9}


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def jax_state_to_numpy(s):
    d = s.data
    data = {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d) if f.name != "contact"}
    c = d.contact
    data["contact"] = {n: None if getattr(c, n) is None else np.asarray(getattr(c, n))
                       for n in ("dist", "pos", "frame", "geom1", "geom2", "src")}
    return dict(
        data=data, obs={k: np.asarray(v) for k, v in s.obs.items()},
        reward=np.asarray(s.reward), terminated=np.asarray(s.terminated),
        truncated=np.asarray(s.truncated),
        info={k: np.asarray(v) for k, v in s.info.items()},
        goal=np.asarray(s.goal), steps=np.asarray(s.steps),
    )


def make_pair(dtype, seed=0):
    """(JAX BatchedEnv, port BatchedEnv) holding the same state."""
    jenv = JPointMaze(dtype=getattr(jnp, dtype))
    jenv.model = jenv.model.with_options(soa="force", fused_solver="force")
    jenv.max_episode_steps = 300
    jb = JBatched(jenv, B)
    jb.reset(seed=seed)
    tb = registry.make("PointMaze_UMaze-v3", num_envs=B, device="cpu",
                       dtype=getattr(torch, dtype))
    tb.reset(seed=seed)
    tb.state = convert.env_state_from_numpy(jax_state_to_numpy(jb.state), "cpu")
    return jb, tb


def step_both(jb, tb, a):
    jo, jr, jte, jtr, ji = jb.step(a)
    to, tr, tte, ttr, ti = tb.step(torch.as_tensor(a))
    return (jo, jr, jte, jtr, ji), (to, tr, tte, ttr, ti)


def assert_transition_close(jout, tout, tol, envs=slice(None)):
    (jo, jr, jte, jtr, ji), (to, tr, tte, ttr, ti) = jout, tout
    for k in jo:
        assert rel_err(to[k].numpy()[envs], np.asarray(jo[k])[envs]) <= tol, k
    np.testing.assert_allclose(tr.numpy()[envs], np.asarray(jr)[envs],
                               rtol=0, atol=tol)
    for name, a, b in (("terminated", jte, tte), ("truncated", jtr, ttr),
                       ("success", ji["success"], ti["success"]),
                       ("diverged", ji["diverged"], ti["diverged"])):
        np.testing.assert_array_equal(b.numpy()[envs], np.asarray(a)[envs],
                                      err_msg=name)


def check_reset_properties(env, state, envs):
    """Reset envs: goal within +-0.25*scale of a goal cell; ball within
    +-0.25*scale of a reset cell > 0.5*scale from the goal; at rest;
    steps = 0."""
    maze = env.maze
    s = maze.size_scaling
    goal = state.goal.numpy()[envs]
    pos = state.data.qpos.numpy()[:2, envs].T
    gcells = np.array(maze.goal_locations)
    rcells = np.array(maze.reset_locations)
    eps = 1e-6
    for g, p in zip(goal, pos):
        assert (np.abs(gcells - g) <= 0.25 * s + eps).all(axis=1).any()
        near = (np.abs(rcells - p) <= 0.25 * s + eps).all(axis=1)
        assert near.any()
        assert (np.linalg.norm(rcells[near] - g, axis=1) > 0.5 * s).any()
    assert (state.steps.numpy()[envs] == 0).all()
    assert (state.data.qvel.numpy()[:, envs] == 0).all()
    np.testing.assert_array_equal(
        state.obs["desired_goal"].numpy()[envs], goal)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_env_matches_jax(dtype):
    tol = TOLS[dtype]
    jb, tb = make_pair(dtype)
    rng = np.random.default_rng(0)
    dirs = rng.uniform(-1, 1, (B, 2))  # steady pushes drive balls into walls
    touched = np.zeros(B, bool)
    for _ in range(40):
        a = np.clip(dirs + rng.uniform(-0.3, 0.3, (B, 2)), -1, 1)
        a = a.astype(np.float32)
        jout, tout = step_both(jb, tb, a)
        assert_transition_close(jout, tout, tol)
        jd, td = jb.state.data, tb.state.data
        for fld in ("qpos", "qvel", "qacc"):
            ref = np.asarray(getattr(jd, fld))
            got = getattr(td, fld).numpy().T
            assert rel_err(got, ref) <= tol, fld
        touched |= (td.contact.dist.numpy()[1:] < 0.004).any(axis=0)
    assert touched.sum() >= 2  # the run crossed wall contacts


def test_auto_reset_at_time_limit():
    tol = TOLS["float32"]
    jb, tb = make_pair("float32", seed=1)
    done = np.arange(B) % 2 == 0
    steps = np.where(done, 299, 7).astype(np.int32)
    jb.state = dataclasses.replace(jb.state, steps=jnp.asarray(steps))
    tb.state.steps = torch.as_tensor(steps)
    a = np.random.default_rng(1).uniform(-1, 1, (B, 2)).astype(np.float32)
    jout, tout = step_both(jb, tb, a)
    # the transition itself is reported for every env
    np.testing.assert_array_equal(tout[3].numpy(), done)
    np.testing.assert_array_equal(np.asarray(jout[3]), done)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=tol)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    # envs that were not done carry on as in JAX
    assert_transition_close(jout, tout, tol, envs=~done)
    assert (tb.state.steps.numpy()[~done] == 8).all()
    # done envs were reset by the port's own generator
    check_reset_properties(tb.env, tb.state, done)


def test_reset_distribution():
    tb = registry.make("PointMaze_UMaze-v3", num_envs=256, device="cpu")
    tb.reset(seed=5)
    check_reset_properties(tb.env, tb.state, slice(None))
    goal = tb.state.goal.numpy()
    assert len(np.unique(np.round(goal), axis=0)) > 3  # several goal cells


def test_divergence_guard():
    jb, tb = make_pair("float32", seed=2)
    bad_env = 3
    qvel = np.asarray(jb.state.data.qvel).copy()
    qvel[bad_env] = np.nan
    jb.state = dataclasses.replace(
        jb.state, data=dataclasses.replace(jb.state.data, qvel=jnp.asarray(qvel)))
    tb.state.data.qvel[:, bad_env] = float("nan")
    a = np.zeros((B, 2), np.float32)
    jout, tout = step_both(jb, tb, a)
    expect = np.arange(B) == bad_env
    for out in (jout, tout):
        np.testing.assert_array_equal(np.asarray(out[3]), expect)
        np.testing.assert_array_equal(np.asarray(out[4]["diverged"]), expect)
    ok = ~expect
    assert_transition_close(jout, tout, TOLS["float32"], envs=ok)
    check_reset_properties(tb.env, tb.state, expect)
    assert np.isfinite(tout[0]["observation"].numpy()).all()


@pytest.mark.parametrize("reward_type", ["sparse", "dense"])
@pytest.mark.parametrize("continuing_task", [True, False])
def test_goal_functions_match_jax(reward_type, continuing_task):
    kw = dict(reward_type=reward_type, continuing_task=continuing_task)
    jenv = JPointMaze(dtype=jnp.float64, **kw)
    tenv = registry.make("PointMaze_UMaze-v3", device="cpu",
                         dtype=torch.float64, **kw)
    rng = np.random.default_rng(7)
    ach, des = rng.uniform(-1, 1, (2, 64, 2))
    des[:8] = ach[:8] + 0.1  # some within the 0.45 success radius
    for name in ("compute_reward", "compute_terminated"):
        ref = np.asarray(getattr(jenv, name)(jnp.asarray(ach), jnp.asarray(des)))
        got = getattr(tenv, name)(torch.tensor(ach), torch.tensor(des)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOLS["float64"])


def test_reset_target_respawns_far_goal():
    """continuing_task + reset_target: a reached goal is redrawn near a goal
    cell (+-0.25*scale) more than 0.45 from the ball; others stay."""
    tb = registry.make("PointMaze_UMaze-v3", num_envs=64, device="cpu",
                       reset_target=True)
    tb.reset(seed=3)
    s = tb.state
    reached = torch.arange(64) % 2 == 0
    s.goal = torch.where(reached[:, None], s.data.qpos[:2].T, s.goal)
    old_goal = s.goal.clone()
    obs, _, _, _, info = tb.step(torch.zeros(64, 2))
    assert info["success"][reached].all()
    new_goal = tb.state.goal.numpy()
    ball = tb.state.data.qpos[:2].T.numpy()
    np.testing.assert_array_equal(new_goal[~reached.numpy()],
                                  old_goal[~reached].numpy())
    gcells = np.array(tb.env.maze.goal_locations)
    for g, p in zip(new_goal[reached.numpy()], ball[reached.numpy()]):
        assert np.linalg.norm(g - p) > 0.45
        assert (np.abs(gcells - g) <= 0.25 + 1e-6).all(axis=1).any()
    np.testing.assert_array_equal(obs["desired_goal"].numpy(), new_goal)


def test_reset_with_values_matches_jax():
    jb, tb = make_pair("float64", seed=4)
    rng = np.random.default_rng(4)
    values = {"goal_xy": rng.uniform(-1, 1, (B, 2)),
              "reset_xy": rng.uniform(-1, 1, (B, 2))}
    js = jax.vmap(jb.env.reset_with_values)(
        jb.state, {k: jnp.asarray(v) for k, v in values.items()})
    ts = tb.env.reset_with_values(tb.state, values)
    for k in js.obs:
        np.testing.assert_array_equal(ts.obs[k].numpy(), np.asarray(js.obs[k]))
    np.testing.assert_array_equal(ts.goal.numpy(), np.asarray(js.goal))
    np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
    np.testing.assert_array_equal(ts.data.qpos.numpy().T, np.asarray(js.data.qpos))
    np.testing.assert_array_equal(ts.data.qacc.numpy().T, np.asarray(js.data.qacc))
