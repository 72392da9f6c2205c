"""The FetchReach-v4 slice against the JAX package: the env without an
object (the 10-wide observation, the goal drawn around the gripper's start
without an offset or a height pin, no actuators), one env step, the
solves at nv = 15 and the carried state.

- One env step of the port's BatchedEnv against the JAX BatchedEnv (its
  batched step compiled once, at XLA's lowest backend optimisation level,
  in float64) from two states: "moving", the JAX reset's state with the
  arm's hinges moving, and "pressed", the same with the second env's robot
  and mocap body lowered so its fingers rest 2.5 mm in the table: 1e-9 for
  the port in float64 from both, 2e-4 for the port in float32 against the
  same float64 reference from "moving". The pressed fingers are squeezed
  between the mocap weld and the table, where float32 rounding alone moves
  the step's solve (the port's own float32 step lands 1.6e-2 from its
  float64 step there, as JAX's float32 step does on FetchSlide's squeezed
  puck), so no float32 path is held at 2e-4 there.
- solve_newton_plain and solve_pos_plain at nv = 15 on the rows the reach
  model builds (6 weld rows, 9 joint-limit rows, 24 capped contacts x 4
  and x 6 pyramid edges: 255) against the Pallas kernels _kernel_nv and
  _kernel_chol in interpret mode, in float64 (1e-9).
- reset_with_values and the parity draws against the JAX package's; the
  state carried both ways by convert.py.

Relative error scaled by max(1, |ref|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.fetch.fetch import FetchReachEnv as JReach
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchReachEnv
from gymnasium_robotics_tpu_torch.physics import constraint, pipeline, solver
from gymnasium_robotics_tpu_torch.utils import parity as tparity

B = 2
TOLS = {"float32": 2e-4, "float64": 1e-9}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
LOWER = 0.119   # env 1's robot and mocap body lowered: fingers 2.5 mm deep


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


def jax_step(step, state, action):
    """One compiled JAX step: (the carried state, the transition and the
    stepped state, as numpy)."""
    s = step(state, jnp.asarray(action))
    return jax_state_to_numpy(state), (
        dict(obs={k: np.asarray(v) for k, v in s.obs.items()},
             reward=np.asarray(s.reward),
             info={k: np.asarray(v) for k, v in s.info.items()},
             terminated=np.asarray(s.terminated),
             truncated=np.asarray(s.truncated)),
        jax_state_to_numpy(s))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX BatchedEnv in float64: ({state name: (the carried state,
    (the transition, the stepped state))} as numpy, the action, the state
    the JAX reset drew, the JAX env)."""
    jenv = JReach(dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 50
    jb = JBatched(jenv, B)
    jb.reset(seed=0)
    s_reset = jax_state_to_numpy(jb.state)
    rs = np.random.RandomState(2)
    d = jb.state.data
    qvel = np.asarray(d.qvel).copy()
    qvel[:, 6:13] = rs.normal(0, 0.05, (B, 7))   # the arm's hinges moving
    moving = dataclasses.replace(jb.state, data=dataclasses.replace(
        d, qvel=jnp.asarray(qvel)))
    qpos, mp = np.asarray(d.qpos).copy(), np.asarray(d.mocap_pos).copy()
    qpos[1, 2] -= LOWER
    mp[1, :, 2] -= LOWER
    pressed = dataclasses.replace(moving, data=dataclasses.replace(
        moving.data, qpos=jnp.asarray(qpos), mocap_pos=jnp.asarray(mp)))
    action = rs.uniform(-1, 1, (B, 4))
    step = jb._step_fn.lower(moving, jnp.asarray(action)).compile(FAST_COMPILE)
    runs = {name: jax_step(step, st, action)
            for name, st in (("moving", moving), ("pressed", pressed))}
    return runs, action, s_reset, jenv


def cast_state(state, dtype):
    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))
    return dataclasses.replace(
        state, data=data, obs={k: cast(v) for k, v in state.obs.items()},
        reward=cast(state.reward), goal=cast(state.goal),
        info={k: cast(v) for k, v in state.info.items()})


@pytest.mark.parametrize("dtype,state", [("float64", "moving"),
                                         ("float64", "pressed"),
                                         ("float32", "moving")])
def test_env_matches_jax(jax_run, dtype, state):
    tol = TOLS[dtype]
    s0, (jt, js) = jax_run[0][state]
    action = jax_run[1]
    tdt = getattr(torch, dtype)
    tb = registry.make("FetchReach-v4", num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    to, tr, tte, ttr, ti = tb.step(torch.as_tensor(action, dtype=tdt))
    assert to["observation"].shape == (B, 10)
    for k in jt["obs"]:
        assert rel_err(to[k].numpy(), jt["obs"][k]) <= tol, k
    assert rel_err(tr.numpy(), jt["reward"]) <= tol
    assert rel_err(ti["is_success"].numpy(), jt["info"]["is_success"]) <= tol
    assert not jt["info"]["diverged"].any()
    for name, a_, b_ in (("terminated", jt["terminated"], tte),
                         ("truncated", jt["truncated"], ttr),
                         ("diverged", jt["info"]["diverged"], ti["diverged"])):
        np.testing.assert_array_equal(b_.numpy(), a_, err_msg=name)
    td, jd = tb.state.data, js["data"]
    for fld in ("qpos", "qvel", "qacc", "xpos", "mocap_pos", "mocap_quat",
                "time"):
        got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
        assert rel_err(got, jd[fld]) <= tol, fld
    if dtype == "float64":
        np.testing.assert_array_equal(td.contact.src.numpy().T,
                                      jd["contact"]["src"])
    # the lowered env's fingers touch the table
    assert (jd["contact"]["dist"][1] < 0).any() == (state == "pressed")


def test_observation_and_goal_draw():
    """No object: the observation is the grip position, the fingers'
    state, the grip velocity and the fingers' velocity (10 wide), the
    achieved goal the grip position; the goal is the gripper's start plus
    a uniform offset in [-0.15, 0.15] on every axis (no height pin), and
    the model has no actuators."""
    env = FetchReachEnv(dtype=torch.float64, device="cpu")
    assert env.model.nu == 0 and not env.has_object and env.obs_dim == 10
    s = env.initial(256, torch.Generator().manual_seed(0))
    obs = s.obs["observation"]
    assert obs.shape == (256, 10)
    torch.testing.assert_close(s.obs["achieved_goal"], obs[:, :3], rtol=0, atol=0)
    torch.testing.assert_close(obs[:, :3], env._init_grip.expand(256, 3),
                               rtol=0, atol=1e-5)
    off = s.goal - env._init_grip
    assert float(off.abs().max()) <= env.target_range
    assert float(off.min()) < -0.1 and float(off.max()) > 0.1
    assert float(s.goal[:, 2].std()) > 0.05


def test_reset_with_values_matches_jax(jax_run):
    ref = jax_run[2]
    tenv = FetchReachEnv(dtype=torch.float64, device="cpu")
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = tenv.reset_with_values(template, {"goal": ref["goal"]})
    for k in ref["obs"]:
        np.testing.assert_allclose(ts.obs[k].numpy(), ref["obs"][k], rtol=0,
                                   atol=TOLS["float64"])
    for fld in ("qpos", "qvel", "xpos", "site_xpos", "mocap_pos"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= TOLS["float64"], fld


def test_parity_draws_match_jax(jax_run):
    """utils/parity's draws for FetchReach (the goal only) equal the JAX
    package's from the same seed."""
    from gymnasium_robotics_tpu.utils import parity as jparity

    tenv = FetchReachEnv(dtype=torch.float64, device="cpu")
    for seed in range(4):
        ref = jparity._fetch_values(jax_run[3], np.random.default_rng(seed))
        got = tparity.sample_reset_values(tenv, np.random.default_rng(seed))
        assert set(got) == set(ref) == {"goal"}
        np.testing.assert_array_equal(got["goal"], ref["goal"])


def test_carried_state_round_trips(jax_run):
    """convert.py carries a FetchReach EnvState both ways unchanged."""
    s0 = jax_run[0]["pressed"][0]
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(s0, "cpu"))
    for k in ("qpos", "qvel", "mocap_pos", "mocap_quat", "eq_active", "xpos"):
        np.testing.assert_array_equal(back["data"][k], s0["data"][k], err_msg=k)
    for k in ("src", "geom1", "geom2", "dist", "frame"):
        np.testing.assert_array_equal(back["data"]["contact"][k],
                                      s0["data"]["contact"][k], err_msg=k)
    assert back["data"]["contact"]["src"].shape == (B, 246)
    assert back["obs"]["observation"].shape == (B, 10)
    for k in ("goal", "steps", "reward"):
        np.testing.assert_array_equal(back[k], s0[k], err_msg=k)


def _reach_rows():
    """The Newton operands of FetchReach's two envs of the carried state
    (the second with its fingers in the table), float64: 255 rows at
    nv = 15."""
    tb = registry.make("FetchReach-v4", num_envs=B, device="cpu",
                       dtype=torch.float64)
    tb.reset(seed=0)
    m, d = tb.env.model, tb.state.data
    d.qpos[2, 1] -= LOWER
    d.mocap_pos[:, 2, 1] -= LOWER
    d = pipeline.forward(m, d)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    return (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq), m


def test_solves_match_pallas_nv15():
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    args, m = _reach_rows()
    M, asm, a0, J, aref, D, active, is_eq = (a.numpy() for a in args)
    assert J.shape == (255, 15, B) and active[:6].all()
    assert active[15:, 1].any() and not active[15:, 0].any()  # contacts in env 1
    n_iter, n_ls = m.opt.iterations, m.opt.ls_iterations
    qref, fref = SP.solve_small_soa(
        *(jnp.asarray(x) for x in (M, asm, a0, J, aref, D, active,
                                   np.broadcast_to(is_eq[:, None], aref.shape))),
        n_iter=n_iter, n_ls=n_ls, interpret=True)
    qacc, f = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(qacc.numpy(), qref) <= TOLS["float64"]
    assert rel_err(f.numpy(), fref) <= TOLS["float64"]
    b = np.random.RandomState(15).normal(size=(15, B))
    ref = SP.solve_pos_soa(jnp.asarray(M), jnp.asarray(b), interpret=True)
    got = solver.solve_pos_plain(args[0], torch.tensor(b))
    assert rel_err(got.numpy(), ref) <= TOLS["float64"]
