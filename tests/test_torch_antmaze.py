"""The AntMaze_UMaze-v5 slice as a whole: the port's BatchedEnv against the
JAX BatchedEnv from the very same state (carried across with convert.py),
stepped with the same numpy actions, and the env's own functions.

The JAX env runs its batch-last SoA path on the XLA side (soa="force"; the
selection, formulas and Newton solve take their CPU defaults), compiled
once, in float64; the carried state has the ants' legs pressed into the
walls and the floor. Tolerance: relative error scaled by max(1, |ref|)
<= 1e-9 for the port in float64 over 3 env steps (15 RK4 substeps), and
<= 2e-4 for the port in float32 after 1 env step against the same float64
reference. RNG streams differ between jax.random and torch, so auto-resets
are held by their properties, and host-drawn resets through
reset_with_values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.maze.ant_maze import AntMazeEnv as JAnt
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.maze.ant_maze import AntMazeEnv

B = 4
STEPS = 3
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


def pressed_qpos(qpos0, jnt_range, rs, n):
    """(n, nq) ant poses with the legs against the top-left cell's walls and
    the floor (as test_torch_antmaze_stages.pressed_qpos)."""
    qpos = np.tile(qpos0, (n, 1))
    u = rs.uniform(0.5, 1.0, n)
    along = rs.uniform(-5.0, -3.0, n)
    top = np.arange(n) % 2 == 0
    qpos[:, 0] = np.where(top, along, -6.0 + u)
    qpos[:, 1] = np.where(top, 6.0 - u, along + 8.0)
    qpos[:, 2] = rs.uniform(0.3, 0.55, n)
    q = np.concatenate([np.ones((n, 1)), rs.normal(0, 0.1, (n, 3))], axis=1)
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    lo, hi = jnt_range[1:].T
    qpos[:, 7:] = rs.uniform(lo, hi, (n, len(lo)))
    return qpos


@pytest.fixture(scope="module")
def jax_run():
    """(initial state as numpy, actions, per step (transition, state) as
    numpy) of the JAX BatchedEnv in float64."""
    jenv = JAnt(dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 700
    jb = JBatched(jenv, B)
    jb.reset(seed=0)
    rs = np.random.RandomState(1)
    m = jenv.model
    qpos = pressed_qpos(np.asarray(m.qpos0), np.asarray(m.jnt_range), rs, B)
    data = dataclasses.replace(
        jb.state.data, qpos=jnp.asarray(qpos),
        qvel=jnp.asarray(rs.normal(0, 0.5, (B, m.nv))))
    jb.state = dataclasses.replace(jb.state, data=data)
    s0 = jax_state_to_numpy(jb.state)
    actions = rs.uniform(-1, 1, (STEPS, B, m.nu))
    out = []
    for a in actions:
        o, r, te, tr, info = jb.step(a)
        out.append((dict(obs={k: np.asarray(v) for k, v in o.items()},
                         reward=np.asarray(r), terminated=np.asarray(te),
                         truncated=np.asarray(tr),
                         info={k: np.asarray(v) for k, v in info.items()}),
                    jax_state_to_numpy(jb.state)))
    return s0, actions, out


def cast_state(state, dtype):
    """The carried state's floating leaves in ``dtype``."""

    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))
    return dataclasses.replace(
        state, data=data, obs={k: cast(v) for k, v in state.obs.items()},
        reward=cast(state.reward), goal=cast(state.goal))


@pytest.mark.parametrize("dtype,steps", [("float64", STEPS), ("float32", 1)])
def test_env_matches_jax(jax_run, dtype, steps):
    tol = TOLS[dtype]
    s0, actions, ref = jax_run
    tdt = getattr(torch, dtype)
    tb = registry.make("AntMaze_UMaze-v5", num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    contacts = 0
    for a, (jt, js) in zip(actions[:steps], ref):
        to, tr, tte, ttr, ti = tb.step(torch.as_tensor(a, dtype=tdt))
        for k in jt["obs"]:
            assert rel_err(to[k].numpy(), jt["obs"][k]) <= tol, k
        assert to["observation"].shape == (B, 105)
        assert rel_err(tr.numpy(), jt["reward"]) <= tol
        for name, a_, b_ in (("terminated", jt["terminated"], tte),
                             ("truncated", jt["truncated"], ttr),
                             ("success", jt["info"]["success"], ti["success"]),
                             ("diverged", jt["info"]["diverged"], ti["diverged"])):
            np.testing.assert_array_equal(b_.numpy(), a_, err_msg=name)
        td, jd = tb.state.data, js["data"]
        for fld in ("qpos", "qvel", "qacc", "xpos", "cfrc_ext", "time"):
            got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
            assert rel_err(got, jd[fld]) <= tol, fld
        if dtype == "float64":
            np.testing.assert_array_equal(td.contact.src.numpy().T,
                                          jd["contact"]["src"])
        contacts += int((jd["contact"]["dist"] < 0).any(axis=1).sum())
    assert contacts >= 2 * steps  # the run crossed contacts


def test_v3_observation_matches_jax(jax_run):
    """v3/v4 observe qpos[2:] and qvel only (27 dims) and skip the
    contact-force decode; v5 appends the clipped cfrc_ext[1:]."""
    s0, _, _ = jax_run
    jenv = JAnt(dtype=jnp.float64, version="v3")
    tenv = registry.make("AntMaze_UMaze-v3", device="cpu", dtype=torch.float64)
    assert not tenv.model.opt.need_cfrc_ext and not tenv.include_cfrc
    jd = jax.tree_util.tree_map(
        jnp.asarray, jax_state_to_numpy_data(s0["data"]))
    goal = jnp.asarray(s0["goal"])
    ref = jax.vmap(jenv._get_obs)(jd, goal)
    got = tenv._get_obs(convert.data_from_numpy(s0["data"], "cpu"),
                        torch.tensor(s0["goal"]))
    assert got["observation"].shape == (B, 27)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def jax_state_to_numpy_data(fields):
    """A JAX Data from the numpy leaves of jax_state_to_numpy."""
    from gymnasium_robotics_tpu.physics import types as JT

    c = fields["contact"]
    contact = JT.Contact(**{k: None if v is None else jnp.asarray(v)
                            for k, v in c.items()})
    return JT.Data(**{k: jnp.asarray(v) for k, v in fields.items()
                      if k != "contact"}, contact=contact)


def test_reset_with_values_matches_jax():
    """The port's host-value reset builds what the JAX reset builds from the
    same goal and torso position: make_data, torso xy, kinematics only."""
    jenv = JAnt(dtype=jnp.float64)
    tenv = AntMazeEnv(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    goal = rng.uniform(-5, 5, (B, 2))
    goal[0] = [1.0, 2.0]
    reset_xy = rng.uniform(-5, 5, (B, 2))
    reset_xy[0] = [1.2, 2.1]                    # within 0.45 of its goal

    def jreset(g, xy):
        d = jpipe.make_data(jenv.model, dtype=jnp.float64)
        d = dataclasses.replace(d, qpos=d.qpos.at[:2].set(xy))
        d = jpipe.refresh_kin(jenv.model, d, com=False)
        obs = jenv._get_obs(d, g)
        return d, obs, jnp.linalg.norm(obs["achieved_goal"] - g) <= 0.45

    jd, jobs, jsucc = jax.jit(jax.vmap(jreset))(jnp.asarray(goal),
                                                jnp.asarray(reset_xy))
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = tenv.reset_with_values(template, {"goal_xy": goal, "reset_xy": reset_xy})
    for k in jobs:
        np.testing.assert_allclose(ts.obs[k].numpy(), np.asarray(jobs[k]),
                                   rtol=0, atol=TOLS["float64"])
    np.testing.assert_array_equal(ts.info["success"].numpy(), np.asarray(jsucc))
    assert ts.info["success"][0] and (ts.steps.numpy() == 0).all()
    for fld in ("qpos", "xpos", "xquat", "geom_xpos", "geom_xmat"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, np.asarray(getattr(jd, fld))) <= TOLS["float64"], fld
    src = ts.data.contact.src
    assert src.shape == (57, B) and not src.any()


def test_auto_reset_picks_pruned_src():
    """The compact contact table's slot map is per env under pair-topk: an
    env that auto-resets takes the fresh (all-zero) src, geom1 and geom2,
    the others keep the ones their own step made."""
    tb = registry.make("AntMaze_UMaze-v5", num_envs=B, device="cpu",
                       dtype=torch.float64)
    tb.reset(seed=3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tb.step(torch.rand((B, 8), generator=gen) * 2 - 1)
    done = torch.arange(B) % 2 == 0
    tb.state.steps = torch.where(done, 699, 5).to(torch.int32)
    a = torch.rand((B, 8), generator=gen) * 2 - 1
    stepped = tb.env.step(tb.state, a, tb.generator)
    _, _, _, truncated, _ = tb.step(a)
    assert torch.equal(truncated, done)
    c, cs = tb.state.data.contact, stepped.data.contact
    for name in ("src", "geom1", "geom2"):
        got, ref = getattr(c, name), getattr(cs, name)
        assert ref[25:, ~done].any()       # the pruned rows vary per env
        assert not got[:, done].any(), name
        assert torch.equal(got[:, ~done], ref[:, ~done]), name
    assert torch.equal(tb.state.steps, torch.where(done, 0, 6).to(torch.int32))


def test_every_ant_maze_id_makes():
    ids = [i for i in registry.ids() if i.startswith("AntMaze")]
    assert len(ids) == 60
    for id_ in ids:
        env = registry.make(id_, device="cpu")
        ver = id_[-2:]
        assert env.version == ver and env.model.opt.pair_topk == 8
        assert env.obs_dim == (105 if ver == "v5" else 27)
        assert env.max_episode_steps == (700 if "UMaze" in id_ or "Open" in id_
                                         else 1000)
        assert env.reward_type == ("dense" if "Dense" in id_ else "sparse")
    env = registry.make("AntMaze_Medium_Diverse_GR-v4", num_envs=2, device="cpu")
    env.reset(seed=0)
    obs, *_ = env.step(torch.zeros(2, 8))
    assert obs["observation"].shape == (2, 27)
    assert torch.isfinite(obs["observation"]).all()
