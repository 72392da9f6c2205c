"""The FetchPush-v4 slice as a whole: the port's BatchedEnv against the JAX
BatchedEnv from the very same state (carried across with convert.py),
stepped with the same numpy actions, and the env's own functions.

The JAX env runs its batch-last SoA path on the XLA side (soa="force"; the
selection, formulas with MPR and the Newton solve take their CPU defaults),
its batched step compiled once (at XLA's lowest backend optimisation level,
which changes how fast the compiler runs, not the arithmetic), in float64.
The carried state has the object on the table against the fingers in one
env and pressed up into the gripper link in the other, so box-box and MPR
rows are active. Tolerance: relative error scaled by
max(1, |ref|) <= 1e-9 for the port in float64 over 2 env steps (40 Euler
substeps), and <= 2e-4 for the port in float32 after 1 env step against
the same float64 reference. RNG streams differ between jax.random and
torch, so auto-resets are held by their properties, and host-drawn resets
through reset_with_values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _jax_ref as R

from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.fetch.fetch import FetchPushEnv as JPush
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchPushEnv

B = 2
STEPS = 2
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


def object_near_gripper(qpos, oq):
    """Env 0: the object on the table, pressed against the fingers' front;
    env 1: the object behind the fingers, 0.5 mm up into the gripper link
    (so the first substeps' MPR rows penetrate)."""
    qpos = qpos.copy()
    qpos[0, oq:oq + 3] = [1.362 + 0.0385 + 0.025 - 0.004, 0.7486, 0.4244]
    qpos[1, oq:oq + 3] = [1.30, 0.7486, 0.482]
    return qpos


@pytest.fixture(scope="module")
def jax_run():
    """(initial state as numpy, actions, per step (transition, state) as
    numpy, and the state the JAX reset drew) of the JAX BatchedEnv in
    float64."""
    jenv = JPush(dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 50
    jb = JBatched(jenv, B)
    jb.reset(seed=0)
    s_reset = jax_state_to_numpy(jb.state)
    mt = jenv.model.meta
    oq = mt.jnt_qposadr[mt.joint_names.index("object0:joint")]
    rs = np.random.RandomState(1)
    qvel = np.zeros((B, mt.nv))     # the object moving; the arm at rest
    qvel[:, -6:] = rs.normal(0, 0.05, (B, 6))
    data = dataclasses.replace(
        jb.state.data,
        qpos=jnp.asarray(object_near_gripper(np.asarray(jb.state.data.qpos), oq)),
        qvel=jnp.asarray(qvel))
    jb.state = dataclasses.replace(jb.state, data=data)
    s0 = jax_state_to_numpy(jb.state)
    actions = rs.uniform(-1, 1, (STEPS, B, 4))
    step = R.compiled_step(jb, jb.state, jnp.asarray(actions[0]))
    out = []
    for a in actions:
        jb.state = step(jb.state, jnp.asarray(a))
        s = jb.state
        out.append((dict(obs={k: np.asarray(v) for k, v in s.obs.items()},
                         reward=np.asarray(s.reward),
                         terminated=np.asarray(s.terminated),
                         truncated=np.asarray(s.truncated),
                         info={k: np.asarray(v) for k, v in s.info.items()}),
                    jax_state_to_numpy(s)))
    return s0, actions, out, s_reset


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
        reward=cast(state.reward), goal=cast(state.goal),
        info={k: cast(v) for k, v in state.info.items()})


@pytest.mark.parametrize("dtype,steps", [("float64", STEPS), ("float32", 1)])
def test_env_matches_jax(jax_run, dtype, steps):
    tol = TOLS[dtype]
    s0, actions, ref, _ = jax_run
    tdt = getattr(torch, dtype)
    tb = registry.make("FetchPush-v4", num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    for a, (jt, js) in zip(actions[:steps], ref):
        to, tr, tte, ttr, ti = tb.step(torch.as_tensor(a, dtype=tdt))
        for k in jt["obs"]:
            assert rel_err(to[k].numpy(), jt["obs"][k]) <= tol, k
        assert to["observation"].shape == (B, 25)
        assert rel_err(tr.numpy(), jt["reward"]) <= tol
        assert rel_err(ti["is_success"].numpy(), jt["info"]["is_success"]) <= tol
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
        # the object stays on the table against the fingers
        assert (jd["contact"]["dist"][0] < 0).any()


def test_carried_state_round_trips(jax_run):
    """convert.py carries a Fetch EnvState both ways unchanged: mocap
    pose, eq_active and the per-env compact slot map included."""
    s0 = jax_run[0]
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(s0, "cpu"))
    for k in ("qpos", "qvel", "mocap_pos", "mocap_quat", "eq_active", "xpos"):
        np.testing.assert_array_equal(back["data"][k], s0["data"][k], err_msg=k)
    for k in ("src", "geom1", "geom2", "dist", "frame"):
        np.testing.assert_array_equal(back["data"]["contact"][k],
                                      s0["data"]["contact"][k], err_msg=k)
    assert back["data"]["contact"]["src"].shape == (B, 277)
    for k in ("goal", "steps", "reward"):
        np.testing.assert_array_equal(back[k], s0[k], err_msg=k)
    np.testing.assert_array_equal(back["info"]["is_success"],
                                  s0["info"]["is_success"])


def test_auto_reset_at_max_episode_steps():
    """An env at its last step comes back reset (steps 0, the initial arm
    pose, a fresh all-zero slot map) and reports truncated; the other keeps
    its stepped state."""
    tb = registry.make("FetchPush-v4", num_envs=B, device="cpu",
                       dtype=torch.float64)
    tb.reset(seed=3)
    env = tb.env
    assert env.max_episode_steps == 50
    tb.state.steps = torch.tensor([49, 5], dtype=torch.int32)
    _, _, terminated, truncated, info = tb.step(torch.zeros(B, 4, dtype=torch.float64))
    assert truncated.tolist() == [True, False] and not terminated.any()
    assert tb.state.steps.tolist() == [0, 6]
    d = tb.state.data
    q0 = env._init_qpos
    keep = torch.ones(env.model.nq, dtype=torch.bool)
    keep[env._obj_qadr:env._obj_qadr + 2] = False
    assert torch.equal(d.qpos[keep, 0], q0[keep])
    assert d.time.tolist() == pytest.approx([0.0, 20 * 0.002])
    assert not d.contact.src[:, 0].any() and d.contact.src[:, 1].any()
    # the object lands at least 0.1 from the gripper, the goal on the table
    obj = d.qpos[env._obj_qadr:env._obj_qadr + 2, 0]
    assert float(torch.linalg.vector_norm(obj - env._init_grip[:2])) >= 0.1
    assert float(tb.state.goal[0, 2]) == pytest.approx(env._height_offset)


def test_reward_matches_jax():
    jenv = JPush(dtype=jnp.float64)
    rs = np.random.RandomState(5)
    a = rs.normal(0, 0.05, (6, 3))
    g = a + rs.normal(0, 0.05, (6, 3))
    for reward_type in ("sparse", "dense"):
        jenv.reward_type = reward_type
        tenv = FetchPushEnv(reward_type=reward_type, dtype=torch.float64,
                            device="cpu")
        ref = np.asarray(jenv.compute_reward(jnp.asarray(a), jnp.asarray(g)))
        got = tenv.compute_reward(torch.tensor(a), torch.tensor(g)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
        assert not tenv.compute_terminated(torch.tensor(a), torch.tensor(g)).any()
    assert set(np.unique(got)) != {0.0}


def test_reset_with_values_matches_jax(jax_run):
    """Given the goals and object positions the JAX reset drew, the port's
    host-value reset builds the same state: the initial arm, the object
    placed, kinematics and com refreshed, the observation."""
    ref = jax_run[3]
    tenv = FetchPushEnv(dtype=torch.float64, device="cpu")
    oq = tenv._obj_qadr
    values = {"goal": ref["goal"], "object_xy": ref["data"]["qpos"][:, oq:oq + 2]}
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = tenv.reset_with_values(template, values)
    for k in ref["obs"]:
        np.testing.assert_allclose(ts.obs[k].numpy(), ref["obs"][k], rtol=0,
                                   atol=TOLS["float64"])
    for fld in ("qpos", "qvel", "xpos", "site_xpos", "subtree_com",
                "mocap_pos", "mocap_quat"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= TOLS["float64"], fld
    assert (ts.steps.numpy() == 0).all() and not ts.info["is_success"].any()
    np.testing.assert_array_equal(ts.data.contact.src.numpy().T,
                                  ref["data"]["contact"]["src"])


def test_pick_and_place_steps():
    """FetchPickAndPlace: the fingers' position actuators follow the
    gripper action (ctrl = finger qpos + action[3])."""
    tb = registry.make("FetchPickAndPlace-v4", num_envs=B, device="cpu")
    tb.reset(seed=0)
    env = tb.env
    assert env.model.nu == 2 and not env.block_gripper
    a = torch.tensor([[0.2, -0.1, 0.0, 1.0], [0.0, 0.3, -0.2, -1.0]])
    obs, reward, *_ = tb.step(a)
    assert obs["observation"].shape == (B, 25)
    assert torch.isfinite(obs["observation"]).all() and torch.isfinite(reward).all()
    d = tb.state.data
    finger = d.qpos[env._finger_qadr]
    assert float(finger[:, 0].mean()) > float(finger[:, 1].mean())  # opened vs closed


def test_every_fetch_id_makes():
    """The 16 Fetch IDs of the JAX registry (reach, push, slide and
    pick-and-place, v1 and v4, sparse and dense) construct on the CPU with
    the JAX side's observation width (25 with an object, 10 for reach)."""
    from gymnasium_robotics_tpu import registry as jreg
    from gymnasium_robotics_tpu.envs import fetch as jfetch

    ids = [i for i in registry.ids() if i.startswith("Fetch")]
    assert ids == sorted(i for i in jreg.ids() if i.startswith("Fetch"))
    assert len(ids) == 16
    tasks = {"Reach": "reach", "Push": "push", "Slide": "slide",
             "PickAndPlace": "pick_and_place"}
    width = {}
    for name, task in tasks.items():
        jenv = getattr(jfetch, f"Fetch{name}Env")(dtype=jnp.float64)
        width[task] = jenv.observation_space["observation"].shape[0]
    assert width == {"reach": 10, "push": 25, "slide": 25, "pick_and_place": 25}
    for id_ in ids:
        env = registry.make(id_, device="cpu")
        assert env.max_episode_steps == 50
        assert env.reward_type == ("dense" if "Dense" in id_ else "sparse")
        assert env.task == tasks[id_[5:].split("-")[0].replace("Dense", "")]
        assert env.obs_dim == width[env.task]
        assert env.model.opt.pair_topk == 8 and env.model.opt.contact_cap == 24
