"""The HandManipulateBlock slice as a whole: the port's BatchedEnv against
the JAX BatchedEnv from the very same state (carried across with
convert.py, the pool of settled poses in ``aux`` included), stepped with
the same numpy actions; the env's own functions and its 52 IDs (the parity reset, with its settle, is held
in tests/test_torch_hand_reset.py).

The JAX env runs its batch-last SoA path on the XLA side (soa="force"; the
contact_cap selection, the formulas with MPR and the Newton solve take
their CPU defaults), its batched step compiled once (at XLA's lowest
backend optimisation level, which changes how fast the compiler runs, not
the arithmetic), in float64. The env is the touch-sensor model with a
random target position and dense rewards, so the touch observations, the
position offset and the rewards are all held. Its state starts from a pool
of two poses an env, given rather than settled: the settled hand with the
block resting on the palm and pressed into it, so box-box, capsule-box and
touch rows are active (tests/test_torch_hand_stages.py holds box-hull).
Tolerance:
relative error scaled by max(1, |ref|) <= 1e-9 for the port in float64,
after 1 env step (20 Euler substeps) with the block resting and after 2
with it falling onto the palm, except qacc, the output of a solve whose
rounding the hand's conditioning amplifies (1.31e-9 measured after the
resting step): <= 1e-8. In float32 the solve is far worse conditioned:
from one state a float32 substep moves qacc by ~5 % of its largest entry
from the float64 one (4.93 of 92.25 m/s^2, the coupling tendons' rows
sitting at their limits), so after 1 env step of the falling block the
port in float32 is held to the float64 reference at 2e-2 (measured:
2.3e-3 in the observation, 1.03e-2 in qacc), not FetchPush's 2e-4. RNG streams differ
between jax.random and torch, so auto-resets are held by their
properties."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu import core as jcore
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.hand.hand import HandManipulateBlockEnv as JBlock
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.hand.hand import HandManipulateBlockEnv

B = 2
POOL = 2
STEPS = 2
TOLS = {"float32": 2e-2, "float64": 1e-9}
QACC_TOL = 1e-8      # float64 qacc, the ill-conditioned solve's output
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
KW = dict(target_position="random", target_rotation="xyz",
          reward_type="dense", touch_obs="sensordata")


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
        aux={k: np.asarray(v) for k, v in s.aux.items()},
    )


# the hand's qpos after the 200-substep settle of the rest pose (zero
# action, float64): fingers half closed, the block resting on the palm
SETTLED = np.array([
    -0.174769, -0.191854, -0.000252, 0.764122, 0.661155, 0.60541, -0.000276,
    0.764287, 0.661136, 0.60539, -0.00158, 0.756159, 0.661121, 0.605374,
    0.356196, 0.002463, 0.76752, 0.662276, 0.606701, 0.003707, 0.582204,
    -0.008114, -0.002224, -0.777191, 1.011544, 0.877313, 0.16682, 0.997886,
    -0.048259, 0.006906, 0.042974, 1.0, 0.87, 0.2, 1.0, 0.0, 0.0, 0.0])


def pool_poses(env, rs):
    """(pool_qpos (B, POOL, nq), pool_qvel (B, POOL, nv)): the settled hand
    with the block on the palm, pressed 0-1.5 mm into it and turned by up
    to 0.1 rad about z, moving slowly."""
    mt = env.model.meta
    oq = env._obj_qadr
    poses = []
    for _ in range(B * POOL):
        q = SETTLED.copy()
        q[oq + 2] -= rs.uniform(0.0, 0.0015)
        yaw = rs.uniform(-0.1, 0.1)
        q[oq + 3:oq + 7] = rotations_np_mul(
            q[oq + 3:oq + 7], [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
        poses.append(q)
    pq = np.stack(poses).reshape(B, POOL, mt.nq)
    pv = rs.normal(0, 0.01, (B, POOL, mt.nv))
    return pq, pv


def rotations_np_mul(q0, q1):
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                     w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                     w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                     w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1])


@pytest.fixture(scope="module")
def jax_run():
    """{start: (initial state as numpy, actions, per step the state as
    numpy)} of the JAX BatchedEnv in float64, from states reset out of a
    given pool (no settle): the block resting on the palm ("rest"), and
    lifted 2 cm above it ("lifted"), where it falls onto the palm during
    the second step."""
    jenv = JBlock(reset_pool_size=POOL, dtype=jnp.float64, **KW)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 100
    jb = JBatched(jenv, B)
    rs = np.random.RandomState(0)
    pq, pv = pool_poses(jenv, rs)
    mt = jenv.model.meta

    def init(key, q, v):
        state = jcore.EnvState(
            data=jpipe.make_data(jenv.model, dtype=jnp.float64), obs=None,
            reward=jnp.zeros((), jnp.float64), terminated=jnp.zeros((), bool),
            truncated=jnp.zeros((), bool),
            info={"is_success": jnp.zeros((), jnp.float64)}, rng=key,
            goal=jnp.zeros(7, jnp.float64), steps=jnp.zeros((), jnp.int32),
            aux={"pool_qpos": q, "pool_qvel": v})
        return jenv.reset(state, key)

    lift = np.zeros(mt.nq)
    lift[jenv._obj_qadr + 2] = 0.02
    init_b = jax.jit(jax.vmap(init))
    # small actions: full-range ones fling the block off the palm
    actions = rs.uniform(-0.1, 0.1, (STEPS, B, 20))
    runs, step = {}, None
    for start, q in (("rest", pq), ("lifted", pq + lift)):
        state = jcore.with_diverged(init_b(
            jax.random.split(jax.random.key(0), B), jnp.asarray(q),
            jnp.asarray(pv)))
        s0 = jax_state_to_numpy(state)
        if step is None:
            step = jb._step_fn.lower(state, jnp.asarray(actions[0])).compile(
                FAST_COMPILE)
        out = []
        for a in actions:
            state = step(state, jnp.asarray(a))
            out.append(jax_state_to_numpy(state))
        runs[start] = (s0, actions, out)
    return runs


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
        info={k: cast(v) for k, v in state.info.items()},
        aux={k: cast(v) for k, v in state.aux.items()})


@pytest.mark.parametrize("dtype,start,steps", [
    ("float64", "rest", 1), ("float64", "lifted", STEPS),
    ("float32", "lifted", 1)])
def test_env_matches_jax(jax_run, dtype, start, steps):
    tol = TOLS[dtype]
    s0, actions, ref = jax_run[start]
    tdt = getattr(torch, dtype)
    tb = registry.make("HandManipulateBlock_ContinuousTouchSensorsDense-v1",
                       num_envs=B, device="cpu", dtype=tdt, reset_pool_size=POOL)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    touched = 0.0
    for a, js in zip(actions[:steps], ref):
        to, tr, tte, ttr, ti = tb.step(torch.as_tensor(a, dtype=tdt))
        for k in js["obs"]:
            assert rel_err(to[k].numpy(), js["obs"][k]) <= tol, k
        assert to["observation"].shape == (B, 61 + 92)
        assert rel_err(tr.numpy(), js["reward"]) <= tol
        np.testing.assert_array_equal(ti["is_success"].numpy(),
                                      js["info"]["is_success"])
        np.testing.assert_array_equal(tte.numpy(), js["terminated"])
        np.testing.assert_array_equal(ttr.numpy(), js["truncated"])
        np.testing.assert_array_equal(ti["diverged"].numpy(),
                                      js["info"]["diverged"])
        td, jd = tb.state.data, js["data"]
        for fld in ("qpos", "qvel", "qacc", "xpos", "sensordata", "ten_length",
                    "time"):
            got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
            ftol = QACC_TOL if fld == "qacc" and dtype == "float64" else tol
            assert rel_err(got, jd[fld]) <= ftol, fld
        touched = max(touched, float(np.abs(js["obs"]["observation"][:, 61:]).max()))
    assert touched > 0 or start == "lifted" and steps == 1  # touch reads forces


def test_carried_state_round_trips(jax_run):
    """convert.py carries a hand EnvState both ways unchanged: the pool in
    aux, the sensor readings and the static slot map included."""
    s0 = jax_run["rest"][0]
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(s0, "cpu"))
    for k in ("qpos", "qvel", "sensordata", "ten_length", "ten_J", "xpos"):
        np.testing.assert_array_equal(back["data"][k], s0["data"][k], err_msg=k)
    for k in ("dist", "frame", "geom1", "geom2"):
        np.testing.assert_array_equal(back["data"]["contact"][k],
                                      s0["data"]["contact"][k], err_msg=k)
    for k in ("pool_qpos", "pool_qvel"):
        np.testing.assert_array_equal(back["aux"][k], s0["aux"][k], err_msg=k)
        assert back["aux"][k].shape[:2] == (B, POOL)
    for k in ("goal", "steps", "reward"):
        np.testing.assert_array_equal(back[k], s0[k], err_msg=k)


def test_auto_reset_at_max_episode_steps(jax_run):
    """An env at its last step comes back reset (steps 0, time 0, one of its
    pool's poses with the target joint parked at a fresh unit-quaternion
    goal) and reports truncated; the other keeps its stepped state."""
    s0 = jax_run["rest"][0]
    tb = registry.make("HandManipulateBlock_ContinuousTouchSensorsDense-v1",
                       num_envs=B, device="cpu", dtype=torch.float64,
                       reset_pool_size=POOL)
    tb.generator = torch.Generator().manual_seed(3)
    tb.state = convert.env_state_from_numpy(s0, "cpu")
    env = tb.env
    assert env.max_episode_steps == 100
    tb.state.steps = torch.tensor([99, 5], dtype=torch.int32)
    goal0 = tb.state.goal.clone()
    _, _, terminated, truncated, info = tb.step(torch.zeros(B, 20, dtype=torch.float64))
    assert truncated.tolist() == [True, False] and not terminated.any()
    assert tb.state.steps.tolist() == [0, 6]
    d = tb.state.data
    assert d.time.tolist() == pytest.approx([0.0, 20 * 0.002])
    tq = env._target_qadr
    pool = torch.as_tensor(s0["aux"]["pool_qpos"][0])
    q = d.qpos[:, 0]
    assert any(torch.equal(q[:tq], p[:tq]) for p in pool)
    goal = tb.state.goal[0]
    assert torch.equal(q[tq:tq + 7], goal) and not torch.equal(goal, goal0[0])
    assert float(torch.linalg.vector_norm(goal[3:])) == pytest.approx(1.0)
    assert torch.equal(tb.state.goal[1], goal0[1])
    assert torch.equal(tb.state.aux["pool_qpos"], torch.as_tensor(s0["aux"]["pool_qpos"]))


def test_reward_and_success_match_jax():
    """compute_reward (sparse and dense) and the success flag over the
    position and rotation distances, for every target mode."""
    rs = np.random.RandomState(5)
    a = rs.normal(0, 1, (6, 7))
    a[:, 3:] /= np.linalg.norm(a[:, 3:], axis=1, keepdims=True)
    g = a + rs.normal(0, 0.001, (6, 7))   # three goals met within both
    g[3, :3] += 0.03                      # thresholds, one 3 cm off,
    g[4:, 3:] += rs.normal(0, 0.2, (2, 4))   # two turned away
    for pos, rot in (("random", "xyz"), ("ignore", "z"), ("ignore", "parallel")):
        for reward_type in ("sparse", "dense"):
            jenv = JBlock(target_position=pos, target_rotation=rot,
                          reward_type=reward_type, dtype=jnp.float64)
            tenv = HandManipulateBlockEnv(
                target_position=pos, target_rotation=rot,
                reward_type=reward_type, dtype=torch.float64, device="cpu")
            ref = np.asarray(jenv.compute_reward(jnp.asarray(a), jnp.asarray(g)))
            got = tenv.compute_reward(torch.tensor(a), torch.tensor(g)).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
            s_ref = np.asarray(jenv._is_success(jnp.asarray(a), jnp.asarray(g)))
            s_got = tenv._is_success(torch.tensor(a), torch.tensor(g)).numpy()
            np.testing.assert_array_equal(s_got, s_ref)
    assert s_ref[:3].all() and not s_ref[4:].any()


def test_relative_control_and_ignored_z_match_jax():
    """The action mapping relative to the joints' positions (each J1
    actuator centred on its J1 + J0 joints), and the goal distance that
    ignores the rotation about z (the Pen's), against the JAX env's."""
    rs = np.random.RandomState(4)
    jenv = JBlock(relative_control=True, ignore_z_target_rotation=True,
                  reward_type="dense", dtype=jnp.float64)
    tenv = HandManipulateBlockEnv(relative_control=True,
                                  ignore_z_target_rotation=True,
                                  reward_type="dense", dtype=torch.float64,
                                  device="cpu")
    q = np.tile(np.asarray(jenv._init_qpos), (3, 1))
    q[:, :24] += rs.uniform(-0.3, 0.3, (3, 24))
    a = rs.uniform(-1, 1, (3, 20))
    d0 = jpipe.make_data(jenv.model, dtype=jnp.float64)
    ref = jax.vmap(lambda qq, aa: jenv._apply_action(
        dataclasses.replace(d0, qpos=qq), aa))(jnp.asarray(q), jnp.asarray(a))
    d = dataclasses.replace(tenv._rest_data(3), qpos=torch.tensor(q.T.copy()))
    got = tenv._apply_action(d, torch.tensor(a))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref), rtol=0, atol=1e-12)
    g = rs.normal(0, 1, (5, 7))
    g[:, 3:] /= np.linalg.norm(g[:, 3:], axis=1, keepdims=True)
    h = g + rs.normal(0, 0.1, (5, 7))
    np.testing.assert_allclose(
        tenv.compute_reward(torch.tensor(g), torch.tensor(h)).numpy(),
        np.asarray(jenv.compute_reward(jnp.asarray(g), jnp.asarray(h))),
        rtol=0, atol=1e-12)


def test_goal_sampling_by_mode():
    """The goals each target mode draws: unit quaternions; about z only for
    "z"; one of the 24 axis-aligned rotations about z for "parallel";
    positions offset within the range only for a random target position;
    and the port's parallel rotations are the JAX package's."""
    from gymnasium_robotics_tpu.utils import rotations as jrot

    from gymnasium_robotics_tpu_torch.utils import rotations as trot

    np.testing.assert_allclose(np.stack(trot.get_parallel_rotations()),
                               np.stack(jrot.get_parallel_rotations()), atol=0)
    gen = torch.Generator().manual_seed(0)
    obj = torch.tensor([[1.0, 0.87, 0.2, 1.0, 0.0, 0.0, 0.0]] * 64,
                       dtype=torch.float64)
    for pos, rot in (("random", "xyz"), ("ignore", "z"), ("ignore", "parallel")):
        env = HandManipulateBlockEnv(target_position=pos, target_rotation=rot,
                                     dtype=torch.float64, device="cpu")
        goal = env._sample_goal(obj, gen)
        assert torch.allclose(torch.linalg.vector_norm(goal[:, 3:], dim=1),
                              torch.ones(64, dtype=torch.float64))
        off = goal[:, :3] - obj[:, :3]
        if pos == "random":
            r = env.target_position_range
            assert ((off >= r[:, 0]) & (off <= r[:, 1])).all() and off.abs().max() > 0
        else:
            assert torch.equal(off, torch.zeros_like(off))
        if rot == "z":
            assert torch.equal(goal[:, 4:6], torch.zeros(64, 2, dtype=torch.float64))
        if rot == "parallel":
            # a turn about z after an axis-aligned rotation takes the z axis
            # to +-z or into the xy plane
            ez = trot.quat2mat(goal[:, 3:])[:, 2, 2]
            near = torch.stack([(ez - v).abs() for v in (-1.0, 0.0, 1.0)]).amin(0)
            assert near.max() < 1e-12 and ez.abs().min() < 0.5 < ez.abs().max()


def test_every_block_id_makes():
    """The 52 HandManipulateBlock IDs of the JAX registry, with its
    kwargs and step limit; the other hand families raise naming their
    slice."""
    import gymnasium_robotics_tpu.envs  # noqa: F401  (registers the IDs)
    from gymnasium_robotics_tpu import registry as jreg

    ids = [i for i in registry.ids() if i.startswith("HandManipulateBlock")]
    jids = [i for i in jreg.ids() if i.startswith("HandManipulateBlock")]
    assert sorted(ids) == sorted(jids) and len(ids) == 52
    for id_ in ids:
        s, js = registry.spec(id_), jreg.spec(id_)
        assert s.kwargs == js.kwargs and s.max_episode_steps == js.max_episode_steps
    env = registry.make("HandManipulateBlockRotateZ_BooleanTouchSensors-v0",
                        device="cpu")
    assert env.max_episode_steps == 100 and env.target_rotation == "z"
    assert env.obs_dim == 61 + 92 and env.model.opt.contact_cap == 16
    gym = registry.make_gym("HandManipulateBlock_ContinuousTouchSensors-v1",
                            parity=True, device="cpu")
    assert gym.env.model.opt.soa is False      # the per-env path
    if gym.observation_space is not None:
        assert gym.observation_space["observation"].shape == (61 + 92,)
        assert gym.action_space.shape == (20,)
    for id_, brings in (("HandManipulateEgg-v1", "ellipsoid"),
                        ("HandManipulatePenRotate-v1", "capsule")):
        with pytest.raises(KeyError, match=brings):
            registry.make(id_, device="cpu")
