"""What the Adroit step tests (tests/test_torch_adroit_{door,hammer,pen,
relocate}.py) share: the JAX env of a task in float64 on its batch-last
path (soa="force"; on the CPU its Newton takes the XLA route), its batched
step (auto-reset included) compiled once, at XLA's lowest backend
optimisation level, the states both packages step from, and the port's
step from the same state.

States, B = 2 envs each, scenes drawn with the port's parity sampler from
numpy seeds:
- "resting": the hand at its initial pose, at rest;
- "pressed": the fingers bent at random within their ranges and the task's
  object (the door's handle, the hammer, the pen, the ball) moved into the
  palm, 3 cm at most from the grasp site, so that fingers press into it;
  the door's hinge and latch at random angles; the hand moving (qvel
  normal, 0.1).
- "reset": the resting state with env 0 at its last step (steps =
  limit - 1), so that the step ends its episode and auto-resets it, and
  env 1 mid-episode. Every reset draws the same fixed scene (FRESH, the
  parity sampler's draws) in both packages, so the fresh env is held like
  the others, and the port's reset_with_values from those draws is held
  to it.

Relative error scaled by max(1, |ref|)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import torch

import _jax_ref as R
from gymnasium_robotics_tpu.envs.adroit import adroit as JA
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu_torch import convert, registry
from gymnasium_robotics_tpu_torch.physics import pipeline
from gymnasium_robotics_tpu_torch.utils import parity

B = 2
LIMIT = 200
TOLS = {"float32": 2e-4, "float64": 1e-9}
BIG = 1e9
JAX_CLASSES = {"door": JA.AdroitHandDoorEnv, "hammer": JA.AdroitHandHammerEnv,
               "pen": JA.AdroitHandPenEnv, "relocate": JA.AdroitHandRelocateEnv}
IDS = {"door": "AdroitHandDoor-v1", "hammer": "AdroitHandHammer-v1",
       "pen": "AdroitHandPen-v1", "relocate": "AdroitHandRelocate-v1"}
# the pressed state's seed: door's keeps fingers in the handle through
# its step
PRESS_SEED = {"door": 14, "hammer": 11, "pen": 11, "relocate": 11}
# the scene every auto-reset draws in these tests: the parity sampler's
# draws from seed 7
FRESH = {task: {k: np.asarray(v) for k, v in parity._adroit_values(
    types.SimpleNamespace(task=task), np.random.default_rng(7)).items()}
    for task in IDS}


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if x.size == 0:
        return 0.0
    return float(np.nanmax(np.abs(x - ref)) / max(1.0, np.nanmax(np.abs(ref))))


def port_env(task, dtype=torch.float64, num_envs=B):
    """The port's BatchedEnv of the task on the CPU, its resets drawing
    FRESH."""
    tb = registry.make(IDS[task], num_envs=num_envs, device="cpu", dtype=dtype)
    fresh = FRESH[task]
    tb.env._sample_aux = lambda n, gen: {
        k: tb.env._t(v).expand(n, *np.shape(v)).clone() for k, v in fresh.items()}
    tb.generator = torch.Generator().manual_seed(0)
    return tb


def pressed(env, n, seed):
    """(qpos (n, nq), aux) of the pressed state, from the port's float64
    kinematics: the fingers (and the door's hinge and latch) at random
    angles in their ranges, the scene drawn, then the object moved (three
    rounds along its slide joints' world axes; the door by its position)
    until it sits at the grasp site plus a random offset of up to 3 cm."""
    rs = np.random.RandomState(seed)
    mt, m = env.model.meta, env.model
    lo, hi = (m.jnt_range[:, i, 0].numpy() for i in (0, 1))
    q = np.tile(env._init_qpos.numpy(), (n, 1))
    for j, name in enumerate(mt.joint_names):
        if name[:2] in ("FF", "MF", "RF", "LF", "TH") or name in (
                "door_hinge", "latch"):
            q[:, mt.jnt_qposadr[j]] = rs.uniform(lo[j], hi[j], n)
    aux = scenes(env, n, seed)
    data = dataclasses.replace(pipeline.make_data(m, n),
                               qpos=torch.tensor(q.T).contiguous())
    site = env._eps_ball if env.task == "pen" else env._grasp_site
    off = torch.tensor(rs.uniform(-0.03, 0.03, (3, n)))
    for _ in range(3):
        d = pipeline.refresh_kin(env._model_for(aux), data)
        target = d.site_xpos[site] + off
        if env.task == "door":
            aux["door_body_pos"] = aux["door_body_pos"] + (
                target - d.site_xpos[env._handle_site]).T
            continue
        err = target - d.xpos[env._obj_body]
        for name in ("OBJTx", "OBJTy", "OBJTz"):
            j = mt.joint_names.index(name)
            data.qpos[mt.jnt_qposadr[j]] += (d.xaxis[j] * err).sum(0)
    return data.qpos.T.numpy(), {k: v.numpy() for k, v in aux.items()}


def scenes(env, n, seed):
    """n scenes of the task, drawn by the parity sampler from numpy seeds."""
    draws = [parity.sample_reset_values(env, np.random.default_rng(seed + i))
             for i in range(n)]
    return {k: torch.tensor(np.stack([np.asarray(d[k]) for d in draws]))
            for k in draws[0]}


def jax_state_to_numpy(s):
    d = s.data
    data = {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d) if f.name != "contact"}
    c = d.contact
    data["contact"] = {n: None if getattr(c, n) is None else np.asarray(getattr(c, n))
                       for n in ("dist", "pos", "frame", "geom1", "geom2", "src")}
    return dict(
        data=data, obs=np.asarray(s.obs), reward=np.asarray(s.reward),
        terminated=np.asarray(s.terminated), truncated=np.asarray(s.truncated),
        info={k: np.asarray(v) for k, v in s.info.items()},
        goal=np.asarray(s.goal), steps=np.asarray(s.steps),
        aux={k: np.asarray(v) for k, v in s.aux.items()})


def jax_run(task):
    """The JAX BatchedEnv of ``task`` in float64 stepped once from each
    state: {state: (the carried state, the stepped state)} as numpy, and
    the action (a tenth of full range)."""
    jenv = JAX_CLASSES[task](dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = LIMIT
    fresh = {k: jnp.asarray(v) for k, v in FRESH[task].items()}
    jenv._sample_aux = lambda rng: fresh
    jb = JBatched(jenv, B)
    jb.reset(seed=0)
    tenv = port_env(task).env
    mt = tenv.model.meta
    rs = np.random.RandomState(1)
    q_press, aux_press = pressed(tenv, B, PRESS_SEED[task])
    qvel_press = rs.normal(0, 0.1, (B, mt.nv))
    rest_aux = {k: v.numpy() for k, v in scenes(tenv, B, 21).items()}
    q_rest = np.tile(tenv._init_qpos.numpy(), (B, 1))
    starts = {"resting": (q_rest, np.zeros((B, mt.nv)), rest_aux, [0, 0]),
              "pressed": (q_press, qvel_press, aux_press, [0, 0]),
              "reset": (q_rest, np.zeros((B, mt.nv)), rest_aux, [LIMIT - 1, 0])}
    action = jnp.asarray(rs.uniform(-1, 1, (B, mt.nu)) * 0.1)
    runs, step = {}, None
    for name, (q, v, aux, steps) in starts.items():
        state = dataclasses.replace(
            jb.state, data=dataclasses.replace(
                jb.state.data, qpos=jnp.asarray(q), qvel=jnp.asarray(v)),
            aux={k: jnp.asarray(x) for k, x in aux.items()},
            steps=jnp.asarray(steps, jnp.int32))
        if step is None:
            step = R.compiled_step(jb, state, action)
        runs[name] = (jax_state_to_numpy(state),
                      jax_state_to_numpy(step(state, action)))
    return runs, np.asarray(action)


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
        state, data=data, obs=cast(state.obs), reward=cast(state.reward),
        goal=cast(state.goal), info={k: cast(v) for k, v in state.info.items()},
        aux={k: cast(v) for k, v in state.aux.items()})


def port_step(task, runs, action, start, dtype):
    """The port's BatchedEnv in ``dtype`` stepped once from the state JAX
    stepped from: ((obs, reward, terminated, truncated, info), its state)."""
    tdt = getattr(torch, dtype)
    tb = port_env(task, tdt)
    tb.state = cast_state(convert.env_state_from_numpy(runs[start][0], "cpu"), tdt)
    out = tb.step(torch.tensor(action, dtype=tdt))
    return out, tb.state


def check_step(task, runs, action, start, dtype, port=None):
    """The port's step against JAX's: obs, reward, success, qpos and qvel
    within TOLS[dtype], terminated, truncated and diverged equal."""
    tol = TOLS[dtype]
    js = runs[start][1]
    (obs, reward, term, trunc, info), ts = port or port_step(
        task, runs, action, start, dtype)
    assert obs.shape == js["obs"].shape == (B, JAX_CLASSES[task].obs_dim)
    assert rel_err(obs.numpy(), js["obs"]) <= tol
    assert rel_err(reward.numpy(), js["reward"]) <= tol
    np.testing.assert_array_equal(info["success"].numpy(), js["info"]["success"])
    for name, got in (("terminated", term), ("truncated", trunc),
                      ("diverged", info["diverged"])):
        want = js[name] if name != "diverged" else js["info"]["diverged"]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for fld in ("qpos", "qvel"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, js["data"][fld]) <= tol, fld
    return ts


def check_auto_reset(task, runs, ts):
    """The step ends env 0's episode: it comes back reset, its scene FRESH,
    its qpos the initial one, its obs the fresh state's, all as JAX's;
    env 1 keeps its own scene and its stepped state."""
    js = runs["reset"][1]
    np.testing.assert_array_equal(js["truncated"], [True, False])
    np.testing.assert_array_equal(js["steps"], [0, 1])
    np.testing.assert_array_equal(ts.steps.numpy(), [0, 1])
    carried = runs["reset"][0]["aux"]
    for k, v in FRESH[task].items():
        got = ts.aux[k].numpy()
        assert rel_err(got, js["aux"][k]) <= TOLS["float64"], k
        np.testing.assert_allclose(got[0], v, rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_array_equal(got[1], carried[k][1], err_msg=k)
    q0 = runs["reset"][0]["data"]["qpos"][0]
    np.testing.assert_allclose(ts.data.qpos[:, 0].numpy(), q0, rtol=0, atol=1e-12)


def check_compact_table(runs, ts, meta):
    """The pruned compact table of the pressed step's last substep against
    JAX's: every row's distance (on its own scale; a row far from touching
    carries 1e10 on both sides), the point and the NaN-equal frame of every
    row that is not (a far row's point is a placeholder: box-box's edge
    slot keeps the best edge pair's midpoint, which a rounding-level tie
    between near-parallel finger boxes' edges picks), and the slot and geom
    ids equal; returns {kind name: whether some row of it penetrates}."""
    from gymnasium_robotics_tpu_torch.physics import collision as tcol

    jc, tc = runs["pressed"][1]["data"]["contact"], ts.data.contact
    a, b = jc["dist"], tc.dist.numpy().T
    assert b.shape == a.shape
    near = a < BIG
    np.testing.assert_array_equal(b < BIG, near)
    assert rel_err(b[near], a[near]) <= TOLS["float64"]
    for k in ("pos", "frame"):
        a, b = jc[k][near], np.moveaxis(getattr(tc, k).numpy(), -1, 0)[near]
        assert b.shape == a.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=TOLS["float64"] * max(
            1.0, np.nanmax(np.abs(a))), equal_nan=True, err_msg=k)
    for k in ("src", "geom1", "geom2"):
        np.testing.assert_array_equal(getattr(tc, k).numpy().T, jc[k], err_msg=k)
    dist = tc.dist.numpy()
    touching = {}
    for g in tcol.prune_plan(meta).groups:
        name = "-".join(tcol._TYPE_NAMES[t] for t in g.tp)
        rows = dist[g.base_c:g.base_c + g.n_slots_c]
        touching[name] = touching.get(name, False) or bool((rows < 0).any())
    return touching


def check_reset_with_values(task, runs):
    """reset_with_values from the parity sampler's draws (FRESH) gives the
    observation and qpos of JAX's reset from the same scene."""
    from gymnasium_robotics_tpu_torch import core

    js = runs["reset"][1]
    env = port_env(task).env
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = env.reset_with_values(template, {
        k: np.stack([v] * B) for k, v in FRESH[task].items()})
    assert rel_err(ts.obs[0].numpy(), js["obs"][0]) <= TOLS["float64"]
    assert rel_err(ts.data.qpos[:, 0].numpy(), js["data"]["qpos"][0]) <= TOLS["float64"]
    for k, v in FRESH[task].items():
        np.testing.assert_array_equal(ts.aux[k][1].numpy(), v, err_msg=k)
