"""Shared by the locomotion test files (pytest does not collect it): the
JAX package's batched locomotion envs in float64, their env steps compiled
as one function for every model of a file, and the port's step from the
same state held to them.

States, per model, B = 2 envs: "moving", the JAX reset's state after
WARM steps of random actions (legs on the floor where the model has
contacts), and "falling" for a hopper: "moving" with env 1 tilted past
the healthy angle, so that it terminates and auto-resets on the step.
The JAX side compiles a file's envs' resets and env layers as one
function, and each model's substep apart, called back from it.

One env step of the port's BatchedEnv (auto-reset and all) against the
JAX BatchedEnv's from the same state with the same action: obs, reward,
terminated, truncated, every info key and qpos, qvel, qacc, xpos and
cfrc_ext; envs that reset on the step are compared on reward, flags and
info only (each side draws its own reset), and the port's is checked to be
a fresh episode. Relative error scaled by max(1, |ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _jax_ref as R
from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu_torch import convert, registry

B = 2
WARM = 3
TOLS = {"float32": 2e-4, "float64": 1e-9}
# the reset of an unbatched JAX Data takes its per-env kinematics
# (tests/test_torch_hand_reach.py): positions held at this tolerance
RESET_TOL = 1e-9


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if x.size == 0 and ref.size == 0:
        return 0.0
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def cast_state(state, dtype):
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x.to(dtype) if x.is_floating_point() else x

    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))
    return dataclasses.replace(state, data=data, obs=cast(state.obs),
                               reward=cast(state.reward), goal=cast(state.goal),
                               info=cast(state.info))


def _tilt(jenv, s):
    """The state with env 1 tilted 0.5 rad about y (past the hopper's
    healthy angle of 0.2)."""
    qpos = np.asarray(s.data.qpos).copy()
    qpos[1, 2] = 0.5
    return dataclasses.replace(s, data=dataclasses.replace(
        s.data, qpos=jnp.asarray(qpos)))


def _stand_in(shapes, key):
    """Arrays of ``shapes`` (ShapeDtypeStructs): zeros, and keys split
    from ``key`` where the leaf holds PRNG keys."""
    def leaf(s):
        if jax.dtypes.issubdtype(s.dtype, jax.dtypes.prng_key):
            return jax.random.split(key, s.shape)
        return jnp.zeros(s.shape, s.dtype)

    return jax.tree_util.tree_map(leaf, shapes)


def jax_runs(ids, falling=(), env_step_only=()):
    """({(id, state name): (the state, the action, the stepped state)} as
    numpy, {id: the JAX BatchedEnv}) for each id's float64 JAX BatchedEnv,
    each keeping its reset's state as numpy (``reset_numpy``, check_reset's
    reference) and its model's compiled substep (``jb.substep(ds)`` on B
    envs' batch-last Data): every id's reset (seed 1) and env step
    compiled as one function (its resets part recomputed, unused, at each
    step) around the models' substeps, compiled apart and called back
    (tests/_jax_ref.py SubstepCallbacks). The ids of ``env_step_only``
    step through the env's own step, vmapped, without the BatchedEnv's
    auto-reset (whose pick their reset's info cannot pass)."""
    jbs = {}
    for id_ in ids:
        jenv = jreg.make(id_, dtype=jnp.float64)
        jenv.model = jenv.model.with_options(soa="force")
        jbs[id_] = JBatched(jenv, B)
    key = jax.random.key(1)

    def initial(k, id_):
        s = jbs[id_]._init(k)
        if id_ in env_step_only:   # the info of the env's step
            s = dataclasses.replace(s, info=jax.vmap(jbs[id_].env._zero_info)(s.data))
        return s

    fns = {k: jax.vmap(jb.env.step) if k in env_step_only else jb._step_fn
           for k, jb in jbs.items()}
    S = {k: jax.eval_shape(lambda k_, i=k: initial(k_, i), key) for k in jbs}
    A = {k: jax.ShapeDtypeStruct((B, jb.env.model.nu), jnp.float64)
         for k, jb in jbs.items()}
    sub = R.SubstepCallbacks()
    with sub.traced():
        compiled = jax.jit(lambda k, S, A: (
            {i: (jbs[i]._init(k), initial(k, i)) for i in S},
            {i: fns[i](S[i], A[i]) for i in S})).lower(key, S, A).compile(
                R.FAST_COMPILE)
    A0 = _stand_in(A, key)
    resets = compiled(key, _stand_in(S, key), A0)[0]
    states = {k: s for k, (_, s) in resets.items()}
    for k, jb in jbs.items():
        jb.reset_numpy = R.state_to_numpy(resets[k][0])
        jb.substep = lambda ds, m=jb.env.model: sub.run(
            soa._model_to_soa(m, None), ds)

    def step(S, A):
        out = compiled(key, {**states, **S}, {**A0, **A})[1]
        return {k: out[k] for k in S}

    rs = np.random.RandomState(7)
    actions = {id_: [jnp.asarray(rs.uniform(-1, 1, (B, jb.env.model.nu)))
                     for _ in range(WARM + 1)] for id_, jb in jbs.items()}
    for i in range(WARM):
        states = step(states, {k: a[i] for k, a in actions.items()})
    A = {k: actions[k][WARM] for k in states}
    runs = {}
    for name, S in (("moving", states),
                    ("falling", {k: _tilt(jbs[k].env, states[k]) for k in falling})):
        out = step(S, {k: A[k] for k in S})
        for k in S:
            runs[(k, name)] = (R.state_to_numpy(S[k]), np.asarray(A[k]),
                               R.state_to_numpy(out[k]))
    return runs, jbs


def port_step(id_, s0, action, dtype):
    """The port's BatchedEnv (CPU, ``dtype``) set to the numpy state
    ``s0`` and stepped once: (the batched env, its step's outputs)."""
    tdt = getattr(torch, dtype)
    tb = registry.make(id_, num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    return tb, tb.step(torch.as_tensor(action, dtype=tdt))


def check_step(id_, run, dtype):
    """The port's step against the JAX step ``run`` (state, action,
    stepped) at TOLS[dtype]; returns the envs that reset on the step."""
    tol = TOLS[dtype]
    s0, action, js = run
    tb, (to, tr, tte, ttr, ti) = port_step(id_, s0, action, dtype)
    np.testing.assert_array_equal(tte.numpy(), js["terminated"])
    np.testing.assert_array_equal(ttr.numpy(), js["truncated"])
    assert rel_err(tr.numpy(), js["reward"]) <= tol, "reward"
    if "diverged" not in js["info"]:   # an env_step_only step
        assert not ti.pop("diverged", torch.zeros(1, dtype=bool)).any()
    assert sorted(ti) == sorted(js["info"]), (sorted(ti), sorted(js["info"]))
    for k, v in js["info"].items():
        if v.dtype == bool:
            np.testing.assert_array_equal(ti[k].numpy(), v, err_msg=k)
        else:
            assert rel_err(ti[k].numpy(), v) <= tol, k
    done = js["terminated"] | js["truncated"]
    keep = ~done
    assert to.shape == js["obs"].shape
    assert rel_err(to.numpy()[keep], js["obs"][keep]) <= tol, "obs"
    td, jd = tb.state.data, js["data"]
    for fld in ("qpos", "qvel", "qacc", "xpos", "cfrc_ext", "time"):
        got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
        assert rel_err(got[keep], jd[fld][keep]) <= tol, fld
    if done.any():   # a fresh episode from the port's own draw
        st = tb.state
        assert (st.steps.numpy()[done] == 0).all()
        fresh = tb.env._get_obs(st.data)
        np.testing.assert_array_equal(st.obs.numpy()[done], fresh.numpy()[done])
        q0 = tb.env.model.qpos0[:, 0].numpy()
        s = tb.env.cfg.reset_noise_scale
        dq = np.abs(st.data.qpos.numpy().T[done] - q0)
        assert (dq <= s * (1 + 1e-6)).all()
    return done


def check_reset(id_, jb):
    """reset_with_values of the JAX reset's qpos and qvel against the JAX
    reset's state (jax_runs' ``jb.reset_numpy``): the observation, info and
    the refreshed kinematics."""
    ref = jb.reset_numpy
    qpos, qvel = ref["data"]["qpos"], ref["data"]["qvel"]
    env = registry.make(id_, device="cpu", dtype=torch.float64)
    template = env.initial(B, torch.Generator().manual_seed(0))
    ts = env.reset_with_values(template, {"qpos": qpos, "qvel": qvel})
    assert rel_err(ts.obs.numpy(), ref["obs"]) <= RESET_TOL
    info = {k: v for k, v in ref["info"].items() if k != "diverged"}
    if id_ == "Pusher-v2":   # the JAX reset's info is the v5 Pusher's
        info.pop("reward_near")
    assert sorted(ts.info) == sorted(info)
    for k, v in info.items():
        assert rel_err(ts.info[k].numpy(), v) <= RESET_TOL, k
    for fld in ("qpos", "qvel", "xpos", "xipos", "site_xpos", "geom_xpos"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= RESET_TOL, fld
    np.testing.assert_array_equal(ts.steps.numpy(), 0)
