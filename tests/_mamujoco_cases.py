"""Shared by the MaMuJoCo env-step test files (pytest does not collect
it): the JAX package's MultiAgentMujocoEnv under its BatchedEnv in float64
(batch-last physics, soa="force"), its reset and env step compiled around
its model's substep, compiled once (tests/_jax_ref.py), and the port's
BatchedEnv
over its MultiAgentMujocoEnv stepped once from the same state with the
same actions.

Compared: terminated, truncated, the shared reward and every info key in
every env; each agent's observation and qpos, qvel, qacc, xpos, the
tendon's length, Jacobian and velocity and the time in the envs that do
not reset on the step; an env that resets is checked to be a fresh
episode of the port's own draw (each side draws its own reset). Relative
error scaled by max(1, |ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _jax_ref as R
import _loco_cases as L
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.mamujoco import mujoco_multi as JMA
from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.envs.batched import BatchedEnv
from gymnasium_robotics_tpu_torch.envs.mamujoco import mujoco_multi as MA

B = 2
WARM = 2
FIELDS = ("qpos", "qvel", "qacc", "xpos", "ten_length", "ten_J", "time")


def _probe_shapes(self):
    """The JAX MultiAgentMujocoEnv's probe of its agents' observation
    widths (for its spaces), by shape only: its constructor would step the
    env op by op."""
    return jax.eval_shape(
        lambda: self._agent_obs(self.env.initial(jax.random.key(0)).data))


def jax_env(scenario, conf, limit, seed=1):
    """(the JAX BatchedEnv's reset (seed), its env step compiled, the
    action widths by agent): the reset and the env layer compiled as one
    function around the model's substep, compiled apart and called back
    (tests/_jax_ref.py SubstepCallbacks)."""
    probe = JMA.MultiAgentMujocoEnv._probe_obs
    JMA.MultiAgentMujocoEnv._probe_obs = _probe_shapes
    try:
        env = JMA.MultiAgentMujocoEnv(scenario, conf, agent_obsk=1,
                                      max_episode_steps=limit, dtype=jnp.float64)
    finally:
        JMA.MultiAgentMujocoEnv._probe_obs = probe
    env.env.model = env.env.model.with_options(soa="force")
    dims = {a: env.action_spaces[a].shape[0] for a in env.possible_agents}
    jb = JBatched(env, B)
    key = jax.random.key(seed)
    S = jax.eval_shape(jb._init, key)
    A = {a: jax.ShapeDtypeStruct((B, n), jnp.float64) for a, n in dims.items()}
    sub = R.SubstepCallbacks()
    with sub.traced():
        compiled = jax.jit(lambda k, S, A: (jb._init(k), jb._step_fn(S, A))).lower(
            key, S, A).compile(R.FAST_COMPILE)
    A0 = L._stand_in(A, key)
    s0 = compiled(key, L._stand_in(S, key), A0)[0]
    return s0, lambda s, a: compiled(key, s, a)[1], dims


def actions(dims, rs):
    return {a: jnp.asarray(rs.uniform(-1, 1, (B, n))) for a, n in dims.items()}


def jax_states(s, step, dims, seed=1):
    """The state after WARM steps of random actions from s, and the action
    of the step to compare."""
    rs = np.random.RandomState(seed)
    for _ in range(WARM):
        s = step(s, actions(dims, rs))
    return s, actions(dims, rs)


def jax_step(step, s, acts):
    """One JAX step of state s: (the state, the stepped state) as numpy."""
    return R.state_to_numpy(s), R.state_to_numpy(step(s, acts))


def check_step(scenario, conf, limit, run, acts, dtype):
    """The port's step from the JAX run's first state against its second,
    at L.TOLS[dtype]; returns (the envs that reset, the port's batched
    env)."""
    tol = L.TOLS[dtype]
    tdt = getattr(torch, dtype)
    s0, js = run
    env = MA.MultiAgentMujocoEnv(scenario, conf, max_episode_steps=limit,
                                 device="cpu", dtype=tdt)
    tb = BatchedEnv(env, B)
    tb.reset(seed=0)
    tb.state = L.cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    obs, rew, term, trunc, info = tb.step(
        {a: torch.as_tensor(np.asarray(v), dtype=tdt) for a, v in acts.items()})
    np.testing.assert_array_equal(term.numpy(), js["terminated"])
    np.testing.assert_array_equal(trunc.numpy(), js["truncated"])
    assert L.rel_err(rew.numpy(), js["reward"]) <= tol, "reward"
    assert sorted(info) == sorted(js["info"])
    for k, v in js["info"].items():
        if v.dtype == bool:
            np.testing.assert_array_equal(info[k].numpy(), v, err_msg=k)
        else:
            assert L.rel_err(info[k].numpy(), v) <= tol, k
    done = js["terminated"] | js["truncated"]
    keep = ~done
    assert sorted(obs) == sorted(js["obs"])
    for a, v in js["obs"].items():
        assert obs[a].shape == v.shape, a
        assert L.rel_err(obs[a].numpy()[keep], v[keep]) <= tol, a
    td, jd = tb.state.data, js["data"]
    for fld in FIELDS:
        got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
        assert L.rel_err(got[keep], jd[fld][keep]) <= tol, fld
    if done.any():   # a fresh episode from the port's own draw
        st = tb.state
        assert (st.steps.numpy()[done] == 0).all()
        fresh = env._agent_obs(st.data)
        for a in obs:
            np.testing.assert_array_equal(st.obs[a].numpy()[done],
                                          fresh[a].numpy()[done])
        q0 = env.env.model.qpos0[:, 0].numpy()
        dq = np.abs(st.data.qpos.numpy().T[done] - q0)
        assert (dq <= env.env.cfg.reset_noise_scale * (1 + 1e-6)).all()
    return done, tb


def with_steps(s, steps):
    return dataclasses.replace(s, steps=jnp.asarray(steps, s.steps.dtype))
