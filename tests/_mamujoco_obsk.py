"""Shared by the MaMuJoCo scenario test files (pytest does not collect
it): the JAX tables of scenarios and agent_confs, and the checks each
scenario's cases run against the JAX package on the CPU with no JAX
compile (the JAX functions here are host code or run op by op). The
cases are spread over several files by scenario: pytest-xdist's
``--dist loadfile`` starts the files with the most tests first, and a
file of more tests than the JAX suite's longest file would start ahead
of it."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_robotics_tpu.envs.mamujoco import coupled_half_cheetah as JCH
from gymnasium_robotics_tpu.envs.mamujoco import mujoco_multi as JMA
from gymnasium_robotics_tpu.envs.mamujoco import obsk as JO
from gymnasium_robotics_tpu_torch.envs.batched import BatchedEnv
from gymnasium_robotics_tpu_torch.envs.mamujoco import mujoco_multi as MA
from gymnasium_robotics_tpu_torch.envs.mamujoco import obsk
from gymnasium_robotics_tpu_torch.physics import pipeline

CONFS = {"HalfCheetah": (None, "2x3", "6x1"),
         "Ant": (None, "2x4", "2x4d", "4x2"),
         "Hopper": (None, "3x1"), "Walker2d": (None, "2x3"),
         "Swimmer": (None, "2x1"), "Reacher": (None, "2x1"),
         "Humanoid": (None, "9|8"), "HumanoidStandup": (None, "9|8"),
         "Pusher": (None, "3p"), "CoupledHalfCheetah": (None, "1p1")}
CASES = [(s, c) for s, confs in CONFS.items() for c in confs]
JAX_MAKERS = {**JMA._SCENARIO_MAKERS,
              "CoupledHalfCheetah": JCH.make_coupled_half_cheetah}
B = 2


def astuple(nodes):
    return [dataclasses.astuple(n) for n in nodes]


def random_data(model, seed):
    """A float64 batch-last Data of B envs whose observed fields hold
    random values, 5 times a normal draw (past the clips at 1 and 10)."""
    rs = np.random.RandomState(seed)
    d = pipeline.make_data(model, B)
    fields = ("qpos", "qvel", "qfrc_actuator", "cinert", "cvel", "cfrc_ext",
              "xpos", "ten_J", "ten_length", "ten_velocity")
    return dataclasses.replace(d, **{
        f: torch.tensor(rs.normal(size=getattr(d, f).shape) * 5.0)
        for f in fields})


def env_slice(d, e):
    """Env e of a batch-last Data, as the JAX obsk reads one env's Data."""
    return types.SimpleNamespace(**{
        f.name: jnp.asarray(getattr(d, f.name)[..., e].numpy())
        for f in dataclasses.fields(d) if f.name != "contact"})


def cases(scenarios):
    """(scenario, agent_conf) of each of ``scenarios``, in CONFS' order."""
    return [(s, c) for s, c in CASES if s in scenarios]


def jax_inner(scenarios):
    """The JAX package's single-agent env of each scenario (float64)."""
    return {s: JAX_MAKERS[s](dtype=jnp.float64) for s in scenarios}


def jax_self(scenario, conf, k, jenv):
    """What the JAX MultiAgentMujocoEnv's methods read of themselves, built
    without its constructor (which steps the env op by op to size the
    observation spaces)."""
    parts, edges, globals_, nodes = JO.get_parts_and_edges(scenario, conf)
    return types.SimpleNamespace(
        env=jenv, agent_obsk=k, agent_partitions=parts,
        k_dicts=[JO.get_joints_at_kdist(p, edges, k, nodes) for p in parts],
        global_nodes=globals_, local_categories=JO.local_categories_for(scenario, k),
        global_categories=("qpos", "qvel"),
        possible_agents=[f"agent_{i}" for i in range(len(parts))],
        _nu=jenv.model.meta.nu, dtype=jnp.float64)


def check_factorization_and_obs(jenv, scenario, conf):
    """Parts, edges, globals and k-hop node sets equal; every agent's
    observation at k = 0, 1, 2 exactly the JAX build_obs on the same Data;
    the observation mapping equal, or raising on both sides."""
    parts, edges, globals_, nodes = obsk.get_parts_and_edges(scenario, conf)
    jparts, jedges, jglobals, jnodes = JO.get_parts_and_edges(scenario, conf)
    assert [astuple(p) for p in parts] == [astuple(p) for p in jparts]
    assert [e.nodes for e in edges] == [e.nodes for e in jedges]
    assert astuple(globals_) == astuple(jglobals)
    assert sorted(nodes) == sorted(jnodes)
    for k in (0, 1, 2):
        env = MA.MultiAgentMujocoEnv(scenario, conf, agent_obsk=k, device="cpu",
                                     dtype=torch.float64)
        js = jax_self(scenario, conf, k, jenv)
        for kd, jkd in zip(env.k_dicts, js.k_dicts):
            assert {d: astuple(v) for d, v in kd.items()} == {
                d: astuple(v) for d, v in jkd.items()}
        d = random_data(env.env.model, k)
        obs = env._agent_obs(d)
        for e in range(B):
            ref = JMA.MultiAgentMujocoEnv._agent_obs(js, env_slice(d, e))
            assert sorted(ref) == sorted(obs)
            for a, v in ref.items():
                np.testing.assert_array_equal(obs[a][e].numpy(), np.asarray(v),
                                              err_msg=f"{a} k={k}")
        try:
            jmap = JMA.MultiAgentMujocoEnv.create_observation_mapping(js)
        except AssertionError:
            with pytest.raises(AssertionError, match="does not cover"):
                env.create_observation_mapping()
        else:
            got = env.create_observation_mapping()
            assert sorted(got) == sorted(jmap)
            for a in jmap:
                assert got[a].dtype == np.int64
                np.testing.assert_array_equal(got[a], jmap[a])


def check_action_maps(jenv, scenario, conf):
    """The scatter of the agents' actions equals the JAX one on each env's
    actions; global -> local -> global is the identity on (B, nu), local ->
    global -> local on the agents' actions."""
    env = MA.MultiAgentMujocoEnv(scenario, conf, device="cpu", dtype=torch.float64)
    js = jax_self(scenario, conf, 1, jenv)
    rs = np.random.RandomState(1)
    local = {a: torch.tensor(rs.normal(size=(B, n)))
             for a, n in env.action_dims.items()}
    ga = env.map_local_actions_to_global_action(local)
    assert ga.shape == (B, env.env.model.meta.nu)
    for e in range(B):
        ref = JMA.MultiAgentMujocoEnv.map_local_actions_to_global_action(
            js, {a: jnp.asarray(v[e].numpy()) for a, v in local.items()})
        np.testing.assert_array_equal(ga[e].numpy(), np.asarray(ref))
    back = env.map_global_action_to_local_actions(ga)
    for a, v in local.items():
        assert torch.equal(back[a], v), a
    g = torch.tensor(rs.normal(size=(B, env.env.model.meta.nu)))
    assert torch.equal(env.map_local_actions_to_global_action(
        env.map_global_action_to_local_actions(g)), g)


def check_steps(scenario, conf, k):
    """Each scenario and agent_conf under BatchedEnv on the CPU: a reset
    and one step with random actions for each agent, every observation
    finite and of its agent's width, the reward shared."""
    env = MA.MultiAgentMujocoEnv(scenario, conf, agent_obsk=k, device="cpu")
    b = BatchedEnv(env, B)
    b.reset(seed=0)
    gen = torch.Generator().manual_seed(1)
    obs, rew, term, trunc, _ = b.step({
        a: torch.rand((B, n), generator=gen) * 2 - 1
        for a, n in env.action_dims.items()})
    assert {a: tuple(v.shape) for a, v in obs.items()} == {
        a: (B, n) for a, n in env.obs_dims.items()}
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert rew.shape == term.shape == trunc.shape == (B,)
