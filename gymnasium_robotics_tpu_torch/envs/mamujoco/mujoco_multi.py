"""Multi-agent MuJoCo: a locomotion env factorized into K cooperating
agents (port of gymnasium_robotics_tpu/envs/mamujoco/mujoco_multi.py
``MultiAgentMujocoEnv`` :50-302 and ``ParallelEnvAdapter``,
``parallel_env``, ``raw_parallel_env``, ``env`` :305-439).

``MultiAgentMujocoEnv`` acts on a whole batch, as the port's envs do:
actions and observations are dicts keyed "agent_0", ... of (B, n_i)
tensors. A step scatters the agents' actions into the inner env's (B, nu)
action with one index copy, steps the inner env once, and gathers every
agent's observation of the stepped Data with one index table built at
construction (envs/mamujoco/obsk.py ``ObsGather``); the inner env's reward,
flags and info are shared by every agent. Under ``BatchedEnv`` (and so
``core.auto_reset``) it is the batched form of the per-env function the
JAX package maps with ``jax.vmap``.

``ParallelEnvAdapter`` is the PettingZoo ParallelEnv one instance (B = 1,
numpy in and out, the shared reward, truncation at ``max_episode_steps``,
``agents`` emptied at the episode's end). Like the Gymnasium adapter it
runs the per-env path (``Option.soa=False``; at nv = 2 the closed-form
Newton), and rendering is not ported (ROADMAP A.10). gymnasium is
optional: without it the spaces are None. ``env`` wraps the adapter for
PettingZoo's AEC API and needs pettingzoo.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.envs import adapters
from gymnasium_robotics_tpu_torch.envs.locomotion import classic as C
from gymnasium_robotics_tpu_torch.envs.locomotion import locomotion as L
from gymnasium_robotics_tpu_torch.envs.mamujoco import obsk
from gymnasium_robotics_tpu_torch.envs.mamujoco.coupled_half_cheetah import (
    make_coupled_half_cheetah)
from gymnasium_robotics_tpu_torch.physics import pipeline

_SCENARIO_MAKERS = {
    "HalfCheetah": L.make_half_cheetah,
    "Ant": L.make_ant,
    "Hopper": L.make_hopper,
    "Walker2d": L.make_walker2d,
    "Swimmer": L.make_swimmer,
    "Reacher": C.make_reacher,
    "Humanoid": C.make_humanoid,
    "HumanoidStandup": C.make_humanoid_standup,
    "Pusher": C.make_pusher,
    "InvertedPendulum": C.make_inverted_pendulum,
    "InvertedDoublePendulum": C.make_inverted_double_pendulum,
    "CoupledHalfCheetah": make_coupled_half_cheetah,
}

_EPISODE_STEPS = {
    "HalfCheetah": 1000, "Ant": 1000, "Hopper": 1000, "Walker2d": 1000,
    "Swimmer": 1000, "Reacher": 50, "Humanoid": 1000,
    "CoupledHalfCheetah": 1000,
    "HumanoidStandup": 1000, "Pusher": 100, "InvertedPendulum": 1000,
    "InvertedDoublePendulum": 1000,
}


def _box(low, high, shape, dtype):
    """A gymnasium Box, or None without gymnasium."""
    if adapters.gym is None:
        return None
    from gymnasium import spaces

    return spaces.Box(low, high, shape=shape, dtype=dtype)


class MultiAgentMujocoEnv:
    """Batched multi-agent env on ``device`` (the CUDA card unless named):
    actions and observations are dicts of (B, n_i) tensors keyed by agent."""

    def __init__(self, scenario: str, agent_conf: Optional[str],
                 agent_obsk: Optional[int] = 1,
                 agent_factorization: Optional[dict] = None,
                 local_categories=None, global_categories=None,
                 max_episode_steps=None, dtype=torch.float32, device=None):
        self.scenario = scenario
        self.agent_conf = agent_conf
        self.agent_obsk = agent_obsk
        self.device = dev = _device.resolve(device)
        self.dtype = dtype
        if scenario in obsk.MANY_SEGMENT:
            raise NotImplementedError(obsk.MANY_SEGMENT_LATER.format(scenario))
        if scenario not in _SCENARIO_MAKERS:
            raise NotImplementedError(f"Scenario {scenario} not available")
        self.env = _SCENARIO_MAKERS[scenario](dtype=dtype, device=dev)
        self.max_episode_steps = (
            max_episode_steps or _EPISODE_STEPS.get(scenario, 1000))
        mt = self.env.model.meta
        self.action_dim = mt.nu      # the inner env's (flat) action width

        if agent_obsk is not None:
            if agent_factorization is None:
                parts, edges, globals_, nodes = obsk.get_parts_and_edges(
                    scenario, agent_conf)
            else:
                # the user's partition, edges and globals (the reference's
                # agent_factorization={'partition','edges','globals'}), the
                # node table rebuilt from them
                parts = [tuple(p) for p in agent_factorization["partition"]]
                edges = list(agent_factorization["edges"])
                globals_ = list(agent_factorization["globals"])
                nodes = {n.label: n for p in parts for n in p}
                for g in globals_:
                    nodes.setdefault(g.label, g)
            self.agent_partitions = parts
            self.k_dicts = [obsk.get_joints_at_kdist(p, edges, agent_obsk, nodes)
                            for p in parts]
            self.global_nodes = globals_
            if local_categories is None:
                self.local_categories = obsk.local_categories_for(
                    scenario, agent_obsk)
            else:
                # per-depth category lists, the deepest entry repeated
                self.local_categories = [
                    local_categories[k if k < len(local_categories) else -1]
                    for k in range(agent_obsk + 1)]
            self.global_categories = (global_categories
                                      if global_categories is not None
                                      else ("qpos", "qvel"))
            self.possible_agents = [f"agent_{i}" for i in range(len(parts))]
            self._gather = obsk.ObsGather(
                [self._layout(k, index_only=False) for k in self.k_dicts],
                pipeline.make_data(self.env.model, 1))
            self.action_dims = {a: len(p) for a, p in
                                zip(self.possible_agents, parts)}
            self.obs_dims = dict(zip(self.possible_agents, self._gather.sizes))
            self._act_ids = torch.tensor([n.act_ids for p in parts for n in p],
                                         dtype=torch.int64, device=dev)
            self._agent_act_ids = {
                a: torch.tensor([n.act_ids for n in p], dtype=torch.int64,
                                device=dev)
                for a, p in zip(self.possible_agents, parts)}
        else:
            self.agent_partitions = None
            self.possible_agents = ["agent_0"]
            self.action_dims = {"agent_0": mt.nu}
            self.obs_dims = {"agent_0": self.env.obs_dim}

        if self.agent_partitions is None:
            obs_space, act_space = adapters._spaces(self.env)
            self.action_spaces = {"agent_0": act_space}
            self.observation_spaces = {"agent_0": obs_space}
        else:
            self.action_spaces = {a: _box(-1.0, 1.0, (n,), np.float32)
                                  for a, n in self.action_dims.items()}
            self.observation_spaces = {a: _box(-np.inf, np.inf, (n,), np.float64)
                                       for a, n in self.obs_dims.items()}
        self.action_space = self.action_spaces[self.possible_agents[0]]
        self.observation_space = self.observation_spaces[self.possible_agents[0]]

    def _layout(self, k_dict, index_only):
        mt = self.env.model.meta
        return obsk.obs_layout(k_dict, self.local_categories, self.global_nodes,
                               self.global_categories, mt.nq, mt.nv, index_only)

    def _agent_obs(self, data) -> Dict[str, torch.Tensor]:
        if self.agent_partitions is None:
            return {"agent_0": self.env._get_obs(data)}
        return dict(zip(self.possible_agents, self._gather(data)))

    def map_local_actions_to_global_action(self, actions):
        """The agents' actions, (B, n_i) or (n_i,) each, scattered into the
        inner env's (B, nu) or (nu,) action by one index copy; actuators no
        agent drives get 0."""
        if self.agent_partitions is None:
            return torch.as_tensor(actions[self.possible_agents[0]],
                                   dtype=self.dtype, device=self.device)
        a = torch.cat([torch.as_tensor(actions[agent], dtype=self.dtype,
                                       device=self.device)
                       for agent in self.possible_agents], dim=-1)
        out = a.new_zeros(a.shape[:-1] + (self.action_dim,))
        return out.index_copy_(a.dim() - 1, self._act_ids, a)

    def map_global_action_to_local_actions(self, action):
        """The inverse: each agent's columns of the (B, nu) or (nu,) action."""
        action = torch.as_tensor(action, device=self.device)
        if self.agent_partitions is None:
            return {self.possible_agents[0]: action}
        return {agent: action[..., ids] for agent, ids in self._agent_act_ids.items()}

    # --- the CTDE state <-> local observation mapping: the gather layout
    # replayed over a Data whose fields hold the single-agent observation's
    # indices, so it is exact for scenarios whose agents' observations are
    # pure gathers of the single-agent one

    @property
    def single_agent_env(self):
        return self.env

    @functools.cached_property
    def observation_factorization(self):
        return self.create_observation_mapping()

    def create_observation_mapping(self) -> Optional[Dict[str, np.ndarray]]:
        """{agent: the single-agent observation's indices of its
        observation} (int64), read off the inner env's
        ``observation_structure``; None without one."""
        obs_dim = self.env.obs_dim
        if self.agent_obsk is None:
            return {self.possible_agents[0]: np.arange(obs_dim)}
        struct = getattr(self.env, "observation_structure", None)
        if struct is None:
            return None
        nb = self.env.model.meta.nbody
        gi = np.arange(obs_dim, dtype=np.float64)
        seg, off = {}, 0
        for key in ("qpos", "qvel", "cinert", "cvel", "qfrc_actuator",
                    "cfrc_ext"):
            n = struct.get(key, 0)
            seg[key] = gi[off:off + n]
            off += n
        assert off == obs_dim, "observation_structure does not cover the obs"

        def pad(name, prefix, rows=None):
            x = np.concatenate([np.zeros(prefix), seg[name]])
            if rows and len(x) > prefix:
                x = x.reshape(nb, rows)
            return torch.tensor(x)[..., None]       # batch-last, B = 1

        fake = dataclasses.make_dataclass("IndexData", [
            "qpos", "qvel", "cinert", "cvel", "qfrc_actuator", "cfrc_ext"])(
            qpos=pad("qpos", struct.get("skipped_qpos", 0)),
            qvel=torch.tensor(seg["qvel"])[:, None],
            cinert=pad("cinert", 10, 10 if struct.get("cinert") else None),
            cvel=pad("cvel", 6, 6 if struct.get("cvel") else None),
            qfrc_actuator=pad("qfrc_actuator", 6),
            cfrc_ext=pad("cfrc_ext", 6, 6 if struct.get("cfrc_ext") else None))
        layouts = [self._layout(k, index_only=True) for k in self.k_dicts]
        idx = obsk.ObsGather(layouts, fake)(fake)
        return {agent: np.asarray(i[0]).round().astype(np.int64)
                for agent, i in zip(self.possible_agents, idx)}

    def map_global_state_to_local_observations(self, global_state):
        """Each agent's observation gathered out of the single-agent
        observation vector (numpy)."""
        fact = self.observation_factorization
        assert fact is not None, (
            "state mapping requires the inner env to expose "
            "observation_structure")
        global_state = np.asarray(global_state)
        out = {a: global_state[idx] for a, idx in fact.items()}
        for agent in self.possible_agents:
            assert len(out[agent]) == self.obs_dims[agent]
        return out

    def map_local_observations_to_global_state(self, local_observation):
        """The agents' observations scattered back into the single-agent
        observation vector (numpy), checking that they agree."""
        fact = self.observation_factorization
        assert fact is not None, (
            "state mapping requires the inner env to expose "
            "observation_structure")
        global_obs = np.full(self.env.obs_dim, np.nan)
        for agent, idx in fact.items():
            vals = np.asarray(local_observation[agent])
            for local_i, global_i in enumerate(idx):
                prev = global_obs[global_i]
                assert np.isnan(prev) or prev == vals[local_i], (
                    "FATAL: at least one observation is doubly defined")
                global_obs[global_i] = vals[local_i]
        assert not np.isnan(global_obs).any(), (
            "FATAL: at least one observation is undefined; observations can "
            "not be mapped")
        return global_obs

    # --- the batched env API: obs is the dict of the agents' observations
    def _with_obs(self, state: core.EnvState) -> core.EnvState:
        return dataclasses.replace(state, obs=self._agent_obs(state.data))

    def initial(self, num_envs: int, generator) -> core.EnvState:
        return self._with_obs(self.env.initial(num_envs, generator))

    def reset(self, state: core.EnvState, generator) -> core.EnvState:
        return self._with_obs(self.env.reset(state, generator))

    def reset_with_values(self, state: core.EnvState, values) -> core.EnvState:
        """A reset to the given ``qpos`` (B, nq) and ``qvel`` (B, nv)."""
        return self._with_obs(self.env.reset_with_values(state, values))

    def step(self, state: core.EnvState, actions, generator=None) -> core.EnvState:
        global_action = self.map_local_actions_to_global_action(actions)
        return self._with_obs(self.env.step(state, global_action, generator))


class ParallelEnvAdapter:
    """PettingZoo ParallelEnv API over one instance (numpy in and out, the
    shared reward)."""

    metadata = {"render_modes": [], "name": "mamujoco_tpu"}

    def __init__(self, env: MultiAgentMujocoEnv, render_mode=None):
        if render_mode is not None:
            raise NotImplementedError(
                f"render_mode={render_mode!r}: rendering (render/) is not "
                "ported yet (ROADMAP A.10)")
        env.env.model = env.env.model.with_options(soa=False)
        self.env = env
        self.possible_agents = list(env.possible_agents)
        self.agents = []
        self.render_mode = None
        self._state = None
        self._steps = 0
        self._gen = torch.Generator(device=env.device)

    def action_space(self, agent):
        return self.env.action_spaces[agent]

    def observation_space(self, agent):
        return self.env.observation_spaces[agent]

    def _obs(self):
        return {k: v[0].detach().cpu().numpy().astype(adapters.OBS_DTYPE)
                for k, v in self._state.obs.items()}

    def reset(self, seed=None, options=None):
        self._gen.manual_seed(0 if seed is None else seed)
        self._state = self.env.initial(1, self._gen)
        self.agents = list(self.possible_agents)
        self._steps = 0
        return self._obs(), {a: {} for a in self.agents}

    def step(self, actions):
        acts = {k: torch.as_tensor(np.asarray(v, np.float64), dtype=self.env.dtype,
                                   device=self.env.device).reshape(1, -1)
                for k, v in actions.items()}
        self._state = s = self.env.step(self._state, acts, self._gen)
        self._steps += 1
        term = bool(s.terminated[0])
        trunc = self._steps >= self.env.max_episode_steps
        rewards = {a: float(s.reward[0]) for a in self.agents}
        terms = {a: term for a in self.agents}
        truncs = {a: trunc for a in self.agents}
        infos = {a: {} for a in self.agents}
        if term or trunc:
            self.agents = []
        return self._obs(), rewards, terms, truncs, infos

    def render(self):
        raise NotImplementedError(
            "render(): rendering (render/) is not ported yet (ROADMAP A.10)")

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self

    def state(self):
        d = self._state.data
        return torch.cat([d.qpos[:, 0], d.qvel[:, 0]]).detach().cpu().numpy()

    # the CTDE mappings, numpy in and out
    def map_local_actions_to_global_action(self, actions):
        return self.env.map_local_actions_to_global_action(
            {k: np.asarray(v) for k, v in actions.items()}).cpu().numpy()

    def map_global_action_to_local_actions(self, action):
        return {k: v.cpu().numpy() for k, v in
                self.env.map_global_action_to_local_actions(
                    np.asarray(action)).items()}

    def map_global_state_to_local_observations(self, global_state):
        return self.env.map_global_state_to_local_observations(global_state)

    def map_local_observations_to_global_state(self, local_observation):
        return self.env.map_local_observations_to_global_state(local_observation)

    def create_observation_mapping(self):
        return self.env.create_observation_mapping()


def parallel_env(scenario=None, agent_conf=None, agent_obsk=1, render_mode=None,
                 **kwargs):
    return ParallelEnvAdapter(
        MultiAgentMujocoEnv(scenario, agent_conf, agent_obsk, **kwargs),
        render_mode=render_mode)


raw_parallel_env = parallel_env


def env(**kwargs):
    """The AEC-wrapped variant (needs pettingzoo)."""
    import pettingzoo.utils.conversions as conv

    return conv.parallel_to_aec(parallel_env(**kwargs))
