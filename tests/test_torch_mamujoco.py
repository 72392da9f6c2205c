"""MaMuJoCo's multi-agent layer in the port (gymnasium_robotics_tpu_torch.
envs.mamujoco, mamujoco_v1) against the JAX package's, on the CPU, with no
JAX compile: the JAX functions here are host code or run op by op.

- The spatial tendon stage (smooth.tendon, site to site) against
  soa.tendon on the same batch-last Data, float64, 1e-12, coincident
  sites (the 1e-10 floor) included (its spring, limit rows and the solve
  on them past the limit in tests/test_torch_mamujoco_coupled.py).
- The coupled scene: the port's XML equal to the JAX package's, its
  import_arrays bit for bit the JAX importer's in float32 and float64, and
  the committed model file bit for bit a fresh float64 import.
- For every scenario and agent_conf of the JAX tables but ManySegment's
  (which raise, naming the next slice), here Pusher's and
  CoupledHalfCheetah's (the others, by scenario, in
  test_torch_mamujoco_cheetah_ant.py, _hopper_walker_swimmer.py and
  _reacher_humanoids.py; tests/_mamujoco_obsk.py): get_parts_and_edges and
  get_joints_at_kdist (k = 0, 1, 2) equal; every agent's observation
  equal, exactly, to the JAX build_obs on the same Data (random values,
  so the clips bite); create_observation_mapping equal (or both raising
  where the single-agent obs is not covered by observation_structure);
  the action maps' round trip and the scatter equal to the JAX one; each
  steps under BatchedEnv (and InvertedPendulum, InvertedDoublePendulum as
  one agent).
- The adapter's contract: the JAX package's test_mamujoco_* cases
  (tests/test_families.py) run on the port, and truncation, the emptied
  agents, render, env() with and without pettingzoo, and the per-env
  route (InvertedPendulum's closed-form nv = 2 Newton)."""

import json
import os
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _jax_ref as R
import _mamujoco_obsk as O
from gymnasium_robotics_tpu.envs.mamujoco import coupled_half_cheetah as JCH
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu.physics import types as JT
from gymnasium_robotics_tpu_torch import mamujoco_v1
from gymnasium_robotics_tpu_torch.envs.batched import BatchedEnv
from gymnasium_robotics_tpu_torch.envs.mamujoco import mujoco_multi as MA
from gymnasium_robotics_tpu_torch.envs.mamujoco import obsk
from gymnasium_robotics_tpu_torch.mjcf import build_locomotion as BL
from gymnasium_robotics_tpu_torch.mjcf import import_mjcf, serialize
from gymnasium_robotics_tpu_torch.physics import pipeline, smooth
from gymnasium_robotics_tpu_torch.physics import types as T

B = O.B


def test_tendon_stage_matches_jax():
    """smooth.tendon on the coupled scene against soa.tendon, float64: the
    same kinematics in, ten_length, ten_J and ten_velocity within 1e-12;
    env 3's sites made coincident (the length's 1e-10 floor)."""
    env = MA.MultiAgentMujocoEnv("CoupledHalfCheetah", "1p1", device="cpu",
                                 dtype=torch.float64).env
    m = env.model
    rs = np.random.RandomState(0)
    n = 4
    q = m.qpos0[:, 0].numpy()[:, None] + rs.uniform(-0.5, 0.5, (m.meta.nq, n))
    q[9] += rs.uniform(-3, 3, n)          # cheetah 1 ahead or behind
    d = pipeline.make_data(m, n)
    d.qpos[:] = torch.tensor(q)
    d.qvel[:] = torch.tensor(rs.normal(size=(m.meta.nv, n)))
    d = smooth.com_pos(m, smooth.kinematics(m, d))
    sites = m.meta.wrap_objid[m.meta.tendon_adr[0]:][:2]
    d.site_xpos[sites[1], :, 3] = d.site_xpos[sites[0], :, 3]
    got = smooth.tendon(m, d)
    jenv = JCH.make_coupled_half_cheetah(dtype=jnp.float64)
    ms = soa._model_to_soa(jenv.model, None)
    ref = soa.tendon(ms, R.data_from_port(d, JT))
    for f in ("ten_length", "ten_J", "ten_velocity"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    assert float(got.ten_length[0, 3]) == 0.0
    assert float(got.ten_length[0, :3].min()) > 1.5


def test_coupled_scene_matches_jax():
    """The port's coupled XML is the JAX package's; import_arrays on it is
    the JAX importer's on the same scene bit for bit (float32 and float64);
    the committed model file is a fresh float64 import bit for bit."""
    from gymnasium_robotics_tpu.mjcf import import_mjcf as J
    from gymnasium_robotics_tpu.mjcf import serialize as JS

    xml = BL.coupled_cheetah_xml()
    assert xml == JCH.coupled_cheetah_xml()
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(xml)
    try:
        for dt in (np.float32, np.float64):
            jm = J.import_xml_path(f.name, dtype=dt)
            arrays, meta_json = import_mjcf.import_arrays(BL.mj_model(BL.COUPLED), dt)
            assert meta_json == JS._meta_to_json(jm.meta)
            for k in T.array_fields():
                ref = getattr(jm, k)
                if ref is None:
                    assert arrays[k] is None, k
                    continue
                assert arrays[k].dtype == np.asarray(ref).dtype, k
                np.testing.assert_array_equal(arrays[k], np.asarray(ref), err_msg=k)
    finally:
        os.unlink(f.name)
    path = serialize.asset_path(BL.asset_name(BL.COUPLED), serialize.OWN_ASSETS_DIR)
    with np.load(path) as z:
        assert bytes(z["__meta__"]).decode() == meta_json
        stored = {k: z[k] for k in z.files if k != "__meta__"}
    assert set(stored) == {k for k, v in arrays.items() if v is not None}
    for k, v in stored.items():
        assert v.dtype == np.float64, k
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    assert json.loads(meta_json)["tendon_kind"] == ["spatial2"]


# --- the scenarios of this file (tests/_mamujoco_obsk.py; the others in
# test_torch_mamujoco_cheetah_ant.py, _hopper_walker_swimmer.py and
# _reacher_humanoids.py)

SCENARIOS = ("Pusher", "CoupledHalfCheetah")
CASES = O.cases(SCENARIOS)


@pytest.fixture(scope="module")
def jax_inner():
    return O.jax_inner(SCENARIOS)


@pytest.mark.parametrize("scenario,conf", CASES)
def test_factorization_and_obs_match_jax(jax_inner, scenario, conf):
    O.check_factorization_and_obs(jax_inner[scenario], scenario, conf)


@pytest.mark.parametrize("scenario,conf", CASES)
def test_action_maps(jax_inner, scenario, conf):
    O.check_action_maps(jax_inner[scenario], scenario, conf)


@pytest.mark.parametrize("scenario,conf,k", [(s, c, 1) for s, c in CASES])
def test_every_scenario_steps(scenario, conf, k):
    O.check_steps(scenario, conf, k)


def test_many_segment_raises():
    for scenario in ("ManySegmentSwimmer", "ManySegmentAnt"):
        with pytest.raises(NotImplementedError, match="next slice"):
            obsk.get_parts_and_edges(scenario, "2x3")
        with pytest.raises(NotImplementedError, match="next slice"):
            MA.MultiAgentMujocoEnv(scenario, "2x3", device="cpu")


# --- the adapter's contract: tests/test_families.py's test_mamujoco_* on
# the port


def test_parallel_api():
    penv = mamujoco_v1.parallel_env(scenario="HalfCheetah", agent_conf="2x3",
                                    agent_obsk=1, device="cpu")
    obs, info = penv.reset(seed=42)
    assert set(obs) == {"agent_0", "agent_1"}
    for _ in range(3):
        acts = {a: penv.action_space(a).sample() for a in penv.agents}
        obs, rew, term, trunc, infos = penv.step(acts)
    assert obs["agent_0"].shape == (12,)
    assert rew["agent_0"] == rew["agent_1"]
    genv = penv.env
    ga = np.arange(6, dtype=np.float32)
    la = genv.map_global_action_to_local_actions(ga)
    ga2 = genv.map_local_actions_to_global_action(la)
    np.testing.assert_allclose(np.asarray(ga2), ga)
    np.testing.assert_allclose(penv.map_local_actions_to_global_action(
        penv.map_global_action_to_local_actions(ga)), ga)


def test_custom_factorization():
    names = ["bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot"]
    nodes = {n: obsk.Node(n, -6 + i, -6 + i, i) for i, n in enumerate(names)}
    factorization = {
        "partition": [(nodes["bthigh"], nodes["bshin"]),
                      (nodes["bfoot"], nodes["fthigh"]),
                      (nodes["fshin"], nodes["ffoot"])],
        "edges": [obsk.HyperEdge(("bfoot", "bshin")),
                  obsk.HyperEdge(("bshin", "bthigh")),
                  obsk.HyperEdge(("bthigh", "fthigh")),
                  obsk.HyperEdge(("fthigh", "fshin")),
                  obsk.HyperEdge(("fshin", "ffoot"))],
        "globals": [obsk.Node("root_z", 1, 1, None), obsk.Node("root_y", 2, 2, None)],
    }
    penv = mamujoco_v1.parallel_env(
        scenario="HalfCheetah", agent_conf="2x3", agent_obsk=0,
        agent_factorization=factorization, local_categories=[["qpos", "qvel"]],
        device="cpu")
    obs, info = penv.reset(seed=0)
    assert set(obs) == {"agent_0", "agent_1", "agent_2"}
    assert obs["agent_0"].shape == (8,)
    assert penv.action_space("agent_0").shape == (2,)
    acts = {a: penv.action_space(a).sample() for a in penv.agents}
    obs, rew, term, trunc, infos = penv.step(acts)
    assert rew["agent_0"] == rew["agent_2"]
    genv = penv.env
    la = genv.map_global_action_to_local_actions(np.arange(6, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(la["agent_1"]), [2.0, 3.0])
    ga = genv.map_local_actions_to_global_action(la)
    np.testing.assert_allclose(np.asarray(ga), np.arange(6, dtype=np.float32))
    penv2 = mamujoco_v1.parallel_env(
        scenario="HalfCheetah", agent_conf=None, agent_obsk=1,
        agent_factorization=factorization, local_categories=[["qpos", "qvel"]],
        device="cpu")
    obs2, _ = penv2.reset(seed=0)
    assert obs2["agent_0"].shape == (12,)


def test_coupled_half_cheetah_contract():
    penv = mamujoco_v1.parallel_env(scenario="CoupledHalfCheetah",
                                    agent_conf="1p1", agent_obsk=1, device="cpu")
    obs, info = penv.reset(seed=3)
    assert set(obs) == {"agent_0", "agent_1"}
    assert obs["agent_0"].shape == (28,)
    for _ in range(3):
        acts = {a: penv.action_space(a).sample() for a in penv.agents}
        obs, rew, term, trunc, infos = penv.step(acts)
    assert rew["agent_0"] == rew["agent_1"]
    assert not term["agent_0"]
    env = penv.env.env
    assert env.obs_dim == 40
    assert env.model.meta.tendon_kind == ("spatial2",)
    assert penv.state().shape == (36,)


def test_ctde_observation_mapping():
    env = MA.MultiAgentMujocoEnv("HalfCheetah", "2x3", agent_obsk=1,
                                 device="cpu", dtype=torch.float64)
    b = BatchedEnv(env, B)
    b.reset(seed=0)
    acts = {a: torch.rand(B, n, dtype=torch.float64) * 2 - 1
            for a, n in env.action_dims.items()}
    b.step(acts)
    s = b.state
    for e in range(B):
        state = env.env._get_obs(s.data)[e].numpy()
        local = env.map_global_state_to_local_observations(state)
        for a in env.possible_agents:
            np.testing.assert_allclose(local[a], s.obs[a][e].numpy(), atol=1e-12)
        np.testing.assert_allclose(
            env.map_local_observations_to_global_state(local), state, atol=1e-12)


def test_truncation_render_and_aec():
    """Truncated at max_episode_steps with the agents emptied; render()
    and a render_mode raise naming ROADMAP A.10; env() wraps the adapter
    for PettingZoo's AEC API and raises without pettingzoo."""
    penv = mamujoco_v1.parallel_env("Swimmer", "2x1", max_episode_steps=2,
                                    device="cpu")
    penv.reset(seed=0)
    out = penv.step({a: np.zeros(1) for a in penv.agents})
    assert not any(out[3].values()) and penv.agents == ["agent_0", "agent_1"]
    out = penv.step({a: np.zeros(1) for a in penv.agents})
    assert all(out[3].values()) and not any(out[2].values())
    assert penv.agents == []
    with pytest.raises(NotImplementedError, match="A.10"):
        penv.render()
    with pytest.raises(NotImplementedError, match="A.10"):
        mamujoco_v1.parallel_env("Swimmer", "2x1", render_mode="rgb_array",
                                 device="cpu")
    aec = mamujoco_v1.env(scenario="Swimmer", agent_conf="2x1", device="cpu")
    aec.reset(seed=0)
    assert aec.agent_selection == "agent_0"
    saved = {k: v for k, v in sys.modules.items() if k.startswith("pettingzoo")}
    try:
        for k in saved:
            sys.modules[k] = None
        sys.modules["pettingzoo"] = None
        with pytest.raises(ImportError):
            mamujoco_v1.env(scenario="Swimmer", agent_conf="2x1", device="cpu")
    finally:
        sys.modules.pop("pettingzoo", None)
        sys.modules.update(saved)


def test_single_agent_per_env_route(monkeypatch):
    """agent_obsk=None is one agent with the inner env's observation; the
    adapter runs the per-env path: InvertedPendulum (nv = 2) takes the
    closed-form Newton (solve_newton_nv2, the TPU kernel B6's port), once a
    forward (RK4: four forwards a substep)."""
    from gymnasium_robotics_tpu_torch.physics import solver

    calls = []
    plain = solver.solve_newton_nv2
    monkeypatch.setattr(solver, "solve_newton_nv2",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    penv = mamujoco_v1.parallel_env("InvertedPendulum", None, agent_obsk=None,
                                    device="cpu")
    obs, _ = penv.reset(seed=0)
    assert list(obs) == ["agent_0"] and obs["agent_0"].shape == (4,)
    assert penv.env.env.model.meta.opt.soa is False
    obs, rew, *_ = penv.step({"agent_0": np.zeros(1)})
    la = penv.map_global_action_to_local_actions(np.ones(1, np.float32))
    np.testing.assert_array_equal(la["agent_0"], [1.0])
    np.testing.assert_array_equal(penv.map_local_actions_to_global_action(la), [1.0])
    inner = penv.env.env
    rk4 = inner.model.meta.opt.integrator == 1
    assert len(calls) == inner.cfg.frame_skip * (4 if rk4 else 1)
    assert rew["agent_0"] == 1.0
