"""MaMuJoCo's multi-agent layer in the port against the JAX package's on
the CPU, with no JAX compile, for Hopper, Walker2d and Swimmer: tests/_mamujoco_obsk.py's
checks of each agent_conf of the JAX tables (factorization, k-hop sets
and observations exactly, the observation mapping, the action maps, a
step under BatchedEnv), and InvertedPendulum and InvertedDoublePendulum stepped as one agent. The other scenarios are in
tests/test_torch_mamujoco*.py."""

import pytest

import _port_cpu  # noqa: F401

import _mamujoco_obsk as O

SCENARIOS = ('Hopper', 'Walker2d', 'Swimmer')
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


@pytest.mark.parametrize("scenario,conf,k", [(s, c, 1) for s, c in CASES] + [
    ("InvertedPendulum", None, None), ("InvertedDoublePendulum", None, None)])
def test_every_scenario_steps(scenario, conf, k):
    O.check_steps(scenario, conf, k)
