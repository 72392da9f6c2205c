"""HalfCheetah 2x3 through the port's multi-agent layer against the JAX
package's: MultiAgentMujocoEnv("HalfCheetah", "2x3", agent_obsk=1) under
each side's BatchedEnv on the CPU, one env step in which env 1 reaches
max_episode_steps and auto-resets (tests/_mamujoco_cases.py).

The JAX side runs in float64: its reset and env step compiled around its
batch-last substep, compiled once (tests/_mamujoco_cases.py). Held at 1e-9 with
the port in float64 and at 2e-4 with the port in float32 against the same
float64 reference: env 0 in full, env 1 on its reward, flags and info,
and as a fresh episode of the port's own draw."""

import pytest

import _port_cpu  # noqa: F401

import _mamujoco_cases as C

LIMIT = 5


@pytest.fixture(scope="module")
def run():
    s0, step, dims = C.jax_env("HalfCheetah", "2x3", LIMIT)
    s, acts = C.jax_states(s0, step, dims)
    s = C.with_steps(s, [1, LIMIT - 1])   # env 1 truncates on the step
    return C.jax_step(step, s, acts), acts


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_with_auto_reset_matches_jax(run, dtype):
    done, _ = C.check_step("HalfCheetah", "2x3", LIMIT, run[0], run[1], dtype)
    assert done.tolist() == [False, True]
