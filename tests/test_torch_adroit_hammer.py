"""AdroitHandHammer against the JAX package: one env step of the port's
BatchedEnv against the JAX BatchedEnv's (its step compiled once, in
float64) from the resting and the pressed state, the auto-reset of an env
at its step limit, reset_with_values from the parity sampler's draws, and
the pruned compact table of the pressed step
(tests/_adroit_cases.py says how the states are made).

Tolerances (relative, scaled by max(1, |ref|)): 1e-9 for the port in
float64 from both states; 2e-4 for the port in float32 against the same
float64 reference from the resting state only. The pressed hand's 88
tendon rows and finger contacts make its float32 solve ill-conditioned
(as the HandManipulateBlock hand's, PERF.md), so no float32 path is held
to 2e-4 there. The compact table of the pressed step's last substep holds
capsule-capsule rows (fingers in the hammer's handle) that penetrate."""

import pytest
import torch

import _port_cpu  # noqa: F401

import _adroit_cases as C

TASK = "hammer"


@pytest.fixture(scope="module")
def jax_run():
    return C.jax_run(TASK)


@pytest.fixture(scope="module")
def pressed64(jax_run):
    return C.port_step(TASK, *jax_run, "pressed", "float64")


@pytest.mark.parametrize("dtype,start", [("float64", "resting"),
                                         ("float64", "pressed"),
                                         ("float32", "resting")])
def test_env_step_matches_jax(jax_run, pressed64, dtype, start):
    port = pressed64 if (dtype, start) == ("float64", "pressed") else None
    C.check_step(TASK, *jax_run, start, dtype, port)


def test_auto_reset_picks_the_scene_per_env(jax_run):
    ts = C.check_step(TASK, *jax_run, "reset", "float64")
    C.check_auto_reset(TASK, jax_run[0], ts)


def test_reset_with_values_matches_jax(jax_run):
    C.check_reset_with_values(TASK, jax_run[0])


def test_compact_table_matches_jax(jax_run, pressed64):
    meta = C.port_env(TASK).env.model.meta
    touching = C.check_compact_table(jax_run[0], pressed64[1], meta)
    assert touching["capsule-capsule"], touching
