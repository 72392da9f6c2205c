"""The port stands alone: no module of gymnasium_robotics_tpu_torch's
physics/, env base modules and mazes imports jax or the JAX package
(tests/_port_imports.py; the other files in tests/test_torch_imports.py
and _envs.py)."""

import pytest

import _port_cpu  # noqa: F401

import _port_imports as P


@pytest.mark.parametrize("path", P.files("physics"), ids=P.case_id)
def test_no_jax_import(path):
    P.check_no_jax_import(path)
