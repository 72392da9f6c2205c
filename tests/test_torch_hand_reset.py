"""The HandManipulateBlock parity reset at B = 1: the host draws of the
port's sampler (utils/parity.py) against the JAX package's from one seed,
and the port's reset_with_values (the block placed, settled over 10 x 20
substeps with zero action, the goal offset from the settled position, the
target parked) against the JAX env's, compiled once, in float64. Over the
settle's 200 substeps of contact the two sides' rounding differences grow
(7.1e-08 measured at this seed), so the settled state is held at 1e-6
(relative error scaled by max(1, |ref|))."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu import core as jcore
from gymnasium_robotics_tpu.envs.hand.hand import HandManipulateBlockEnv as JBlock
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.utils import parity as jparity
from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch.envs.hand.hand import HandManipulateBlockEnv
from gymnasium_robotics_tpu_torch.utils import parity as tparity

SETTLE_TOL = 1e-6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def test_reset_with_values_matches_jax():
    """The host draws equal the JAX package's sampler's from the same seed;
    from them the port's reset gives the JAX env's state and
    observation."""
    jenv = JBlock(target_position="random", target_rotation="xyz",
                  dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    tenv = HandManipulateBlockEnv(target_position="random",
                                  target_rotation="xyz", dtype=torch.float64,
                                  device="cpu")
    jv = jparity.sample_reset_values(jenv, np.random.default_rng(7))
    tv = tparity.sample_reset_values(tenv, np.random.default_rng(7))
    assert jv.keys() == tv.keys()
    for k in jv:
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
    template = jcore.EnvState(
        data=jpipe.make_data(jenv.model, dtype=jnp.float64), obs=None,
        reward=jnp.zeros((), jnp.float64), terminated=jnp.zeros((), bool),
        truncated=jnp.zeros((), bool),
        info={"is_success": jnp.zeros((), jnp.float64)},
        rng=jax.random.key(0), goal=jnp.zeros(7, jnp.float64),
        steps=jnp.zeros((), jnp.int32), aux={})
    ref = jax.jit(jenv.reset_with_values).lower(
        template, {k: jnp.asarray(v) for k, v in jv.items()}).compile(
        FAST_COMPILE)(template, {k: jnp.asarray(v) for k, v in jv.items()})
    got = tenv.reset_with_values(
        core.EnvState(None, None, None, None, None, {}, None,
                      torch.zeros(1, dtype=torch.int32)),
        {k: np.asarray(v)[None] for k, v in tv.items()})
    for k in ref.obs:
        assert rel_err(got.obs[k][0].numpy(), ref.obs[k]) <= SETTLE_TOL, k
    for fld in ("qpos", "qvel", "xpos", "site_xpos", "time"):
        assert rel_err(getattr(got.data, fld)[..., 0].numpy(),
                       getattr(ref.data, fld)) <= SETTLE_TOL, fld
    assert got.steps.tolist() == [0] and not got.info["is_success"].any()
