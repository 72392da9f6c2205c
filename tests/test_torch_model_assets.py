"""The port reads the JAX package's shipped maze models where they lie,
and loads them in float64 as the JAX loader does (each model's fields
are held against the JAX loader in tests/test_torch_model.py)."""

import glob
import os

import numpy as np
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu_torch.mjcf import serialize as tser


def _assets(family):
    return sorted(glob.glob(os.path.join(jser.ASSETS_DIR, family, "*.npz")))


ASSETS = _assets("point_maze")
ANT_ASSETS = _assets("ant_maze")


def test_port_reads_the_jax_assets():
    assert os.path.samefile(tser.ASSETS_DIR, jser.ASSETS_DIR)
    assert len(ASSETS) == 12
    assert len(ANT_ASSETS) == 10


def test_load_model_float64():
    jm, _ = jser.load_model(ASSETS[0], dtype=np.float64)
    tm, _ = tser.load_model(ASSETS[0], dtype=torch.float64, device="cpu")
    assert tm.body_mass.dtype == torch.float64
    np.testing.assert_array_equal(tm.geom_size.numpy()[..., 0],
                                  np.asarray(jm.geom_size))
