"""The port's model loader (gymnasium_robotics_tpu_torch.mjcf.serialize)
against the JAX package's serialize.load_model, for every shipped PointMaze
and AntMaze model (where they lie and float64:
tests/test_torch_model_assets.py). Tolerance: exact equality of every field and of Meta (both sides
cast the same stored arrays)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu.physics import types as JT
from gymnasium_robotics_tpu_torch.mjcf import serialize as tser
from gymnasium_robotics_tpu_torch.physics import types as TT

def _assets(family):
    return sorted(glob.glob(os.path.join(jser.ASSETS_DIR, family, "*.npz")))


ASSETS = _assets("point_maze")
ANT_ASSETS = _assets("ant_maze")


@pytest.mark.parametrize("path", ASSETS + ANT_ASSETS, ids=os.path.basename)
def test_load_model_matches_jax(path):
    jm, jextra = jser.load_model(path)
    tm, textra = tser.load_model(path, device="cpu")
    assert dataclasses.asdict(tm.meta) == dataclasses.asdict(jm.meta)
    assert sorted(textra) == sorted(jextra)
    assert [f.name for f in dataclasses.fields(JT.Model)
            if f.name not in JT.Model._meta] == TT.array_fields()
    for name in TT.array_fields():
        jv, tv = getattr(jm, name), getattr(tm, name)
        if jv is None:
            assert tv is None, name
            continue
        tv = tv.numpy()
        if name not in TT.HULL_FIELDS:
            assert tv.shape[-1] == 1, name  # trailing broadcast axis
            tv = tv[..., 0]
        assert tv.dtype == np.asarray(jv).dtype, name
        np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=name)
