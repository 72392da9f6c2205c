"""The committed locomotion model files
(gymnasium_robotics_tpu_torch/assets/locomotion/*.npz, float64) against a
fresh import of each model's XML by the port's importer, bit for bit,
and their float32 load against a float32 import (the importer itself is
held against the JAX one in tests/test_torch_import_mjcf.py)."""

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch.mjcf import build_locomotion as BL
from gymnasium_robotics_tpu_torch.mjcf import import_mjcf, serialize
from gymnasium_robotics_tpu_torch.physics import types as T


@pytest.mark.parametrize("name", BL.XMLS)
def test_committed_model_files_match_fresh_import(name):
    import mujoco

    arrays, meta_json = import_mjcf.import_arrays(
        mujoco.MjModel.from_xml_path(BL.gym_xml(name)), np.float64)
    path = serialize.asset_path(BL.asset_name(name), serialize.OWN_ASSETS_DIR)
    with np.load(path) as z:
        assert bytes(z["__meta__"]).decode() == meta_json
        stored = {k: z[k] for k in z.files if k != "__meta__"}
    assert set(stored) == {k for k, v in arrays.items() if v is not None}
    for k, v in stored.items():
        assert v.dtype == np.float64, k
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    m32, extra = serialize.load_asset(BL.asset_name(name), torch.float32, "cpu",
                                      root=serialize.OWN_ASSETS_DIR)
    assert extra == {}
    fresh = import_mjcf.import_model(
        mujoco.MjModel.from_xml_path(BL.gym_xml(name)), np.float32, "cpu")
    assert fresh.meta == m32.meta
    for k in T.array_fields():
        t = getattr(m32, k)
        if t is None:
            continue
        ref = arrays[k].astype(np.float32)
        got = t.numpy() if k in T.HULL_FIELDS else t[..., 0].numpy()
        np.testing.assert_array_equal(got, ref, err_msg=k)
        assert torch.equal(getattr(fresh, k), t), k
