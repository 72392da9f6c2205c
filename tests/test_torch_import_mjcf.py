"""The port's MJCF importer (gymnasium_robotics_tpu_torch.mjcf) against the
JAX package's, and the locomotion model files it writes.

- import_arrays against JAX import_xml_path on the 12 XMLs the locomotion
  envs use, in float32 and float64: every Model field bit for bit (the
  candidate pairs' slot parameters con_* too), the Meta JSON equal (the
  pairs, their condims, the options, the names).
- Each committed assets/locomotion/<xml>.npz against a fresh import:
  tests/test_torch_import_mjcf_committed.py.
- The writer refuses any path outside the port's own assets directory.
- registry.make("HalfCheetah-v5", num_envs=2, device="cpu") resets and
  steps with ``mujoco`` and ``gymnasium`` blocked in sys.modules (the
  card's path reads the model files and imports neither)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch.mjcf import build_locomotion as BL
from gymnasium_robotics_tpu_torch.mjcf import import_mjcf, serialize
from gymnasium_robotics_tpu_torch.physics import types as T


@pytest.mark.parametrize("name", BL.XMLS)
def test_import_matches_jax(name):
    import mujoco

    from gymnasium_robotics_tpu.mjcf import import_mjcf as J
    from gymnasium_robotics_tpu.mjcf import serialize as JS

    path = BL.gym_xml(name)
    for dt in (np.float32, np.float64):
        jm = J.import_xml_path(path, dtype=dt)
        arrays, meta_json = import_mjcf.import_arrays(
            mujoco.MjModel.from_xml_path(path), dt)
        assert meta_json == JS._meta_to_json(jm.meta)
        for k in T.array_fields():
            ref = getattr(jm, k)
            if ref is None:
                assert arrays[k] is None, k
                continue
            ref = np.asarray(ref)
            assert arrays[k].dtype == ref.dtype, k
            np.testing.assert_array_equal(arrays[k], ref, err_msg=k)


def test_writer_stays_in_own_assets(tmp_path):
    arrays, meta_json = {"qpos0": np.zeros(1)}, "{}"
    for bad in (str(tmp_path / "x.npz"),
                os.path.join(serialize.ASSETS_DIR, "locomotion", "x.npz"),
                os.path.join(serialize.OWN_ASSETS_DIR, "..", "x.npz")):
        with pytest.raises(ValueError, match="outside"):
            serialize.save_model(bad, arrays, meta_json)


def test_half_cheetah_runs_without_mujoco_and_gymnasium():
    code = (
        "import sys\n"
        "sys.modules['mujoco'] = None\n"
        "sys.modules['gymnasium'] = None\n"
        "import torch\n"
        "from gymnasium_robotics_tpu_torch import registry\n"
        "env = registry.make('HalfCheetah-v5', num_envs=2, device='cpu')\n"
        "obs, _ = env.reset(seed=0)\n"
        "out = env.step(torch.zeros(2, 6))\n"
        "assert out[0].shape == (2, 17) and bool(torch.isfinite(out[0]).all())\n"
        "assert 'mujoco' not in [m for m, v in sys.modules.items() if v]\n"
        "assert not any(m.startswith('jax') or m.startswith('gymnasium_robotics_tpu.')\n"
        "               for m, v in sys.modules.items() if v)\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
