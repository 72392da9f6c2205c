"""Compile the locomotion models into the port's own model files.

    python -m gymnasium_robotics_tpu_torch.mjcf.build_locomotion

Imports each of gymnasium's installed MuJoCo XMLs that the locomotion envs
use (``XMLS``) with the MuJoCo compiler (mjcf/import_mjcf.py) and writes
``assets/locomotion/<xml>.npz`` in float64, so that a float32 load rounds
once from float64, as a float32 import does. Needs ``mujoco``, ``scipy``
and ``gymnasium``; the envs then read the files and need none of them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

XMLS = ("ant", "half_cheetah", "hopper", "humanoid", "humanoidstandup",
        "inverted_double_pendulum", "inverted_pendulum", "reacher",
        "pusher_v5", "swimmer", "walker2d", "walker2d_v5")


def gym_xml(name: str) -> str:
    """Path of gymnasium's installed ``<name>.xml``."""
    import gymnasium.envs.mujoco as gm

    return os.path.join(os.path.dirname(gm.__file__), "assets", name + ".xml")


def asset_name(name: str) -> str:
    return f"locomotion/{name}"


def build(names=XMLS) -> list:
    """Compile and write each named model; returns the paths written."""
    import mujoco

    from gymnasium_robotics_tpu_torch.mjcf import import_mjcf, serialize

    out = []
    for name in names:
        m = mujoco.MjModel.from_xml_path(gym_xml(name))
        arrays, meta_json = import_mjcf.import_arrays(m, np.float64)
        path = os.path.join(serialize.OWN_ASSETS_DIR, asset_name(name) + ".npz")
        serialize.save_model(path, arrays, meta_json)
        out.append(path)
    return out


if __name__ == "__main__":
    for p in build(sys.argv[1:] or XMLS):
        print(p, os.path.getsize(p), "bytes")
