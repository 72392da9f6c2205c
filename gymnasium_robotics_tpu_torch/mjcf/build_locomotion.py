"""Compile the locomotion models into the port's own model files.

    python -m gymnasium_robotics_tpu_torch.mjcf.build_locomotion [NAME ...]

Imports each of gymnasium's installed MuJoCo XMLs that the locomotion envs
use (``XMLS``), and MaMuJoCo's CoupledHalfCheetah scene built from
gymnasium's half_cheetah.xml (``COUPLED``, ``coupled_cheetah_xml``), with
the MuJoCo compiler (mjcf/import_mjcf.py) and writes
``assets/locomotion/<name>.npz`` in float64, so that a float32 load rounds
once from float64, as a float32 import does. Needs ``mujoco``, ``scipy``
and ``gymnasium``; the envs then read the files and need none of them.
"""

from __future__ import annotations

import copy
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

XMLS = ("ant", "half_cheetah", "hopper", "humanoid", "humanoidstandup",
        "inverted_double_pendulum", "inverted_pendulum", "reacher",
        "pusher_v5", "swimmer", "walker2d", "walker2d_v5")
# MaMuJoCo's two half-cheetahs joined by a spatial tendon (coupled_cheetah_xml)
COUPLED = "coupled_half_cheetah"


def gym_xml(name: str) -> str:
    """Path of gymnasium's installed ``<name>.xml``."""
    import gymnasium.envs.mujoco as gm

    return os.path.join(os.path.dirname(gm.__file__), "assets", name + ".xml")


def asset_name(name: str) -> str:
    return f"locomotion/{name}"


def _suffix_tree(elem, suffix):
    for e in elem.iter():
        for attr in ("name", "joint", "site"):
            v = e.get(attr)
            if v is not None:
                e.set(attr, v + suffix)


def coupled_cheetah_xml() -> str:
    """The CoupledHalfCheetah scene (the JAX package's
    envs/mamujoco/coupled_half_cheetah.py ``coupled_cheetah_xml`` :40-79):
    gymnasium's half_cheetah.xml with its cheetah cloned (names suffixed 0
    and 1, at y = -1 and +1), the actuators doubled, a site at each torso's
    origin and the spatial tendon between them (limited to 1.5-3.5,
    stiffness 0.1)."""
    tree = ET.parse(gym_xml("half_cheetah"))
    root = tree.getroot()
    worldbody = root.find("worldbody")
    torso = worldbody.find("body")
    actuators = root.find("actuator")

    torso2 = copy.deepcopy(torso)
    act_children = list(actuators)
    _suffix_tree(torso, "0")
    for a in act_children:
        a.set("joint", a.get("joint") + "0")
        if a.get("name"):
            a.set("name", a.get("name") + "0")
    _suffix_tree(torso2, "1")
    torso.set("pos", "0 -1 0.7")
    torso2.set("pos", "0 1 0.7")
    worldbody.append(torso2)
    for a in act_children:
        a2 = copy.deepcopy(a)
        a2.set("joint", a.get("joint")[:-1] + "1")
        if a.get("name"):
            a2.set("name", a.get("name")[:-1] + "1")
        actuators.append(a2)
    for t, name in ((torso, "t0"), (torso2, "t1")):
        s = ET.SubElement(t, "site")
        s.set("name", name)
        s.set("pos", "0 0 0")
        s.set("size", "0.05")
    tendon = ET.SubElement(root, "tendon")
    spatial = ET.SubElement(tendon, "spatial")
    spatial.set("name", "tendon0")
    spatial.set("limited", "true")
    spatial.set("range", "1.5 3.5")
    spatial.set("stiffness", "0.1")
    ET.SubElement(spatial, "site").set("site", "t0")
    ET.SubElement(spatial, "site").set("site", "t1")
    return ET.tostring(root, encoding="unicode")


def mj_model(name: str):
    """The compiled ``mujoco.MjModel`` of a model file's name."""
    import mujoco

    if name == COUPLED:
        return mujoco.MjModel.from_xml_string(coupled_cheetah_xml())
    return mujoco.MjModel.from_xml_path(gym_xml(name))


def build(names=XMLS + (COUPLED,)) -> list:
    """Compile and write each named model; returns the paths written."""
    from gymnasium_robotics_tpu_torch.mjcf import import_mjcf, serialize

    out = []
    for name in names:
        arrays, meta_json = import_mjcf.import_arrays(mj_model(name), np.float64)
        path = os.path.join(serialize.OWN_ASSETS_DIR, asset_name(name) + ".npz")
        serialize.save_model(path, arrays, meta_json)
        out.append(path)
    return out


if __name__ == "__main__":
    for p in build(sys.argv[1:] or XMLS + (COUPLED,)):
        print(p, os.path.getsize(p), "bytes")
