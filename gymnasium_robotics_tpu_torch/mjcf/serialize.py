"""Compiled model files: read the JAX package's shipped models and the
port's own, and write the port's own (port of
gymnasium_robotics_tpu/mjcf/serialize.py: ``save_model`` :43-58,
``load_model`` and ``load_asset`` :61-99).

The files are data: numeric fields as npz arrays, the static Meta as JSON
in ``__meta__``. The JAX package's files are read by path and never
written; ``save_model`` writes only under the port's own ``assets/``
(the locomotion models, compiled on the host by mjcf/build_locomotion.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import convert

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS_DIR = os.path.join(os.path.dirname(_PKG), "gymnasium_robotics_tpu",
                          "assets")
OWN_ASSETS_DIR = os.path.join(_PKG, "assets")


def asset_path(name: str, root: str = ASSETS_DIR) -> str:
    """The model file of ``name`` under ``root``: the JAX package's assets,
    or the port's own (OWN_ASSETS_DIR, the locomotion models)."""
    return os.path.join(root, name + ".npz")


def save_model(path: str, arrays: dict, meta_json: str):
    """Write a model file in the format ``load_model`` reads: each array of
    ``arrays`` (None entries skipped) and the Meta JSON. Only under the
    port's own assets directory."""
    own = os.path.realpath(OWN_ASSETS_DIR) + os.sep
    if not os.path.realpath(path).startswith(own):
        raise ValueError(f"{path} is outside the port's assets ({OWN_ASSETS_DIR})")
    out = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    out["__meta__"] = np.frombuffer(meta_json.encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)


def load_model(path: str, dtype=torch.float32, device=None):
    """Returns (Model, extra): the model on ``device`` (the CUDA card unless
    named) with float fields in ``dtype``, and the file's ``extra__*``
    arrays as numpy."""
    with np.load(path) as z:
        meta_json = bytes(z["__meta__"]).decode()
        arrays, extra = {}, {}
        for k in z.files:
            if k == "__meta__":
                continue
            if k.startswith("extra__"):
                extra[k[len("extra__"):]] = z[k]
            else:
                arrays[k] = z[k]
    return convert.model_from_numpy(arrays, meta_json, dtype, device), extra


def load_asset(name: str, dtype=torch.float32, device=None,
               root: str = ASSETS_DIR):
    """(Model, extra) of a compiled model file, e.g. ``"fetch/push"`` or
    ``"locomotion/half_cheetah"``: the model as ``load_model`` gives it
    (convex-hull tables per hull, (nhull, V, 3) and (nhull, F, 4)) and the
    file's extras (initial qpos, mocap pose, ...) as numpy. ``root``: as
    asset_path's."""
    path = asset_path(name, root)
    if not os.path.exists(path):
        raise FileNotFoundError(f"compiled asset {name!r} not found at {path}")
    return load_model(path, dtype=dtype, device=device)
