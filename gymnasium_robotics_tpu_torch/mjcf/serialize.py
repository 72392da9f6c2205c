"""Load the compiled models the JAX package ships (port of
gymnasium_robotics_tpu/mjcf/serialize.py:61-99: ``load_model`` and
``load_asset``, reading only).

The model files are data: numeric fields as npz arrays, the static Meta as
JSON in ``__meta__``. They are read by path and never written.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import convert

ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gymnasium_robotics_tpu", "assets",
)


def asset_path(name: str) -> str:
    return os.path.join(ASSETS_DIR, name + ".npz")


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


def load_asset(name: str, dtype=torch.float32, device=None):
    """(Model, extra) of a shipped compiled asset, e.g. ``"fetch/push"``:
    the model as ``load_model`` gives it (convex-hull tables per hull,
    (nhull, V, 3) and (nhull, F, 4)) and the file's extras (initial qpos,
    mocap pose, ...) as numpy."""
    path = asset_path(name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"compiled asset {name!r} not found at {path}")
    return load_model(path, dtype=dtype, device=device)
