"""Load the compiled models the JAX package ships (port of
gymnasium_robotics_tpu/mjcf/serialize.py:61-99, reading only).

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
