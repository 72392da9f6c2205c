"""Carry a model and a batched state across from numpy arrays.

These functions take and return numpy arrays only, so a caller can move the
JAX package's ``Model`` and batched ``EnvState`` into the port (``np.asarray``
on each leaf) without this package importing JAX; both sides then step from
the very same state.

Layouts: the JAX batched leaves are B-leading; the port's ``Data`` is
batch-last and its ``Model`` leaves carry a trailing axis of size 1. The
env-level leaves of ``EnvState`` (obs, reward, goal, ...) are B-leading on
both sides.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import core
from gymnasium_robotics_tpu_torch import device as _device
from gymnasium_robotics_tpu_torch.physics import types as T

_CONTACT_FIELDS = ("dist", "pos", "frame")


def meta_from_json(s: str) -> T.Meta:
    """Meta (with its Option) from the JSON the shipped model files carry."""
    d = json.loads(s)

    def tup(x):
        if isinstance(x, list):
            return tuple(tup(e) for e in x)
        return x

    opt = T.Option(**{k: tup(v) for k, v in d.pop("opt").items()})
    return T.Meta(opt=opt, **{k: tup(v) for k, v in d.items()})


def model_from_numpy(arrays: dict, meta_json: str, dtype=torch.float32,
                     device=None) -> T.Model:
    """Model from per-field numpy arrays (unbatched, as the JAX ``Model``
    holds them) and the Meta JSON. Float fields are cast to ``dtype``; every
    leaf but the hull tables gains a trailing axis of size 1."""
    dev = _device.resolve(device)
    kw = {}
    for name in T.array_fields():
        arr = arrays.get(name)
        if arr is None:
            kw[name] = None
            continue
        arr = np.asarray(arr)
        t = torch.tensor(arr)
        if arr.dtype.kind == "f":
            t = t.to(dtype)
        if name not in T.HULL_FIELDS:
            t = t[..., None]
        kw[name] = t.contiguous().to(dev)
    return T.Model(meta=meta_from_json(meta_json), **kw)


def _to_batch_last(arr, dev):
    return torch.tensor(np.moveaxis(np.asarray(arr), 0, -1)).contiguous().to(dev)


def _to_batch_first(t):
    return np.moveaxis(t.detach().cpu().numpy(), -1, 0)


def data_from_numpy(fields: dict, device=None) -> T.Data:
    """The port's batch-last ``Data`` from B-leading batched leaves (the JAX
    ``BatchedEnv`` layout). ``fields["contact"]`` is a dict of the Contact
    leaves; its geom ids may be (ncon,) or (B, ncon), and a pair-topk table
    carries per-env ``src``, ``geom1`` and ``geom2`` (B, ncon)."""
    dev = _device.resolve(device)
    kw = {}
    for f in dataclasses.fields(T.Data):
        if f.name == "contact":
            continue
        kw[f.name] = _to_batch_last(fields[f.name], dev)
    c = fields["contact"]
    pruned = c.get("src") is not None
    ids = {}
    for name in ("geom1", "geom2", "src"):
        g = c.get(name)
        if g is None:
            ids[name] = None
        elif pruned:
            # pair-topk: the slot map is per env, (B, ncon) -> (ncon, B)
            ids[name] = _to_batch_last(np.asarray(g).astype(np.int64), dev)
        else:
            g = np.asarray(g)
            ids[name] = torch.tensor(
                (g[0] if g.ndim == 2 else g).astype(np.int64)).to(dev)
    kw["contact"] = T.Contact(
        *[_to_batch_last(c[name], dev) for name in _CONTACT_FIELDS], **ids
    )
    return T.Data(**kw)


def data_to_numpy(data: T.Data) -> dict:
    """B-leading numpy leaves of a batch-last ``Data`` (the reverse of
    ``data_from_numpy``; geom ids come back as (B, ncon))."""
    out = {}
    for f in dataclasses.fields(T.Data):
        if f.name != "contact":
            out[f.name] = _to_batch_first(getattr(data, f.name))
    c = data.contact
    B = data.qpos.shape[-1]
    out["contact"] = {name: _to_batch_first(getattr(c, name))
                      for name in _CONTACT_FIELDS}
    out["contact"]["src"] = None
    if c.src is not None:
        for name in ("geom1", "geom2", "src"):
            out["contact"][name] = _to_batch_first(getattr(c, name))
        return out
    for name in ("geom1", "geom2"):
        g = getattr(c, name).cpu().numpy()
        out["contact"][name] = np.broadcast_to(g, (B,) + g.shape).copy()
    return out


def _env_leaf(x, dev):
    return torch.tensor(np.asarray(x)).to(dev)


def _map_obs(obs, fn):
    """fn on an observation: a dict of leaves or of dicts of leaves (the
    goal envs; the kitchen's goals are dicts by task) or one leaf
    (Adroit's flat vector)."""
    if isinstance(obs, dict):
        return {k: _map_obs(v, fn) for k, v in obs.items()}
    return fn(obs)


def env_state_from_numpy(fields: dict, device=None):
    """The port's ``EnvState`` from B-leading numpy leaves: ``data`` (as for
    ``data_from_numpy``), ``obs`` (a dict, or one array: Adroit's),
    ``reward``, ``terminated``, ``truncated``, ``info`` (dict: ``success``
    and, when present, ``diverged``), ``goal``, ``steps`` and, where given,
    ``aux`` (dict: the hand's pool of settled poses, Adroit's scene). Per-env
    RNG keys are not carried: the port's resets draw from a
    ``torch.Generator``."""
    dev = _device.resolve(device)
    return core.EnvState(
        data=data_from_numpy(fields["data"], dev),
        obs=_map_obs(fields["obs"], lambda v: _env_leaf(v, dev)),
        reward=_env_leaf(fields["reward"], dev),
        terminated=_env_leaf(fields["terminated"], dev),
        truncated=_env_leaf(fields["truncated"], dev),
        info={k: _env_leaf(v, dev) for k, v in fields["info"].items()},
        goal=_env_leaf(fields["goal"], dev),
        steps=_env_leaf(fields["steps"], dev),
        aux={k: _env_leaf(v, dev) for k, v in fields.get("aux", {}).items()},
    )


def env_state_to_numpy(state) -> dict:
    """B-leading numpy leaves of an ``EnvState`` (reverse of
    ``env_state_from_numpy``)."""

    def np_(t):
        return t.detach().cpu().numpy()

    return dict(
        data=data_to_numpy(state.data),
        obs=_map_obs(state.obs, np_),
        reward=np_(state.reward),
        terminated=np_(state.terminated),
        truncated=np_(state.truncated),
        info={k: np_(v) for k, v in state.info.items()},
        goal=np_(state.goal),
        steps=np_(state.steps),
        aux={k: np_(v) for k, v in state.aux.items()},
    )
