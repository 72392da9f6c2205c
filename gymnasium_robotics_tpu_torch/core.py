"""Batched environment core (port of gymnasium_robotics_tpu/core.py).

An env here steps its whole batch at once: the env-level leaves of
``EnvState`` are B-leading (``obs["observation"] (B, 4)``, ``reward (B,)``),
as JAX's ``BatchedEnv`` returns them, while ``data`` is the batch-last
physics ``Data``. Where JAX maps per-env functions with ``vmap``, the batch
dimension is written out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from gymnasium_robotics_tpu_torch.physics import types as T


@dataclasses.dataclass
class EnvState:
    """Complete state of a batch of env instances."""

    data: Any              # batch-last physics Data
    obs: Any               # (B, n) tensor, or a dict of (B, ...) tensors
    reward: Any            # (B,)
    terminated: Any        # (B,) bool
    truncated: Any         # (B,) bool
    info: Dict[str, Any]   # (B,) tensors
    goal: Any              # (B, ...)
    steps: Any             # (B,) int32, steps since the last reset
    # per-family, per-env state (B-leading tensors) beside the physics:
    # the hand's pool of settled reset poses (a reset keeps it), Adroit's
    # scene (door position, board height, pen target, ball and target
    # positions), drawn anew at every reset. auto_reset picks it per env
    # with the rest of the state.
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _where_batch_last(mask, a, b):
    return torch.where(mask.view((1,) * (a.dim() - 1) + (-1,)), a, b)


def _where_batch_first(mask, a, b):
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _pick_first(done, fresh, stepped):
    """Per env, ``fresh`` where ``done`` and ``stepped`` elsewhere, for a
    B-leading tensor or a dict of them, nested at any depth (the kitchen's
    goals are dicts by task)."""
    if isinstance(stepped, dict):
        return {k: _pick_first(done, fresh[k], v) for k, v in stepped.items()}
    return _where_batch_first(done, fresh, stepped)


def _pick_data(done, fresh: T.Data, stepped: T.Data) -> T.Data:
    """Per env, the fresh Data where ``done`` and the stepped one elsewhere:
    every leaf, as JAX's auto_reset picks the whole state tree, including
    the contact table's per-env slot map (src, geom1, geom2 (ncon, B) under
    pair-topk pruning); static (ncon,) geom ids are shared and kept."""
    kw = {}
    for f in dataclasses.fields(T.Data):
        if f.name == "contact":
            continue
        kw[f.name] = _where_batch_last(
            done, getattr(fresh, f.name), getattr(stepped, f.name)
        )
    c1, c2 = fresh.contact, stepped.contact
    names = ["dist", "pos", "frame"]
    names += [n for n in ("src", "geom1", "geom2")
              if getattr(c2, n) is not None and getattr(c2, n).dim() == 2]
    kw["contact"] = dataclasses.replace(
        c2, **{n: _where_batch_last(done, getattr(c1, n), getattr(c2, n))
               for n in names}
    )
    return T.Data(**kw)


def auto_reset(env, state: EnvState, action, generator) -> EnvState:
    """Step with masked in-step auto-reset: an env whose episode ends on
    this step (terminated, past ``max_episode_steps``, or diverged) comes
    back reset, while the transition's reward, terminated and truncated are
    reported. ``generator`` draws the reset noise."""
    stepped = env.step(state, action, generator)
    truncated = stepped.truncated
    if env.max_episode_steps is not None:
        truncated = truncated | (stepped.steps >= env.max_episode_steps)

    # divergence guard (the mjWARN_BADQACC analogue), per env over its own
    # qacc and qpos: a non-finite or exploding state ends the episode
    data = stepped.data
    bad = torch.zeros_like(truncated)
    if data.qacc.numel():
        q_mag = torch.amax(torch.abs(data.qacc), dim=0) + torch.amax(
            torch.abs(data.qpos), dim=0
        )
        bad = ~torch.isfinite(q_mag) | (q_mag > 1e10)
        truncated = truncated | bad

    done = stepped.terminated | truncated
    fresh = env.reset(stepped, generator)
    info = dict(stepped.info)
    if "diverged" in state.info:
        info["diverged"] = bad
    return EnvState(
        data=_pick_data(done, fresh.data, data),
        obs=_pick_first(done, fresh.obs, stepped.obs),
        reward=stepped.reward,
        terminated=stepped.terminated,
        truncated=truncated,
        info=info,
        goal=_where_batch_first(done, fresh.goal, stepped.goal),
        steps=torch.where(done, fresh.steps, stepped.steps),
        aux=_pick_first(done, fresh.aux, stepped.aux),
    )


def with_diverged(state: EnvState) -> EnvState:
    """Opt a fresh state into divergence reporting: ``info["diverged"]``,
    which ``auto_reset`` keeps updated."""
    info = dict(state.info)
    info["diverged"] = torch.zeros_like(state.truncated)
    return dataclasses.replace(state, info=info)
