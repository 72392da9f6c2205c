"""Batch-last narrowphase over the static candidate pair table.

Host tables: port of gymnasium_robotics_tpu/physics/collision.py (slot
counts, ``ncon``, the pair-topk prune test) and of
``collision_vec.slot_geoms_static`` :1341 / ``constraint._slot_geoms``.
Device part: the unpruned core ``collision_vec._make_narrowphase_core``
:932-1060 with the primitives this slice reaches (plane-sphere :88,
sphere-box :221-251) and the contact frame ``_contact_frame_soa`` :806,
driven like ``soa.collision`` :1018-1081.

Every slot reports a signed distance; slots far from touching simply carry
a large positive one. Any other geom-type pair raises
``NotImplementedError`` naming it, as does an active pair-topk prune plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch.physics import types as T

_BIG = 1e10
_TYPE_NAMES = ("plane", "hfield", "sphere", "capsule", "ellipsoid",
               "cylinder", "box", "mesh")

# contact slots per canonically ordered (type1, type2) pair
_SLOTS = {
    (T.PLANE, T.SPHERE): 1, (T.PLANE, T.CAPSULE): 2, (T.PLANE, T.BOX): 4,
    (T.PLANE, T.CYLINDER): 2, (T.PLANE, T.ELLIPSOID): 1,
    (T.SPHERE, T.SPHERE): 1, (T.SPHERE, T.CAPSULE): 1, (T.SPHERE, T.BOX): 1,
    (T.SPHERE, T.CYLINDER): 1, (T.SPHERE, T.ELLIPSOID): 1,
    (T.CAPSULE, T.CAPSULE): 1, (T.CAPSULE, T.BOX): 3,
    (T.CAPSULE, T.CYLINDER): 1, (T.CAPSULE, T.ELLIPSOID): 1,
    (T.BOX, T.BOX): 9, (T.CYLINDER, T.CYLINDER): 1, (T.CYLINDER, T.BOX): 3,
    (T.ELLIPSOID, T.BOX): 1, (T.ELLIPSOID, T.ELLIPSOID): 1,
    (T.ELLIPSOID, T.CYLINDER): 1,
    (T.PLANE, T.MESH): 4, (T.SPHERE, T.MESH): 1, (T.CAPSULE, T.MESH): 2,
    (T.ELLIPSOID, T.MESH): 1, (T.CYLINDER, T.MESH): 2, (T.BOX, T.MESH): 8,
    (T.MESH, T.MESH): 4,
}


def pair_slots(t1: int, t2: int) -> int:
    return _SLOTS.get((min(t1, t2), max(t1, t2)), 1)


def _pair_slot_counts(meta: T.Meta):
    return [pair_slots(meta.geom_type[g1], meta.geom_type[g2])
            for g1, g2 in meta.pairs]


def prune_active(meta: T.Meta) -> bool:
    """Whether Option.pair_topk prunes any (type pair, condim) group
    (collision.prune_plan): plane groups never prune."""
    K = meta.opt.pair_topk
    if not K:
        return False
    counts = _pair_slot_counts(meta)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    sizes: dict = {}
    for j, (g1, g2) in enumerate(meta.pairs):
        t1, t2 = meta.geom_type[g1], meta.geom_type[g2]
        key = (t1, t2, meta.con_condim[int(base[j])])
        sizes[key] = sizes.get(key, 0) + 1
    return any(n > K and T.PLANE not in key[:2] for key, n in sizes.items())


def ncon(m: T.Model) -> int:
    """Slot count of the contact table Data carries (the full static
    table; the compact pair-topk table is a later slice)."""
    if prune_active(m.meta):
        raise NotImplementedError(
            "pair-topk pruning (Option.pair_topk) comes with the FetchPush "
            "slice"
        )
    return sum(_pair_slot_counts(m.meta))


def slot_geoms_static(meta: T.Meta):
    """(geom1, geom2) per canonical static slot, numpy int32 (ncon,) each."""
    g1s, g2s = [], []
    for (g1, g2), k in zip(meta.pairs, _pair_slot_counts(meta)):
        g1s += [g1] * k
        g2s += [g2] * k
    return np.array(g1s, np.int32), np.array(g2s, np.int32)


def slot_geoms(m: T.Model):
    """``slot_geoms_static`` as int32 tensors on the model's device, made
    once per model (a copy from host memory would wait for the device)."""
    return m.plan("slot_geoms", lambda m: tuple(
        torch.as_tensor(g, device=m.device) for g in slot_geoms_static(m.meta)
    ))


# ---------------------------------------------------------------------------
# Primitives: p (3, k, B), R (3, 3, k, B), s (3, k, Bm) -> dist (S, k, B),
# pos (S, 3, k, B), normal (S, 3, k, B) from geom1 into geom2.
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b, dim=0)


def _normalize(a, eps=1e-12):
    n = torch.sqrt(torch.clamp(_dot(a, a), min=0.0))
    return a / torch.clamp(n, min=eps)[None], n


def _matvec(R, v):
    return torch.stack([_dot(R[i], v) for i in range(3)])


def _matTvec(R, v):
    return torch.stack([_dot(R[:, i], v) for i in range(3)])


def _plane_sphere(p1, R1, s1, p2, R2, s2):
    n = R1[:, 2]
    dist = _dot(n, p2 - p1) - s2[0]
    pos = p2 - n * (s2[0] + 0.5 * dist)[None]
    return dist[None], pos[None], n[None]


def _sphere_box(p1, R1, s1, p2, R2, s2):
    r1 = s1[0]
    loc = _matTvec(R2, p1 - p2)                  # sphere centre in box frame
    s2b = s2.expand(loc.shape)
    clamped = torch.minimum(torch.maximum(loc, -s2b), s2b)
    inside = torch.all(torch.abs(loc) < s2b, dim=0)
    face_dist = s2b - torch.abs(loc)
    k = torch.argmin(face_dist, dim=0)
    iota3 = torch.arange(3, device=loc.device)[:, None, None]
    onehot = (iota3 == k[None]).to(loc.dtype)
    sgn_k = torch.sign(torch.sum(loc * onehot, dim=0))
    push = onehot * (sgn_k[None] * torch.sum(s2b * onehot, dim=0)[None])
    surf_in = torch.where(onehot > 0, push, loc)
    surf = torch.where(inside[None], surf_in, clamped)
    world = p2 + _matvec(R2, surf)
    nrm, d0 = _normalize(world - p1)
    n_out = torch.where((d0 > 1e-9)[None], nrm, R2[:, 2])
    dist_out = d0 - r1
    dist_in = -(torch.amin(face_dist, dim=0) + r1)
    n_in = -_matvec(R2, onehot * sgn_k[None])
    n = torch.where(inside[None], n_in, n_out)
    dist = torch.where(inside, dist_in, dist_out)
    pos = p1 + n * (r1 + 0.5 * dist)[None]
    return dist[None], pos[None], n[None]


_PRIMITIVES = {
    (T.PLANE, T.SPHERE): _plane_sphere,
    (T.SPHERE, T.BOX): _sphere_box,
}


def _contact_frame(n):
    """Rows (normal, tan1, tan2) from normals (3, N, B), mju_makeFrame's
    convention. The JAX core takes an explicit tan1 where a primitive gives
    one (capsule/cylinder against a plane); neither ported primitive does,
    so every slot takes the generic tangent, as its NaN placeholder does
    there."""
    z = torch.zeros_like(n[0])
    o = z + 1.0
    yhat = torch.stack([z, o, z])
    zhat = torch.stack([z, z, o])
    cand_y = yhat - n * n[1][None]
    cand_z = zhat - n * n[2][None]
    use_y = torch.abs(n[1]) < 0.99
    t1, _ = _normalize(torch.where(use_y[None], cand_y, cand_z))
    t2 = torch.stack([
        n[1] * t1[2] - n[2] * t1[1],
        n[2] * t1[0] - n[0] * t1[2],
        n[0] * t1[1] - n[1] * t1[0],
    ])
    return torch.stack([n, t1, t2], dim=1)            # (3comp, 3rows, N, B)


class _NarrowPlan:
    """Pair groups by type pair, with device index tensors, and the static
    permutation from group-major to canonical pair-major slot order."""

    def __init__(self, m: T.Model):
        meta = m.meta
        dev = m.device
        groups: dict = {}
        for g1, g2 in meta.pairs:
            tp = (meta.geom_type[g1], meta.geom_type[g2])
            groups.setdefault(tp, []).append((g1, g2))
        for t1, t2 in groups:
            if (t1, t2) not in _PRIMITIVES:
                raise NotImplementedError(
                    f"narrowphase for {_TYPE_NAMES[t1]}-{_TYPE_NAMES[t2]} pairs "
                    "is not ported yet (the PointMaze slice ports "
                    "plane-sphere and sphere-box)"
                )
        self.groups = []
        group_base, offset = {}, 0
        for tp, entries in groups.items():
            group_base[tp] = offset
            offset += len(entries) * pair_slots(*tp)
            self.groups.append((
                _PRIMITIVES[tp], pair_slots(*tp), len(entries),
                torch.as_tensor([e[0] for e in entries], device=dev),
                torch.as_tensor([e[1] for e in entries], device=dev),
            ))
        perm = np.zeros(offset, dtype=np.int64)
        pos_in_group = {tp: 0 for tp in groups}
        cursor = 0
        for g1, g2 in meta.pairs:
            tp = (meta.geom_type[g1], meta.geom_type[g2])
            k = pair_slots(*tp)
            src = group_base[tp] + pos_in_group[tp] * k
            perm[cursor:cursor + k] = np.arange(src, src + k)
            pos_in_group[tp] += 1
            cursor += k
        self.perm = torch.as_tensor(perm, device=dev)


def collision(m: T.Model, d: T.Data) -> T.Data:
    mt = m.meta
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    n_total = ncon(m)

    geom1, geom2 = slot_geoms(m)
    if not mt.pairs or mt.opt.disable_contact:
        eye = torch.eye(3, dtype=dtype, device=d.qpos.device)
        contact = T.Contact(
            dist=d.qpos.new_full((n_total, B), _BIG),
            pos=d.qpos.new_zeros((n_total, 3, B)),
            frame=eye[None, :, :, None].expand(n_total, 3, 3, B),
            geom1=geom1, geom2=geom2,
        )
        return dataclasses.replace(d, contact=contact)

    plan = m.plan("narrow", _NarrowPlan)
    P, Rm, sizes3 = d.geom_xpos, d.geom_xmat, m.geom_size

    def take(i):
        return (P[i].transpose(0, 1),                 # (3, k, B)
                Rm[i].movedim(0, 2),                  # (3, 3, k, B)
                sizes3[i].transpose(0, 1))            # (3, k, Bm)

    all_d, all_p, all_n = [], [], []
    for fn, S, k, i1, i2 in plan.groups:
        dd, pp, nn = fn(*take(i1), *take(i2))
        # (S, k, B) -> pair-major rows (k*S, B); (S, 3, k, B) -> (k*S, 3, B)
        all_d.append(dd.transpose(0, 1).reshape(k * S, B))
        all_p.append(pp.movedim(2, 0).reshape(k * S, 3, B))
        all_n.append(nn.movedim(2, 0).reshape(k * S, 3, B))

    dist = torch.cat(all_d)[plan.perm]
    pos = torch.cat(all_p)[plan.perm]
    normal = torch.cat(all_n)[plan.perm]
    frame = _contact_frame(normal.transpose(0, 1))
    contact = T.Contact(
        dist=dist, pos=pos, frame=frame.permute(2, 1, 0, 3),
        geom1=geom1, geom2=geom2,
    )
    return dataclasses.replace(d, contact=contact)
