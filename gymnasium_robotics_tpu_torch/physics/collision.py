"""Batch-last narrowphase over the static candidate pair table.

Host tables: port of gymnasium_robotics_tpu/physics/collision.py (slot
counts, ``ncon``, the pair-topk ``prune_plan`` :102-175) and of
``collision_vec.slot_geoms_static`` :1341. Device part: the unpruned core
``collision_vec._make_narrowphase_core`` :932-1060 and the pair-topk core
``_make_narrowphase_core_pruned`` :1063-1334 (AABB gap ranking,
per-group selection through ``narrowphase.topk_select``, the contact
formulas through ``narrowphase.narrowphase``, ``src`` and the compact
group-major table), driven like ``soa.collision`` :1018-1081, with the
primitives the ported slices reach: plane-sphere :88, plane-capsule :95,
sphere-box :221-251 and capsule-box :375, and the contact frame
``_contact_frame_soa`` :806.

Every slot reports a signed distance; slots far from touching simply carry
a large positive one. Any other geom-type pair raises
``NotImplementedError`` naming it; mesh (convex hull) groups name the
FetchPush slice that brings them.
"""

from __future__ import annotations

import dataclasses
import functools

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


def ncon_static(meta: T.Meta) -> int:
    """Slot count of the full static candidate table (the per-slot model
    tables con_solref/solimp/friction/includemargin are this size)."""
    return sum(_pair_slot_counts(meta))


# ---------------------------------------------------------------------------
# Pair-topk host tables (collision.prune_plan :102-175)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PruneGroup:
    tp: tuple            # (t1, t2)
    cd: int              # condim shared by every pair in the group
    idx: tuple           # positions into meta.pairs
    S: int               # slots per pair
    K: int               # pairs evaluated (== len(idx) when not pruned)
    pruned: bool
    base_c: int          # compact slot offset of this group

    @property
    def n_slots_c(self):
        return self.K * self.S


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    active: bool
    groups: tuple        # of PruneGroup (empty when inactive)
    ncon_c: int


@functools.lru_cache(maxsize=None)
def _pair_slot_base(meta: T.Meta):
    """Canonical static slot offset per pair (meta.pairs order), numpy."""
    counts = _pair_slot_counts(meta)
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64) \
        if counts else np.zeros(0, np.int64)


def _pair_condim(meta: T.Meta, j: int) -> int:
    """Condim of pair j, read from the canonical per-slot table."""
    return meta.con_condim[int(_pair_slot_base(meta)[j])]


@functools.lru_cache(maxsize=None)
def prune_plan(meta: T.Meta) -> PrunePlan:
    """Static layout of the pair-level top-K broadphase (Option.pair_topk).

    Pairs are grouped by (geom-type pair, condim); a group larger than K
    evaluates the narrowphase on only the K nearest pairs per env, ranked by
    world-AABB gap minus margin. Plane groups are never pruned. The compact
    slot layout is group-major, pair-major, slot-minor; Contact.src maps
    each compact slot to its canonical static slot id."""
    K = meta.opt.pair_topk
    if not K:
        return PrunePlan(active=False, groups=(), ncon_c=0)
    members: dict = {}
    for j, (g1, g2) in enumerate(meta.pairs):
        key = (meta.geom_type[g1], meta.geom_type[g2], _pair_condim(meta, j))
        members.setdefault(key, []).append(j)
    groups, base_c, any_pruned = [], 0, False
    for (t1, t2, cd), idx in members.items():
        S = pair_slots(t1, t2)
        pruned = len(idx) > K and T.PLANE not in (t1, t2)
        Kg = K if pruned else len(idx)
        groups.append(PruneGroup(tp=(t1, t2), cd=cd, idx=tuple(idx), S=S,
                                 K=Kg, pruned=pruned, base_c=base_c))
        base_c += Kg * S
        any_pruned |= pruned
    if not any_pruned:
        return PrunePlan(active=False, groups=(), ncon_c=0)
    return PrunePlan(active=True, groups=tuple(groups), ncon_c=base_c)


@functools.lru_cache(maxsize=None)
def compact_condim(meta: T.Meta):
    """Condim per compact slot (pair_topk layout), numpy (ncon_c,)."""
    out = []
    for g in prune_plan(meta).groups:
        out += [g.cd] * g.n_slots_c
    return np.array(out, np.int64)


def prune_active(meta: T.Meta) -> bool:
    return prune_plan(meta).active


def ncon(m: T.Model) -> int:
    """Slot count of the contact table Data carries: compact under pair-topk
    pruning, else the full static table."""
    p = prune_plan(m.meta)
    return p.ncon_c if p.active else ncon_static(m.meta)


def slot_geoms_static(meta: T.Meta):
    """(geom1, geom2) per canonical static slot, numpy int32 (ncon,) each."""
    g1s, g2s = [], []
    for (g1, g2), k in zip(meta.pairs, _pair_slot_counts(meta)):
        g1s += [g1] * k
        g2s += [g2] * k
    return np.array(g1s, np.int32), np.array(g2s, np.int32)


def slot_geoms(m: T.Model):
    """``slot_geoms_static`` as int64 tensors on the model's device, made
    once per model (a copy from host memory would wait for the device)."""
    return m.plan("slot_geoms", lambda m: tuple(
        torch.as_tensor(g.astype(np.int64), device=m.device)
        for g in slot_geoms_static(m.meta)
    ))


# ---------------------------------------------------------------------------
# Primitives: p (3, k, B), R (3, 3, k, B), s (3, k, Bm) -> dist (S, k, B),
# pos (S, 3, k, B), normal (S, 3, k, B) from geom1 into geom2, and for
# plane-capsule an explicit tan1 (S, 3, k, B) (NaN where undefined).
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


def _plane_capsule(p1, R1, s1, p2, R2, s2):
    n = R1[:, 2]
    axis = R2[:, 2]
    pn = _dot(p1, n)
    outs_d, outs_p = [], []
    for sgn in (1.0, -1.0):
        e = p2 + axis * (sgn * s2[1])[None]
        dist = _dot(e, n) - pn - s2[0]
        outs_d.append(dist)
        outs_p.append(e - n * (s2[0] + 0.5 * dist)[None])
    # tan1 = capsule +z axis projected onto the plane; undefined (NaN) for a
    # capsule standing on the plane, where the frame takes the generic one
    proj = axis - n * _dot(n, axis)[None]
    t1n, nrm = _normalize(proj, 1e-12)
    tan = torch.where((nrm > 1e-8)[None], t1n, torch.full_like(t1n, float("nan")))
    return (torch.stack(outs_d), torch.stack(outs_p), torch.stack([n, n]),
            torch.stack([tan, tan]))


def _closest_on_seg(p, a, b):
    ab = b - a
    t = torch.clamp(
        _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12), 0.0, 1.0
    )
    return a + t[None] * ab


def _sphere_box_at(c1, r1, p2, R2, s2):
    loc = _matTvec(R2, c1 - p2)                  # sphere centre in box frame
    s2b = s2.expand(loc.shape)
    clamped = torch.minimum(torch.maximum(loc, -s2b), s2b)
    inside = torch.all(torch.abs(loc) < s2b, dim=0)
    face_dist = s2b - torch.abs(loc)
    k = torch.argmin(face_dist, dim=0)           # first index on ties
    iota3 = torch.arange(3, device=loc.device)[:, None, None]
    onehot = (iota3 == k[None]).to(loc.dtype)
    sgn_k = torch.sign(torch.sum(loc * onehot, dim=0))   # sign(0) = 0
    push = onehot * (sgn_k[None] * torch.sum(s2b * onehot, dim=0)[None])
    surf_in = torch.where(onehot > 0, push, loc)
    surf = torch.where(inside[None], surf_in, clamped)
    world = p2 + _matvec(R2, surf)
    nrm, d0 = _normalize(world - c1)
    n_out = torch.where((d0 > 1e-9)[None], nrm, R2[:, 2])
    dist_out = d0 - r1
    dist_in = -(torch.amin(face_dist, dim=0) + r1)
    n_in = -_matvec(R2, onehot * sgn_k[None])
    n = torch.where(inside[None], n_in, n_out)
    dist = torch.where(inside, dist_in, dist_out)
    pos = c1 + n * (r1 + 0.5 * dist)[None]
    return dist[None], pos[None], n[None]


def _sphere_box(p1, R1, s1, p2, R2, s2):
    return _sphere_box_at(p1, s1[0], p2, R2, s2)


def _capsule_box(p1, R1, s1, p2, R2, s2):
    ax = R1[:, 2]
    outs = [_sphere_box_at(p1 + ax * (t * s1[1])[None], s1[0], p2, R2, s2)
            for t in (-1.0, 0.0, 1.0)]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


PRIMITIVES = {
    (T.PLANE, T.SPHERE): _plane_sphere,
    (T.PLANE, T.CAPSULE): _plane_capsule,
    (T.SPHERE, T.BOX): _sphere_box,
    (T.CAPSULE, T.BOX): _capsule_box,
}


def _check_ported(t1, t2):
    if (t1, t2) in PRIMITIVES:
        return
    if T.MESH in (t1, t2):
        raise NotImplementedError(
            f"narrowphase for {_TYPE_NAMES[t1]}-{_TYPE_NAMES[t2]} pairs "
            "(convex hulls, collision_vec.py:510-783, and MPR) comes with "
            "the FetchPush slice"
        )
    raise NotImplementedError(
        f"narrowphase for {_TYPE_NAMES[t1]}-{_TYPE_NAMES[t2]} pairs is not "
        "ported yet (the port has plane-sphere, plane-capsule, sphere-box "
        "and capsule-box)"
    )


def contact_frame(n, t1=None):
    """Rows (normal, tan1, tan2) from normals (3, N, B) and an optional
    explicit tan1 (3, N, B), mju_makeFrame's convention: where tan1 is
    missing or not finite, the generic tangent from the normal."""
    z = torch.zeros_like(n[0])
    o = z + 1.0
    yhat = torch.stack([z, o, z])
    zhat = torch.stack([z, z, o])
    cand_y = yhat - n * n[1][None]
    cand_z = zhat - n * n[2][None]
    use_y = torch.abs(n[1]) < 0.99
    t, _ = _normalize(torch.where(use_y[None], cand_y, cand_z))
    if t1 is not None:
        ok = torch.all(torch.isfinite(t1), dim=0)
        t = torch.where(ok[None], torch.nan_to_num(t1), t)
    t2 = torch.stack([
        n[1] * t[2] - n[2] * t[1],
        n[2] * t[0] - n[0] * t[2],
        n[0] * t[1] - n[1] * t[0],
    ])
    return torch.stack([n, t, t2], dim=1)             # (3comp, 3rows, N, B)


def rows_of(res, k, S, B):
    """A primitive's (S, k, B)-shaped result -> pair-major rows: dist
    (k*S, B), pos and normal (k*S, 3, B), and the explicit tan1 (k*S, 3, B)
    or None."""
    dd, pp, nn = res[:3]

    def rows3(x):
        return x.movedim(2, 0).reshape(k * S, 3, B)

    tan = rows3(res[3]) if len(res) == 4 else None
    return dd.transpose(0, 1).reshape(k * S, B), rows3(pp), rows3(nn), tan


def frame_rows(normal, tan):
    """Frames (N, 3rows, 3comp, B) of rows with normals (N, 3, B) and
    explicit tangents (N, 3, B) or None."""
    t = None if tan is None else tan.transpose(0, 1)
    return contact_frame(normal.transpose(0, 1), t).permute(2, 1, 0, 3)


def cat_rows(groups):
    """Concatenate per-group rows_of results -> dist, pos, normal and tan
    (NaN rows for groups without one; None when no group has one)."""
    dist, pos, normal, tans = (list(x) for x in zip(*groups))
    tan = None
    if any(t is not None for t in tans):
        tan = torch.cat([torch.full_like(n, float("nan")) if t is None else t
                         for n, t in zip(normal, tans)])
    return torch.cat(dist), torch.cat(pos), torch.cat(normal), tan


def _local_aabb_half(meta: T.Meta, sizes3):
    """Per-geom local AABB half extents (ngeom, 3, Bm) for the pair-topk
    bound (collision_vec._local_aabbs :884-931): every primitive's extent
    is linear in its size components. Local centres are all zero without
    mesh geoms; plane rows are zeros (plane groups never prune)."""
    coef = np.zeros((meta.ngeom, 3, 3))
    for g, t in enumerate(meta.geom_type):
        if t == T.MESH:
            raise NotImplementedError(
                "mesh AABBs from hull tables come with the FetchPush slice")
        if t == T.SPHERE:
            coef[g, :, 0] = 1.0
        elif t == T.CAPSULE:
            coef[g, :, 0] = 1.0
            coef[g, 2, 1] = 1.0
        elif t == T.CYLINDER:
            coef[g, 0, 0] = coef[g, 1, 0] = 1.0
            coef[g, 2, 1] = 1.0
        elif t in (T.BOX, T.ELLIPSOID):
            coef[g] = np.eye(3)
    c = torch.as_tensor(coef, dtype=sizes3.dtype, device=sizes3.device)
    return torch.einsum("gij,gjb->gib", c, sizes3)


# ---------------------------------------------------------------------------
# Unpruned table (the PointMaze path)
# ---------------------------------------------------------------------------


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
        for tp in groups:
            _check_ported(*tp)
        self.groups = []
        group_base, offset = {}, 0
        for tp, entries in groups.items():
            group_base[tp] = offset
            offset += len(entries) * pair_slots(*tp)
            self.groups.append((
                PRIMITIVES[tp], pair_slots(*tp), len(entries),
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


def take_static(P, Rm, sizes3, i):
    """Operands of geoms ``i`` (k,): p (3, k, B), R (3, 3, k, B),
    s (3, k, Bm)."""
    return (P[i].transpose(0, 1), Rm[i].movedim(0, 2),
            sizes3[i].transpose(0, 1))


def _collision_static(m: T.Model, d: T.Data):
    B = d.qpos.shape[-1]
    plan = m.plan("narrow", _NarrowPlan)
    P, Rm, sizes3 = d.geom_xpos, d.geom_xmat, m.geom_size
    dist, pos, normal, tan = cat_rows([
        rows_of(fn(*take_static(P, Rm, sizes3, i1),
                   *take_static(P, Rm, sizes3, i2)), k, S, B)
        for fn, S, k, i1, i2 in plan.groups])
    pm = plan.perm
    geom1, geom2 = slot_geoms(m)
    return T.Contact(
        dist=dist[pm], pos=pos[pm],
        frame=frame_rows(normal[pm], None if tan is None else tan[pm]),
        geom1=geom1, geom2=geom2,
    )


# ---------------------------------------------------------------------------
# Pair-topk pruned table (the AntMaze path)
# ---------------------------------------------------------------------------


class _PrunedPlan:
    """Host tables of the pruned core: the merged broadphase of every pruned
    group (one rank chain over the concatenated pairs, padded to (G, maxk)
    with a mask), each group's canonical slot ids, and the megakernel's
    group table (narrowphase.GroupTable)."""

    def __init__(self, m: T.Model):
        from gymnasium_robotics_tpu_torch.physics import narrowphase as NP

        meta = m.meta
        dev = m.device
        plan = prune_plan(meta)
        for g in plan.groups:
            _check_ported(*g.tp)
        slot_base = _pair_slot_base(meta)
        pruned = [g for g in plan.groups if g.pruned]
        self.K = pruned[0].K
        maxk = max(len(g.idx) for g in pruned)
        g1c, g2c, rows, mask = [], [], [], []
        for g in pruned:
            k = len(g.idx)
            rows.append([len(g1c) + min(i, k - 1) for i in range(maxk)])
            mask.append([i < k for i in range(maxk)])
            g1c += [meta.pairs[j][0] for j in g.idx]
            g2c += [meta.pairs[j][1] for j in g.idx]
        self.i1c = torch.as_tensor(g1c, device=dev)
        self.i2c = torch.as_tensor(g2c, device=dev)
        self.rows = torch.as_tensor(rows, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        # a NaN lane selects index maxk (topk_select): clamp to each
        # group's last pair, so every gather stays in range
        self.sel_max = torch.as_tensor(
            [len(g.idx) - 1 for g in pruned], device=dev)[:, None, None]
        self.half = _local_aabb_half(meta, m.geom_size)     # (ngeom, 3, Bm)
        self.table = NP.GroupTable.build(meta, plan, dev)
        self.src_static, self.src_sel = [], []
        gi = 0
        for g in plan.groups:
            ids = slot_base[np.asarray(g.idx)][:, None] + np.arange(g.S)[None]
            ids = torch.as_tensor(ids, device=dev)          # (k, S)
            if g.pruned:
                self.src_sel.append((g.base_c, g.n_slots_c, ids, gi))
                gi += 1
            else:
                self.src_static.append((g.base_c, g.n_slots_c, ids.reshape(-1)))
        self.ncon = plan.ncon_c


def broadphase_rank(m: T.Model, d: T.Data, tp: _PrunedPlan):
    """(G, maxk, B) ranks of the pruned groups' pairs: world-AABB gap minus
    the pair's margin (collision_vec.py:1171-1191)."""
    B = d.qpos.shape[-1]
    P, Rm = d.geom_xpos, d.geom_xmat
    hw = torch.einsum("gijb,gjb->gib", torch.abs(Rm), tp.half.expand(-1, -1, B))
    i1, i2 = tp.i1c, tp.i2c
    gap = torch.amax(torch.abs(P[i1] - P[i2]) - hw[i1] - hw[i2], dim=1)
    gm = m.geom_margin
    rank = gap - (gm[i1] + gm[i2])
    return rank[tp.rows]


def _collision_pruned(m: T.Model, d: T.Data):
    from gymnasium_robotics_tpu_torch.physics import narrowphase as NP

    B = d.qpos.shape[-1]
    tp = m.plan("pruned", _PrunedPlan)
    sel = NP.topk_select(broadphase_rank(m, d, tp), tp.mask, tp.K)  # int32
    # the narrowphase clamps the picks itself; for the slot-id gather below
    # one op clamps them into each group and widens them to int64
    dist, pos, frame = NP.narrowphase(tp.table, d.geom_xpos, d.geom_xmat,
                                      m.geom_size, sel)
    sel = torch.minimum(sel, tp.sel_max)                    # (G, K, B)
    src = torch.empty((tp.ncon, B), dtype=torch.int64, device=sel.device)
    for base, n, ids in tp.src_static:
        src[base:base + n] = ids[:, None]
    for base, n, ids, gi in tp.src_sel:
        # (K, B) pair picks -> (K, S, B) slot ids, pair-major rows
        src[base:base + n] = ids[sel[gi]].transpose(1, 2).reshape(n, B)
    g1s, g2s = slot_geoms(m)
    return T.Contact(dist=dist, pos=pos, frame=frame, geom1=g1s[src],
                     geom2=g2s[src], src=src)


def collision(m: T.Model, d: T.Data) -> T.Data:
    mt = m.meta
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    n_total = ncon(m)
    pruned = prune_active(mt)

    if not mt.pairs or mt.opt.disable_contact:
        g1s, g2s = slot_geoms(m)
        src = None
        if pruned:
            src = torch.zeros((n_total, B), dtype=torch.int64,
                              device=d.qpos.device)
            g1s, g2s = g1s[src], g2s[src]
        eye = torch.eye(3, dtype=dtype, device=d.qpos.device)
        contact = T.Contact(
            dist=d.qpos.new_full((n_total, B), _BIG),
            pos=d.qpos.new_zeros((n_total, 3, B)),
            frame=eye[None, :, :, None].expand(n_total, 3, 3, B),
            geom1=g1s, geom2=g2s, src=src,
        )
        return dataclasses.replace(d, contact=contact)

    contact = _collision_pruned(m, d) if pruned else _collision_static(m, d)
    return dataclasses.replace(d, contact=contact)
