"""Batch-last narrowphase over the static candidate pair table.

Host tables: port of gymnasium_robotics_tpu/physics/collision.py (slot
counts, ``ncon``, the pair-topk ``prune_plan`` :102-175) and of
``collision_vec.slot_geoms_static`` :1341. Device part: the unpruned core
``collision_vec._make_narrowphase_core`` :932-1060 and the pair-topk core
``_make_narrowphase_core_pruned`` :1063-1334 (AABB gap ranking, hull-aware
per-lane gathers, per-group selection through ``narrowphase.topk_select``,
the hybrid routing :1249-1323, ``src`` and the compact group-major table),
driven like ``soa.collision`` :1018-1081. The formulas the ported slices
reach: plane-sphere :88, plane-capsule :95, plane-box :152,
plane-cylinder :163, sphere-box :221-251, sphere-capsule :213 (with
``_sphere_sphere_at`` :188), the cylinder formulas ``_point_cylinder``
:252, ``_sphere_cylinder_at`` :301, capsule-cylinder :313 and
cylinder-cylinder :332, capsule-capsule :366, capsule-box :375 (also
cylinder-box, as ``_dispatch`` :800 maps it), box-box :388-499, and the
convex-hull formulas :510-781 (plane-hull; cylinder-hull, the two
end-sphere probes of ``_make_capsule_hull`` :624; box-hull and hull-hull
with the MPR upgrade of ``physics/mpr.py``; on the unpruned table
box-hull, :999-1021), with the contact frame ``_contact_frame_soa`` :806.

Every slot reports a signed distance; slots far from touching simply carry
a large positive one. Any other geom-type pair raises
``NotImplementedError`` naming it.
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


def _dot3(a, b):
    """_dot summed in a fixed order, ((x + y) + z), as the kernel's dot_rn
    sums: the sphere, capsule and cylinder formulas take it, so that the
    capsule-cylinder search's comparisons round alike in both (torch.sum
    over the first axis of a CUDA tensor takes its own order)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _normalize(a, eps=1e-12, dot=_dot):
    n = torch.sqrt(torch.clamp(dot(a, a), min=0.0))
    return a / torch.clamp(n, min=eps)[None], n


def _matvec(R, v, dot=_dot):
    return torch.stack([dot(R[i], v) for i in range(3)])


def _matTvec(R, v, dot=_dot):
    return torch.stack([dot(R[:, i], v) for i in range(3)])


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


def _plane_cylinder(p1, R1, s1, p2, R2, s2):
    """Two rim points, one on each end cap, at the cap's deepest point
    along the plane's normal; where the axis is parallel to the normal
    (an upright cylinder) the rim point falls back to the cylinder's x
    axis. tan1 is the axis projected onto the plane, NaN where that
    vanishes."""
    n = R1[:, 2]
    axis = R2[:, 2]
    perp = n - axis * _dot(n, axis)[None]
    pn_v, nrm = _normalize(perp, 1e-12)
    rad = -pn_v * s2[0][None]
    rad = torch.where((nrm > 1e-6)[None], rad, R2[:, 0] * s2[0][None])
    pn = _dot(p1, n)
    outs_d, outs_p = [], []
    for sgn in (1.0, -1.0):
        e = p2 + axis * (sgn * s2[1])[None] + rad
        dist = _dot(e, n) - pn
        outs_d.append(dist)
        outs_p.append(e - 0.5 * dist[None] * n)
    proj = axis - n * _dot(n, axis)[None]
    t1n, tn = _normalize(proj, 1e-12)
    tan = torch.where((tn > 1e-8)[None], t1n, torch.full_like(t1n, float("nan")))
    return (torch.stack(outs_d), torch.stack(outs_p), torch.stack([n, n]),
            torch.stack([tan, tan]))


def _closest_on_seg(p, a, b):
    ab = b - a
    t = torch.clamp(
        _dot3(p - a, ab) / torch.clamp(_dot3(ab, ab), min=1e-12), 0.0, 1.0
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


_CORNER_SIGNS = np.array(
    [[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)], np.float64)


def _sign01(c, like):
    """+1 where c, else -1, in the dtype of ``like``."""
    return 2.0 * c.to(like.dtype) - 1.0


def _box_corners(p, R, s):
    """(8, 3, k, B) world-space corners."""
    outs = []
    for sg in _CORNER_SIGNS:
        off = torch.stack([sg[0] * s[0], sg[1] * s[1], sg[2] * s[2]])
        outs.append(p + _matvec(R, off.expand((3,) + p.shape[1:])))
    return torch.stack(outs)


def _take_smallest(dist, payloads, m):
    """The m smallest rows of dist (S, k, B), payload rows (S, ..., k, B)
    taken alike: m rounds of first-index argmin, each pick pushed up by
    2 * _BIG (collision_vec._take_smallest)."""
    d = dist
    iota = torch.arange(dist.shape[0], device=dist.device).view(-1, 1, 1)
    out_d, out_p = [], [[] for _ in payloads]
    for _ in range(m):
        onehot = (iota == torch.argmin(d, dim=0)[None]).to(dist.dtype)
        out_d.append(torch.sum(dist * onehot, dim=0))
        for pi, p in enumerate(payloads):
            out_p[pi].append(torch.sum(p * onehot[:, None], dim=0))
        d = d + onehot * (2.0 * _BIG)
    return torch.stack(out_d), [torch.stack(p) for p in out_p]


def _plane_box(p1, R1, s1, p2, R2, s2):
    n = R1[:, 2]
    corners = _box_corners(p2, R2, s2)                   # (8, 3, k, B)
    pn = _dot(p1, n)
    dist = torch.stack([_dot(corners[c], n) - pn for c in range(8)])
    d4, (c4,) = _take_smallest(dist, [corners], 4)
    pos = c4 - 0.5 * d4[:, None] * n[None]
    return d4, pos, n[None].expand((4,) + n.shape)


def _seg_seg_closest(a1, b1, a2, b2, dot=_dot):
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    A = dot(d1, d1)
    e = dot(d2, d2)
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = A * e - b * b
    zero = torch.zeros_like(denom)
    s = torch.where(torch.abs(denom) > 1e-12,
                    (b * f - c * e) / torch.where(denom == 0, zero + 1.0, denom),
                    zero)
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > 1e-12, (b * s + f) / torch.clamp(e, min=1e-12), zero)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp(torch.where(A > 1e-12, (b * t - c) / torch.clamp(A, min=1e-12),
                                zero), 0.0, 1.0)
    return a1 + s[None] * d1, a2 + t[None] * d2


def _sphere_sphere_at(c1, r1, c2, r2):
    """Spheres at c1 and c2: the normal from c1 to c2, +z where the
    centres coincide (within 1e-9)."""
    nrm, d0 = _normalize(c2 - c1, dot=_dot3)
    z = torch.zeros_like(d0)
    n = torch.where((d0 > 1e-9)[None], nrm, torch.stack([z, z, z + 1.0]))
    dist = d0 - r1 - r2
    pos = c1 + n * (r1 + 0.5 * dist)[None]
    return dist[None], pos[None], n[None]


def _sphere_sphere(p1, R1, s1, p2, R2, s2):
    return _sphere_sphere_at(p1, s1[0], p2, s2[0])


def _sphere_capsule(p1, R1, s1, p2, R2, s2):
    """The sphere against the closest point of the capsule's segment."""
    axis = R2[:, 2]
    c = _closest_on_seg(p1, p2 - axis * s2[1][None], p2 + axis * s2[1][None])
    return _sphere_sphere_at(p1, s1[0], c, s2[0])


def _capsule_capsule(p1, R1, s1, p2, R2, s2):
    """The two segments' closest points as spheres."""
    ax1, ax2 = R1[:, 2], R2[:, 2]
    c1, c2 = _seg_seg_closest(
        p1 - ax1 * s1[1][None], p1 + ax1 * s1[1][None],
        p2 - ax2 * s2[1][None], p2 + ax2 * s2[1][None], dot=_dot3)
    return _sphere_sphere_at(c1, s1[0], c2, s2[0])


def _point_cylinder(P, pc, Rc, s):
    """Signed distance of points P (3, k, B) to the cylinder at (pc, Rc)
    of radius s[0] and half height s[1]: (sd (k, B), the closest surface
    point (3, k, B), the outward normal there (3, k, B)). On the axis
    (rlen <= 1e-9) the radial direction is the cylinder's x axis; z = 0
    takes the +z cap."""
    q = _matTvec(Rc, P - pc, _dot3)
    z = q[2]
    rlen = torch.sqrt(torch.clamp(q[0] * q[0] + q[1] * q[1], min=0.0))
    safe = torch.clamp(rlen, min=1e-12)
    on_r = rlen > 1e-9
    one = torch.ones_like(rlen)
    rdir = (torch.where(on_r, q[0] / safe, one),
            torch.where(on_r, q[1] / safe, one - 1.0))
    dr = rlen - s[0]
    dz = torch.abs(z) - s[1]
    zsign = torch.where(z >= 0, one, -one)
    out_r, out_z = dr > 0, dz > 0
    both = out_r & out_z
    lat = torch.stack([rdir[0] * s[0], rdir[1] * s[0],
                       torch.minimum(torch.maximum(z, -s[1]), s[1])])
    rmin = torch.minimum(rlen, s[0])
    cap = torch.stack([rdir[0] * rmin, rdir[1] * rmin, zsign * s[1]])
    rim = torch.stack([rdir[0] * s[0], rdir[1] * s[0], zsign * s[1]])
    lat_wins = (dr > dz)[None]
    inter = torch.where(lat_wins, lat, cap)
    surf_loc = torch.where(both[None], rim, torch.where(
        out_r[None], lat, torch.where(out_z[None], cap, inter)))
    sd = torch.where(both, torch.sqrt(dr * dr + dz * dz), torch.where(
        out_r, dr, torch.where(out_z, dz, torch.maximum(dr, dz))))
    surf = pc + _matvec(Rc, surf_loc, _dot3)
    n_lat = _matvec(Rc, torch.stack([rdir[0], rdir[1], torch.zeros_like(z)]),
                    _dot3)
    n_cap = Rc[:, 2] * zsign[None]
    n_away, dn = _normalize(P - surf, dot=_dot3)
    n_out = torch.where(both[None], torch.where((dn > 1e-9)[None], n_away, n_lat),
                        torch.where(out_r[None], n_lat, torch.where(
                            out_z[None], n_cap, torch.where(lat_wins, n_lat, n_cap))))
    return sd, surf, n_out


def _sphere_cylinder_at(c1, r1, p2, R2, s2):
    sd, surf, n_out = _point_cylinder(c1, p2, R2, s2)
    dist = sd - r1
    n = -n_out
    pos = 0.5 * ((c1 + n * r1[None]) + surf)
    return dist[None], pos[None], n[None]


CYL_SEARCH_ROUNDS = 24


def capsule_cylinder_t(p1, R1, s1, p2, R2, s2):
    """Where along the capsule's axis (t in [-1, 1], times its half
    length) its centre line comes closest to the cylinder: a ternary
    search of CYL_SEARCH_ROUNDS rounds, each comparing the signed distance
    at two probes and keeping the side of the smaller (the left one on a
    tie), then the middle of the last interval -> t (k, B)."""
    ax = R1[:, 2]

    def sd_at(t):
        return _point_cylinder(p1 + ax * (t * s1[1])[None], p2, R2, s2)[0]

    lo = torch.full(p1.shape[1:], -1.0, dtype=p1.dtype, device=p1.device)
    hi = -lo
    # (hi - lo) / 3 an IEEE division, as the kernel's: divided by a Python
    # number, a CUDA tensor is multiplied by the number's reciprocal, and
    # a rounding's difference in the probes moves the result by up to the
    # last interval (a contact normal near a rim by 1e-3)
    three = torch.full_like(lo, 3.0)
    for _ in range(CYL_SEARCH_ROUNDS):
        m1 = lo + (hi - lo) / three
        m2 = hi - (hi - lo) / three
        go_right = sd_at(m1) > sd_at(m2)
        lo = torch.where(go_right, m1, lo)
        hi = torch.where(go_right, hi, m2)
    return 0.5 * (lo + hi)


def _capsule_cylinder(p1, R1, s1, p2, R2, s2):
    """The sphere of the capsule's radius at capsule_cylinder_t's point
    against the cylinder."""
    t = capsule_cylinder_t(p1, R1, s1, p2, R2, s2)
    c = p1 + R1[:, 2] * (t * s1[1])[None]
    return _sphere_cylinder_at(c, s1[0], p2, R2, s2)


def _cylinder_cylinder(p1, R1, s1, p2, R2, s2):
    """Each cylinder searched as a capsule against the other; the pair's
    one slot the larger distance of the two (a on b where they tie), b on
    a with its normal turned from a into b."""
    d_a, pos_a, n_a = _capsule_cylinder(p1, R1, s1, p2, R2, s2)
    d_b, pos_b, n_b = _capsule_cylinder(p2, R2, s2, p1, R1, s1)
    use_a = d_a >= d_b
    return (torch.where(use_a, d_a, d_b),
            torch.where(use_a[:, None], pos_a, pos_b),
            torch.where(use_a[:, None], n_a, -n_b))


def _verts_in_box(pa, Ra, sa, pb, Rb, sb, sign):
    """Corners of box a against box b's faces, 4 deepest: vertex-face
    contacts with normals sign * box b's outward face normal."""
    corners = _box_corners(pa, Ra, sa)                   # (8, 3, k, B)
    sbb = sb.expand(corners.shape[1:])
    iota3 = torch.arange(3, device=pa.device).view(3, 1, 1)
    dists, normals = [], []
    for c in range(8):
        loc = _matTvec(Rb, corners[c] - pb)
        face_dist = sbb - torch.abs(loc)
        pen = torch.amin(face_dist, dim=0)
        onehot = (iota3 == torch.argmin(face_dist, dim=0)[None]).to(loc.dtype)
        sgn = torch.sign(torch.sum(loc * onehot, dim=0))
        dists.append(torch.where(pen > 0, -pen, torch.full_like(pen, _BIG)))
        normals.append(sign * _matvec(Rb, onehot * sgn[None]))
    d4, (c4, n4) = _take_smallest(torch.stack(dists),
                                  [corners, torch.stack(normals)], 4)
    depth = torch.where(d4 < 0, d4, torch.zeros_like(d4))
    return d4, c4 - 0.5 * depth[:, None] * n4, n4


def _box_box_edge(p1, R1, s1, p2, R2, s2):
    """Edge-edge contact: SAT over the 9 edge cross axes picks the least
    penetrating edge pair, the contact point is the midpoint of the two
    supporting edges' closest points, and the slot exists only where an
    edge axis separates no less than every face axis."""
    d12 = p2 - p1
    s1b = s1.expand((3,) + d12.shape[1:])
    s2b = s2.expand((3,) + d12.shape[1:])

    def support(R, sb, a):
        return sum(torch.abs(_dot(a, R[:, k])) * sb[k] for k in range(3))

    face_sep = None
    for R in (R1, R2):
        for k in range(3):
            a = R[:, k]
            sep = torch.abs(_dot(a, d12)) - (support(R1, s1b, a) + support(R2, s2b, a))
            face_sep = sep if face_sep is None else torch.maximum(face_sep, sep)

    best = None
    for i in range(3):
        e1 = R1[:, i]
        for j in range(3):
            e2 = R2[:, j]
            a, alen = _normalize(_cross(e1, e2), 1e-12)
            a = a * _sign01(_dot(a, d12) >= 0, a)[None]   # from box1 into box2
            sep = _dot(a, d12) - (support(R1, s1b, a) + support(R2, s2b, a))
            sep = torch.where(alen > 1e-6, sep, torch.full_like(sep, -_BIG))
            # supporting edge centres (zero-sign components stay centred)
            c1 = p1
            for k in range(3):
                if k != i:
                    c1 = c1 + R1[:, k] * (torch.sign(_dot(a, R1[:, k])) * s1b[k])[None]
            c2 = p2
            for k in range(3):
                if k != j:
                    c2 = c2 - R2[:, k] * (torch.sign(_dot(a, R2[:, k])) * s2b[k])[None]
            q1, q2 = _seg_seg_closest(
                c1 - e1 * s1b[i][None], c1 + e1 * s1b[i][None],
                c2 - e2 * s2b[j][None], c2 + e2 * s2b[j][None])
            cand = (sep, 0.5 * (q1 + q2), a)
            if best is None:
                best = cand
            else:
                take = cand[0] > best[0]
                best = (torch.where(take, cand[0], best[0]),
                        torch.where(take[None], cand[1], best[1]),
                        torch.where(take[None], cand[2], best[2]))
    sep, pos, n = best
    big = torch.full_like(sep, _BIG)
    dist = torch.where(sep >= face_sep, sep, big)
    dist = torch.where(sep <= -_BIG / 2, big, dist)
    return dist[None], pos[None], n[None]


def _box_box(p1, R1, s1, p2, R2, s2):
    """Vertex-face contacts both ways, 4 deepest each, then the edge-edge
    slot: 9 slots (collision_vec._box_box)."""
    outs = (_verts_in_box(p2, R2, s2, p1, R1, s1, 1.0),
            _verts_in_box(p1, R1, s1, p2, R2, s2, -1.0),
            _box_box_edge(p1, R1, s1, p2, R2, s2))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# Convex hulls (mesh geoms): static-feature SAT over the hull tables. Per
# pair: vertices hv (V, 3, k, Bm) in the hull's geom frame, face normals fn
# (F, 3, k, Bm) and offsets fd (F, k, Bm), signed distance n.x + d (padding
# faces have d = -1e10 and never win the max; padding vertices repeat a real
# one). Bm is 1 for a static group and B where each lane gathered its hull.
# ---------------------------------------------------------------------------


def _point_hull_depth(x_l, fn, fd):
    """Deepest-face signed distance of a point (hull frame) and that face's
    local normal (collision_vec._point_hull_depth, first-index argmax)."""
    dists = torch.sum(fn * x_l[None], dim=1) + fd           # (F, k, B)
    iota = torch.arange(dists.shape[0], device=dists.device).view(-1, 1, 1)
    onehot = (iota == torch.argmax(dists, dim=0)[None]).to(x_l.dtype)
    return torch.sum(dists * onehot, dim=0), torch.sum(fn * onehot[:, None], dim=0)


def _rot_many(R, v, transpose=False):
    """R (3, 3, k, B) applied to many vectors v (V, 3, k, B) (or R^T)."""
    rows = []
    for i in range(3):
        a, b, c = R[:, i] if transpose else R[i]
        rows.append(a[None] * v[:, 0] + b[None] * v[:, 1] + c[None] * v[:, 2])
    return torch.stack(rows, dim=1)


def _hull_world_verts(p, R, hv):
    """World-space hull vertices (V, 3, k, B)."""
    c0, c1, c2 = hv[:, 0], hv[:, 1], hv[:, 2]               # (V, k, Bm)
    return torch.stack([
        p[i][None] + (R[i, 0][None] * c0 + R[i, 1][None] * c1 + R[i, 2][None] * c2)
        for i in range(3)], dim=1)


def _points_hull_depth_max(xl, fn, fd):
    """Deepest-face signed distance of many points xl (V, 3, k, B), hull
    frame -> (V, k, B). (The reference takes the max over face chunks of
    16; the max is exact, so one pass gives the same values.)"""
    dc = (xl[:, None, 0] * fn[None, :, 0] + xl[:, None, 1] * fn[None, :, 1]
          + xl[:, None, 2] * fn[None, :, 2] + fd[None])     # (V, F, k, B)
    return torch.amax(dc, dim=1)


def _verts_world_vs_hull(w, ph, Rh, fn, fd, sign, m_out):
    """The m_out deepest of world points w (V, 3, k, B) against a hull at
    (ph, Rh): dist (m, k, B), pos and normal (m, 3, k, B), the normal sign *
    the hull's outward one."""
    xl = _rot_many(Rh, w - ph[None], transpose=True)
    best = _points_hull_depth_max(xl, fn, fd)
    d_m, (w_m, xl_m) = _take_smallest(best, [w, xl], m_out)
    n = torch.stack([sign * _matvec(Rh, _point_hull_depth(xl_m[i], fn, fd)[1])
                     for i in range(m_out)])
    return d_m, w_m - 0.5 * d_m[:, None] * n, n


def _make_plane_hull(hv):
    def f(p1, R1, s1, p2, R2, s2):
        n = R1[:, 2]
        pn = _dot(p1, n)
        w = _hull_world_verts(p2, R2, hv)                    # (V, 3, k, B)
        d = torch.sum(w * n[None], dim=1) - pn[None]         # (V, k, B)
        d4, (c4,) = _take_smallest(d, [w], 4)
        pos = c4 - 0.5 * d4[:, None] * n[None]
        return d4, pos, n[None].expand((4,) + n.shape)

    return f


def _corner_table(s):
    """(8, 3, k, Bm) box corners in the box frame, from per-component
    scalar signs."""
    return torch.stack([torch.stack([float(sg[j]) * s[j] for j in range(3)])
                        for sg in _CORNER_SIGNS])


def _mpr_upgrade(dA, pA, nA, p1, R1, hv1, p2, R2, hv2):
    """Slot 0 of dA/pA/nA replaced by MPR's answer where MPR confirms a
    deeper penetration (edge-edge features the face-SAT probes miss)."""
    from gymnasium_robotics_tpu_torch.physics import mpr

    dep, n_m, pos_m, okm = mpr.penetration(p1, R1, hv1, p2, R2, hv2)
    dm = -dep
    use = okm & (dm < dA[0])
    return (torch.cat([torch.where(use, dm, dA[0])[None], dA[1:]]),
            torch.cat([torch.where(use[None], pos_m, pA[0])[None], pA[1:]]),
            torch.cat([torch.where(use[None], n_m, nA[0])[None], nA[1:]]))


def _sphere_hull_probe(c, r, p2, R2, fn, fd):
    """One contact of a sphere (centre c, radius r) against a hull posed
    at (p2, R2): the deepest face's signed distance minus r, the normal
    from the sphere into the hull."""
    best, n_l = _point_hull_depth(_matTvec(R2, c - p2), fn, fd)
    dist = best - r
    n = -_matvec(R2, n_l)
    pos = c + n * (r + 0.5 * dist)[None]
    return dist[None], pos[None], n[None]


def _make_capsule_hull(hull):
    """Capsule or cylinder (geom1) vs hull (geom2): two sphere probes of
    radius s1[0] at -s1[1] and +s1[1] along the axis, each against the
    hull's face planes (collision_vec._make_capsule_hull, which
    _mesh_group_fn calls for both types)."""
    fn, fd = hull

    def f(p1, R1, s1, p2, R2, s2):
        ax = R1[:, 2]
        outs = [_sphere_hull_probe(p1 + ax * (t * s1[1])[None], s1[0], p2, R2,
                                   fn, fd) for t in (-1.0, 1.0)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    return f


def _make_box_hull(hull):
    """Box (geom1) vs hull (geom2): box corners against the hull's faces
    (4 deepest) and hull vertices inside the box (4 deepest, penetrating
    only), with the MPR upgrade of the corner slot 0."""
    (fn, fd), hv = hull

    def f(p1, R1, s1, p2, R2, s2):
        corners = _corner_table(s1)                          # (8, 3, k, Bm)
        cw = torch.stack([
            p1[i][None] + R1[i, 0][None] * corners[:, 0]
            + R1[i, 1][None] * corners[:, 1] + R1[i, 2][None] * corners[:, 2]
            for i in range(3)], dim=1)                       # (8, 3, k, B)
        dA, pA, nA = _verts_world_vs_hull(cw, p2, R2, fn, fd, -1.0, 4)
        w = _hull_world_verts(p2, R2, hv)
        loc = _rot_many(R1, w - p1[None], transpose=True)
        face_dist = s1[None].expand(loc.shape) - torch.abs(loc)  # (V, 3, k, B)
        pen = torch.amin(face_dist, dim=1)
        iota3 = torch.arange(3, device=loc.device).view(1, 3, 1, 1)
        onehot = (iota3 == torch.argmin(face_dist, dim=1)[:, None]).to(loc.dtype)
        sgn = torch.sign(torch.sum(loc * onehot, dim=1))
        n_w = _rot_many(R1, onehot * sgn[:, None])           # box outward
        dB0 = torch.where(pen > 0, -pen, torch.full_like(pen, _BIG))
        dB, (pB, nB) = _take_smallest(dB0, [w, n_w], 4)
        dA, pA, nA = _mpr_upgrade(dA, pA, nA, p1, R1, corners, p2, R2, hv)
        return torch.cat([dA, dB]), torch.cat([pA, pB]), torch.cat([nA, nB])

    return f


def _make_hull_hull(hull1, hull2):
    """Hull-hull: each hull's vertices against the other's faces, 2 deepest
    each way, with the MPR upgrade of slot 0."""
    (fn1, fd1), hv1 = hull1
    (fn2, fd2), hv2 = hull2

    def f(p1, R1, s1, p2, R2, s2):
        w1 = _hull_world_verts(p1, R1, hv1)
        dA, pA, nA = _verts_world_vs_hull(w1, p2, R2, fn2, fd2, -1.0, 2)
        w2 = _hull_world_verts(p2, R2, hv2)
        dB, pB, nB = _verts_world_vs_hull(w2, p1, R1, fn1, fd1, 1.0, 2)
        dA, pA, nA = _mpr_upgrade(dA, pA, nA, p1, R1, hv1, p2, R2, hv2)
        return torch.cat([dA, dB]), torch.cat([pA, pB]), torch.cat([nA, nB])

    return f


PRIMITIVES = {
    (T.PLANE, T.SPHERE): _plane_sphere,
    (T.PLANE, T.CAPSULE): _plane_capsule,
    (T.PLANE, T.BOX): _plane_box,
    (T.PLANE, T.CYLINDER): _plane_cylinder,
    (T.SPHERE, T.SPHERE): _sphere_sphere,
    (T.SPHERE, T.BOX): _sphere_box,
    (T.CAPSULE, T.BOX): _capsule_box,
    (T.CYLINDER, T.BOX): _capsule_box,
    (T.BOX, T.BOX): _box_box,
    (T.SPHERE, T.CAPSULE): _sphere_capsule,
    (T.CAPSULE, T.CAPSULE): _capsule_capsule,
    (T.CAPSULE, T.CYLINDER): _capsule_cylinder,
    (T.CYLINDER, T.CYLINDER): _cylinder_cylinder,
}
# hull groups by their first geom's type; box and mesh run with MPR
HULL_GROUPS = (T.PLANE, T.CAPSULE, T.CYLINDER, T.BOX, T.MESH)


# the slice that brings each hull group the port does not have: on any
# table, and (capsule-hull) on the unpruned table
_HULL_FAMILY = {
    (T.SPHERE, T.MESH): "the first family that has sphere-hull pairs",
    (T.ELLIPSOID, T.MESH): "the HandManipulateEgg slice",
}
_UNPRUNED_FAMILY = {(T.CAPSULE, T.MESH): "the HandManipulatePen slice"}


def use_mpr(meta: T.Meta) -> bool:
    """Option.mpr gate (collision_vec.use_mpr_xla): on unless set False."""
    v = meta.opt.mpr
    return v is True or v in ("force", "auto")


def _check_ported(meta: T.Meta, t1, t2):
    if (t1, t2) in PRIMITIVES:
        return
    name = f"{_TYPE_NAMES[t1]}-{_TYPE_NAMES[t2]}"
    if t2 == T.MESH and t1 in HULL_GROUPS:
        if t1 in (T.PLANE, T.CAPSULE, T.CYLINDER) or use_mpr(meta):
            return
        raise NotImplementedError(
            f"{name} pairs with Option.mpr=False run face-SAT inside the "
            "narrowphase kernel, which is not ported yet (ROADMAP B4)")
    if T.MESH in (t1, t2):
        raise NotImplementedError(
            f"narrowphase for {name} pairs (convex hulls) is not ported yet: "
            f"it comes with {_HULL_FAMILY.get((t1, t2), 'ROADMAP B4')}")
    raise NotImplementedError(
        f"narrowphase for {name} pairs is not ported yet (the port has "
        "plane-sphere, plane-capsule, plane-box, plane-cylinder, sphere-sphere, "
        "sphere-box, sphere-capsule, capsule-capsule, capsule-box, capsule-cylinder, "
        "cylinder-box, cylinder-cylinder, box-box and plane, capsule, "
        "cylinder, box and mesh against convex hulls)")


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


def _local_aabb_half(meta: T.Meta, sizes3, hull_vert=None):
    """Per-geom local AABB half extents (ngeom, 3, Bm) for the pair-topk
    bound (collision_vec._local_aabbs :884-931): every primitive's extent
    is linear in its size components; a mesh geom takes its hull's vertex
    bounds; plane rows are zeros (plane groups never prune)."""
    coef = np.zeros((meta.ngeom, 3, 3))
    for g, t in enumerate(meta.geom_type):
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
    half = torch.einsum("gij,gjb->gib", c, sizes3)
    bounds = _hull_bounds(meta, hull_vert)
    if bounds is None:
        return half
    mesh, _, half_h = bounds
    return torch.where(mesh, half_h.expand(half.shape), half)


def _hull_bounds(meta: T.Meta, hull_vert):
    """(mesh mask (ngeom, 1, 1), centre, half extents (ngeom, 3, 1)) of
    each geom's hull vertex bounds, or None without mesh geoms."""
    is_mesh = [t == T.MESH for t in meta.geom_type]
    if not any(is_mesh):
        return None
    if hull_vert is None:
        raise ValueError("the model has mesh geoms but no hull tables")
    lo, hi = torch.amin(hull_vert, dim=1), torch.amax(hull_vert, dim=1)
    hid = torch.as_tensor([max(h, 0) for h in meta.geom_hullid],
                          device=hull_vert.device)
    mesh = torch.as_tensor(is_mesh, device=hull_vert.device)[:, None, None]
    return mesh, ((lo + hi) * 0.5)[hid][..., None], ((hi - lo) * 0.5)[hid][..., None]


def _local_aabb_ctr(meta: T.Meta, hull_vert):
    """Per-geom local AABB centres (ngeom, 3, 1): the hull bounds' centre
    for mesh geoms, zero elsewhere; None without mesh geoms."""
    bounds = _hull_bounds(meta, hull_vert)
    if bounds is None:
        return None
    mesh, ctr, _ = bounds
    return torch.where(mesh, ctr, torch.zeros_like(ctr))


# ---------------------------------------------------------------------------
# Unpruned table (the PointMaze and HandManipulateBlock paths)
# ---------------------------------------------------------------------------


class _NarrowPlan:
    """Pair groups by type pair, with device index tensors (and a box-hull
    group's static hull operands), and the static permutation from
    group-major to canonical pair-major slot order."""

    def __init__(self, m: T.Model):
        meta = m.meta
        dev = m.device
        groups: dict = {}
        for g1, g2 in meta.pairs:
            tp = (meta.geom_type[g1], meta.geom_type[g2])
            groups.setdefault(tp, []).append((g1, g2))
        for tp in groups:
            _check_ported(meta, *tp)
            if tp not in PRIMITIVES and tp != (T.BOX, T.MESH):
                brings = _UNPRUNED_FAMILY.get(
                    tp, "the first family that has them (no shipped one does)")
                raise NotImplementedError(
                    f"{_TYPE_NAMES[tp[0]]}-{_TYPE_NAMES[tp[1]]} pairs without "
                    f"pair_topk come with {brings}; the unpruned table has "
                    "box-hull")
        self.groups = []
        group_base, offset = {}, 0
        for tp, entries in groups.items():
            group_base[tp] = offset
            offset += len(entries) * pair_slots(*tp)
            g1 = torch.as_tensor([e[0] for e in entries], device=dev)
            g2 = torch.as_tensor([e[1] for e in entries], device=dev)
            if tp == (T.BOX, T.MESH):
                # the hulls' tables as (.., k, 1) operands
                # (collision_vec._make_narrowphase_core :977-987, MPR on)
                hid = torch.as_tensor([meta.geom_hullid[e[1]] for e in entries],
                                      device=dev)
                hull = take_hull(m.hull_vert, m.hull_face, hid[:, None])
                fn = _make_box_hull(hull)
            else:
                fn = PRIMITIVES[tp]
            self.groups.append((fn, pair_slots(*tp), len(entries), g1, g2))
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


def take_sel(P, Rm, sizes3, gid):
    """Per-lane operands of geoms ``gid`` (K, B): p (3, K, B),
    R (3, 3, K, B), s (3, K, B)."""
    lane = torch.arange(gid.shape[1], device=gid.device)
    p = P[gid, :, lane].permute(2, 0, 1)
    R = Rm[gid, :, :, lane].permute(2, 3, 0, 1)
    s = sizes3.expand(-1, -1, gid.shape[1])[gid, :, lane].permute(2, 0, 1)
    return p, R, s


def take_hull(hull_vert, hull_face, hid):
    """Per-lane hull operands ((fn, fd), hv) of hull ids ``hid`` (K, B)
    from the tables hull_vert (nhull, V, 3) and hull_face (nhull, F, 4):
    fn (F, 3, K, B), fd (F, K, B), hv (V, 3, K, B)."""
    hv, hf = hull_vert[hid], hull_face[hid]
    return ((hf[..., :3].permute(2, 3, 0, 1), hf[..., 3].permute(2, 0, 1)),
            hv.permute(2, 3, 0, 1))


def mesh_group_fn(t1, hull1, hull2):
    """The formula of a box-hull or hull-hull group, the groups that run
    outside the narrowphase kernel, on hull operands
    (collision_vec._mesh_group_fn with MPR)."""
    if t1 == T.BOX:
        return _make_box_hull(hull2)
    return _make_hull_hull(hull1, hull2)


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
# Pair-topk pruned table (the AntMaze and Fetch paths)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _HullRun:
    """Consecutive pruned groups of one hull formula that run outside the
    narrowphase kernel (box-hull and hull-hull with MPR): their pair lists,
    hull ids and rows of ``sel``, and the compact rows [row0, row0 + k * S)
    they fill."""

    tp: tuple
    S: int
    row0: int
    k: int
    members: list      # of (sel row, g1 (n,), g2 (n,), hull1 (n,), hull2 (n,), k)


class _PrunedPlan:
    """Host tables of the pruned core: the merged broadphase of every pruned
    group (one rank chain over the concatenated pairs, padded to (G, maxk)
    with a mask), each group's canonical slot ids, the narrowphase kernel's
    group table (narrowphase.GroupTable) and the hull groups that run
    outside it."""

    def __init__(self, m: T.Model):
        from gymnasium_robotics_tpu_torch.physics import narrowphase as NP

        meta = m.meta
        dev = m.device
        plan = prune_plan(meta)
        for g in plan.groups:
            _check_ported(meta, *g.tp)
            if g.tp not in NP.KINDS and T.MESH not in g.tp:
                raise NotImplementedError(
                    f"{_TYPE_NAMES[g.tp[0]]}-{_TYPE_NAMES[g.tp[1]]} pairs on a "
                    "pair-topk table need their kind in the narrowphase "
                    "kernel, which is not ported yet (ROADMAP B4); the "
                    "unpruned table has them")
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
        self.half = _local_aabb_half(meta, m.geom_size, m.hull_vert)
        self.ctr = _local_aabb_ctr(meta, m.hull_vert)
        self.table = NP.GroupTable.build(meta, plan, dev)
        self.src_static, self.src_sel, self.runs = [], [], []
        gi = 0
        for g in plan.groups:
            ids = slot_base[np.asarray(g.idx)][:, None] + np.arange(g.S)[None]
            ids = torch.as_tensor(ids, device=dev)          # (k, S)
            srow = gi if g.pruned else -1
            if g.pruned:
                self.src_sel.append((g.base_c, g.n_slots_c, ids, gi))
                gi += 1
            else:
                self.src_static.append((g.base_c, g.n_slots_c, ids.reshape(-1)))
            if g.tp not in NP.KINDS:
                self._add_hull_group(meta, g, srow, dev)
        self.ncon = plan.ncon_c

    def _add_hull_group(self, meta, g, srow, dev):
        if srow < 0:
            raise NotImplementedError(
                f"{_TYPE_NAMES[g.tp[0]]}-{_TYPE_NAMES[g.tp[1]]} groups of at "
                "most pair_topk pairs (not pruned) are not ported yet")

        def ix(geoms):
            return torch.as_tensor(geoms, device=dev)

        g1 = [meta.pairs[j][0] for j in g.idx]
        g2 = [meta.pairs[j][1] for j in g.idx]
        hull1 = ix([meta.geom_hullid[x] for x in g1]) if g.tp[0] == T.MESH else None
        member = (srow, ix(g1), ix(g2), hull1,
                  ix([meta.geom_hullid[x] for x in g2]), g.K)
        last = self.runs[-1] if self.runs else None
        if (last is not None and last.tp == g.tp
                and last.row0 + last.k * last.S == g.base_c):
            last.members.append(member)
            last.k += g.K
        else:
            self.runs.append(_HullRun(g.tp, g.S, g.base_c, g.K, [member]))


def broadphase_rank(m: T.Model, d: T.Data, tp: _PrunedPlan):
    """(G, maxk, B) ranks of the pruned groups' pairs: world-AABB gap minus
    the pair's margin (collision_vec.py:1171-1191)."""
    B = d.qpos.shape[-1]
    P, Rm = d.geom_xpos, d.geom_xmat
    hw = torch.einsum("gijb,gjb->gib", torch.abs(Rm), tp.half.expand(-1, -1, B))
    if tp.ctr is not None:
        P = P + torch.einsum("gijb,gjb->gib", Rm, tp.ctr.expand(-1, -1, B))
    i1, i2 = tp.i1c, tp.i2c
    gap = torch.amax(torch.abs(P[i1] - P[i2]) - hw[i1] - hw[i2], dim=1)
    gm = m.geom_margin
    rank = gap - (gm[i1] + gm[i2])
    return rank[tp.rows]


def _cat_pairs(trees):
    """Operand trees (nested tuples of tensors, or None) of several groups
    concatenated leaf by leaf along the pair axis, second to last."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], tuple):
        return tuple(_cat_pairs(leaves) for leaves in zip(*trees))
    return torch.cat(trees, dim=-2)


def _run_hull_groups(m: T.Model, d: T.Data, run: _HullRun, sel, out):
    """One run of hull groups as plain PyTorch (on the card, where the
    reference runs these formulas as XLA ops): operands of every member
    concatenated along the pair axis, one formula call, rows written into
    the compact table ``out`` in place."""
    P, Rm, sizes3 = d.geom_xpos, d.geom_xmat, m.geom_size
    B = P.shape[-1]
    ops = []
    for srow, g1, g2, h1, h2, _ in run.members:
        pick = sel[srow]                                      # (K, B)
        ops.append(((*take_sel(P, Rm, sizes3, g1[pick]),
                     *take_sel(P, Rm, sizes3, g2[pick])),
                    None if h1 is None else take_hull(m.hull_vert, m.hull_face,
                                                      h1[pick]),
                    take_hull(m.hull_vert, m.hull_face, h2[pick])))
    o, h1, h2 = _cat_pairs(ops)
    fn = mesh_group_fn(run.tp[0], h1, h2)
    dist, pos, normal, _ = rows_of(fn(*o), run.k, run.S, B)
    r0, r1 = run.row0, run.row0 + run.k * run.S
    out[0][r0:r1] = dist
    out[1][r0:r1] = pos
    out[2][r0:r1] = frame_rows(normal, None)


def _collision_pruned(m: T.Model, d: T.Data):
    from gymnasium_robotics_tpu_torch.physics import narrowphase as NP

    P = d.geom_xpos
    B = P.shape[-1]
    tp = m.plan("pruned", _PrunedPlan)
    sel = NP.topk_select(broadphase_rank(m, d, tp), tp.mask, tp.K)  # int32
    n = tp.ncon
    out = (P.new_empty((n, B)), P.new_empty((n, 3, B)), P.new_empty((n, 3, 3, B)))
    # the kernel writes its groups' rows and clamps the picks itself; the
    # hull groups fill theirs below. For the gathers one op clamps the
    # picks into each group and widens them to int64
    NP.narrowphase(tp.table, P, d.geom_xmat, m.geom_size, sel, m.hull_vert,
                   m.hull_face, out=out)
    sel = torch.minimum(sel, tp.sel_max)                    # (G, K, B)
    for run in tp.runs:
        _run_hull_groups(m, d, run, sel, out)
    src = torch.empty((n, B), dtype=torch.int64, device=sel.device)
    for base, k, ids in tp.src_static:
        src[base:base + k] = ids[:, None]
    for base, k, ids, gi in tp.src_sel:
        # (K, B) pair picks -> (K, S, B) slot ids, pair-major rows
        src[base:base + k] = ids[sel[gi]].transpose(1, 2).reshape(k, B)
    g1s, g2s = slot_geoms(m)
    return T.Contact(dist=out[0], pos=out[1], frame=out[2], geom1=g1s[src],
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
