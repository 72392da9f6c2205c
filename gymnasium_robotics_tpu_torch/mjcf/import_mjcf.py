"""Host-side MJCF import: ``mujoco.MjModel`` -> the port's ``Model`` (port
of gymnasium_robotics_tpu/mjcf/import_mjcf.py :26-495, with its own copy of
physics/collision.py ``slot_params`` :595).

The MuJoCo compiler parses and compiles the MJCF once, on the host; the
compiled model is frozen into per-field numpy arrays and a static Meta,
which ``convert.model_from_numpy`` turns into tensors. The static collision
candidate table (MuJoCo's broadphase filters: contype/conaffinity, same
and parent-child weld bodies, <exclude> pairs, then the reachability and
mesh rest-penetration prunes) is resolved here, so a step has a fixed
contact layout. Mesh geoms become convex hulls (vertices and halfspace
faces) re-centred on their vertex bounds.

``mujoco`` and ``scipy`` are imported inside the functions that need them:
the card's path never imports this module, it reads the model files that
``build_locomotion`` writes (mjcf/serialize.py).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from gymnasium_robotics_tpu_torch.physics import types as T
from gymnasium_robotics_tpu_torch.physics.collision import pair_slots


def _tup(a) -> tuple:
    return tuple(int(x) for x in np.asarray(a).ravel())


def _names(m, count, adr_field):
    out = []
    raw = m.names
    for i in range(count):
        adr = getattr(m, adr_field)[i]
        end = raw.find(b"\x00", adr)
        out.append(raw[adr:end].decode())
    return tuple(out)


def _levels(parent: np.ndarray):
    depth = np.zeros(len(parent), dtype=int)
    for b in range(1, len(parent)):
        depth[b] = depth[parent[b]] + 1
    levels = []
    for d in range(depth.max() + 1 if len(parent) else 0):
        levels.append(tuple(int(b) for b in np.nonzero(depth == d)[0]))
    return tuple(levels)


def _collision_pairs(m, geom_type) -> tuple:
    """Static candidate pairs, mirroring MuJoCo's broadphase filters; each
    pair ordered with the lower geom type first."""
    pairs = []
    weld = m.body_weldid
    weld_parent = np.array([weld[m.body_parentid[b]] for b in range(m.nbody)])
    excludes = set()
    for i in range(m.nexclude):
        sig = int(m.exclude_signature[i])
        excludes.add((sig >> 16, sig & 0xFFFF))

    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
            w1, w2 = int(weld[b1]), int(weld[b2])
            if w1 == w2:
                continue
            # parent filter: skip welded parent-child unless parent is world
            wp1, wp2 = int(weld_parent[b1]), int(weld_parent[b2])
            if (w1 == wp2 and w1 != 0) or (w2 == wp1 and w2 != 0):
                continue
            ct1, ca1 = int(m.geom_contype[g1]), int(m.geom_conaffinity[g1])
            ct2, ca2 = int(m.geom_contype[g2]), int(m.geom_conaffinity[g2])
            if not ((ct1 & ca2) or (ct2 & ca1)):
                continue
            if (b1, b2) in excludes or (b2, b1) in excludes:
                continue
            if int(geom_type[g1]) > int(geom_type[g2]):
                pairs.append((g2, g1))
            else:
                pairs.append((g1, g2))
    return tuple(pairs)


HULL_V, HULL_F = 24, 44  # per-hull vertex/face budget (F <= 2V - 4)


def _convex_hull(verts: np.ndarray):
    """Convex hull of a point cloud, downsampled to <= HULL_V vertices by
    farthest-point selection: (verts (HULL_V, 3), faces (HULL_F, 4)), the
    faces as halfspaces n.x + d (positive outside; padding d = -1e10).
    Near-parallel facets merge by quantised plane equation, and past the
    budget the largest-area planes are kept."""
    from scipy.spatial import ConvexHull, QhullError

    def hull_of(pts):
        try:
            return ConvexHull(pts)
        except QhullError:
            return ConvexHull(pts, qhull_options="QJ")

    h = hull_of(verts)
    pts = verts[h.vertices]
    if len(pts) > HULL_V:
        chosen = [int(np.argmax(np.linalg.norm(pts, axis=1)))]
        d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
        for _ in range(HULL_V - 1):
            nxt = int(np.argmax(d))
            chosen.append(nxt)
            d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
        pts = pts[np.array(chosen)]
        h = hull_of(pts)
        pts = pts[h.vertices]
    eqs = np.asarray(h.equations, np.float64)  # n.x + d <= 0 inside
    tri = h.points[h.simplices]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    keys = np.round(eqs, 6)
    _, group, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    garea = np.zeros(len(group))
    np.add.at(garea, inv, areas)
    order = np.argsort(-garea)[:HULL_F]
    eqs = eqs[group[order]]
    hv = np.zeros((HULL_V, 3))
    hv[: len(pts)] = pts
    hv[len(pts):] = pts[0]
    hf = np.zeros((HULL_F, 4))
    hf[:, 3] = -1e10
    hf[: len(eqs)] = eqs
    return hv, hf


def _forward_at(m, filter_qpos):
    import mujoco

    d0 = mujoco.MjData(m)
    d0.qpos[:] = m.qpos0 if filter_qpos is None else filter_qpos
    mujoco.mj_forward(m, d0)
    return d0


def _filter_mesh_rest_penetrations(
    m, pairs, geom_type, geom_pos, geom_quat, geom_size, mesh_substituted,
    filter_qpos=None,
):
    """Drop box-box candidate pairs with a mesh-substituted geom whose boxes
    already interpenetrate at qpos0 (more than 1e-5 on every axis of the
    separating-axis test): the true meshes are contact-free there by
    design, so the overlap is an artifact of the approximation."""
    from scipy.spatial.transform import Rotation as R

    if not mesh_substituted.any():
        return pairs
    d0 = _forward_at(m, filter_qpos)

    def world_box(g):
        bid = m.geom_bodyid[g]
        Rb = d0.xmat[bid].reshape(3, 3)
        pb = d0.xpos[bid]
        rot = R.from_quat(np.array(geom_quat[g])[[1, 2, 3, 0]]).as_matrix()
        return pb + Rb @ np.array(geom_pos[g]), Rb @ rot, np.array(geom_size[g])

    def overlap(g1, g2):
        p1, R1, s1 = world_box(g1)
        p2, R2, s2 = world_box(g2)
        dvec = p2 - p1
        axes = [R1[:, i] for i in range(3)] + [R2[:, i] for i in range(3)]
        min_sep = np.inf
        for ax in axes:
            r1 = np.sum(np.abs(R1.T @ ax) * s1)
            r2 = np.sum(np.abs(R2.T @ ax) * s2)
            sep = abs(np.dot(dvec, ax)) - (r1 + r2)
            min_sep = min(min_sep, -sep)
            if sep > 0:
                return False, 0.0
        return True, min_sep

    out = []
    for g1, g2 in pairs:
        if (mesh_substituted[g1] or mesh_substituted[g2]) and (
            geom_type[g1] == T.BOX and geom_type[g2] == T.BOX
        ):
            pen, depth = overlap(g1, g2)
            if pen and depth > 1e-5:
                continue
        out.append((g1, g2))
    return tuple(out)


def _reachability_prune(m, pairs, geom_type, geom_size, filter_qpos=None):
    """Drop pairs whose geoms can never meet: each geom's reachable region
    is a sphere around its rest position whose radius adds the travel
    bounds of every joint between it and the world (slide: range span;
    hinge: span x lever arm; ball, free or unlimited: unbounded)."""
    d0 = _forward_at(m, filter_qpos)

    UNBOUNDED = 1e9
    geom_center = d0.geom_xpos.copy()

    def geom_radius(g):
        if geom_type[g] == T.PLANE:
            return UNBOUNDED
        if geom_type[g] == T.BOX:
            return float(np.linalg.norm(geom_size[g]))
        return float(m.geom_rbound[g])

    in_subtree = np.zeros((m.nbody, m.nbody), dtype=bool)
    for b in range(m.nbody):
        bb = b
        while bb >= 0:
            in_subtree[bb, b] = True
            if bb == 0:
                break
            bb = int(m.body_parentid[bb])

    travel = np.zeros(m.nbody)
    for b in range(1, m.nbody):
        t = travel[m.body_parentid[b]]
        for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
            jt = int(m.jnt_type[j])
            limited = bool(m.jnt_limited[j])
            lo, hi = m.jnt_range[j]
            if jt == T.SLIDE and limited:
                t += float(hi - lo)
            elif jt == T.HINGE and limited:
                anchor = d0.xanchor[j]
                arm = 0.1
                for g in range(m.ngeom):
                    if in_subtree[b, int(m.geom_bodyid[g])]:
                        gr = geom_radius(g)
                        if gr < 1e8:
                            arm = max(
                                arm,
                                float(np.linalg.norm(d0.geom_xpos[g] - anchor)) + gr,
                            )
                span = min(float(hi - lo), 2 * np.pi)
                t += span * arm
            else:
                t = UNBOUNDED
        travel[b] = t

    out = []
    for g1, g2 in pairs:
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        r = (
            geom_radius(g1) + geom_radius(g2)
            + travel[b1] + travel[b2] + 0.05
        )
        if r < 1e8:
            dist = float(np.linalg.norm(geom_center[g1] - geom_center[g2]))
            if dist > r:
                continue
        out.append((g1, g2))
    return tuple(out)


def slot_params(mjm, pairs, geom_type=None) -> dict:
    """Per-contact-slot parameters of the candidate pairs (MuJoCo's
    mj_contactParam mixing: the higher priority's parameters, else the
    solmix-weighted solref/solimp, elementwise-max friction and the larger
    condim; includemargin = the margins' sum less the gaps')."""
    fric, solref, solimp, margin, condim = [], [], [], [], []
    gt = np.asarray(geom_type if geom_type is not None else mjm.geom_type)
    for g1, g2 in pairs:
        p1, p2 = int(mjm.geom_priority[g1]), int(mjm.geom_priority[g2])
        k = pair_slots(int(gt[g1]), int(gt[g2]))
        if p1 != p2:
            src = g1 if p1 > p2 else g2
            f3 = mjm.geom_friction[src]
            sr, si = mjm.geom_solref[src], mjm.geom_solimp[src]
            cd = int(mjm.geom_condim[src])
        else:
            f3 = np.maximum(mjm.geom_friction[g1], mjm.geom_friction[g2])
            tot = mjm.geom_solmix[g1] + mjm.geom_solmix[g2]
            mix = mjm.geom_solmix[g1] / tot if tot > 1e-12 else 0.5
            if mjm.geom_solref[g1][0] <= 0 or mjm.geom_solref[g2][0] <= 0:
                sr = np.minimum(mjm.geom_solref[g1], mjm.geom_solref[g2])
            else:
                sr = mix * mjm.geom_solref[g1] + (1 - mix) * mjm.geom_solref[g2]
            si = mix * mjm.geom_solimp[g1] + (1 - mix) * mjm.geom_solimp[g2]
            cd = max(int(mjm.geom_condim[g1]), int(mjm.geom_condim[g2]))
        f5 = np.array([f3[0], f3[0], f3[1], f3[2], f3[2]])
        mg = (mjm.geom_margin[g1] + mjm.geom_margin[g2]) - (
            mjm.geom_gap[g1] + mjm.geom_gap[g2]
        )
        for _ in range(k):
            fric.append(f5)
            solref.append(sr)
            solimp.append(si)
            margin.append(mg)
            condim.append(cd)
    n = len(condim)
    return dict(
        friction=np.array(fric).reshape(n, 5),
        solref=np.array(solref).reshape(n, 2),
        solimp=np.array(solimp).reshape(n, 5),
        includemargin=np.array(margin).reshape(n),
        condim=tuple(condim),
    )


def meta_to_json(meta: T.Meta) -> str:
    """The Meta (with its Option) as the JSON the model files carry."""
    d = dataclasses.asdict(meta)
    d["opt"] = dataclasses.asdict(meta.opt)
    return json.dumps(d)


def import_arrays(m, dtype=np.float32, filter_qpos=None):
    """(arrays, meta_json) of a compiled mujoco.MjModel: each Model field
    as an unbatched numpy array in ``dtype`` (None where the model has no
    such table) and the Meta JSON, as convert.model_from_numpy and the
    model files take them."""
    from scipy.spatial.transform import Rotation as R

    geom_type = np.array(m.geom_type, dtype=int)
    geom_pos = np.array(m.geom_pos, dtype=dtype)
    geom_quat = np.array(m.geom_quat, dtype=dtype)
    geom_size = np.array(m.geom_size, dtype=dtype)

    # mesh geoms: the convex hull in the parent body frame, re-centred on
    # the vertex bounds (geom_quat absorbed); geom_size keeps the bounds'
    # half extents
    mesh_substituted = np.zeros(m.ngeom, dtype=bool)
    geom_hullid = np.full(m.ngeom, -1, dtype=np.int64)
    hull_verts, hull_faces = [], []
    for g in range(m.ngeom):
        if geom_type[g] == T.MESH:
            mid = m.geom_dataid[g]
            va, vn = m.mesh_vertadr[mid], m.mesh_vertnum[mid]
            verts = np.array(m.mesh_vert[va:va + vn], dtype=np.float64)
            rot = R.from_quat(np.array(geom_quat[g])[[1, 2, 3, 0]]).as_matrix()
            v_body = verts @ rot.T + np.array(geom_pos[g])
            lo, hi = v_body.min(0), v_body.max(0)
            center = (lo + hi) / 2
            geom_pos[g] = center.astype(dtype)
            geom_size[g] = np.maximum((hi - lo) / 2, 1e-4).astype(dtype)
            geom_quat[g] = np.array([1.0, 0, 0, 0], dtype=dtype)
            mesh_substituted[g] = True
            hv, hf = _convex_hull(v_body - center)
            geom_hullid[g] = len(hull_verts)
            hull_verts.append(hv)
            hull_faces.append(hf)

    opt = T.Option(
        timestep=float(m.opt.timestep),
        gravity=tuple(float(x) for x in m.opt.gravity),
        iterations=int(m.opt.iterations),
        ls_iterations=int(getattr(m.opt, "ls_iterations", 50)),
        tolerance=float(m.opt.tolerance),
        impratio=float(m.opt.impratio),
        integrator=int(m.opt.integrator),
        density=float(m.opt.density),
        viscosity=float(m.opt.viscosity),
        disable_contact=bool(m.opt.disableflags & (1 << 4)),
        disable_gravity=bool(m.opt.disableflags & (1 << 6)),
        disable_limit=bool(m.opt.disableflags & (1 << 3)),
        disable_equality=bool(m.opt.disableflags & (1 << 1)),
        disable_clampctrl=bool(m.opt.disableflags & (1 << 5)),
    )

    pairs = _collision_pairs(m, geom_type)
    pairs = _reachability_prune(m, pairs, geom_type, geom_size, filter_qpos)
    pairs = _filter_mesh_rest_penetrations(
        m, pairs, geom_type, geom_pos, geom_quat, geom_size, mesh_substituted,
        filter_qpos=filter_qpos,
    )
    slot = slot_params(m, pairs, geom_type)

    meta = T.Meta(
        nq=int(m.nq), nv=int(m.nv), nu=int(m.nu), na=int(m.na),
        nbody=int(m.nbody), njnt=int(m.njnt), ngeom=int(m.ngeom),
        nsite=int(m.nsite), neq=int(m.neq), nmocap=int(m.nmocap),
        ntendon=int(m.ntendon), nwrap=int(m.nwrap),
        nsensor=int(m.nsensor), nsensordata=int(m.nsensordata),
        opt=opt,
        body_parentid=_tup(m.body_parentid),
        body_rootid=_tup(m.body_rootid),
        body_jntadr=_tup(m.body_jntadr),
        body_jntnum=_tup(m.body_jntnum),
        body_dofadr=_tup(m.body_dofadr),
        body_dofnum=_tup(m.body_dofnum),
        body_mocapid=_tup(m.body_mocapid),
        body_weldid=_tup(m.body_weldid),
        levels=_levels(np.array(m.body_parentid)),
        jnt_type=_tup(m.jnt_type),
        jnt_qposadr=_tup(m.jnt_qposadr),
        jnt_dofadr=_tup(m.jnt_dofadr),
        jnt_bodyid=_tup(m.jnt_bodyid),
        jnt_limited=_tup(m.jnt_limited),
        jnt_actfrclimited=_tup(getattr(m, "jnt_actfrclimited", np.zeros(m.njnt))),
        dof_bodyid=_tup(m.dof_bodyid),
        dof_jntid=_tup(m.dof_jntid),
        dof_parentid=_tup(m.dof_parentid),
        geom_type=_tup(geom_type),
        geom_bodyid=_tup(m.geom_bodyid),
        geom_condim=_tup(m.geom_condim),
        geom_hullid=_tup(geom_hullid),
        geom_priority=_tup(m.geom_priority),
        site_bodyid=_tup(m.site_bodyid),
        eq_type=_tup(m.eq_type),
        eq_obj1id=_tup(m.eq_obj1id),
        eq_obj2id=_tup(m.eq_obj2id),
        eq_active0=_tup(m.eq_active0),
        actuator_trntype=_tup(m.actuator_trntype),
        actuator_trnid=_tup(m.actuator_trnid[:, 0]) if m.nu else (),
        actuator_gaintype=_tup(m.actuator_gaintype),
        actuator_biastype=_tup(m.actuator_biastype),
        actuator_dyntype=_tup(m.actuator_dyntype),
        actuator_ctrllimited=_tup(m.actuator_ctrllimited),
        actuator_forcelimited=_tup(m.actuator_forcelimited),
        actuator_actadr=_tup(m.actuator_actadr),
        actuator_actnum=_tup(m.actuator_actnum),
        tendon_adr=_tup(m.tendon_adr),
        tendon_num=_tup(m.tendon_num),
        tendon_limited=_tup(m.tendon_limited),
        wrap_objid=_tup(m.wrap_objid),
        tendon_kind=tuple(
            "spatial2"
            if (
                m.tendon_num[t] == 2
                and all(
                    m.wrap_type[w] == 3  # mjWRAP_SITE
                    for w in range(m.tendon_adr[t], m.tendon_adr[t] + 2)
                )
            )
            else "fixed"
            for t in range(m.ntendon)
        ),
        sensor_type=_tup(m.sensor_type),
        sensor_objid=_tup(m.sensor_objid),
        sensor_adr=_tup(m.sensor_adr),
        sensor_dim=_tup(m.sensor_dim),
        site_type=_tup(m.site_type),
        pairs=pairs,
        con_condim=slot["condim"],
        has_damping=bool(np.any(np.asarray(m.dof_damping) > 0)),
        body_names=_names(m, m.nbody, "name_bodyadr"),
        joint_names=_names(m, m.njnt, "name_jntadr"),
        geom_names=_names(m, m.ngeom, "name_geomadr"),
        site_names=_names(m, m.nsite, "name_siteadr"),
        actuator_names=_names(m, m.nu, "name_actuatoradr"),
        sensor_names=_names(m, m.nsensor, "name_sensoradr"),
        tendon_names=_names(m, m.ntendon, "name_tendonadr"),
    )

    fields = {
        "geom_pos": geom_pos, "geom_quat": geom_quat, "geom_size": geom_size,
        "hull_vert": np.stack(hull_verts) if hull_verts else None,
        "hull_face": np.stack(hull_faces) if hull_faces else None,
        "site_size_arr": m.site_size,
        "con_friction": slot["friction"], "con_solref": slot["solref"],
        "con_solimp": slot["solimp"],
        "con_includemargin": slot["includemargin"],
    }
    arrays = {}
    for name in T.array_fields():
        v = fields[name] if name in fields else getattr(m, name)
        arrays[name] = None if v is None else np.array(v, dtype=dtype)
    return arrays, meta_to_json(meta)


def import_model(m, dtype=np.float32, device=None, filter_qpos=None) -> T.Model:
    """The port's Model of a compiled mujoco.MjModel, its float fields
    rounded once to ``dtype`` (numpy's float32 or float64) and placed on
    ``device`` (the CUDA card unless named)."""
    import torch

    from gymnasium_robotics_tpu_torch import convert

    arrays, meta_json = import_arrays(m, dtype, filter_qpos)
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    return convert.model_from_numpy(arrays, meta_json, tdt, device)
