"""Batch-last smooth dynamics (port of gymnasium_robotics_tpu/physics/soa.py
:206-391 jump FK, the FK routing of ``kinematics`` :392-411, com_pos :572,
com_vel :642, crb :661, rne :681, tendon :713, transmission :787,
fwd_actuation :837, fwd_passive :923, _inertia_box_fluid :953).

Each stage takes and returns a batch-last ``Data``. Static index tables and
the 0/1 tree matrices are built once per model (``Model.plan``) on the
model's device. Fixed tendons and their springs and the inertia-box fluid
model (soa._inertia_box_fluid :953) and site-to-site spatial tendons are
ported; stages a later slice brings (tendon and free/ball actuation,
activation dynamics) raise ``NotImplementedError`` when a model needs
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import kernels
from gymnasium_robotics_tpu_torch.physics import kinematics as KIN
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.physics import types as T


def _ix(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)


class _JumpPlan:
    """Pointer-jumping FK tables: joint rounds over all bodies at once and
    2^k-ancestor tables (port of soa._JumpPlan)."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev = m.device
        nb = mt.nbody
        parent = np.array(mt.body_parentid)
        ok = nb > 1
        for b in range(nb):
            adr, num = mt.body_jntadr[b], mt.body_jntnum[b]
            for j in range(adr, adr + num):
                if mt.jnt_type[j] not in (T.FREE, T.BALL, T.SLIDE, T.HINGE):
                    ok = False
                if mt.jnt_type[j] == T.FREE and parent[b] != 0:
                    ok = False
            if mt.body_mocapid[b] >= 0 and parent[b] != 0:
                ok = False
        # a free joint or a mocap body below the root takes the level pass
        self.ok = ok
        if not ok:
            return
        self.ancs = []
        anc = parent.copy()
        while anc.any():
            self.ancs.append(_ix(anc, dev))
            anc = anc[anc]
        maxr = max((mt.body_jntnum[b] for b in range(nb)), default=0)
        self.rounds = []
        for r in range(maxr):
            groups: dict = {}
            for b in range(nb):
                if mt.body_jntnum[b] <= r:
                    continue
                j = mt.body_jntadr[b] + r
                jt = mt.jnt_type[j]
                g = groups.setdefault(
                    jt, {"li": [], "jids": [], "qadr": [], "qidx": []}
                )
                g["li"].append(b)
                g["jids"].append(j)
                qa = mt.jnt_qposadr[j]
                g["qadr"].append(qa)
                width = 7 if jt == T.FREE else 4
                g["qidx"].append([qa + i for i in range(width)])
            self.rounds.append({
                jt: {k: _ix(v, dev) for k, v in g.items()}
                for jt, g in groups.items()
            })
        mids = [(b, mt.body_mocapid[b]) for b in range(nb)
                if mt.body_mocapid[b] >= 0]
        self.mocap_bodies = _ix([b for b, _ in mids], dev)
        self.mocap_ids = _ix([i for _, i in mids], dev)
        self.jnt_parent = _ix(
            parent[np.array(mt.jnt_bodyid, dtype=np.int64)] if mt.njnt else [],
            dev,
        )
        self.geom_body = _ix(mt.geom_bodyid, dev)
        self.site_body = _ix(mt.site_bodyid, dev)


def kinematics(m: T.Model, d: T.Data) -> T.Data:
    """Forward kinematics, routed as soa.kinematics routes it: the FK kernel
    (kinematics.kinematics) when ``Option.fk_kernel`` is True or "force",
    or "auto" on a CUDA tensor (the card in the TPU's place); else the
    pointer-jumping pass (``Option.fk_jump``, on by default) where the tree
    allows it; else the level pass (kinematics.kinematics_plain). On CUDA
    tensors the kernel's wrapper is called whatever the model, so a model
    it does not support raises there; on CPU tensors such a model takes
    the other passes, as soa.kinematics does off the TPU."""
    opt = m.meta.opt
    fk = opt.fk_kernel
    if fk is True or fk == "force" or (fk == "auto" and d.qpos.is_cuda):
        if kernels.on_card((d.qpos,)) or KIN.supported(m):
            return KIN.kinematics(m, d)
    fj = opt.fk_jump
    if (fj is True or fj in ("force", "auto")) and m.plan("jump", _JumpPlan).ok:
        return kinematics_jump(m, d)
    return KIN.kinematics_plain(m, d)


def kinematics_jump(m: T.Model, d: T.Data) -> T.Data:
    """Pointer-jumping forward kinematics (soa._kinematics_jump): local
    transforms of all bodies in one pass, then world poses by ancestor
    doubling. Writes in place into freshly made tensors."""
    mt = m.meta
    B = d.qpos.shape[-1]
    plan = m.plan("jump", _JumpPlan)
    z3 = d.qpos.new_zeros((mt.njnt, 3, B))

    pos = M.bB(m.body_pos, B).clone()
    quat = M.bB(m.body_quat, B).clone()
    anchor_l = z3.clone()
    axis_l = z3.clone()
    for groups in plan.rounds:
        for jt, g in groups.items():
            li, jids = g["li"], g["jids"]
            jax_ = M.bB(m.jnt_axis[jids], B)
            if jt == T.FREE:
                q7 = d.qpos[g["qidx"]]                      # (k, 7, B)
                fquat, _ = M.normalize(q7[:, 3:7])
                pos[li] = q7[:, :3]
                quat[li] = fquat
                anchor_l[jids] = q7[:, :3]
                axis_l[jids] = M.quat_rot(fquat, jax_)
            elif jt == T.BALL:
                q4, _ = M.normalize(d.qpos[g["qidx"]])      # (k, 4, B)
                jp = M.bB(m.jnt_pos[jids], B)
                anc = pos[li] + M.quat_rot(quat[li], jp)
                nquat = M.quat_mul(quat[li], q4)
                quat[li] = nquat
                pos[li] = anc - M.quat_rot(nquat, jp)
                anchor_l[jids] = anc
                axis_l[jids] = M.quat_rot(nquat, jax_)
            elif jt == T.SLIDE:
                qa = g["qadr"]
                qv = d.qpos[qa] - m.qpos0[qa]               # (k, B)
                ax = M.quat_rot(quat[li], jax_)
                npos = pos[li] + ax * qv[:, None, :]
                anchor_l[jids] = npos + M.quat_rot(
                    quat[li], M.bB(m.jnt_pos[jids], B)
                )
                pos[li] = npos
                axis_l[jids] = ax
            else:  # HINGE
                qa = g["qadr"]
                qv = d.qpos[qa] - m.qpos0[qa]
                jp = M.bB(m.jnt_pos[jids], B)
                ax_w = M.quat_rot(quat[li], jax_)
                anc = pos[li] + M.quat_rot(quat[li], jp)
                nquat = M.quat_mul(quat[li], M.axis_angle_to_quat(jax_, qv))
                quat[li] = nquat
                pos[li] = anc - M.quat_rot(nquat, jp)
                anchor_l[jids] = anc
                axis_l[jids] = ax_w
    if len(plan.mocap_bodies):
        mq, _ = M.normalize(d.mocap_quat[plan.mocap_ids])
        pos[plan.mocap_bodies] = d.mocap_pos[plan.mocap_ids]
        quat[plan.mocap_bodies] = mq

    for ai in plan.ancs:
        pos = pos[ai] + M.quat_rot(quat[ai], pos)
        quat = M.quat_mul(quat[ai], quat)
    xpos, xquat = pos, quat

    if mt.njnt:
        pj = plan.jnt_parent
        xanchor = xpos[pj] + M.quat_rot(xquat[pj], anchor_l)
        xaxis = M.quat_rot(xquat[pj], axis_l)
    else:
        xanchor, xaxis = z3, z3

    gb = plan.geom_body
    sb = plan.site_body
    return dataclasses.replace(
        d, xpos=xpos, xquat=xquat, xmat=M.quat_to_mat(xquat),
        xipos=xpos + M.quat_rot(xquat, m.body_ipos),
        ximat=M.quat_to_mat(M.quat_mul(xquat, m.body_iquat)),
        xanchor=xanchor, xaxis=xaxis,
        geom_xpos=xpos[gb] + M.quat_rot(xquat[gb], m.geom_pos),
        geom_xmat=M.quat_to_mat(M.quat_mul(xquat[gb], m.geom_quat)),
        site_xpos=xpos[sb] + M.quat_rot(xquat[sb], m.site_pos),
        site_xmat=M.quat_to_mat(M.quat_mul(xquat[sb], m.site_quat)),
    )


class _TreePlan:
    """Static 0/1 tree-accumulation matrices (soa._tree_mats) in the
    model's dtype, the ancestor-dof mask (smooth._ancestor_mask) and the
    joint groups of com_pos, on the model's device."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev, dtype = m.device, m.qpos0.dtype
        nbody, nv = mt.nbody, mt.nv
        par = np.array(mt.body_parentid)
        anc = np.zeros((nbody, nbody))
        for b in range(nbody):
            a = b
            while True:
                anc[b, a] = 1.0
                if a == 0:
                    break
                a = int(par[a])
        dof_body = np.array(mt.dof_bodyid, dtype=np.int64)
        jnt_of_dof = np.zeros(nv, np.int64)
        sub_of_dof = np.zeros(nv, np.int64)
        free_trans = np.zeros(nv, bool)
        for j in range(mt.njnt):
            adr = mt.jnt_dofadr[j]
            jt = mt.jnt_type[j]
            for k in range(T.JNT_DOF_WIDTH[jt]):
                jnt_of_dof[adr + k] = j
                if jt == T.FREE:
                    sub_of_dof[adr + k] = 0 if k < 3 else 1
                    free_trans[adr + k] = k < 3
        prefix = np.zeros((nv, nv))
        for dd in range(nv):
            bd = dof_body[dd]
            for e in range(nv):
                be = dof_body[e]
                if be == bd:
                    if jnt_of_dof[e] < jnt_of_dof[dd] or (
                        jnt_of_dof[e] == jnt_of_dof[dd]
                        and sub_of_dof[e] < sub_of_dof[dd]
                    ):
                        prefix[dd, e] = 1.0
                elif anc[bd, be] and be != bd:
                    prefix[dd, e] = 1.0
        mask = np.zeros((nv, nv), dtype=bool)
        for i in range(nv):
            j = i
            while j >= 0:
                mask[i, j] = True
                j = mt.dof_parentid[j]

        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        sub = anc.T.copy()
        self.sub = f(sub)
        self.danc = f(anc[:, dof_body])
        self.subd = f(sub[dof_body])
        self.prefix = f(prefix)
        self.cdofdot_mask = f((~free_trans).astype(np.float64))[:, None, None]
        self.anc_mask = torch.as_tensor(mask, device=dev)[:, :, None]
        self.diag = _ix(np.arange(nv), dev)
        self.root = _ix(mt.body_rootid, dev)
        self.jnt_groups = {}
        for jt in sorted(set(mt.jnt_type)):
            jids = [j for j in range(mt.njnt) if mt.jnt_type[j] == jt]
            dadr = np.array([mt.jnt_dofadr[j] for j in jids], dtype=np.int64)
            width = T.JNT_DOF_WIDTH[jt]
            self.jnt_groups[jt] = dict(
                jids=_ix(jids, dev),
                bodies=_ix([mt.jnt_bodyid[j] for j in jids], dev),
                rows=_ix((dadr[:, None] + np.arange(width)).reshape(-1), dev),
            )
        grav = np.zeros(3) if mt.opt.disable_gravity else np.asarray(
            mt.opt.gravity, np.float64
        )
        self.cacc0 = f(np.concatenate([np.zeros(3), -grav]))[None, :, None]


def _tree(m: T.Model) -> _TreePlan:
    return m.plan("tree", _TreePlan)


def com_pos(m: T.Model, d: T.Data) -> T.Data:
    mt = m.meta
    B = d.qpos.shape[-1]
    tp = _tree(m)

    mom = d.xipos * m.body_mass[:, None, :]
    sub_mom = torch.einsum("ij,jcb->icb", tp.sub, mom)
    sub_mass = tp.sub @ M.bB(m.body_mass, B)
    subtree_com = torch.where(
        (sub_mass > 1e-10)[:, None, :],
        sub_mom / torch.clamp(sub_mass, min=1e-12)[:, None, :],
        d.xipos,
    )
    c_origin = subtree_com[tp.root]
    iquat = M.quat_mul(d.xquat, m.body_iquat)
    cinert = M.inertia_about_point(
        m.body_mass, m.body_inertia, d.xipos, iquat, c_origin
    )

    cdof = d.qpos.new_zeros((mt.nv, 6, B))
    for jt, g in tp.jnt_groups.items():
        jids, bodies = g["jids"], g["bodies"]
        o = c_origin[bodies]
        a = d.xanchor[jids]
        if jt in (T.FREE, T.BALL):
            ax = d.xmat[bodies].transpose(1, 2)            # (k, 3 axes, 3, B)
            rot = torch.cat([ax, M.cross3(ax, (o - a)[:, None])], dim=-2)
            if jt == T.FREE:
                k = len(jids)
                eye = torch.eye(3, dtype=ax.dtype, device=ax.device)
                lin = torch.cat(
                    [ax.new_zeros((k, 3, 3, B)),
                     eye[None, :, :, None].expand(k, 3, 3, B)], dim=-2
                )
                rot = torch.cat([lin, rot], dim=1)          # (k, 6, 6, B)
            cdof[g["rows"]] = rot.reshape(-1, 6, B)
        elif jt == T.SLIDE:
            ax = d.xaxis[jids]
            cdof[g["rows"]] = torch.cat([torch.zeros_like(ax), ax], dim=-2)
        else:  # HINGE
            ax = d.xaxis[jids]
            cdof[g["rows"]] = torch.cat([ax, M.cross3(ax, o - a)], dim=-2)

    return dataclasses.replace(
        d, subtree_com=subtree_com, cinert=cinert, cdof=cdof
    )


def com_vel(m: T.Model, d: T.Data) -> T.Data:
    tp = _tree(m)
    cq = d.cdof * d.qvel[:, None, :]
    cvel = torch.einsum("ij,jcb->icb", tp.danc, cq)
    vpre = torch.einsum("ij,jcb->icb", tp.prefix, cq)
    cdof_dot = M.motion_cross(vpre, d.cdof) * tp.cdofdot_mask
    return dataclasses.replace(d, cvel=cvel, cdof_dot=cdof_dot)


def crb(m: T.Model, d: T.Data) -> T.Data:
    B = d.qpos.shape[-1]
    tp = _tree(m)
    crb_dof = torch.einsum("ij,jcb->icb", tp.subd, d.cinert)
    F = M.inert_mul(crb_dof, d.cdof)
    G = torch.einsum("icb,jcb->ijb", F, d.cdof)
    Ml = torch.where(tp.anc_mask, G, torch.zeros_like(G))
    ar = tp.diag
    dg = Ml[ar, ar]
    qM = Ml + Ml.transpose(0, 1)
    qM[ar, ar] += M.bB(m.dof_armature, B) - dg
    return dataclasses.replace(d, qM=qM)


def rne(m: T.Model, d: T.Data) -> T.Data:
    tp = _tree(m)
    contrib = d.cdof_dot * d.qvel[:, None, :]
    cacc = tp.cacc0 + torch.einsum("ij,jcb->icb", tp.danc, contrib)
    hb = M.inert_mul(d.cinert, d.cvel)
    cfrc = M.inert_mul(d.cinert, cacc) + M.motion_cross_force(d.cvel, hb)
    cfrc_dof = torch.einsum("ij,jcb->icb", tp.subd, cfrc)
    return dataclasses.replace(d, qfrc_bias=torch.sum(d.cdof * cfrc_dof, dim=-2))


def body_dof_masks(mt: T.Meta) -> np.ndarray:
    """mask[b, i] = 1 if dof i belongs to body b or an ancestor of b."""
    mask = np.zeros((mt.nbody, mt.nv))
    for b in range(mt.nbody):
        bb = b
        while bb > 0:
            adr, num = mt.body_dofadr[bb], mt.body_dofnum[bb]
            mask[b, adr:adr + num] = 1.0
            bb = mt.body_parentid[bb]
    return mask


class _TendonPlan:
    """Tendon tables (soa.tendon): for the fixed tendons, per wrap entry its
    tendon, joint qpos and dof addresses and its coefficient's row of
    wrap_prm; for the site-to-site spatial tendons (``spatial2``), per
    tendon its two sites, their bodies' roots and the dofs that move each
    body."""

    def __init__(self, m: T.Model):
        mt = m.meta
        kinds = mt.tendon_kind or ("fixed",) * mt.ntendon
        w_idx, w_q, w_d, w_t = [], [], [], []
        sp_t, sp_s0, sp_s1 = [], [], []
        for t in range(mt.ntendon):
            adr = mt.tendon_adr[t]
            if kinds[t] == "spatial2":
                sp_t.append(t)
                sp_s0.append(mt.wrap_objid[adr])
                sp_s1.append(mt.wrap_objid[adr + 1])
                continue
            for w in range(adr, adr + mt.tendon_num[t]):
                j = mt.wrap_objid[w]
                w_idx.append(w)
                w_q.append(mt.jnt_qposadr[j])
                w_d.append(mt.jnt_dofadr[j])
                w_t.append(t)
        dev = m.device
        self.w, self.q, self.d, self.t = (_ix(x, dev) for x in (w_idx, w_q, w_d, w_t))
        self.spatial = bool(sp_t)
        if self.spatial:
            masks = body_dof_masks(mt)
            self.sp_t = _ix(sp_t, dev)
            self.sp_ends = []
            for sites in (sp_s0, sp_s1):
                bodies = [mt.site_bodyid[s] for s in sites]
                # sites, their bodies' roots, (n, nv, 1, 1) dof masks
                self.sp_ends.append((
                    _ix(sites, dev), _ix([mt.body_rootid[b] for b in bodies], dev),
                    torch.as_tensor(masks[bodies][:, :, None, None],
                                    dtype=m.qpos0.dtype, device=dev)))


def _site_jacp(d: T.Data, sites, roots, masks):
    """(n, nv, 3, B) translational Jacobians of sites, each about its body's
    root's subtree com (soa.tendon's jacp)."""
    off = d.site_xpos[sites] - d.subtree_com[roots]          # (n, 3, B)
    cdof = d.cdof[None]                                      # (1, nv, 6, B)
    return (cdof[..., 3:, :] + M.cross3(cdof[..., :3, :], off[:, None])) * masks


def tendon(m: T.Model, d: T.Data) -> T.Data:
    """Tendons (soa.tendon :713-783). Fixed: length = sum of coef * qpos
    over the tendon's joints, ten_J scattered from the coefficients.
    Site-to-site spatial (:750-776): length |p1 - p0|, ten_J the two
    sites' translational Jacobians' difference along the direction
    (p1 - p0) / max(length, 1e-10). Velocity = ten_J qvel."""
    mt = m.meta
    B = d.qpos.shape[-1]
    ten_length = d.qpos.new_zeros((mt.ntendon, B))
    ten_J = d.qpos.new_zeros((mt.ntendon, mt.nv, B))
    if mt.ntendon:
        tp = m.plan("tendon", _TendonPlan)
        coefs = m.wrap_prm[tp.w]                             # (nw, Bm)
        ten_length.index_add_(0, tp.t, coefs * d.qpos[tp.q])
        ten_J.index_put_((tp.t, tp.d), M.bB(coefs, B), accumulate=True)
        if tp.spatial:
            (s0, r0, m0), (s1, r1, m1) = tp.sp_ends
            dvec = d.site_xpos[s1] - d.site_xpos[s0]          # (n, 3, B)
            L = torch.sqrt(torch.sum(dvec * dvec, dim=1))
            direction = dvec / torch.clamp(L, min=1e-10)[:, None]
            jac = _site_jacp(d, s1, r1, m1) - _site_jacp(d, s0, r0, m0)
            ten_J[tp.sp_t] = torch.einsum("nvcb,ncb->nvb", jac, direction)
            ten_length[tp.sp_t] = L
    return dataclasses.replace(
        d, ten_length=ten_length,
        ten_velocity=torch.einsum("tvb,vb->tb", ten_J, d.qvel), ten_J=ten_J,
    )


class _ActPlan:
    """Actuator tables (soa.transmission / fwd_actuation). Only joint
    transmissions on slide and hinge joints, without activation dynamics,
    are ported."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev = m.device
        u_1d, q_1d, d_1d = [], [], []
        for u in range(mt.nu):
            trn, tid = mt.actuator_trntype[u], mt.actuator_trnid[u]
            if trn not in (T.TRN_JOINT, T.TRN_JOINTINPARENT) or mt.jnt_type[
                tid
            ] not in (T.SLIDE, T.HINGE):
                raise NotImplementedError(
                    f"actuator {u}: only joint transmissions on slide/hinge "
                    "joints are ported (soa.transmission :787)"
                )
            if mt.actuator_dyntype[u] != T.DYN_NONE:
                raise NotImplementedError(
                    f"actuator {u}: activation dynamics (soa.act_dot :904) "
                    "are not ported yet"
                )
            u_1d.append(u)
            q_1d.append(mt.jnt_qposadr[tid])
            d_1d.append(mt.jnt_dofadr[tid])
        self.u, self.q, self.d = (_ix(x, dev) for x in (u_1d, q_1d, d_1d))
        self.ctrl_limited = torch.as_tensor(
            mt.actuator_ctrllimited, dtype=torch.bool, device=dev
        )[:, None]
        self.force_limited = torch.as_tensor(
            mt.actuator_forcelimited, dtype=torch.bool, device=dev
        )[:, None]
        self.gain_fixed = torch.as_tensor(
            np.array(mt.actuator_gaintype) == T.GAIN_FIXED, device=dev
        )[:, None]
        self.bias_none = torch.as_tensor(
            np.array(mt.actuator_biastype) == T.BIAS_NONE, device=dev
        )[:, None]


def transmission(m: T.Model, d: T.Data):
    mt = m.meta
    B = d.qpos.shape[-1]
    ap = m.plan("act", _ActPlan)
    length = d.qpos.new_zeros((mt.nu, B))
    moment = d.qpos.new_zeros((mt.nu, mt.nv, B))
    g0 = m.actuator_gear[ap.u, 0]                            # (k, Bm)
    length[ap.u] = (d.qpos[ap.q] - m.qpos0[ap.q]) * g0
    moment[ap.u, ap.d] = M.bB(g0, B)
    return length, moment


def fwd_actuation(m: T.Model, d: T.Data) -> T.Data:
    mt = m.meta
    B = d.qpos.shape[-1]
    if not mt.nu:
        z = d.qpos.new_zeros((0, B))
        return dataclasses.replace(
            d, actuator_length=z, actuator_velocity=z, actuator_force=z,
            qfrc_actuator=d.qpos.new_zeros((mt.nv, B)),
        )
    ap = m.plan("act", _ActPlan)
    length, moment = transmission(m, d)
    velocity = torch.einsum("uvb,vb->ub", moment, d.qvel)

    ctrl = d.ctrl
    if not mt.opt.disable_clampctrl:
        cr = m.actuator_ctrlrange
        ctrl = torch.where(
            ap.ctrl_limited, torch.clamp(ctrl, cr[:, 0], cr[:, 1]), ctrl
        )
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    gain = torch.where(
        ap.gain_fixed, gp[:, 0], gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity
    )
    bias = torch.where(
        ap.bias_none, torch.zeros_like(length),
        bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity,
    )
    force = gain * ctrl + bias
    fr = m.actuator_forcerange
    force = torch.where(
        ap.force_limited, torch.clamp(force, fr[:, 0], fr[:, 1]), force
    )
    return dataclasses.replace(
        d, actuator_length=length, actuator_velocity=velocity,
        actuator_force=force,
        qfrc_actuator=torch.einsum("uvb,ub->vb", moment, force),
    )


class _PassivePlan:
    def __init__(self, m: T.Model):
        mt = m.meta
        sel = [j for j in range(mt.njnt) if mt.jnt_type[j] in (T.HINGE, T.SLIDE)]
        dev = m.device
        self.j = _ix(sel, dev)
        self.q = _ix([mt.jnt_qposadr[j] for j in sel], dev)
        self.d = _ix([mt.jnt_dofadr[j] for j in sel], dev)
        self.fluid = mt.opt.density > 0 or mt.opt.viscosity > 0
        if self.fluid:
            # bodies 1.., their roots, and which dofs move each (nb-1, nv, 1)
            self.roots = _ix(mt.body_rootid[1:], dev)
            self.masks = torch.as_tensor(
                body_dof_masks(mt)[1:, :, None], dtype=m.qpos0.dtype,
                device=dev)


def _inertia_box_fluid(m: T.Model, d: T.Data, pp: _PassivePlan):
    """The inertia-box fluid model (soa._inertia_box_fluid :953), every
    body but the world at once: each body as the box of its inertia, in
    the medium's density (quadratic drag on the box's faces) and viscosity
    (Stokes drag of a sphere of the box's mean diameter), its local force
    and torque mapped to the dofs through the body's point Jacobian."""
    mt = m.meta
    rho, beta = mt.opt.density, mt.opt.viscosity
    mass, inert = m.body_mass[1:], m.body_inertia[1:]        # (n, Bm), (n, 3, Bm)
    i0, i1, i2 = inert[:, 0], inert[:, 1], inert[:, 2]
    box = torch.sqrt(torch.clamp(
        torch.stack([i1 + i2 - i0, i0 + i2 - i1, i0 + i1 - i2], dim=1)
        / torch.clamp(mass, min=1e-12)[:, None] * 6.0, min=1e-12)) / 2.0
    o = d.subtree_com[pp.roots]                              # (n, 3, B)
    off = d.xipos[1:] - o
    w_world = d.cvel[1:, :3]
    v_world = d.cvel[1:, 3:] + M.cross3(w_world, off)
    Rm = d.ximat[1:]                                         # (n, 3, 3, B)
    w = torch.einsum("nijb,nib->njb", Rm, w_world)
    v = torch.einsum("nijb,nib->njb", Rm, v_world)
    lfrc_f = torch.zeros_like(v)
    lfrc_t = torch.zeros_like(w)
    if beta > 0:
        diam = torch.mean(box, dim=1) * 2.0                  # (n, Bm)
        lfrc_f = lfrc_f - 3.0 * torch.pi * diam[:, None] * beta * v
        lfrc_t = lfrc_t - torch.pi * diam[:, None] ** 3 * beta * w
    if rho > 0:
        b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
        area = torch.stack([b1 * b2, b0 * b2, b0 * b1], dim=1) * 4.0
        lfrc_f = lfrc_f - 0.5 * rho * area * torch.abs(v) * v
        scl = torch.stack([b0 * (b1 ** 4 + b2 ** 4), b1 * (b0 ** 4 + b2 ** 4),
                           b2 * (b0 ** 4 + b1 ** 4)], dim=1)
        lfrc_t = lfrc_t - rho * scl * torch.abs(w) * w / 64.0 * 32.0
    f_world = torch.einsum("nijb,njb->nib", Rm, lfrc_f)
    t_world = torch.einsum("nijb,njb->nib", Rm, lfrc_t)
    cdof = d.cdof                                            # (nv, 6, B)
    jacp = (cdof[None, :, 3:] + M.cross3(cdof[None, :, :3], off[:, None])
            ) * pp.masks[..., None, :]                       # (n, nv, 3, B)
    jacr = cdof[None, :, :3] * pp.masks[..., None, :]
    return (torch.einsum("nvcb,ncb->vb", jacp, f_world)
            + torch.einsum("nvcb,ncb->vb", jacr, t_world))


def fwd_passive(m: T.Model, d: T.Data) -> T.Data:
    pp = m.plan("passive", _PassivePlan)
    qfrc = -m.dof_damping * d.qvel
    if len(pp.j):
        qfrc[pp.d] += -m.jnt_stiffness[pp.j] * (
            d.qpos[pp.q] - m.qpos_spring[pp.q]
        )
    if m.meta.ntendon:
        # springs with the lengthspring dead band, and damping (soa :937-945)
        lo = m.tendon_lengthspring[:, 0]
        hi = m.tendon_lengthspring[:, 1]
        L = d.ten_length
        dsp = torch.where(L < lo, L - lo,
                          torch.where(L > hi, L - hi, torch.zeros_like(L)))
        frc = -m.tendon_stiffness * dsp - m.tendon_damping * d.ten_velocity
        qfrc = qfrc + torch.einsum("tvb,tb->vb", d.ten_J, frc)
    if pp.fluid:
        qfrc = qfrc + _inertia_box_fluid(m, d, pp)
    return dataclasses.replace(d, qfrc_passive=qfrc)
