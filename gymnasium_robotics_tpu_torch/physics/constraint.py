"""Constraint rows and the constraint solve, batch-last (port of
gymnasium_robotics_tpu/physics/soa.py: ``_impedance`` :1091, ``_kbi``
:1104, ``_jacp_static`` :1119, ``build_rows`` :1276-1691,
``solve_constraints`` :1723-1755, ``_decode_contact_forces`` :1811,
``sensors`` :1938).

This slice ports unpruned, uncapped frictionless contact rows (condim 1)
with plain gathers. Equality, joint-limit, tendon-limit and friction-loss
rows, ``condim > 1``, ``contact_cap``, the contact-force decode and touch
sensors raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch.physics import collision as COL
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.physics import solver
from gymnasium_robotics_tpu_torch.physics import types as T


def _impedance(solimp, pos):
    """solimp (rows, 5, Bm), pos (rows, B) -> (rows, B)."""
    dmin = torch.clamp(solimp[:, 0], 0.0001, 0.9999)
    dmax = torch.clamp(solimp[:, 1], 0.0001, 0.9999)
    width, mid = solimp[:, 2], solimp[:, 3]
    power = torch.clamp(solimp[:, 4], min=1.0)
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-10), 0.0, 1.0)
    y1 = (mid ** (1.0 - power)) * (x ** power)
    y2 = 1.0 - ((1.0 - mid) ** (1.0 - power)) * ((1.0 - x) ** power)
    y = torch.where(x < mid, y1, y2)
    return dmin + (dmax - dmin) * y


def _kbi(solref, solimp, pos, dt):
    d_ = _impedance(solimp, pos)
    dmax = torch.clamp(solimp[:, 1], 0.0001, 0.9999)
    timeconst, dampratio = solref[:, 0], solref[:, 1]
    direct = timeconst <= 0
    tc = torch.clamp(timeconst, min=2.0 * dt)
    b = torch.where(direct, -solref[:, 1], 2.0 / (dmax * tc))
    k = torch.where(
        direct,
        -solref[:, 0],
        1.0 / (dmax * dmax * tc * tc * torch.clamp(dampratio, min=1e-8) ** 2),
    )
    return d_, b, k


def _body_dof_masks(mt: T.Meta) -> np.ndarray:
    """mask[b, i] = 1 if dof i belongs to body b or an ancestor of b."""
    mask = np.zeros((mt.nbody, mt.nv))
    for b in range(mt.nbody):
        bb = b
        while bb > 0:
            adr, num = mt.body_dofadr[bb], mt.body_dofnum[bb]
            mask[b, adr:adr + num] = 1.0
            bb = mt.body_parentid[bb]
    return mask


class _RowPlan:
    """Static row tables: per condim group of contact slots, the slot ids,
    their bodies' roots and dof masks; and the per-row is_eq flags."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev, dtype = m.device, m.qpos0.dtype
        if mt.neq:
            raise NotImplementedError(
                "equality rows (soa.build_rows :1297-1411) come with the "
                "FetchPush slice"
            )
        lim = not mt.opt.disable_limit and (
            any(mt.jnt_limited[j] and mt.jnt_type[j] in (T.HINGE, T.SLIDE)
                for j in range(mt.njnt))
            or any(mt.tendon_limited)
        )
        if lim:
            raise NotImplementedError(
                "joint and tendon limit rows (soa.build_rows :1413-1461) are "
                "not ported yet"
            )
        cond = np.array(mt.con_condim, dtype=np.int64)
        gb = mt.geom_bodyid
        roots = np.array(mt.body_rootid)
        masks = _body_dof_masks(mt)
        g1s, g2s = COL.slot_geoms_static(mt)
        b1s = np.array([gb[g] for g in g1s], dtype=np.int64)
        b2s = np.array([gb[g] for g in g2s], dtype=np.int64)
        cap = mt.opt.contact_cap
        self.groups = []
        n_rows = 0
        if COL.ncon(m) and not mt.opt.disable_contact:
            for cd in sorted(set(cond.tolist())):
                idx = np.nonzero(cond == cd)[0]
                if cd != 1:
                    raise NotImplementedError(
                        f"condim {cd} contact rows (pyramidal friction) are "
                        "not ported yet"
                    )
                if cap and len(idx) > cap:
                    raise NotImplementedError(
                        "contact_cap selection (narrowphase_pallas."
                        "topk_select) comes with the FetchPush slice"
                    )
                b1, b2 = b1s[idx], b2s[idx]

                def f(x):
                    return torch.as_tensor(x, dtype=dtype, device=dev)

                self.groups.append(dict(
                    idx=torch.as_tensor(idx, device=dev),
                    b1=torch.as_tensor(b1, device=dev),
                    b2=torch.as_tensor(b2, device=dev),
                    root1=torch.as_tensor(roots[b1], device=dev),
                    root2=torch.as_tensor(roots[b2], device=dev),
                    mask1=f(masks[b1])[:, :, None, None],
                    mask2=f(masks[b2])[:, :, None, None],
                ))
                n_rows += len(idx)
        self.is_eq = torch.zeros(n_rows, dtype=torch.bool, device=dev)


def _jacp(d, point, root, mask):
    """Point jacobians (k, nv, 3, B) of ``point`` (k, 3, B) on bodies with
    roots ``root`` and dof masks ``mask`` (k, nv, 1, 1)."""
    off = point - d.subtree_com[root]
    return (d.cdof[None, :, 3:] + M.cross3(d.cdof[None, :, :3], off[:, None])) * mask


def build_rows(m: T.Model, d: T.Data):
    """(J (rows, nv, B), aref, D, R, active (rows, B), is_eq (rows,), layout)."""
    mt = m.meta
    B = d.qpos.shape[-1]
    rp = m.plan("rows", _RowPlan)
    if not rp.groups:
        z = d.qpos.new_zeros((0, B))
        return (d.qpos.new_zeros((0, mt.nv, B)), z, z, z,
                torch.zeros((0, B), dtype=torch.bool, device=z.device),
                rp.is_eq, [])

    c = d.contact
    pen_all = c.dist - m.con_includemargin                  # (ncon, B)
    biw = m.body_invweight0[:, 0]                            # (nbody, Bm)
    Js, poss, srs, sis, iws, acts, layout = [], [], [], [], [], [], []
    for g in rp.groups:
        idx = g["idx"]
        pos_s = c.pos[idx]
        frame_n = c.frame[idx, 0]                            # normals (k, 3, B)
        pen = pen_all[idx]
        jp1 = _jacp(d, pos_s, g["root1"], g["mask1"])
        jp2 = _jacp(d, pos_s, g["root2"], g["mask2"])
        Js.append(torch.einsum("kvcb,kcb->kvb", jp2 - jp1, frame_n))
        poss.append(pen)
        srs.append(m.con_solref[idx])
        sis.append(m.con_solimp[idx])
        iws.append(biw[g["b1"]] + biw[g["b2"]])
        acts.append(pen < 0.0)
        layout.append((1, idx))

    J = torch.cat(Js)
    pos = torch.cat(poss)
    solref, solimp, invw = torch.cat(srs), torch.cat(sis), torch.cat(iws)
    active = torch.cat(acts)

    imp, b_, k_ = _kbi(solref, solimp, pos, mt.opt.timestep)
    vel = torch.einsum("evb,vb->eb", J, d.qvel)
    aref = -b_ * vel - k_ * imp * pos
    R = torch.clamp((1.0 - imp) / torch.clamp(imp, min=1e-8) * invw, min=1e-10)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))
    return J, aref, D, R, active, rp.is_eq, layout


def solve_constraints(m: T.Model, d: T.Data) -> T.Data:
    """The fused branch of soa.solve_constraints: one warm-started Newton
    solve per env (solver.solve_newton), then qfrc_constraint = J^T f."""
    mt = m.meta
    B = d.qpos.shape[-1]
    J, aref, D, _, active, is_eq, layout = build_rows(m, d)
    n_rows = J.shape[0]
    if n_rows == 0:
        return dataclasses.replace(
            d, qacc=d.qacc_smooth, qfrc_constraint=d.qpos.new_zeros((mt.nv, B))
        )
    if not (mt.nv <= 36 and n_rows * mt.nv <= 36000):
        raise NotImplementedError(
            f"nv={mt.nv} with {n_rows} rows is past the fused Newton gate "
            "(soa.py:1738); the dense generic solve is not ported yet"
        )
    qacc, f = solver.solve_newton(
        d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq,
        n_iter=min(mt.opt.iterations, 20), n_ls=min(mt.opt.ls_iterations, 8),
    )
    con_force, cfrc_ext = _decode_contact_forces(m, d, f, layout)
    return dataclasses.replace(
        d, qacc=qacc, qfrc_constraint=torch.einsum("evb,eb->vb", J, f),
        con_force=con_force, cfrc_ext=cfrc_ext,
    )


def _decode_contact_forces(m: T.Model, d: T.Data, f, layout):
    """Contact-frame forces and body wrenches: zeros when nothing reads them
    (no touch sensor and Option.need_cfrc_ext off), as in the JAX skip
    branch :1826-1838. The decode itself is not ported yet."""
    mt = m.meta
    B = d.qpos.shape[-1]
    need_cf = mt.opt.need_con_force
    if need_cf == "auto":
        need_cf = mt.opt.need_cfrc_ext or any(
            t == T.SENS_TOUCH for t in mt.sensor_type
        )
    if need_cf:
        raise NotImplementedError(
            "the contact-force decode (soa._decode_contact_forces :1839-1911)"
            " is not ported yet; set Option.need_cfrc_ext=False"
        )
    ncon = d.contact.dist.shape[0]
    return (d.qpos.new_zeros((ncon, 6, B)), d.qpos.new_zeros((mt.nbody, 6, B)))


def sensors(m: T.Model, d: T.Data) -> T.Data:
    if m.meta.nsensordata:
        raise NotImplementedError(
            "sensors (soa.sensors :1938) come with the HandManipulateBlock "
            "slice"
        )
    return d
