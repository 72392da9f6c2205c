"""Constraint rows and the constraint solve, batch-last (port of
gymnasium_robotics_tpu/physics/soa.py: ``_impedance`` :1091, ``_kbi``
:1104, ``_jacp_static`` :1119, ``_jacs_traced`` :1133, ``build_rows``
:1276-1691, ``solve_constraints`` :1723-1755, ``_decode_contact_forces``
:1811-1911, ``sensors`` :1938).

This port has weld and joint equality rows (:1324-1400), joint-limit
rows (:1413-1436), tendon-limit rows (:1438-1461) and pyramidal contact
rows of condim 1, 3, 4 and 6 (:1618-1667), static or traced: a pair-topk
compact table (Contact.src) and the ``contact_cap`` selection
(:1499-1560, one ``narrowphase.topk_select`` call for every capped condim
group) pick slots per env, and the body ids, Jacobians and per-slot
parameters are gathered per lane with plain gathers; and touch sensors
(:1920-1981). Connect and tendon equality rows, friction-loss rows and the
other condims raise ``NotImplementedError`` until a model needs them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_robotics_tpu_torch.physics import collision as COL
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.physics import narrowphase as NP
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


def _need_con_force(mt: T.Meta) -> bool:
    need = mt.opt.need_con_force
    if need == "auto":
        need = mt.opt.need_cfrc_ext or any(
            t == T.SENS_TOUCH for t in mt.sensor_type)
    return bool(need)


@dataclasses.dataclass
class _ContactGroup:
    cd: int
    idx: torch.Tensor      # (g,) compact slot positions of this condim
    capped: bool           # contact_cap picks `cap` of them per env
    traced: bool           # body ids and parameters gathered per lane
    k: int                 # slots that enter the rows
    cap_row: int = -1      # row of the merged topk_select call
    static: dict = None    # static groups: their bodies, roots and masks


class _RowPlan:
    """Static row tables: the weld rows' bodies, the joint equalities'
    addresses, the joint-limit rows, per condim group of contact slots the
    slot ids (and for a static group its bodies' roots and dof masks), the
    merged contact_cap selection and the per-row is_eq flags."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev, dtype = m.device, m.qpos0.dtype
        eq_on = mt.neq > 0     # soa.build_rows reads no disable_equality
        other = sorted({t for t in mt.eq_type
                        if t not in (T.EQ_WELD, T.EQ_JOINT)}) if eq_on else []
        if other:
            raise NotImplementedError(
                "equality rows of type "
                + ", ".join(T.EQ_NAMES[t] for t in other)
                + " (soa.build_rows :1301-1323, :1401-1411) are not ported "
                "yet; the port has weld and joint rows, and no model the "
                "JAX package loads or builds has the others")

        def ix(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        masks = _body_dof_masks(mt)
        roots = np.array(mt.body_rootid)
        self.masks = torch.as_tensor(masks, dtype=dtype, device=dev)
        welds = [e for e in range(mt.neq) if eq_on and mt.eq_type[e] == T.EQ_WELD]
        self.weld = None
        jeqs = [e for e in range(mt.neq) if eq_on and mt.eq_type[e] == T.EQ_JOINT]
        n_rows = 6 * len(welds) + len(jeqs)
        if welds:
            b1 = np.array([mt.eq_obj1id[e] for e in welds])
            b2 = np.array([mt.eq_obj2id[e] for e in welds])
            self.weld = dict(
                e=ix(welds), b1=ix(b1), b2=ix(b2), root1=ix(roots[b1]),
                root2=ix(roots[b2]), mask1=self.masks[ix(b1)][:, :, None, None],
                mask2=self.masks[ix(b2)][:, :, None, None])
        # joint equalities: joint 1's qpos address and dof, and joint 2's
        # where there is one (obj2 -1: joint 1 held at data[0])
        self.jeq = None
        if jeqs:
            j1 = [mt.eq_obj1id[e] for e in jeqs]
            j2 = [mt.eq_obj2id[e] for e in jeqs]
            two = [j >= 0 for j in j2]
            self.jeq = dict(
                e=ix(jeqs), n=ix(range(len(jeqs))),
                q1=ix([mt.jnt_qposadr[j] for j in j1]),
                d1=ix([mt.jnt_dofadr[j] for j in j1]),
                q2=ix([mt.jnt_qposadr[j] if j >= 0 else 0 for j in j2]),
                d2=ix([mt.jnt_dofadr[j] if j >= 0 else 0 for j in j2]),
                two=torch.as_tensor(two, device=dev), two_n=ix(np.nonzero(two)[0]))
        lim = [j for j in range(mt.njnt)
               if mt.jnt_limited[j] and not mt.opt.disable_limit
               and mt.jnt_type[j] in (T.HINGE, T.SLIDE)]
        self.lim = None
        if lim:
            self.lim = dict(
                j=ix(lim), q=ix([mt.jnt_qposadr[j] for j in lim]),
                d=ix([mt.jnt_dofadr[j] for j in lim]), n=ix(range(len(lim))),
            )
            n_rows += len(lim)
        tlim = [t for t in range(mt.ntendon)
                if mt.tendon_limited[t] and not mt.opt.disable_limit]
        self.tlim = ix(tlim) if tlim else None
        n_rows += 2 * len(tlim)
        self.n_loop = n_rows

        gb = np.array(mt.geom_bodyid)
        g1s, g2s = COL.slot_geoms_static(mt)
        b1s, b2s = gb[g1s], gb[g2s]
        self.b1s, self.b2s = ix(b1s), ix(b2s)      # per static slot
        self.roots = ix(roots)
        pruned = COL.prune_active(mt)
        cond = COL.compact_condim(mt) if pruned else np.array(mt.con_condim)
        cap = mt.opt.contact_cap
        self.cap = cap
        self.groups = []
        cap_rows = []
        if len(cond) and not mt.opt.disable_contact and mt.pairs:
            for cd in sorted(set(cond.tolist())):
                if cd not in (1, 3, 4, 6):
                    raise NotImplementedError(
                        f"condim {cd} contact rows (soa.build_rows :1630-1636)"
                        " are not ported yet (the port has condim 1, 3, 4, 6)"
                    )
                idx = np.nonzero(cond == cd)[0]
                capped = bool(cap) and len(idx) > cap
                g = _ContactGroup(cd=cd, idx=ix(idx), capped=capped,
                                  traced=capped or pruned,
                                  k=cap if capped else len(idx))
                if capped:
                    g.cap_row = len(cap_rows)
                    cap_rows.append(idx)
                if not g.traced:
                    b1, b2 = b1s[idx], b2s[idx]
                    g.static = dict(
                        b1=ix(b1), b2=ix(b2), root1=ix(roots[b1]),
                        root2=ix(roots[b2]),
                        mask1=self.masks[ix(b1)][:, :, None, None],
                        mask2=self.masks[ix(b2)][:, :, None, None],
                    )
                self.groups.append(g)
                n_rows += g.k * (1 if cd == 1 else 2 * (cd - 1))
        # the capped groups share one selection (soa.py:1515-1531): their
        # slot ids padded with the last one to the longest group, masked
        self.cap_rows = self.cap_mask = None
        if cap_rows:
            maxg = max(len(r) for r in cap_rows)
            self.cap_rows = ix(np.stack([
                np.concatenate([r, np.full(maxg - len(r), r[-1])])
                for r in cap_rows]))
            self.cap_mask = torch.as_tensor(
                np.stack([np.arange(maxg) < len(r) for r in cap_rows]),
                device=dev)
        self.is_eq = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        self.is_eq[:6 * len(welds) + len(jeqs)] = True


def _lane_take(x, i):
    """x (n, ..., B) gathered per lane at i (k, B) -> (k, ..., B)."""
    lane = torch.arange(i.shape[-1], device=i.device)
    return x[i, ..., lane].movedim(1, -1) if x.dim() > 2 else x[i, lane]


def _jacs_traced(d, rp, point, bodies):
    """(jacp, jacr) for per-lane body ids: point (k, 3, B), bodies (k, B)
    -> each (k, nv, 3, B) (soa._jacs_traced)."""
    o = _lane_take(d.subtree_com, rp.roots[bodies])          # (k, 3, B)
    off = point - o
    cdof_r = d.cdof[None, :, :3]
    jacp = d.cdof[None, :, 3:] + M.cross3(cdof_r, off[:, None])
    mk = rp.masks[bodies].permute(0, 2, 1)[:, :, None, :]    # (k, nv, 1, B)
    return jacp * mk, cdof_r * mk


def _jacs_static(d, point, root, mask):
    """(jacp, jacr) of ``point`` (k, 3, B) on bodies with roots ``root`` and
    dof masks ``mask`` (k, nv, 1, 1) (soa._jacp_static)."""
    off = point - d.subtree_com[root]
    cdof_r = d.cdof[None, :, :3]
    return (d.cdof[None, :, 3:] + M.cross3(cdof_r, off[:, None])) * mask, \
        cdof_r * mask


def _param(table, sel):
    """Per-slot model table (ncon_static, c, 1) read at static slot ids sel
    (k,) -> (k, c, 1), or per lane (k, B) -> (k, c, B)."""
    if sel.dim() == 1:
        return table[sel]
    return table[:, :, 0][sel].movedim(-1, 1)


def _weld_rows(m: T.Model, d: T.Data, w):
    """The 6 rows of each weld (soa.build_rows :1324-1376): the anchor
    points' offset and the quaternion error against the relative pose,
    scaled by torquescale, with the error's Jacobian; the impedance reads
    the norm of the whole 6-vector. -> (J, pos, solref, solimp, invweight,
    active, pos for the impedance)."""
    B = d.qpos.shape[-1]
    nv = m.meta.nv
    b1, b2, e = w["b1"], w["b2"], w["e"]
    k = len(e)
    eqd = m.eq_data[e]                                        # (k, 11, Bm)
    anchor1, anchor2 = M.bB(eqd[:, 0:3], B), M.bB(eqd[:, 3:6], B)
    relpose_q = M.bB(eqd[:, 6:10], B)
    torquescale = eqd[:, 10]                                  # (k, Bm)
    p1 = d.xpos[b1] + torch.einsum("kijb,kjb->kib", d.xmat[b1], anchor1)
    p2 = d.xpos[b2] + torch.einsum("kijb,kjb->kib", d.xmat[b2], anchor2)
    jp1, jr1 = _jacs_static(d, p1, w["root1"], w["mask1"])
    jp2, jr2 = _jacs_static(d, p2, w["root2"], w["mask2"])
    Jp = (jp1 - jp2).transpose(1, 2)                          # (k, 3, nv, B)
    err_p = p1 - p2
    q1 = d.xquat[b1]
    q2t = M.quat_mul(d.xquat[b2], relpose_q)
    q2c = M.quat_conj(q2t)
    err_q = M.quat_mul(q2c, q1)[:, 1:4] * torquescale[:, None]
    # A[:, :, j] = vec(conj(q2t) e_j q1): the quaternion error's Jacobian
    cols = []
    for j in range(3):
        ej = torch.zeros_like(q1)
        ej[:, 1 + j] = 1.0
        cols.append(M.quat_mul(M.quat_mul(q2c, ej), q1)[:, 1:4])
    A = torch.stack(cols, dim=2)                              # (k, 3, 3, B)
    Jr = 0.5 * torquescale[:, None, None] * torch.einsum(
        "kijb,kjvb->kivb", A, (jr1 - jr2).transpose(1, 2))
    nrm = torch.sqrt(torch.sum(err_p * err_p, dim=1) + torch.sum(err_q * err_q, dim=1))
    biw = m.body_invweight0
    iw_t = biw[b1, 0] + biw[b2, 0]
    iw_r = biw[b1, 1] + biw[b2, 1]
    iw6 = torch.stack([iw_t] * 3 + [iw_r] * 3, dim=1).reshape(k * 6, -1)

    def rep(x):
        return torch.repeat_interleave(x, 6, dim=0)

    return (torch.cat([Jp, Jr], dim=1).reshape(k * 6, nv, B),
            torch.cat([err_p, err_q], dim=1).reshape(k * 6, B),
            rep(m.eq_solref[e]), rep(m.eq_solimp[e]), iw6,
            rep(d.eq_active[e]), rep(nrm))


def _joint_eq_rows(m: T.Model, d: T.Data, q):
    """One row a joint equality (soa.build_rows :1377-1400): q1 - poly(q2)
    with the quartic of eq_data, both positions taken from qpos0, and
    -dpoly/dq2 at joint 2's dof; where obj2 is -1, q1 - data[0]. -> (J,
    pos, solref, solimp, invweight, active)."""
    B = d.qpos.shape[-1]
    e, n = q["e"], len(q["e"])
    data = m.eq_data[e]                                       # (k, 11, Bm)
    q1 = d.qpos[q["q1"]] - m.qpos0[q["q1"]]                   # (k, B)
    q2 = d.qpos[q["q2"]] - m.qpos0[q["q2"]]
    c = [data[:, i] for i in range(5)]
    q2s = q2 * q2
    poly = c[0] + c[1] * q2 + c[2] * q2s + c[3] * (q2s * q2) + c[4] * (q2s * q2s)
    dpoly = c[1] + 2 * c[2] * q2 + 3 * c[3] * q2s + 4 * c[4] * (q2s * q2)
    two = q["two"][:, None]
    err = q1 - torch.where(two, poly, M.bB(c[0], B))
    rows = q1.new_zeros((n, m.meta.nv, B))
    rows[q["n"], q["d1"]] = 1.0
    t = q["two_n"]
    rows[t, q["d2"][t]] = -M.bB(dpoly, B)[t]
    return (rows, err, m.eq_solref[e], m.eq_solimp[e],
            m.dof_invweight0[q["d1"]], d.eq_active[e])


def build_rows(m: T.Model, d: T.Data):
    """(J (rows, nv, B), aref, D, R, active (rows, B), is_eq (rows,),
    layout): the weld rows, the joint equality rows, the joint-limit rows,
    the tendon-limit rows, then the contact rows per condim group
    (soa.build_rows). ``layout`` lists, per contact group, (condim, compact
    slots, static slot ids, first row) for the force decode."""
    mt = m.meta
    B = d.qpos.shape[-1]
    rp = m.plan("rows", _RowPlan)
    Js, poss, pimps, srs, sis, iws, acts, layout = ([] for _ in range(8))

    def add(J, pos, sr, si, iw, act, p_imp=None):
        Js.append(J)
        poss.append(pos)
        pimps.append(pos if p_imp is None else p_imp)
        srs.append(M.bB(sr, B))
        sis.append(M.bB(si, B))
        iws.append(M.bB(iw, B))
        acts.append(act)

    if rp.weld is not None:
        add(*_weld_rows(m, d, rp.weld))
    if rp.jeq is not None:
        add(*_joint_eq_rows(m, d, rp.jeq))

    if rp.lim is not None:
        ji, n = rp.lim["j"], len(rp.lim["j"])
        q = d.qpos[rp.lim["q"]]                               # (k, B)
        dist_lo = q - m.jnt_range[ji, 0]
        dist_hi = m.jnt_range[ji, 1] - q
        lo_closer = dist_lo < dist_hi
        dist = torch.where(lo_closer, dist_lo, dist_hi)
        sign = torch.where(lo_closer, 1.0, -1.0).to(q.dtype)
        margin = m.jnt_margin[ji]
        rows = q.new_zeros((n, mt.nv, B))
        rows[rp.lim["n"], rp.lim["d"]] = sign
        add(rows, dist - margin, m.jnt_solref[ji], m.jnt_solimp[ji],
            m.dof_invweight0[rp.lim["d"]], dist < margin)

    if rp.tlim is not None:
        # two rows a limited tendon, [lower, upper] (soa.build_rows :1438-1461)
        ti, nt = rp.tlim, len(rp.tlim)
        margin = m.tendon_margin[ti]                          # (nt, Bm)
        length = d.ten_length[ti]
        dist_lo = length - m.tendon_range[ti, 0]
        dist_hi = m.tendon_range[ti, 1] - length
        tj = d.ten_J[ti]                                      # (nt, nv, B)

        def two(x):
            return torch.repeat_interleave(x, 2, dim=0)

        add(torch.stack([tj, -tj], dim=1).reshape(2 * nt, mt.nv, B),
            torch.stack([dist_lo, dist_hi], dim=1).reshape(2 * nt, B)
            - two(margin),
            two(m.tendon_solref_lim[ti]), two(m.tendon_solimp_lim[ti]),
            two(m.tendon_invweight0[ti]),
            torch.stack([dist_lo < margin, dist_hi < margin],
                        dim=1).reshape(2 * nt, B))

    c = d.contact
    pruned = c.src is not None
    if rp.groups:
        imarg = m.con_includemargin
        pen_all = c.dist - (imarg[:, 0][c.src] if pruned else imarg)
        orders = None
        if rp.cap_rows is not None:
            orders = NP.topk_select(pen_all[rp.cap_rows], rp.cap_mask, rp.cap)
        biw = m.body_invweight0[:, 0, 0]                      # (nbody,)
        base = rp.n_loop
        for g in rp.groups:
            if g.capped:
                # a NaN lane picks index maxg: clamp into the group
                order = torch.clamp(orders[g.cap_row].long(), max=len(g.idx) - 1)
                sel_c = g.idx[order]                          # (cap, B)
                pos_s = _lane_take(c.pos, sel_c)
                frame_s = _lane_take(c.frame, sel_c)
                pen = torch.gather(pen_all, 0, sel_c)
                sel = torch.gather(c.src, 0, sel_c) if pruned else sel_c
            else:
                sel_c = g.idx
                pos_s, frame_s, pen = c.pos[sel_c], c.frame[sel_c], pen_all[sel_c]
                sel = c.src[sel_c] if pruned else sel_c
            if g.traced:
                b1, b2 = rp.b1s[sel], rp.b2s[sel]             # (k, B)
                iw = biw[b1] + biw[b2]
                jp1, jr1 = _jacs_traced(d, rp, pos_s, b1)
                jp2, jr2 = _jacs_traced(d, rp, pos_s, b2)
            else:
                st = g.static
                iw = biw[st["b1"]] + biw[st["b2"]]
                iw = iw[:, None] if iw.dim() == 1 else iw
                jp1, jr1 = _jacs_static(d, pos_s, st["root1"], st["mask1"])
                jp2, jr2 = _jacs_static(d, pos_s, st["root2"], st["mask2"])
            sr, si = _param(m.con_solref, sel), _param(m.con_solimp, sel)
            Jp = jp2 - jp1                                    # (k, nv, 3, B)
            Jn = torch.einsum("kvcb,kcb->kvb", Jp, frame_s[:, 0])
            act = pen < 0.0
            k = g.k
            layout.append((g.cd, sel_c, sel, base))
            if g.cd == 1:
                add(Jn, pen, sr, si, iw, act)
                base += k
                continue
            # pyramid edges Jn +- mu * J_axis, rows [i+, i-] blocks of k: the
            # two tangents, for condim 4 the torsion about the normal, and
            # for condim 6 the rolling about both tangents
            nfr = g.cd - 1
            mu = M.bB(_param(m.con_friction, sel), B)[:, :nfr].transpose(0, 1)
            Jr = jr2 - jr1 if nfr > 2 else None
            axes = [(Jp, 1), (Jp, 2)] + [(Jr, r) for r in range(nfr - 2)]
            ax = torch.stack([torch.einsum("kvcb,kcb->kvb", Jx, frame_s[:, r])
                              for Jx, r in axes])             # (nfr, k, nv, B)
            edge = mu[:, :, None] * ax
            Jpy = torch.stack([Jn[None] + edge, Jn[None] - edge], dim=1)
            iwp = 2.0 * mu * mu * (1.0 + mu * mu) * iw       # (nfr, k, B)
            R2k = 2 * nfr * k

            def rep(x):
                x = M.bB(x, B)
                return x[None, None].expand(nfr, 2, *x.shape).reshape(
                    R2k, *x.shape[1:])

            add(Jpy.reshape(R2k, mt.nv, B), rep(pen), rep(sr), rep(si),
                iwp[:, None].expand(nfr, 2, k, B).reshape(R2k, B), rep(act))
            base += R2k

    if not Js:
        z = d.qpos.new_zeros((0, B))
        return (d.qpos.new_zeros((0, mt.nv, B)), z, z, z,
                torch.zeros((0, B), dtype=torch.bool, device=z.device),
                rp.is_eq, layout)
    J = torch.cat(Js)
    pos = torch.cat(poss)
    solref, solimp, invw = torch.cat(srs), torch.cat(sis), torch.cat(iws)
    active = torch.cat(acts)

    # the impedance reads a weld's 6-vector norm, every other row its pos
    pos_imp = pos if rp.weld is None else torch.cat(pimps)
    imp, b_, k_ = _kbi(solref, solimp, pos_imp, mt.opt.timestep)
    vel = torch.einsum("evb,vb->eb", J, d.qvel)
    aref = -b_ * vel - k_ * imp * pos
    R = torch.clamp((1.0 - imp) / torch.clamp(imp, min=1e-8) * invw, min=1e-10)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))
    return J, aref, D, R, active, rp.is_eq, layout


def solve_constraints(m: T.Model, d: T.Data) -> T.Data:
    """The fused branch of soa.solve_constraints: one warm-started Newton
    solve per env, then qfrc_constraint = J^T f. The solve is
    solver.solve_newton, or at nv = 2 on the per-env path (Option.soa
    False, as the single env of envs/adapters.py runs) the closed-form
    solver.solve_newton_nv2, as constraint.solve_constraints takes
    solve_small_nv2 there (constraint.py:500-512); at other nv the per-env
    path keeps solve_newton, as solve_small there."""
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
    solve = (solver.solve_newton_nv2 if mt.nv == 2 and mt.opt.soa is False
             else solver.solve_newton)
    qacc, f = solve(
        d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq,
        n_iter=min(mt.opt.iterations, 20), n_ls=min(mt.opt.ls_iterations, 8),
    )
    con_force, cfrc_ext = _decode_contact_forces(m, d, f, layout)
    return dataclasses.replace(
        d, qacc=qacc, qfrc_constraint=torch.einsum("evb,eb->vb", J, f),
        con_force=con_force, cfrc_ext=cfrc_ext,
    )


def _scatter_rows(out, sel_c, val):
    """out[sel_c] = val along the slot axis: sel_c (k,) static or (k, B)
    per lane."""
    if sel_c.dim() == 1:
        out[sel_c] = val
    else:
        out.scatter_(0, sel_c, val)


def _decode_contact_forces(m: T.Model, d: T.Data, f, layout):
    """Pyramid forces -> contact-frame force per slot, then per-body com
    wrenches (soa._decode_contact_forces): zeros when nothing reads them (no
    touch sensor and Option.need_cfrc_ext off, :1826-1838)."""
    mt = m.meta
    B = d.qpos.shape[-1]
    c = d.contact
    ncon = c.dist.shape[0]
    con_force = d.qpos.new_zeros((ncon, 6, B))
    cfrc_ext = d.qpos.new_zeros((mt.nbody, 6, B))
    if not ncon or not _need_con_force(mt):
        return con_force, cfrc_ext
    for cd, sel_c, sel, base in layout:
        k = sel_c.shape[0]
        if cd == 1:
            _scatter_rows(con_force[:, 0], sel_c, f[base:base + k])
            continue
        nf = cd - 1
        lam = f[base:base + 2 * nf * k].reshape(nf, 2, k, B)
        _scatter_rows(con_force[:, 0], sel_c, torch.sum(lam, dim=(0, 1)))
        mu = _param(m.con_friction, sel)
        for i in range(nf):
            _scatter_rows(con_force[:, 1 + i], sel_c,
                          M.bB(mu[:, i] * (lam[i, 0] - lam[i, 1]), B))
    if not mt.opt.need_cfrc_ext:
        return con_force, cfrc_ext

    rp = m.plan("rows", _RowPlan)
    frame = c.frame                                         # (ncon, 3, 3, B)
    F_w = torch.einsum("ckb,ckjb->cjb", con_force[:, :3], frame)
    T_w = torch.einsum("ckb,ckjb->cjb", con_force[:, 3:], frame)
    if c.src is not None:
        b1s, b2s = rp.b1s[c.src], rp.b2s[c.src]              # (ncon, B)
        o1 = _lane_take(d.subtree_com, rp.roots[b1s])
        o2 = _lane_take(d.subtree_com, rp.roots[b2s])
    else:
        b1s, b2s = rp.b1s, rp.b2s
        o1, o2 = d.subtree_com[rp.roots[b1s]], d.subtree_com[rp.roots[b2s]]
    w2 = torch.cat([T_w + M.cross3(c.pos - o2, F_w), F_w], dim=1)
    w1 = torch.cat([T_w + M.cross3(c.pos - o1, F_w), F_w], dim=1)
    if c.src is not None:
        cfrc_ext.scatter_add_(0, b2s[:, None].expand(-1, 6, -1), w2)
        cfrc_ext.scatter_add_(0, b1s[:, None].expand(-1, 6, -1), -w1)
    else:
        cfrc_ext.index_add_(0, b2s, w2)
        cfrc_ext.index_add_(0, b1s, -w1)
    cfrc_ext[0] = 0.0
    return con_force, cfrc_ext


# site types of a touch sensor's zone (sensor._SPHERE ... _BOX)
_SITE_SPHERE, _SITE_CAPSULE, _SITE_ELLIPSOID, _SITE_CYLINDER, _SITE_BOX = \
    2, 3, 4, 5, 6


def _inside_zone(site_type, size, loc):
    """Whether points loc (k, 3, B) in a site's frame lie in its zone of
    half sizes size (k, 3, Bm) -> (k, B) (soa._inside_zone :1920-1935; any
    other type is a box)."""
    if site_type == _SITE_SPHERE:
        return torch.sqrt(torch.sum(loc * loc, dim=1)) <= size[:, 0]
    if site_type == _SITE_CAPSULE:
        z = torch.clamp(loc[:, 2], -size[:, 1], size[:, 1])
        dz = torch.stack([loc[:, 0], loc[:, 1], loc[:, 2] - z], dim=1)
        return torch.sqrt(torch.sum(dz * dz, dim=1)) <= size[:, 0]
    if site_type == _SITE_ELLIPSOID:
        return torch.sum(torch.square(loc / size), dim=1) <= 1.0
    if site_type == _SITE_CYLINDER:
        r = torch.sqrt(torch.sum(loc[:, :2] ** 2, dim=1))
        return (r <= size[:, 0]) & (torch.abs(loc[:, 2]) <= size[:, 1])
    return torch.all(torch.abs(loc) <= size + 1e-6, dim=1)


class _SensorPlan:
    """Touch sensors by site type. Each sensor sums the normal force of the
    contact slots on its site's body that lie in the site's zone. Per
    group: each sensor's output row, site and body (``sensor_*``, for a
    pair-topk table, whose slot map is per lane) and every (sensor, static
    slot) pair's output row, site and slot (``pair_*``, for the static
    table)."""

    def __init__(self, m: T.Model):
        mt = m.meta
        g1s, g2s = COL.slot_geoms_static(mt)
        gb = np.array(mt.geom_bodyid)
        b1s, b2s = gb[g1s], gb[g2s]
        groups: dict = {}
        for s in range(mt.nsensor):
            if mt.sensor_type[s] != T.SENS_TOUCH:
                continue
            site = mt.sensor_objid[s]
            body = mt.site_bodyid[site]
            stype = mt.site_type[site] if mt.site_type else _SITE_BOX
            g = groups.setdefault(stype, {k: [] for k in (
                "sensor_adr", "sensor_site", "sensor_body", "pair_adr",
                "pair_site", "pair_slot")})
            g["sensor_adr"].append(mt.sensor_adr[s])
            g["sensor_site"].append(site)
            g["sensor_body"].append(body)
            cis = np.nonzero((b1s == body) | (b2s == body))[0]
            g["pair_adr"] += [mt.sensor_adr[s]] * len(cis)
            g["pair_site"] += [site] * len(cis)
            g["pair_slot"] += cis.tolist()
        dev = m.device
        self.groups = [
            (stype, {k: torch.as_tensor(np.asarray(v, np.int64), device=dev)
                     for k, v in g.items()})
            for stype, g in sorted(groups.items())]
        self.b1s = torch.as_tensor(b1s.astype(np.int64), device=dev)
        self.b2s = torch.as_tensor(b2s.astype(np.int64), device=dev)


def sensors(m: T.Model, d: T.Data) -> T.Data:
    """Touch sensors (soa.sensors :1938-1981): the positive normal forces
    of the contact slots on the sensor's body inside its site's zone, over
    the static slot list or, on a pair-topk table, every compact slot whose
    per-lane geoms put it on the body. Sensors of other types read 0, as
    in the reference's batch-last path."""
    mt = m.meta
    if not mt.nsensordata:
        return d
    B = d.qpos.shape[-1]
    sp = m.plan("sensors", _SensorPlan)
    c = d.contact
    out = d.qpos.new_zeros((mt.nsensordata, B))
    fn_all = torch.clamp(d.con_force[:, 0], min=0.0)           # (ncon, B)
    for stype, g in sp.groups:
        if c.src is not None:
            # (s, ncon, 3, B): every compact slot, on the body per lane
            site, body = g["sensor_site"], g["sensor_body"][:, None, None]
            member = (sp.b1s[c.src][None] == body) | (sp.b2s[c.src][None] == body)
            rel = c.pos[None] - d.site_xpos[site][:, None]
            loc = torch.einsum("sijb,skib->skjb", d.site_xmat[site], rel)
            ns, nc = loc.shape[:2]
            size = m.site_size_arr[site][:, None].expand(-1, nc, -1, -1)
            inside = _inside_zone(stype, size.reshape(ns * nc, 3, -1),
                                  loc.reshape(ns * nc, 3, B)).reshape(ns, nc, B)
            out[g["sensor_adr"]] = torch.sum(torch.where(
                inside & member, fn_all[None], torch.zeros_like(loc[:, :, 0])),
                dim=1)
            continue
        site, slot = g["pair_site"], g["pair_slot"]
        if not len(slot):
            continue
        loc = torch.einsum("kijb,kib->kjb", d.site_xmat[site], c.pos[slot]
                           - d.site_xpos[site])
        inside = _inside_zone(stype, m.site_size_arr[site], loc)
        fn = fn_all[slot]
        out.index_add_(0, g["pair_adr"], torch.where(inside, fn, torch.zeros_like(fn)))
    return dataclasses.replace(d, sensordata=out)
