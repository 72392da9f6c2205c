"""The batch-last substep (port of gymnasium_robotics_tpu/physics/soa.py
``_integrate_qpos`` :1989-2006, ``_euler`` :2023, ``_rk4`` :2044-2070,
``forward`` :2078, ``step`` :2100, ``step_n`` :2237, ``refresh_kin``
:2274, and of ``pipeline.make_data`` :23-81 and ``pipeline._int_plan``
:141).

``Data`` stays batch-last across steps: there is no transpose in or out per
step as at the JAX ``custom_vmap`` boundary. Activation dynamics raise until
their slice.
"""

from __future__ import annotations

import dataclasses

import torch

from gymnasium_robotics_tpu_torch.physics import collision as COL
from gymnasium_robotics_tpu_torch.physics import constraint as CST
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.physics import smooth as SM
from gymnasium_robotics_tpu_torch.physics import solver
from gymnasium_robotics_tpu_torch.physics import types as T


def make_data(m: T.Model, B: int) -> T.Data:
    """Fresh batch-last Data at qpos0 for B envs, in the model's dtype and
    on its device (mujoco.MjData + mj_resetData)."""
    mt = m.meta
    like = m.qpos0

    def z(*s):
        return like.new_zeros(s + (B,))

    ncon = COL.ncon(m)
    src = None
    if COL.prune_active(mt):
        # per-env compact slot map, all zeros until the first collision (as
        # the JAX make_data leaves it)
        src = torch.zeros((ncon, B), dtype=torch.int64, device=like.device)
        geom1, geom2 = src.clone(), src.clone()
    else:
        geom1, geom2 = COL.slot_geoms(m)
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    contact = T.Contact(
        dist=like.new_full((ncon, B), 1e10),
        pos=z(ncon, 3),
        frame=eye[None, :, :, None].expand(ncon, 3, 3, B).clone(),
        geom1=geom1, geom2=geom2, src=src,
    )
    mocap_pos, mocap_quat = z(mt.nmocap, 3), z(mt.nmocap, 4)
    mocap_quat[:, 0] = 1.0
    for b in range(mt.nbody):
        mid = mt.body_mocapid[b]
        if mid >= 0:
            mocap_pos[mid] = m.body_pos[b]
            mocap_quat[mid] = m.body_quat[b]
    eq_active = m.plan("eq_active0", lambda m: torch.as_tensor(
        [bool(x) for x in mt.eq_active0], dtype=torch.bool, device=m.device
    ))[:, None].expand(mt.neq, B).clone()
    return T.Data(
        time=like.new_zeros((B,)),
        qpos=M.bB(m.qpos0, B).clone(),
        qvel=z(mt.nv), act=z(mt.na), ctrl=z(mt.nu), qfrc_applied=z(mt.nv),
        mocap_pos=mocap_pos, mocap_quat=mocap_quat, eq_active=eq_active,
        xpos=z(mt.nbody, 3), xquat=z(mt.nbody, 4), xmat=z(mt.nbody, 3, 3),
        xipos=z(mt.nbody, 3), ximat=z(mt.nbody, 3, 3),
        xanchor=z(mt.njnt, 3), xaxis=z(mt.njnt, 3),
        geom_xpos=z(mt.ngeom, 3), geom_xmat=z(mt.ngeom, 3, 3),
        site_xpos=z(mt.nsite, 3), site_xmat=z(mt.nsite, 3, 3),
        subtree_com=z(mt.nbody, 3),
        cinert=z(mt.nbody, 10), cdof=z(mt.nv, 6), cvel=z(mt.nbody, 6),
        cdof_dot=z(mt.nv, 6),
        ten_length=z(mt.ntendon), ten_velocity=z(mt.ntendon),
        ten_J=z(mt.ntendon, mt.nv),
        qM=z(mt.nv, mt.nv),
        qfrc_bias=z(mt.nv), qfrc_passive=z(mt.nv), qfrc_actuator=z(mt.nv),
        actuator_length=z(mt.nu), actuator_velocity=z(mt.nu),
        actuator_force=z(mt.nu),
        qfrc_smooth=z(mt.nv), qacc_smooth=z(mt.nv),
        qfrc_constraint=z(mt.nv), qacc=z(mt.nv),
        contact=contact,
        con_force=z(ncon, 6),
        cfrc_ext=z(mt.nbody, 6),
        sensordata=z(mt.nsensordata),
    )


class _IntPlan:
    """Index tables of the qpos integration (pipeline._int_plan): 1-dof
    joints, free-joint translations, and the quaternion and angular
    velocity blocks of free and ball joints."""

    def __init__(self, m: T.Model):
        mt = m.meta
        q1, d1, qf3, df3, quat4, quatw = [], [], [], [], [], []
        for j in range(mt.njnt):
            jt = mt.jnt_type[j]
            qa, da = mt.jnt_qposadr[j], mt.jnt_dofadr[j]
            if jt == T.FREE:
                qf3 += [qa, qa + 1, qa + 2]
                df3 += [da, da + 1, da + 2]
                quat4.append([qa + 3 + k for k in range(4)])
                quatw.append([da + 3 + k for k in range(3)])
            elif jt == T.BALL:
                quat4.append([qa + k for k in range(4)])
                quatw.append([da + k for k in range(3)])
            else:
                q1.append(qa)
                d1.append(da)

        def ix(x):
            return torch.as_tensor(x, dtype=torch.int64, device=m.device)

        self.q = ix(q1 + qf3)
        self.d = ix(d1 + df3)
        self.quat = ix(quat4).reshape(-1, 4)
        self.omega = ix(quatw).reshape(-1, 3)


def _integrate_qpos(m: T.Model, qpos, qvel, dt):
    ip = m.plan("int", _IntPlan)
    out = qpos.clone()
    out[ip.q] = qpos[ip.q] + dt * qvel[ip.d]
    if len(ip.quat):
        out[ip.quat] = M.quat_integrate(qpos[ip.quat], qvel[ip.omega], dt)
    return out


def damped_system(m: T.Model, d: T.Data):
    """(M + h diag(damping), M v + h (qfrc_smooth + qfrc_constraint
    + damping v)): the SPD system of the Euler step's new velocity."""
    h = m.meta.opt.timestep
    ar = SM._tree(m).diag
    MhB = d.qM.clone()
    MhB[ar, ar] += h * M.bB(m.dof_damping, d.qpos.shape[-1])
    rhs = torch.einsum("uvb,vb->ub", d.qM, d.qvel) + h * (
        d.qfrc_smooth + d.qfrc_constraint + m.dof_damping * d.qvel
    )
    return MhB, rhs


def _euler(m: T.Model, d: T.Data) -> T.Data:
    """Semi-implicit Euler with implicit joint damping (damped_system)."""
    mt = m.meta
    h = mt.opt.timestep
    if mt.na:
        raise NotImplementedError("activation integration is not ported yet")
    if mt.has_damping:
        qvel = solver.solve_pos(*damped_system(m, d))
    else:
        qvel = d.qvel + h * d.qacc
    return dataclasses.replace(
        d, qpos=_integrate_qpos(m, d.qpos, qvel, h), qvel=qvel, time=d.time + h
    )


def forward(m: T.Model, d: T.Data) -> T.Data:
    d = SM.kinematics(m, d)
    d = SM.com_pos(m, d)
    d = SM.tendon(m, d)
    d = SM.crb(m, d)
    d = COL.collision(m, d)
    d = SM.com_vel(m, d)
    d = SM.rne(m, d)
    d = SM.fwd_passive(m, d)
    d = SM.fwd_actuation(m, d)
    qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + d.qfrc_applied
    d = dataclasses.replace(
        d, qfrc_smooth=qfrc_smooth, qacc_smooth=solver.solve_pos(d.qM, qfrc_smooth)
    )
    d = CST.solve_constraints(m, d)
    return CST.sensors(m, d)


def _rk4(m: T.Model, d: T.Data) -> T.Data:
    """Classic RK4 over (qpos, qvel) from a forwarded ``d``; the post-step
    Data carries the last RK stage's derived fields (MuJoCo's
    mj_RungeKutta snapshot, which the Ant observations read)."""
    if m.meta.na:
        raise NotImplementedError("activation integration is not ported yet")
    h = m.meta.opt.timestep
    A = [0.5, 0.5, 1.0]
    Bc = [1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6]
    qpos0, qvel0 = d.qpos, d.qvel
    kq, kv = [d.qvel], [d.qacc]
    dd = d
    for i in range(3):
        dd = dataclasses.replace(
            dd, qpos=_integrate_qpos(m, qpos0, kq[i], A[i] * h),
            qvel=qvel0 + A[i] * h * kv[i],
        )
        dd = forward(m, dd)
        kq.append(dd.qvel)
        kv.append(dd.qacc)
    vavg = sum(b * k for b, k in zip(Bc, kq))
    aavg = sum(b * k for b, k in zip(Bc, kv))
    return dataclasses.replace(
        dd, qpos=_integrate_qpos(m, qpos0, vavg, h), qvel=qvel0 + h * aavg,
        time=d.time + h,
    )


def step(m: T.Model, d: T.Data) -> T.Data:
    d = forward(m, d)
    if m.meta.opt.integrator == T.RK4:
        return _rk4(m, d)
    return _euler(m, d)


def refresh_kin(m: T.Model, d: T.Data, com: bool = True) -> T.Data:
    """Kinematics (and com_pos) of ``d``'s qpos: the refresh the envs make
    after writing qpos outside the substep loop (reset-state
    construction)."""
    d = SM.kinematics(m, d)
    return SM.com_pos(m, d) if com else d


def step_n(m: T.Model, d: T.Data, ctrl, n: int) -> T.Data:
    """n substeps with fixed ctrl (nu, B) (the reference's
    mj_step(nstep=n))."""
    d = dataclasses.replace(d, ctrl=ctrl)
    for _ in range(n):
        d = step(m, d)
    return d
