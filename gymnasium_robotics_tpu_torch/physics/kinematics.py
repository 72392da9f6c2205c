"""Forward kinematics through the fused FK kernel (csrc/kinematics.cu), its
wrapper, and beside it its plain PyTorch version.

Port of gymnasium_robotics_tpu/physics/kinematics_pallas.py: ``kinematics``
replaces the TPU kernel ``_build_kernel`` (launched by ``_fk_call``,
entered through ``kinematics`` :315), and ``supported`` its gate :300.
``kinematics_plain`` is the body-ordered level pass of soa.kinematics
:412-503, which the kernel computes: per tree level the bodies' frames in
their parents', their joints round by round and the mocap override, then
the inertial, geom and site frames. Both write the eleven pose fields
(xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, geom_xpos, geom_xmat,
site_xpos, site_xmat) in the port's batch-last shapes.

``Option.fk_kernel`` selects this path (smooth.kinematics). A wrapper given
CPU tensors computes the plain version; given CUDA tensors it launches its
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from gymnasium_robotics_tpu_torch import kernels
from gymnasium_robotics_tpu_torch.physics import math as M
from gymnasium_robotics_tpu_torch.physics import types as T

LAUNCHES = {"fk": 0}
MAX_BODIES = 36          # kinematics_pallas.supported's tree-size gate
FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
          "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")


def supported(m: T.Model) -> bool:
    """kinematics_pallas.supported's gates: every joint free, ball, slide or
    hinge; at most MAX_BODIES bodies; FK tables shared by every env (a
    trailing axis of size 1, not a model batched per env). The TPU kernel
    also needs a batch divisible by its 128 lanes; the CUDA kernel masks
    the ragged edge, so that gate has no counterpart here."""
    mt = m.meta
    if mt.nbody > MAX_BODIES:
        return False
    if any(getattr(m, name).shape[-1] != 1 for name in T.FK_TABLES):
        return False
    return all(jt in (T.FREE, T.BALL, T.SLIDE, T.HINGE) for jt in mt.jnt_type)


def _ix(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)


class _LevelPlan:
    """Per tree level (smooth_vec.Plan): the bodies and their parents, the
    joint rounds grouped by type, and the mocap bodies; index tensors on
    the model's device."""

    def __init__(self, m: T.Model):
        mt = m.meta
        dev = m.device
        width = {T.FREE: 7, T.BALL: 4, T.SLIDE: 1, T.HINGE: 1}
        self.levels = []
        for bodies in mt.levels[1:]:
            if not bodies:
                continue
            rounds = []
            for r in range(max(mt.body_jntnum[b] for b in bodies)):
                groups: dict = {}
                for li, b in enumerate(bodies):
                    if mt.body_jntnum[b] <= r:
                        continue
                    j = mt.body_jntadr[b] + r
                    jt = mt.jnt_type[j]
                    g = groups.setdefault(jt, {"li": [], "jids": [], "qadr": []})
                    g["li"].append(li)
                    g["jids"].append(j)
                    g["qadr"].append(mt.jnt_qposadr[j])
                rounds.append({
                    jt: dict(
                        li=_ix(g["li"], dev), jids=_ix(g["jids"], dev),
                        qadr=_ix(g["qadr"], dev),
                        qidx=_ix([[q + i for i in range(width[jt])]
                                  for q in g["qadr"]], dev),
                    ) for jt, g in groups.items()
                })
            mocap = [mt.body_mocapid[b] >= 0 for b in bodies]
            self.levels.append(dict(
                bodies=_ix(bodies, dev),
                parents=_ix([mt.body_parentid[b] for b in bodies], dev),
                rounds=rounds,
                any_mocap=any(mocap),
                mocap_mask=torch.as_tensor(mocap, device=dev)[:, None, None],
                mocap_ids=_ix([max(mt.body_mocapid[b], 0) for b in bodies], dev),
            ))
        self.geom_body = _ix(mt.geom_bodyid, dev)
        self.site_body = _ix(mt.site_bodyid, dev)


def kinematics_plain(m: T.Model, d: T.Data) -> T.Data:
    """The level pass (soa.kinematics :412-503): world frames level by
    level, each level's joints applied round by round in body_jntadr
    order, the mocap override last."""
    mt = m.meta
    B = d.qpos.shape[-1]
    plan = m.plan("levels", _LevelPlan)
    xpos = d.qpos.new_zeros((mt.nbody, 3, B))
    xquat = d.qpos.new_zeros((mt.nbody, 4, B))
    xquat[:, 0] = 1.0
    xanchor = d.qpos.new_zeros((mt.njnt, 3, B))
    xaxis = d.qpos.new_zeros((mt.njnt, 3, B))

    for lv in plan.levels:
        bidx, pidx = lv["bodies"], lv["parents"]
        pos = xpos[pidx] + M.quat_rot(xquat[pidx], m.body_pos[bidx])
        quat = M.quat_mul(xquat[pidx], m.body_quat[bidx])
        for groups in lv["rounds"]:
            for jt, g in groups.items():
                li, jids = g["li"], g["jids"]
                axis = m.jnt_axis[jids]
                if jt == T.FREE:
                    q7 = d.qpos[g["qidx"]]                      # (k, 7, B)
                    fquat, _ = M.normalize(q7[:, 3:7])
                    pos[li] = q7[:, :3]
                    quat[li] = fquat
                    xanchor[jids] = q7[:, :3]
                    xaxis[jids] = M.quat_rot(fquat, axis)
                elif jt == T.BALL:
                    q4, _ = M.normalize(d.qpos[g["qidx"]])      # (k, 4, B)
                    jp = m.jnt_pos[jids]
                    anchor = pos[li] + M.quat_rot(quat[li], jp)
                    nquat = M.quat_mul(quat[li], q4)
                    quat[li] = nquat
                    pos[li] = anchor - M.quat_rot(nquat, jp)
                    xanchor[jids] = anchor
                    xaxis[jids] = M.quat_rot(nquat, axis)
                elif jt == T.SLIDE:
                    qa = g["qadr"]
                    qv = d.qpos[qa] - m.qpos0[qa]               # (k, B)
                    ax = M.quat_rot(quat[li], axis)
                    npos = pos[li] + ax * qv[:, None, :]
                    xanchor[jids] = npos + M.quat_rot(quat[li], m.jnt_pos[jids])
                    pos[li] = npos
                    xaxis[jids] = ax
                else:  # HINGE
                    qa = g["qadr"]
                    qv = d.qpos[qa] - m.qpos0[qa]
                    jp = m.jnt_pos[jids]
                    ax_w = M.quat_rot(quat[li], axis)
                    anchor = pos[li] + M.quat_rot(quat[li], jp)
                    nquat = M.quat_mul(quat[li], M.axis_angle_to_quat(axis, qv))
                    quat[li] = nquat
                    pos[li] = anchor - M.quat_rot(nquat, jp)
                    xanchor[jids] = anchor
                    xaxis[jids] = ax_w
        if lv["any_mocap"]:
            mid = lv["mocap_ids"]
            mq, _ = M.normalize(d.mocap_quat[mid])
            pos = torch.where(lv["mocap_mask"], d.mocap_pos[mid], pos)
            quat = torch.where(lv["mocap_mask"], mq, quat)
        xpos[bidx] = pos
        xquat[bidx] = quat

    gb, sb = plan.geom_body, plan.site_body
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


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

FK_SLOTS = 16            # csrc/kinematics.cu kFkSlots: task slots a block
FK_TILE = 32             # csrc/kinematics.cu kFkTile: envs a block
# the schedule's task kinds, as csrc/kinematics.cu's FkTask numbers them
TASK_KINDS = ("body", "xmat", "inertial", "geom", "site")

_vp, _i = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.load("kinematics")
    lib.grt_fk_f32.argtypes = [_vp] * 7 + [_vp, _vp, _i, _i, _vp]
    lib.grt_fk_f32.restype = _i
    lib.grt_fk_smem_bytes.argtypes = [_vp]
    lib.grt_fk_smem_bytes.restype = _i
    lib.grt_fk_blocks_per_sm.argtypes = [_i]
    lib.grt_fk_blocks_per_sm.restype = _i
    return lib


def _rows(mt: T.Meta):
    """(rows of each output in the (rows, B) buffer, their offsets)."""
    nb, nj, ng, ns = mt.nbody, mt.njnt, mt.ngeom, mt.nsite
    shapes = ((nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nb, 3, 3), (nj, 3),
              (nj, 3), (ng, 3), (ng, 3, 3), (ns, 3), (ns, 3, 3))
    sizes = [int(np.prod(s)) for s in shapes]
    return shapes, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def schedule(mt: T.Meta, slots: int = FK_SLOTS):
    """fk_kernel's task schedule: a list of steps, each a list of
    (kind, index) tasks (kinds as TASK_KINDS). Step s holds the bodies at
    depth s + 1 (a body task computes its joints too); every frame task
    (xmat, inertial, geom, site) goes into the first step after its body's
    step with a slot to spare, the rest into one last step. Within a step
    tasks are in kind order, then index order."""
    frames_of = {b: [(1, b), (2, b)] for b in range(mt.nbody)}
    for i, b in enumerate(mt.geom_bodyid):
        frames_of[b].append((3, i))
    for i, b in enumerate(mt.site_bodyid):
        frames_of[b].append((4, i))
    ready = list(frames_of[0])
    steps = []
    for bodies in mt.levels[1:]:
        if not bodies:
            continue
        step = [(0, b) for b in bodies]
        room = -len(step) % slots
        step += ready[:room]
        ready = ready[room:]
        steps.append(sorted(step))
        for b in bodies:
            ready += frames_of[b]
    if ready:
        steps.append(sorted(ready))
    return steps


def fk_geometry(mt: T.Meta, B: int) -> dict:
    """Launch geometry of fk_kernel at B envs: its grid, threads a block
    (FK_SLOTS slots of FK_TILE lanes), and shared memory bytes: the tile's
    body poses (7 floats a body), qpos and mocap poses, and the float and
    int tables (_KernelTables), as csrc/kinematics.cu's FkLayout computes
    them."""
    nf, ni = table_sizes(mt)
    words = (7 * mt.nbody + mt.nq + 7 * mt.nmocap) * FK_TILE + nf + ni
    return {"grid": -(-B // FK_TILE), "threads": FK_SLOTS * FK_TILE,
            "tile": FK_TILE, "slots": FK_SLOTS, "smem": 4 * words}


@functools.lru_cache(maxsize=None)
def table_sizes(mt: T.Meta):
    """(floats, ints) of the kernel's two tables, the schedule included."""
    steps = schedule(mt)
    nf = 14 * mt.nbody + 6 * mt.njnt + mt.nq + 7 * (mt.ngeom + mt.nsite)
    ni = (4 * mt.nbody + 2 * mt.njnt + mt.ngeom + mt.nsite + len(steps) + 1
          + sum(len(s) for s in steps))
    return nf, ni


class _KernelTables:
    """The model's FK constants as the kernel reads them (csrc/kinematics.cu
    fk_kernel): one float table (body pos/quat/ipos/iquat, joint pos/axis,
    qpos0, geom pos/quat, site pos/quat) and one int32 table (body parent,
    jntadr, jntnum, mocapid; joint type, qposadr; geom body; site body;
    then the schedule: the steps' offsets into the tasks, and the tasks,
    kind << 16 | index), with the dims and output row offsets, on the
    model's device."""

    def __init__(self, m: T.Model):
        mt = m.meta

        def flat(*names):
            return torch.cat([getattr(m, n)[..., 0] for n in names], dim=-1)

        self.ftab = torch.cat([
            flat("body_pos", "body_quat", "body_ipos", "body_iquat").reshape(-1),
            flat("jnt_pos", "jnt_axis").reshape(-1), m.qpos0[:, 0],
            flat("geom_pos", "geom_quat").reshape(-1),
            flat("site_pos", "site_quat").reshape(-1),
        ]).contiguous()
        self.steps = schedule(mt)
        tasks = [k << 16 | i for step in self.steps for k, i in step]
        offs = np.cumsum([0] + [len(s) for s in self.steps])
        ints = np.concatenate([
            np.stack([mt.body_parentid, mt.body_jntadr, mt.body_jntnum,
                      mt.body_mocapid], axis=1).reshape(-1),
            np.stack([mt.jnt_type, mt.jnt_qposadr], axis=1).reshape(-1)
            if mt.njnt else np.zeros(0, np.int64),
            np.asarray(mt.geom_bodyid, np.int64),
            np.asarray(mt.site_bodyid, np.int64),
            offs, np.asarray(tasks, np.int64),
        ]).astype(np.int32)
        self.itab = torch.as_tensor(ints, device=m.device)
        assert (self.ftab.numel(), self.itab.numel()) == table_sizes(mt)
        dims = [mt.nbody, mt.njnt, mt.nq, mt.ngeom, mt.nsite, mt.nmocap,
                self.ftab.numel(), self.itab.numel(), len(self.steps),
                len(tasks)]
        self.shapes, offs = _rows(mt)
        self.offs = [int(o) for o in offs]
        self.dims = (ctypes.c_int * 10)(*dims)
        self.row_offs = (ctypes.c_int * 11)(*self.offs[:-1])


def kinematics(m: T.Model, d: T.Data) -> T.Data:
    """The eleven pose fields of ``d`` from its qpos and mocap poses (see
    kinematics_plain). CUDA tensors launch fk_kernel (float32, a model
    ``supported`` takes); CPU tensors take the plain version."""
    mt = m.meta
    if not kernels.on_card((d.qpos, d.mocap_pos, d.mocap_quat)):
        return kinematics_plain(m, d)
    if not supported(m):
        raise NotImplementedError(
            f"the FK kernel takes trees of up to {MAX_BODIES} bodies with "
            "free, ball, slide and hinge joints and FK tables shared by "
            "every env; this model is not one")
    tabs = m.plan("fk_kernel", _KernelTables)
    kernels.on_card((d.qpos, tabs.ftab), ints=(tabs.itab,))
    B = d.qpos.shape[-1]
    _check = (("qpos", d.qpos, (mt.nq, B)),
              ("mocap_pos", d.mocap_pos, (mt.nmocap, 3, B)),
              ("mocap_quat", d.mocap_quat, (mt.nmocap, 4, B)))
    for name, t, shape in _check:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    dev = d.qpos.device
    out = torch.empty((tabs.offs[-1], B), dtype=torch.float32, device=dev)
    st = [s for t in (d.qpos, d.mocap_pos, d.mocap_quat) for s in t.stride()]
    rc = _lib().grt_fk_f32(
        d.qpos.data_ptr(), d.mocap_pos.data_ptr(), d.mocap_quat.data_ptr(),
        (ctypes.c_longlong * 8)(*st), tabs.ftab.data_ptr(),
        tabs.itab.data_ptr(), tabs.dims, tabs.row_offs, out.data_ptr(), B,
        fk_geometry(mt, B)["smem"], torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.raise_on(rc, "fk_kernel")
    LAUNCHES["fk"] += B > 0      # the entry point launches nothing at B = 0
    fields = {
        name: out[lo:hi].view(*shape, B)
        for name, shape, lo, hi in zip(FIELDS, tabs.shapes, tabs.offs,
                                       tabs.offs[1:])
    }
    return dataclasses.replace(d, **fields)
