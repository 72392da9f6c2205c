"""Core types of the batched physics engine (port of
gymnasium_robotics_tpu/physics/types.py).

``Meta`` and ``Option`` are host-side, hashable Python: the static structure
every stage specialises on. ``Model`` and ``Data`` are dataclasses of torch
tensors in the batch-last layout of the JAX SoA path (physics/soa.py there):
``qpos (nq, B)``, vectors ``(n, 3, B)``, ``qM (nv, nv, B)``. Model leaves
carry a trailing broadcast axis of size 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

# Joint types (MuJoCo's mjtJoint codes)
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# Geom types (mjtGeom)
PLANE, HFIELD, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX, MESH = range(8)
# Integrators
EULER, RK4 = 0, 1
JNT_DOF_WIDTH = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}
# Actuator transmission / gain / bias / dynamics types
TRN_JOINT, TRN_JOINTINPARENT, TRN_SLIDERCRANK, TRN_TENDON, TRN_SITE = range(5)
GAIN_FIXED, GAIN_AFFINE, GAIN_MUSCLE = 0, 1, 2
BIAS_NONE, BIAS_AFFINE, BIAS_MUSCLE = 0, 1, 2
DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT = 0, 1, 2, 3
SENS_TOUCH = 0
# Equality constraint types (mjtEq)
EQ_CONNECT, EQ_WELD, EQ_JOINT, EQ_TENDON = 0, 1, 2, 3
EQ_NAMES = ("connect", "weld", "joint", "tendon")


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options. Every key the shipped model files carry is
    accepted, including the TPU switches of the JAX package
    (``fused_solver``, ``soa``, ``slot_pack``, ``gather_mode``,
    ``narrowphase_kernel``, ``fk_kernel``, ``fk_jump``, ``mpr``). Of those
    the port reads:
    - ``fk_kernel``: True or "force" takes the FK kernel
      (physics/kinematics.py), "auto" takes it on a CUDA tensor, False
      (the default) never, as soa.kinematics :392-404 reads it with the
      card in the TPU's place;
    - ``fk_jump``: the pointer-jumping FK unless False;
    - ``soa``: False names the per-env path, whose nv = 2 constraint solve
      is the closed form (solver.solve_newton_nv2);
    - ``need_con_force``/``need_cfrc_ext``: whether the contact forces are
      decoded."""

    timestep: float = 0.002
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    iterations: int = 20
    ls_iterations: int = 10
    tolerance: float = 1e-8
    impratio: float = 1.0
    integrator: int = EULER
    density: float = 0.0
    viscosity: float = 0.0
    contact_cap: int = 0
    pair_topk: int = 0
    narrowphase_kernel: Any = "auto"
    gather_mode: str = "auto"
    fused_solver: str = "auto"
    soa: Any = "auto"
    mpr: Any = "auto"
    fk_kernel: Any = False
    fk_jump: Any = "auto"
    need_cfrc_ext: bool = True
    need_con_force: Any = "auto"
    slot_pack: Any = "auto"
    disable_contact: bool = False
    disable_gravity: bool = False
    disable_limit: bool = False
    disable_equality: bool = False
    disable_clampctrl: bool = False


@dataclasses.dataclass(frozen=True)
class Meta:
    """Hashable structural metadata (tuples only)."""

    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    neq: int
    nmocap: int
    ntendon: int
    nwrap: int
    nsensor: int
    nsensordata: int

    opt: Option

    body_parentid: Tuple[int, ...]
    body_rootid: Tuple[int, ...]
    body_jntadr: Tuple[int, ...]
    body_jntnum: Tuple[int, ...]
    body_dofadr: Tuple[int, ...]
    body_dofnum: Tuple[int, ...]
    body_mocapid: Tuple[int, ...]
    body_weldid: Tuple[int, ...]
    levels: Tuple[Tuple[int, ...], ...]

    jnt_type: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_limited: Tuple[int, ...]
    jnt_actfrclimited: Tuple[int, ...]

    dof_bodyid: Tuple[int, ...]
    dof_jntid: Tuple[int, ...]
    dof_parentid: Tuple[int, ...]

    geom_type: Tuple[int, ...]
    geom_bodyid: Tuple[int, ...]
    geom_condim: Tuple[int, ...]
    geom_priority: Tuple[int, ...]

    site_bodyid: Tuple[int, ...]

    eq_type: Tuple[int, ...]
    eq_obj1id: Tuple[int, ...]
    eq_obj2id: Tuple[int, ...]
    eq_active0: Tuple[int, ...]

    actuator_trntype: Tuple[int, ...]
    actuator_trnid: Tuple[int, ...]
    actuator_gaintype: Tuple[int, ...]
    actuator_biastype: Tuple[int, ...]
    actuator_dyntype: Tuple[int, ...]
    actuator_ctrllimited: Tuple[int, ...]
    actuator_forcelimited: Tuple[int, ...]
    actuator_actadr: Tuple[int, ...]
    actuator_actnum: Tuple[int, ...]

    tendon_adr: Tuple[int, ...]
    tendon_num: Tuple[int, ...]
    tendon_limited: Tuple[int, ...]
    wrap_objid: Tuple[int, ...]

    sensor_type: Tuple[int, ...]
    sensor_objid: Tuple[int, ...]
    sensor_adr: Tuple[int, ...]
    sensor_dim: Tuple[int, ...]

    pairs: Tuple[Tuple[int, int], ...]
    con_condim: Tuple[int, ...] = ()
    tendon_kind: Tuple[str, ...] = ()
    site_type: Tuple[int, ...] = ()

    has_damping: bool = False

    geom_hullid: Tuple[int, ...] = ()

    body_names: Tuple[str, ...] = ()
    joint_names: Tuple[str, ...] = ()
    geom_names: Tuple[str, ...] = ()
    site_names: Tuple[str, ...] = ()
    actuator_names: Tuple[str, ...] = ()
    sensor_names: Tuple[str, ...] = ()
    tendon_names: Tuple[str, ...] = ()


# Model leaves that keep no trailing batch axis (per-hull tables).
HULL_FIELDS = ("hull_vert", "hull_face")
# The model constants forward kinematics reads (the FK kernel's tables).
FK_TABLES = ("body_pos", "body_quat", "body_ipos", "body_iquat", "jnt_pos",
             "jnt_axis", "qpos0", "geom_pos", "geom_quat", "site_pos",
             "site_quat")
# The Model fields each plan's builder reads besides meta and device, by
# the plan's name (Model.plan); a builder not named reads none. A copy made
# by Model.rebind shares the plans that read none of its rebound fields.
PLAN_READS = {
    "fk_kernel": FK_TABLES,
    "narrow": ("hull_vert", "hull_face"),
    "pruned": ("geom_size", "hull_vert"),
    "rows": ("qpos0",),
    "tree": ("qpos0",),
}


@dataclasses.dataclass
class Model:
    """Compiled model: static Meta + numeric tensors, each with a trailing
    broadcast axis of size 1 (hull tables excepted)."""

    meta: Meta

    qpos0: Any
    qpos_spring: Any

    body_pos: Any
    body_quat: Any
    body_ipos: Any
    body_iquat: Any
    body_mass: Any
    body_subtreemass: Any
    body_inertia: Any
    body_invweight0: Any

    jnt_pos: Any
    jnt_axis: Any
    jnt_range: Any
    jnt_stiffness: Any
    jnt_margin: Any
    jnt_solref: Any
    jnt_solimp: Any

    dof_armature: Any
    dof_damping: Any
    dof_frictionloss: Any
    dof_invweight0: Any
    dof_solref: Any
    dof_solimp: Any

    geom_pos: Any
    geom_quat: Any
    geom_size: Any
    geom_friction: Any
    geom_margin: Any
    geom_gap: Any
    geom_solref: Any
    geom_solimp: Any
    geom_solmix: Any
    geom_rbound: Any

    site_pos: Any
    site_quat: Any
    site_size_arr: Any

    eq_data: Any
    eq_solref: Any
    eq_solimp: Any

    actuator_gear: Any
    actuator_ctrlrange: Any
    actuator_forcerange: Any
    actuator_actrange: Any
    actuator_gainprm: Any
    actuator_biasprm: Any
    actuator_dynprm: Any

    tendon_range: Any
    tendon_stiffness: Any
    tendon_damping: Any
    tendon_lengthspring: Any
    tendon_invweight0: Any
    tendon_solref_lim: Any
    tendon_solimp_lim: Any
    tendon_margin: Any
    wrap_prm: Any

    geom_rgba: Any = None
    hull_vert: Any = None
    hull_face: Any = None
    con_friction: Any = None
    con_solref: Any = None
    con_solimp: Any = None
    con_includemargin: Any = None

    @property
    def nq(self):
        return self.meta.nq

    @property
    def nv(self):
        return self.meta.nv

    @property
    def nu(self):
        return self.meta.nu

    @property
    def opt(self):
        return self.meta.opt

    def with_options(self, **kw) -> "Model":
        """A copy with Option fields overridden (e.g. iterations)."""
        opt = dataclasses.replace(self.meta.opt, **kw)
        return dataclasses.replace(
            self, meta=dataclasses.replace(self.meta, opt=opt)
        )

    def plan(self, name: str, build):
        """Static per-model tables (index tensors on the model's device),
        built once by ``build(model)`` and kept on this instance. A copy made
        by ``with_options`` starts with no tables, since its Meta differs;
        one made by ``rebind`` shares its origin's tables where the builder
        reads none of the rebound fields (PLAN_READS)."""
        cache = self.__dict__.setdefault("_plans", {})
        shared = self.__dict__.get("_shared_plans")
        if shared is not None and not self.__dict__["_rebound"].intersection(
                PLAN_READS.get(name, ())):
            cache = shared
        p = cache.get(name)
        if p is None:
            p = cache[name] = build(self)
        return p

    def rebind(self, **fields) -> "Model":
        """A copy with the given array fields replaced, e.g. a body_pos of
        (nbody, 3, B) that places each env's scene: the per-env model an env
        step runs. It shares this model's plans except those whose builders
        read a rebound field, so rebinding at every step builds no table
        anew but those."""
        out = dataclasses.replace(self, **fields)
        root = self.__dict__.get("_shared_plans")
        out.__dict__["_shared_plans"] = (
            self.__dict__.setdefault("_plans", {}) if root is None else root)
        out.__dict__["_rebound"] = frozenset(fields).union(
            self.__dict__.get("_rebound", ()))
        return out

    @property
    def device(self):
        return self.qpos0.device


def array_fields():
    """Names of the Model fields that hold tensors."""
    return [f.name for f in dataclasses.fields(Model) if f.name != "meta"]


@dataclasses.dataclass
class Contact:
    """Fixed-size contact table, batch-last: dist (ncon, B), pos
    (ncon, 3, B), frame (ncon, 3, 3, B) with rows normal, tan1, tan2.
    geom1/geom2 are the static slot geoms (ncon,); under pair-topk pruning
    the table is compact and per env: src (ncon, B) maps each slot to its
    canonical static slot id, and geom1/geom2 are (ncon, B)."""

    dist: Any
    pos: Any
    frame: Any
    geom1: Any
    geom2: Any
    src: Any = None


@dataclasses.dataclass
class Data:
    """Simulation state and derived quantities, batch-last."""

    time: Any          # (B,)
    qpos: Any          # (nq, B)
    qvel: Any          # (nv, B)
    act: Any           # (na, B)
    ctrl: Any          # (nu, B)
    qfrc_applied: Any  # (nv, B)
    mocap_pos: Any     # (nmocap, 3, B)
    mocap_quat: Any    # (nmocap, 4, B)
    eq_active: Any     # (neq, B) bool

    xpos: Any
    xquat: Any
    xmat: Any
    xipos: Any
    ximat: Any
    xanchor: Any
    xaxis: Any
    geom_xpos: Any
    geom_xmat: Any
    site_xpos: Any
    site_xmat: Any
    subtree_com: Any

    cinert: Any
    cdof: Any
    cvel: Any
    cdof_dot: Any

    ten_length: Any
    ten_velocity: Any
    ten_J: Any

    qM: Any
    qfrc_bias: Any
    qfrc_passive: Any
    qfrc_actuator: Any
    actuator_length: Any
    actuator_velocity: Any
    actuator_force: Any
    qfrc_smooth: Any
    qacc_smooth: Any
    qfrc_constraint: Any
    qacc: Any

    contact: Contact
    con_force: Any     # (ncon, 6, B)
    cfrc_ext: Any      # (nbody, 6, B)
    sensordata: Any    # (nsensordata, B)
