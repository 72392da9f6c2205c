"""Each substep stage of the port on HandManipulateBlock (the touch-sensor
model, 97 touch sensors) against its JAX batch-last counterpart
(gymnasium_robotics_tpu.physics.soa): the fixed tendons, their springs,
the tendon-limit rows, box-hull on the unpruned table and the touch
sensors, in float64 and float32.

The state is a batch of hands around the block: the block pressed onto
the first and middle fingertips (capsule-box rows and fingertip touch), the
block pressed into the palm (box-box rows and palm touch), the block pushed
into the forearm's hull (box-hull rows with MPR), and every hand joint past
a limit with the block on the floor (joint- and tendon-limit rows,
plane-box rows). Both sides start every stage from the very same state: the
JAX state before the stage is carried into the port through
convert.data_from_numpy. The JAX side runs its XLA path (the CPU default:
lax.top_k selection, the formula chains with MPR and the generic Newton
solve), each stage compiled on its own.

Tolerance: relative error scaled by max(1, |ref|) <= 1e-9 for the port in
float64 (the same operations rounded in another order) and <= 2e-4 for the
port in float32 against the same float64 reference; contact frames compare
with equal_nan and contact distances on their own scale (the rows far from
touching carry 1e10)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.hand.hand import HandManipulateBlockEnv as JBlock
from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint as tcst
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm

TOLS = {"float64": 1e-9, "float32": 2e-4}
B = 4
BIG = 1e9   # distances above this are rows far from touching (1e10)
N_ROWS = 24 + 88 + 16 * 4 + 16 * 6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def jax_data_to_numpy(d):
    """B-leading numpy leaves of a JAX batched Data (convert's input)."""
    out = {f.name: np.asarray(getattr(d, f.name))
           for f in dataclasses.fields(d) if f.name != "contact"}
    c = d.contact
    out["contact"] = {n: None if getattr(c, n) is None else np.asarray(getattr(c, n))
                      for n in ("dist", "pos", "frame", "geom1", "geom2", "src")}
    return out


def cast_data(d, dtype):
    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    c = d.contact
    return dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))


def to_port(ds, dtype="float64"):
    """JAX SoA (batch-last) Data -> the port's Data, through numpy."""
    return cast_data(convert.data_from_numpy(
        jax_data_to_numpy(soa._data_from_soa(ds)), "cpu"), getattr(torch, dtype))


def port_model(m, dtype="float64"):
    return convert.model_from_numpy(
        {f.name: np.asarray(getattr(m, f.name))
         for f in dataclasses.fields(m)
         if f.name not in ("meta", "fk_np") and getattr(m, f.name) is not None},
        jser._meta_to_json(m.meta), getattr(torch, dtype), "cpu",
    )


def hand_states(env, rs):
    """(qpos (B, nq), qvel (B, nv)): the block pressed onto the first and
    middle fingertips, into the palm, into the forearm's hull, and every
    hand joint 0.02 past one of its limits with the block 5 mm into the
    floor."""
    m = env.model
    mt = m.meta
    q0 = np.asarray(env._init_qpos, np.float64)
    oq = env._obj_qadr
    qpos = np.tile(q0, (B, 1))
    qpos[0, oq:oq + 3] = [0.967, 0.749, 0.144]
    qpos[1, oq + 2] = 0.165
    qpos[2, oq:oq + 3] = [1.0, 1.008, 0.13]
    nh = env._robot_nq
    lo = np.asarray(m.jnt_range[:nh, 0])
    hi = np.asarray(m.jnt_range[:nh, 1])
    qpos[3, :nh] = np.where(rs.rand(nh) < 0.5, lo - 0.02, hi + 0.02)
    qpos[3, oq + 2] = 0.02
    yaw = rs.uniform(-0.3, 0.3, B)
    qpos[:, oq + 3:oq + 7] = np.stack(
        [np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], axis=1)
    qvel = rs.normal(0, 0.05, (B, mt.nv))
    return qpos, qvel


def batched_state(env, rs):
    """The hand states as a JAX SoA Data, kinematics not yet run, with
    random warm starts and controls."""
    m = env.model
    d0 = jpipe.make_data(m, dtype=jnp.float64)
    qpos, qvel = hand_states(env, rs)
    db = jax.vmap(lambda q, v, a, c: dataclasses.replace(
        d0, qpos=q, qvel=v, qacc=a, ctrl=c))(
        jnp.asarray(qpos), jnp.asarray(qvel),
        jnp.asarray(rs.normal(0, 1.0, (B, m.nv))),
        jnp.asarray(rs.uniform(-0.5, 0.5, (B, m.nu))))
    return soa._data_to_soa(db, jax.tree_util.tree_map(lambda _: True, db), B)


@pytest.fixture(scope="module")
def models():
    env = JBlock(touch_obs="sensordata", dtype=jnp.float64)
    m = env.model
    return env, soa._model_to_soa(m, None), port_model(m)


SMOOTH = [("kinematics", tsm.kinematics), ("com_pos", tsm.com_pos),
          ("tendon", tsm.tendon), ("crb", tsm.crb),
          ("collision", tcol.collision), ("com_vel", tsm.com_vel),
          ("rne", tsm.rne), ("fwd_passive", tsm.fwd_passive),
          ("fwd_actuation", tsm.fwd_actuation)]


def compiled(fn, *args):
    """fn(*args) compiled on its own (at XLA's lowest backend optimisation
    level, which changes how fast the compiler runs, not the arithmetic):
    stage by stage this is faster than running the stages op by op."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def chain(models):
    """soa.forward stage by stage with every intermediate state kept:
    {stage: the state after it}, the rows build_rows makes from the
    smoothed state, the sensors and the Euler substep."""
    _, ms, _ = models
    out = {"input": batched_state(models[0], np.random.RandomState(0))}
    d = out["input"]
    for name, _ in SMOOTH:
        d = compiled(functools.partial(getattr(soa, name), ms), d)
        out[name] = d

    def smooth(d):
        qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                       + d.qfrc_applied)
        return dataclasses.replace(
            d, qfrc_smooth=qfrc_smooth,
            qacc_smooth=soa._spd_solve(ms, d.qM, qfrc_smooth))

    d = out["smooth"] = compiled(smooth, d)
    out["rows"] = compiled(lambda x: soa.build_rows(ms, x)[:5], d)
    out["solve_constraints"] = compiled(
        functools.partial(soa.solve_constraints, ms), d)
    out["sensors"] = compiled(functools.partial(soa.sensors, ms),
                              out["solve_constraints"])
    out["euler"] = compiled(functools.partial(soa._euler, ms), out["sensors"])
    return out


FIELDS = {
    "tendon": ["ten_length", "ten_J", "ten_velocity"],
    "collision": ["contact"],
    "fwd_passive": ["qfrc_passive"],
    "solve_constraints": ["qacc", "qfrc_constraint", "con_force"],
    "sensors": ["sensordata"],
    "euler": ["qpos", "qvel", "time"],
}
PREV = {"tendon": "com_pos", "collision": "crb", "fwd_passive": "rne",
        "solve_constraints": "smooth", "sensors": "solve_constraints",
        "euler": "sensors"}
PORT = dict(SMOOTH, solve_constraints=tcst.solve_constraints,
            sensors=tcst.sensors, euler=tpipe._euler)
# stages held in float32 too: the slice's modules, each from the same state
F32 = ("tendon", "collision", "fwd_passive", "sensors")


def assert_contact_equal(tc, jc, tol, rows_of_solve=False):
    """The contact table: distances on their own scale (rows far from
    touching must agree on being so), pos and frames (NaN-equal) against
    the largest entry: of every row, or with ``rows_of_solve`` of the
    penetrating rows, the rows a solve reads (in float32 two corners of a
    box that lie apart by less than its resolution, on a slot far from
    touching, can trade places)."""
    a, b = np.asarray(jc.dist), tc.dist.numpy()
    assert b.shape == a.shape
    near = a < BIG
    np.testing.assert_array_equal(b < BIG, near)
    assert rel_err(b[near], a[near]) <= tol
    keep = a < 0 if rows_of_solve else np.ones_like(near)
    assert keep.any()
    for k in ("pos", "frame"):
        a = np.asarray(getattr(jc, k))
        b = getattr(tc, k).numpy()
        assert b.shape == a.shape, (k, b.shape, a.shape)
        a, b = np.moveaxis(a, -1, 1)[keep], np.moveaxis(b, -1, 1)[keep]
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(
            1.0, np.nanmax(np.abs(a))), equal_nan=True, err_msg=k)


@pytest.mark.parametrize("name,dtype", [(n, "float64") for n in FIELDS]
                         + [(n, "float32") for n in F32])
def test_stage_matches_soa(models, chain, name, dtype):
    _, ms, _ = models
    tol = TOLS[dtype]
    tm = port_model(models[0].model, dtype)
    tout = PORT[name](tm, to_port(chain[PREV[name]], dtype))
    jout = chain[name]
    for fld in FIELDS[name]:
        if fld == "contact":
            assert_contact_equal(tout.contact, jout.contact, tol,
                                 rows_of_solve=dtype == "float32")
            continue
        a = np.asarray(getattr(jout, fld))
        b = getattr(tout, fld).numpy()
        assert b.shape == a.shape, (fld, b.shape, a.shape)
        assert rel_err(b, a) <= tol, (fld, rel_err(b, a))


def test_state_touches_every_module(models, chain):
    """Every pair kind has penetrating slots, the joint- and tendon-limit
    rows are active, the springs pull and the touch sensors read forces on
    the fingertips and the palm."""
    env, _, tm = models
    mt = tm.meta
    dist = np.asarray(chain["collision"].contact.dist)
    g1s, g2s = tcol.slot_geoms_static(mt)
    kinds = {(mt.geom_type[a], mt.geom_type[b]) for a, b in zip(g1s, g2s)}
    for tp in kinds - {(0, 3)}:     # no fingertip reaches the floor
        rows = [i for i, (a, b) in enumerate(zip(g1s, g2s))
                if (mt.geom_type[a], mt.geom_type[b]) == tp]
        assert (dist[rows] < 0).any(), tp
    J, aref, D, R, active = (np.asarray(x) for x in chain["rows"])
    assert J.shape[:2] == (N_ROWS, 36)
    assert active[:24, 3].any() and active[24:112, 3].any()
    assert not active[24:112, 0].any()
    sd = np.asarray(chain["sensors"].sensordata)
    touch = [mt.sensor_adr[s] for s in range(mt.nsensor)
             if mt.sensor_type[s] == 0]
    names = [mt.sensor_names[s] for s in range(mt.nsensor)
             if mt.sensor_type[s] == 0]
    on = {n for n, a in zip(names, touch) if (sd[a] > 0).any()}
    assert {"robot0:ST_Tch_fftip", "robot0:ST_Tch_mftip"} <= on
    assert any(n.startswith("robot0:TS_palm") for n in on)
    assert np.abs(np.asarray(chain["fwd_passive"].qfrc_passive)).max() > 0


def test_build_rows_matches_soa(models, chain):
    """Rows and their order: 24 joint-limit rows, 88 tendon-limit rows
    ([lower, upper] per tendon), then the capped condim-3 and condim-4
    contact groups."""
    _, _, tm = models
    J, aref, D, R, active, is_eq, layout = tcst.build_rows(
        tm, to_port(chain["smooth"]))
    jJ, jaref, jD, jR, jactive = chain["rows"]
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    assert is_eq.shape == (N_ROWS,) and not is_eq.any()
    for name, a, b in (("J", jJ, J), ("aref", jaref, aref), ("D", jD, D),
                       ("R", jR, R)):
        assert rel_err(b.numpy(), a) <= TOLS["float64"], name
    assert [(cd, tuple(sel_c.shape), base) for cd, sel_c, _, base in layout] == \
        [(3, (16, B), 112), (4, (16, B), 176)]


def test_unported_models_raise(models):
    """A spatial tendon, and a hull kind the unpruned table does not have,
    raise naming what brings them."""
    _, _, tm = models
    mt = tm.meta
    spatial = dataclasses.replace(
        tm, meta=dataclasses.replace(mt, tendon_kind=("spatial2",) * mt.ntendon))
    d = tpipe.make_data(spatial, 1)
    with pytest.raises(NotImplementedError, match="spatial"):
        tsm.tendon(spatial, d)
    obj = mt.geom_names.index("object")
    hull = mt.geom_names.index("robot0:C_forearm")
    for kind, brings in ((4, "HandManipulateEgg"), (3, "HandManipulatePen")):
        types = list(mt.geom_type)
        types[obj] = kind      # the block as an ellipsoid or a capsule
        bm = dataclasses.replace(tm, meta=dataclasses.replace(
            mt, geom_type=tuple(types), pairs=((obj, hull),)))
        with pytest.raises(NotImplementedError, match=brings):
            tcol.collision(bm, tpipe.make_data(bm, 1))


def test_sensors_on_a_compact_table(models, chain):
    """The touch sensors over a pair-topk compact table (per-lane slot map
    src, the branch Adroit's pruned tables take): 60 compact slots drawn
    per lane from the static table, with its positions and forces."""
    env, ms, tm = models
    d = chain["solve_constraints"]
    rs = np.random.RandomState(3)
    ncon = d.contact.dist.shape[0]
    src = rs.randint(0, ncon, (60, B))
    lane = np.arange(B)[None]
    g1s, g2s = tcol.slot_geoms_static(tm.meta)

    def pick(x):
        return jnp.asarray(np.asarray(x)[src, ..., lane].transpose(
            (0,) + tuple(range(2, np.asarray(x).ndim)) + (1,)))

    c = dataclasses.replace(
        d.contact, dist=pick(d.contact.dist), pos=pick(d.contact.pos),
        frame=pick(d.contact.frame), src=jnp.asarray(src),
        geom1=jnp.asarray(g1s[src]), geom2=jnp.asarray(g2s[src]))
    dc = dataclasses.replace(d, contact=c, con_force=pick(d.con_force))
    ref = compiled(functools.partial(soa.sensors, ms), dc)
    got = tcst.sensors(tm, to_port(dc))
    a = np.asarray(ref.sensordata)
    assert (a > 0).any()
    assert rel_err(got.sensordata.numpy(), a) <= TOLS["float64"]
