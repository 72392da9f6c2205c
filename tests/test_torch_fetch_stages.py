"""Each substep stage of the port on FetchPush-v4 against its JAX batch-last
counterpart (gymnasium_robotics_tpu.physics.soa), in float64, and one
PickAndPlace substep.

The state is a batch of Fetch arms around the object: the object resting
on the table against the fingers, the arm lowered into the table, the
object held between the fingers and against the gripper link, and an arm
bent onto itself; the mocap body is displaced from the gripper link so the
weld pulls. So every group of the compact table has penetrating rows:
plane-hull, plane-box, box-box, and the MPR groups box-hull and hull-hull.
Both sides start every stage from the very same state: the JAX state
before the stage is carried into the port through convert.data_from_numpy.
The JAX side runs its XLA path (the CPU default: lax.top_k selection, the
formula chains with MPR and the generic Newton solve), compiled once for
all stages.

Tolerance: relative error scaled by max(1, |ref|) <= 1e-9 (the same
operations rounded in another order); contact frames compare with
equal_nan, the slot map (src, geom1, geom2) must be equal, and contact
distances compare on their own scale (the rows far from touching carry
1e10)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.fetch.fetch import FetchPickAndPlaceEnv as JPnP
from gymnasium_robotics_tpu.envs.fetch.fetch import FetchPushEnv as JPush
from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchPushEnv
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint as tcst
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm

TOL = 1e-9
B = 5
BIG = 1e9   # distances above this are rows far from touching (1e10)


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


def to_port(ds):
    """JAX SoA (batch-last) Data -> the port's Data, through numpy."""
    return convert.data_from_numpy(
        jax_data_to_numpy(soa._data_from_soa(ds)), "cpu")


def port_model(m):
    return convert.model_from_numpy(
        {f.name: np.asarray(getattr(m, f.name))
         for f in dataclasses.fields(m)
         if f.name not in ("meta", "fk_np") and getattr(m, f.name) is not None},
        jser._meta_to_json(m.meta), torch.float64, "cpu",
    )


def arm_states(env, rs, n):
    """(qpos (n, nq), qvel (n, nv), mocap_pos (n, 1, 3), mocap_quat
    (n, 1, 4)) of Fetch arms around the object, cycling through five
    poses: the object on the table pressed against the fingers' front; the
    arm lowered 0.1 into the table (fingers and gripper link); the object
    between the fingers, up against the gripper link; the arm bent onto
    itself; the robot moved off the table and lowered onto the floor, with
    the object on the floor. The mocap body sits 1-3 cm from the gripper
    link."""
    q0 = np.asarray(env._init_qpos, np.float64)
    m = env.model
    mt = m.meta
    oq = mt.jnt_qposadr[mt.joint_names.index("object0:joint")]
    qpos = np.tile(q0, (n, 1))
    for i in range(n):
        pose = i % 5
        yaw = rs.uniform(-0.3, 0.3)
        qpos[i, oq + 3:oq + 7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
        if pose == 0:
            qpos[i, oq:oq + 3] = [1.362 + 0.0385 + 0.025 - 0.004, 0.7486,
                                  0.4249 - 0.0005]
        elif pose == 1:
            qpos[i, 2] -= 0.1
        elif pose == 2:
            qpos[i, oq:oq + 3] = [1.362, 0.7486, 0.47]
        elif pose == 4:
            qpos[i, 1] += 0.45
            qpos[i, 2] -= 0.422
            qpos[i, oq:oq + 3] = [0.9, 1.3, 0.02]
        else:   # the wrist and gripper fold back into the forearm
            qpos[i, 6:13] += [0.235, 0.835, -0.117, 0.7, 0.029, 0.204, 0.426]
    qvel = rs.normal(0, 0.05, (n, mt.nv))
    mocap_pos = np.asarray(env._init_mocap_pos)[None] + rs.uniform(-0.03, 0.03, (n, 1, 3))
    mocap_quat = np.asarray(env._init_mocap_quat)[None] + rs.normal(0, 0.1, (n, 1, 4))
    return qpos, qvel, mocap_pos, mocap_quat


def batched_state(env, rs, n):
    """The arm states as a JAX SoA Data, kinematics not yet run."""
    m = env.model
    d0 = jpipe.make_data(m, dtype=jnp.float64)
    qpos, qvel, mp, mq = arm_states(env, rs, n)
    db = jax.vmap(lambda q, v, a, p, r, c: dataclasses.replace(
        d0, qpos=q, qvel=v, qacc=a, mocap_pos=p, mocap_quat=r, ctrl=c))(
        jnp.asarray(qpos), jnp.asarray(qvel),
        jnp.asarray(rs.normal(0, 1.0, (n, m.nv))), jnp.asarray(mp),
        jnp.asarray(mq), jnp.asarray(rs.uniform(-0.01, 0.01, (n, m.nu))))
    return soa._data_to_soa(db, jax.tree_util.tree_map(lambda _: True, db), n)


@pytest.fixture(scope="module")
def models():
    env = JPush(dtype=jnp.float64)
    m = env.model
    return env, soa._model_to_soa(m, None), port_model(m)


@pytest.fixture(scope="module")
def state(models):
    return batched_state(models[0], np.random.RandomState(0), B)


SMOOTH = [("kinematics", tsm.kinematics), ("com_pos", tsm.com_pos),
          ("tendon", tsm.tendon), ("crb", tsm.crb),
          ("collision", tcol.collision), ("com_vel", tsm.com_vel),
          ("rne", tsm.rne), ("fwd_passive", tsm.fwd_passive),
          ("fwd_actuation", tsm.fwd_actuation)]


def _jax_chain(ms, ds):
    """soa.forward with every intermediate state kept: {stage: the state
    after it}, the rows build_rows makes from the smoothed state, and the
    Euler substep from the forwarded state."""
    out = {"input": ds}
    d = ds
    for name, _ in SMOOTH:
        d = getattr(soa, name)(ms, d)
        out[name] = d
    qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + d.qfrc_applied
    d = dataclasses.replace(d, qfrc_smooth=qfrc_smooth,
                            qacc_smooth=soa._spd_solve(ms, d.qM, qfrc_smooth))
    out["smooth"] = d
    out["rows"] = soa.build_rows(ms, d)[:5]
    out["solve_constraints"] = soa.solve_constraints(ms, d)
    out["forward"] = soa.sensors(ms, out["solve_constraints"])
    out["euler"] = soa._euler(ms, out["forward"])
    return out


@pytest.fixture(scope="module")
def chain(models, state):
    # op by op: compiling the chain (MPR unrolled 3 x 28 times) takes longer
    # on the CPU than running it eagerly, and the PickAndPlace substep below
    # reuses the compiled operations
    _, ms, _ = models
    with jax.disable_jit():
        return _jax_chain(ms, state)


FIELDS = {
    "kinematics": ["xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                   "xaxis", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"],
    "com_pos": ["subtree_com", "cinert", "cdof"],
    "crb": ["qM"],
    "collision": ["contact"],
    "com_vel": ["cvel", "cdof_dot"],
    "rne": ["qfrc_bias"],
    "fwd_passive": ["qfrc_passive"],
    "solve_constraints": ["qacc", "qfrc_constraint"],
    "forward": ["xpos", "site_xpos", "qM", "contact", "qfrc_smooth",
                "qacc_smooth", "qacc", "qfrc_constraint"],
    "euler": ["qpos", "qvel", "time"],
}
PREV = {name: prev for (name, _), (prev, _) in zip(SMOOTH[1:], SMOOTH)}
PREV.update(kinematics="input", solve_constraints="smooth", forward="input",
            euler="forward")
PORT = dict(SMOOTH, solve_constraints=tcst.solve_constraints,
            forward=tpipe.forward, euler=tpipe._euler)


def assert_contact_equal(tc, jc):
    """The compact contact table: distances on their own scale (rows far
    from touching must agree on being so), pos and frames (NaN-equal)
    against the largest entry, and the slot map exactly."""
    a, b = np.asarray(jc.dist), tc.dist.numpy()
    assert b.shape == a.shape
    near = a < BIG
    np.testing.assert_array_equal(b < BIG, near)
    assert rel_err(b[near], a[near]) <= TOL
    for k in ("pos", "frame"):
        a = np.asarray(getattr(jc, k))
        b = getattr(tc, k).numpy()
        assert b.shape == a.shape, (k, b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL * max(
            1.0, np.nanmax(np.abs(a))), equal_nan=True, err_msg=k)
    for k in ("src", "geom1", "geom2"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)


@pytest.mark.parametrize("name", list(FIELDS))
def test_stage_matches_soa(models, chain, name):
    _, _, tm = models
    tout = PORT[name](tm, to_port(chain[PREV[name]]))
    jout = chain[name]
    for fld in FIELDS[name]:
        if fld == "contact":
            assert_contact_equal(tout.contact, jout.contact)
            continue
        a = np.asarray(getattr(jout, fld))
        b = getattr(tout, fld).numpy()
        assert b.shape == a.shape, (fld, b.shape, a.shape)
        assert rel_err(b, a) <= TOL, (fld, rel_err(b, a))


def test_state_touches_every_group(models, chain):
    """Every group kind of the compact table has penetrating rows in some
    env, the weld pulls, joint limits are crossed."""
    _, _, tm = models
    c = chain["collision"].contact
    dist = np.asarray(c.dist)
    for g in tcol.prune_plan(tm.meta).groups:
        rows = dist[g.base_c:g.base_c + g.n_slots_c]
        assert (rows < 0).any(), g.tp
    J, aref, D, R, active = chain["rows"]
    assert J.shape[:2] == (255, 21)
    assert np.asarray(active)[:6].all()                  # the weld rows
    assert np.asarray(active)[6:15].any()                # joint limits


def test_build_rows_matches_soa(models, chain):
    _, _, tm = models
    J, aref, D, R, active, is_eq, layout = tcst.build_rows(
        tm, to_port(chain["smooth"]))
    jJ, jaref, jD, jR, jactive = chain["rows"]
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    assert is_eq.shape == (255,) and is_eq[:6].all() and not is_eq[6:].any()
    for name, a, b in (("J", jJ, J), ("aref", jaref, aref), ("D", jD, D),
                       ("R", jR, R)):
        assert rel_err(b.numpy(), a) <= TOL, name
    # 6 weld rows, 9 limit rows, then the capped condim-3 and condim-4 groups
    assert [(cd, tuple(sel_c.shape), base) for cd, sel_c, _, base in layout] == \
        [(3, (24, B), 15), (4, (24, B), 111)]


def test_pick_and_place_substep_matches_soa():
    """PickAndPlace (two finger position actuators, an unblocked gripper):
    one substep from the arm states with the finger ctrl set."""
    env = JPnP(dtype=jnp.float64)
    m = env.model
    ms = soa._model_to_soa(m, None)
    tm = port_model(m)
    ds = batched_state(env, np.random.RandomState(1), B)
    with jax.disable_jit():
        ref = soa.step(ms, ds)
    got = tpipe.step(tm, to_port(ds))
    assert m.meta.nu == 2
    for fld in ("qpos", "qvel", "qacc", "actuator_force"):
        a = np.moveaxis(np.asarray(getattr(ref, fld)), -1, 0)
        b = np.moveaxis(getattr(got, fld).numpy(), -1, 0)
        assert rel_err(b, a) <= TOL, fld
    assert_contact_equal(got.contact, ref.contact)


def test_site_velocities_match_jax(models, chain):
    """The observation's site velocities (fetch.site_velp/site_velr)."""
    from gymnasium_robotics_tpu.envs.fetch import fetch as jfetch

    env, _, tm = models
    tenv = FetchPushEnv(dtype=torch.float64, device="cpu")
    jd = soa._data_from_soa(chain["com_pos"])
    td = to_port(chain["com_pos"])
    for site in (env._grip_site, env._obj_site):
        body = env.model.meta.site_bodyid[site]
        rp = jax.vmap(lambda d: jfetch.site_velp(env.model, d, site, body))(jd)
        rr = jax.vmap(lambda d: jfetch.site_velr(env.model, d, site, body))(jd)
        vp, vr = tenv._site_vel(td, site, body)
        assert rel_err(vp.numpy().T, rp) <= TOL
        assert rel_err(vr.numpy().T, rr) <= TOL
