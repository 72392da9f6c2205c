"""Each substep stage of the port on AntMaze_UMaze-v5 against its JAX
batch-last counterpart (gymnasium_robotics_tpu.physics.soa), in float64.

The state is a batch of ants with legs pressed into the maze's walls and
the floor (joint limits crossed, capsule-box and plane-capsule contacts).
Both sides start every stage from the very same state: the JAX state before
the stage is carried into the port through convert.data_from_numpy. The
JAX side runs its XLA path (the CPU default: lax.top_k selection, the
formula chains and the generic Newton solve), compiled once for all stages;
tests/test_narrowphase_kernel.py pins that path to the Pallas megakernel.
The RK4 step is held through the env (test_torch_antmaze.py).

Tolerance: relative error scaled by max(1, |ref|) <= 1e-9 (the same
operations rounded in another order); contact frames compare with
equal_nan; the compact slot map (src, geom1, geom2) must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.maze.ant_maze import AntMazeEnv as JAnt
from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint as tcst
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm

TOL = 1e-9
B = 8


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


def pressed_qpos(m, rs, n):
    """(n, nq) ant poses in the U-maze's top-left cell, torso 0.5-1.0 from
    the cell's top (y = 6) or left (x = -6) wall, low enough for the legs
    to meet the floor, tilted, hinges drawn across their ranges and a
    little past them."""
    qpos = np.tile(np.asarray(m.qpos0), (n, 1))
    u = rs.uniform(0.5, 1.0, n)
    along = rs.uniform(-5.0, -3.0, n)
    top = np.arange(n) % 2 == 0
    qpos[:, 0] = np.where(top, along, -6.0 + u)
    qpos[:, 1] = np.where(top, 6.0 - u, along + 8.0)
    qpos[:, 2] = rs.uniform(0.25, 0.55, n)
    q = np.concatenate([np.ones((n, 1)), rs.normal(0, 0.15, (n, 3))], axis=1)
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    lo, hi = np.asarray(m.jnt_range)[1:].T
    qpos[:, 7:] = rs.uniform(lo - 0.1, hi + 0.1, (n, len(lo)))
    return qpos


@pytest.fixture(scope="module")
def models():
    env = JAnt(dtype=jnp.float64)
    m = env.model
    return m, soa._model_to_soa(m, None), port_model(m)


@pytest.fixture(scope="module")
def state(models):
    m, _, _ = models
    rs = np.random.RandomState(0)
    d0 = jpipe.make_data(m, dtype=jnp.float64)
    db = jax.vmap(lambda q, v, a, c: dataclasses.replace(
        d0, qpos=q, qvel=v, qacc=a, ctrl=c))(
        jnp.asarray(pressed_qpos(m, rs, B)),
        jnp.asarray(rs.normal(0, 1, (B, m.nv))),
        jnp.asarray(rs.normal(0, 3, (B, m.nv))),
        jnp.asarray(rs.uniform(-1, 1, (B, m.nu))))
    return soa._data_to_soa(db, jax.tree_util.tree_map(lambda _: True, db), B)


SMOOTH = [("kinematics", tsm.kinematics), ("com_pos", tsm.com_pos),
          ("tendon", tsm.tendon), ("crb", tsm.crb),
          ("collision", tcol.collision), ("com_vel", tsm.com_vel),
          ("rne", tsm.rne), ("fwd_passive", tsm.fwd_passive),
          ("fwd_actuation", tsm.fwd_actuation)]


def _jax_chain(ms, ds):
    """soa.forward with every intermediate state kept: {stage: the state
    after it}, plus the rows build_rows makes from the smoothed state."""
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
    return out


@pytest.fixture(scope="module")
def chain(models, state):
    _, ms, _ = models
    return jax.jit(_jax_chain)(ms, state)


FIELDS = {
    "kinematics": ["xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                   "xaxis", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"],
    "com_pos": ["subtree_com", "cinert", "cdof"],
    "crb": ["qM"],
    "collision": ["contact"],
    "com_vel": ["cvel", "cdof_dot"],
    "rne": ["qfrc_bias"],
    "fwd_passive": ["qfrc_passive"],
    "fwd_actuation": ["actuator_length", "actuator_velocity",
                      "actuator_force", "qfrc_actuator"],
    "solve_constraints": ["qacc", "qfrc_constraint", "con_force", "cfrc_ext"],
    "forward": ["xpos", "qM", "contact", "qfrc_bias", "qfrc_smooth",
                "qacc_smooth", "qacc", "qfrc_constraint", "con_force",
                "cfrc_ext"],
}
PREV = {name: prev for (name, _), (prev, _) in zip(SMOOTH[1:], SMOOTH)}
PREV.update(kinematics="input", solve_constraints="smooth", forward="input")
PORT = dict(SMOOTH, solve_constraints=tcst.solve_constraints,
            forward=tpipe.forward)


def assert_contact_equal(tc, jc):
    for k in ("dist", "pos", "frame"):
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


def test_state_presses_legs_into_walls(models, chain):
    """The stage inputs cover what the slice brings: pruned capsule-box
    contacts that penetrate, floor contacts, crossed joint limits and
    nonzero contact wrenches on the ant's bodies."""
    m, _, _ = models
    c = chain["collision"].contact
    dist, g2 = np.asarray(c.dist), np.asarray(c.geom2)
    box = np.asarray(m.meta.geom_type)[g2] == 6
    assert ((dist < 0) & box).any(axis=0).sum() >= 2
    assert ((dist < 0) & ~box).any(axis=0).sum() >= 2
    J, aref, D, R, active = chain["rows"]
    assert J.shape[:2] == (72, 14)
    assert np.asarray(active)[:8].any()                  # joint limits
    cfrc = np.asarray(chain["solve_constraints"].cfrc_ext)
    assert (np.abs(cfrc[1:]) > 1e-3).any()


def test_build_rows_matches_soa(models, chain):
    _, _, tm = models
    J, aref, D, R, active, is_eq, layout = tcst.build_rows(
        tm, to_port(chain["smooth"]))
    jJ, jaref, jD, jR, jactive = chain["rows"]
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    assert not is_eq.any() and is_eq.shape == (72,)
    for name, a, b in (("J", jJ, J), ("aref", jaref, aref), ("D", jD, D),
                       ("R", jR, R)):
        assert rel_err(b.numpy(), a) <= TOL, name
    # one capped condim-3 group of 16 slots per env, after the 8 limit rows
    [(cd, sel_c, sel, base)] = layout
    assert (cd, tuple(sel_c.shape), base) == (3, (16, B), 8)


def test_mesh_group_names_its_slice(models):
    _, _, tm = models
    gt = list(tm.meta.geom_type)
    gt[tm.meta.geom_names.index("torso_geom")] = 7          # a mesh
    meta = dataclasses.replace(tm.meta, geom_type=tuple(gt))
    meta = dataclasses.replace(meta, con_condim=(3,) * tcol.ncon_static(meta))
    m2 = dataclasses.replace(tm, meta=meta)
    d = tsm.kinematics(m2, tpipe.make_data(m2, 2))
    with pytest.raises(NotImplementedError, match="convex hulls"):
        tcol.collision(m2, d)
