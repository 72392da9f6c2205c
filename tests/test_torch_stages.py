"""Each ported substep stage against its JAX batch-last counterpart
(gymnasium_robotics_tpu.physics.soa), on PointMaze_UMaze-v3 in float64.

Both sides start every stage from the very same state: the JAX SoA state
before the stage is carried into the port through convert.data_from_numpy.
The JAX model runs with soa="force" and fused_solver="force", so its
solves go through the Pallas kernels in interpret mode. Tolerance: relative
error scaled by max(1, |ref|) <= 1e-9 (float64; the same operations
rounded in another order). Contact frames compare with equal_nan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.maze.point_maze import PointMazeEnv
from gymnasium_robotics_tpu.mjcf import serialize as jser
from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu_torch import convert
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint as tcst
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm
from gymnasium_robotics_tpu_torch.physics import types as TT

TOL = 1e-9
B = 16


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


@pytest.fixture(scope="module")
def models():
    env = PointMazeEnv(dtype=jnp.float64)
    m = env.model.with_options(soa="force", fused_solver="force")
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(m, f.name))
         for f in dataclasses.fields(m)
         if f.name not in ("meta", "fk_np") and getattr(m, f.name) is not None},
        jser._meta_to_json(m.meta), torch.float64, "cpu",
    )
    return env, m, soa._model_to_soa(m, None), tm


@pytest.fixture(scope="module")
def state(models):
    """A batch of balls near and in the walls (a cell centre +-0.45, ball
    radius 0.1), moving, with a warm-start qacc and controls."""
    env, m, _, _ = models
    rs = np.random.RandomState(0)
    cells = np.array(env.maze.reset_locations)
    qpos = cells[rs.randint(len(cells), size=B)] + rs.uniform(-0.45, 0.45, (B, 2))
    d0 = jpipe.make_data(m, dtype=jnp.float64)
    db = jax.vmap(lambda q, v, a, c: dataclasses.replace(
        d0, qpos=q, qvel=v, qacc=a, ctrl=c))(
        jnp.asarray(qpos), jnp.asarray(rs.normal(0, 2, (B, 2))),
        jnp.asarray(rs.normal(0, 5, (B, 2))),
        jnp.asarray(rs.uniform(-1.2, 1.2, (B, 2))))
    return soa._data_to_soa(db, jax.tree_util.tree_map(lambda _: True, db), B)


STAGES = {
    "kinematics": (soa.kinematics, tsm.kinematics,
                   ["xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                    "xaxis", "geom_xpos", "geom_xmat", "site_xpos",
                    "site_xmat"]),
    "com_pos": (soa.com_pos, tsm.com_pos, ["subtree_com", "cinert", "cdof"]),
    "crb": (soa.crb, tsm.crb, ["qM"]),
    "collision": (soa.collision, tcol.collision, ["contact"]),
    "com_vel": (soa.com_vel, tsm.com_vel, ["cvel", "cdof_dot"]),
    "rne": (soa.rne, tsm.rne, ["qfrc_bias"]),
    "fwd_passive": (soa.fwd_passive, tsm.fwd_passive, ["qfrc_passive"]),
    "fwd_actuation": (soa.fwd_actuation, tsm.fwd_actuation,
                      ["actuator_length", "actuator_velocity",
                       "actuator_force", "qfrc_actuator"]),
    "solve_constraints": (soa.solve_constraints, tcst.solve_constraints,
                          ["qacc", "qfrc_constraint", "con_force",
                           "cfrc_ext"]),
    "forward": (soa.forward, tpipe.forward,
                ["xpos", "qM", "contact", "qfrc_bias", "qfrc_smooth",
                 "qacc_smooth", "qacc", "qfrc_constraint"]),
    "step": (soa.step, tpipe.step,
             ["qpos", "qvel", "time", "qacc", "qacc_smooth", "contact"]),
}
ORDER = list(STAGES)[:-3]  # the stages forward() runs before its solves


def _input_state(ms, ds, name):
    """The JAX state a stage starts from: the stages before it applied."""
    if name in ("solve_constraints",):
        ds = jax.jit(soa.forward)(ms, ds)
        return dataclasses.replace(ds, qacc=ds.qacc_smooth * 0.5)
    if name in ("forward", "step"):
        return ds
    for prev in ORDER[:ORDER.index(name)]:
        ds = jax.jit(STAGES[prev][0])(ms, ds)
    return ds


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_matches_soa(models, state, name):
    _, _, ms, tm = models
    jfn, tfn, fields = STAGES[name]
    ds_in = _input_state(ms, state, name)
    jout = jax.jit(jfn)(ms, ds_in)
    tout = tfn(tm, to_port(ds_in))
    for fld in fields:
        if fld == "contact":
            for k in ("dist", "pos", "frame"):
                a = np.asarray(getattr(jout.contact, k))
                b = getattr(tout.contact, k).numpy()
                np.testing.assert_allclose(b, a, rtol=0, atol=TOL * max(
                    1.0, np.nanmax(np.abs(a))), equal_nan=True, err_msg=k)
            continue
        a = np.asarray(getattr(jout, fld))
        b = getattr(tout, fld).numpy()
        assert b.shape == a.shape, (fld, b.shape, a.shape)
        assert rel_err(b, a) <= TOL, (fld, rel_err(b, a))


def test_build_rows_matches_soa(models, state):
    _, _, ms, tm = models
    ds = _input_state(ms, state, "solve_constraints")
    J, aref, D, R, active, is_eq, _ = soa.build_rows(ms, ds)
    tJ, taref, tD, tR, tactive, tis_eq, _ = tcst.build_rows(tm, to_port(ds))
    assert bool(np.asarray(active)[1:].any())  # some balls are in contact
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(active))
    np.testing.assert_array_equal(tis_eq.numpy(), np.asarray(is_eq))
    for name, a, b in (("J", J, tJ), ("aref", aref, taref), ("D", D, tD),
                       ("R", R, tR)):
        assert rel_err(b.numpy(), a) <= TOL, name


def test_unported_pair_type_raises(models):
    _, _, _, tm = models
    def with_ball(t):
        gt = list(tm.meta.geom_type)
        gt[tm.meta.geom_names.index("particle_geom")] = t
        return dataclasses.replace(tm, meta=dataclasses.replace(
            tm.meta, geom_type=tuple(gt)))

    # the ball becomes an ellipsoid: plane-ellipsoid and ellipsoid-box
    # pairs are not ported
    m2 = with_ball(TT.ELLIPSOID)
    d = tpipe.make_data(m2, 2)
    with pytest.raises(NotImplementedError, match="plane-ellipsoid"):
        tcol.collision(m2, tsm.kinematics(m2, d))
    # a cylinder's plane-cylinder and cylinder-box pairs are (FetchSlide)
    m3 = with_ball(TT.CYLINDER)
    c = tcol.collision(m3, tsm.kinematics(m3, tpipe.make_data(m3, 2))).contact
    assert bool(torch.isfinite(c.dist).all())
