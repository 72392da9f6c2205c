"""Humanoid-v5 and HumanoidStandup-v5 against the JAX package (nv = 23,
244 rows, 128 contact pairs, 10 of them sphere-sphere, 2 fixed tendons,
RK4), through the registry's BatchedEnv on the CPU.

The JAX side runs its batch-last path in float64, its env steps of both
models compiled as one function (tests/_loco_cases.py). One env step from
each model's moving state (after three steps of random actions, the feet
on the floor) is held at 1e-9 with the port in float64 and at 2e-4 with
the port in float32 against the same float64 reference; the reset's
refresh from injected qpos and qvel at 1e-9; the sphere-sphere formula
against collision_vec._sphere_sphere (float64, 1e-12, coincident centres
included); the unpruned table of a pressed state (limbs pushed into each
other) against the JAX substep's; the plain solves at nv = 23 and 244 rows
against the TPU kernels' bodies (1e-12)."""

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _loco_cases as L
from gymnasium_robotics_tpu_torch import registry
from gymnasium_robotics_tpu_torch.physics import collision, constraint, solver
from gymnasium_robotics_tpu_torch.physics import types as T

IDS = ["Humanoid-v5", "HumanoidStandup-v5"]


@pytest.fixture(scope="module")
def jax_runs():
    return L.jax_runs(IDS)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("id_", IDS)
def test_env_step_matches_jax(jax_runs, id_, dtype):
    done = L.check_step(id_, jax_runs[0][(id_, "moving")], dtype)
    assert not done.any()


@pytest.mark.parametrize("id_", IDS)
def test_reset_with_values_matches_jax(jax_runs, id_):
    L.check_reset(id_, jax_runs[1][id_])


def test_sphere_sphere_matches_jax():
    """The sphere-sphere formula on random spheres, overlapping and apart,
    and on coincident centres (the +z normal), against the JAX one."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(3)
    k, B = 5, 16
    p1, p2 = rs.normal(0, 0.1, (3, k, B)), rs.normal(0, 0.1, (3, k, B))
    p2[:, 0, :4] = p1[:, 0, :4]
    s1, s2 = rs.uniform(0.02, 0.1, (3, k, 1)), rs.uniform(0.02, 0.1, (3, k, 1))
    R = np.broadcast_to(np.eye(3)[:, :, None, None], (3, 3, k, B))
    ref = CV._sphere_sphere(*(jnp.asarray(a) for a in (p1, R, s1, p2, R, s2)))
    got = collision._sphere_sphere(*(torch.tensor(np.ascontiguousarray(a))
                                     for a in (p1, R, s1, p2, R, s2)))
    assert (np.asarray(ref[0]) < 0).any() and (np.asarray(ref[0]) > 0).any()
    for g, r in zip(got, ref):
        assert L.rel_err(g.numpy(), np.asarray(r)) <= 1e-12
    np.testing.assert_array_equal(got[2][0, :, 0, :4].numpy(),
                                  np.array([[0.0] * 4, [0.0] * 4, [1.0] * 4]))


def test_pressed_table_matches_jax(jax_runs):
    """One substep from a state with the torso 0.3 m above the floor and
    every joint drawn past its range (limbs in the floor and in each
    other: plane-capsule, plane-sphere, sphere-capsule and capsule-capsule
    rows penetrate; the 10 sphere-sphere rows, hands, feet and head, stay
    apart) against the JAX substep, float64: the table's distances (rows
    far apart carry 1e10), positions and frames, qacc and the new
    qpos."""
    import _jax_ref as R
    from gymnasium_robotics_tpu.physics import types as jT

    from gymnasium_robotics_tpu_torch import convert
    from gymnasium_robotics_tpu_torch.physics import pipeline

    jenv = jax_runs[1]["Humanoid-v5"].env
    m = registry.make("Humanoid-v5", device="cpu", dtype=torch.float64).model
    s0 = jax_runs[0][("Humanoid-v5", "moving")][0]
    d = convert.data_from_numpy(s0["data"], "cpu")
    rs = np.random.RandomState(11)
    lo, hi = m.jnt_range[1:, 0, 0].numpy(), m.jnt_range[1:, 1, 0].numpy()
    d.qpos[7:] = torch.tensor((lo - 0.5)[:, None] + rs.uniform(
        size=(len(lo), L.B)) * (hi - lo + 1.0)[:, None])
    d.qpos[2] = 0.3
    ref = R.SubstepRef(jenv.model, L.B)(R.data_from_port(d, jT))
    got = pipeline.step(m, d)
    geoms = m.meta.geom_type
    ss = [i for i, (g1, g2) in enumerate(m.meta.pairs)
          if (geoms[g1], geoms[g2]) == (T.SPHERE, T.SPHERE)]
    assert len(ss) == 10
    a, b = np.asarray(ref.contact.dist), got.contact.dist.numpy()
    near = a < 1e9
    np.testing.assert_array_equal(b < 1e9, near)
    assert (a < 0).sum() >= 20
    slot = collision._pair_slot_base(m.meta)[ss]
    assert near[slot].all()
    assert L.rel_err(b[near], a[near]) <= 1e-9
    for k in ("pos", "frame"):
        r = np.asarray(getattr(ref.contact, k))
        np.testing.assert_allclose(getattr(got.contact, k).numpy(), r, rtol=0,
                                   atol=1e-9 * max(1.0, np.nanmax(np.abs(r))),
                                   equal_nan=True, err_msg=k)
    for fld in ("qacc", "qpos", "qvel"):
        assert L.rel_err(getattr(got, fld).numpy(),
                         np.asarray(getattr(ref, fld))) <= 1e-9, fld


def test_solves_match_kernel_bodies():
    """solve_newton_plain and solve_pos_plain at nv = 23 and the model's
    244 rows against the TPU kernels' bodies (random rows, B = 2), float64."""
    import _jax_ref as R

    m = registry.make("Humanoid-v5", device="cpu").model
    ne = m.plan("rows", constraint._RowPlan).is_eq.numel()
    assert (m.nv, ne) == (23, 244)
    assert m.nv in solver.KERNEL_NV and ne <= solver.NEWTON_MAX_ROWS[m.nv]
    args, qacc, f, x = R.kernel_body_solves(m.nv, ne, 4, 3, seed=23)
    q_got, f_got = solver.solve_newton_plain(*args, n_iter=4, n_ls=3)
    assert L.rel_err(q_got.numpy(), qacc) <= 1e-12
    assert L.rel_err(f_got.numpy(), f) <= 1e-12
    assert L.rel_err(solver.solve_pos_plain(args[0], args[1]).numpy(), x) <= 1e-12
