"""CoupledHalfCheetah through the port's multi-agent layer against the JAX
package's: MultiAgentMujocoEnv("CoupledHalfCheetah", "1p1") under each
side's BatchedEnv on the CPU, one env step (tests/_mamujoco_cases.py).

The JAX side runs in float64: its reset and env step compiled around its
batch-last substep, compiled once (tests/_mamujoco_cases.py). Held at 1e-9 with
the port in float64 and at 2e-4 with the port in float32 against the same
float64 reference, from "moving" (the JAX reset after two steps of random
actions): the tendon's spring acts (its length off the dead band at the
rest length 2) and its limit rows are in the system, inactive; each
agent's observation carries the tendon's Jacobian columns, length and
velocity. The limit rows acting are held stage by stage, with no JAX
compile (the JAX functions op by op): from one Data with the tendon past
its upper limit, the passive forces (its spring) and the constraint rows
against soa.fwd_passive and soa.build_rows, 1e-9, and the solve on those
rows against the TPU kernels' bodies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _jax_ref as R
import _mamujoco_cases as C
from gymnasium_robotics_tpu.envs.mamujoco import coupled_half_cheetah as JCH
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu.physics import types as JT
from gymnasium_robotics_tpu_torch.envs.mamujoco import mujoco_multi as MA
from gymnasium_robotics_tpu_torch.physics import pipeline

B = C.B

LIMIT = 1000


@pytest.fixture(scope="module")
def run():
    s0, step, dims = C.jax_env("CoupledHalfCheetah", "1p1", LIMIT)
    s, acts = C.jax_states(s0, step, dims)
    return C.jax_step(step, s, acts), acts


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_matches_jax(run, dtype):
    done, tb = C.check_step("CoupledHalfCheetah", "1p1", LIMIT, run[0], run[1],
                            dtype)
    assert not done.any()
    lengths = tb.state.data.ten_length[0].double().numpy()
    assert (lengths > 1.5).all() and (lengths < 3.5).all()
    assert (abs(lengths - 2.0) > 1e-4).all()


def _past_the_limit():
    """The coupled model in float64 and one forwarded Data of B envs, env
    1's second cheetah 3 m ahead and moving away at 3 m/s: its tendon past
    the 3.5 upper limit and lengthening."""
    m = MA.MultiAgentMujocoEnv("CoupledHalfCheetah", "1p1", device="cpu",
                               dtype=torch.float64).env.model
    rs = np.random.RandomState(1)
    q = m.qpos0[:, 0].numpy()[:, None] + rs.uniform(-0.1, 0.1, (m.meta.nq, B))
    q[9, 1] += 3.0
    d = pipeline.make_data(m, B)
    d.qpos[:] = torch.tensor(q)
    d.qvel[:] = torch.tensor(rs.normal(size=(m.meta.nv, B)))
    d.qvel[9, 1] = 3.0
    return m, pipeline.forward(m, d)


def test_tendon_spring_and_limit_rows_match_jax():
    """The spatial tendon through the stages that read it, float64: from
    one forwarded Data (_past_the_limit) the passive forces (the spring,
    stiffness 0.1, its dead band at the rest length) and the constraint
    rows (J, aref, D, active: the limit's two rows among them) against
    soa.fwd_passive and soa.build_rows within 1e-9 relative; the upper
    limit row active in env 1 only. (The row's D is 1e10: the tendon's
    invweight0 is 0, no dof moving along it at qpos0; the solve on these
    rows is held in test_solve_past_the_limit_matches_kernel_body.)"""
    from gymnasium_robotics_tpu_torch.physics import constraint

    m, d = _past_the_limit()
    jenv = JCH.make_coupled_half_cheetah(dtype=jnp.float64)
    ms = soa._model_to_soa(jenv.model, None)
    jd = R.data_from_port(d, JT)
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    assert rel(d.qfrc_passive.numpy(),
               np.asarray(soa.fwd_passive(ms, jd).qfrc_passive)) <= 1e-9
    got = constraint.build_rows(m, d)[:5]
    ref = soa.build_rows(ms, jd)[:5]
    for name, g, r in zip(("J", "aref", "D", "R", "active"), got, ref):
        assert rel(g.double().numpy(), np.asarray(r).astype(np.float64)) <= 1e-9, name
    lim = sum(m.meta.jnt_limited)     # a row a limited joint, then the tendon's two
    act = got[4][lim:lim + 2].numpy()
    assert act.tolist() == [[False, False], [False, True]]
    assert float(d.ten_length[0, 1]) > 3.5


def test_solve_past_the_limit_matches_kernel_body():
    """The constraint solve on those rows (the tendon's upper limit row
    active in env 1, D = 1e10), float64, warm-started at qacc_smooth:
    solver.solve_newton_plain against the TPU kernels' bodies
    (solver_pallas._kernel_nv and _kernel_chol) run op by op on the same
    operands (tests/_jax_ref.py kernel_bodies_on), at the model's 20 Newton
    and 8 line-search iterations; finite, with the limit row binding (its
    force nonzero) in env 1 only. This is the fused route's witness there:
    the JAX package's dense CPU route diverges from such a state (ROADMAP
    C). The binding row makes the system's condition number about
    D / eig(M) ~ 1e10, so float64 answers move by ~1e10 x 1.1e-16 with the
    rounding: qacc and f are held within 1e-9 relative, or within twice
    the plain version's own spread over 8 copies of its inputs perturbed
    at 1e-15 relative (as chip_smoke.py's newton_spread in float32), the
    spread itself at most 1e-6; the Cholesky solve within 1e-9."""
    from gymnasium_robotics_tpu_torch.physics import constraint, solver

    m, d = _past_the_limit()
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    args = [d.qM, d.qacc_smooth, d.qacc_smooth, J, aref, D, active,
            torch.as_tensor(np.asarray(is_eq))]
    n_iter, n_ls = min(m.meta.opt.iterations, 20), min(m.meta.opt.ls_iterations, 8)
    assert (n_iter, n_ls) == (20, 8)
    qacc, f = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    q_ref, f_ref, x_ref = R.kernel_bodies_on(args, n_iter, n_ls)
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    g = torch.Generator().manual_seed(0)
    spread = 0.0
    for _ in range(8):
        y = list(args)
        for i in range(6):
            u = torch.rand(y[i].shape, generator=g, dtype=torch.float64) * 2 - 1
            if i == 0:
                u = (u + u.transpose(0, 1)) / 2
            y[i] = y[i] * (1 + 1e-15 * u)
        q2, f2 = solver.solve_newton_plain(*y, n_iter=n_iter, n_ls=n_ls)
        spread = max(spread, rel(q2.numpy(), qacc.numpy()), rel(f2.numpy(), f.numpy()))
    assert spread <= 1e-6
    gate = max(1e-9, 2 * spread)
    assert np.isfinite(q_ref).all() and np.isfinite(f_ref).all()
    assert rel(qacc.numpy(), q_ref) <= gate
    assert rel(f.numpy(), f_ref) <= gate
    assert rel(solver.solve_pos_plain(args[0], args[1]).numpy(), x_ref) <= 1e-9
    upper = sum(m.meta.jnt_limited) + 1
    assert (f_ref[upper] != 0).tolist() == [False, True]
