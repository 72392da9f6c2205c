"""The HandReach slice against the JAX package (HandReach{,Dense}-{v0,v3}):
the env (20 substeps at nv = 24, 44 fixed tendons, the unpruned table of
57 pairs), its goal draw, its parity reset, the solves at nv = 24 and the
single env.

The JAX side runs its batch-last path (soa="force") op by op around one
compiled function, its substep (tests/_jax_ref.py), in float64. States:
"moving", the JAX reset's state with the joints moving, and "pressed", the
same with env 1's joints bent past their ranges so that 17 joint limits,
8 tendon limits and 28 contact rows (capsule-box, box-box and
plane-capsule, fingers pressed into the palm and each other) are active.

- One env step of the port's BatchedEnv (dense rewards) against the JAX
  BatchedEnv's from both states, and one substep from "pressed": 1e-9 for
  the port in float64; 2e-4 for the port in float32 from "moving" against
  the same float64 reference. The pressed hand's float32 solve is
  ill-conditioned as the HandManipulateBlock hand's is (PERF.md,
  tests/test_torch_hand.py), so no float32 path is held at 2e-4 there.
- reset_with_values against the JAX reset's state with its goal (1e-8:
  the JAX reset refreshes the kinematics on its per-env path, 3.2e-9 from
  its batch-last one; 1e-12 against the batch-last kinematics); the
  parity draws equal to the JAX package's; the goal draw's properties.
- solve_newton_plain and solve_pos_plain at nv = 24 and the model's 272
  rows against the TPU kernels' bodies, float64 (1e-12).
- make_gym(parity=True): a seeded reset (the goal equal, the positions
  1e-8 as above) and three steps against the JAX make_gym(parity=True),
  float64 (1e-9).

Relative error scaled by max(1, |ref|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _jax_ref as R
from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.hand.hand import HandReachEnv as JReach
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.hand.hand import HandReachEnv
from gymnasium_robotics_tpu_torch.physics import constraint, pipeline, solver
from gymnasium_robotics_tpu_torch.utils import parity as tparity

B = 2
TOLS = {"float32": 2e-4, "float64": 1e-9}
# positions of a reset against the JAX reset's, whose kinematics take the
# package's per-env path (test_reset_with_values_matches_jax)
RESET_TOL = 1e-8
ID = "HandReachDense-v3"
# env 1's joints in the "pressed" state: fingers bent past their ranges,
# into the palm and each other
PRESSED = np.array([
    -0.134, -0.486, 0.613, 2.25, 1.438, 1.998, 0.65, 2.325, 0.828, 1.841,
    0.317, -0.163, -0.263, 0.878, 1.01, 0.989, -0.21, 2.31, 2.152, 1.531,
    1.257, 0.246, 0.983, -1.3])


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def jax_env():
    jenv = JReach(reward_type="dense", dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 50
    return jenv, R.SubstepRef(jenv.model, B)


@pytest.fixture(scope="module")
def jax_run(jax_env):
    """({state name: (the state, the stepped state)} as numpy, the action,
    the JAX reset's state as numpy, the JAX env)."""
    jenv, ref = jax_env
    jb = JBatched(jenv, B)
    rs = np.random.RandomState(3)
    action = rs.uniform(-1, 1, (B, 20))
    with R.patched(ref):
        jb.reset(seed=0)
        s_reset = jb.state
        d = s_reset.data
        moving = dataclasses.replace(s_reset, data=dataclasses.replace(
            d, qvel=jnp.asarray(rs.normal(0, 0.5, (B, 24)))))
        qpos = np.asarray(d.qpos).copy()
        qpos[1] = PRESSED
        pressed = dataclasses.replace(moving, data=dataclasses.replace(
            moving.data, qpos=jnp.asarray(qpos)))
        runs = {name: (R.state_to_numpy(st),
                       R.state_to_numpy(jb._step_fn(st, jnp.asarray(action))))
                for name, st in (("moving", moving), ("pressed", pressed))}
    return runs, action, R.state_to_numpy(s_reset), jenv


def cast_state(state, dtype):
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x.to(dtype) if x.is_floating_point() else x

    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))
    return dataclasses.replace(state, data=data, obs=cast(state.obs),
                               reward=cast(state.reward), goal=cast(state.goal),
                               info=cast(state.info))


@pytest.mark.parametrize("dtype,state", [("float64", "moving"),
                                         ("float64", "pressed"),
                                         ("float32", "moving")])
def test_env_step_matches_jax(jax_run, dtype, state):
    tol = TOLS[dtype]
    s0, js = jax_run[0][state]
    action = jax_run[1]
    tdt = getattr(torch, dtype)
    tb = registry.make(ID, num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    to, tr, tte, ttr, ti = tb.step(torch.as_tensor(action, dtype=tdt))
    assert to["observation"].shape == (B, 63)
    for k in js["obs"]:
        assert rel_err(to[k].numpy(), js["obs"][k]) <= tol, k
    assert rel_err(tr.numpy(), js["reward"]) <= tol
    assert rel_err(ti["is_success"].numpy(), js["info"]["is_success"]) <= tol
    for name, a_, b_ in (("terminated", js["terminated"], tte),
                         ("truncated", js["truncated"], ttr),
                         ("diverged", js["info"]["diverged"], ti["diverged"])):
        np.testing.assert_array_equal(b_.numpy(), a_, err_msg=name)
    td, jd = tb.state.data, js["data"]
    for fld in ("qpos", "qvel", "qacc", "site_xpos", "ten_length", "time"):
        got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
        assert rel_err(got, jd[fld]) <= tol, fld
    # the pressed hand starts with its fingers in contact
    # (test_substep_matches_jax) and is pushed apart within the step
    assert not (jd["contact"]["dist"] < 0).any()


def test_substep_matches_jax(jax_env, jax_run):
    """One substep (soa.step) from the pressed state, float64: the
    kinematics, the unpruned table (distances on their own scale: rows far
    from touching carry 1e10), the solve and the Euler update."""
    jenv, ref = jax_env
    s0 = jax_run[0]["pressed"][0]
    tm = registry.make(ID, device="cpu", dtype=torch.float64).model
    td = convert.data_from_numpy(s0["data"], "cpu")
    td = dataclasses.replace(td, ctrl=torch.zeros_like(td.ctrl) + 0.1)
    ds = R.data_from_port(td, _jax_types())
    jd = ref(ds)
    got = pipeline.step(tm, td)
    for fld in ("xpos", "site_xpos", "qacc_smooth", "qacc", "qfrc_constraint",
                "qpos", "qvel"):
        a = np.asarray(getattr(jd, fld))
        assert rel_err(getattr(got, fld).numpy(), a) <= TOLS["float64"], fld
    a, b = np.asarray(jd.contact.dist), got.contact.dist.numpy()
    near = a < 1e9
    np.testing.assert_array_equal(b < 1e9, near)
    assert rel_err(b[near], a[near]) <= TOLS["float64"]
    assert (a[:, 1] < 0).sum() >= 6
    for k in ("pos", "frame"):
        a = np.asarray(getattr(jd.contact, k))
        np.testing.assert_allclose(getattr(got.contact, k).numpy(), a, rtol=0,
                                   atol=TOLS["float64"] * max(1.0, np.nanmax(np.abs(a))),
                                   equal_nan=True, err_msg=k)


def _jax_types():
    from gymnasium_robotics_tpu.physics import types as jT

    return jT


def test_reset_with_values_matches_jax(jax_run):
    """The initial pose with kinematics refreshed and the given goal,
    against the JAX reset's state. The JAX reset refreshes the kinematics
    of an unbatched Data, which takes its per-env path (smooth.kinematics)
    even under vmap; that path lands 3.2e-9 from the package's own
    batch-last kinematics at this pose, so the positions are held at
    RESET_TOL here and at 1e-12 against the batch-last kinematics."""
    import jax

    from gymnasium_robotics_tpu.physics import pipeline as jpipe

    ref, jenv = jax_run[2], jax_run[3]
    tenv = HandReachEnv(reward_type="dense", dtype=torch.float64, device="cpu")
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = tenv.reset_with_values(template, {"goal": ref["goal"]})
    for k in ref["obs"]:
        np.testing.assert_allclose(ts.obs[k].numpy(), ref["obs"][k], rtol=0,
                                   atol=RESET_TOL)
    np.testing.assert_array_equal(ts.obs["desired_goal"].numpy(), ref["goal"])
    for fld in ("qpos", "qvel", "xpos", "site_xpos", "subtree_com"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= RESET_TOL, fld
    np.testing.assert_array_equal(ts.steps.numpy(), 0)
    d = jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * B),
        dataclasses.replace(jpipe.make_data(jenv.model, dtype=jnp.float64),
                            qpos=jenv._init_qpos, qvel=jenv._init_qvel))
    kin = jax.vmap(lambda d: jpipe.refresh_kin(jenv.model, d))(d)
    for fld in ("xpos", "site_xpos", "subtree_com"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, np.asarray(getattr(kin, fld))) <= 1e-12, fld


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_parity_draws_match_jax(jax_run, dtype):
    """utils/parity's HandReach draws (the finger, the meeting point's
    noise, the revert) equal the JAX package's from the same seed, the palm
    and initial pattern read in the env's dtype."""
    from gymnasium_robotics_tpu.utils import parity as jparity

    jenv = JReach(dtype=getattr(jnp, dtype))
    tenv = HandReachEnv(dtype=getattr(torch, dtype), device="cpu")
    reverted = 0
    for seed in range(40):
        ref = jparity.sample_reset_values(jenv, np.random.default_rng(seed))
        got = tparity.sample_reset_values(tenv, np.random.default_rng(seed))
        assert set(got) == set(ref) == {"goal"}
        np.testing.assert_array_equal(got["goal"], ref["goal"])
        reverted += np.array_equal(
            got["goal"], tenv._initial_goal.reshape(-1).double().numpy())
    assert 0 < reverted < 40


def test_goal_draw():
    """The batched draw (reach.py:99-126): the thumb and one of the four
    other fingers 0.005 short of a common meeting point near the palm (so
    within 0.01 of each other), every other tip at its initial place; about
    one goal in ten the initial pattern; each finger drawn."""
    env = HandReachEnv(dtype=torch.float64, device="cpu")
    n = 4000
    goal = env._sample_goal(n, torch.Generator().manual_seed(0)).reshape(n, 5, 3)
    init = env._initial_goal
    moved = (goal - init).abs().amax(-1) > 0                  # (n, 5)
    revert = ~moved.any(-1)
    assert 0.08 < float(revert.double().mean()) < 0.12
    kept = goal[~revert]
    mv = moved[~revert]
    assert mv[:, 4].all() and (mv[:, :4].sum(-1) == 1).all()
    finger = mv[:, :4].double().argmax(-1)
    assert set(finger.tolist()) == {0, 1, 2, 3}
    tip = kept[torch.arange(len(kept)), finger]
    gap = torch.linalg.vector_norm(tip - kept[:, 4], dim=-1)
    assert float(gap.max()) <= 0.01 + 1e-12
    meeting = env._meeting0
    for t in (tip, kept[:, 4]):
        d = torch.linalg.vector_norm(t - meeting, dim=-1)
        assert float(d.max()) < 0.005 * 6


def test_solves_match_kernel_bodies():
    """solve_newton_plain and solve_pos_plain at nv = 24 and HandReach's
    272 rows (24 joint limits, 88 tendon limits, 16 + 16 capped contacts
    of condim 3 and 4) against the TPU kernels' bodies, float64."""
    m = registry.make(ID, device="cpu").model
    nv = m.nv
    ne = m.plan("rows", constraint._RowPlan).is_eq.numel()
    assert (nv, ne) == (24, 272)
    assert nv in solver.KERNEL_NV and ne <= solver.NEWTON_MAX_ROWS[nv]
    n_iter, n_ls = m.opt.iterations, m.opt.ls_iterations
    args, qacc, f, x = R.kernel_body_solves(nv, ne, n_iter, n_ls, seed=nv)
    q_got, f_got = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(q_got.numpy(), qacc) <= 1e-12
    assert rel_err(f_got.numpy(), f) <= 1e-12
    assert rel_err(solver.solve_pos_plain(args[0], args[1]).numpy(), x) <= 1e-12


def test_registry_matches_jax():
    """The 4 IDs with the JAX registry's kwargs and step limit (50); the
    env's widths and options."""
    import gymnasium_robotics_tpu.envs  # noqa: F401  (registers the IDs)

    ids = [i for i in registry.ids() if i.startswith("HandReach")]
    jids = [i for i in jreg.ids() if i.startswith("HandReach")]
    assert sorted(ids) == sorted(jids) and len(ids) == 4
    for id_ in ids:
        s, js = registry.spec(id_), jreg.spec(id_)
        assert s.kwargs == js.kwargs and s.max_episode_steps == js.max_episode_steps == 50
    env = registry.make("HandReach-v0", device="cpu")
    assert (env.obs_dim, env.goal_dim, env.action_dim) == (63, 15, 20)
    assert env.max_episode_steps == 50 and env.reward_type == "sparse"
    assert (env.model.opt.contact_cap, env.model.opt.iterations) == (16, 5)


def test_make_gym_parity_matches_jax(jax_env):
    """make_gym(parity=True): a reset from seed 3 and three steps against
    the JAX make_gym(parity=True), float64 (the JAX single env's substep
    loop runs the compiled batch-last substep, lane 0)."""
    _, ref = jax_env
    je = jreg.make_gym(ID, parity=True, dtype=jnp.float64)
    te = registry.make_gym(ID, parity=True, dtype=torch.float64, device="cpu")
    assert te.metadata["render_fps"] == je.metadata["render_fps"] == 25
    rs = np.random.RandomState(5)
    with R.patched(ref):
        jo, _ = je.reset(seed=3)
        to, _ = te.reset(seed=3)
        for k in jo:   # the JAX single env's reset kinematics: per-env path
            assert rel_err(to[k], jo[k]) <= RESET_TOL, k
        np.testing.assert_array_equal(to["desired_goal"], jo["desired_goal"])
        for _ in range(3):
            a = rs.uniform(-1, 1, 20)
            jo, jr, jterm, jtrunc, _ = je.step(a)
            to, tr, tterm, ttrunc, _ = te.step(a)
            for k in jo:
                assert to[k].dtype == np.float64
                assert rel_err(to[k], jo[k]) <= TOLS["float64"], k
            assert abs(tr - jr) <= TOLS["float64"] and (tterm, ttrunc) == (jterm, jtrunc)
