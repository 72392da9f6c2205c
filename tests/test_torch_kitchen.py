"""The FrankaKitchen-v1 slice against the JAX package: the joint-equality
and condim-6 constraint rows, capsule-hull on the pruned table, the
kitchen's pruned compact table (its 32 groups, 760 slots), one substep, the
solves at nv = 29, the env with its observation noise injected, and the
single env.

The JAX side runs its batch-last path (soa="force") op by op around one
compiled function, its substep (tests/_jax_ref.py), in float64. States:
"rest", the JAX reset's state with the arm's joints moving, and "pressed",
the same with both arms turned into the scene (a turn of the seven arm
joints, picked for its contacts, at 0.88 and 0.86 of its size): in env 0
a capsule-hull row of condim 6 penetrates 0.8 mm, beside hull-hull,
box-hull and cylinder rows 56 rows are active; and "lifted", "rest" with
the kettle raised 5 cm off the stove.

- build_rows field by field (J, aref, D, R, active, is_eq) against
  soa.build_rows on the same smoothed state of the pressed arms: the 5
  joint-equality rows first, the condim-6 groups' 10 pyramid edges a
  contact; 1e-9. The force decode of condim-6 rows against
  soa._decode_contact_forces: 1e-9.
- the capsule-hull formula against collision_vec._make_capsule_hull on
  random poses, float64 (1e-12).
- one substep (soa.step) from the pressed state: the pruned compact table
  (slot map equal, distances on their own scale: rows far from touching
  carry 1e10), the solve and the Euler update, 1e-9.
- one env step (40 substeps) through step_with_values, the noise drawn
  on the host, from "rest" and "pressed": 1e-9 for the port in float64;
  2e-4 for the port in float32 from "lifted" against the float64
  reference. At rest the kettle sits on the stove on stiff contact rows
  whose float32 solve moves with rounding (the port's float32 step lands
  0.13 rad/s from its float64 step in the kettle's angular velocity,
  everything else within 1e-4), as the squeezed Fetch fingers' and the
  pressed hands' do, so float32 is held where the kettle falls free.
- reset_with_values against the JAX reset's state with its noise (the
  JAX reset refreshes the kinematics on its per-env path, 2.1e-8 from its
  batch-last one here: 5e-8, see tests/test_torch_hand_reach.py; 1e-12
  against the batch-last kinematics); the parity draws equal to the JAX
  package's.
- solve_newton_plain and solve_pos_plain at nv = 29 and the kitchen's 188
  rows against the TPU kernels' bodies, float64 (1e-12).
- make_gym(parity=True): a seeded reset and a step against the JAX
  make_gym(parity=True), float64; the observation noise of the reset and
  of the step drawn from the adapter's np_random in the reference's
  order.
- the auto-reset at the step limit picks the nested goal dicts, the
  (B, 7) task masks and aux per env.

Relative error scaled by max(1, |ref|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

import _jax_ref as R
from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.kitchen.kitchen import KitchenEnv as JKitchen
from gymnasium_robotics_tpu.physics import soa
from gymnasium_robotics_tpu.physics import types as jT
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.kitchen.kitchen import KitchenEnv
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint, pipeline, solver
from gymnasium_robotics_tpu_torch.physics import smooth as tsm
from gymnasium_robotics_tpu_torch.physics import types as T
from gymnasium_robotics_tpu_torch.utils import parity as tparity

B = 2
TOLS = {"float32": 2e-4, "float64": 1e-9}
# positions of a reset against the JAX reset's, whose kinematics take the
# package's per-env path: 2.1e-8 from its batch-last kinematics here
RESET_TOL = 5e-8
BIG = 1e9
ID = "FrankaKitchen-v1"
# the pressed arms: a turn of the seven arm joints (row 60 of the draw)
# at 0.88 and 0.86 of its size; the first puts a capsule-hull row of
# condim 6 into contact
PRESS = np.random.RandomState(0).uniform(-1.2, 1.2, (64, 7))[60] * np.array(
    [[0.88], [0.86]])
KETTLE_Z = 25   # the kettle's free joint: qpos 23-29, its height at 25


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def noise(seed, n=B):
    """Host-drawn observation noise (the parity sampler's keys), (n, size)."""
    rs = np.random.RandomState(seed)
    return {k: rs.uniform(-1.0, 1.0, (n, s))
            for k, s in (("robot_pos", 9), ("robot_vel", 9), ("obj_pos", 21),
                         ("obj_vel", 20))}


@pytest.fixture(scope="module")
def jax_env():
    jenv = JKitchen(dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 280
    return jenv, R.SubstepRef(jenv.model, B)


@pytest.fixture(scope="module")
def jax_run(jax_env):
    """({state name: (the state, the state after step_with_values)} as
    numpy, the action, the noise, the JAX reset's state as numpy)."""
    jenv, ref = jax_env
    jb = JBatched(jenv, B)
    rs = np.random.RandomState(4)
    action = rs.uniform(-1, 1, (B, 9))
    values = noise(5)
    step = jax.vmap(jenv.step_with_values)
    with R.patched(ref):
        jb.reset(seed=0)
        s_reset = jb.state
        d = s_reset.data
        qvel = np.asarray(d.qvel).copy()
        qvel[:, :7] = rs.normal(0, 0.3, (B, 7))
        rest = dataclasses.replace(s_reset, data=dataclasses.replace(
            d, qvel=jnp.asarray(qvel)))
        qpos = np.asarray(d.qpos).copy()
        qpos[:, :7] += PRESS
        pressed = dataclasses.replace(rest, data=dataclasses.replace(
            rest.data, qpos=jnp.asarray(qpos)))
        qpos = np.asarray(d.qpos).copy()
        qpos[:, KETTLE_Z] += 0.05
        lifted = dataclasses.replace(rest, data=dataclasses.replace(
            rest.data, qpos=jnp.asarray(qpos)))
        jv = {k: jnp.asarray(v) for k, v in values.items()}
        runs = {name: (R.state_to_numpy(st),
                       R.state_to_numpy(step(st, jnp.asarray(action), jv)))
                for name, st in (("rest", rest), ("pressed", pressed),
                                 ("lifted", lifted))}
    return runs, action, values, R.state_to_numpy(s_reset)


def cast(x, dtype):
    if isinstance(x, dict):
        return {k: cast(v, dtype) for k, v in x.items()}
    return x.to(dtype) if x.is_floating_point() else x


def cast_state(state, dtype):
    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name), dtype) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist, dtype), pos=cast(c.pos, dtype),
            frame=cast(c.frame, dtype)))
    return dataclasses.replace(
        state, data=data, obs=cast(state.obs, dtype),
        reward=cast(state.reward, dtype), goal=cast(state.goal, dtype),
        info=cast(state.info, dtype), aux=cast(state.aux, dtype))


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, x


@pytest.fixture(scope="module")
def smoothed(jax_run):
    """The port's pressed state through the smooth stages and the pruned
    table (float64), and the package's batch-last Data of it."""
    s0 = jax_run[0]["pressed"][0]
    tm = registry.make(ID, device="cpu", dtype=torch.float64).model
    d = convert.data_from_numpy(s0["data"], "cpu")
    for stage in (tsm.kinematics, tsm.com_pos, tsm.tendon, tsm.crb,
                  tcol.collision, tsm.com_vel, tsm.rne, tsm.fwd_passive,
                  tsm.fwd_actuation):
        d = stage(tm, d)
    qfrc = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + d.qfrc_applied
    d = dataclasses.replace(d, qfrc_smooth=qfrc,
                            qacc_smooth=solver.solve_pos(d.qM, qfrc))
    return tm, d, R.data_from_port(d, jT)


def test_rows_match_soa(jax_env, smoothed):
    """build_rows against soa.build_rows, field by field: the 5 joint
    equalities (q1 - poly(q2), -dpoly at joint 2's dof) first, then 23
    joint limits and the capped contact groups of condim 3, 4 and 6."""
    jenv, ref = jax_env
    tm, td, jd = smoothed
    J, aref, D, Rr, active, is_eq, layout = constraint.build_rows(tm, td)
    with jax.disable_jit():
        jJ, jaref, jD, jR, jactive, jis_eq, (n_loop, jlayout) = soa.build_rows(
            ref.ms, jd)
    assert J.shape == (188, 29, B) and n_loop == 28
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(is_eq.numpy(), jis_eq)
    assert is_eq[:5].all() and not is_eq[5:].any()
    for name, a, b in (("J", jJ, J), ("aref", jaref, aref), ("D", jD, D),
                       ("R", jR, Rr)):
        assert rel_err(b.numpy(), a) <= TOLS["float64"], name
    # the joint equalities: a 1 at joint 1's dof, -dpoly at joint 2's
    mt = tm.meta
    for r, e in enumerate(range(5)):
        d1 = mt.jnt_dofadr[mt.eq_obj1id[e]]
        d2 = mt.jnt_dofadr[mt.eq_obj2id[e]]
        assert (J[r, d1] == 1.0).all() and (J[r, d2] != 0).all()
        assert (J[r].abs().sum(0) == 1.0 + J[r, d2].abs()).all()
    assert [(cd, base) for cd, _, _, base in layout] == [(3, 28), (4, 60), (6, 108)]
    assert [(cd, np.asarray(sel_c).shape) for cd, sel_c, _, _ in jlayout] == \
        [(cd, tuple(sel_c.shape)) for cd, sel_c, _, _ in layout]
    assert active[108:].any()              # condim-6 rows in contact


def test_condim6_force_decode_matches_soa(jax_env, smoothed):
    """Contact forces decoded from pyramid forces (normal and the five
    frictional components of condim 6) against soa._decode_contact_forces,
    with the cfrc_ext aggregation on."""
    jenv, ref = jax_env
    tm, td, jd = smoothed
    tm = dataclasses.replace(tm, meta=dataclasses.replace(
        tm.meta, opt=dataclasses.replace(tm.meta.opt, need_cfrc_ext=True)))
    ms = dataclasses.replace(ref.ms, meta=dataclasses.replace(
        ref.ms.meta, opt=dataclasses.replace(ref.ms.meta.opt, need_cfrc_ext=True)))
    J, aref, D, Rr, active, is_eq, layout = constraint.build_rows(tm, td)
    f = torch.tensor(np.random.RandomState(6).uniform(0, 2, (188, B)))
    cf, ce = constraint._decode_contact_forces(tm, td, f, layout)
    with jax.disable_jit():
        jlayout = soa.build_rows(ms, jd)[-1]
        jcf, jce = soa._decode_contact_forces(ms, jd, jnp.asarray(f.numpy()), jlayout)
    assert rel_err(cf.numpy(), jcf) <= TOLS["float64"]
    assert rel_err(ce.numpy(), jce) <= TOLS["float64"]
    six = layout[2][1]                               # condim-6 slots (8, B)
    lane = torch.arange(B)
    assert (cf[six, 4:, lane].abs() > 0).all()      # the rolling components


def test_capsule_hull_matches_jax():
    """collision._make_capsule_hull (which also serves cylinders) on a
    capsule against a kitchen hull, random poses, against
    collision_vec._make_capsule_hull, float64."""
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    env = KitchenEnv(dtype=torch.float64, device="cpu")
    m = env.model
    rs = np.random.RandomState(7)
    n = 64
    hid = torch.as_tensor(rs.randint(0, m.hull_vert.shape[0], (n,)))
    (fn, fd), _ = tcol.take_hull(m.hull_vert, m.hull_face, hid[:, None])
    p1, p2 = rs.normal(0, 0.08, (3, n, 1)), rs.normal(0, 0.02, (3, n, 1))
    q1, q2 = rs.normal(size=(n, 4)), rs.normal(size=(n, 4))
    R1 = np.stack([_rot(q) for q in q1], axis=-1)[..., None]
    R2 = np.stack([_rot(q) for q in q2], axis=-1)[..., None]
    s1 = np.stack([rs.uniform(0.01, 0.05, n), rs.uniform(0.02, 0.1, n),
                   np.zeros(n)])[..., None]
    ops = [p1, R1, s1, p2, R2, np.zeros_like(s1)]
    got = tcol._make_capsule_hull((fn, fd))(*(torch.tensor(o) for o in ops))
    ref = CV._make_capsule_hull((jnp.asarray(fn.numpy()), jnp.asarray(fd.numpy())),
                                cylinder=False)(*(jnp.asarray(o) for o in ops))
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) <= 1e-12
    assert (got[0] < 0).any() and (got[0] > 0).any()


def _rot(q):
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def test_substep_matches_jax(jax_env, jax_run):
    """One substep (soa.step) from the pressed arms, float64: the pruned
    compact table every group of it, the constraint solve, Euler."""
    jenv, ref = jax_env
    s0 = jax_run[0]["pressed"][0]
    tm = registry.make(ID, device="cpu", dtype=torch.float64).model
    td = convert.data_from_numpy(s0["data"], "cpu")
    td = dataclasses.replace(td, ctrl=td.qpos[:9] + 0.05)
    jd = ref(R.data_from_port(td, jT))
    got = pipeline.step(tm, td)
    for fld in ("xpos", "geom_xpos", "qacc_smooth", "qacc", "qfrc_constraint",
                "qpos", "qvel"):
        assert rel_err(getattr(got, fld).numpy(), np.asarray(getattr(jd, fld))) \
            <= TOLS["float64"], fld
    tc, jc = got.contact, jd.contact
    for k in ("src", "geom1", "geom2"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
                                      err_msg=k)
    a, b = np.asarray(jc.dist), tc.dist.numpy()
    near = a < BIG
    np.testing.assert_array_equal(b < BIG, near)
    assert rel_err(b[near], a[near]) <= TOLS["float64"]
    for k in ("pos", "frame"):
        a = np.asarray(getattr(jc, k))
        np.testing.assert_allclose(getattr(tc, k).numpy(), a, rtol=0,
                                   atol=TOLS["float64"] * max(1.0, np.nanmax(np.abs(a))),
                                   equal_nan=True, err_msg=k)
    # a capsule-hull row (kind 14) penetrates in env 0
    plan = tcol.prune_plan(tm.meta)
    caps = [g for g in plan.groups if g.tp == (T.CAPSULE, T.MESH)]
    assert len(caps) == 3 and sum(len(g.idx) for g in caps) == 262
    pen = sum((np.asarray(jc.dist)[g.base_c:g.base_c + g.n_slots_c] < 0).sum(0)
              for g in caps)
    assert pen[0] > 0


@pytest.mark.parametrize("dtype,state", [("float64", "rest"),
                                         ("float64", "pressed"),
                                         ("float32", "lifted")])
def test_env_step_with_values_matches_jax(jax_run, dtype, state):
    tol = TOLS[dtype]
    runs, action, values, _ = jax_run
    s0, js = runs[state]
    tdt = getattr(torch, dtype)
    env = registry.make(ID, device="cpu", dtype=tdt)
    ts = cast_state(convert.env_state_from_numpy(s0, "cpu"), tdt)
    out = env.step_with_values(ts, torch.as_tensor(action, dtype=tdt), values)
    for name, got in _leaves(out.obs):
        ref = js["obs"]
        for k in name.strip("/").split("/"):
            ref = ref[k]
        assert got.shape == ref.shape and rel_err(got.numpy(), ref) <= tol, name
    assert out.obs["observation"].shape == (B, 59)
    assert rel_err(out.reward.numpy(), js["reward"]) <= tol
    for k in ("tasks_to_complete", "step_task_completions",
              "episode_task_completions"):
        np.testing.assert_array_equal(out.info[k].numpy(), js["info"][k], err_msg=k)
        assert out.info[k].shape == (B, 7)
    np.testing.assert_array_equal(out.terminated.numpy(), js["terminated"])
    assert rel_err(out.aux["last_robot_qpos"].numpy(),
                   js["aux"]["last_robot_qpos"]) <= tol
    for fld in ("qpos", "qvel", "qacc", "xpos", "time"):
        got = np.moveaxis(getattr(out.data, fld).numpy(), -1, 0)
        assert rel_err(got, js["data"][fld]) <= tol, fld
    if dtype == "float64":
        np.testing.assert_array_equal(out.data.contact.src.numpy().T,
                                      js["data"]["contact"]["src"])


def test_reset_with_values_matches_jax(jax_env, jax_run):
    """The initial pose, kinematics refreshed, the noisy observation and
    the task masks, from the JAX reset's state's noise-free pose."""
    ref = jax_run[3]
    env = KitchenEnv(dtype=torch.float64, device="cpu")
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    values = noise(8)
    ts = env.reset_with_values(template, values)
    q, v = ref["data"]["qpos"], ref["data"]["qvel"]
    amp = {k: a.numpy() for k, a in env._amp.items()}
    obs = np.concatenate([q[:, :9] + amp["robot_pos"] * values["robot_pos"],
                          v[:, :9] + amp["robot_vel"] * values["robot_vel"],
                          q[:, 9:] + amp["obj_pos"] * values["obj_pos"],
                          v[:, 9:] + amp["obj_vel"] * values["obj_vel"]], axis=1)
    assert rel_err(ts.obs["observation"].numpy(), obs) <= 1e-12
    for k in ref["obs"]["achieved_goal"]:
        np.testing.assert_array_equal(ts.obs["achieved_goal"][k].numpy(),
                                      ref["obs"]["achieved_goal"][k])
        np.testing.assert_array_equal(ts.obs["desired_goal"][k].numpy(),
                                      ref["obs"]["desired_goal"][k])
    for fld in ("qpos", "qvel", "xpos", "geom_xpos"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= RESET_TOL, fld
    from gymnasium_robotics_tpu.physics import pipeline as jpipe

    jenv = jax_env[0]
    d = jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * B),
        dataclasses.replace(jpipe.make_data(jenv.model, dtype=jnp.float64),
                            qpos=jenv._init_qpos, qvel=jenv._init_qvel))
    kin = jax.vmap(lambda d: jpipe.refresh_kin(jenv.model, d, com=False))(d)
    for fld in ("xpos", "geom_xpos"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, np.asarray(getattr(kin, fld))) <= 1e-12, fld
    for k in ("tasks_to_complete", "step_task_completions",
              "episode_task_completions"):
        np.testing.assert_array_equal(ts.info[k].numpy(), ref["info"][k], err_msg=k)
    np.testing.assert_array_equal(ts.aux["last_robot_qpos"].numpy(), obs[:, :9])


def test_parity_draws_match_jax():
    """utils/parity's kitchen draws (reset and step: robot position and
    velocity noise, then the objects') equal the JAX package's."""
    from gymnasium_robotics_tpu.utils import parity as jparity

    jenv = JKitchen()
    tenv = KitchenEnv(device="cpu")
    for seed in range(3):
        for fn in ("sample_reset_values", "sample_step_values"):
            ref = getattr(jparity, fn)(jenv, np.random.default_rng(seed))
            got = getattr(tparity, fn)(tenv, np.random.default_rng(seed))
            assert set(got) == set(ref) == {"robot_pos", "robot_vel", "obj_pos",
                                            "obj_vel"}
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert tparity.sample_step_values(
        registry.make("FetchPush-v4", device="cpu"), np.random.default_rng(0)) is None


def test_solves_match_kernel_bodies():
    """solve_newton_plain and solve_pos_plain at nv = 29 and the kitchen's
    188 rows, 8 Newton iterations, against the TPU kernels' bodies,
    float64."""
    m = registry.make(ID, device="cpu").model
    nv = m.nv
    ne = m.plan("rows", constraint._RowPlan).is_eq.numel()
    assert (nv, ne) == (29, 188) and m.opt.iterations == 8
    assert nv in solver.KERNEL_NV and ne <= solver.NEWTON_MAX_ROWS[nv]
    assert ne * nv <= 36000     # inside the fused Newton's gate
    n_iter, n_ls = m.opt.iterations, m.opt.ls_iterations
    args, qacc, f, x = R.kernel_body_solves(nv, ne, n_iter, n_ls, seed=nv)
    q_got, f_got = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(q_got.numpy(), qacc) <= 1e-12
    assert rel_err(f_got.numpy(), f) <= 1e-12
    assert rel_err(solver.solve_pos_plain(args[0], args[1]).numpy(), x) <= 1e-12


def test_registry_and_spaces_match_jax():
    import gymnasium_robotics_tpu.envs  # noqa: F401  (registers the IDs)

    s, js = registry.spec(ID), jreg.spec(ID)
    assert s.kwargs == js.kwargs == {} and s.max_episode_steps == js.max_episode_steps == 280
    je = jreg.make_gym(ID)
    te = registry.make_gym(ID, device="cpu")
    assert te.metadata["render_fps"] == je.metadata["render_fps"] == 12
    if te.observation_space is not None:
        assert te.observation_space == je.observation_space
        assert te.action_space == je.action_space
    m = te.env.model
    assert (m.opt.pair_topk, m.opt.contact_cap, m.opt.iterations,
            m.opt.ls_iterations) == (8, 8, 8, 4)
    assert te.env.model.meta.nbody == 44   # past the FK kernel's 36 bodies
    assert not m.opt.fk_kernel


def test_make_gym_parity_matches_jax(jax_env):
    """make_gym(parity=True): a reset from seed 2 and a step against the
    JAX make_gym(parity=True), float64; both draw the reset's and the
    step's observation noise from np_random in the reference's order."""
    _, ref = jax_env
    je = jreg.make_gym(ID, parity=True, dtype=jnp.float64)
    te = registry.make_gym(ID, parity=True, dtype=torch.float64, device="cpu")
    rs = np.random.RandomState(9)

    def check(t, j, tol):
        for name, got in _leaves(t):
            r = j
            for k in name.strip("/").split("/"):
                r = r[k]
            assert got.dtype == np.float64 and rel_err(got, r) <= tol, name

    with R.patched(ref):
        jo, ji = je.reset(seed=2)
        to, ti = te.reset(seed=2)
        check(to, jo, RESET_TOL)
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
        for _ in range(1):
            a = rs.uniform(-1, 1, 9)
            jo, jr, jterm, jtrunc, ji = je.step(a)
            to, tr, tterm, ttrunc, ti = te.step(a)
            check(to, jo, TOLS["float64"])
            assert tr == jr and (tterm, ttrunc) == (jterm, jtrunc)
            for k in ji:
                np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)


def test_auto_reset_picks_nested_leaves_per_env():
    """core.auto_reset on the kitchen: env 0 at the step limit comes back
    reset (steps 0, every task to do, its fresh noisy robot position in
    aux), env 1 keeps its stepped state, its task masks included; the
    goal dicts are picked per env too."""
    env = KitchenEnv(max_episode_steps=280, device="cpu")
    g = torch.Generator().manual_seed(0)
    s = env.initial(B, g)
    todo = s.aux["tasks_to_complete"].clone()
    todo[1, 2] = False
    s = dataclasses.replace(
        s, steps=torch.tensor([279, 3], dtype=torch.int32),
        aux={**s.aux, "tasks_to_complete": todo})
    out = core.auto_reset(env, s, torch.zeros(B, 9), g)
    assert out.truncated.tolist() == [True, False]
    assert out.steps.tolist() == [0, 4]
    assert out.aux["tasks_to_complete"][0].all()
    assert out.aux["tasks_to_complete"][1].tolist() == todo[1].tolist()
    assert out.info["tasks_to_complete"].shape == (B, 7)
    q = out.data.qpos
    torch.testing.assert_close(q[:, 0], env._init_qpos, rtol=0, atol=0)
    assert not torch.equal(q[:, 1], env._init_qpos)
    dq = out.aux["last_robot_qpos"][0] - env._init_qpos[:9]
    assert float(dq.abs().max()) <= float(env._amp["robot_pos"].max()) + 1e-7
    for k, v in out.obs["achieved_goal"].items():
        assert v.shape == (B, len(env._goal[k]))
