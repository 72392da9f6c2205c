"""The FetchSlide-v4 slice against the JAX package: the three contact
formulas it adds, its pruned compact table, one env step and its resets.

- The plain formulas of physics.collision against collision_vec's:
  _plane_cylinder, _capsule_box on a cylinder (as _dispatch maps
  cylinder-box) and _make_capsule_hull (cylinder-hull), on random poses,
  in float64 (1e-12) and float32 (2e-4). The upright puck on the plane is
  pinned: its axis along the normal, the rim point falls back to the
  cylinder's x axis and the tangent is NaN.
- One env step of the port's BatchedEnv against the JAX BatchedEnv (its
  batched step compiled once, at XLA's lowest backend optimisation level,
  in float64) from two states: "pressed", the gripper link pressing the
  upright puck into the table in one env and the puck tipped onto the
  floor in the other, and "resting", the same with the first puck on the
  table clear of the gripper: 1e-9 for the port in float64 from both,
  2e-4 for the port in float32 against the same float64 reference from
  "resting". The pressed puck is squeezed between the mocap-welded
  gripper and the table, where float32 rounding alone moves the step's
  solve: JAX's own float32 step lands 1.09e-1 from its float64 step there
  (and the port's 1.5e-2), so no float32 path is held at 2e-4 there.
  The pruned compact table of the pressed step's last substep (the
  kernel's groups through the plain narrowphase, the MPR groups as plain
  PyTorch) against JAX's pruned core's, field by field with equal_nan:
  there every new group (plane-cylinder, cylinder-box, cylinder-hull)
  still has a penetrating row.
- reset_with_values against the JAX reset's draws, and the parity draws
  (target offset, object range) against the JAX package's sampler.

Relative error scaled by max(1, |ref|); contact distances on their own
scale (rows far from touching carry 1e10)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu.envs.batched import BatchedEnv as JBatched
from gymnasium_robotics_tpu.envs.fetch.fetch import FetchSlideEnv as JSlide
from gymnasium_robotics_tpu.physics import collision_vec as CV
from gymnasium_robotics_tpu_torch import convert, core, registry
from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchSlideEnv
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import types as T
from gymnasium_robotics_tpu_torch.utils import parity as tparity

B = 2
TOLS = {"float32": 2e-4, "float64": 1e-9}
TOL_F64 = 1e-12
BIG = 1e9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.nanmax(np.abs(x - ref)) / max(1.0, np.nanmax(np.abs(ref))))


# ---------------------------------------------------------------------------
# the formulas
# ---------------------------------------------------------------------------


def _rot(q):
    """Rotation matrices (3, 3, n) of quaternions q (n, 4), wxyz."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _poses(rs, n):
    """(p1, R1, p2, R2) (3, 1, n) and (3, 3, 1, n) of geom 1 near geom 2:
    random orientations, with lane 0 the upright puck on a level plane
    (both rotations the identity, exactly), lane 1 the puck upside down,
    lane 2 tipped by 1e-3 rad and lane 3 by 0.3 rad."""
    q1, q2 = rs.normal(size=(n, 4)), rs.normal(size=(n, 4))
    q1[:4] = [1.0, 0.0, 0.0, 0.0]
    q2[:4] = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
              [np.cos(5e-4), np.sin(5e-4), 0.0, 0.0],
              [np.cos(0.15), 0.0, np.sin(0.15), 0.0]]
    p1 = rs.normal(0, 0.03, (3, n))
    p2 = p1 + rs.normal(0, 0.03, (3, n))
    p2[:, :4] = p1[:, :4] + [[0.0], [0.0], [0.018]]
    return p1[:, None], _rot(q1)[:, :, None], p2[:, None], _rot(q2)[:, :, None]


def _sizes(*s):
    return np.array(s, np.float64)[:, None, None]


CYL = _sizes(0.025, 0.02, 0.0)   # the puck: radius, half height


def _hull_ops(n):
    """((fn, fd), hv) of FetchSlide's hull 11 (the gripper link's) as
    static (.., 1, 1) operands, and the same per lane (.., 1, n) from
    hulls cycling through all 15."""
    m = FetchSlideEnv(dtype=torch.float64, device="cpu").model
    hf = m.hull_face.numpy()
    stat = (hf[11][..., :3][:, :, None, None], hf[11][..., 3][:, None, None])
    hid = np.arange(n) % hf.shape[0]
    lane = (np.moveaxis(hf[hid][..., :3], 0, -1)[:, :, None],
            np.moveaxis(hf[hid][..., 3], 0, -1)[:, None])
    return stat, lane


def _formula_cases(rs, n):
    """(name, jax fn, port fn, operands) of the three formulas."""
    p1, R1, p2, R2 = _poses(rs, n)
    plane = _sizes(0.0, 0.0, 0.0)
    box = _sizes(0.03, 0.02, 0.01)
    (sf, sd), (lf, ld) = _hull_ops(n)
    # the hull posed near the cylinder: its frame at p1's offset
    ph = p2 + rs.normal(0, 0.02, (3, 1, n))
    return [
        ("plane-cylinder", CV._plane_cylinder, tcol._plane_cylinder,
         (p1, R1, plane, p2, R2, CYL)),
        ("cylinder-box", CV._dispatch(T.CYLINDER, T.BOX),
         tcol.PRIMITIVES[(T.CYLINDER, T.BOX)], (p2, R2, CYL, p1, R1, box)),
        ("cylinder-hull", lambda *a: CV._make_capsule_hull(
            (jnp.asarray(sf, a[0].dtype), jnp.asarray(sd, a[0].dtype)))(*a),
         lambda *a: tcol._make_capsule_hull(
             (torch.as_tensor(sf, dtype=a[0].dtype),
              torch.as_tensor(sd, dtype=a[0].dtype)))(*a),
         (p2, R2, CYL, ph, R1, plane)),
        ("cylinder-hull per lane",
         lambda *a: CV._make_capsule_hull(
             (jnp.asarray(lf, a[0].dtype), jnp.asarray(ld, a[0].dtype)))(*a),
         lambda *a: tcol._make_capsule_hull(
             (torch.as_tensor(lf, dtype=a[0].dtype),
              torch.as_tensor(ld, dtype=a[0].dtype)))(*a),
         (p2, R2, CYL, ph, R1, plane)),
    ]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_formulas_match_jax(dtype):
    tol = TOL_F64 if dtype == "float64" else TOLS["float32"]
    rs = np.random.RandomState(9)
    for name, jfn, tfn, ops in _formula_cases(rs, 64):
        ops = [np.asarray(o, dtype) for o in ops]
        ref = [np.asarray(r) for r in jfn(*[jnp.asarray(o) for o in ops])]
        got = [g.numpy() for g in tfn(*[torch.as_tensor(o) for o in ops])]
        assert len(got) == len(ref), name
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape, (name, k)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
            assert rel_err(g, r) <= tol, (name, k, rel_err(g, r))
        if name != "plane-cylinder":
            assert (got[0] < 0).any() and (got[0] > 0).any(), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_upright_puck_on_the_plane(dtype):
    """The axis along the plane's normal: both rim points fall back to the
    cylinder's x axis, the tangent is NaN (the frame takes the generic
    one); the upside-down puck alike; a tilt of 1e-3 rad takes the
    deepest rim point and the axis' projection."""
    p1, R1, p2, R2 = (np.asarray(x[..., :4], dtype) for x in _poses(
        np.random.RandomState(3), 4))
    plane = np.zeros((3, 1, 1), dtype)
    ops = (p1, R1, plane, p2, R2, CYL.astype(dtype))
    d, pos, n, tan = (x.numpy() for x in tcol._plane_cylinder(
        *[torch.as_tensor(o) for o in ops]))
    ref = CV._plane_cylinder(*[jnp.asarray(o) for o in ops])
    for g, r in zip((d, pos, n, tan), ref):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(np.asarray(r)))
        assert rel_err(g, np.asarray(r)) <= TOL_F64
    r, h = 0.025, 0.02
    up = p2[:, 0, 0] - p1[:, 0, 0]
    assert np.isnan(tan[:, :, 0, :2]).all() and np.isfinite(tan[:, :, 0, 2:]).all()
    # upright: cap +h then -h, each at the x axis' rim point
    np.testing.assert_allclose(d[:, 0, 0], [up[2] + h, up[2] - h], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pos[:, 0, 0, 0], p2[0, 0, 0] + r, rtol=0, atol=1e-6)
    # upside down: the x axis' rim point again, the caps swapped
    np.testing.assert_allclose(d[:, 0, 1], [up[2] - h, up[2] + h], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pos[:, 0, 0, 1], p2[0, 0, 1] + r, rtol=0, atol=1e-6)
    # tipped: the rim point the normal points away from, below the x axis'
    assert d[1, 0, 2] < up[2] - h


# ---------------------------------------------------------------------------
# the compact table and the env step
# ---------------------------------------------------------------------------


def jax_state_to_numpy(s):
    d = s.data
    data = {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d) if f.name != "contact"}
    c = d.contact
    data["contact"] = {n: None if getattr(c, n) is None else np.asarray(getattr(c, n))
                       for n in ("dist", "pos", "frame", "geom1", "geom2", "src")}
    return dict(
        data=data, obs={k: np.asarray(v) for k, v in s.obs.items()},
        reward=np.asarray(s.reward), terminated=np.asarray(s.terminated),
        truncated=np.asarray(s.truncated),
        info={k: np.asarray(v) for k, v in s.info.items()},
        goal=np.asarray(s.goal), steps=np.asarray(s.steps),
    )


def puck_states(qpos, oq):
    """qpos of two states: "pressed", the upright puck on the table at the
    height where its capsule-like bottom probe rests (0.5 mm deep), its
    top probe 4.2 mm up into the gripper link (env 0), and the puck off
    the table, tipped by 0.3 rad onto the floor, 0.5 mm deep (env 1);
    "resting", the same with env 0's puck on the table clear of the
    gripper."""
    pressed = qpos.copy()
    pressed[0, oq:oq + 7] = [1.06, 0.7497, 0.4445, 1.0, 0.0, 0.0, 0.0]
    pressed[1, oq:oq + 7] = [1.7, 1.4, 0.026, np.cos(0.15), np.sin(0.15), 0.0, 0.0]
    resting = pressed.copy()
    resting[0, oq:oq + 3] = [1.3, 0.9, 0.4445]
    return {"pressed": pressed, "resting": resting}


def jax_step(step, state, action):
    """One compiled JAX step: (the carried state, the transition and the
    stepped state, as numpy)."""
    s = step(state, jnp.asarray(action))
    return jax_state_to_numpy(state), (
        dict(obs={k: np.asarray(v) for k, v in s.obs.items()},
             reward=np.asarray(s.reward),
             info={k: np.asarray(v) for k, v in s.info.items()},
             terminated=np.asarray(s.terminated),
             truncated=np.asarray(s.truncated)),
        jax_state_to_numpy(s))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX BatchedEnv in float64: ({state name: (the carried state,
    (the transition, the stepped state))} as numpy, the action (a tenth of
    full range, so the gripper link keeps pressing the puck), the state
    the JAX reset drew, the JAX env)."""
    jenv = JSlide(dtype=jnp.float64)
    jenv.model = jenv.model.with_options(soa="force")
    jenv.max_episode_steps = 50
    jb = JBatched(jenv, B)
    jb.reset(seed=0)
    s_reset = jax_state_to_numpy(jb.state)
    mt = jenv.model.meta
    oq = mt.jnt_qposadr[mt.joint_names.index("object0:joint")]
    rs = np.random.RandomState(1)
    qvel = np.zeros((B, mt.nv))     # the puck moving; the arm at rest
    qvel[:, -6:] = rs.normal(0, 0.05, (B, 6))
    states = {name: dataclasses.replace(jb.state, data=dataclasses.replace(
        jb.state.data, qpos=jnp.asarray(q), qvel=jnp.asarray(qvel)))
        for name, q in puck_states(np.asarray(jb.state.data.qpos), oq).items()}
    action = rs.uniform(-1, 1, (B, 4)) * 0.1
    step = jb._step_fn.lower(states["pressed"], jnp.asarray(action)).compile(
        FAST_COMPILE)
    runs = {name: jax_step(step, st, action) for name, st in states.items()}
    return runs, action, s_reset, jenv


def cast_state(state, dtype):
    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    d, c = state.data, state.data.contact
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(
            c, dist=cast(c.dist), pos=cast(c.pos), frame=cast(c.frame)))
    return dataclasses.replace(
        state, data=data, obs={k: cast(v) for k, v in state.obs.items()},
        reward=cast(state.reward), goal=cast(state.goal),
        info={k: cast(v) for k, v in state.info.items()})


def port_step(jax_run, state, dtype):
    """The port's BatchedEnv in ``dtype`` from a carried state, one step:
    (its transition, its state)."""
    tdt = getattr(torch, dtype)
    tb = registry.make("FetchSlide-v4", num_envs=B, device="cpu", dtype=tdt)
    tb.reset(seed=0)
    tb.state = cast_state(convert.env_state_from_numpy(
        jax_run[0][state][0], "cpu"), tdt)
    out = tb.step(torch.as_tensor(jax_run[1], dtype=tdt))
    return out, tb.state


@pytest.fixture(scope="module")
def port64(jax_run):
    return port_step(jax_run, "pressed", "float64")


@pytest.mark.parametrize("dtype,state", [("float64", "pressed"),
                                         ("float64", "resting"),
                                         ("float32", "resting")])
def test_env_matches_jax(jax_run, port64, dtype, state):
    tol = TOLS[dtype]
    jt, js = jax_run[0][state][1]
    (to, tr, tte, ttr, ti), ts = (port64 if (dtype, state) == ("float64", "pressed")
                                  else port_step(jax_run, state, dtype))
    assert to["observation"].shape == (B, 25)
    for k in jt["obs"]:
        assert rel_err(to[k].numpy(), jt["obs"][k]) <= tol, k
    assert rel_err(tr.numpy(), jt["reward"]) <= tol
    assert rel_err(ti["is_success"].numpy(), jt["info"]["is_success"]) <= tol
    assert not jt["info"]["diverged"].any()
    for name, a_, b_ in (("terminated", jt["terminated"], tte),
                         ("truncated", jt["truncated"], ttr),
                         ("diverged", jt["info"]["diverged"], ti["diverged"])):
        np.testing.assert_array_equal(b_.numpy(), a_, err_msg=name)
    td, jd = ts.data, js["data"]
    for fld in ("qpos", "qvel", "qacc", "xpos", "mocap_pos", "mocap_quat",
                "time"):
        got = np.moveaxis(getattr(td, fld).numpy(), -1, 0)
        assert rel_err(got, jd[fld]) <= tol, fld
    if dtype == "float64":
        np.testing.assert_array_equal(td.contact.src.numpy().T,
                                      jd["contact"]["src"])


def test_compact_table_matches_jax(jax_run, port64):
    """The pruned compact table of the step's last substep (the kernel's
    groups through the plain narrowphase, the MPR groups as plain PyTorch)
    against JAX's pruned core's, field by field: the gripper link still
    presses the puck, the puck rests on the table and the tipped one on
    the floor, so every cylinder group has a penetrating row."""
    jc, tc = jax_run[0]["pressed"][1][1]["data"]["contact"], port64[1].data.contact
    a, b = jc["dist"], tc.dist.numpy().T
    assert b.shape == a.shape == (B, 273)
    near = a < BIG
    np.testing.assert_array_equal(b < BIG, near)
    assert rel_err(b[near], a[near]) <= TOLS["float64"]
    for k in ("pos", "frame"):
        a, b = jc[k], np.moveaxis(getattr(tc, k).numpy(), -1, 0)
        assert b.shape == a.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=TOLS["float64"] * max(
            1.0, np.nanmax(np.abs(a))), equal_nan=True, err_msg=k)
    for k in ("src", "geom1", "geom2"):
        np.testing.assert_array_equal(getattr(tc, k).numpy().T, jc[k], err_msg=k)
    dist = tc.dist.numpy()
    meta = FetchSlideEnv(dtype=torch.float64, device="cpu").model.meta
    touching = {}
    for g in tcol.prune_plan(meta).groups:
        if T.CYLINDER in g.tp:
            rows = dist[g.base_c:g.base_c + g.n_slots_c]
            touching[g.tp] = touching.get(g.tp, False) or bool((rows < 0).any())
    assert touching == {(T.PLANE, T.CYLINDER): True, (T.CYLINDER, T.MESH): True,
                        (T.CYLINDER, T.BOX): True}


def test_reset_with_values_matches_jax(jax_run):
    """Given the goals and puck positions the JAX reset drew (the goal
    0.4 ahead of the gripper's start, at the table's height), the port's
    host-value reset builds the same state."""
    ref = jax_run[2]
    tenv = FetchSlideEnv(dtype=torch.float64, device="cpu")
    oq = tenv._obj_qadr
    values = {"goal": ref["goal"], "object_xy": ref["data"]["qpos"][:, oq:oq + 2]}
    template = core.EnvState(None, None, None, None, None, {}, None,
                             torch.zeros(B, dtype=torch.int32))
    ts = tenv.reset_with_values(template, values)
    for k in ref["obs"]:
        np.testing.assert_allclose(ts.obs[k].numpy(), ref["obs"][k], rtol=0,
                                   atol=TOLS["float64"])
    for fld in ("qpos", "qvel", "xpos", "site_xpos", "mocap_pos"):
        got = np.moveaxis(getattr(ts.data, fld).numpy(), -1, 0)
        assert rel_err(got, ref["data"][fld]) <= TOLS["float64"], fld
    grip = tenv._init_grip.numpy()
    assert (np.abs(ref["goal"][:, :2] - grip[:2] - [0.4, 0.0]) <= 0.3).all()
    np.testing.assert_allclose(ref["goal"][:, 2], tenv._height_offset)


def test_parity_draws_match_jax(jax_run):
    """utils/parity's draws for FetchSlide (the puck within obj_range 0.1,
    0.1 from the gripper; the goal with the 0.4 target offset, at the
    table's height) equal the JAX package's from the same seed."""
    from gymnasium_robotics_tpu.utils import parity as jparity

    jenv = jax_run[3]
    tenv = FetchSlideEnv(dtype=torch.float64, device="cpu")
    for seed in range(4):
        ref = jparity._fetch_values(jenv, np.random.default_rng(seed))
        got = tparity.sample_reset_values(tenv, np.random.default_rng(seed))
        assert set(got) == set(ref) == {"object_xy", "goal"}
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
