"""The Adroit slice's parts against the JAX package (its env steps are in
tests/test_torch_adroit_{door,hammer,pen,relocate}.py):

- the four contact formulas it adds (sphere-capsule, capsule-capsule,
  capsule-cylinder, cylinder-cylinder, with _point_cylinder beneath them)
  against collision_vec's, in float64 within 1e-12 on random poses and on
  the edges: a capsule parallel to the cylinder's axis beside its side,
  over a cap and through the rim; parallel and coincident segments (the
  |denom| <= 1e-12 branch); a sphere centred on the capsule's axis (the +z
  fallback); points at z = 0 and on the axis (rlen = 0). In float32 within
  2e-4 on every lane but one where the capsule-cylinder search's rounds
  are decided by rounding (held there to float64, against JAX's own
  float32 error); the search's t (where along the capsule the contact
  sits) agreeing with the JAX search's (its loop run on
  collision_vec._point_cylinder) within 1e-12 in float64 and 2e-4 in
  float32;
- narrowphase_plain on Door's capsule-capsule and Relocate's
  sphere-capsule groups against the Pallas megakernel in interpret mode
  (float32, 2e-4);
- the plain solves at nv = 30 (Door) and 33 (Hammer) at the models' row
  counts against the TPU kernels' bodies (solver_pallas._kernel_nv and
  _kernel_chol) run eagerly, in float64 (1e-12);
- the 16 IDs, their spaces and limits against the JAX registry's; three
  steps of the single env (make_gym); the reference's state dicts round
  trip; the parity draws against the JAX package's;
- Model.rebind: an env step builds no plan anew, and the plans that read
  the rebound fields (the FK kernel's tables) are not shared; the FK
  kernel refuses a rebound model with per-env tables."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from _jax_ref import _Ref

from gymnasium_robotics_tpu import registry as jreg
from gymnasium_robotics_tpu.envs.adroit import adroit as JA
from gymnasium_robotics_tpu.physics import collision_vec as CV
from gymnasium_robotics_tpu_torch import kernels, registry
from gymnasium_robotics_tpu_torch.envs.adroit import adroit as TA
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import kinematics as KIN
from gymnasium_robotics_tpu_torch.physics import narrowphase as tnp
from gymnasium_robotics_tpu_torch.physics import pipeline, solver
from gymnasium_robotics_tpu_torch.physics import constraint
from gymnasium_robotics_tpu_torch.physics import smooth as tsm
from gymnasium_robotics_tpu_torch.physics import types as T
from gymnasium_robotics_tpu_torch.utils import parity as tparity

TOL64, TOL32 = 1e-12, 2e-4
N = 64


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


def _sizes(*s):
    return np.array(s, np.float64)[:, None, None]


CAP = _sizes(0.01, 0.02, 0.0)     # a finger phalanx: radius, half length
CYL = _sizes(0.015, 0.05, 0.0)    # the door handle: radius, half height
CYL2 = _sizes(0.03, 0.01, 0.0)    # a short, wide cylinder


def _edges(n):
    """(p1, R1, p2, R2) (3, 1, n) and (3, 3, 1, n): geom 2 upright at the
    origin, geom 1 at random poses within 6 cm, except lanes 0-5: a
    capsule parallel to the axis beside the side (lane 0, 1 mm in; lane 1
    1 mm clear), lying across the +z cap (lane 2) and the -z cap (lane 3),
    through the rim at 45 degrees (lane 4), and along the axis itself
    (lane 5: every probe at rlen = 0)."""
    rs = np.random.RandomState(7)
    q1 = rs.normal(size=(n, 4))
    p1 = rs.normal(0, 0.03, (3, n))
    s45 = np.sin(np.pi / 8)
    q1[:6] = [[1, 0, 0, 0], [1, 0, 0, 0], [np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0],
              [np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0],
              [np.cos(np.pi / 8), 0, s45, 0], [1, 0, 0, 0]]
    p1[:, :6] = np.array([[0.024, 0.0, 0.0], [0.026, 0.0, 0.0],
                          [0.0, 0.0, 0.059], [0.0, 0.0, -0.058],
                          [0.02, 0.0, 0.055], [0.0, 0.0, 0.01]]).T
    R2 = np.repeat(np.eye(3)[:, :, None], n, axis=2)
    return (p1[:, None], _rot(q1)[:, :, None], np.zeros((3, 1, n)),
            R2[:, :, None])


def _segments(n):
    """Capsule poses: random, except lanes 0-3: parallel segments side by
    side (lane 0) and end to end (lane 1), coincident segments (lane 2),
    and crossed ones (lane 3)."""
    rs = np.random.RandomState(8)
    q1, q2 = rs.normal(size=(n, 4)), rs.normal(size=(n, 4))
    q1[:4] = q2[:4] = [1, 0, 0, 0]
    q2[3] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0]
    p1 = rs.normal(0, 0.02, (3, n))
    p2 = p1 + rs.normal(0, 0.02, (3, n))
    p2[:, :4] = p1[:, :4] + np.array([[0.015, 0, 0], [0, 0, 0.035], [0, 0, 0],
                                      [0, 0.005, 0.0]]).T
    return p1[:, None], _rot(q1)[:, :, None], p2[:, None], _rot(q2)[:, :, None]


def _sphere_on_axis(n):
    """A sphere and a capsule at random poses, lanes 0-1 with the sphere's
    centre on the capsule's segment (exactly, at its middle and at an
    end)."""
    p1, R1, p2, R2 = _segments(n)
    p1 = p1.copy()
    p1[:, :, 0] = p2[:, :, 0]
    p1[:, :, 1] = p2[:, :, 1] + R2[:, 2, :, 1] * 0.02
    return p1, R1, p2, R2


def jax_cylinder_t(p1, R1, s1, p2, R2, s2):
    """The JAX capsule-cylinder search's t: collision_vec._capsule_cylinder's
    loop, on collision_vec._point_cylinder."""
    ax = CV._col(R1, 2)

    def sd_at(t):
        return CV._point_cylinder(p1 + ax * (t * s1[1])[None], p2, R2, s2)[0]

    lo = jnp.full(p1.shape[1:], -1.0, p1.dtype)
    hi = jnp.full(p1.shape[1:], 1.0, p1.dtype)
    for _ in range(24):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        go_right = sd_at(m1) > sd_at(m2)
        lo = jnp.where(go_right, m1, lo)
        hi = jnp.where(go_right, hi, m2)
    return 0.5 * (lo + hi)


def _cases():
    """(name, jax fn, port fn, operands (float64 numpy))."""
    e = _edges(N)
    seg = _segments(N)
    sph = _sphere_on_axis(N)
    ball = _sizes(0.035, 0.0, 0.0)
    pts = e[0][:, 0]
    pts[:, 6:10] = np.array([[0.03, 0.01, 0.0], [0.0, 0.0, 0.0],
                             [0.0, 0.0, 0.07], [0.01, 0.0, 0.0]]).T  # z = 0, rlen = 0
    return [
        ("capsule-cylinder", CV._capsule_cylinder, tcol._capsule_cylinder,
         (e[0], e[1], CAP, e[2], e[3], CYL)),
        ("cylinder-cylinder", CV._cylinder_cylinder, tcol._cylinder_cylinder,
         (e[0], e[1], CYL2, e[2], e[3], CYL)),
        ("capsule-capsule", CV._capsule_capsule, tcol._capsule_capsule,
         (seg[0], seg[1], CAP, seg[2], seg[3], CAP)),
        ("sphere-capsule", CV._sphere_capsule, tcol._sphere_capsule,
         (sph[0], sph[1], ball, sph[2], sph[3], CAP)),
        ("point-cylinder", lambda P, pc, Rc, s: CV._point_cylinder(P, pc, Rc, s[:, 0]),
         lambda P, pc, Rc, s: tcol._point_cylinder(P, pc, Rc, s[:, 0]),
         (pts, e[2][:, 0], e[3][:, :, 0], CYL)),
    ]


def _lane_err(x, ref):
    """Per lane (last axis): the largest |x - ref| over the other axes,
    over max(1, |ref|) there."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    d = np.abs(x - ref).reshape(-1, x.shape[-1])
    return np.nanmax(d, 0) / np.maximum(1.0, np.nanmax(
        np.abs(ref).reshape(-1, x.shape[-1]), 0))


def _run(fn, ops, dtype, lib):
    if lib is jnp:
        return [np.asarray(r) for r in fn(*[jnp.asarray(np.asarray(o, dtype))
                                            for o in ops])]
    return [g.numpy() for g in fn(*[torch.as_tensor(np.asarray(o, dtype))
                                    for o in ops])]


def test_formulas_match_jax_float64():
    for name, jfn, tfn, ops in _cases():
        ref, got = _run(jfn, ops, "float64", jnp), _run(tfn, ops, "float64", torch)
        assert len(got) == len(ref), name
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape, (name, k)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
            assert rel_err(g, r) <= TOL64, (name, k, rel_err(g, r))
        if name != "point-cylinder":
            assert (got[0] < 0).any() and (got[0] > 0).any(), name


def test_formulas_match_jax_float32():
    """In float32 every lane within 2e-4 of JAX's float32 answer, except a
    lane where the capsule-cylinder search's rounds are decided by rounding
    (sd flat along the capsule): there the two searches may end at t's a
    few 1e-5 apart (measured: one lane of 64, t 5.2e-5 apart, its normal
    3.1e-4), and the lane is held to the float64 answer no further than
    twice JAX's float32 answer is (or 2e-4)."""
    for name, jfn, tfn, ops in _cases():
        got, ref = _run(tfn, ops, "float32", torch), _run(jfn, ops, "float32", jnp)
        ref64 = _run(jfn, ops, "float64", jnp)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
        e32 = np.max([_lane_err(g, r) for g, r in zip(got, ref)], 0)
        e_port = np.max([_lane_err(g, r) for g, r in zip(got, ref64)], 0)
        e_jax = np.max([_lane_err(g, r) for g, r in zip(ref, ref64)], 0)
        off = e32 > TOL32
        assert off.sum() <= (1 if name == "capsule-cylinder" else 0), (name, e32.max())
        assert (e_port[off] <= np.maximum(TOL32, 2 * e_jax[off])).all(), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cylinder_search_t_matches_jax(dtype):
    """t of the port's search against the JAX search's, also on the edge
    lanes where the distance is flat along the capsule (lanes 0-1, beside
    the side: every t ties in exact arithmetic, and both searches keep the
    left third on each tie, so t sits at the capsule's -z end); the contact
    point follows t."""
    e = [np.asarray(o, dtype) for o in _edges(N)]
    ops = (e[0], e[1], CAP.astype(dtype), e[2], e[3], CYL.astype(dtype))
    t_ref = np.asarray(jax_cylinder_t(*[jnp.asarray(o) for o in ops]))
    t = tcol.capsule_cylinder_t(*[torch.as_tensor(o) for o in ops]).numpy()
    assert np.abs(t - t_ref).max() <= (TOL64 if dtype == "float64" else TOL32)
    assert (t[0, :2] < -0.99).all()      # beside the side: the -z end


def test_point_cylinder_edges():
    """z = 0 takes the +z cap's side, a point on the axis the x axis as its
    radial direction; inside, the nearer of the side and the cap."""
    P = torch.tensor([[0.0, 0.03, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.02]],
                     dtype=torch.float64).T[:, None]          # (3, 1, 3)
    R = torch.eye(3, dtype=torch.float64)[:, :, None, None]
    s = torch.tensor([0.015, 0.05], dtype=torch.float64)[:, None, None]
    sd, surf, n = tcol._point_cylinder(P, torch.zeros(3, 1, 1, dtype=torch.float64), R, s)
    np.testing.assert_allclose(sd[0].numpy(), [0.015, -0.015, -0.015], atol=1e-15)
    # on the axis at z = 0: the side along +x (the radial fallback)
    np.testing.assert_allclose(surf[:, 0, 1].numpy(), [0.015, 0.0, 0.0], atol=1e-15)
    np.testing.assert_allclose(n[:, 0, 1].numpy(), [1.0, 0.0, 0.0], atol=1e-15)


# ---------------------------------------------------------------------------
# the narrowphase megakernel's new kinds
# ---------------------------------------------------------------------------


def _jax_megakernel(table, P, Rm, sizes, sel):
    """The Pallas megakernel in interpret mode on the groups of ``table``,
    operands gathered as collision_vec's take_static / take_sel gather
    them: the groups' rows end to end."""
    from gymnasium_robotics_tpu.physics import narrowphase_pallas as NPK

    B = P.shape[-1]
    lane = np.arange(B)
    specs, arrays, off = [], [], 0
    for grp in table.groups:
        ops = []
        for gl in (grp.g1.numpy(), grp.g2.numpy()):
            if grp.sel_group < 0:
                ops += [P[gl].transpose(1, 0, 2), np.moveaxis(Rm[gl], 0, 2),
                        sizes[gl].transpose(1, 0, 2)]
            else:
                gid = gl[np.clip(sel[grp.sel_group], 0, len(gl) - 1)]
                ops += [P[gid, :, lane].transpose(2, 0, 1),
                        Rm[gid, :, :, lane].transpose(2, 3, 0, 1),
                        sizes[gid, :, 0].transpose(2, 0, 1)]
        t1, t2 = tnp.KINDS[grp.kind]
        specs.append(NPK.GroupSpec(t1=t1, t2=t2, S=grp.S, k=grp.k,
                                   row_off=off, n_arrays=6, use_mpr=False))
        arrays += [jnp.asarray(a) for a in ops]
        off += grp.k * grp.S
    out = NPK.narrowphase_megakernel(tuple(specs), arrays, off, B,
                                     jnp.float32, interpret=True)
    return [np.asarray(o) for o in out]   # the groups' rows, end to end


@pytest.mark.parametrize("task,kinds", [("door", (10,)), ("relocate", (13,))])
def test_new_kinds_match_megakernel(task, kinds):
    """narrowphase_plain on Door's capsule-capsule and Relocate's
    sphere-capsule groups against the Pallas megakernel (interpret mode) on
    the same picks, B = 4 pressed hands (tests/_adroit_cases.py), float32.
    The cylinder kinds' searches are held to the XLA path (the formulas
    above and the env steps' compact tables): in interpret mode their 24
    rounds take a minute to trace."""
    import _adroit_cases as C

    B = 4
    env = C.port_env(task, torch.float32).env
    q, aux = C.pressed(C.port_env(task).env, B, C.PRESS_SEED[task])
    m = env._model_for({k: torch.tensor(v, dtype=torch.float32) for k, v in aux.items()})
    d = dataclasses.replace(pipeline.make_data(m, B),
                            qpos=torch.tensor(q.T, dtype=torch.float32).contiguous())
    d = tsm.kinematics(m, d)
    tp = m.plan("pruned", tcol._PrunedPlan)
    table = tp.table.only(kinds)
    sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
    args = (d.geom_xpos, d.geom_xmat, m.geom_size)
    got = tnp.narrowphase_plain(table, *args, sel)
    ref = _jax_megakernel(table, *[a.numpy() for a in args], sel.numpy())
    rows = table.rows.numpy()
    for g, r, name in zip(got, ref, ("dist", "pos", "frame")):
        g = g.numpy()[rows]
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL32 * max(
            1.0, np.nanmax(np.abs(r))), equal_nan=True, err_msg=name)
    assert (got[0][rows] < 0).any()


# ---------------------------------------------------------------------------
# the solves at nv = 30 and 33
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["door", "hammer"])
def test_solves_match_kernel_bodies(task):
    """solve_newton_plain and solve_pos_plain at the model's nv and row
    count (random rows, B = 2) against the TPU kernels' bodies
    (solver_pallas._kernel_nv and _kernel_chol, their lanes the batch),
    run eagerly, in float64."""
    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    m = registry.make(f"AdroitHand{task.capitalize()}-v1", device="cpu").model
    nv = m.nv
    ne = m.plan("rows", constraint._RowPlan).is_eq.numel()
    assert (nv, ne) == {"door": (30, 278), "hammer": (33, 275)}[task]
    assert nv in solver.KERNEL_NV and ne <= solver.NEWTON_MAX_ROWS[nv]
    B = 2
    rs = np.random.RandomState(nv)
    A = rs.normal(size=(nv, nv, B))
    M = np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None]
    asm, a0 = rs.normal(size=(nv, B)), rs.normal(size=(nv, B))
    J = rs.normal(size=(ne, nv, B)) * 0.3
    aref, D = rs.normal(size=(ne, B)), np.exp(rs.normal(size=(ne, B)))
    active = rs.uniform(size=(ne, B)) < 0.4
    is_eq = np.zeros(ne, bool)
    n_iter, n_ls = m.opt.iterations, m.opt.ls_iterations
    tri = np.stack([M[i, j] for i in range(nv) for j in range(i + 1)])
    qacc, f = _Ref(np.zeros((nv, B))), _Ref(np.zeros((ne, B)))
    x = _Ref(np.zeros((nv, B)))
    with jax.disable_jit():
        SP._kernel_nv(nv, n_iter, n_ls, _Ref(tri), _Ref(asm), _Ref(a0),
                      _Ref(J.transpose(1, 0, 2)), _Ref(aref), _Ref(D),
                      _Ref(active.astype(np.float64)),
                      _Ref(np.zeros((ne, B))), qacc, f)
        SP._kernel_chol(nv, _Ref(tri), _Ref(asm), x)
    t = [torch.tensor(a) for a in (M, asm, a0, J, aref, D, active, is_eq)]
    q_got, f_got = solver.solve_newton_plain(*t, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(q_got.numpy(), qacc.a) <= TOL64
    assert rel_err(f_got.numpy(), f.a) <= TOL64
    assert rel_err(solver.solve_pos_plain(t[0], t[1]).numpy(), x.a) <= TOL64


# ---------------------------------------------------------------------------
# registry, single env, state dicts, resets
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    ids = [i for i in registry.ids() if i.startswith("Adroit")]
    jids = [i for i in jreg.ids() if i.startswith("Adroit")]
    assert sorted(ids) == sorted(jids) and len(ids) == 16
    assert len(registry.ids()) == 197
    for id_ in ids:
        s, js = registry.spec(id_), jreg.spec(id_)
        assert s.kwargs == js.kwargs and s.max_episode_steps == js.max_episode_steps == 200
    for task, cls in (("door", TA.AdroitHandDoorEnv), ("hammer", TA.AdroitHandHammerEnv),
                      ("pen", TA.AdroitHandPenEnv),
                      ("relocate", TA.AdroitHandRelocateEnv)):
        gym = registry.make_gym(f"AdroitHand{task.capitalize()}Sparse-v2",
                                device="cpu")
        jcls = getattr(JA, cls.__name__)
        assert gym.env.model.opt.soa is False and gym.env.sparse_reward
        assert gym.env.obs_dim == jcls.obs_dim
        if gym.observation_space is not None:
            jenv = jcls()
            assert gym.observation_space == jenv.observation_space
            assert gym.action_space == jenv.action_space
        assert gym.env.model.opt.pair_topk == (24 if task == "pen" else 16)


def test_single_env_steps_and_round_trips():
    """make_gym on the per-env path: a parity reset, 3 steps; the
    reference's state dict (qpos, qvel, the door's position) round-trips,
    and a reset from it (options initial_state_dict) gives its
    observation."""
    gym = registry.make_gym("AdroitHandDoor-v1", parity=True, device="cpu")
    obs, info = gym.reset(seed=4)
    assert obs.shape == (39,) and obs.dtype == np.float64
    rng = np.random.default_rng(0)
    for _ in range(3):
        obs, r, term, trunc, info = gym.step(rng.uniform(-1, 1, 28))
        assert np.isfinite(obs).all() and not term and not trunc
    state = gym.get_env_state()
    assert set(state) == {"qpos", "qvel", "door_body_pos"}
    assert state["qpos"].shape == (30,)
    # a step's observation reads the poses of its last substep's forward,
    # a set state's those of its own qpos (the reference's mj_forward)
    gym.set_env_state(state)
    again = registry.make_gym("AdroitHandDoor-v1", device="cpu")
    obs2, _ = again.reset(seed=9, options={"initial_state_dict": state})
    np.testing.assert_allclose(obs2, gym._obs(), rtol=0, atol=1e-6)
    for k, v in again.get_env_state().items():
        np.testing.assert_allclose(v, state[k], rtol=0, atol=1e-7, err_msg=k)


# the keys of the reference's state dicts that set_env_state writes
SET_KEYS = {"door": ("qpos", "qvel", "door_body_pos"),
            "hammer": ("qpos", "qvel", "board_pos"),
            "pen": ("qpos", "qvel", "desired_orien"),
            "relocate": ("qpos", "qvel", "obj_pos", "target_pos")}


@pytest.mark.parametrize("task", ["door", "hammer", "pen", "relocate"])
def test_state_dicts_round_trip(task):
    env = TA.CLASSES[f"AdroitHand{task.capitalize()}"](dtype=torch.float64,
                                                        device="cpu")
    s = env.initial(3, torch.Generator().manual_seed(1))
    rs = np.random.RandomState(2)
    d = env.get_env_state(s)
    d["qpos"] = d["qpos"] + torch.tensor(rs.uniform(-0.05, 0.05, d["qpos"].shape))
    s2 = env.set_env_state(s, d)
    back = env.get_env_state(s2)
    assert set(back) == set(d)
    for k in SET_KEYS[task]:    # the others the kinematics recompute
        np.testing.assert_allclose(back[k].numpy(), d[k].numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert not torch.equal(s2.obs, s.obs)


@pytest.mark.parametrize("task", ["door", "hammer", "pen", "relocate"])
def test_parity_draws_match_jax(task):
    """The parity sampler's scene draws equal the JAX package's from the
    same seeds (reset_with_values from such draws against JAX's reset:
    tests/test_torch_adroit_<task>.py)."""
    from gymnasium_robotics_tpu.utils import parity as jparity

    name = f"AdroitHand{task.capitalize()}"
    tenv = TA.CLASSES[name](dtype=torch.float64, device="cpu")
    jenv = getattr(JA, f"{name}Env")(dtype=jnp.float64)
    for seed in range(4):
        ref = jparity._adroit_values(jenv, np.random.default_rng(seed))
        got = tparity.sample_reset_values(tenv, np.random.default_rng(seed))
        assert set(got) == set(ref) == set(tenv._sample_aux(1, torch.Generator()))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# Model.rebind
# ---------------------------------------------------------------------------


def test_rebind_builds_no_plan_per_step(monkeypatch):
    """Over env steps of a batch whose scene is rebound every step, the
    plans are built once (the first step) and then shared."""
    builds = []
    plan = T.Model.plan

    def counting(self, name, build):
        def counted(m):
            builds.append(name)
            return build(m)
        return plan(self, name, counted)

    monkeypatch.setattr(T.Model, "plan", counting)
    env = registry.make("AdroitHandRelocate-v1", num_envs=2, device="cpu")
    env.reset(seed=0)
    env.step(torch.zeros(2, 30))
    n = len(builds)
    assert n > 0 and len(set(builds)) == n       # each plan once
    for _ in range(2):
        env.step(torch.zeros(2, 30))
    assert len(builds) == n, builds[n:]


def test_rebind_shares_only_plans_of_other_fields():
    m = TA.AdroitHandDoorEnv(device="cpu").model
    rows = m.plan("rows", constraint._RowPlan)
    tabs = m.plan("fk_kernel", KIN._KernelTables)
    bp = m.body_pos.clone()
    bp[5, 0] += 0.1
    r = m.rebind(body_pos=bp)
    assert r.plan("rows", constraint._RowPlan) is rows
    assert r.plan("fk_kernel", KIN._KernelTables) is not tabs   # reads body_pos
    assert not torch.equal(r.plan("fk_kernel", KIN._KernelTables).ftab, tabs.ftab)
    assert m.plan("fk_kernel", KIN._KernelTables) is tabs
    rr = r.rebind(site_pos=m.site_pos.clone())
    assert rr.plan("rows", constraint._RowPlan) is rows
    assert rr.with_options(iterations=3).plan("rows", constraint._RowPlan) is not rows


def test_fk_kernel_refuses_per_env_tables(monkeypatch):
    """A rebound model whose FK constants differ per env (trailing axis B)
    is not one the FK kernel takes: on the card its route raises, and it
    never reads lane 0's constants."""
    env = TA.AdroitHandDoorEnv(device="cpu")
    aux = env._sample_aux(3, torch.Generator().manual_seed(0))
    m = env._model_for(aux)
    assert m.body_pos.shape[-1] == 3 and not KIN.supported(m)
    assert KIN.supported(env._model_for({k: v[:1] for k, v in aux.items()}))
    d = pipeline.make_data(env.model, 3)
    monkeypatch.setattr(kernels, "on_card", lambda *a, **k: True)
    for fk in (True, "force"):
        with pytest.raises(NotImplementedError, match="FK kernel"):
            tsm.kinematics(m.with_options(fk_kernel=fk), d)
