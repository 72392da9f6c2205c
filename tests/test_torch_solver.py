"""The port's per-env solves (gymnasium_robotics_tpu_torch.physics.solver)
against the Pallas kernels they replace, run in interpret mode on the CPU:
solve_pos_plain vs solver_pallas.solve_pos_soa (_kernel_chol),
solve_newton_plain vs solver_pallas.solve_small_soa (_kernel_nv) and
solve_newton_nv2_plain vs solver_pallas.solve_small_nv2 (_kernel).

Tolerance: relative error scaled by max(1, |ref|) <= 1e-9 in float64 (the
two sides round the same operations in another order); the closed-form
nv = 2 solve is held in float32, at 2e-4. newton_tile_kernel's launch
geometry is held at the ported systems and the row caps, and
chol_tile_kernel's and newton2_kernel's (nv = 2, both routes) to the
constants of their source. The tests marked
``cuda`` hold each CUDA kernel against its plain version on the card
(<= 2e-4 in float32), also at the edges of the Newton kernel's shapes;
they skip where no card is present. The JAX imports
sit inside the tests so that the ``cuda`` test also runs where JAX is
missing."""

import functools

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch import kernels, registry
from gymnasium_robotics_tpu_torch.physics import constraint, solver

TOL64 = 1e-9
TOL32 = 2e-4


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


def _spd(rs, nv, B):
    """Random non-diagonal SPD matrices (nv, nv, B), plus lanes that hit the
    1e-20 diagonal floor exactly: a rank-deficient block of ones, a zero
    diagonal entry and an all-zero matrix (a freshly reset env's qM)."""
    A = rs.normal(size=(nv, nv, B))
    M = np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None]
    M[:, :, 0] = np.eye(nv)
    M[:2, :2, 0] = 1.0
    M[:, :, 1] = np.diag(np.arange(nv, dtype=np.float64) % 2)
    M[:, :, 2] = 0.0
    return M


@pytest.mark.parametrize("nv", [2, 3, 6])
@pytest.mark.parametrize("B", [5, 130])
def test_solve_pos_plain_matches_pallas(nv, B):
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    rs = np.random.RandomState(nv * 1000 + B)
    M = _spd(rs, nv, B)
    b = rs.normal(size=(nv, B))
    ref = np.asarray(SP.solve_pos_soa(jnp.asarray(M), jnp.asarray(b),
                                      interpret=True))
    out = solver.solve_pos_plain(torch.tensor(M), torch.tensor(b)).numpy()
    floored = np.abs(ref[:, 0]).max()
    assert floored > 1e8  # the floor was reached on the rank-deficient lane
    assert rel_err(out, ref) <= TOL64
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        solver.solve_pos(torch.tensor(M), torch.tensor(b)).numpy(), out)


def _chol_unrolled(M, b):
    """The floored LL^T solve entry by entry, as the kernels and
    solver_pallas._chol_solve_lanes order it: each entry of L and of y is
    t - a * b in ascending k, then a division by L_ii; the back
    substitution subtracts in ascending k."""
    nv = b.shape[0]
    L, y, x = {}, [], [None] * nv
    for i in range(nv):
        s = M[i, i]
        for k in range(i):
            s = s - L[(i, k)] * L[(i, k)]
        L[(i, i)] = torch.sqrt(torch.clamp(s, min=1e-20))
        for j in range(i + 1, nv):
            s = M[j, i]
            for k in range(i):
                s = s - L[(j, k)] * L[(i, k)]
            L[(j, i)] = s / L[(i, i)]
    for i in range(nv):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return torch.stack(x)


@pytest.mark.parametrize("nv", [2, 14, 21])
def test_solve_pos_plain_keeps_the_unrolled_order(nv):
    """The plain Cholesky takes whole columns at once and gives the
    entry-by-entry solve's results bit for bit, floored lanes included, in
    float64 and float32."""
    rs = np.random.RandomState(nv)
    M, b = _spd(rs, nv, 9), rs.normal(size=(nv, 9))
    for dtype in (torch.float64, torch.float32):
        Mt, bt = torch.tensor(M, dtype=dtype), torch.tensor(b, dtype=dtype)
        assert torch.equal(solver.solve_pos_plain(Mt, bt), _chol_unrolled(Mt, bt))


def _newton_ref(args, n_iter, n_ls):
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    M, asm, a0, J, aref, D, active, is_eq = (np.asarray(a) for a in args)
    if is_eq.ndim == 1:  # per model row: the Pallas entry takes (ne, B)
        is_eq = np.broadcast_to(is_eq[:, None], aref.shape)
    qacc, f = SP.solve_small_soa(
        jnp.asarray(M), jnp.asarray(asm), jnp.asarray(a0), jnp.asarray(J),
        jnp.asarray(aref), jnp.asarray(D), jnp.asarray(active),
        jnp.asarray(is_eq), n_iter=n_iter, n_ls=n_ls, interpret=True,
    )
    return np.asarray(qacc), np.asarray(f)


def _check_newton(args, n_iter, n_ls):
    qref, fref = _newton_ref(args, n_iter, n_ls)
    targs = [torch.tensor(np.asarray(a)) for a in args]
    qacc, f = solver.solve_newton_plain(*targs, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(qacc.numpy(), qref) <= TOL64
    assert rel_err(f.numpy(), fref) <= TOL64
    qw, fw = solver.solve_newton(*targs, n_iter=n_iter, n_ls=n_ls)
    np.testing.assert_array_equal(qw.numpy(), qacc.numpy())
    np.testing.assert_array_equal(fw.numpy(), f.numpy())


@functools.lru_cache(maxsize=None)
def _pointmaze_rows(B, steps, dtype=torch.float64, device="cpu"):
    """(M, a_smooth, a_warm, J, aref, D, active, is_eq (ne,)) of a PointMaze
    batch pushed into the walls, with the model's (n_iter, n_ls)."""
    env = registry.make("PointMaze_UMaze-v3", num_envs=B, device=device,
                        dtype=dtype)
    env.reset(seed=0)
    rs = np.random.RandomState(0)
    dirs = torch.tensor(rs.uniform(-1, 1, (B, 2)), dtype=dtype, device=device)
    for _ in range(steps):
        env.step(dirs)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    args = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    return args, min(m.opt.iterations, 20), min(m.opt.ls_iterations, 8)


def test_solve_newton_plain_matches_pallas_pointmaze():
    args, n_iter, n_ls = _pointmaze_rows(B=130, steps=25)
    J, active = args[3], args[6]
    assert J.shape[:2] == (19, 2) and (n_iter, n_ls) == (6, 4)
    assert bool(active[1:].any())  # some balls press on a wall
    _check_newton([a.numpy() for a in args], n_iter, n_ls)


@pytest.mark.parametrize("B", [7, 130])
def test_solve_newton_plain_matches_pallas_random(B):
    nv, ne = 3, 8
    rs = np.random.RandomState(B)
    args = [
        _spd(rs, nv, B)[:, :, [3] * 3 + list(range(3, B))],  # no floor lanes
        rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
        rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
        np.exp(rs.normal(size=(ne, B))),
        rs.uniform(size=(ne, B)) < 0.7, rs.uniform(size=(ne, B)) < 0.3,
    ]
    _check_newton(args, n_iter=5, n_ls=3)


def test_solve_pos_plain_matches_pallas_nv14():
    """The AntMaze system size, with the floored lanes of _spd."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    nv, B = 14, 5
    rs = np.random.RandomState(14)
    M = _spd(rs, nv, B)
    b = rs.normal(size=(nv, B))
    ref = np.asarray(SP.solve_pos_soa(jnp.asarray(M), jnp.asarray(b),
                                      interpret=True))
    out = solver.solve_pos_plain(torch.tensor(M), torch.tensor(b)).numpy()
    assert rel_err(out, ref) <= TOL64


def _antmaze_rows(rs, B):
    """Random rows at the AntMaze shapes (nv = 14, ne = 72: 8 limit rows
    and 16 capped condim-3 contacts x 4 pyramid edges), per-model is_eq."""
    nv, ne = 14, 72
    M = _spd(rs, nv, B)[:, :, [3] * 3 + list(range(3, B))]  # no floor lanes
    return [
        M, rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
        rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
        np.exp(rs.normal(size=(ne, B))), rs.uniform(size=(ne, B)) < 0.6,
        np.zeros(ne, bool),
    ]


def test_solve_newton_plain_matches_pallas_antmaze():
    args = _antmaze_rows(np.random.RandomState(72), 4)
    _check_newton(args, n_iter=5, n_ls=4)


def test_solve_pos_plain_matches_pallas_nv21():
    """The FetchPush system size, with the floored lanes of _spd."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    nv, B = 21, 5
    rs = np.random.RandomState(21)
    M = _spd(rs, nv, B)
    b = rs.normal(size=(nv, B))
    ref = np.asarray(SP.solve_pos_soa(jnp.asarray(M), jnp.asarray(b),
                                      interpret=True))
    out = solver.solve_pos_plain(torch.tensor(M), torch.tensor(b)).numpy()
    assert rel_err(out, ref) <= TOL64


def _fetch_rows(rs, B):
    """Random rows at the FetchPush shapes (nv = 21, ne = 255: 6 weld rows,
    equality, then 9 limit rows and 24 capped contacts x 4 and x 6 pyramid
    edges), per-model is_eq."""
    nv, ne = 21, 255
    M = _spd(rs, nv, B)[:, :, [3] * 3 + list(range(3, B))]  # no floor lanes
    is_eq = np.zeros(ne, bool)
    is_eq[:6] = True
    return [
        M, rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
        rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
        np.exp(rs.normal(size=(ne, B))), rs.uniform(size=(ne, B)) < 0.6, is_eq,
    ]


def test_solve_newton_plain_matches_pallas_fetch():
    args = _fetch_rows(np.random.RandomState(255), 4)
    _check_newton(args, n_iter=4, n_ls=4)


def test_solve_pos_plain_matches_pallas_nv36():
    """The HandManipulateBlock system size, with the floored lanes of
    _spd."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    nv, B = 36, 4
    rs = np.random.RandomState(36)
    M = _spd(rs, nv, B)
    b = rs.normal(size=(nv, B))
    ref = np.asarray(SP.solve_pos_soa(jnp.asarray(M), jnp.asarray(b),
                                      interpret=True))
    out = solver.solve_pos_plain(torch.tensor(M), torch.tensor(b)).numpy()
    assert rel_err(out, ref) <= TOL64


def _hand_rows(rs, B, ne=272):
    """Random rows at the HandManipulateBlock shapes (nv = 36, ne = 272: 24
    joint-limit and 88 tendon-limit rows, then 16 capped contacts x 4 and x
    6 pyramid edges), per-model is_eq (all False)."""
    nv = 36
    M = _spd(rs, nv, B + 3)[:, :, 3:]                  # no floor lanes
    return [
        M, rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
        rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
        np.exp(rs.normal(size=(ne, B))), rs.uniform(size=(ne, B)) < 0.4,
        np.zeros(ne, bool),
    ]


def test_solve_newton_plain_matches_pallas_hand():
    """nv = 36 at 40 rows (the interpret run's time is the unrolled nv = 36
    solve's, whatever the rows), with the hand's iterations."""
    args = _hand_rows(np.random.RandomState(36), 2, ne=40)
    _check_newton(args, n_iter=5, n_ls=4)


def _nv2_ref(args, n_iter, n_ls):
    """solver_pallas.solve_small_nv2 (interpret mode) over the batch of the
    port's batch-last operands, vmapped as the per-env path vmaps it."""
    import jax
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    M, asm, a0, J, aref, D, active, is_eq = (np.asarray(a) for a in args)
    lead = [np.moveaxis(x, -1, 0) for x in (M, asm, a0, J, aref, D, active)]
    eq_axis = None if is_eq.ndim == 1 else 0
    if eq_axis == 0:
        is_eq = np.moveaxis(is_eq, -1, 0)
    qacc, f = jax.vmap(
        lambda *a: SP.solve_small_nv2(*a, n_iter=n_iter, n_ls=n_ls,
                                      interpret=True),
        in_axes=(0,) * 7 + (eq_axis,))(*map(jnp.asarray, lead),
                                      jnp.asarray(is_eq))
    return np.moveaxis(np.asarray(qacc), 0, -1), np.moveaxis(np.asarray(f), 0, -1)


def _random_nv2_rows(rs, B, ne=19):
    return [
        _spd(rs, 2, B)[:, :, [3] * 3 + list(range(3, B))],  # no floor lanes
        rs.normal(size=(2, B)), rs.normal(size=(2, B)),
        rs.normal(size=(ne, 2, B)), rs.normal(size=(ne, B)),
        np.exp(rs.normal(size=(ne, B))),
        rs.uniform(size=(ne, B)) < 0.7, rs.uniform(size=(ne, B)) < 0.3,
    ]


@pytest.mark.parametrize("nv,ne", [(3, 1), (4, 3), (5, 2), (6, 38), (9, 70),
                                   (9, 62), (11, 22), (14, 108)])
def test_plain_solves_match_kernel_bodies_locomotion(nv, ne):
    """solve_newton_plain and solve_pos_plain at the locomotion models' nv
    and rows (InvertedDoublePendulum, Reacher, Swimmer, Hopper,
    HalfCheetah, Walker2d, Pusher, Ant past AntMaze's 96 rows; the
    humanoids' nv = 23 in tests/test_torch_humanoid.py) against the TPU
    kernels' bodies, solver_pallas._kernel_nv and _kernel_chol run op by op
    with their lanes the batch (random rows, B = 2), float64."""
    import _jax_ref as R

    assert nv in solver.KERNEL_NV and ne <= solver.NEWTON_MAX_ROWS[nv]
    args, qacc, f, x = R.kernel_body_solves(nv, ne, 4, 3, seed=nv + ne)
    q_got, f_got = solver.solve_newton_plain(*args, n_iter=4, n_ls=3)
    assert rel_err(q_got.numpy(), qacc) <= 1e-12
    assert rel_err(f_got.numpy(), f) <= 1e-12
    assert rel_err(solver.solve_pos_plain(args[0], args[1]).numpy(), x) <= 1e-12


@pytest.mark.parametrize("rows", ["pointmaze", "random"])
def test_solve_newton_nv2_plain_matches_pallas(rows):
    """float32, at 2e-4: PointMaze rows pushed into the walls (per-model
    is_eq) and random rows (is_eq per env)."""
    if rows == "pointmaze":
        args, n_iter, n_ls = _pointmaze_rows(B=130, steps=25)
        args = [a.numpy() for a in args]
    else:
        args, n_iter, n_ls = _random_nv2_rows(np.random.RandomState(2), 130), 5, 3
    args = [a.astype(np.float32) if a.dtype == np.float64 else a for a in args]
    qref, fref = _nv2_ref(args, n_iter, n_ls)
    targs = [torch.tensor(a) for a in args]
    qacc, f = solver.solve_newton_nv2_plain(*targs, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(qacc.numpy(), qref) <= TOL32
    assert rel_err(f.numpy(), fref) <= TOL32
    qw, fw = solver.solve_newton_nv2(*targs, n_iter=n_iter, n_ls=n_ls)
    np.testing.assert_array_equal(qw.numpy(), qacc.numpy())
    np.testing.assert_array_equal(fw.numpy(), f.numpy())
    with pytest.raises(ValueError, match="nv = 2"):
        solver.solve_newton_nv2(
            torch.eye(3)[:, :, None], torch.zeros(3, 1), torch.zeros(3, 1),
            torch.zeros(1, 3, 1), torch.zeros(1, 1), torch.ones(1, 1),
            torch.ones(1, 1, dtype=torch.bool),
            torch.zeros(1, dtype=torch.bool), n_iter=1, n_ls=1)


def test_wrappers_route_and_check():
    M = torch.eye(2)[:, :, None]
    b = torch.zeros(2, 1)
    assert solver._route_to_kernel(2, (M, b)) is False  # CPU: plain version
    with pytest.raises(ValueError, match="unsupported device"):
        solver._route_to_kernel(2, (M.to("meta"), b.to("meta")))
    with pytest.raises(ValueError, match="shape"):
        solver.solve_pos(M, torch.zeros(3, 1))
    # is_eq is per model row (ne,) or per env (ne, B), nothing else
    ne = 3
    rows = (torch.zeros(ne, 2, 1), torch.zeros(ne, 1), torch.ones(ne, 1),
            torch.ones(ne, 1, dtype=torch.bool))
    for is_eq, ok in ((torch.ones(ne, dtype=torch.bool), True),
                      (torch.ones(ne, 1, dtype=torch.bool), True),
                      (torch.ones(ne + 1, dtype=torch.bool), False)):
        if ok:
            solver.solve_newton(M, b, b, *rows, is_eq, n_iter=2, n_ls=2)
        else:
            with pytest.raises(ValueError, match="is_eq"):
                solver.solve_newton(M, b, b, *rows, is_eq, n_iter=2, n_ls=2)


def test_newton_geometry_covers_row_caps():
    """newton_tile_kernel's launch geometry for every ported system with a
    tile Newton (the locomotion models at nv = 3, 4, 5, 6, 9, 11, 14 and
    23, the AntMaze IDs at nv = 14, FetchReach at nv = 15, the other Fetch
    IDs at nv = 21, HandReach at nv = 24, FrankaKitchen-v1 at nv = 29,
    AdroitHandDoor and Pen at nv = 30, Hammer at nv = 33, the
    HandManipulateBlock IDs and AdroitHandRelocate at nv = 36) and at the
    row caps, at B from 1 up: the grid covers every env, a block's shared
    memory fits, the lanes hold the rows and the shape is the smallest of
    the nv's that does (nv = 14: 96 rows for AntMaze's 72, 128 for Ant's
    108); other nv and more rows raise."""
    systems = set()
    for id_ in registry.ids():
        m = registry.make(id_, num_envs=1, device="cpu").env.model
        if m.nv in solver.NEWTON_TILE_SHAPES:
            systems.add((m.nv, m.plan("rows", constraint._RowPlan).is_eq.numel()))
    assert systems == {(3, 1), (4, 3), (5, 2), (6, 38), (9, 70), (9, 62),
                       (11, 22), (14, 72), (14, 108), (15, 255), (21, 255),
                       (23, 244), (24, 272), (29, 188), (30, 278), (30, 272),
                       (33, 275), (36, 272), (36, 278)}
    for nv in solver.NEWTON_TILE_SHAPES:
        cap = solver.NEWTON_MAX_ROWS[nv]
        caps = [32 * w * r for w, r, _ in solver.NEWTON_TILE_SHAPES[nv]]
        assert caps == sorted(caps) and caps[-1] == cap
        for ne in sorted({1, 31, cap} | {n for v, n in systems if v == nv}):
            for B in (1, 7, 8, 2047, 2048, 8192):
                geo = solver.newton_geometry(nv, ne, B)
                assert (geo["grid"] - 1) * geo["tile"] < B <= geo["grid"] * geo["tile"]
                assert geo["smem"] <= kernels.SMEM_MAX
                assert geo["threads"] == geo["tile"] * 32 * geo["warps_per_env"]
                held = 32 * geo["warps_per_env"] * geo["rows_per_lane"]
                assert held == min(c for c in caps if c >= ne)
        with pytest.raises(NotImplementedError, match="rows"):
            solver.newton_geometry(nv, cap + 1, 1)
    assert solver.newton_shape(14, 96) == (1, 3, 8)
    assert solver.newton_shape(14, 97) == (1, 4, 8)
    with pytest.raises(NotImplementedError, match="nv=22"):
        solver.newton_geometry(22, 10, 1)


def test_chol_geometry_matches_source():
    """chol_tile_kernel's launch geometry (nv 3, 4, 5, 6, 9, 11, 14, 15, 21,
    23, 24, 29, 30, 33 and 36) against the
    constants of csrc/solver.cu (the tiles, the lanes an env, the triangle
    and right-hand side a block stages) at B from 1 up: the grid covers
    every env, the shared memory fits a static launch, up to nv = 36;
    other nv raise."""
    import os
    import re

    src = open(os.path.join(kernels.CSRC, "solver.cu")).read()
    tile16 = int(re.search(r"constexpr int kCholTile = (\d+);", src).group(1))
    tile8 = int(re.search(r"constexpr int kCholTileWide = (\d+);", src).group(1))
    small, big = map(int, re.search(
        r"static constexpr int LPE = NV <= 16 \? (\d+) : (\d+); +// lanes an env",
        src).groups())
    assert (tile16, tile8) == (solver.CHOL_TILE, solver.CHOL_TILE_WIDE)
    assert [solver.chol_geometry(nv, 1)["lanes_per_env"] for nv in (14, 21)] == [small, big]
    for nv in solver.CHOL_TILE_NV:
        lanes = small if nv <= 16 else big
        tile = tile16 if nv <= lanes else tile8
        for B in (1, 7, 16, 2047, 2048, 8192):
            geo = solver.chol_geometry(nv, B)
            assert (geo["grid"] - 1) * tile < B <= geo["grid"] * tile
            assert geo["threads"] == tile * lanes
            assert geo["rows_per_lane"] * lanes >= nv
            assert geo["smem"] == tile * (nv * (nv + 1) // 2 + nv) * 4 <= 48 * 1024
    assert tile16 * (36 * 37 // 2 + 36) * 4 <= 48 * 1024   # nv = 36, the design's top
    for nv in (2, 22):
        with pytest.raises(NotImplementedError, match=f"nv={nv}"):
            solver.chol_geometry(nv, 1)


def test_newton2_geometry_matches_source():
    """newton2_kernel's launch geometry (the nv = 2 Newton of both routes)
    for every ne from 1 to 64 against the constants of csrc/solver.cu: the
    rows a lane, the threads a block and the lanes an env nv2_lanes picks;
    a group's lanes hold ne rows, groups tile a warp, the grid covers every
    env; past 64 rows it raises, as the wrappers' row caps do."""
    import os
    import re

    src = open(os.path.join(kernels.CSRC, "solver.cu")).read()
    rows = int(re.search(r"constexpr int kNv2Rows = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int kNv2Threads = (\d+);", src).group(1))
    g_lo, g_lo2, g_hi, g_hi2 = map(int, re.search(
        r"return ne <= (\d+) \* kNv2Rows \? (\d+) : ne <= (\d+) \* kNv2Rows \? (\d+) : 0;",
        src).groups())
    assert (g_lo, g_hi) == (g_lo2, g_hi2) == solver.NV2_LANES
    assert (rows, threads) == (solver.NV2_ROWS_PER_LANE, solver.NV2_THREADS)
    assert solver.NEWTON_MAX_ROWS[2] == solver.NEWTON_NV2_MAX_ROWS == g_hi * rows
    for ne in range(1, solver.NEWTON_NV2_MAX_ROWS + 1):
        lanes = g_lo if ne <= g_lo * rows else g_hi
        for B in (1, 7, 8191, 8192):
            geo = solver.newton2_geometry(ne, B)
            assert geo["lanes_per_env"] == lanes, ne
            assert geo["rows_per_lane"] * lanes >= ne
            assert 32 % lanes == 0 and threads % 32 == 0
            assert geo["envs_per_block"] * lanes == geo["threads"] == threads
            assert (geo["grid"] - 1) * geo["envs_per_block"] < B
            assert B <= geo["grid"] * geo["envs_per_block"]
    with pytest.raises(NotImplementedError, match="64 rows"):
        solver.newton2_geometry(65, 1)


def test_kernel_strides_describe_views():
    """The kernels read each input through its element strides: the array
    the wrappers pass must rebuild every view from its storage, including
    the batch-leading views einsum leaves and the per-model is_eq."""
    B, ne = 5, 3
    b = torch.arange(2.0 * B).reshape(B, 2).T          # strides (1, 2)
    is_eq = torch.tensor([True, False, True]).expand(B, ne).T  # (1, 0)
    M = torch.arange(4.0 * B).reshape(B, 2, 2).permute(1, 2, 0)
    st = list(solver._strides(M, b, is_eq))
    assert st == [2, 1, 4, 1, 2, 1, 0]
    for t, s in ((M, st[:3]), (b, st[3:5]), (is_eq, st[5:])):
        flat = t.untyped_storage()
        base = torch.tensor([], dtype=t.dtype).set_(flat)
        assert torch.equal(base.as_strided(t.shape, s), t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    B = 8192
    rs = np.random.RandomState(0)
    M = torch.tensor(_spd(rs, 2, B), dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rs.normal(size=(2, B)), dtype=torch.float32,
                     device=cuda_device)
    n0 = dict(solver.LAUNCHES)
    x = solver.solve_pos(M, b)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["chol"] == n0["chol"] + 1
    ok = slice(3, None)  # the floored lanes amplify rounding by 1e10
    assert rel_err(x[:, ok].cpu(), solver.solve_pos_plain(M, b)[:, ok].cpu()) <= TOL32

    args, n_iter, n_ls = _pointmaze_rows(B, 25, torch.float32, cuda_device)
    qk, fk = solver.solve_newton(*args, n_iter=n_iter, n_ls=n_ls)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["newton"] > n0["newton"]
    qp, fp = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    assert rel_err(qk.cpu(), qp.cpu()) <= TOL32
    assert rel_err(fk.cpu(), fp.cpu()) <= TOL32


@pytest.mark.cuda
def test_kernels_match_plain_on_card_nv14(cuda_device):
    """nv = 14: chol_solve_kernel<14> on random SPD systems, and
    newton_tile_kernel<14, 1, 3> on random rows and on an AntMaze batch's
    own rows (B = 2048)."""
    B = 2048
    rs = np.random.RandomState(1)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    M, b = cuda(_spd(rs, 14, B)), cuda(rs.normal(size=(14, B)))
    n0 = dict(solver.LAUNCHES)
    x = solver.solve_pos(M, b)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["chol"] == n0["chol"] + 1
    ok = slice(3, None)
    assert rel_err(x[:, ok].cpu(), solver.solve_pos_plain(M, b)[:, ok].cpu()) <= TOL32

    env = registry.make("AntMaze_UMaze-v5", num_envs=B, device=cuda_device)
    env.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(10):
        env.step(torch.rand((B, 8), generator=gen, device=cuda_device) * 2 - 1)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    rand = [cuda(a) for a in _antmaze_rows(rs, B)]
    for args in (rand, real):
        qk, fk = solver.solve_newton(*args, n_iter=5, n_ls=4)
        torch.cuda.synchronize()
        qp, fp = solver.solve_newton_plain(*args, n_iter=5, n_ls=4)
        assert rel_err(qk.cpu(), qp.cpu()) <= TOL32
        assert rel_err(fk.cpu(), fp.cpu()) <= TOL32


def newton_errs(args, n_iter, n_ls):
    """(qacc, f) errors of the Newton kernel against its plain version: f
    on its largest entry; qacc = a_smooth + M^-1 J^T f, the small
    difference of large constraint terms, on the largest term a dof
    receives, max(1, |qacc|, sum_e |J_ev f_e| / M_vv) (float32 leaves it an
    error of eps times those terms)."""
    qk, fk = solver.solve_newton(*args, n_iter=n_iter, n_ls=n_ls)
    torch.cuda.synchronize()
    qp, fp = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    M, J = args[0], args[3]
    terms = torch.einsum("evb,eb->vb", J.abs(), fp.abs()) / torch.diagonal(
        M, dim1=0, dim2=1).T
    scale = max(1.0, float(qp.abs().max()), float(terms.max()))
    dq = float((qk.double() - qp.double()).abs().max())
    return dq / scale, rel_err(fk.cpu(), fp.cpu())


@pytest.mark.cuda
def test_kernels_match_plain_on_card_nv21(cuda_device):
    """nv = 21: chol_warp_kernel<21> on random SPD systems, and
    newton_tile_kernel<21, 2, 4> on random rows and on a FetchPush batch's
    own rows (B = 2048)."""
    B = 2048
    rs = np.random.RandomState(2)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    M, b = cuda(_spd(rs, 21, B)), cuda(rs.normal(size=(21, B)))
    n0 = dict(solver.LAUNCHES)
    x = solver.solve_pos(M, b)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["chol"] == n0["chol"] + 1
    ok = slice(3, None)
    assert rel_err(x[:, ok].cpu(), solver.solve_pos_plain(M, b)[:, ok].cpu()) <= TOL32

    env = registry.make("FetchPush-v4", num_envs=B, device=cuda_device)
    env.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(3):
        env.step(torch.rand((B, 4), generator=gen, device=cuda_device) * 2 - 1)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    assert J.shape[:2] == (255, 21)
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    rand = [cuda(a) for a in _fetch_rows(rs, B)]
    for args in (rand, real):
        for err in newton_errs(args, 4, 4):
            assert err <= TOL32


def gate64(args, n_iter, n_ls):
    """(kernel error, float32 plain version's error) of the Newton kernel
    against its plain version run in float64, on qacc and f each against
    its largest entry: the gate of the systems float32 itself moves."""
    got = solver.solve_newton(*args, n_iter=n_iter, n_ls=n_ls)
    torch.cuda.synchronize()
    plain = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    ref = solver.solve_newton_plain(
        *[a.double() if a.is_floating_point() else a for a in args],
        n_iter=n_iter, n_ls=n_ls)
    return (max(rel_err(g.cpu(), r.cpu()) for g, r in zip(got, ref)),
            max(rel_err(p.cpu(), r.cpu()) for p, r in zip(plain, ref)))


@pytest.mark.cuda
def test_kernels_match_plain_on_card_nv36(cuda_device):
    """nv = 36: chol_tile_kernel<36, true> on random SPD systems, and
    newton_tile_kernel<36, 3, 3, 4> on random rows and on a
    HandManipulateBlock batch's own rows (B = 1024), each within 2e-4 of its
    plain version in float32, or no further from the plain version run in
    float64 than max(2e-4, 2x the float32 plain version)."""
    B = 1024
    rs = np.random.RandomState(36)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    M, b = cuda(_spd(rs, 36, B)), cuda(rs.normal(size=(36, B)))
    n0 = dict(solver.LAUNCHES)
    x = solver.solve_pos(M, b)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["chol"] == n0["chol"] + 1
    ok = slice(3, None)
    assert rel_err(x[:, ok].cpu(), solver.solve_pos_plain(M, b)[:, ok].cpu()) <= TOL32

    env = registry.make("HandManipulateBlockRotateXYZ-v1", num_envs=B,
                        device=cuda_device, reset_pool_size=1)
    env.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(2):
        env.step(torch.rand((B, 20), generator=gen, device=cuda_device) * 2 - 1)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    assert J.shape[:2] == (272, 36)
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    rand = [cuda(a) for a in _hand_rows(rs, B)]
    for args in (rand, real):
        err, p32 = gate64(args, 5, 4)
        assert err <= max(TOL32, 2 * p32), (err, p32)


@pytest.mark.cuda
def test_kernels_match_plain_on_card_nv15(cuda_device):
    """nv = 15: chol_tile_kernel<15, false> on random SPD systems within
    2e-4 of its plain version, and newton_tile_kernel<15, 2, 4, 8>
    on random rows and on a FetchReach batch's own rows (B = 2048, 255
    rows), within max(2e-4, 2x the float32 plain version) of the plain
    version run in float64."""
    B = 2048
    rs = np.random.RandomState(15)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    M, b = cuda(_spd(rs, 15, B)), cuda(rs.normal(size=(15, B)))
    n0 = dict(solver.LAUNCHES)
    x = solver.solve_pos(M, b)
    torch.cuda.synchronize()
    assert solver.LAUNCHES["chol"] == n0["chol"] + 1
    ok = slice(3, None)
    assert rel_err(x[:, ok].cpu(), solver.solve_pos_plain(M, b)[:, ok].cpu()) <= TOL32

    env = registry.make("FetchReach-v4", num_envs=B, device=cuda_device)
    env.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(2):
        env.step(torch.rand((B, 4), generator=gen, device=cuda_device) * 2 - 1)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    assert J.shape[:2] == (255, 15)
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    A = rs.normal(size=(15, 15, B))
    rand = [cuda(a) for a in (
        np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(15)[:, :, None],
        rs.normal(size=(15, B)), rs.normal(size=(15, B)),
        rs.normal(size=(255, 15, B)), rs.normal(size=(255, B)),
        np.exp(rs.normal(size=(255, B))), rs.uniform(size=(255, B)) < 0.6,
        np.arange(255) < 6)]
    for args in (rand, real):
        err, p32 = gate64(args, 4, 4)
        assert err <= max(TOL32, 2 * p32), (err, p32)


@pytest.mark.cuda
def test_newton_edges_on_card(cuda_device):
    """newton_tile_kernel at the edges of its shapes against its plain
    version (nv = 14 but Ant's rows: within 2e-4 of it in float32; the
    rest, whose random systems float32 itself moves: within max(2e-4, 2x
    the float32 plain version's error) of the plain version run in
    float64): the row cap of every instantiation (64 at nv = 3-6, 96 at 9,
    32 at 11, 96 and 128 at 14 (AntMaze's shape and Ant's), 256 at 15 and
    21, 288 from 23 on) and one row under it at B = 1, an ne that is not a
    multiple of 32, and at 72 rows (the cap less 3 where that is smaller)
    a B that is not a multiple of the env tile, n_iter = 0, every row
    inactive and J in a batch-leading layout (the strided staging); at
    nv = 36 and 24 the hands' 272 rows at B = 1023, at nv = 29 the
    kitchen's 188 at B = 511, 8 iterations, and each locomotion model's
    rows at B = 8191, 20 iterations and 8 line-search steps. The
    wrapper's shared memory is the source's."""
    rs = np.random.RandomState(9)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    # the locomotion models' rows, at their 20 iterations and 8 line-search
    # steps (the nv they bring in run every case so)
    loco = {3: 1, 4: 3, 5: 2, 6: 38, 9: 70, 11: 22, 14: 108, 23: 244}
    for nv, n_iter in ((3, 20), (4, 20), (5, 20), (6, 20), (9, 20), (11, 20),
                       (14, 5), (15, 4), (21, 4), (23, 20), (24, 5), (29, 8),
                       (36, 5)):
        n_ls = 8 if n_iter == 20 else 4
        # every instantiation's row cap (nv = 14: AntMaze's 96, Ant's 128)
        caps = [32 * w * r for w, r, _ in solver.NEWTON_TILE_SHAPES[nv]]
        mid = min(72, caps[0] - 3)
        extra = {36: [(272, 1023, n_iter, n_ls, "")],
                 24: [(272, 1023, n_iter, n_ls, "")],
                 29: [(188, 511, n_iter, n_ls, "")]}.get(nv, [])
        if nv in loco:
            extra += [(loco[nv], 8191, 20, 8, "loco")]
        cases = [c for cap in caps for c in ((cap, 2048, n_iter, n_ls, ""),
                                             (cap - 1, 1, n_iter, n_ls, ""))]
        cases += [(min(45, mid), 13, n_iter, n_ls, ""),
                  (mid, 2047, n_iter, n_ls, ""), (mid, 64, 0, n_ls, ""),
                  (mid, 64, n_iter, n_ls, "inactive"),
                  (mid, 64, n_iter, n_ls, "strided")] + extra
        for ne, B, it, ls, case in cases:
            A = rs.normal(size=(nv, nv, B))
            is_eq = np.zeros(ne, bool)
            is_eq[:6] = True
            args = [cuda(a) for a in (
                np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None],
                rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
                rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
                np.exp(rs.normal(size=(ne, B))),
                (rs.uniform(size=(ne, B)) < 0.6) & (case != "inactive"), is_eq)]
            if case == "strided":   # (B, ne, nv) storage: batch stride ne nv
                args[3] = args[3].permute(2, 0, 1).contiguous().permute(1, 2, 0)
            n0 = solver.LAUNCHES["newton"]
            if nv == 14 and case != "loco":
                got = solver.solve_newton(*args, n_iter=it, n_ls=ls)
                torch.cuda.synchronize()
                plain = solver.solve_newton_plain(*args, n_iter=it, n_ls=ls)
                err = max(rel_err(g.cpu(), p.cpu()) for g, p in zip(got, plain))
                assert err <= TOL32, (nv, ne, B, it, case, err)
            else:
                err, p32 = gate64(args, it, ls)
                assert err <= max(TOL32, 2 * p32), (nv, ne, B, it, case, err, p32)
            assert solver.LAUNCHES["newton"] == n0 + 1
        for ne in (mid, *caps):
            assert (solver._lib().grt_newton_smem_bytes(nv, ne)
                    == solver.newton_geometry(nv, ne, 1)["smem"])


@pytest.mark.cuda
def test_chol_edges_on_card(cuda_device):
    """chol_tile_kernel at nv 3, 4, 5, 6, 9, 11, 14, 15, 21, 23, 24, 29 and
    36 against its plain version: B = 1 and
    B = 2047, M as a transposed and as a sliced view, b transposed, envs
    whose factor takes the 1e-20 floor exactly (equal to the plain
    version), an env with a NaN entry (NaN in both); and the same solves
    held to the plain version run in float64 (within 2e-4, or no further
    than twice the float32 plain version). The wrapper's shared memory is
    the source's."""
    rs = np.random.RandomState(12)
    for nv in (3, 4, 5, 6, 9, 11, 14, 15, 21, 23, 24, 29, 36):
        def spd(B):
            A = rs.normal(size=(nv, nv, B))
            return torch.tensor(np.einsum("ikb,jkb->ijb", A, A)
                                + 0.5 * np.eye(nv)[:, :, None],
                                dtype=torch.float32, device=cuda_device)

        def vec(B):
            return torch.tensor(rs.normal(size=(nv, B)), dtype=torch.float32,
                                device=cuda_device)

        M2, b2 = spd(4096), vec(4096)
        M64 = spd(64)
        M64[:, :, 0] = 0.0
        M64[:, :, 1] = torch.diag(torch.arange(nv, device=cuda_device) % 2.0)
        M64[0, 0, 5] = float("nan")
        cases = [(spd(1), vec(1)), (spd(2047), vec(2047)),
                 (M2[:, :, :2048].permute(2, 0, 1).contiguous().permute(1, 2, 0),
                  b2[:, :2048].T.contiguous().T),
                 (M2[:, :, ::2], b2[:, :2048]), (M64, vec(64))]
        for i, (M, b) in enumerate(cases):
            n0 = solver.LAUNCHES["chol"]
            x = solver.solve_pos(M, b)
            torch.cuda.synchronize()
            assert solver.LAUNCHES["chol"] == n0 + 1
            ref = solver.solve_pos_plain(M, b)
            if M is M64:
                assert torch.equal(x[:, :2], ref[:, :2])
                x, ref = x[:, 2:], ref[:, 2:]
                M, b = M[:, :, 2:], b[:, 2:]
            nan = ref.isnan()
            assert torch.equal(x.isnan(), nan) and int(nan.any(0).sum()) == (i == 4)
            assert rel_err(x[~nan].cpu(), ref[~nan].cpu()) <= TOL32, (nv, i)
            ok = ~nan.any(0)
            M, b, x = M[:, :, ok], b[:, ok], x[:, ok]
            r64 = solver.solve_pos_plain(M.double(), b.double())
            k = rel_err(x.cpu(), r64.cpu())
            p = rel_err(solver.solve_pos_plain(M, b).cpu(), r64.cpu())
            assert k <= max(TOL32, 2 * p), (nv, i, k, p)
        assert (solver._lib().grt_chol_smem_bytes(nv)
                == solver.chol_geometry(nv, 1)["smem"])


@pytest.mark.cuda
def test_newton_nv2_cap64_on_card(cuda_device):
    """newton2_kernel (8 lanes an env) on both routes on the rows of
    PointMaze_Medium-v3 (39) and PointMaze_Large-v3 (63), balls pushed into
    the walls, each held to its plain version run in float64: within 2e-4,
    or no further than twice the float32 plain version."""
    B = 2048
    for id_, ne in (("PointMaze_Medium-v3", 39), ("PointMaze_Large-v3", 63)):
        env = registry.make(id_, num_envs=B, device=cuda_device)
        env.reset(seed=0)
        rs = np.random.RandomState(0)
        dirs = torch.tensor(rs.uniform(-1, 1, (B, 2)), dtype=torch.float32,
                            device=cuda_device)
        for _ in range(25):
            env.step(dirs)
        m, d = env.env.model, env.state.data
        J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
        assert J.shape[0] == ne and bool(active[1:].any())
        args = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
        a64 = [a.double() if a.is_floating_point() else a for a in args]
        for kern, plain, counter in (
                (solver.solve_newton, solver.solve_newton_plain, "newton"),
                (solver.solve_newton_nv2, solver.solve_newton_nv2_plain,
                 "newton_nv2")):
            n0 = solver.LAUNCHES[counter]
            got = kern(*args, n_iter=6, n_ls=4)
            torch.cuda.synchronize()
            assert solver.LAUNCHES[counter] == n0 + 1
            ref = plain(*a64, n_iter=6, n_ls=4)
            p32 = plain(*args, n_iter=6, n_ls=4)
            k = max(rel_err(g.cpu(), r.cpu()) for g, r in zip(got, ref))
            p = max(rel_err(g.cpu(), r.cpu()) for g, r in zip(p32, ref))
            assert k <= max(TOL32, 2 * p), (id_, counter, k, p)


@pytest.mark.cuda
def test_newton_nv2_kernel_matches_plain_on_card(cuda_device):
    """newton2_kernel's determinant route (solve_newton_nv2) against
    solve_newton_nv2_plain at B = 8192 on
    a PointMaze batch's rows and on random rows (is_eq per env)."""
    B = 8192
    args, n_iter, n_ls = _pointmaze_rows(B, 25, torch.float32, cuda_device)
    rand = [torch.tensor(a, dtype=torch.bool if a.dtype == bool else
                         torch.float32, device=cuda_device)
            for a in _random_nv2_rows(np.random.RandomState(4), B)]
    for a, it, ls in ((args, n_iter, n_ls), (rand, 5, 3)):
        n0 = solver.LAUNCHES["newton_nv2"]
        qk, fk = solver.solve_newton_nv2(*a, n_iter=it, n_ls=ls)
        torch.cuda.synchronize()
        assert solver.LAUNCHES["newton_nv2"] == n0 + 1
        qp, fp = solver.solve_newton_nv2_plain(*a, n_iter=it, n_ls=ls)
        assert rel_err(qk.cpu(), qp.cpu()) <= TOL32
        assert rel_err(fk.cpu(), fp.cpu()) <= TOL32


@pytest.mark.cuda
def test_newton2_edges_on_card(cuda_device):
    """newton2_kernel on both routes (solve_newton at nv = 2, the Cholesky
    route; solve_newton_nv2, the determinant route) at ne in {1, 19, 32,
    33, 39, 63, 64}, at B = 1 and 8191 (a partial block), with n_iter = 0,
    with every row inactive and with J batch-leading (batch stride 2 ne),
    each held to its plain version run in float64: within 2e-4, or no
    further than twice the float32 plain version."""
    rs = np.random.RandomState(9)

    def cuda(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.float32, device=cuda_device)

    routes = ((solver.solve_newton, solver.solve_newton_plain, "newton"),
              (solver.solve_newton_nv2, solver.solve_newton_nv2_plain,
               "newton_nv2"))
    for ne in (1, 19, 32, 33, 39, 63, 64):
        for B, it, p_act, strided in ((1, 6, 0.6, False), (8191, 6, 0.6, False),
                                      (64, 0, 0.6, False), (64, 6, 0.0, False),
                                      (64, 6, 0.6, True)):
            args = [cuda(a) for a in _random_nv2_rows(rs, max(B, 4), ne)]
            args = [a[..., :B] for a in args]
            args[6] = args[6] & (torch.rand(args[6].shape, device=cuda_device) < p_act)
            if strided:
                args[3] = args[3].permute(2, 0, 1).contiguous().permute(1, 2, 0)
            a64 = [a.double() if a.is_floating_point() else a for a in args]
            for kern, plain, counter in routes:
                n0 = solver.LAUNCHES[counter]
                got = kern(*args, n_iter=it, n_ls=4)
                torch.cuda.synchronize()
                assert solver.LAUNCHES[counter] == n0 + 1
                ref = plain(*a64, n_iter=it, n_ls=4)
                p32 = plain(*args, n_iter=it, n_ls=4)
                k = max(rel_err(g.cpu(), r.cpu()) for g, r in zip(got, ref))
                p = max(rel_err(g.cpu(), r.cpu()) for g, r in zip(p32, ref))
                assert k <= max(TOL32, 2 * p), (counter, ne, B, it, p_act, strided, k, p)
        lanes = solver._lib().grt_newton2_lanes(ne)
        assert lanes == solver.newton2_geometry(ne, 1)["lanes_per_env"]
    assert solver._lib().grt_newton2_lanes(65) == 0
