"""The narrowphase's pair formulas (gymnasium_robotics_tpu_torch.physics
.collision) against the collision_vec functions they replace, and the
CUDA narrowphase's task tables (the rest of the narrowphase in
tests/test_torch_narrowphase.py).

- each formula vs its collision_vec function in float64 (1e-12), with the
  degenerate poses: a capsule standing on the plane (NaN tangent), a
  capsule parallel to a box face, boxes with parallel edges.
- the task table of every family's pruned table writes each compact row
  once, cooperative items alone, the longest tasks first."""

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch.envs.maze import maps, maze_core
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import narrowphase as tnp

TOL64 = 1e-12
BIG = 1e9


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.nanmax(np.abs(x - ref)) / max(1.0, np.nanmax(np.abs(ref))))


def _rot(rs, n):
    q = rs.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])                                                   # (3, 3, n)


def _operands(rs, k, B, size):
    """p (3, k, B), R (3, 3, k, B), s (3, k, 1) as numpy."""
    p = rs.normal(0, 0.6, (3, k, B))
    R = _rot(rs, k * B).reshape(3, 3, k, B)
    return p, R, np.asarray(size, np.float64).reshape(3, 1, 1).repeat(k, 1)


def _both(jfn, tfn, *args):
    import jax.numpy as jnp

    ref = jfn(*[jnp.asarray(a) for a in args])
    got = tfn(*[torch.tensor(a) for a in args])
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        assert rel_err(g, r) <= TOL64


def test_plane_capsule_matches():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(0)
    k, B = 3, 6
    p1, R1, s1 = _operands(rs, k, B, [40, 40, 40])
    R1[:] = np.eye(3)[:, :, None, None]                  # the floor
    p2, R2, s2 = _operands(rs, k, B, [0.08, 0.28, 0])
    R2[:, :, 0, 0] = np.eye(3)                           # a standing leg
    R2[:, :, 1, 0] = np.diag([1.0, -1.0, -1.0])          # upside down
    ref, got = _both(CV._plane_capsule, tcol._plane_capsule, p1, R1, s1, p2, R2, s2)
    assert np.isnan(ref[3][:, :, 0, 0]).all() and np.isnan(ref[3][:, :, 1, 0]).all()
    _assert_close(got, ref)


def test_closest_on_seg_matches():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(1)
    p, a, b = rs.normal(size=(3, 3, 4, 5))
    b[:, 0, 0] = a[:, 0, 0]                              # a point segment
    ref, got = _both(lambda *x: [CV._closest_on_seg(*x)],
                     lambda *x: [tcol._closest_on_seg(*x)], p, a, b)
    _assert_close(got, ref)


def test_sphere_box_at_matches():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(2)
    k, B = 4, 8
    p2, R2, s2 = _operands(rs, k, B, [0.5, 0.5, 0.3])
    loc = rs.uniform(-1.0, 1.0, (3, k, B))
    loc[:, 0, 0] = 0.0                                   # the box centre
    loc[:, 0, 1] = [0.2, 0.2, 0.0]                       # face-distance tie
    loc[:, 0, 2] = [0.5, 0.1, 0.0]                       # on a face
    c1 = p2 + np.einsum("ijkb,jkb->ikb", R2, loc)
    r1 = rs.uniform(0.05, 0.3, (k, B))
    ref, got = _both(CV._sphere_box_at, tcol._sphere_box_at, c1, r1, p2, R2, s2)
    _assert_close(got, ref)


def test_capsule_box_matches():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(3)
    k, B = 3, 8
    p1, R1, s1 = _operands(rs, k, B, [0.08, 0.28, 0])
    p2, R2, s2 = _operands(rs, k, B, [2, 2, 1])
    # a leg lying parallel to the box's top face, just above it
    R2[:, :, 0, :2] = np.eye(3)[:, :, None]
    R1[:, :, 0, :2] = np.array([[0, 0, 1.0], [0, 1, 0], [-1, 0, 0]])[:, :, None]
    p1[:, 0, :2] = p2[:, 0, :2] + np.array([0.3, -0.2, 1.05])[:, None]
    ref, got = _both(CV._capsule_box, tcol._capsule_box, p1, R1, s1, p2, R2, s2)
    assert ref[0].shape == (3, k, B)
    _assert_close(got, ref)


def test_contact_frame_matches():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(4)
    n = rs.normal(size=(3, 5, 4))
    n /= np.linalg.norm(n, axis=0)
    n[:, 0, 0] = [0.0, 1.0, 0.0]                         # |n_y| >= 0.99
    t = rs.normal(size=(3, 5, 4))
    t[:, :2] = np.nan                                    # no explicit tangent
    t[1, 2, 0] = np.inf
    ref, got = _both(lambda *x: [CV._contact_frame_soa(*x)],
                     lambda *x: [tcol.contact_frame(*x)], n, t)
    _assert_close(got, ref)


def test_local_aabb_half_matches():
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import collision_vec as CV

    m, _ = maze_core.build_ant_maze_model(maps.U_MAZE, dtype=torch.float64,
                                          device="cpu")
    _, ref = CV._local_aabbs(m.meta, jnp.asarray(m.geom_size.numpy()), None,
                             jnp.float64)
    got = tcol._local_aabb_half(m.meta, m.geom_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_box_box_matches():
    """box-box (vertex-face both ways and the edge slot) with boxes pressed
    together at random poses and axis-aligned ones, whose edge axes are
    parallel or fall on a face axis."""
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(5)
    k, B = 3, 8
    p1, R1, s1 = _operands(rs, k, B, [0.3, 0.2, 0.1])
    p2, R2, s2 = _operands(rs, k, B, [0.025, 0.025, 0.025])
    p2[:] = p1 + rs.normal(0, 0.15, p1.shape)
    R1[:, :, 0] = R2[:, :, 0] = np.eye(3)[:, :, None]      # axis-aligned
    p2[:, 0] = p1[:, 0] + np.array([0.05, -0.1, 0.12])[:, None]
    ref, got = _both(CV._box_box, tcol._box_box, p1, R1, s1, p2, R2, s2)
    assert ref[0].shape == (9, k, B)
    assert (ref[0] < 0).any() and (ref[0] > BIG).any()
    _assert_close(got, ref)


def test_plane_box_and_hull_match():
    from gymnasium_robotics_tpu.physics import collision_vec as CV

    rs = np.random.RandomState(6)
    k, B = 2, 6
    p1, R1, s1 = _operands(rs, k, B, [1, 1, 1])
    R1[:] = np.eye(3)[:, :, None, None]
    p2, R2, s2 = _operands(rs, k, B, [0.03, 0.05, 0.02])
    p2[2] = rs.uniform(-0.02, 0.06, (k, B))
    ref, got = _both(CV._plane_box, tcol._plane_box, p1, R1, s1, p2, R2, s2)
    _assert_close(got, ref)
    hv = rs.normal(0, 0.05, (24, 3, k, 1))
    hv[20:] = hv[:4]                                      # padding rows
    ref, got = _both(lambda *x: CV._make_plane_hull(x[0])(*x[1:]),
                     lambda *x: tcol._make_plane_hull(x[0])(*x[1:]),
                     hv, p1, R1, s1, p2, R2, s2)
    assert (ref[0] < 0).any()
    _assert_close(got, ref)


# compact rows each kernel item writes, from its pair's first row: per
# kind, per part (csrc/narrowphase.cu)
_ITEM_ROWS = {0: [[0]], 1: [[0, 1]], 2: [[0]], 3: [[0], [1], [2]],
              4: [[0, 1, 2, 3]], 5: [[0, 1, 2, 3], [4, 5, 6, 7], [8]],
              6: [[0, 1, 2, 3]], 7: [[0, 1]], 8: [[0], [1], [2]],
              9: [[0], [1]], 10: [[0]], 11: [[0]], 12: [[0]], 13: [[0]],
              14: [[0], [1]]}


def _rows_written(table):
    """Every compact row the kernel's task table writes, once per write."""
    pairs = table.pairs.numpy()
    out = []
    for task in table.tasks.numpy():
        coop = task[0] >= tnp.NP_COOP
        items = [task[0] - tnp.NP_COOP] if coop else [i for i in task if i >= 0]
        if coop:
            assert (task == task[0]).all()
        else:
            assert all(i < tnp.NP_COOP for i in task)
        for it in items:
            c, part = it >> 3, it & 7
            out += [pairs[1, c] + r for r in _ITEM_ROWS[pairs[0, c]][part]]
    return out


@pytest.mark.parametrize("id_", ["AntMaze_UMaze-v5", "AntMaze_Large-v5",
                                 "FetchPush-v4", "FetchPickAndPlace-v4",
                                 "FetchReach-v4", "FetchSlide-v4",
                                 "AdroitHandDoor-v1", "AdroitHandHammer-v1",
                                 "AdroitHandPen-v1", "AdroitHandRelocate-v1",
                                 "FrankaKitchen-v1"])
def test_group_table_tasks_write_each_row_once(id_):
    """The kernel's task table writes every compact row of its groups
    exactly once (for the whole table and cut to each kind), each
    cooperative item is a task of its own and only plane-box's, box-box's
    and cylinder-cylinder's are, the longest tasks come first; the launch
    takes the primitive-only instantiation where the table has no box,
    hull or sphere-capsule-cylinder kinds (Adroit's whole table is inside
    the kernel)."""
    from gymnasium_robotics_tpu_torch import registry

    m = registry.make(id_, num_envs=1, device="cpu").env.model
    tp = m.plan("pruned", tcol._PrunedPlan)
    table = tp.table
    assert table.boxes == id_.startswith(("Fetch", "Adroit", "Franka"))   # the instantiation
    if id_.startswith("Adroit"):    # no group runs outside the kernel
        assert not tp.runs and sorted(table.rows.tolist()) == list(range(table.ncon))
    geo = tnp.narrowphase_geometry(table, 2047)
    assert geo["grid"] == (64, table.tasks.shape[0]) and geo["threads"] == 128
    for tab in [table] + [table.only([g.kind]) for g in table.groups]:
        written = _rows_written(tab)
        assert sorted(written) == sorted(tab.rows.tolist())
        assert len(set(written)) == len(written)
    cost = []
    for task in table.tasks.tolist():
        it = task[0] % tnp.NP_COOP
        kind = table.pairs[0, it >> 3].item()
        cost.append(tnp.ITEMS[kind][it & 7])
        assert (task[0] >= tnp.NP_COOP) == (kind in tnp.COOP_KINDS)
    assert cost == sorted(cost, reverse=True)
