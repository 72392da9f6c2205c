"""The pruned narrowphase of the port (gymnasium_robotics_tpu_torch.physics
.narrowphase and the primitive formulas of physics.collision) against the
JAX functions they replace.

- topk_select_plain vs the Pallas narrowphase_pallas.topk_select in
  interpret mode, at the AntMaze shapes (2, 216, B) -> K = 8 and
  (1, 57, B) -> K = 16 and the FetchPush shapes (3, 85, B) -> 8 and
  (2, 169, B) -> 24: indices equal exactly, on ranks with forced ties,
  masks, +-inf, lanes with fewer finite ranks than K, and NaN lanes.
- narrowphase_plain vs the Pallas narrowphase_megakernel in interpret mode
  on the same selected operands in float32 (2e-4, frames with equal_nan),
  for the AntMaze groups and FetchPush's plane-hull, plane-box and box-box
  (distances on their own scale: a slot far from touching carries 1e10).
- the pruned core on a NaN lane: the narrowphase clamps maxk picks itself,
  and the slot ids fall back to each group's last pair.

- topk_select_kernel's launch geometry (topk_geometry) at every shape the
  ported IDs call it with: the grid covers B, shared memory fits a block.

The pair formulas and the task tables are held in
tests/test_torch_narrowphase_formulas.py.

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card at B = 2048 (indices exactly, the table within 2e-4), and
topk_select at the edges of its shapes; they skip where no card is
present. The JAX imports sit inside the tests so that the
``cuda`` tests also run where JAX is missing."""

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch import kernels
from gymnasium_robotics_tpu_torch.envs.maze import maps, maze_core
from gymnasium_robotics_tpu_torch.physics import collision as tcol
from gymnasium_robotics_tpu_torch.physics import constraint as tcst
from gymnasium_robotics_tpu_torch.physics import narrowphase as tnp
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm

TOL32 = 2e-4
SHAPES = [((2, 216), 8), ((1, 57), 16), ((3, 85), 8), ((2, 169), 24)]
BIG = 1e9


def tie_ranks(rs, G, maxk, B):
    """Ranks on a coarse grid (many ties), with -inf and +inf entries, a
    mask that cuts group 0 short, and a lane with fewer finite ranks than
    any K."""
    rank = rs.randint(-4, 5, (G, maxk, B)).astype(np.float32) * 0.5
    rank[rs.uniform(size=rank.shape) < 0.03] = -np.inf
    rank[rs.uniform(size=rank.shape) < 0.05] = np.inf
    rank[:, 5:, min(1, B - 1)] = np.inf             # 5 finite ranks at most
    mask = np.ones((G, maxk), bool)
    mask[0, maxk // 3:] = False
    return rank, mask


def pallas_topk(rank, mask, K):
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import narrowphase_pallas as NPK

    return np.asarray(NPK.topk_select(jnp.asarray(rank), mask, K,
                                      interpret=True))


@pytest.mark.parametrize("shape,K", SHAPES)
def test_topk_select_plain_matches_pallas(shape, K):
    rs = np.random.RandomState(K)
    rank, mask = tie_ranks(rs, *shape, 8)
    ref = pallas_topk(rank, mask, K)
    got = tnp.topk_select_plain(torch.tensor(rank), torch.tensor(mask), K)
    assert got.dtype == torch.int32 and got.shape == (shape[0], K, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tnp.topk_select(torch.tensor(rank), torch.tensor(mask), K).numpy(), ref)
    assert (ref[:, 5:, 1] == 0).all()       # exhausted lane: index 0 again


def test_topk_select_nan_lane():
    """Pinned NaN behaviour (the Pallas kernel's): a lane with an unmasked
    NaN rank gives maxk in every round; a masked NaN is ignored. The
    pruned narrowphase clamps maxk to the group's last pair."""
    rs = np.random.RandomState(1)
    G, maxk, B, K = 2, 216, 4, 8
    rank = rs.normal(size=(G, maxk, B)).astype(np.float32)
    mask = np.ones((G, maxk), bool)
    mask[0, 18:] = False
    rank[1, 100, 0] = np.nan                 # unmasked: lane 0 of group 1
    rank[0, 50, 2] = np.nan                  # masked: ignored
    ref = pallas_topk(rank, mask, K)
    got = tnp.topk_select_plain(torch.tensor(rank), torch.tensor(mask), K).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[1, :, 0] == maxk).all() and (got[0, :, 0] < 18).all()
    assert (got[0, :, 2] < 18).all()


def _ported_topk_shapes():
    """{(G, maxk, K)} of every topk_select call the ported IDs make (the
    pair-topk broadphase and the contact cap), from each model's plans."""
    from gymnasium_robotics_tpu_torch import registry

    shapes = set()
    for id_ in registry.ids():
        m = registry.make(id_, num_envs=1, device="cpu").env.model
        if tcol.prune_active(m.meta):
            tp = m.plan("pruned", tcol._PrunedPlan)
            shapes.add((*tp.mask.shape, tp.K))
        rp = m.plan("rows", tcst._RowPlan)
        if rp.cap_rows is not None:
            shapes.add((*rp.cap_mask.shape, rp.cap))
    return shapes


def test_topk_geometry_covers_ported_shapes():
    """The 60 AntMaze IDs (four maze sizes), the 16 Fetch IDs, the 52
    HandManipulateBlock and 4 HandReach IDs, the 16 Adroit IDs and
    FrankaKitchen-v1 call topk_select at twenty-one shapes; at each, and at
    B from 1 up, the kernel's grid covers every env and its shared memory
    fits a block."""
    shapes = _ported_topk_shapes()
    assert shapes == {(2, 216, 8), (2, 240, 8), (2, 456, 8), (2, 744, 8),
                      (1, 57, 16), (3, 85, 8), (2, 169, 24), (2, 160, 16),
                      (4, 85, 8), (2, 177, 24), (2, 156, 24),
                      (6, 64, 16), (2, 300, 16), (5, 45, 16), (2, 247, 16),
                      (2, 33, 24), (2, 170, 16), (2, 33, 16), (2, 146, 16),
                      (20, 1126, 8), (3, 272, 8)}
    for G, maxk, K in shapes:
        for B in (1, 31, 32, 2047, 2048, 8192):
            geo = tnp.topk_geometry(G, maxk, B, K)
            nx, gy = geo["grid"]
            assert gy == G and (nx - 1) * geo["tile"] < B <= nx * geo["tile"]
            assert K <= geo["kcap"] <= tnp.TOPK_MAX_K
            assert geo["threads"] == 32 * tnp.TOPK_WARPS
            ring = 2 * min(maxk, tnp.TOPK_CHUNK) * geo["tile"] * 4
            lists = tnp.TOPK_WARPS * geo["kcap"] * geo["tile"] * 8
            assert max(ring, lists) < geo["smem"] <= kernels.SMEM_MAX
    with pytest.raises(NotImplementedError, match="K <= 24"):
        tnp.topk_geometry(1, 57, 8, 25)


def ant_inputs(B, seed, dtype=torch.float32, device="cpu"):
    """(model, Data after kinematics) of AntMaze ants pressed into the top
    left cell's walls and the floor."""
    m, _ = maze_core.build_ant_maze_model(maps.U_MAZE, dtype=dtype,
                                          device=device)
    m = m.with_options(pair_topk=8, contact_cap=16)
    rs = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy()[:, 0], (B, 1))
    u = rs.uniform(0.5, 1.0, B)
    along = rs.uniform(-5.0, -3.0, B)
    top = np.arange(B) % 2 == 0
    qpos[:, 0] = np.where(top, along, -6.0 + u)
    qpos[:, 1] = np.where(top, 6.0 - u, along + 8.0)
    qpos[:, 2] = rs.uniform(0.25, 0.55, B)
    lo, hi = m.jnt_range.cpu().numpy()[1:, :, 0].T
    qpos[:, 7:] = rs.uniform(lo, hi, (B, len(lo)))
    d = tpipe.make_data(m, B)
    d.qpos[:] = torch.as_tensor(qpos.T, dtype=dtype, device=device)
    return m, tsm.kinematics(m, d)


def _jax_megakernel(table, plan, P, Rm, sizes, sel):
    """The Pallas megakernel in interpret mode on operands gathered as
    collision_vec's take_static / take_sel gather them."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import narrowphase_pallas as NPK

    B = P.shape[-1]
    lane = np.arange(B)
    specs, arrays = [], []
    for g, grp in zip(plan.groups, table.groups):
        ops = []
        for gl in (grp.g1.numpy(), grp.g2.numpy()):
            if grp.sel_group < 0:
                ops += [P[gl].transpose(1, 0, 2),
                        np.moveaxis(Rm[gl], 0, 2), sizes[gl].transpose(1, 0, 2)]
            else:
                gid = gl[sel[grp.sel_group]]                 # (K, B)
                ops += [P[gid, :, lane].transpose(2, 0, 1),
                        Rm[gid, :, :, lane].transpose(2, 3, 0, 1),
                        sizes[gid, :, 0].transpose(2, 0, 1)]
        specs.append(NPK.GroupSpec(t1=g.tp[0], t2=g.tp[1], S=g.S, k=g.K,
                                   row_off=g.base_c, n_arrays=6, use_mpr=False))
        arrays += [jnp.asarray(a) for a in ops]
    out = NPK.narrowphase_megakernel(tuple(specs), arrays, plan.ncon_c, B,
                                     jnp.float32, interpret=True)
    return [np.asarray(o) for o in out]


def test_narrowphase_plain_matches_megakernel():
    B = 8
    m, d = ant_inputs(B, seed=0)
    tp = m.plan("pruned", tcol._PrunedPlan)
    rs = np.random.RandomState(0)
    sel = np.stack([rs.randint(0, len(g.g1), (tp.K, B))
                    for g in tp.table.groups if g.sel_group >= 0])
    args = (d.geom_xpos, d.geom_xmat, m.geom_size)
    got = tnp.narrowphase_plain(tp.table, *args, torch.as_tensor(sel))
    ref = _jax_megakernel(tp.table, tcol.prune_plan(m.meta),
                          *[a.numpy() for a in args], sel)
    for g, r, name in zip(got, ref, ("dist", "pos", "frame")):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL32 * max(
            1.0, np.nanmax(np.abs(r))), equal_nan=True, err_msg=name)
    assert (got[0] < 0).any()                           # some legs touch


def test_narrowphase_clamps_out_of_range_picks():
    """The pruned core hands the narrowphase topk_select's raw picks: a NaN
    lane's maxk must give the same table as the pick clamped to its
    group's last pair."""
    B = 4
    m, d = ant_inputs(B, seed=3)
    tp = m.plan("pruned", tcol._PrunedPlan)
    sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
    sel[:, :, 0] = tp.mask.shape[1]                     # maxk on lane 0
    args = (tp.table, d.geom_xpos, d.geom_xmat, m.geom_size)
    got = tnp.narrowphase(*args, sel)
    ref = tnp.narrowphase(*args, torch.minimum(sel, tp.sel_max))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


def test_pruned_core_nan_lane_slot_ids():
    """A lane whose poses are NaN ranks NaN everywhere, so topk_select
    gives maxk; the pruned core clamps it to each group's last pair, and
    the slot and geom ids stay in range."""
    B = 4
    m, d = ant_inputs(B, seed=3)
    d.geom_xpos[:, :, 1] = float("nan")
    tp = m.plan("pruned", tcol._PrunedPlan)
    c = tcol._collision_pruned(m, d)
    g1s, _ = tcol.slot_geoms(m)
    assert c.src.dtype == torch.int64
    assert bool(((c.src >= 0) & (c.src < len(g1s))).all())
    for base, n, ids, _ in tp.src_sel:
        assert torch.equal(c.src[base:base + n, 1], ids[-1].repeat(n // ids.shape[1]))
    assert torch.equal(c.geom1, g1s[c.src])


def fetch_inputs(B, dtype=torch.float32, device="cpu"):
    """(model, Data after kinematics) of Fetch arms pressed into things,
    five poses in turn: the object on the table 4 mm into the fingers'
    front, the arm 0.1 into the table, the object between the fingers, the
    wrist folded into the forearm, the robot on the floor."""
    from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchPushEnv

    env = FetchPushEnv(dtype=dtype, device=device)
    m, oq = env.model, env._obj_qadr
    qpos = np.tile(env._init_qpos.cpu().numpy(), (B, 1))
    for i in range(B):
        pose = i % 5
        if pose == 0:
            qpos[i, oq:oq + 3] = [1.4215, 0.7486, 0.4244]
        elif pose == 1:
            qpos[i, 2] -= 0.1
        elif pose == 2:
            qpos[i, oq:oq + 3] = [1.362, 0.7486, 0.47]
        elif pose == 3:
            qpos[i, 6:13] += [0.235, 0.835, -0.117, 0.7, 0.029, 0.204, 0.426]
        else:
            qpos[i, 1:3] += [0.45, -0.422]
            qpos[i, oq:oq + 3] = [0.9, 1.3, 0.02]
    d = tpipe.make_data(m, B)
    d.qpos[:] = torch.as_tensor(qpos.T, dtype=dtype, device=device)
    return m, tsm.kinematics(m, d)


def assert_table_close(got, ref, rows, tol):
    """The kernel rows of two contact tables: distances on their own scale
    (a slot far from touching must be so in both), positions and frames on
    their largest entry, NaN-equal."""
    for name, g, r in zip(("dist", "pos", "frame"), got, ref):
        g, r = np.asarray(g)[rows], np.asarray(r)[rows]
        if name == "dist":
            far = r >= BIG
            np.testing.assert_array_equal(g >= BIG, far)
            g, r = g[~far], r[~far]
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * max(
            1.0, np.nanmax(np.abs(r))), equal_nan=True, err_msg=name)


def test_narrowphase_plain_matches_megakernel_fetch():
    """FetchPush's kernel groups (plane-hull, plane-box twice, box-box
    twice) against the Pallas megakernel in interpret mode, the groups'
    rows laid end to end."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import narrowphase_pallas as NPK

    B = 5
    m, d = fetch_inputs(B)
    tp = m.plan("pruned", tcol._PrunedPlan)
    table = tp.table
    P, Rm, sizes = (x.numpy() for x in (d.geom_xpos, d.geom_xmat, m.geom_size))
    hull_vert, hull_face = m.hull_vert.numpy(), m.hull_face.numpy()
    specs, arrays, row = [], [], 0
    for g in table.groups:
        t1, t2 = tnp.KINDS[g.kind]
        ops = []
        for gl in (g.g1.numpy(), g.g2.numpy()):
            ops += [P[gl].transpose(1, 0, 2), np.moveaxis(Rm[gl], 0, 2),
                    sizes[gl].transpose(1, 0, 2)]
        if g.hull2 is not None:
            h = g.hull2.numpy()
            ops += [hull_face[h][..., :3].transpose(1, 2, 0)[..., None],
                    hull_face[h][..., 3].T[..., None],
                    hull_vert[h].transpose(1, 2, 0)[..., None]]
        specs.append(NPK.GroupSpec(t1=t1, t2=t2, S=g.S, k=g.k, row_off=row,
                                   n_arrays=len(ops), use_mpr=False))
        arrays += [jnp.asarray(a) for a in ops]
        row += g.k * g.S
    ref = NPK.narrowphase_megakernel(tuple(specs), arrays, row, B, jnp.float32,
                                     interpret=True)
    sel = torch.zeros((3, tp.K, B), dtype=torch.int32)
    got = tnp.narrowphase_plain(table, d.geom_xpos, d.geom_xmat, m.geom_size,
                                sel, m.hull_vert)
    rows = table.rows.numpy()
    assert len(rows) == row == 117
    assert_table_close([g.numpy() for g in got],
                       [_spread(np.asarray(o), rows, tp.ncon) for o in ref],
                       rows, TOL32)
    for g in table.groups:                             # every kind touches
        assert (got[0][g.row_off:g.row_off + g.k * g.S] < 0).any(), g.kind


def _spread(x, rows, n):
    """Rows laid end to end -> a table of n rows with them at ``rows``."""
    out = np.full((n,) + x.shape[1:], np.nan, x.dtype)
    out[rows] = x
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    B = 2048
    rs = np.random.RandomState(0)
    for shape, K in SHAPES:
        rank, mask = tie_ranks(rs, *shape, B)
        r, mk = (torch.tensor(x, device=cuda_device) for x in (rank, mask))
        n0 = tnp.LAUNCHES["topk"]
        got = tnp.topk_select(r, mk, K)
        torch.cuda.synchronize()
        assert tnp.LAUNCHES["topk"] == n0 + 1
        assert torch.equal(got.cpu(), tnp.topk_select_plain(r, mk, K).cpu())

    m, d = ant_inputs(B, seed=1, device=cuda_device)
    tp = m.plan("pruned", tcol._PrunedPlan)
    sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
    sel = torch.minimum(sel, tp.sel_max)
    args = (tp.table, d.geom_xpos, d.geom_xmat, m.geom_size, sel)
    got = tnp.narrowphase(*args)
    torch.cuda.synchronize()
    ref = tnp.narrowphase_plain(*args)
    for g, r in zip(got, ref):
        r = r.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), r, rtol=0, atol=TOL32 * max(
            1.0, np.nanmax(np.abs(r))), equal_nan=True)
    assert bool((got[0][33:] < 0).any())           # capsule-box rows touch


@pytest.mark.cuda
def test_topk_edges_on_card(cuda_device):
    """topk_select_kernel at the edges of its shapes, indices equal to the
    plain version's: tied and +-inf ranks at (2, 744) -> 8 (AntMaze_Large's
    broadphase) and at B = 1 and 2047; K larger than the unmasked count; an
    all-masked group and a NaN lane; a rank view that is not 16-byte
    aligned. The wrapper's shared memory is the source's."""
    rs = np.random.RandomState(5)
    cases = [tie_ranks(rs, 2, 744, 2048) + (8,), tie_ranks(rs, 2, 169, 1) + (24,),
             tie_ranks(rs, 1, 57, 2047) + (16,), tie_ranks(rs, 2, 216, 2047) + (8,)]
    rank, mask = tie_ranks(rs, 2, 40, 64)
    mask[:, 5:] = False
    cases.append((rank, mask, 16))
    rank = rs.normal(size=(3, 85, 96)).astype(np.float32)
    mask = np.ones((3, 85), bool)
    mask[1] = False                           # an all-masked group
    rank[2, 40, 3] = np.nan                   # an unmasked NaN
    rank[0, 7, 5] = np.nan
    mask[0, 7] = False                        # a masked NaN
    cases.append((rank, mask, 8))
    for rank, mask, K in cases:
        r, mk = (torch.tensor(x, device=cuda_device) for x in (rank, mask))
        n0 = tnp.LAUNCHES["topk"]
        got = tnp.topk_select(r, mk, K)
        torch.cuda.synchronize()
        assert tnp.LAUNCHES["topk"] == n0 + 1
        assert torch.equal(got, tnp.topk_select_plain(r, mk, K)), rank.shape
    # the last case: the NaN lane gives maxk, the all-masked group 0
    assert bool((got[2, :, 3] == 85).all()) and bool((got[1] == 0).all())
    flat = torch.tensor(np.concatenate([[0.0], cases[0][0].ravel()]),
                        dtype=torch.float32, device=cuda_device)
    r = flat[1:].view(cases[0][0].shape)      # 4 bytes past an aligned start
    mk = torch.tensor(cases[0][1], device=cuda_device)
    assert torch.equal(tnp.topk_select(r, mk, 8), tnp.topk_select_plain(r, mk, 8))
    lib = tnp._lib()
    for maxk, K in ((216, 8), (57, 16), (169, 24), (744, 8)):
        geo = tnp.topk_geometry(1, maxk, 2048, K)
        assert lib.grt_topk_smem_bytes(maxk, geo["kcap"]) == geo["smem"]


@pytest.mark.cuda
def test_narrowphase_edges_on_card(cuda_device):
    """narrowphase_kernel against its plain version on pressed AntMaze and
    FetchPush states at B = 2048: at B = 1 and B = 2047 (the first envs),
    each kind alone (also bitwise equal to the whole table's rows), picks
    out of range (clamped) and int64 picks."""
    B = 2048
    for m, d in (ant_inputs(B, seed=2, device=cuda_device),
                 fetch_inputs(B, device=cuda_device)):
        hv = m.hull_vert
        tp = m.plan("pruned", tcol._PrunedPlan)
        table = tp.table
        sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
        whole = tnp.narrowphase(table, d.geom_xpos, d.geom_xmat, m.geom_size,
                                sel, hv)
        rs = np.random.RandomState(3)
        wild = torch.tensor(rs.randint(-3, tp.mask.shape[1] + 3, tuple(sel.shape)),
                            dtype=torch.int32, device=cuda_device)
        cases = [(table, d.geom_xpos[..., :n], d.geom_xmat[..., :n], sel[..., :n])
                 for n in (1, 2047)]
        cases += [(table.only([g.kind]), d.geom_xpos, d.geom_xmat, sel)
                  for g in table.groups]
        cases += [(table, d.geom_xpos, d.geom_xmat, wild),
                  (table, d.geom_xpos, d.geom_xmat, sel.long())]
        for i, (tab, P, R, sl) in enumerate(cases):
            n0 = tnp.LAUNCHES["narrowphase"]
            args = (tab, P, R, m.geom_size, sl, hv)
            got = tnp.narrowphase(*args)
            torch.cuda.synchronize()
            assert tnp.LAUNCHES["narrowphase"] == n0 + 1
            rows = tab.rows.cpu().numpy()
            assert_table_close([g.cpu().numpy() for g in got],
                               [r.cpu().numpy() for r in tnp.narrowphase_plain(*args)],
                               rows, TOL32)
            if tab is not table:
                for g, w in zip(got, whole):
                    assert torch.equal(g[tab.rows].view(torch.int32),
                                       w[tab.rows].view(torch.int32)), i


@pytest.mark.cuda
def test_capsule_hull_on_card(cuda_device):
    """The kitchen at B = 512 with the arm turned into the scene: its two
    topk_select shapes, indices equal to the plain version's; capsule-hull
    (kind 14) alone within 2e-4 of its plain version and bitwise the whole
    table's rows, some of them penetrating."""
    from gymnasium_robotics_tpu_torch import registry
    from gymnasium_robotics_tpu_torch.physics import pipeline

    B = 512
    env = registry.make("FrankaKitchen-v1", device=cuda_device)
    m = env.model
    rs = np.random.RandomState(15)
    q = np.tile(env._init_qpos.cpu().numpy(), (B, 1))
    q[:, :7] += rs.uniform(-1.2, 1.2, (B, 7))
    d = pipeline.make_data(m, B)
    d.qpos[:] = torch.tensor(q.T, dtype=torch.float32, device=cuda_device)
    d = pipeline.forward(m, d)
    tp = m.plan("pruned", tcol._PrunedPlan)
    rp = m.plan("rows", tcst._RowPlan)
    pen = d.contact.dist - m.con_includemargin[:, 0][d.contact.src]
    for rank, mask, K in ((tcol.broadphase_rank(m, d, tp), tp.mask, tp.K),
                          (pen[rp.cap_rows], rp.cap_mask, rp.cap)):
        assert torch.equal(tnp.topk_select(rank, mask, K),
                           tnp.topk_select_plain(rank, mask, K)), rank.shape
    sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
    args = (d.geom_xpos, d.geom_xmat, m.geom_size, sel, m.hull_vert, m.hull_face)
    whole = tnp.narrowphase(tp.table, *args)
    sub = tp.table.only([14])
    n0 = tnp.LAUNCHES["narrowphase"]
    got = tnp.narrowphase(sub, *args)
    torch.cuda.synchronize()
    assert tnp.LAUNCHES["narrowphase"] == n0 + 1
    rows = sub.rows.cpu().numpy()
    assert_table_close([g.cpu().numpy() for g in got],
                       [r.cpu().numpy() for r in tnp.narrowphase_plain(sub, *args)],
                       rows, TOL32)
    for g, w in zip(got, whole):
        assert torch.equal(g[sub.rows].view(torch.int32), w[sub.rows].view(torch.int32))
    assert bool((got[0][sub.rows] < 0).any())


@pytest.mark.cuda
def test_kernels_match_plain_on_card_fetch(cuda_device):
    """FetchPush's kernel groups at B = 2048 on arms pressed into things:
    every kernel row of the table (distances on their own scale, frames
    NaN-equal), and topk_select at K = 24 on the contact-cap ranks."""
    B = 2048
    m, d = fetch_inputs(B, device=cuda_device)
    tp = m.plan("pruned", tcol._PrunedPlan)
    sel = torch.minimum(tnp.topk_select(tcol.broadphase_rank(m, d, tp),
                                        tp.mask, tp.K), tp.sel_max)
    args = (tp.table, d.geom_xpos, d.geom_xmat, m.geom_size, sel, m.hull_vert)
    n0 = tnp.LAUNCHES["narrowphase"]
    got = tnp.narrowphase(*args)
    torch.cuda.synchronize()
    assert tnp.LAUNCHES["narrowphase"] == n0 + 1
    ref = tnp.narrowphase_plain(*args)
    rows = tp.table.rows.cpu().numpy()
    assert_table_close([g.cpu().numpy() for g in got],
                       [r.cpu().numpy() for r in ref], rows, TOL32)
    for g in tp.table.groups:
        assert bool((ref[0][g.row_off:g.row_off + g.k * g.S] < 0).any()), g.kind
    c = tcol.collision(m, d).contact
    rp = m.plan("rows", tcst._RowPlan)
    pen = (c.dist - m.con_includemargin[:, 0][c.src])[rp.cap_rows]
    assert torch.equal(tnp.topk_select(pen, rp.cap_mask, 24),
                       tnp.topk_select_plain(pen, rp.cap_mask, 24))


def slide_inputs(B, device="cpu"):
    """FetchSlide's model and a forwarded batch of B envs cycling through
    four puck poses, jittered by up to 2 mm: upright under the gripper
    link, 4 mm into it; tipped 0.3 rad onto the floor; upright on the floor
    (its axis along the plane's normal: the fallback rim point, a NaN
    tangent); tipped 1.2 rad against the fingers and the link."""
    from gymnasium_robotics_tpu_torch.envs.fetch.fetch import FetchSlideEnv

    env = FetchSlideEnv(dtype=torch.float32, device=device)
    m, oq = env.model, env._obj_qadr
    rs = np.random.RandomState(4)
    qpos = np.tile(env._init_qpos.cpu().numpy(), (B, 1))
    poses = [[1.06, 0.7497, 0.4445, 1.0, 0.0, 0.0, 0.0],
             [1.7, 1.4, 0.026, np.cos(0.15), np.sin(0.15), 0.0, 0.0],
             [1.7, 1.4, 0.0195, 1.0, 0.0, 0.0, 0.0],
             [1.05, 0.7497, 0.455, np.cos(0.6), 0.0, np.sin(0.6), 0.0]]
    for i in range(B):
        qpos[i, oq:oq + 7] = poses[i % 4]
        qpos[i, oq:oq + 2] += rs.uniform(-0.002, 0.002, 2) * (i >= 4)
    d = tpipe.make_data(m, B)
    d.qpos[:] = torch.tensor(qpos.T, dtype=torch.float32, device=device)
    return m, tpipe.forward(m, d)


@pytest.mark.cuda
def test_kernels_match_plain_on_card_slide(cuda_device):
    """FetchSlide's kernel groups at B = 2048 (plane-cylinder, cylinder-box
    and the pruned cylinder-hull group beside FetchPush's kinds): every
    kernel row against the plain version (distances on their own scale,
    frames NaN-equal), each new kind alone bitwise equal to the whole
    table's rows; the envs' cylinder-hull picks differ; a table without the
    face table raises."""
    B = 2048
    m, d = slide_inputs(B, device=cuda_device)
    tp = m.plan("pruned", tcol._PrunedPlan)
    table = tp.table
    sel = tnp.topk_select(tcol.broadphase_rank(m, d, tp), tp.mask, tp.K)
    args = (table, d.geom_xpos, d.geom_xmat, m.geom_size, sel, m.hull_vert,
            m.hull_face)
    whole = tnp.narrowphase(*args)
    torch.cuda.synchronize()
    rows = table.rows.cpu().numpy()
    ref = tnp.narrowphase_plain(*args)
    assert_table_close([g.cpu().numpy() for g in whole],
                       [r.cpu().numpy() for r in ref], rows, TOL32)
    for kind in (7, 8, 9):
        tab = table.only([kind])
        got = tnp.narrowphase(tab, *args[1:])
        for g, w in zip(got, whole):
            assert torch.equal(g[tab.rows].view(torch.int32),
                               w[tab.rows].view(torch.int32)), kind
        g = next(g for g in table.groups if g.kind == kind)
        assert bool((ref[0][g.row_off:g.row_off + g.k * g.S] < 0).any()), kind
    hull = next(g for g in table.groups if g.kind == 9)
    picks = hull.g2[torch.clamp(sel[hull.sel_group].long(), 0, len(hull.g2) - 1)]
    assert int((picks[0] != picks[0, :1]).sum()) > 0   # hulls differ by env
    with pytest.raises(ValueError, match="face table"):
        tnp.narrowphase(*args[:6])
