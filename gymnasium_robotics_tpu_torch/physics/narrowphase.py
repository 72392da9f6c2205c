"""The pruned narrowphase's two kernels (csrc/narrowphase.cu), their
wrappers, and beside each its plain PyTorch version.

Port of gymnasium_robotics_tpu/physics/narrowphase_pallas.py:
``topk_select`` replaces the TPU kernel ``topk_select`` :155-198 (K rounds
of masked min + first-index argmin) and ``narrowphase`` replaces
``narrowphase_megakernel`` :201-287 (every group's contact formula in one
dispatch, ``GroupSpec``/``_emit_group`` :64-152) for the groups the port
has (plane-sphere, plane-capsule, plane-box, plane-cylinder, sphere-box,
sphere-capsule, capsule-box, capsule-capsule, capsule-cylinder,
cylinder-box, cylinder-cylinder, box-box, plane-hull, cylinder-hull and
capsule-hull).
Where
the TPU kernel took operand blocks gathered by XLA, this kernel reads the
selected geom ids and gathers geom_xpos/geom_xmat/geom_size and the hull
vertex and face tables itself; its work is cut into warp items finer than
a pair (GroupTable.tasks). The
box-hull and hull-hull groups run with MPR outside the kernel, as they do
outside the TPU kernel (collision._run_hull_groups).

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from gymnasium_robotics_tpu_torch import kernels
from gymnasium_robotics_tpu_torch.physics import collision as COL
from gymnasium_robotics_tpu_torch.physics import types as T

LAUNCHES = {"topk": 0, "narrowphase": 0}
# topk_select launches by shape (G, maxk, K), counted beside LAUNCHES["topk"]
TOPK_SHAPES = collections.Counter()
TOPK_MAX_K = 24          # largest K csrc/narrowphase.cu instantiates
# topk_select_kernel's launch geometry (csrc/narrowphase.cu): a block takes
# one group and TOPK_TILE envs with TOPK_WARPS warps over the rows, which
# stream through two stages of TOPK_CHUNK rows in shared memory
TOPK_TILE, TOPK_WARPS, TOPK_CHUNK = 32, 8, 128
# group kinds, in the order csrc/narrowphase.cu numbers them
KINDS = ((T.PLANE, T.SPHERE), (T.PLANE, T.CAPSULE), (T.SPHERE, T.BOX),
         (T.CAPSULE, T.BOX), (T.PLANE, T.BOX), (T.BOX, T.BOX),
         (T.PLANE, T.MESH), (T.PLANE, T.CYLINDER), (T.CYLINDER, T.BOX),
         (T.CYLINDER, T.MESH), (T.CAPSULE, T.CAPSULE),
         (T.CAPSULE, T.CYLINDER), (T.CYLINDER, T.CYLINDER),
         (T.SPHERE, T.CAPSULE), (T.CAPSULE, T.MESH))
# narrowphase_kernel's work items: a block takes 32 envs and one task of
# NP_WARPS warp items. Per kind, a rough count of the longest warp's
# instructions for each of its items a pair (capsule-box and cylinder-box:
# a sphere each; box-box: box 2's corners in box 1, box 1's in box 2, the
# edge slot; cylinder-hull and capsule-hull: an end sphere's probe each;
# capsule-cylinder: its 24-round search, 48 point-cylinder distances;
# cylinder-cylinder: two such searches, one a warp), used only to put the
# longest tasks first.
# The kinds of COOP_KINDS run each item on all the block's warps (a
# cooperative task), the others four items to a task, one a warp
# (tools/narrowphase_kinds.py times the kinds).
NP_WARPS, NP_ENVS = 4, 32
NP_COOP = 1 << 28     # csrc/narrowphase.cu's kCoop
BOX_KINDS = 4         # kinds from here on: narrowphase_kernel<true> only
COOP_KINDS = (4, 5, 12)   # plane-box, box-box, cylinder-cylinder
ITEMS = {0: (60,), 1: (150,), 2: (200,), 3: (200, 200, 200), 4: (260,),
         5: (370, 370, 830), 6: (1000,), 7: (180,), 8: (200, 200, 200),
         9: (500, 500), 10: (250,), 11: (2600,), 12: (2600,), 13: (150,),
         14: (500, 500)}


# ---------------------------------------------------------------------------
# topk_select
# ---------------------------------------------------------------------------


def topk_select_plain(rank, mask, K: int):
    """Indices of the K smallest ranks per (group, env): rank (G, maxk, B),
    mask (G, maxk) bool -> (G, K, B) int32, as K rounds of masked min and
    first-index argmin (narrowphase_pallas.topk_select), masked entries
    counting as +inf. So the order is ascending rank, first index first on
    ties; once every finite rank is taken the remaining rounds give index 0
    (the first +inf entry); a lane with a NaN rank gives maxk in every
    round."""
    G, maxk, B = rank.shape
    inf = torch.full((), float("inf"), dtype=rank.dtype, device=rank.device)
    d = torch.where(mask[:, :, None], rank, inf)
    iota = torch.arange(maxk, device=rank.device)[None, :, None]
    out = []
    for _ in range(K):
        m = torch.amin(d, dim=1, keepdim=True)
        idx = torch.amin(torch.where(d == m, iota, maxk), dim=1)   # (G, B)
        out.append(idx)
        d = torch.where(iota == idx[:, None], inf, d)
    return torch.stack(out, dim=1).to(torch.int32)


def topk_geometry(G: int, maxk: int, B: int, K: int) -> dict:
    """Launch geometry of topk_select_kernel: its list length (the
    instantiation, KCAP), grid (env tiles, groups), threads a block and
    dynamic shared memory bytes (the ring of two chunks, aliased by the
    warps' lists after the scan, then per env a NaN flag and the merge's
    place in each list), as csrc/narrowphase.cu's topk_smem_bytes computes
    them."""
    if not 0 < K <= TOPK_MAX_K:
        raise NotImplementedError(
            f"topk_select_kernel is instantiated for K <= {TOPK_MAX_K}, not {K}")
    kcap = next(c for c in (8, 16, 24) if K <= c)
    ch = min(max(maxk, 1), TOPK_CHUNK)
    smem = max(2 * ch * TOPK_TILE * 4, TOPK_WARPS * kcap * TOPK_TILE * 8)
    return {"grid": (-(-B // TOPK_TILE), G), "threads": TOPK_WARPS * 32,
            "tile": TOPK_TILE, "kcap": kcap,
            "smem": smem + (1 + TOPK_WARPS) * TOPK_TILE * 4}


def topk_select(rank, mask, K: int):
    """(G, maxk, B) ranks, (G, maxk) bool mask -> (G, K, B) int32 indices of
    the K smallest (see topk_select_plain). CUDA tensors launch
    topk_select_kernel (float32 ranks); CPU tensors take the plain
    version."""
    G, maxk, B = rank.shape
    if tuple(mask.shape) != (G, maxk):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected {(G, maxk)}")
    if not kernels.on_card((rank,), (mask,)):
        return topk_select_plain(rank, mask, K)
    geo = topk_geometry(G, maxk, B, K)
    if geo["smem"] > kernels.SMEM_MAX:
        raise NotImplementedError(f"topk_select_kernel needs {geo['smem']} "
                                  "bytes of shared memory a block")
    rank = rank.contiguous()
    mask = mask.contiguous()
    out = torch.empty((G, K, B), dtype=torch.int32, device=rank.device)
    vec4 = B % 4 == 0 and rank.data_ptr() % 16 == 0
    rc = _lib().grt_topk_select_f32(
        rank.data_ptr(), mask.data_ptr(), out.data_ptr(), G, maxk, B, K,
        int(vec4), geo["smem"], torch.cuda.current_stream(rank.device).cuda_stream,
    )
    kernels.raise_on(rc, "topk_select_kernel")
    launched = B > 0 and G > 0 and maxk > 0   # it launches nothing else
    LAUNCHES["topk"] += launched
    TOPK_SHAPES[(G, maxk, K)] += launched
    return out


# ---------------------------------------------------------------------------
# narrowphase megakernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Group:
    kind: int          # index into KINDS
    S: int             # slots per pair
    k: int             # pairs evaluated
    row_off: int       # first compact row
    g1: torch.Tensor   # (n,) geom ids of the group's pair list
    g2: torch.Tensor
    sel_group: int     # row block of ``sel`` for a pruned group, else -1
    hull2: torch.Tensor = None   # (n,) hull ids of g2 for a hull group


@dataclasses.dataclass
class GroupTable:
    """Static description of the kernel's groups in the compact table of
    ``ncon`` rows (the rows of the groups that run outside the kernel are
    left to their caller): the groups (for the plain version) and, for the
    kernel, one int32 column per evaluated pair: ``pairs`` (4, C) = kind,
    first output row, row of ``sel`` that picks the pair (-1: a static
    pair) and offset of the group's pair list in ``lists``; ``lens`` (C,) =
    that list's length; ``lists`` (2, L) = the geom ids of every group's
    pair list, concatenated; ``tasks`` (T, NP_WARPS) = a block's warp items,
    each 8 * column + part (ITEMS) or -1 for an idle warp, a cooperative
    item (COOP_KINDS) given to every warp of its task plus NP_COOP, the
    tasks longest first; ``geom_hull`` (ngeom,) = each geom's hull id (-1 for a
    primitive); ``rows`` = the compact rows the kernel writes."""

    groups: list
    pairs: torch.Tensor
    lens: torch.Tensor
    lists: torch.Tensor
    tasks: torch.Tensor
    geom_hull: torch.Tensor
    rows: torch.Tensor
    ncon: int

    @property
    def boxes(self) -> bool:
        """Whether the table holds a kind past the primitive four
        (plane-box, box-box, plane-hull, plane-cylinder, cylinder-box,
        cylinder-hull, capsule-capsule, capsule-cylinder,
        cylinder-cylinder, sphere-capsule, capsule-hull): the kernel's
        instantiation with
        their formulas, which needs more registers than the primitive kinds
        alone."""
        return any(g.kind >= BOX_KINDS for g in self.groups)

    @staticmethod
    def build(meta: T.Meta, plan, dev) -> "GroupTable":
        groups, pairs, lens, l1, l2, rows = [], [], [], [], [], []
        hull_of = (list(meta.geom_hullid) if meta.geom_hullid
                   else [-1] * meta.ngeom)
        sel_group = -1
        for g in plan.groups:
            sel_group += g.pruned
            if g.tp not in KINDS:
                continue
            kind = KINDS.index(g.tp)
            srow = sel_group if g.pruned else -1
            g1 = [meta.pairs[j][0] for j in g.idx]
            g2 = [meta.pairs[j][1] for j in g.idx]
            base = len(l1)
            for p in range(g.K):
                pairs.append((kind, g.base_c + p * g.S,
                              srow * g.K + p if g.pruned else -1,
                              base if g.pruned else base + p))
                lens.append(len(g1))
            groups.append(Group(
                kind, g.S, g.K, g.base_c, torch.as_tensor(g1, device=dev),
                torch.as_tensor(g2, device=dev), srow,
                torch.as_tensor([hull_of[x] for x in g2], device=dev)
                if g.tp[1] == T.MESH else None))
            rows += range(g.base_c, g.base_c + g.n_slots_c)
            l1 += g1
            l2 += g2
        i32 = dict(dtype=torch.int32, device=dev)
        return GroupTable(
            groups=groups,
            pairs=torch.as_tensor(pairs, **i32).reshape(-1, 4).T.contiguous(),
            lens=torch.as_tensor(lens, **i32),
            lists=torch.as_tensor([l1, l2], **i32).reshape(2, -1),
            tasks=_tasks([p[0] for p in pairs], dev),
            geom_hull=torch.as_tensor(hull_of, **i32),
            rows=torch.as_tensor(rows, dtype=torch.int64, device=dev),
            ncon=plan.ncon_c,
        )

    def only(self, kinds) -> "GroupTable":
        """The table cut to the groups of ``kinds`` (the kernel then writes
        only their rows), e.g. to time one kind alone."""
        cols = [c for c, k in enumerate(self.pairs[0].tolist()) if k in kinds]
        groups = [g for g in self.groups if g.kind in kinds]
        dev = self.pairs.device
        rows = [r for g in groups for r in range(g.row_off, g.row_off + g.k * g.S)]
        return dataclasses.replace(
            self, groups=groups, pairs=self.pairs[:, cols].contiguous(),
            lens=self.lens[cols].contiguous(),
            tasks=_tasks([self.pairs[0, c].item() for c in cols], dev),
            rows=torch.as_tensor(rows, dtype=torch.int64, device=dev))


def _tasks(kinds, dev) -> torch.Tensor:
    """The kernel's task table for pair columns of the given kinds: each
    item of COOP_KINDS a task of its own, the others four to a task, all
    longest first (ITEMS)."""
    solo, tasks = [], []
    for c, k in enumerate(kinds):
        for part, cost in enumerate(ITEMS[k]):
            if k in COOP_KINDS:
                tasks.append((cost, [8 * c + part + NP_COOP] * NP_WARPS))
            else:
                solo.append((cost, 8 * c + part))
    solo.sort(key=lambda x: -x[0])
    for i in range(0, len(solo), NP_WARPS):
        chunk = [item for _, item in solo[i:i + NP_WARPS]]
        tasks.append((solo[i][0], chunk + [-1] * (NP_WARPS - len(chunk))))
    tasks.sort(key=lambda x: -x[0])
    return torch.as_tensor([t for _, t in tasks], dtype=torch.int32,
                           device=dev).reshape(-1, NP_WARPS)


def narrowphase_geometry(table: GroupTable, B: int) -> dict:
    """Launch geometry of narrowphase_kernel<table.boxes>: grid (env tiles
    of NP_ENVS, tasks) and threads a block (NP_WARPS warps); its shared
    memory is static."""
    return {"grid": (-(-B // NP_ENVS), int(table.tasks.shape[0])),
            "threads": NP_WARPS * 32, "tile": NP_ENVS, "boxes": table.boxes}


def _nan_table(n, P):
    B = P.shape[-1]
    return tuple(torch.full((n, *shape, B), float("nan"), dtype=P.dtype,
                            device=P.device) for shape in ((), (3,), (3, 3)))


def narrowphase_plain(table: GroupTable, P, Rm, sizes3, sel, hull_vert=None,
                      hull_face=None, out=None):
    """The kernel's rows of the compact contact table: geom_xpos P
    (ngeom, 3, B), geom_xmat Rm (ngeom, 3, 3, B), geom_size sizes3
    (ngeom, 3, Bm), sel (G, K, B) picks of the pruned groups, the hull
    tables hull_vert (nhull, V, 3) (plane-hull reads the vertices) and
    hull_face (nhull, F, 4) (cylinder-hull and capsule-hull read the face
    planes, of the hull each env picked) -> dist (ncon, B), pos (ncon, 3, B), frame
    (ncon, 3, 3, B), rows group-major and pair-major (row = pair*S + slot)
    as collision_vec's pruned core emits them. The rows are written into
    ``out`` (dist, pos, frame) when given; a new table has NaN in the rows
    of the groups that run outside the kernel."""
    B = P.shape[-1]
    out = _nan_table(table.ncon, P) if out is None else out
    for g in table.groups:
        if g.sel_group < 0:
            ops1 = COL.take_static(P, Rm, sizes3, g.g1)
            ops2 = COL.take_static(P, Rm, sizes3, g.g2)
        else:
            pick = torch.clamp(sel[g.sel_group].long(), 0, len(g.g1) - 1)
            ops1 = COL.take_sel(P, Rm, sizes3, g.g1[pick])
            ops2 = COL.take_sel(P, Rm, sizes3, g.g2[pick])
        if g.hull2 is None:
            fn = COL.PRIMITIVES[KINDS[g.kind]]
        elif KINDS[g.kind][0] == T.PLANE:   # plane groups are never pruned
            fn = COL._make_plane_hull(hull_vert[g.hull2].permute(1, 2, 0)[..., None])
        else:   # cylinder- or capsule-hull: each env's picked hull's faces
            hid = g.hull2[:, None] if g.sel_group < 0 else g.hull2[pick]
            fn = COL._make_capsule_hull(COL.take_hull(hull_vert, hull_face, hid)[0])
        dist, pos, normal, tan = COL.rows_of(fn(*ops1, *ops2), g.k, g.S, B)
        r0, r1 = g.row_off, g.row_off + g.k * g.S
        out[0][r0:r1] = dist
        out[1][r0:r1] = pos
        out[2][r0:r1] = COL.frame_rows(normal, tan)
    return out


def narrowphase(table: GroupTable, P, Rm, sizes3, sel, hull_vert=None,
                hull_face=None, out=None):
    """The kernel's rows of the compact contact table (see
    narrowphase_plain). CUDA tensors launch narrowphase_kernel (float32);
    CPU tensors take the plain version."""
    ngeom, _, B = P.shape
    if tuple(Rm.shape) != (ngeom, 3, 3, B) or sizes3.shape[:2] != (ngeom, 3):
        raise ValueError("geom_xpos, geom_xmat and geom_size disagree on shape")
    floats = (P, Rm, sizes3) + tuple(h for h in (hull_vert, hull_face)
                                     if h is not None)
    if not kernels.on_card(floats, (), ints=(sel,)):
        return narrowphase_plain(table, P, Rm, sizes3, sel, hull_vert,
                                 hull_face, out)
    if sizes3.shape[-1] not in (1, B):
        raise ValueError(f"geom_size has batch axis {sizes3.shape[-1]}, not 1 or {B}")
    for g in table.groups:
        if g.hull2 is None:
            continue
        if KINDS[g.kind][0] == T.PLANE and hull_vert is None:
            raise ValueError("a plane-hull group needs the hull vertex table")
        if KINDS[g.kind][0] != T.PLANE and hull_face is None:
            raise ValueError("a cylinder- or capsule-hull group needs the "
                             "hull face table")
    n = table.ncon
    out = _nan_table(n, P) if out is None else out
    for t, shape in zip(out, ((n, B), (n, 3, B), (n, 3, 3, B))):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.dtype != P.dtype:
            raise ValueError(f"out table of shape {tuple(t.shape)}, expected "
                             f"a contiguous {shape}")
    P, Rm = P.contiguous(), Rm.contiguous()
    sel = sel.to(torch.int32).contiguous()
    hv = None if hull_vert is None else hull_vert.contiguous()
    hf = None if hull_face is None else hull_face.contiguous()
    ss = sizes3.stride()
    rc = _lib().grt_narrowphase_f32(
        P.data_ptr(), Rm.data_ptr(), sizes3.data_ptr(), ss[0], ss[1],
        ss[2] if sizes3.shape[-1] == B else 0,
        sel.data_ptr(), table.pairs.data_ptr(), table.lens.data_ptr(),
        table.lists.data_ptr(), table.lists.shape[1], table.pairs.shape[1],
        table.tasks.data_ptr(), table.tasks.shape[0], int(table.boxes),
        table.geom_hull.data_ptr(), None if hv is None else hv.data_ptr(),
        0 if hv is None else hv.shape[1], None if hf is None else hf.data_ptr(),
        0 if hf is None else hf.shape[1],
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B,
        torch.cuda.current_stream(P.device).cuda_stream,
    )
    kernels.raise_on(rc, "narrowphase_kernel")
    LAUNCHES["narrowphase"] += B > 0 and table.tasks.shape[0] > 0
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.load("narrowphase")
    lib.grt_topk_select_f32.argtypes = [_vp] * 3 + [_i] * 6 + [_vp]
    lib.grt_topk_select_f32.restype = _i
    for fn in (lib.grt_topk_smem_bytes, lib.grt_topk_blocks_per_sm):
        fn.argtypes = [_i, _i]
        fn.restype = _i
    lib.grt_narrowphase_f32.argtypes = (
        [_vp] * 3 + [_ll] * 3 + [_vp] * 4 + [_i] * 2 + [_vp, _i, _i]
        + [_vp] * 2 + [_i, _vp, _i] + [_vp] * 3 + [_i, _vp])
    lib.grt_narrowphase_f32.restype = _i
    lib.grt_narrowphase_blocks_per_sm.argtypes = [_i]
    lib.grt_narrowphase_blocks_per_sm.restype = _i
    return lib
