"""The pruned narrowphase's two kernels (csrc/narrowphase.cu), their
wrappers, and beside each its plain PyTorch version.

Port of gymnasium_robotics_tpu/physics/narrowphase_pallas.py:
``topk_select`` replaces the TPU kernel ``topk_select`` :155-198 (K rounds
of masked min + first-index argmin) and ``narrowphase`` replaces
``narrowphase_megakernel`` :201-287 (every group's contact formula in one
dispatch, ``GroupSpec``/``_emit_group`` :64-152) for the primitive groups
the port has (plane-sphere, plane-capsule, sphere-box, capsule-box). Where
the TPU kernel took operand blocks gathered by XLA, this kernel reads the
selected geom ids and gathers geom_xpos/geom_xmat/geom_size itself.

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
TOPK_MAX_K = 16          # largest K csrc/narrowphase.cu instantiates
# group kinds, in the order csrc/narrowphase.cu numbers them
KINDS = ((T.PLANE, T.SPHERE), (T.PLANE, T.CAPSULE), (T.SPHERE, T.BOX),
         (T.CAPSULE, T.BOX))


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
    if not 0 < K <= TOPK_MAX_K:
        raise NotImplementedError(
            f"topk_select_kernel is instantiated for K <= {TOPK_MAX_K}, not {K}")
    rank = rank.contiguous()
    mask = mask.contiguous()
    out = torch.empty((G, K, B), dtype=torch.int32, device=rank.device)
    rc = _lib().grt_topk_select_f32(
        rank.data_ptr(), mask.data_ptr(), out.data_ptr(), G, maxk, B, K,
        torch.cuda.current_stream(rank.device).cuda_stream,
    )
    kernels.raise_on(rc, "topk_select_kernel")
    LAUNCHES["topk"] += 1
    TOPK_SHAPES[(G, maxk, K)] += 1
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


@dataclasses.dataclass
class GroupTable:
    """Static description of the compact table: the groups (for the plain
    version) and, for the kernel, one int32 column per evaluated pair:
    ``pairs`` (4, C) = kind, first output row, row of ``sel`` that picks the
    pair (-1: a static pair) and offset of the group's pair list in
    ``lists``; ``lens`` (C,) = that list's length; ``lists`` (2, L) = the
    geom ids of every group's pair list, concatenated."""

    groups: list
    pairs: torch.Tensor
    lens: torch.Tensor
    lists: torch.Tensor
    ncon: int

    @staticmethod
    def build(meta: T.Meta, plan, dev) -> "GroupTable":
        groups, pairs, lens, l1, l2 = [], [], [], [], []
        sel_group = 0
        for g in plan.groups:
            kind = KINDS.index(g.tp)
            g1 = [meta.pairs[j][0] for j in g.idx]
            g2 = [meta.pairs[j][1] for j in g.idx]
            base = len(l1)
            for p in range(g.K):
                pairs.append((kind, g.base_c + p * g.S,
                              sel_group * g.K + p if g.pruned else -1,
                              base if g.pruned else base + p))
                lens.append(len(g1))
            groups.append(Group(kind, g.S, g.K, g.base_c,
                                torch.as_tensor(g1, device=dev),
                                torch.as_tensor(g2, device=dev),
                                sel_group if g.pruned else -1))
            if g.pruned:
                sel_group += 1
            l1 += g1
            l2 += g2
        i32 = dict(dtype=torch.int32, device=dev)
        return GroupTable(
            groups=groups,
            pairs=torch.as_tensor(pairs, **i32).T.contiguous(),
            lens=torch.as_tensor(lens, **i32),
            lists=torch.as_tensor([l1, l2], **i32),
            ncon=plan.ncon_c,
        )


def _take_sel(P, Rm, sizes3, gid):
    """Per-lane operands of geoms ``gid`` (K, B): p (3, K, B),
    R (3, 3, K, B), s (3, K, B)."""
    lane = torch.arange(gid.shape[1], device=gid.device)
    p = P[gid, :, lane].permute(2, 0, 1)
    R = Rm[gid, :, :, lane].permute(2, 3, 0, 1)
    s = sizes3.expand(-1, -1, gid.shape[1])[gid, :, lane].permute(2, 0, 1)
    return p, R, s


def narrowphase_plain(table: GroupTable, P, Rm, sizes3, sel):
    """The compact contact table: geom_xpos P (ngeom, 3, B), geom_xmat Rm
    (ngeom, 3, 3, B), geom_size sizes3 (ngeom, 3, Bm), sel (G, K, B) picks of
    the pruned groups -> dist (ncon, B), pos (ncon, 3, B), frame
    (ncon, 3, 3, B), rows group-major and pair-major (row = pair*S + slot)
    as collision_vec's pruned core emits them."""
    B = P.shape[-1]
    rows = []
    for g in table.groups:
        if g.sel_group < 0:
            ops1 = COL.take_static(P, Rm, sizes3, g.g1)
            ops2 = COL.take_static(P, Rm, sizes3, g.g2)
        else:
            pick = torch.clamp(sel[g.sel_group].long(), 0, len(g.g1) - 1)
            ops1 = _take_sel(P, Rm, sizes3, g.g1[pick])
            ops2 = _take_sel(P, Rm, sizes3, g.g2[pick])
        res = COL.PRIMITIVES[KINDS[g.kind]](*ops1, *ops2)
        rows.append(COL.rows_of(res, g.k, g.S, B))
    dist, pos, normal, tan = COL.cat_rows(rows)
    return dist, pos, COL.frame_rows(normal, tan)


def narrowphase(table: GroupTable, P, Rm, sizes3, sel):
    """The compact contact table (see narrowphase_plain). CUDA tensors
    launch narrowphase_kernel (float32); CPU tensors take the plain
    version."""
    ngeom, _, B = P.shape
    if tuple(Rm.shape) != (ngeom, 3, 3, B) or sizes3.shape[:2] != (ngeom, 3):
        raise ValueError("geom_xpos, geom_xmat and geom_size disagree on shape")
    if not kernels.on_card((P, Rm, sizes3), (), ints=(sel,)):
        return narrowphase_plain(table, P, Rm, sizes3, sel)
    if sizes3.shape[-1] not in (1, B):
        raise ValueError(f"geom_size has batch axis {sizes3.shape[-1]}, not 1 or {B}")
    P, Rm = P.contiguous(), Rm.contiguous()
    sel = sel.to(torch.int32).contiguous()
    n = table.ncon
    dev = P.device
    dist = torch.empty((n, B), dtype=torch.float32, device=dev)
    pos = torch.empty((n, 3, B), dtype=torch.float32, device=dev)
    frame = torch.empty((n, 3, 3, B), dtype=torch.float32, device=dev)
    ss = sizes3.stride()
    rc = _lib().grt_narrowphase_f32(
        P.data_ptr(), Rm.data_ptr(), sizes3.data_ptr(), ss[0], ss[1],
        ss[2] if sizes3.shape[-1] == B else 0,
        sel.data_ptr(), table.pairs.data_ptr(), table.lens.data_ptr(),
        table.lists.data_ptr(), table.lists.shape[1], table.pairs.shape[1],
        dist.data_ptr(), pos.data_ptr(), frame.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.raise_on(rc, "narrowphase_kernel")
    LAUNCHES["narrowphase"] += 1
    return dist, pos, frame


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.load("narrowphase")
    lib.grt_topk_select_f32.argtypes = [_vp] * 3 + [_i] * 4 + [_vp]
    lib.grt_topk_select_f32.restype = _i
    lib.grt_narrowphase_f32.argtypes = (
        [_vp] * 3 + [_ll] * 3 + [_vp] * 4 + [_i] * 2 + [_vp] * 3 + [_i, _vp])
    lib.grt_narrowphase_f32.restype = _i
    return lib
