"""Per-env dense solves: the CUDA kernels of csrc/solver.cu, their
wrappers, and beside each its plain PyTorch version.

Port of gymnasium_robotics_tpu/physics/solver_pallas.py: ``solve_pos``
replaces ``solve_pos_soa`` (TPU kernel ``_kernel_chol``),
``solve_newton`` replaces ``solve_small_soa`` (TPU kernel ``_kernel_nv``)
and ``solve_newton_nv2`` replaces ``solve_small_nv2`` (TPU kernel
``_kernel``, the nv = 2 Newton with its 2x2 systems solved in closed form;
both nv = 2 routes run one kernel template, ``newton2_kernel``),
with the same batch-last signatures. The kernels read the port's own
layouts (the full M, J as (ne, nv, B), bool masks, a per-model is_eq), so
the wrappers copy nothing: the kernels take each input's strides.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches its kernel or raises. The plain versions serve the CPU tests and
the on-card check of each kernel; they never stand in for a kernel on CUDA
tensors. ``LAUNCHES`` counts kernel launches, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gymnasium_robotics_tpu_torch import kernels

LAUNCHES = {"chol": 0, "newton": 0, "newton_nv2": 0}
# newton_tile_kernel's instantiations (csrc/solver.cu GRT_NEWTON_TILES):
# nv -> its shapes (warps an env, rows a lane, envs a tile) in ascending
# row cap, 32 x warps x rows; a solve takes the first whose rows hold ne
# (nv = 14: AntMaze's 72 rows the 96-row shape, Ant's 108 the 128-row one)
NEWTON_TILE_SHAPES = {3: ((1, 2, 8),), 4: ((1, 2, 8),), 5: ((1, 2, 8),),
                      6: ((1, 2, 8),), 9: ((1, 3, 8),), 11: ((1, 1, 8),),
                      14: ((1, 3, 8), (1, 4, 8)), 15: ((2, 4, 8),),
                      21: ((2, 4, 8),), 23: ((3, 3, 4),), 24: ((3, 3, 4),),
                      29: ((3, 3, 4),), 30: ((3, 3, 4),), 33: ((3, 3, 4),),
                      36: ((3, 3, 4),)}
# nv values csrc/solver.cu instantiates
KERNEL_NV = (2,) + tuple(NEWTON_TILE_SHAPES)
# largest row count the Newton kernel takes, per nv: newton2_kernel's (a
# group of lanes an env) at nv = 2, else the largest tile shape's
NEWTON_MAX_ROWS = {2: 64, **{nv: 32 * s[-1][0] * s[-1][1]
                             for nv, s in NEWTON_TILE_SHAPES.items()}}
NEWTON_BLOCK = 3   # side of the block of H a lane sums
NEWTON_NV2_MAX_ROWS = 64  # newton2_kernel, the per-env route
# newton2_kernel<G, CHOL>: NV2_ROWS_PER_LANE rows a lane, G lanes an env
# (the first of NV2_LANES that holds ne), NV2_THREADS threads a block
NV2_ROWS_PER_LANE = 8
NV2_LANES = (4, 8)
NV2_THREADS = 128
# chol_tile_kernel (CHOL_TILE_NV, csrc/solver.cu GRT_CHOL_TILES): a tile
# of CHOL_TILE envs a block (CHOL_TILE_WIDE where a lane holds two rows,
# past nv = 32), a half-warp an env where nv <= 16, else a warp; nv = 2
# runs chol_solve_kernel, one env per thread
CHOL_TILE = 16
CHOL_TILE_WIDE = 8
CHOL_TILE_NV = KERNEL_NV[1:]


def solve_pos_plain(M, b):
    """Batch-last SPD solve M x = b: M (nv, nv, B), read on and below the
    diagonal, b (nv, B) -> (nv, B), by LL^T with the diagonal floored at
    sqrt(max(s, 1e-20)) (solver_pallas._chol_solve_lanes). Each element's
    arithmetic is the unrolled solve's, operation for operation: t - a * b
    in ascending k for every entry of L and of y, then a division by L_ii;
    x_i = (y_i - sum over k > i of L_ki x_k, in ascending k) / L_ii. The
    factor and the forward substitution take whole columns at once."""
    nv = b.shape[0]
    cols = []                      # cols[i] = L[i:, i], (nv - i, B)
    for i in range(nv):
        c = M[i:, i]
        for k in range(i):
            c = c - cols[k][i - k:] * cols[k][i - k]
        d = torch.sqrt(torch.clamp(c[0], min=1e-20))
        cols.append(torch.cat([d[None], c[1:] / d]))
    y, rest = [], b
    for i in range(nv):
        y.append(rest[0] / cols[i][0])
        rest = rest[1:] - cols[i][1:] * y[i]
    x = [None] * nv
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            s = s - cols[i][k - i] * x[k]
        x[i] = s / cols[i][0]
    return torch.stack(x)


def solve_newton_plain(M, a_smooth, a_warm, J, aref, D, active, is_eq,
                       n_iter: int, n_ls: int):
    """Batch-last warm-started Newton solve of the soft-constraint problem
    (the batched formulation of soa.solve_constraints :1757-1808, with the
    floored Cholesky for every SPD solve): M (nv, nv, B), a_smooth/a_warm
    (nv, B), J (ne, nv, B), aref/D/active (ne, B), is_eq (ne,) per model
    row or (ne, B) -> (qacc (nv, B), f (ne, B))."""
    active = active.bool()
    is_eq = is_eq.bool()
    if is_eq.dim() == 1:
        is_eq = is_eq[:, None]

    def x_of(a):
        return torch.einsum("evb,vb->eb", J, a) - aref

    def dw_of(x):
        return torch.where((is_eq | (x < 0.0)) & active, D, torch.zeros_like(D))

    a = a_warm
    for _ in range(n_iter):
        x = x_of(a)
        Dw = dw_of(x)
        Mda = torch.einsum("uvb,vb->ub", M, a - a_smooth)
        grad = Mda + torch.einsum("evb,eb->vb", J, Dw * x)
        H = M + torch.einsum("evb,eb,ewb->vwb", J, Dw, J)
        p = -solve_pos_plain(H, grad)
        Jp = torch.einsum("evb,vb->eb", J, p)
        pMp = torch.sum(p * torch.einsum("uvb,vb->ub", M, p), dim=0)
        pMa = torch.sum(p * Mda, dim=0)
        alpha = torch.ones_like(pMp)
        for _ in range(n_ls):
            xl = x + alpha * Jp
            Dl = dw_of(xl)
            dphi = alpha * pMp + pMa + torch.sum(Dl * xl * Jp, dim=0)
            ddphi = pMp + torch.sum(Dl * Jp * Jp, dim=0)
            alpha = alpha - dphi / torch.clamp(ddphi, min=1e-12)
        a = a + torch.clamp(alpha, 0.0, 4.0) * p

    x = x_of(a)
    f = -dw_of(x) * x
    f = torch.where(is_eq, f, torch.clamp(f, min=0.0))
    qacc = a_smooth + solve_pos_plain(M, torch.einsum("evb,eb->vb", J, f))
    return qacc, f


def solve_newton_nv2_plain(M, a_smooth, a_warm, J, aref, D, active, is_eq,
                           n_iter: int, n_ls: int):
    """The nv = 2 Newton solve in closed form (solver_pallas._kernel
    :42-110): the same problem and iteration as solve_newton_plain, with
    the 2x2 Hessian and the final M solve by determinant instead of
    Cholesky. Shapes as solve_newton_plain, nv = 2."""
    active = active.bool()
    is_eq = is_eq.bool()
    if is_eq.dim() == 1:
        is_eq = is_eq[:, None]
    m00, m01, m11 = M[0, 0], M[0, 1], M[1, 1]
    as0, as1 = a_smooth[0], a_smooth[1]
    J0, J1 = J[:, 0], J[:, 1]
    a0, a1 = a_warm[0], a_warm[1]

    def dw_of(x):
        return torch.where((is_eq | (x < 0.0)) & active, D, torch.zeros_like(D))

    def rsum(x):
        return torch.sum(x, dim=0)

    for _ in range(n_iter):
        x = J0 * a0 + J1 * a1 - aref
        Dw = dw_of(x)
        gx = Dw * x
        da0, da1 = a0 - as0, a1 - as1
        grad0 = m00 * da0 + m01 * da1 + rsum(J0 * gx)
        grad1 = m01 * da0 + m11 * da1 + rsum(J1 * gx)
        h00 = m00 + rsum(Dw * J0 * J0)
        h01 = m01 + rsum(Dw * J0 * J1)
        h11 = m11 + rsum(Dw * J1 * J1)
        det = h00 * h11 - h01 * h01
        p0 = -(h11 * grad0 - h01 * grad1) / det
        p1 = -(-h01 * grad0 + h00 * grad1) / det
        Jp = J0 * p0 + J1 * p1
        pMp = p0 * (m00 * p0 + m01 * p1) + p1 * (m01 * p0 + m11 * p1)
        pMa = p0 * (m00 * da0 + m01 * da1) + p1 * (m01 * da0 + m11 * da1)
        alpha = torch.ones_like(p0)
        for _ in range(n_ls):
            x2 = x + alpha * Jp
            Dw2 = dw_of(x2)
            dphi = alpha * pMp + pMa + rsum(Dw2 * x2 * Jp)
            ddphi = pMp + rsum(Dw2 * Jp * Jp)
            alpha = alpha - dphi / torch.clamp(ddphi, min=1e-12)
        alpha = torch.clamp(alpha, 0.0, 4.0)
        a0 = a0 + alpha * p0
        a1 = a1 + alpha * p1

    x = J0 * a0 + J1 * a1 - aref
    f = -dw_of(x) * x
    f = torch.where(is_eq, f, torch.clamp(f, min=0.0))
    qfc0, qfc1 = rsum(J0 * f), rsum(J1 * f)
    detM = m00 * m11 - m01 * m01
    q0 = as0 + (m11 * qfc0 - m01 * qfc1) / detM
    q1 = as1 + (-m01 * qfc0 + m00 * qfc1) / detM
    return torch.stack([q0, q1]), f


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_vp, _i = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.load("solver")
    lib.grt_chol_solve_f32.argtypes = [_vp] * 4 + [_i, _i, _i, _vp]
    lib.grt_chol_solve_f32.restype = _i
    lib.grt_newton_f32.argtypes = [_vp] * 11 + [_i] * 6 + [_vp]
    lib.grt_newton_f32.restype = _i
    for fn in (lib.grt_newton_smem_bytes, lib.grt_newton_blocks_per_sm):
        fn.argtypes = [_i, _i]
        fn.restype = _i
    for fn in (lib.grt_chol_smem_bytes, lib.grt_chol_blocks_per_sm):
        fn.argtypes = [_i]
        fn.restype = _i
    lib.grt_newton2_f32.argtypes = [_vp] * 11 + [_i] * 4 + [_vp]
    lib.grt_newton2_f32.restype = _i
    lib.grt_newton2_lanes.argtypes = [_i]
    lib.grt_newton2_lanes.restype = _i
    lib.grt_newton2_blocks_per_sm.argtypes = [_i, _i]
    lib.grt_newton2_blocks_per_sm.restype = _i
    return lib


def _route_to_kernel(nv, floats, masks=()):
    """kernels.on_card, and the nv values csrc/solver.cu instantiates."""
    if not kernels.on_card(floats, masks):
        return False
    if nv not in KERNEL_NV:
        raise NotImplementedError(
            f"the CUDA solver kernels are instantiated for nv in {KERNEL_NV}, "
            f"not nv={nv}; add it to csrc/solver.cu with its slice"
        )
    return True


def _check_shapes(named):
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _strides(*ts):
    """The element strides of the inputs, in order, as the C array the
    kernels read them through: no input is copied."""
    st = [s for t in ts for s in t.stride()]
    return (ctypes.c_longlong * len(st))(*st)


def solve_pos(M, b):
    """Batch-last SPD solve M x = b: M (nv, nv, B), b (nv, B) -> (nv, B).
    CUDA tensors launch chol_solve_kernel (nv = 2) or chol_tile_kernel
    (CHOL_TILE_NV); CPU tensors take the plain version."""
    nv, B = b.shape
    _check_shapes([("M", M, (nv, nv, B))])
    if not _route_to_kernel(nv, (M, b)):
        return solve_pos_plain(M, b)
    smem = chol_geometry(nv, B)["smem"] if nv in CHOL_TILE_NV else 0
    x = torch.empty((nv, B), dtype=torch.float32, device=b.device)
    rc = _lib().grt_chol_solve_f32(
        M.data_ptr(), b.data_ptr(), x.data_ptr(), _strides(M, b), nv, B, smem,
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    kernels.raise_on(rc, "chol_solve_kernel")
    LAUNCHES["chol"] += B > 0         # the entry point launches nothing at B = 0
    return x


def solve_newton(M, a_smooth, a_warm, J, aref, D, active, is_eq,
                 n_iter: int, n_ls: int):
    """Batch-last fused Newton solve (signature of solve_small_soa): M
    (nv, nv, B), a_smooth/a_warm (nv, B), J (ne, nv, B), aref/D/active
    (ne, B), is_eq (ne,) per model row or (ne, B) -> (qacc (nv, B),
    f (ne, B)). CUDA tensors launch newton2_kernel<G, true> (nv = 2) or
    newton_tile_kernel (newton_shape); CPU tensors take the plain
    version."""
    nv, ne, B = _check_newton_shapes(M, a_smooth, a_warm, J, aref, D,
                                     active, is_eq)
    if not _route_to_kernel(nv, (M, a_smooth, a_warm, J, aref, D),
                            (active, is_eq)):
        return solve_newton_plain(M, a_smooth, a_warm, J, aref, D, active,
                                  is_eq, n_iter, n_ls)
    if ne > NEWTON_MAX_ROWS[nv]:
        raise NotImplementedError(
            f"the Newton kernel at nv={nv} is instantiated for up to "
            f"{NEWTON_MAX_ROWS[nv]} rows, not {ne}; add a larger row cap to "
            "csrc/solver.cu"
        )
    smem = newton_geometry(nv, ne, B)["smem"] if nv in NEWTON_TILE_SHAPES else 0
    qacc, f, rc = _launch_newton(_lib().grt_newton_f32, (nv,), M, a_smooth,
                                 a_warm, J, aref, D, active, is_eq, n_iter,
                                 n_ls, (smem,))
    kernels.raise_on(rc, "newton2_kernel" if nv == 2 else "newton_tile_kernel")
    LAUNCHES["newton"] += B > 0
    return qacc, f


def solve_newton_nv2(M, a_smooth, a_warm, J, aref, D, active, is_eq,
                     n_iter: int, n_ls: int):
    """The nv = 2 Newton solve in closed form (signature of solve_newton,
    nv = 2): the per-env path's solve (constraint.solve_constraints with
    Option.soa False). CUDA tensors launch newton2_kernel<G, false>; CPU
    tensors take solve_newton_nv2_plain."""
    nv, ne, B = _check_newton_shapes(M, a_smooth, a_warm, J, aref, D, active,
                                     is_eq)
    if nv != 2:
        raise ValueError(f"solve_newton_nv2 takes nv = 2, not nv={nv}")
    if not kernels.on_card((M, a_smooth, a_warm, J, aref, D), (active, is_eq)):
        return solve_newton_nv2_plain(M, a_smooth, a_warm, J, aref, D, active,
                                      is_eq, n_iter, n_ls)
    if ne > NEWTON_NV2_MAX_ROWS:
        raise NotImplementedError(
            f"newton2_kernel is instantiated for up to "
            f"{NEWTON_NV2_MAX_ROWS} rows, not {ne}; add a larger row cap to "
            "csrc/solver.cu"
        )
    qacc, f, rc = _launch_newton(_lib().grt_newton2_f32, (), M, a_smooth,
                                 a_warm, J, aref, D, active, is_eq, n_iter,
                                 n_ls)
    kernels.raise_on(rc, "newton2_kernel")
    LAUNCHES["newton_nv2"] += B > 0
    return qacc, f


def _check_newton_shapes(M, a_smooth, a_warm, J, aref, D, active, is_eq):
    """(nv, ne, B) of a Newton solve's operands, raising on any other
    shape."""
    nv, B = a_smooth.shape
    ne = aref.shape[0]
    _check_shapes([
        ("M", M, (nv, nv, B)), ("a_warm", a_warm, (nv, B)),
        ("J", J, (ne, nv, B)), ("D", D, (ne, B)), ("active", active, (ne, B)),
        ("is_eq", is_eq, (ne,) if is_eq.dim() == 1 else (ne, B)),
    ])
    return nv, ne, B


def newton2_geometry(ne: int, B: int) -> dict:
    """Launch geometry of newton2_kernel at ne rows and B envs: the lanes
    an env (the first of NV2_LANES whose NV2_ROWS_PER_LANE rows a lane hold
    ne), rows a lane, envs and threads a block and the grid, as
    csrc/solver.cu's nv2_lanes and launch_newton2 compute them."""
    lanes = next((g for g in NV2_LANES if g * NV2_ROWS_PER_LANE >= ne), None)
    if lanes is None:
        raise NotImplementedError(
            f"newton2_kernel is instantiated for up to "
            f"{NV2_LANES[-1] * NV2_ROWS_PER_LANE} rows, not {ne}")
    return {"lanes_per_env": lanes, "rows_per_lane": NV2_ROWS_PER_LANE,
            "envs_per_block": NV2_THREADS // lanes, "threads": NV2_THREADS,
            "grid": -(-B * lanes // NV2_THREADS), "smem": 0}


def chol_geometry(nv: int, B: int) -> dict:
    """Launch geometry of chol_tile_kernel (CHOL_TILE_NV) at B envs: its
    tile, lanes an env and rows a lane, grid, threads a block and shared
    memory bytes (per env M's packed triangle and the right-hand side, nv
    (nv + 3) / 2 floats), as csrc/solver.cu's CholLayout computes them."""
    if nv not in CHOL_TILE_NV:
        raise NotImplementedError(f"chol_tile_kernel has no nv={nv}")
    lanes = 16 if nv <= 16 else 32
    rpl = -(-nv // lanes)
    tile = CHOL_TILE_WIDE if rpl > 1 else CHOL_TILE
    return {"grid": -(-B // tile), "threads": tile * lanes, "tile": tile,
            "lanes_per_env": lanes, "rows_per_lane": rpl,
            "smem": tile * nv * (nv + 3) // 2 * 4}


def newton_shape(nv: int, ne: int) -> tuple:
    """(warps an env, rows a lane, envs a tile) of the newton_tile_kernel
    instantiation that takes ne rows at nv: the first of NEWTON_TILE_SHAPES
    [nv] whose rows hold ne."""
    if nv not in NEWTON_TILE_SHAPES:
        raise NotImplementedError(f"newton_tile_kernel has no nv={nv}")
    for shape in NEWTON_TILE_SHAPES[nv]:
        if ne <= 32 * shape[0] * shape[1]:
            return shape
    raise NotImplementedError(
        f"the Newton kernel at nv={nv} is instantiated for up to "
        f"{NEWTON_MAX_ROWS[nv]} rows, not {ne}; add a larger row cap to "
        "csrc/solver.cu")


def newton_geometry(nv: int, ne: int, B: int) -> dict:
    """Launch geometry of newton_tile_kernel (newton_shape) at ne rows
    and B envs: its tile, grid, threads a block and dynamic shared memory
    bytes (per env: J^T with a zero column where the blocks of H overhang
    nv and its rows padded to the row cap + 4, each row's weight and D x,
    M's triangle and H's, five vectors of 32 floats a 32 components, 16
    scalars and a byte per row; padded to 4 mod 32 floats), as
    csrc/solver.cu's TileLayout computes them."""
    wpe, rpl, tile = newton_shape(nv, ne)
    bs = NEWTON_BLOCK
    nec = 32 * wpe * rpl
    njc = nv + 1 if -(-nv // bs) * bs > nv else nv   # + a zero column
    nt = nv * (nv + 1) // 2
    vw = 32 * -(-nv // 32)
    used = njc * (nec + 4) + 2 * nec + 2 * nt + 5 * vw + 16 + nec // 4
    total = used + (36 - used % 32) % 32
    return {"grid": -(-B // tile), "threads": tile * wpe * 32, "tile": tile,
            "warps_per_env": wpe, "rows_per_lane": rpl,
            "smem": total * 4 * tile}


def _launch_newton(entry, nv_arg, M, a_smooth, a_warm, J, aref, D, active,
                   is_eq, n_iter, n_ls, tail=()):
    """Launch one of the Newton entry points on the operands where they lie
    (a per-model is_eq gets batch stride 0), ``tail`` its arguments before
    the stream: (qacc, f, its return code)."""
    nv, B = a_smooth.shape
    ne = aref.shape[0]
    dev = a_smooth.device
    eq = is_eq.expand(B, ne).T if is_eq.dim() == 1 else is_eq  # batch stride 0
    ins = (M, a_smooth, a_warm, J, aref, D, active, eq)
    qacc = torch.empty((nv, B), dtype=torch.float32, device=dev)
    f = torch.empty((ne, B), dtype=torch.float32, device=dev)
    rc = entry(
        *(t.data_ptr() for t in ins), qacc.data_ptr(), f.data_ptr(),
        _strides(*ins), *nv_arg, ne, B, int(n_iter), int(n_ls), *tail,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return qacc, f, rc
