#!/usr/bin/env python3
"""The narrowphase kernel's time by group kind, on the card.

    python3 tools/narrowphase_kinds.py [--parent DIR]

Builds csrc/narrowphase.cu, makes the arrays the main paths hand the kernel
at B = 2048 (AntMaze_UMaze-v5: the pressed state chip_smoke.py times it on;
FetchPush-v4: the state after two env steps of registry.make), and times
the kernel on its whole group table and on each kind's pairs alone (the
table cut to that kind's columns, GroupTable.only), with CUDA events over a
CUDA graph of 50 launches as chip_smoke.py times kernels. Prints one JSON
line per path.

With --parent DIR (an unpacked checkout of an earlier commit), it also
builds that checkout's csrc/narrowphase.cu and csrc/solver.cu, calls their
entry points through the older C interfaces (grt_narrowphase_f32 without a
task table; grt_chol_solve_f32 without shared memory bytes) on the same
inputs, and prints whether the compact tables (on the main-path arrays and
on the pressed states) and the Cholesky solutions (nv = 14 and 21 on the
main paths' qM and the Euler's damped system) are bitwise equal, with both
versions' times taken in turns (parent, this tree, this tree, parent).
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

B = 2048
KIND_NAMES = ("plane-sphere", "plane-capsule", "sphere-box", "capsule-box",
              "plane-box", "box-box", "plane-hull")


def build_parent(parent, names):
    """{name: ctypes library} of the parent's csrc/<name>.cu."""
    from gymnasium_robotics_tpu_torch import kernels

    out = {}
    tmp = tempfile.mkdtemp(prefix="grt_parent_")
    procs = {}
    for name in names:
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(parent, "gymnasium_robotics_tpu_torch", "csrc", name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent {name}.cu: nvcc exited {p.returncode}\n{log}")
        out[name] = ctypes.CDLL(so)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out["narrowphase"].grt_narrowphase_f32.argtypes = (
        [vp] * 3 + [ll] * 3 + [vp] * 4 + [i] * 2 + [vp] * 2 + [i] + [vp] * 3 + [i, vp])
    out["narrowphase"].grt_narrowphase_f32.restype = i
    out["solver"].grt_chol_solve_f32.argtypes = [vp] * 4 + [i, i, vp]
    out["solver"].grt_chol_solve_f32.restype = i
    return out


def parent_narrowphase(lib, torch, table, P, Rm, sizes3, sel, hull_vert, out):
    """The parent's narrowphase_kernel on the wrapper's operands, into out."""
    nb = P.shape[-1]
    P, Rm = P.contiguous(), Rm.contiguous()
    sel = sel.to(torch.int32).contiguous()
    ss = sizes3.stride()
    rc = lib.grt_narrowphase_f32(
        P.data_ptr(), Rm.data_ptr(), sizes3.data_ptr(), ss[0], ss[1],
        ss[2] if sizes3.shape[-1] == nb else 0, sel.data_ptr(),
        table.pairs.data_ptr(), table.lens.data_ptr(), table.lists.data_ptr(),
        table.lists.shape[1], table.pairs.shape[1], table.geom_hull.data_ptr(),
        None if hull_vert is None else hull_vert.contiguous().data_ptr(),
        0 if hull_vert is None else hull_vert.shape[1],
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), nb,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent narrowphase: {rc}"
    return out


def parent_chol(lib, torch, solver, M, b):
    nv, nb = b.shape
    x = torch.empty((nv, nb), dtype=torch.float32, device=b.device)
    rc = lib.grt_chol_solve_f32(M.data_ptr(), b.data_ptr(), x.data_ptr(),
                                solver._strides(M, b), nv, nb,
                                torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent chol: {rc}"
    return x


def bits_equal(torch, a, b):
    """Bitwise equality of two float tensors (every NaN the same bits)."""
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("narrowphase_kinds: no CUDA device", file=sys.stderr)
        return 2
    from gymnasium_robotics_tpu_torch import kernels, registry
    from gymnasium_robotics_tpu_torch.physics import (
        collision, narrowphase, pipeline, solver)

    ptx = CS.ptxas_report(kernels.build())
    card = CS.card_line()
    print(json.dumps({"ptxas": {k: v for k, v in ptx.items()
                                if "chol" in k or "narrowphase" in k}}), flush=True)
    dev = torch.device("cuda")
    plib = build_parent(args.parent, ("narrowphase", "solver")) if args.parent else None

    ant = registry.make("AntMaze_UMaze-v5", num_envs=B)
    m_ant = ant.env.model
    fetch = registry.make("FetchPush-v4", num_envs=B)
    fetch.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        fetch.step(torch.rand((B, 4), generator=gen, device=dev) * 2 - 1)
    m_f = fetch.env.model
    d_f = pipeline.forward(m_f, fetch.state.data)
    qpos, mp, mq = CS.arm_poses(fetch.env, B, 1)
    d_fp = pipeline.make_data(m_f, B)
    d_fp.qpos[:] = torch.as_tensor(qpos, dtype=torch.float32, device=dev)
    d_fp.mocap_pos[:] = torch.as_tensor(mp, dtype=torch.float32, device=dev)
    d_fp.mocap_quat[:] = torch.as_tensor(mq, dtype=torch.float32, device=dev)
    d_fp = pipeline.forward(m_f, d_fp)
    paths = {
        "AntMaze_UMaze-v5": (m_ant, [CS.pressed_state(torch, pipeline, m_ant, B, s, dev)
                                     for s in (1, 2)], None),
        "FetchPush-v4": (m_f, [d_f, d_fp], m_f.hull_vert),
    }
    for path, (m, ds, hv) in paths.items():
        tp = m.plan("pruned", collision._PrunedPlan)
        table = tp.table
        sels = [narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                        tp.mask, tp.K) for d in ds]
        d, sel = ds[0], sels[0]
        out = tuple(torch.empty_like(x) for x in (d.contact.dist, d.contact.pos,
                                                  d.contact.frame))
        ops = (d.geom_xpos, d.geom_xmat, m.geom_size, sel, hv)
        kinds = sorted({g.kind for g in table.groups})
        line = {"path": path, "B": B, "pairs": int(table.pairs.shape[1]),
                "rows": int(table.rows.numel()),
                "ms": CS.time_ms(torch, lambda: narrowphase.narrowphase(
                    table, *ops, out=out)),
                "by_kind_ms": {}, "card": card}
        for k in kinds:
            sub = table.only([k])
            line["by_kind_ms"][KIND_NAMES[k]] = CS.time_ms(
                torch, lambda: narrowphase.narrowphase(sub, *ops, out=out))
        if plib:
            lib = plib["narrowphase"]
            eq = []
            for dd, ss in zip(ds, sels):
                o = (dd.geom_xpos, dd.geom_xmat, m.geom_size, ss, hv)
                got = narrowphase.narrowphase(table, *o)
                ref = parent_narrowphase(lib, torch, table, *o,
                                         tuple(torch.full_like(x, float("nan"))
                                               for x in got))
                rows = table.rows
                eq.append(all(bits_equal(torch, g[rows], r[rows])
                              for g, r in zip(got, ref)))
            line["table_bitwise_equal_to_parent"] = eq
            p_out = tuple(torch.empty_like(x) for x in out)
            turns = []
            for who in ("parent", "tree", "tree", "parent"):
                fn = ((lambda: parent_narrowphase(lib, torch, table, *ops, p_out))
                      if who == "parent" else
                      (lambda: narrowphase.narrowphase(table, *ops, out=out)))
                turns.append((who, CS.time_ms(torch, fn)))
            line["turns_ms"] = turns
            # the Cholesky at this path's nv: qM / qfrc_smooth and the
            # Euler's damped system, on the main path's and pressed states
            slib = plib["solver"]
            systems = [(dd.qM, dd.qfrc_smooth) for dd in ds]
            systems.append(pipeline.damped_system(m, ds[0]))
            line["chol_nv"] = m.nv
            line["chol_bitwise_equal_to_parent"] = [
                bits_equal(torch, solver.solve_pos(*s), parent_chol(slib, torch, solver, *s))
                for s in systems]
            Ms, bs = systems[0]
            turns = []
            for who in ("parent", "tree", "tree", "parent"):
                fn = ((lambda: parent_chol(slib, torch, solver, Ms, bs))
                      if who == "parent" else (lambda: solver.solve_pos(Ms, bs)))
                turns.append((who, CS.time_ms(torch, fn)))
            line["chol_turns_ms"] = turns
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
