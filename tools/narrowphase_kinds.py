#!/usr/bin/env python3
"""The narrowphase kernel's time by group kind, on the card, and the
redesigned kernels against an earlier commit's.

    python3 tools/narrowphase_kinds.py [--parent DIR]

Builds csrc/narrowphase.cu, makes the arrays the main paths hand the kernel
at B = 2048 (AntMaze_UMaze-v5: the pressed state chip_smoke.py times it on;
FetchPush-v4 and FetchSlide-v4: the state after two env steps of
registry.make, then FetchSlide's pressed pucks, chip_smoke.slide_poses) and
at B = 1024 for the four Adroit tasks (the state after two env steps, then
the pressed hands of chip_smoke.adroit_pressed) and at B = 512 for
FrankaKitchen-v1 (the state after two env steps, then the pressed arms of
chip_smoke.kitchen_pressed), and times
the kernel on its whole group table and on each kind's pairs alone (the
table cut to that kind's columns, GroupTable.only), with CUDA events over a
CUDA graph of 50 launches as chip_smoke.py times kernels. Prints one JSON
line per path.

With --parent DIR (an unpacked checkout of an earlier commit), it also
builds that checkout's csrc/narrowphase.cu, csrc/solver.cu and
csrc/kinematics.cu, calls their entry points through the parent's C
interfaces (those of this tree, but grt_fk_f32 without the schedule and
shared memory bytes where the parent's source has the one-thread-an-env
kernel, and grt_narrowphase_f32 without the hull face table where it has
none) on the
same inputs (FetchSlide only where the parent has its kinds),
and prints
- whether the compact tables (on the main-path arrays and on the pressed
  states; on the Adroit and kitchen tables the rows of the kinds the
  parent has, the table cut to them, GroupTable.only) and the Cholesky
  solutions (nv = 14 and 21 on the main paths' qM and the Euler's damped
  system) are bitwise equal;
- whether the FK kernel's eleven outputs are bitwise equal on FetchPush's
  main-path poses (the state after two env steps) and on random poses, at
  B = 2048;
- the nv = 2 Newton solve of both routes (solve_newton at nv = 2, the
  Cholesky route; solve_newton_nv2, the determinant route) on the rows of
  PointMaze_UMaze-v3, PointMaze_Medium-v3 and PointMaze_Large-v3 (19, 39
  and 63 rows; balls pushed into the walls, B = 8192): the largest
  difference of qacc and of f from the parent's kernel;
with both versions' times taken in turns (parent, this tree, this tree,
parent): the FK kernel at FetchPush x 2048, the nv = 2 routes
at each row count, the determinant route also at B = 1.
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

B = 2048
KIND_NAMES = ("plane-sphere", "plane-capsule", "sphere-box", "capsule-box",
              "plane-box", "box-box", "plane-hull", "plane-cylinder",
              "cylinder-box", "cylinder-hull", "capsule-capsule",
              "capsule-cylinder", "cylinder-cylinder", "sphere-capsule",
              "capsule-hull")
ADROIT = {"AdroitHandDoor-v1": 14, "AdroitHandHammer-v1": 11,
          "AdroitHandPen-v1": 11, "AdroitHandRelocate-v1": 11}   # pressed seeds
KITCHEN_SEED = 15   # the kitchen's pressed arms (chip_smoke.kitchen_pressed)


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
    out["ptxas"] = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent {name}.cu: nvcc exited {p.returncode}\n{log}")
        out[name] = ctypes.CDLL(so)
        out["ptxas"].update({
            k: line.strip() for k, line in zip(
                (m for m in re.findall(r"Compiling entry function '(\S+)'", log)),
                (x for x in log.splitlines() if "Used" in x and "registers" in x))})
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    src = open(os.path.join(parent, "gymnasium_robotics_tpu_torch", "csrc",
                            "narrowphase.cu")).read()
    out["faces"] = "const float* hull_face" in src   # its C interface
    # the group kinds the parent's kernel has (its physics/narrowphase.py)
    psrc = open(os.path.join(parent, "gymnasium_robotics_tpu_torch", "physics",
                             "narrowphase.py")).read()
    kinds = re.search(r"^KINDS = \((.*?)\)\n# ", psrc, re.S | re.M).group(1)
    out["kinds"] = re.findall(r"\(T\.\w+, T\.\w+\)", kinds)
    out["narrowphase"].grt_narrowphase_f32.argtypes = (
        [vp] * 3 + [ll] * 3 + [vp] * 4 + [i] * 2 + [vp, i, i]
        + [vp] * 2 + [i] + ([vp, i] if out["faces"] else []) + [vp] * 3
        + [i, vp])
    out["narrowphase"].grt_narrowphase_f32.restype = i
    out["solver"].grt_chol_solve_f32.argtypes = [vp] * 4 + [i, i, i, vp]
    out["solver"].grt_chol_solve_f32.restype = i
    out["solver"].grt_newton_f32.argtypes = [vp] * 11 + [i] * 6 + [vp]
    out["solver"].grt_newton_f32.restype = i
    out["solver"].grt_newton2_f32.argtypes = [vp] * 11 + [i] * 4 + [vp]
    out["solver"].grt_newton2_f32.restype = i
    src = open(os.path.join(parent, "gymnasium_robotics_tpu_torch", "csrc",
                            "kinematics.cu")).read()
    out["fk_smem"] = "int B, int smem, void* stream" in src   # its C interface
    out["kinematics"].grt_fk_f32.argtypes = (
        [vp] * 9 + ([i, i, vp] if out["fk_smem"] else [i, vp]))
    out["kinematics"].grt_fk_f32.restype = i
    return out


def parent_narrowphase(lib, faces, torch, table, P, Rm, sizes3, sel, hull_vert,
                       hull_face, out):
    """The parent's narrowphase_kernel on the wrapper's operands, into out
    (``faces``: whether its interface takes the hull face table)."""
    nb = P.shape[-1]
    P, Rm = P.contiguous(), Rm.contiguous()
    sel = sel.to(torch.int32).contiguous()
    ss = sizes3.stride()
    rc = lib.grt_narrowphase_f32(
        P.data_ptr(), Rm.data_ptr(), sizes3.data_ptr(), ss[0], ss[1],
        ss[2] if sizes3.shape[-1] == nb else 0, sel.data_ptr(),
        table.pairs.data_ptr(), table.lens.data_ptr(), table.lists.data_ptr(),
        table.lists.shape[1], table.pairs.shape[1], table.tasks.data_ptr(),
        table.tasks.shape[0], int(table.boxes), table.geom_hull.data_ptr(),
        None if hull_vert is None else hull_vert.contiguous().data_ptr(),
        0 if hull_vert is None else hull_vert.shape[1],
        *((None if hull_face is None else hull_face.contiguous().data_ptr(),
           0 if hull_face is None else hull_face.shape[1]) if faces else ()),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), nb,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent narrowphase: {rc}"
    return out


def parent_chol(lib, torch, solver, M, b):
    nv, nb = b.shape
    x = torch.empty((nv, nb), dtype=torch.float32, device=b.device)
    rc = lib.grt_chol_solve_f32(M.data_ptr(), b.data_ptr(), x.data_ptr(),
                                solver._strides(M, b), nv, nb,
                                solver.chol_geometry(nv, nb)["smem"],
                                torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent chol: {rc}"
    return x


def parent_fk(lib, smem, torch, kinematics, m, d, out):
    """The parent's fk_kernel on d's poses, into out (the wrapper's
    (rows, B) buffer). ``smem``: whether its interface is this tree's (the
    scheduled kernel: the whole int table, the dims, the shared memory
    bytes); else the one-thread-an-env kernel, whose int table is this
    tree's without the schedule. The float table is the same."""
    mt = m.meta
    B = out.shape[1]
    tabs = m.plan("fk_kernel", kinematics._KernelTables)
    if smem:
        itab, dims = tabs.itab, tabs.dims
        tail = (kinematics.fk_geometry(mt, B)["smem"],)
    else:
        itab = tabs.itab[:4 * mt.nbody + 2 * mt.njnt + mt.ngeom + mt.nsite]
        dims = (ctypes.c_int * 5)(mt.nbody, mt.njnt, mt.nq, mt.ngeom, mt.nsite)
        tail = ()
    st = [x for t in (d.qpos, d.mocap_pos, d.mocap_quat) for x in t.stride()]
    rc = lib.grt_fk_f32(
        d.qpos.data_ptr(), d.mocap_pos.data_ptr(), d.mocap_quat.data_ptr(),
        (ctypes.c_longlong * 8)(*st), tabs.ftab.data_ptr(), itab.data_ptr(),
        dims, tabs.row_offs, out.data_ptr(), B, *tail,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent fk: {rc}"
    return out


def fk_buffer(torch, kinematics, d):
    """The eleven pose fields of d as one (rows, B) buffer."""
    B = d.qpos.shape[-1]
    return torch.cat([getattr(d, f).reshape(-1, B) for f in kinematics.FIELDS])


def fk_vs_parent(torch, lib, smem, kinematics, pipeline, fetch, d_main, card):
    """FK: bitwise equality with the parent's kernel on the main path's and
    random poses, and times in turns."""
    m = fetch.env.model
    mt = m.meta
    rs = np.random.RandomState(0)
    rand = pipeline.make_data(m, B)
    q = m.qpos0[:, 0].cpu().numpy()[:, None] + rs.normal(0, 0.5, (mt.nq, B))
    oq = fetch.env._obj_qadr + 3
    q[oq:oq + 4] = rs.normal(0, 1, (4, B))      # unnormalised
    dev = d_main.qpos.device
    rand.qpos[:] = torch.as_tensor(q, dtype=torch.float32, device=dev)
    rand.mocap_pos[:] = torch.as_tensor(rs.normal(0, 1, (1, 3, B)),
                                        dtype=torch.float32, device=dev)
    rand.mocap_quat[:] = torch.as_tensor(rs.normal(0, 1, (1, 4, B)),
                                         dtype=torch.float32, device=dev)
    tabs = m.plan("fk_kernel", kinematics._KernelTables)
    p_out = torch.empty((tabs.offs[-1], B), dtype=torch.float32, device=dev)
    eq = []
    for d in (d_main, rand):
        got = fk_buffer(torch, kinematics, kinematics.kinematics(m, d))
        ref = parent_fk(lib, smem, torch, kinematics, m, d,
                        torch.full_like(p_out, float("nan")))
        eq.append(bits_equal(torch, got, ref))
    turns = []
    for who in ("parent", "tree", "tree", "parent"):
        fn = ((lambda: parent_fk(lib, smem, torch, kinematics, m, d_main, p_out))
              if who == "parent" else (lambda: kinematics.kinematics(m, d_main)))
        turns.append((who, CS.time_ms(torch, fn)))
    return {"kernel": "fk", "B": B, "card": card,
            "bitwise_equal_to_parent_main_random": eq, "turns_ms": turns}


def nv2_vs_parent(torch, slib, solver, constraint, registry, dev, card):
    """The nv = 2 routes against the parent's kernels at 19, 39 and 63
    rows: the largest qacc and f differences, and times in turns (the
    determinant route also at B = 1)."""
    routes = (("chol", solver.solve_newton, slib.grt_newton_f32, (2,), (0,)),
              ("det", solver.solve_newton_nv2, slib.grt_newton2_f32, (), ()))
    lines = []
    for id_ in ("PointMaze_UMaze-v3", "PointMaze_Medium-v3", "PointMaze_Large-v3"):
        args, n_iter, n_ls, touching = CS.maze_rows(torch, dev, constraint,
                                                    registry, id_, CS.B)
        line = {"kernel": "newton nv=2", "id": id_, "ne": int(args[3].shape[0]),
                "B": CS.B, "envs_touching": touching, "card": card}
        for route, fn, entry, nv_arg, tail in routes:
            def parent(a=args):
                qacc, f, rc = solver._launch_newton(entry, nv_arg, *a, n_iter,
                                                    n_ls, tail)
                assert rc == 0, f"parent newton ({route}): {rc}"
                return qacc, f

            got, ref = fn(*args, n_iter=n_iter, n_ls=n_ls), parent()
            line[route] = {"max_abs_diff_qacc_f": [
                float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref)]}
            shapes = [("B", args)]
            if route == "det":
                shapes.append(("B1", tuple(x[..., :1] if x.dim() > 1 else x
                                           for x in args)))
            for label, a in shapes:
                turns = []
                for who in ("parent", "tree", "tree", "parent"):
                    call = ((lambda: parent(a)) if who == "parent" else
                            (lambda: fn(*a, n_iter=n_iter, n_ls=n_ls)))
                    turns.append((who, CS.time_ms(torch, call)))
                line[route][f"turns_ms_{label}"] = turns
        lines.append(line)
    return lines


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
        collision, constraint, kinematics, narrowphase, pipeline, solver)

    ptx = CS.ptxas_report(kernels.build())
    card = CS.card_line()
    print(json.dumps({"ptxas": {k: v for k, v in ptx.items()
                                if any(n in k for n in ("chol", "narrowphase",
                                                        "fk", "newton2"))}}),
          flush=True)
    dev = torch.device("cuda")
    plib = (build_parent(args.parent, ("narrowphase", "solver", "kinematics"))
            if args.parent else None)
    if plib:
        print(json.dumps({"parent_ptxas": {k: v for k, v in plib["ptxas"].items()
                                           if "narrowphase_kernel" in k}}),
              flush=True)

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
    slide = registry.make("FetchSlide-v4", num_envs=B)
    slide.reset(seed=0)
    for _ in range(2):
        slide.step(torch.rand((B, 4), generator=gen, device=dev) * 2 - 1)
    m_s = slide.env.model
    qpos, qvel = CS.slide_poses(slide.env, B, 1)
    d_sp = pipeline.make_data(m_s, B)
    d_sp.qpos[:] = torch.as_tensor(qpos, dtype=torch.float32, device=dev)
    d_sp = pipeline.forward(m_s, d_sp)
    paths = {
        "AntMaze_UMaze-v5": (m_ant, [CS.pressed_state(torch, pipeline, m_ant, B, s, dev)
                                     for s in (1, 2)], None),
        "FetchPush-v4": (m_f, [d_f, d_fp], m_f.hull_vert),
        "FetchSlide-v4": (m_s, [pipeline.forward(m_s, slide.state.data), d_sp],
                          m_s.hull_vert),
    }
    for id_, seed in ADROIT.items():
        env = registry.make(id_, num_envs=CS.ADROIT_B)
        env.reset(seed=0)
        for _ in range(2):
            env.step(torch.rand((CS.ADROIT_B, env.env.action_dim), generator=gen,
                                device=dev) * 2 - 1)
        m = env.env._model_for(env.state.aux)
        paths[id_] = (m, [pipeline.forward(m, env.state.data),
                          CS.adroit_pressed(torch, pipeline, env.env,
                                            CS.ADROIT_B, seed)[1]], None)
    kitchen = registry.make(CS.KITCHEN_ID, num_envs=CS.KITCHEN_B)
    kitchen.reset(seed=0)
    for _ in range(2):
        kitchen.step(torch.rand((CS.KITCHEN_B, 9), generator=gen, device=dev) * 2 - 1)
    m_k = kitchen.env.model
    paths[CS.KITCHEN_ID] = (m_k, [pipeline.forward(m_k, kitchen.state.data),
                                  CS.kitchen_pressed(torch, pipeline, kitchen.env,
                                                     CS.KITCHEN_B, KITCHEN_SEED)],
                            m_k.hull_vert)
    for path, (m, ds, hv) in paths.items():
        hf = None if hv is None else m.hull_face
        tp = m.plan("pruned", collision._PrunedPlan)
        table = tp.table
        nb = ds[0].qpos.shape[-1]
        sels = [narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                        tp.mask, tp.K) for d in ds]
        d, sel = ds[0], sels[0]
        out = tuple(torch.empty_like(x) for x in (d.contact.dist, d.contact.pos,
                                                  d.contact.frame))
        ops = (d.geom_xpos, d.geom_xmat, m.geom_size, sel, hv, hf)
        kinds = sorted({g.kind for g in table.groups})
        line = {"path": path, "B": nb, "pairs": int(table.pairs.shape[1]),
                "rows": int(table.rows.numel()),
                "ms": CS.time_ms(torch, lambda: narrowphase.narrowphase(
                    table, *ops, out=out)),
                "by_kind_ms": {}, "card": card}
        for k in kinds:
            sub = table.only([k])
            line["by_kind_ms"][KIND_NAMES[k]] = CS.time_ms(
                torch, lambda: narrowphase.narrowphase(sub, *ops, out=out))
        if plib and (plib["faces"] or path != "FetchSlide-v4"):
            lib, faces = plib["narrowphase"], plib["faces"]
            adroit = path in ADROIT or path == CS.KITCHEN_ID
            if adroit:   # the kinds the parent has; no Cholesky (nv 29-33)
                table = table.only([k for k in kinds if k < len(plib["kinds"])])
                line["parent_kinds"] = sorted({g.kind for g in table.groups})
            eq = []
            for dd, ss in zip(ds, sels):
                o = (dd.geom_xpos, dd.geom_xmat, m.geom_size, ss, hv, hf)
                got = narrowphase.narrowphase(table, *o)
                ref = parent_narrowphase(lib, faces, torch, table, *o,
                                         tuple(torch.full_like(x, float("nan"))
                                               for x in got))
                rows = table.rows
                eq.append(all(bits_equal(torch, g[rows], r[rows])
                              for g, r in zip(got, ref)))
            line["table_bitwise_equal_to_parent"] = eq
            p_out = tuple(torch.empty_like(x) for x in out)
            turns = []
            for who in ("parent", "tree", "tree", "parent"):
                fn = ((lambda: parent_narrowphase(lib, faces, torch, table,
                                                  *ops, p_out))
                      if who == "parent" else
                      (lambda: narrowphase.narrowphase(table, *ops, out=out)))
                turns.append((who, CS.time_ms(torch, fn)))
            line["turns_ms"] = turns
            if adroit:
                print(json.dumps(line), flush=True)
                continue
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
    if plib:
        print(json.dumps(fk_vs_parent(torch, plib["kinematics"], plib["fk_smem"],
                                      kinematics, pipeline, fetch,
                                      fetch.state.data, card)),
              flush=True)
        for line in nv2_vs_parent(torch, plib["solver"], solver, constraint,
                                  registry, dev, card):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
