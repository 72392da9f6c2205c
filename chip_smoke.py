#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gymnasium_robotics_tpu_torch) on one CUDA
card and check it: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel from csrc/ (one nvcc per source, in
     parallel) and prints the build seconds and ptxas' register report;
  PointMaze_UMaze-v3 (the chol and Newton kernels at nv = 2):
  3. main path: registry.make("PointMaze_UMaze-v3", num_envs=8192), reset,
     then 320 steps with random actions, past max_episode_steps=300 so every
     env auto-resets; the kernels' launch counters are zeroed just before
     and read just after, and must equal 2 Cholesky and 1 Newton launch per
     step (and no narrowphase launch); prints ms/step and env-steps/s;
  4. trace: 20 more steps of the same env timed on the host clock, then 20
     traced with torch.profiler; prints kernels per step, device busy time
     per step (the union of kernel intervals), the device's idle share of
     the traced wall time and device time by kernel name;
  5. reference: the same env stepped on the card and, through the plain
     versions, on the CPU from one carried-across state must agree;
  6. kernels: each kernel against its plain PyTorch version on the card at
     B = 8192 (random inputs from a numpy seed, and the main path's own
     rows, where balls touch walls), with CUDA-event times of the kernel,
     the plain version and, for the Cholesky, torch.linalg.solve_ex;
  AntMaze_UMaze-v5 (all four kernels: chol and Newton at nv = 14,
  topk_select at two shapes, the narrowphase):
  7. main path: registry.make("AntMaze_UMaze-v5", num_envs=2048,
     max_episode_steps=50), reset, 60 steps with random actions, so every
     env auto-resets; per step 20 chol, 20 Newton, 40 topk_select (20 of
     each shape) and 20 narrowphase launches; prints ms/step and
     env-steps/s;
  8. trace: 8 steps traced, as in phase 4;
  9. reference: 8 envs on the card and on the CPU plain path from one
     carried-across state: within 2e-4 after 1 env step; the error after 5
     steps is printed, not gated (contact dynamics are chaotic);
  10. kernels: each AntMaze kernel against its plain version at B = 2048, on
     random inputs (forced ties for topk_select) and on the arrays of a
     state with the legs pressed into the walls (some capsule-box rows
     must penetrate), with CUDA-event times of the kernel, the plain version
     and, where one PyTorch call computes the same function, that call;
  then a JSON line of the kernels, the card line, and the last line
  {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

B = 8192
STEPS = 320
ANT_B = 2048
ANT_STEPS = 60
ANT_LIMIT = 50
TOL = 2e-4            # relative error, scaled by max(1, |ref|), float32
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_S = 67e12     # H100 SXM float32 rate outside the tensor cores
NP_SRC = "gymnasium_robotics_tpu_torch/csrc/narrowphase.cu"
SOLVER_SRC = "gymnasium_robotics_tpu_torch/csrc/solver.cu"
# float operations of one pair of each narrowphase group kind (plane-sphere,
# plane-capsule, sphere-box, capsule-box), counted from the formulas of
# csrc/narrowphase.cu, each slot's frame included
NARROW_OPS = (40, 90, 115, 366)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def rel_err(x, ref):
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / max(1.0, float(ref.abs().max())))


def time_ms(torch, fn, n=50, reps=5):
    """Device time of one call of fn: n calls captured in a CUDA graph, so
    the host's launch cost is left out, replayed reps times between CUDA
    events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def chol_ops(nv):
    """Floating-point operations of one floored LL^T solve, as the kernel
    does them (sub+mul per product, max+sqrt per pivot, one div each)."""
    fac = sum(2 * i + 2 + (nv - 1 - i) * (2 * i + 1) for i in range(nv))
    return fac + sum(2 * i + 1 for i in range(nv)) + sum(
        2 * (nv - 1 - i) + 1 for i in range(nv))


def newton_ops(nv, ne, n_iter, n_ls):
    """Floating-point operations of the Newton solve for one env, as the
    function defines them (solver_pallas._kernel_nv): per iteration x and
    J p once, and per line-search step x2 = x + alpha J p on every row."""
    nm = nv * (nv + 1) // 2
    mv = nv * (2 * nv - 1)                  # one symmetric product
    dot = 2 * nv - 1
    row = 2 * nv + 4 + 1 + nv + 2 * nv + 2 * nm   # x, Dw, gx, DJ, J^T gx, H
    ls = ne * (2 + 4 + 3 + 3) + 7                  # x2, Dw, s1, s2; alpha
    it = (nv + mv + ne * row + nm + 2 * nv + chol_ops(nv)  # da, Mda, rows, H, g
          + ne * dot + mv + 2 * dot + n_ls * ls + 2 + 2 * nv)
    final = ne * (2 * nv + 4 + 2 + 1 + 2 * nv) + chol_ops(nv) + nv
    return n_iter * it + final


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_row(name, source, replaces, launches, abs_err, rel, ms, plain_ms,
               bnd, library_ms, shape):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=abs_err, max_rel_err=rel,
                tolerance=TOL, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
                shape=shape)


def zero_counters(solver, narrowphase):
    for c in (solver.LAUNCHES, narrowphase.LAUNCHES):
        for k in c:
            c[k] = 0
    narrowphase.TOPK_SHAPES.clear()


def trace(torch, run, n, card, label):
    """n steps of ``run`` timed on the host clock, then n traced with
    torch.profiler: prints the per-step device numbers and the kernels by
    device time."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert events, "the trace holds no device time"
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in events]) / 1e3
    by_name = {}
    for e in events:
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"{label}: " + json.dumps({
        "steps": n, "host_ms_per_step": host_ms,
        "traced_ms_per_step": traced_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "kernels_per_step": len(events) / n, "card": card}), flush=True)
    ported = ("chol_solve_kernel", "newton_kernel", "newton_warp_kernel",
              "topk_select_kernel", "narrowphase_kernel")
    for i, (name, (c, ms)) in enumerate(top):
        if i < 15 or any(k in name for k in ported):
            print(f"  {ms / n:9.4f} ms/step {c / n:6.1f}x {name[:110]}")


def check_pair(fn, plain, inputs, outs=None):
    """(max rel err, max abs err) of a kernel's wrapper against its plain
    version over the input sets."""
    rel = ab = 0.0
    for args in inputs:
        got, ref = fn(*args), plain(*args)
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        for g, r in zip(got, ref):
            rel = max(rel, rel_err(g, r))
            ab = max(ab, float((g.double() - r.double()).abs().max()))
    return rel, ab


def pointmaze(torch, dev, card, solver, constraint, narrowphase, convert,
              registry):
    """Phases 3-6; returns the kernels' JSON rows."""
    # --- 3. main path
    env = registry.make("PointMaze_UMaze-v3", num_envs=B)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(B, dtype=torch.bool, device=dev)
    warm = 20
    zero_counters(solver, narrowphase)
    for i in range(STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((B, 2), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = dict(solver.LAUNCHES)
    np_launches = dict(narrowphase.LAUNCHES)
    ms_step = wall / (STEPS - warm) * 1e3
    assert obs["observation"].shape == (B, 4), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert not bool(info["diverged"].any()), "diverged envs"
    assert launches == {"chol": 2 * STEPS, "newton": STEPS}, launches
    assert not any(np_launches.values()), np_launches
    print(f"main path: PointMaze_UMaze-v3 x{B}, {STEPS} steps, launches "
          f"{launches}; {ms_step:.4f} ms/step, "
          f"{B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{STEPS} "
          f"[{card}]", flush=True)

    # --- 4. trace of the same env: where the step's time goes
    def run(n):
        for _ in range(n):
            env.step(torch.rand((B, 2), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 20, card, "trace")

    # --- 5. the card against the CPU plain path from one state
    small = 64
    env_g = registry.make("PointMaze_UMaze-v3", num_envs=small)
    env_c = registry.make("PointMaze_UMaze-v3", num_envs=small, device="cpu")
    env_g.reset(seed=3)
    env_c.reset(seed=3)
    rng = np.random.default_rng(0)
    dirs = rng.uniform(-1, 1, (small, 2))
    for _ in range(20):
        env_g.step(torch.as_tensor(dirs, dtype=torch.float32, device=dev))
    env_c.state = convert.env_state_from_numpy(
        convert.env_state_to_numpy(env_g.state), "cpu")
    ref_err = 0.0
    for _ in range(30):
        a = np.clip(dirs + rng.uniform(-0.3, 0.3, (small, 2)), -1, 1)
        a = a.astype(np.float32)
        og = env_g.step(torch.as_tensor(a, device=dev))[0]["observation"]
        oc = env_c.step(torch.as_tensor(a))[0]["observation"]
        ref_err = max(ref_err, rel_err(og.cpu(), oc))
    assert ref_err <= TOL, f"card vs CPU path: relerr {ref_err:.3e}"
    print(f"reference: card vs CPU plain path, {small} envs x 30 steps, "
          f"relerr {ref_err:.3e}", flush=True)

    # --- 6. kernels against their plain versions
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # Cholesky: random SPD systems and the main path's own qM
    nv = 2
    A = rs.normal(size=(nv, nv, B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.1 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, B)))
    d = env.state.data
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    ((M, b), (d.qM, d.qfrc_smooth)))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(M, b))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(M, b))
    Mb = M.permute(2, 0, 1).contiguous()
    bb = b.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb))
    nm = nv * (nv + 1) // 2
    chol_bound = bound((nm + 2 * nv) * 4 * B, chol_ops(nv) * B)

    # Newton: random systems (mixed is_eq/active) and the main path's rows
    m = env.env.model
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    ne = J.shape[0]
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    wall_rows = torch.tensor([m.meta.geom_type[g] == 6  # box
                              for g in d.contact.geom2.tolist()], device=dev)
    n_touching = int(active[wall_rows].any(dim=0).sum())
    assert n_touching > 0, "no ball touches a wall in the main path's state"
    rand = (
        M, cuda(rs.normal(size=(nv, B))), cuda(rs.normal(size=(nv, B))),
        cuda(rs.normal(size=(ne, nv, B))), cuda(rs.normal(size=(ne, B))),
        cuda(np.exp(rs.normal(size=(ne, B)))),
        cuda(rs.uniform(size=(ne, B)) < 0.7, torch.bool),
        cuda(rs.uniform(size=(ne, B)) < 0.2, torch.bool),
    )
    newton_err, newton_abs = check_pair(
        lambda *a: solver.solve_newton(*a, n_iter=n_iter, n_ls=n_ls),
        lambda *a: solver.solve_newton_plain(*a, n_iter=n_iter, n_ls=n_ls),
        (rand, real))
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(
        torch, lambda: solver.solve_newton_plain(*real, n_iter=n_iter,
                                                 n_ls=n_ls), n=10)
    # bytes: the lower triangle of M, a_smooth, a_warm, J, aref, D and f,
    # qacc as floats; active as bytes; is_eq one byte per model row
    newton_bound = bound(
        (nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * B + ne * B + ne,
        newton_ops(nv, ne, n_iter, n_ls) * B)
    assert chol_err <= TOL, f"chol_solve: relerr {chol_err:.3e}"
    assert newton_err <= TOL, f"newton: relerr {newton_err:.3e}"
    print(f"kernels: {n_touching} of {B} envs touch a wall in the real rows",
          flush=True)
    return [
        kernel_row("chol_solve", SOLVER_SRC,
                   "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
                   launches["chol"], chol_abs, chol_err, chol_ms,
                   chol_plain_ms, chol_bound, chol_lib_ms, [nv, B]),
        kernel_row("newton", SOLVER_SRC,
                   "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
                   launches["newton"], newton_abs, newton_err, newton_ms,
                   newton_plain_ms, newton_bound, None,
                   [nv, ne, B, n_iter, n_ls]),
    ]


def pressed_state(torch, pipeline, m, n, seed, dev):
    """A forwarded AntMaze state of n ants in the top-left cell, torso
    0.5-1.0 from its top or left wall and low, so that the legs press into
    the walls and the floor."""
    rs = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy()[:, 0], (n, 1))
    u = rs.uniform(0.5, 1.0, n)
    along = rs.uniform(-5.0, -3.0, n)
    top = np.arange(n) % 2 == 0
    qpos[:, 0] = np.where(top, along, -6.0 + u)
    qpos[:, 1] = np.where(top, 6.0 - u, along + 8.0)
    qpos[:, 2] = rs.uniform(0.25, 0.55, n)
    lo, hi = m.jnt_range.cpu().numpy()[1:, :, 0].T
    qpos[:, 7:] = rs.uniform(lo, hi, (n, len(lo)))
    d = pipeline.make_data(m, n)
    d.qpos[:] = torch.as_tensor(qpos.T, dtype=torch.float32, device=dev)
    d.qvel[:] = torch.as_tensor(rs.normal(0, 0.5, (m.nv, n)),
                                dtype=torch.float32, device=dev)
    return pipeline.forward(m, d)


def tie_ranks(rs, G, maxk, n):
    """Ranks on a coarse grid (many ties), with -inf and +inf entries, a
    mask that cuts group 0 short, and a lane with fewer finite ranks than
    any K."""
    rank = rs.randint(-4, 5, (G, maxk, n)).astype(np.float32) * 0.5
    rank[rs.uniform(size=rank.shape) < 0.03] = -np.inf
    rank[rs.uniform(size=rank.shape) < 0.05] = np.inf
    rank[:, 5:, 1] = np.inf
    mask = np.ones((G, maxk), bool)
    mask[0, maxk // 3:] = False
    return rank, mask


def antmaze(torch, dev, card, solver, constraint, narrowphase, collision,
            pipeline, convert, registry):
    """Phases 7-10; returns the kernels' JSON rows."""
    # --- 7. main path
    env = registry.make("AntMaze_UMaze-v5", num_envs=ANT_B,
                        max_episode_steps=ANT_LIMIT)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(ANT_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(ANT_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(ANT_B, dtype=torch.bool, device=dev)
    warm = 5
    zero_counters(solver, narrowphase)
    for i in range(ANT_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((ANT_B, 8), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {**solver.LAUNCHES, **narrowphase.LAUNCHES}
    shapes = dict(narrowphase.TOPK_SHAPES)
    ms_step = wall / (ANT_STEPS - warm) * 1e3
    n = ANT_STEPS
    assert obs["observation"].shape == (ANT_B, 105), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert launches == {"chol": 20 * n, "newton": 20 * n, "topk": 40 * n,
                        "narrowphase": 20 * n}, launches
    assert shapes == {(2, 216, 8): 20 * n, (1, 57, 16): 20 * n}, shapes
    print(f"main path: AntMaze_UMaze-v5 x{ANT_B}, {n} steps, limit "
          f"{ANT_LIMIT}, launches {launches}; {ms_step:.4f} ms/step, "
          f"{ANT_B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{n}; "
          f"{int(diverged.sum())} envs truncated as diverged [{card}]",
          flush=True)

    # --- 8. trace
    def run(k):
        for _ in range(k):
            env.step(torch.rand((ANT_B, 8), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 8, card, "ant trace")

    # --- 9. the card against the CPU plain path from one state
    small = 8
    env_g = registry.make("AntMaze_UMaze-v5", num_envs=small)
    env_c = registry.make("AntMaze_UMaze-v5", num_envs=small, device="cpu")
    env_g.reset(seed=3)
    env_c.reset(seed=3)
    rng = np.random.default_rng(0)
    for _ in range(20):   # down onto the floor
        env_g.step(torch.as_tensor(rng.uniform(-1, 1, (small, 8)),
                                   dtype=torch.float32, device=dev))
    env_c.state = convert.env_state_from_numpy(
        convert.env_state_to_numpy(env_g.state), "cpu")
    errs = []
    for _ in range(5):
        a = rng.uniform(-1, 1, (small, 8)).astype(np.float32)
        og = env_g.step(torch.as_tensor(a, device=dev))[0]
        oc = env_c.step(torch.as_tensor(a))[0]
        errs.append(max(rel_err(og[k].cpu(), oc[k]) for k in oc))
    assert errs[0] <= TOL, f"card vs CPU path after 1 step: relerr {errs[0]:.3e}"
    c = env_c.state.data.contact     # active where dist < includemargin
    n_contact = int((c.dist < env_c.env.model.con_includemargin[:, 0][c.src])
                    .any(dim=0).sum())
    print(f"ant reference: card vs CPU plain path, {small} envs, relerr "
          f"{errs[0]:.3e} after 1 step (gated), per step {errs} "
          f"(5 steps, not gated); {n_contact} envs in contact", flush=True)

    # --- 10. kernels against their plain versions, B = 2048
    m = env.env.model
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    d = pressed_state(torch, pipeline, m, ANT_B, 1, dev)
    d_rand = pressed_state(torch, pipeline, m, ANT_B, 2, dev)
    plan = collision.prune_plan(m.meta)
    cb = next(g for g in plan.groups if g.tp == (3, 6))    # capsule-box
    c = d.contact
    n_press = int((c.dist[cb.base_c:cb.base_c + cb.n_slots_c] < 0)
                  .any(dim=0).sum())
    assert n_press > 0, "no leg presses into a wall in the real state"
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    rows = []

    # topk_select at both shapes: forced ties, and the main path's ranks
    pen = c.dist - m.con_includemargin[:, 0][c.src]
    real_topk = {
        (2, 216, 8): (collision.broadphase_rank(m, d, tp), tp.mask),
        (1, 57, 16): (pen[rp.cap_rows], rp.cap_mask),
    }
    for (G, maxk, K), (rank, mask) in real_topk.items():
        r_rand, m_rand = tie_ranks(rs, G, maxk, ANT_B)
        sets = ((cuda(r_rand), cuda(m_rand, torch.bool)), (rank, mask))
        for r, mk in sets:
            got = narrowphase.topk_select(r, mk, K)
            assert torch.equal(got, narrowphase.topk_select_plain(r, mk, K)), \
                f"topk_select {(G, maxk, K)} indices differ"
        ms = time_ms(torch, lambda: narrowphase.topk_select(rank, mask, K))
        plain_ms = time_ms(torch, lambda: narrowphase.topk_select_plain(
            rank, mask, K), n=10)
        masked = torch.where(mask[:, :, None], rank, float("inf"))
        lib_ms = time_ms(torch, lambda: torch.topk(masked, K, dim=1,
                                                   largest=False))
        # bytes: ranks and mask read, indices written; one comparison per
        # entry at least
        bnd = bound(G * maxk * ANT_B * 4 + G * maxk + G * K * ANT_B * 4,
                    G * maxk * ANT_B)
        rows.append(kernel_row(
            f"topk_select_{G}x{maxk}_k{K}", NP_SRC,
            "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:155",
            shapes[(G, maxk, K)], 0.0, 0.0, ms, plain_ms, bnd, lib_ms,
            [G, maxk, ANT_B, K]))

    # narrowphase: random picks on other poses, and the main path's picks
    sel_real = torch.minimum(narrowphase.topk_select(
        collision.broadphase_rank(m, d, tp), tp.mask, tp.K), tp.sel_max)
    sel_rand = torch.stack([
        cuda(rs.randint(0, len(g.g1), (tp.K, ANT_B)), torch.int64)
        for g in tp.table.groups if g.sel_group >= 0])
    real_np = (tp.table, d.geom_xpos, d.geom_xmat, m.geom_size, sel_real)
    np_err, np_abs = check_pair(
        narrowphase.narrowphase, narrowphase.narrowphase_plain,
        ((tp.table, d_rand.geom_xpos, d_rand.geom_xmat, m.geom_size, sel_rand),
         real_np))
    np_ms = time_ms(torch, lambda: narrowphase.narrowphase(*real_np))
    np_plain_ms = time_ms(torch, lambda: narrowphase.narrowphase_plain(*real_np),
                          n=10)
    ngeom = m.meta.ngeom
    pair_ops = sum(NARROW_OPS[g.kind] * g.k for g in tp.table.groups)
    np_bound = bound((ngeom * 12 + sel_real.shape[0] * tp.K) * 4 * ANT_B
                     + tp.ncon * 13 * 4 * ANT_B, pair_ops * ANT_B)
    assert np_err <= TOL, f"narrowphase: relerr {np_err:.3e}"
    rows.append(kernel_row(
        "narrowphase", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, np_err, np_ms, np_plain_ms, np_bound,
        None, [tp.ncon, ANT_B]))

    # Cholesky at nv = 14: random SPD systems and the real qM
    nv = m.nv
    A = rs.normal(size=(nv, nv, ANT_B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, ANT_B)))
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    ((M, b), (d.qM, d.qfrc_smooth)))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(d.qM, d.qfrc_smooth))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(
        d.qM, d.qfrc_smooth), n=10)
    Mb = d.qM.permute(2, 0, 1).contiguous()
    bb = d.qfrc_smooth.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb))
    nm = nv * (nv + 1) // 2
    assert chol_err <= TOL, f"chol_solve nv=14: relerr {chol_err:.3e}"
    rows.append(kernel_row(
        "chol_solve_nv14", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
        launches["chol"], chol_abs, chol_err, chol_ms, chol_plain_ms,
        bound((nm + 2 * nv) * 4 * ANT_B, chol_ops(nv) * ANT_B), chol_lib_ms,
        [nv, ANT_B]))

    # Newton at nv = 14, 72 rows: random rows and the real ones
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    ne = J.shape[0]
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    rand = (M, cuda(rs.normal(size=(nv, ANT_B))),
            cuda(rs.normal(size=(nv, ANT_B))),
            cuda(rs.normal(size=(ne, nv, ANT_B))),
            cuda(rs.normal(size=(ne, ANT_B))),
            cuda(np.exp(rs.normal(size=(ne, ANT_B)))),
            cuda(rs.uniform(size=(ne, ANT_B)) < 0.6, torch.bool), is_eq)
    newton_err, newton_abs = check_pair(
        lambda *a: solver.solve_newton(*a, n_iter=n_iter, n_ls=n_ls),
        lambda *a: solver.solve_newton_plain(*a, n_iter=n_iter, n_ls=n_ls),
        (rand, real))
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(torch, lambda: solver.solve_newton_plain(
        *real, n_iter=n_iter, n_ls=n_ls), n=5)
    assert newton_err <= TOL, f"newton nv=14: relerr {newton_err:.3e}"
    rows.append(kernel_row(
        "newton_nv14", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches["newton"], newton_abs, newton_err, newton_ms,
        newton_plain_ms,
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * ANT_B
              + ne * ANT_B + ne, newton_ops(nv, ne, n_iter, n_ls) * ANT_B),
        None, [nv, ne, ANT_B, n_iter, n_ls]))
    n_active = int(active.any(dim=0).sum())
    print(f"ant kernels: {n_press} of {ANT_B} envs press a leg into a wall, "
          f"{n_active} have active rows; {ne} rows", flush=True)
    return rows


def main():
    import torch

    # --- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    from gymnasium_robotics_tpu_torch import convert, kernels, registry
    from gymnasium_robotics_tpu_torch.physics import (
        collision, constraint, narrowphase, pipeline, solver)

    dev = torch.device("cuda")

    # --- 2. build
    t0 = time.perf_counter()
    report = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    for name, (secs, log) in report.items():
        print(f"  {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("   ", line.strip())

    kern = pointmaze(torch, dev, card, solver, constraint, narrowphase,
                     convert, registry)
    kern += antmaze(torch, dev, card, solver, constraint, narrowphase,
                    collision, pipeline, convert, registry)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
