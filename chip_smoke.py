#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gymnasium_robotics_tpu_torch) on one CUDA
card and check it: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel from csrc/ (one nvcc per source, in
     parallel) and prints the build seconds and ptxas' register report;
  3. main path: registry.make("PointMaze_UMaze-v3", num_envs=8192), reset,
     then 320 steps with random actions, past max_episode_steps=300 so every
     env auto-resets; the kernels' launch counters are zeroed just before
     and read just after, and must equal 2 Cholesky and 1 Newton launch per
     step; prints ms/step and env-steps/s;
  4. trace: 20 more steps of the same env timed on the host clock, then 20
     traced with torch.profiler; prints kernels per step, device busy time
     per step (the union of kernel intervals), the device's idle share of
     the traced wall time and device time by kernel name;
  5. reference: the same env stepped on the card and, through the plain
     versions, on the CPU from one carried-across state must agree;
  6. kernels: each kernel against its plain PyTorch version on the card at
     B = 8192 (random inputs from a numpy seed, and the main path's own
     rows, where balls touch walls), with CUDA-event times of the kernel,
     the plain version and, for the Cholesky, torch.linalg.solve;
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
TOL = 2e-4            # relative error, scaled by max(1, |ref|), float32
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_S = 67e12     # H100 SXM float32 rate outside the tensor cores


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


def main():
    import torch

    # --- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    from gymnasium_robotics_tpu_torch import convert, kernels, registry
    from gymnasium_robotics_tpu_torch.physics import constraint, solver

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

    # --- 3. main path
    for k in solver.LAUNCHES:
        solver.LAUNCHES[k] = 0
    env = registry.make("PointMaze_UMaze-v3", num_envs=B)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(B, dtype=torch.bool, device=dev)
    warm = 20
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
    ms_step = wall / (STEPS - warm) * 1e3
    assert obs["observation"].shape == (B, 4), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert not bool(info["diverged"].any()), "diverged envs"
    assert launches == {"chol": 2 * STEPS, "newton": STEPS}, launches
    print(f"main path: PointMaze_UMaze-v3 x{B}, {STEPS} steps, launches "
          f"{launches}; {ms_step:.4f} ms/step, "
          f"{B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{STEPS} "
          f"[{card}]", flush=True)

    # --- 4. trace of the same env: where the step's time goes
    from torch.autograd import DeviceType

    def run(n):
        for _ in range(n):
            env.step(torch.rand((B, 2), generator=gen, device=dev) * 2 - 1)

    n_tr = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n_tr)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n_tr * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(n_tr)
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
    print("trace: " + json.dumps({
        "steps": n_tr, "host_ms_per_step": host_ms,
        "traced_ms_per_step": traced_ms / n_tr,
        "device_busy_ms_per_step": busy_ms / n_tr,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "kernels_per_step": len(events) / n_tr, "card": card}), flush=True)
    for name, (c, ms) in top[:15]:
        print(f"  {ms / n_tr:9.4f} ms/step {c / n_tr:6.1f}x {name[:110]}")

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
    chol_err, chol_abs = 0.0, 0.0
    for args in ((M, b), (d.qM, d.qfrc_smooth)):
        xk, xp = solver.solve_pos(*args), solver.solve_pos_plain(*args)
        chol_err = max(chol_err, rel_err(xk, xp))
        chol_abs = max(chol_abs, float((xk - xp).abs().max()))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(M, b))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(M, b))
    Mb = M.permute(2, 0, 1).contiguous()
    bb = b.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb))
    nm = nv * (nv + 1) // 2
    chol_bound, chol_by = bound((nm + 2 * nv) * 4 * B, chol_ops(nv) * B)

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
    newton_err, newton_abs = 0.0, 0.0
    for args in (rand, real):
        qk, fk = solver.solve_newton(*args, n_iter=n_iter, n_ls=n_ls)
        qp, fp = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
        newton_err = max(newton_err, rel_err(qk, qp), rel_err(fk, fp))
        newton_abs = max(newton_abs, float((qk - qp).abs().max()),
                         float((fk - fp).abs().max()))
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(
        torch, lambda: solver.solve_newton_plain(*real, n_iter=n_iter,
                                                 n_ls=n_ls), n=10)
    # bytes: the lower triangle of M, a_smooth, a_warm, J, aref, D and f,
    # qacc as floats; active as bytes; is_eq one byte per model row
    newton_bound, newton_by = bound(
        (nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * B + ne * B + ne,
        newton_ops(nv, ne, n_iter, n_ls) * B)
    assert chol_err <= TOL, f"chol_solve: relerr {chol_err:.3e}"
    assert newton_err <= TOL, f"newton: relerr {newton_err:.3e}"
    print(f"kernels: {n_touching} of {B} envs touch a wall in the real rows",
          flush=True)

    src = "gymnasium_robotics_tpu_torch/csrc/solver.cu"
    kern = [
        dict(name="chol_solve", route="cuda", source=src,
             replaces="gymnasium_robotics_tpu/physics/solver_pallas.py:455",
             launches=launches["chol"], max_abs_err=chol_abs,
             max_rel_err=chol_err, tolerance=TOL, ms=chol_ms,
             kernel_ms=chol_ms, plain_ms=chol_plain_ms, bound_ms=chol_bound,
             bound_by=chol_by, library_ms=chol_lib_ms, shape=[nv, B]),
        dict(name="newton", route="cuda", source=src,
             replaces="gymnasium_robotics_tpu/physics/solver_pallas.py:249",
             launches=launches["newton"], max_abs_err=newton_abs,
             max_rel_err=newton_err, tolerance=TOL, ms=newton_ms,
             kernel_ms=newton_ms, plain_ms=newton_plain_ms,
             bound_ms=newton_bound, bound_by=newton_by, library_ms=None,
             shape=[nv, ne, B, n_iter, n_ls]),
    ]
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
