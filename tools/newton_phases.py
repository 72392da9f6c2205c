#!/usr/bin/env python3
"""Where newton_tile_kernel's time goes, by phase, on the card.

    python3 tools/newton_phases.py

Builds a copy of gymnasium_robotics_tpu_torch/csrc/solver.cu with clock64()
marks at the Newton kernel's phase boundaries (read by thread 0 of block 0:
the lead lane of the first env of the first tile), runs the solve on random
rows at the AntMaze (nv = 14, 72 rows, 5 iterations) and FetchPush (nv = 21,
255 rows, 4 iterations) shapes, with B = 8 (one block alone on the card) and
B = 2048, and prints one JSON line per run with the SM cycles of each phase:
staging (J, M, vectors and rows, then the wait), the first Newton
iteration's steps (rows: x and M da; H: J^T D J and g; chol: the Cholesky
solve and p'Mp; line: J p and the line search), the later iterations
together, and the forces (rows, J^T f and the M solve). The copy and its
library go to gymnasium_robotics_tpu_torch/_build/. Needs a CUDA card and
nvcc; imports no JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (mark, text the mark goes before) in the kernel's source, in order
MARKS = (
    (0, "  const bool vec4 = s.J.b == 1"),
    (1, "  // M's lower triangle, from the (i, j) square"),
    (2, "  for (int idx = tid; idx < ET * VW; idx += nthr) {"),
    (3, "  cp_async_wait_all();\n  __syncthreads();\n  // this lane's rows"),
    (4, "  // this lane's rows r = u + LPE q: weight, aref and equality flag"),
    (5, "    // (2) H = M + J^T diag(Dw) J"),
    (6, "    // (3) the lead warp: p = -H^-1"),
    (7, "    // (4) J p on this lane's rows"),
    (8, "    // (5) a += alpha p"),
    (9, "  // forces on the final active set; unilateral rows pushed to f >= 0\n"
        "  float* F"),
    (10, "  __syncthreads();\n  for (int idx = tid; idx < ET * ne;"),
)
NAMES = ("J", "M", "vectors_rows", "wait", "iter0_rows", "iter0_H",
         "iter0_chol", "iter0_line", "later_iters", "forces")


def instrumented(src):
    head = ("__device__ long long g_marks[16];\n"
            "#define MARK(n) do { if (blockIdx.x == 0 && threadIdx.x == 0) "
            "g_marks[n] = clock64(); } while (0)\n")
    src = src.replace("namespace {", head + "namespace {", 1)
    for n, anchor in MARKS:
        assert src.count(anchor) == 1, f"anchor of mark {n} not found once"
        mark = f"  if (it == 0) MARK({n});\n" if 5 <= n <= 8 else f"  MARK({n});\n"
        src = src.replace(anchor, mark + anchor)
    return src.replace('extern "C" {', 'extern "C" {\nint grt_marks(long long* out) '
                       '{ return (int)cudaMemcpyFromSymbol(out, g_marks, '
                       'sizeof(g_marks)); }', 1)


def main():
    import torch

    from gymnasium_robotics_tpu_torch import kernels
    from gymnasium_robotics_tpu_torch.physics import solver

    if not torch.cuda.is_available():
        print("newton_phases: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernels.BUILD_DIR, "newton_phases.cu")
    lib_path = os.path.join(kernels.BUILD_DIR, "libnewton_phases.so")
    with open(os.path.join(kernels.CSRC, "solver.cu")) as fh:
        src = instrumented(fh.read())
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.grt_marks.argtypes = [ctypes.c_void_p]
    kernels.load = lambda name: lib
    solver._lib.cache_clear()
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for nv, ne, n_iter in ((14, 72, 5), (21, 255, 4)):
        for B in (8, 2048):
            A = rs.normal(size=(nv, nv, B))
            is_eq = np.zeros(ne, bool)
            is_eq[:6] = True
            args = [torch.as_tensor(np.asarray(x), device=dev,
                                    dtype=torch.bool if np.asarray(x).dtype == bool
                                    else torch.float32) for x in (
                np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None],
                rs.normal(size=(nv, B)), rs.normal(size=(nv, B)),
                rs.normal(size=(ne, nv, B)), rs.normal(size=(ne, B)),
                np.exp(rs.normal(size=(ne, B))), rs.uniform(size=(ne, B)) < 0.6,
                is_eq)]
            for _ in range(3):
                solver.solve_newton(*args, n_iter=n_iter, n_ls=4)
            torch.cuda.synchronize()
            marks = (ctypes.c_longlong * 16)()
            assert lib.grt_marks(marks) == 0
            m = list(marks)
            cycles = {name: m[i + 1] - m[i] for i, name in enumerate(NAMES)}
            print(json.dumps({"nv": nv, "ne": ne, "B": B, "n_iter": n_iter,
                              "n_ls": 4, "cycles": cycles,
                              "total": m[10] - m[0], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
