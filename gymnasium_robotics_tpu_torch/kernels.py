"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``_build/lib<name>-<hash>.so``,
and loaded with ``ctypes``. The hash covers the sources and the flags, so a
changed source is rebuilt at its next use. Nothing is built when the package
is imported: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_MAX = 232448

_LIBS: dict = {}


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(
        os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(p, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once. Returns {name: (seconds, compiler log)}; a source
    already built reports (0.0, "cached")."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            report[name] = (0.0, "cached")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def on_card(floats, masks=(), ints=()):
    """Whether a wrapper launches its kernel: False for CPU tensors (the
    plain version runs); True for CUDA tensors the kernels take (float32
    values, bool masks, integer indices, all on one card); raises for
    anything else."""
    dev = floats[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in (*floats, *masks, *ints):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
    for t in masks:
        if t.dtype != torch.bool:
            raise TypeError(f"the CUDA kernels take bool masks, got {t.dtype}")
    for t in ints:
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"the CUDA kernels take integer indices, got {t.dtype}")
    return True


def raise_on(rc, what):
    """Raise if a kernel's entry point returned a CUDA error (a refused
    launch) or -1 (no instantiation for the shape)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
