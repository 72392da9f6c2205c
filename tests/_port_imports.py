"""Shared by the tests/test_torch_imports*.py files (pytest does not
collect it): the port's Python files, each in one group, and the check
that none imports jax or the JAX package. The groups spread
test_no_jax_import's cases over three files: pytest-xdist's
``--dist loadfile`` starts the files with the most tests first, and a
file of more tests than the JAX suite's longest file would start ahead of
it; rebalance the groups when a slice adds many modules."""

import ast
import glob
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    p for p in glob.glob(
        os.path.join(REPO, "gymnasium_robotics_tpu_torch", "**", "*.py"),
        recursive=True)
    # _build/ holds what the kernel builds leave, not sources of the port
    if "_build" not in os.path.relpath(p, REPO).split(os.sep)
) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "gymnasium_robotics_tpu")


def group_of(path):
    """"physics" (physics/, the env base modules and the mazes), "envs"
    (the other env families) or "core" (the rest, chip_smoke.py too)."""
    parts = os.path.relpath(path, REPO).split(os.sep)
    if parts[0] != "gymnasium_robotics_tpu_torch" or len(parts) < 3:
        return "core"
    if parts[1] == "physics" or (parts[1] == "envs"
                                 and (len(parts) == 3 or parts[2] == "maze")):
        return "physics"
    return "envs" if parts[1] == "envs" else "core"


def files(group):
    return [p for p in PORT_FILES if group_of(p) == group]


def case_id(path):
    return os.path.relpath(path, REPO)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def check_no_jax_import(path):
    for name in _imported(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)
