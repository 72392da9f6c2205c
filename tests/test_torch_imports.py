"""The port stands alone: no module of gymnasium_robotics_tpu_torch (nor
chip_smoke.py) imports jax or the JAX package, building the env leaves
neither in sys.modules, and no entry point falls back to the CPU unasked."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

import _port_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    p for p in glob.glob(
        os.path.join(REPO, "gymnasium_robotics_tpu_torch", "**", "*.py"),
        recursive=True)
    # _build/ holds what the kernel builds leave, not sources of the port
    if "_build" not in os.path.relpath(p, REPO).split(os.sep)
) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "gymnasium_robotics_tpu")


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    for name in _imported(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_building_the_env_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from gymnasium_robotics_tpu_torch import registry\n"
        "for id_, nu in (('PointMaze_UMaze-v3', 2), ('AntMaze_UMaze-v5', 8),\n"
        "                ('FetchPush-v4', 4)):\n"
        "    env = registry.make(id_, num_envs=4, device='cpu')\n"
        "    env.reset(seed=0)\n"
        "    env.step(torch.zeros(4, nu))\n"
        "hand = registry.make('HandManipulateBlock_ContinuousTouchSensors-v1',\n"
        "                     device='cpu')\n"
        "assert hand.obs_dim == 153\n"
        "slide = registry.make('FetchSlide-v4', device='cpu')\n"
        "assert slide.obs_dim == 25\n"
        "reach = registry.make_gym('FetchReach-v4', parity=True, device='cpu')\n"
        "reach.reset(seed=0)\n"
        "door = registry.make('AdroitHandDoor-v1', num_envs=2, device='cpu')\n"
        "door.reset(seed=0)\n"
        "assert door.step(torch.zeros(2, 28))[0].shape == (2, 39)\n"
        "hreach = registry.make_gym('HandReach-v3', parity=True, device='cpu')\n"
        "hreach.reset(seed=0)\n"
        "kitchen = registry.make('FrankaKitchen-v1', num_envs=2, device='cpu')\n"
        "kitchen.reset(seed=0)\n"
        "for id_ in ('HalfCheetah-v5', 'Humanoid-v2', 'Swimmer-v3'):\n"
        "    loco = registry.make(id_, num_envs=2, device='cpu')\n"
        "    loco.reset(seed=0)\n"
        "    loco.step(torch.zeros(2, loco.env.action_dim))\n"
        "registry.make_gym('InvertedPendulum-v5', device='cpu').reset(seed=0)\n"
        "from gymnasium_robotics_tpu_torch.physics import kinematics, pipeline\n"
        "m = env.env.model.with_options(fk_kernel=True)\n"
        "kinematics.kinematics(m, pipeline.make_data(m, 2))\n"
        "gym = registry.make_gym('PointMaze_UMaze-v3', parity=True, device='cpu')\n"
        "gym.reset(seed=0)\n"
        "gym.step([0.0, 0.0])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gymnasium_robotics_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_make_without_device_needs_a_card():
    from gymnasium_robotics_tpu_torch import registry

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make("PointMaze_UMaze-v3", num_envs=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_gym("PointMaze_UMaze-v3")


def test_unported_id_names_its_slice():
    from gymnasium_robotics_tpu_torch import registry

    with pytest.raises(KeyError, match="HandManipulateEgg slice"):
        registry.make("HandManipulateEgg-v1", num_envs=4, device="cpu")
    assert "PointMaze_UMaze-v3" in registry.ids()
    assert registry.spec("PointMaze_UMaze-v3").max_episode_steps == 300
    assert registry.spec("AntMaze_UMaze-v5").max_episode_steps == 700
