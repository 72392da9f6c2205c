"""The port's forward kinematics (gymnasium_robotics_tpu_torch.physics.
kinematics) against the JAX package's.

- kinematics_plain (the level pass) against soa.kinematics with
  fk_kernel=False and fk_jump=False (the JAX level pass) in float64, and
  against the port's pointer-jumping pass, on PointMaze, AntMaze and
  FetchPush poses (FetchPush with its mocap body) and on a small model with
  a ball joint: relative error scaled by max(1, |ref|) <= 1e-12 (the same
  operations, rounded in another order).
- kinematics_plain against the Pallas FK kernel
  (kinematics_pallas.kinematics in interpret mode, B = 128, its lane
  width) in float32 on PointMaze and AntMaze, at tests/test_soa.py's
  tolerance for that kernel (atol 5e-7, rtol 1e-6). Interpret mode costs
  tens of seconds a model here, so the ball-joint model is held against
  the level pass only (in float64, above) and the CUDA kernel on the card.
- The Option.fk_kernel gate of smooth.kinematics.
- The FK kernel's task schedule and launch geometry (kinematics.schedule,
  fk_geometry) on the PointMaze, AntMaze, FetchPush and ball-joint
  models, against the constants of csrc/kinematics.cu.

No shipped family has a ball joint, so the ball-joint model is compiled
here from a few lines of MJCF by the JAX importer (mujoco) and carried
across with convert.model_from_numpy.

The tests marked ``cuda`` hold the CUDA kernel (csrc/kinematics.cu) against
kinematics_plain on the card, within 2e-4; they skip where no card is
present. JAX is imported inside the tests, so those run where JAX is
missing."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import _port_cpu  # noqa: F401

from gymnasium_robotics_tpu_torch import convert, kernels, registry
from gymnasium_robotics_tpu_torch.physics import kinematics as KIN
from gymnasium_robotics_tpu_torch.physics import pipeline as tpipe
from gymnasium_robotics_tpu_torch.physics import smooth as tsm

TOL64 = 1e-12
TOL32 = 2e-4

BALL_XML = """
<mujoco>
  <worldbody>
    <body name="arm" pos="0 0 1" quat="0.96 0 0.28 0">
      <joint name="lift" type="slide" axis="0 0 1"/>
      <joint name="yaw" type="hinge" axis="0 0.6 0.8" pos="0.1 0 0"/>
      <geom type="capsule" size="0.05 0.2" pos="0.1 0 0" quat="0.7 0.7 0 0"/>
      <body name="cup" pos="0.3 0.1 0" quat="0.9 0.1 0.3 0.3">
        <joint name="ball" type="ball" pos="0.05 0 0.02"/>
        <geom type="sphere" size="0.08" pos="0.1 0 0"/>
        <site name="tip" pos="0.2 0.05 0" quat="0.8 0 0.6 0"/>
        <body name="finger" pos="0.25 0 0">
          <inertial pos="0.02 0.01 0" quat="0.6 0.8 0 0" mass="0.1"
                    diaginertia="1e-3 2e-3 3e-3"/>
          <joint name="bend" type="hinge" axis="1 0 0" pos="0 0.02 0"/>
          <geom type="box" size="0.05 0.02 0.02" pos="0.05 0 0"/>
        </body>
      </body>
    </body>
    <body name="block" pos="0.5 -0.5 0.2">
      <freejoint/>
      <geom type="box" size="0.1 0.1 0.1"/>
    </body>
    <body name="target" mocap="true" pos="1 1 1" quat="0.6 0 0 0.8">
      <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""


def rel_err(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(x - ref).max() / max(1.0, np.abs(ref).max()))


@functools.lru_cache(maxsize=None)
def jax_model(name, dtype_name):
    """The JAX package's model of ``name`` in the named float dtype."""
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.envs.maze.ant_maze import AntMazeEnv
    from gymnasium_robotics_tpu.envs.maze.point_maze import PointMazeEnv
    from gymnasium_robotics_tpu.mjcf import import_mjcf
    from gymnasium_robotics_tpu.mjcf import serialize as jser

    dtype = np.dtype(dtype_name)
    if name == "pointmaze":
        return PointMazeEnv(dtype=jnp.dtype(dtype)).model
    if name == "antmaze":
        return AntMazeEnv(dtype=jnp.dtype(dtype)).model
    if name == "fetchpush":
        return jser.load_asset("fetch/push", dtype=dtype)[0]
    return import_mjcf.import_xml_string(BALL_XML, dtype=dtype)


def port_model(m, dtype, device="cpu"):
    from gymnasium_robotics_tpu.mjcf import serialize as jser

    return convert.model_from_numpy(
        {f.name: np.asarray(getattr(m, f.name))
         for f in dataclasses.fields(m)
         if f.name not in ("meta", "fk_np") and getattr(m, f.name) is not None},
        jser._meta_to_json(m.meta), dtype, device)


def poses(meta, qpos0, B, seed):
    """(qpos (B, nq), mocap_pos (B, nmocap, 3), mocap_quat (B, nmocap, 4)):
    qpos0 moved by N(0, 0.5), free and ball quaternions drawn away from
    unit length (the kinematics normalise them), mocap poses at random."""
    rs = np.random.RandomState(seed)
    q = np.tile(np.asarray(qpos0, np.float64), (B, 1)) + rs.normal(
        0, 0.5, (B, meta.nq))
    for j, jt in enumerate(meta.jnt_type):
        if jt in (0, 1):  # free, ball
            a = meta.jnt_qposadr[j] + (3 if jt == 0 else 0)
            q[:, a:a + 4] = rs.normal(0, 1, (B, 4)) * rs.uniform(0.5, 2, (B, 1))
    return (q, rs.normal(0, 1, (B, meta.nmocap, 3)),
            rs.normal(0, 1, (B, meta.nmocap, 4)))


def jax_fk(m, fk, pose):
    """``fk(m_soa, d_soa)`` (a JAX FK) at ``pose``, with the SoA Data built
    and the FK run in one jitted call."""
    import jax
    import jax.numpy as jnp

    from gymnasium_robotics_tpu.physics import pipeline as jpipe
    from gymnasium_robotics_tpu.physics import soa

    dt = m.qpos0.dtype
    B = pose[0].shape[0]
    ms = soa._model_to_soa(m, None)

    def run(q, mp, mq):
        d0 = jpipe.make_data(m, dtype=dt)
        db = jax.vmap(lambda a, b, c: dataclasses.replace(
            d0, qpos=a, mocap_pos=b, mocap_quat=c))(q, mp, mq)
        return fk(ms, soa._data_to_soa(
            db, jax.tree_util.tree_map(lambda _: True, db), B))

    return jax.jit(run)(*(jnp.asarray(x, dt) for x in pose))


def port_data(m, pose):
    q, mp, mq = pose
    d = tpipe.make_data(m, q.shape[0])

    def t(x):
        return torch.tensor(x, dtype=m.qpos0.dtype, device=m.device)

    return dataclasses.replace(d, qpos=t(q.T), mocap_pos=t(np.moveaxis(mp, 0, -1)),
                               mocap_quat=t(np.moveaxis(mq, 0, -1)))


def field_errs(got, ref):
    """{field: rel err} over the eleven pose fields; ``ref`` a JAX SoA Data
    or a port Data."""
    return {f: rel_err(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)))
            for f in KIN.FIELDS}


@pytest.mark.parametrize("name", ["pointmaze", "antmaze", "fetchpush", "ball"])
def test_level_pass_matches_jax_f64(name):
    from gymnasium_robotics_tpu.physics import soa

    jm = jax_model(name, "float64")
    pose = poses(jm.meta, jm.qpos0, 8, seed=len(name))
    ref = jax_fk(jm, lambda ms, d: soa.kinematics(
        ms.with_options(fk_kernel=False, fk_jump=False), d), pose)
    m = port_model(jm, torch.float64)
    d = port_data(m, pose)
    got = KIN.kinematics_plain(m, d)
    errs = field_errs(got, ref)
    assert max(errs.values()) <= TOL64, errs
    jump = field_errs(tsm.kinematics_jump(m, d), got)
    assert max(jump.values()) <= TOL64, jump
    if name in ("fetchpush", "ball"):  # the mocap override took effect
        mb = m.meta.body_mocapid.index(0)
        assert torch.equal(got.xpos[mb], d.mocap_pos[0])


@pytest.mark.parametrize("name", ["pointmaze", "antmaze"])
def test_plain_matches_pallas_f32(name):
    from gymnasium_robotics_tpu.physics import kinematics_pallas as KP

    jm = jax_model(name, "float32")
    pose = poses(jm.meta, jm.qpos0, 128, seed=7)

    def fk(ms, d):
        assert KP.supported(ms, d)
        return KP.kinematics(ms, d, interpret=True)

    ref = jax_fk(jm, fk, pose)
    m = port_model(jm, torch.float32)
    got = KIN.kinematics_plain(m, port_data(m, pose))
    for f in KIN.FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   atol=5e-7, rtol=1e-6, err_msg=f"{name} {f}")


def test_fk_kernel_gate(monkeypatch):
    """fk_kernel True or "force" takes kinematics.kinematics (on CPU
    tensors its plain version, the level pass); False and "auto" on the CPU
    take the pointer-jumping pass; a tree past 36 bodies or a model batched
    per env is not supported, and fk_jump=False takes the level pass."""
    env = registry.make("FetchPush-v4", device="cpu", dtype=torch.float64)
    m = env.model
    d = port_data(m, poses(m.meta, m.qpos0[:, 0].numpy(), 3, seed=0))
    level = KIN.kinematics_plain(m, d)
    jump = tsm.kinematics_jump(m, d)
    calls = []
    orig = KIN.kinematics

    def spy(mm, dd):
        calls.append(mm.meta.opt.fk_kernel)
        return orig(mm, dd)

    monkeypatch.setattr(KIN, "kinematics", spy)
    for fk, via_kernel in ((True, True), ("force", True), (False, False),
                           ("auto", False)):
        out = tsm.kinematics(m.with_options(fk_kernel=fk), d)
        ref = level if via_kernel else jump
        assert all(torch.equal(getattr(out, f), getattr(ref, f))
                   for f in KIN.FIELDS), fk
    assert calls == [True, "force"]
    out = tsm.kinematics(m.with_options(fk_jump=False), d)
    assert all(torch.equal(getattr(out, f), getattr(level, f)) for f in KIN.FIELDS)
    assert KIN.supported(m)
    batched = dataclasses.replace(m, body_pos=m.body_pos.expand(-1, -1, 3))
    assert not KIN.supported(batched)
    big = dataclasses.replace(m, meta=dataclasses.replace(
        m.meta, nbody=KIN.MAX_BODIES + 1))
    assert not KIN.supported(big)
    # On the card a model the kernel does not take raises; it does not
    # fall through to the pointer-jumping or level pass.
    monkeypatch.setattr(kernels, "on_card", lambda *a, **k: True)
    for fk in (True, "force"):
        with pytest.raises(NotImplementedError, match="FK kernel"):
            tsm.kinematics(big.with_options(fk_kernel=fk), d)
        with pytest.raises(NotImplementedError, match="FK kernel"):
            tsm.kinematics(batched.with_options(fk_kernel=fk), d)
    assert calls[2:] == [True, True, "force", "force"]


@pytest.mark.parametrize("name", ["pointmaze", "antmaze", "fetchpush", "ball"])
def test_fk_schedule_covers_tree(name):
    """fk_kernel's schedule: every body but the world once, in a step after
    its parent's; every xmat, inertial, geom and site frame once, in a step
    after its body's; the tables' lengths as the kernel computes them; a
    block's shared memory within kernels.SMEM_MAX; the tile, slot count and
    task kinds as csrc/kinematics.cu has them."""
    import os
    import re

    if name == "ball":
        m = port_model(jax_model("ball", "float32"), torch.float32)
    else:
        ids = {"pointmaze": "PointMaze_UMaze-v3", "antmaze": "AntMaze_UMaze-v5",
               "fetchpush": "FetchPush-v4"}
        m = registry.make(ids[name], num_envs=1, device="cpu").env.model
    mt = m.meta
    steps = KIN.schedule(mt)
    at = {}
    for s, step in enumerate(steps):
        assert len(step) <= KIN.FK_SLOTS or all(k == 0 for k, _ in step)
        assert step == sorted(step)
        for task in step:
            assert task not in at, task
            at[task] = s
    body_step = {0: -1, **{b: at.pop((0, b)) for b in range(1, mt.nbody)}}
    for b in range(1, mt.nbody):
        assert body_step[b] > body_step[mt.body_parentid[b]], b
    frames = ([((1, b), b) for b in range(mt.nbody)]
              + [((2, b), b) for b in range(mt.nbody)]
              + [((3, i), b) for i, b in enumerate(mt.geom_bodyid)]
              + [((4, i), b) for i, b in enumerate(mt.site_bodyid)])
    for task, b in frames:
        assert at.pop(task) > body_step[b], task
    assert not at, at                      # nothing else is scheduled
    assert len(steps) <= max(len(mt.levels), 2)
    tabs = KIN._KernelTables(m)
    assert (tabs.ftab.numel(), tabs.itab.numel()) == KIN.table_sizes(mt)
    geo = KIN.fk_geometry(mt, 2047)
    tile = KIN.FK_TILE
    assert geo["smem"] <= kernels.SMEM_MAX
    assert (geo["grid"] - 1) * tile < 2047 <= geo["grid"] * tile
    assert geo["threads"] == KIN.FK_SLOTS * tile
    src = open(os.path.join(kernels.CSRC, "kinematics.cu")).read()
    assert int(re.search(r"constexpr int kFkSlots = (\d+);", src).group(1)) == KIN.FK_SLOTS
    assert int(re.search(r"constexpr int kFkTile = (\d+);", src).group(1)) == tile
    kinds = re.search(r"enum \{ BODY = 0, XMAT = 1, INERTIAL = 2, GEOM = 3, SITE = 4 \};",
                      src)
    assert kinds and KIN.TASK_KINDS == ("body", "xmat", "inertial", "geom", "site")
    # the gate's largest tree, every joint free, fits a block
    big = dataclasses.replace(mt, nbody=KIN.MAX_BODIES, nq=7 * KIN.MAX_BODIES)
    assert KIN.fk_geometry(big, 1)["smem"] <= kernels.SMEM_MAX


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_errs(m, d):
    n0 = KIN.LAUNCHES["fk"]
    got = KIN.kinematics(m, d)
    torch.cuda.synchronize()
    assert KIN.LAUNCHES["fk"] == n0 + 1
    ref = KIN.kinematics_plain(m, d)
    return {f: rel_err(getattr(got, f).cpu(), getattr(ref, f).cpu())
            for f in KIN.FIELDS}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """fk_kernel against kinematics_plain on FetchPush poses at B = 2048
    (random, and a stepped batch's own) and on the ball-joint model, whose
    model is built from the shipped JAX-free assets where JAX is missing:
    FetchPush only then."""
    B = 2048
    env = registry.make("FetchPush-v4", num_envs=B, device=cuda_device)
    env.env.model = m = env.env.model.with_options(fk_kernel=True)
    env.reset(seed=0)
    n0 = KIN.LAUNCHES["fk"]
    env.step(torch.zeros((B, 4), device=cuda_device))
    # 20 substeps' forwards, the blocked gripper's refresh, the auto-reset's
    assert KIN.LAUNCHES["fk"] == n0 + 22
    for d in (env.state.data,
              port_data(m, poses(m.meta, m.qpos0[:, 0].cpu().numpy(), B, 1))):
        errs = card_errs(m, d)
        assert max(errs.values()) <= TOL32, errs
    try:
        jm = jax_model("ball", "float32")
    except ImportError:
        return
    mb = port_model(jm, torch.float32, cuda_device)
    errs = card_errs(mb, port_data(mb, poses(jm.meta, jm.qpos0, B, 2)))
    assert max(errs.values()) <= TOL32, errs


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda_device):
    """fk_kernel at the edges of its launch, on FetchPush's stepped and
    random poses, against kinematics_plain, every env within 2e-4: B = 1, 33
    (a partial tile) and 2047, qpos given batch-leading (batch stride
    nq); the wrapper's shared memory bytes held to the source's."""
    B = 2048
    env = registry.make("FetchPush-v4", num_envs=B, device=cuda_device)
    m = env.env.model
    env.reset(seed=0)
    env.step(torch.zeros((B, 4), device=cuda_device))
    rand = port_data(m, poses(m.meta, m.qpos0[:, 0].cpu().numpy(), B, 3))
    for d in (env.state.data, rand):
        for n in (1, 33, 2047):
            q = d.qpos[:, :n].T.contiguous().T       # strides (1, nq)
            dn = dataclasses.replace(d, qpos=q, mocap_pos=d.mocap_pos[..., :n],
                                     mocap_quat=d.mocap_quat[..., :n])
            n0 = KIN.LAUNCHES["fk"]
            got = KIN.kinematics(m, dn)
            torch.cuda.synchronize()
            assert KIN.LAUNCHES["fk"] == n0 + 1
            ref = KIN.kinematics_plain(m, dn)
            for f in KIN.FIELDS:
                g, r = getattr(got, f).cpu().double(), getattr(ref, f).cpu().double()
                per_env = ((g - r).abs().reshape(-1, n).amax(dim=0)
                           / r.abs().max().clamp(min=1.0))
                assert float(per_env.max()) <= TOL32, (n, f)
    tabs = m.plan("fk_kernel", KIN._KernelTables)
    assert KIN._lib().grt_fk_smem_bytes(tabs.dims) == KIN.fk_geometry(m.meta, 1)["smem"]
