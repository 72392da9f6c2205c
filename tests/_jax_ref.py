"""Shared by the port's test files that step JAX envs (pytest does not
collect it): the JAX package's env functions run op by op
(``jax.disable_jit``) around one compiled function, its batch-last substep
``soa.step`` (``SubstepRef``), or compiled with each model's substep
compiled apart and called back (``SubstepCallbacks``); and the TPU solver
kernels' bodies run op by op.

Compiling a whole JAX env step of the HandReach hand or the kitchen, or
running one of its substeps op by op, takes minutes on the CPU; the env
layer around the substep loop (actions, observations, rewards, noise,
resets, the kinematics refresh) takes seconds op by op. So ``substep_ref``
compiles the substep once, for a batch of B envs, and ``patched`` puts it
in place of both of the package's substep loops while the env functions
run op by op: ``soa.step``, which the batched loop (vmapped, under
``custom_vmap``) calls each substep, and ``pipeline.step_n_loop``, the
loop of one env (the Gymnasium adapter's), which runs as lane 0 of B
copies of that env. The arithmetic is the package's own: only the
compiled substep is run where its traced twin would have been."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gymnasium_robotics_tpu.physics import pipeline as jpipe
from gymnasium_robotics_tpu.physics import soa

# XLA's lowest backend optimisation level: changes how fast the compiler
# runs, not the arithmetic
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
_STEP = soa.step


def poisoned(d):
    """``d`` with every float leaf NaN: what a stand-in traced for shapes
    only returns, so that a path which reaches it with values (a call
    outside custom_vmap's batching rule) fails every comparison instead of
    passing its input through as a step."""
    return jax.tree_util.tree_map(
        lambda x: x * jnp.nan if jnp.issubdtype(jnp.result_type(x), jnp.floating)
        else x, d)


class SubstepRef:
    """soa.step of ``model`` (the package's Model, unbatched) for B envs,
    compiled at its first call on a batch-last Data."""

    def __init__(self, model, B: int):
        self.ms = soa._model_to_soa(model, None)
        self.B = B
        self._compiled = None

    def __call__(self, ds):
        if any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves(ds)):
            # a trace for shapes only (custom_vmap traces the loop it wraps
            # before its batching rule runs on the values): the substep
            # keeps every leaf's shape and dtype
            return poisoned(ds)
        with jax.disable_jit(False):
            if self._compiled is None:
                self._compiled = jax.jit(lambda d: _STEP(self.ms, d)).lower(
                    ds).compile(FAST_COMPILE)
            return self._compiled(ds)


class SubstepCallbacks:
    """The package's batch-last substep soa.step, compiled for each model
    layout and batch it is called with (its model as an argument, so a
    model rebound per env passes its own fields). Inside ``traced()``
    soa.step is a host callback to it, so that a jitted env step traces and
    compiles its env layer only, and calls the compiled substep each
    substep; the single env's loop, which custom_vmap traces for shapes
    only before its batching rule, returns its input with every float leaf
    NaN there (``poisoned``), so that a path reaching it with values fails
    every comparison. The arithmetic is the package's own."""

    def __init__(self):
        self._compiled = {}

    def run(self, ms, ds):
        """soa.step(ms, ds), compiled at the first call of its layout."""
        leaves, tree = jax.tree_util.tree_flatten((ms, ds))
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        f = self._compiled.get(key)
        if f is None:
            f = self._compiled[key] = jax.jit(_STEP).lower(ms, ds).compile(
                FAST_COMPILE)
        return f(ms, ds)

    def _callback(self, ms, ds):
        shapes = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ds)
        return jax.pure_callback(self.run, shapes, ms, ds)

    @contextlib.contextmanager
    def traced(self):
        def loop(m, d, ctrl, n):
            return poisoned(dataclasses.replace(d, ctrl=ctrl))

        saved = soa.step, jpipe.step_n_loop
        soa.step, jpipe.step_n_loop = self._callback, loop
        try:
            yield
        finally:
            soa.step, jpipe.step_n_loop = saved


def compiled_step(jb, *args):
    """A JAX BatchedEnv's step (``jb._step_fn``) compiled for ``args``
    around its model's substep, compiled apart and called back
    (SubstepCallbacks): the same arithmetic, about half the compile."""
    with SubstepCallbacks().traced():
        return jb._step_fn.lower(*args).compile(FAST_COMPILE)


def to_soa(d, B):
    """A JAX Data with B-leading leaves (a vmapped env's) -> batch-last."""
    return soa._data_to_soa(d, jax.tree_util.tree_map(lambda _: True, d), B)


def one_env_loop(ref):
    """pipeline.step_n_loop for one env: lane 0 of ref.B copies of it."""

    def loop(m, d, ctrl, n):
        d = dataclasses.replace(d, ctrl=ctrl)
        ds = soa._data_to_soa(d, jax.tree_util.tree_map(lambda _: False, d),
                              ref.B)
        for _ in range(n):
            ds = ref(ds)
        out = soa._data_from_soa(ds)
        lane0 = jax.tree_util.tree_map(lambda x: x[0], out)
        if d.contact.src is None:   # static slot ids stay unbatched
            lane0 = dataclasses.replace(lane0, contact=dataclasses.replace(
                lane0.contact, geom1=out.contact.geom1, geom2=out.contact.geom2))
        return lane0

    return loop


@contextlib.contextmanager
def patched(ref):
    """The package's substep loops run ``ref``'s compiled substep, and every
    jitted function runs op by op, inside the block."""
    saved = soa.step, jpipe.step_n_loop
    soa.step = lambda ms, d: ref(d)
    jpipe.step_n_loop = one_env_loop(ref)
    try:
        with jax.disable_jit():
            yield
    finally:
        soa.step, jpipe.step_n_loop = saved


def data_from_port(td, jT):
    """The port's batch-last Data as the package's batch-last Data (jT: the
    package's physics.types), through B-leading numpy leaves."""
    from gymnasium_robotics_tpu_torch import convert

    leaves = convert.data_to_numpy(td)
    c = leaves.pop("contact")
    B = td.qpos.shape[-1]
    ids = ("geom1", "geom2", "src")   # the package's slot ids are int32
    contact = jT.Contact(**{
        k: None if v is None else jnp.asarray(v, jnp.int32 if k in ids else None)
        for k, v in c.items()})
    d = jT.Data(**{k: jnp.asarray(v) for k, v in leaves.items()},
                contact=contact)
    return to_soa(d, B)


def state_to_numpy(s):
    """B-leading numpy leaves of a JAX EnvState (convert's input); obs and
    aux may be dicts of dicts."""
    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return np.asarray(x)

    d = s.data
    data = {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d) if f.name != "contact"}
    c = d.contact
    data["contact"] = {n: None if getattr(c, n) is None else np.asarray(getattr(c, n))
                       for n in ("dist", "pos", "frame", "geom1", "geom2", "src")}
    return dict(data=data, obs=tree(s.obs), reward=np.asarray(s.reward),
                terminated=np.asarray(s.terminated),
                truncated=np.asarray(s.truncated), info=tree(s.info),
                goal=np.asarray(s.goal), steps=np.asarray(s.steps),
                aux=tree(s.aux))


class _Ref:
    """A Pallas ref over an array, for running a kernel body op by op."""

    def __init__(self, a):
        self.a = jnp.asarray(a)

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)


def kernel_body_solves(nv, ne, n_iter, n_ls, seed, B=2):
    """Random rows at (nv, ne) and the TPU kernels' answers on them, run op
    by op with their lanes the batch (solver_pallas._kernel_nv and
    _kernel_chol; the interpret-mode pallas_call takes tens of seconds to
    trace at these nv): (the operands as float64 tensors in the port's
    layout, qacc, f, the Cholesky solve of M x = a_smooth), float64."""
    import torch

    rs = np.random.RandomState(seed)
    A = rs.normal(size=(nv, nv, B))
    M = np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None]
    asm, a0 = rs.normal(size=(nv, B)), rs.normal(size=(nv, B))
    J = rs.normal(size=(ne, nv, B)) * 0.3
    aref, D = rs.normal(size=(ne, B)), np.exp(rs.normal(size=(ne, B)))
    active = rs.uniform(size=(ne, B)) < 0.4
    is_eq = np.zeros(ne, bool)
    is_eq[:5] = True
    args = [torch.tensor(a) for a in (M, asm, a0, J, aref, D, active, is_eq)]
    return (args,) + kernel_bodies_on(args, n_iter, n_ls)


def kernel_bodies_on(args, n_iter, n_ls):
    """The TPU kernels' answers, run op by op with their lanes the batch
    (solver_pallas._kernel_nv and _kernel_chol), on the port's solve
    operands ``args`` (M (nv, nv, B), a_smooth, a_warm, J (ne, nv, B),
    aref, D, active, is_eq (ne,)): (qacc, f, the Cholesky solve of
    M x = a_smooth), float64 numpy."""
    from gymnasium_robotics_tpu.physics import solver_pallas as SP

    M, asm, a0, J, aref, D, active, is_eq = (
        a.detach().cpu().double().numpy() for a in args)
    ne, nv, B = J.shape
    tri = np.stack([M[i, j] for i in range(nv) for j in range(i + 1)])
    qacc, f = _Ref(np.zeros((nv, B))), _Ref(np.zeros((ne, B)))
    x = _Ref(np.zeros((nv, B)))
    with jax.disable_jit():
        SP._kernel_nv(nv, n_iter, n_ls, _Ref(tri), _Ref(asm), _Ref(a0),
                      _Ref(J.transpose(1, 0, 2)), _Ref(aref), _Ref(D),
                      _Ref(active), _Ref(np.broadcast_to(is_eq[:, None], (ne, B))),
                      qacc, f)
        SP._kernel_chol(nv, _Ref(tri), _Ref(asm), x)
    return np.asarray(qacc.a), np.asarray(f.a), np.asarray(x.a)
