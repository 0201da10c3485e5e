"""The port's other integrators (ops/forward.implicitfast, implicit, rk4,
chosen by opt.integrator in fwd.step) against the JAX package.

Inputs are seeded numpy states handed to both packages (the port's Data
carried across with tests/test_torch_general._to_port); the JAX side runs
its step in float64 as fwd.step runs it (_jax_step: forward under jit,
compiled once a world, then the integrator's update), the hooked step as
jax.vmap(fwd.step) under jit. One JAX model is loaded per world; the
integrator is edited on both sides' models. Tolerances are relative to
each field's scale max(1, max |want|).

- TWO_HINGE (two damped hinges, a position and a velocity servo, after
  tests/test_integrators_geoms.py): implicitfast, implicit and RK4, qpos,
  qvel, qacc and time within 1e-12 after 1 step and 1e-10 after 5;
- GYRO (a spinning box on a ball joint, a hinged arm): implicit and
  implicitfast within 1e-10 after 5 steps, and apart from each other by
  more than 1e-6 in qvel (the gyroscopic derivative);
- the qDeriv masks (forward.qderiv_sparsity) against the JAX package's
  `_qderiv_sparsity` on the port's compile, with and without the
  simple-dof truncation, on PANDA_PICK_IF, HUMANOID and two trees coupled
  by a damped tendon (the coupling dropped); the implicit integrator's
  d qfrc_bias / d qvel (forward.bias_jacobian, by forward-mode AD) against
  jax.jacfwd of the JAX stages on GYRO, 1e-12 (PANDA_PICK_IF's step
  against the JAX package's is in tests/test_torch_panda.py, beside its
  JAX model);
- RK4 on PENDULUM with contacts, the general Newton on both sides (the
  fused Newton's gate patched off, ROADMAP C3): qpos and qvel within 1e-9,
  qacc within 1e-6 after 1 and 5 steps (the Newton's own stopping test on
  each side);
- RK4 with a stateful control hook: four hook calls a step on both sides,
  the same hook state and the same trajectory (1e-12);
- make_plan takes every integrator and solver on the general route, the
  fused route Euler and Newton alone, and still refuses fluid.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth
from mujoco_ros_pkgs_tpu.ops import solver_tpu as jsolver_tpu

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import IntegratorType, SolverType
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.models.humanoid import HUMANOID
from mujoco_ros_pkgs_tpu_torch.ops import smooth, solver_tpu, step_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from tests.test_torch_general import _jax_batch, _states, _to_port
from tests.torch_problems import (CROSS_TREE_TENDON, GYRO, GYRO_QVEL0, PANDA_PICK_IF,
                                  TWO_HINGE)
from tests.torch_jax import jax_load

NENV = 3
_XML = {"two_hinge": TWO_HINGE, "gyro": GYRO, "pendulum": worlds.PENDULUM}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, port model) of a world, float64."""
    return jax_load(_XML[name]), mjcf.load_model_from_string(_XML[name])


def _with(name, integrator):
    """Both models of a world with opt.integrator set."""
    jm, pm = _models(name)
    i = int(IntegratorType[integrator])
    return (jm.replace(opt=jm.opt.replace(integrator=i)),
            dataclasses.replace(pm, opt=dataclasses.replace(pm.opt, integrator=i)))


def _close(label, got, want, tol):
    """got against want within tol of want's scale max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=label)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """jfwd.forward of a world's model, per env, under jit: compiled once
    for every integrator (forward reads none) and vmapped by its callers."""
    jm = _models(name)[0]
    return jax.jit(lambda d: jfwd.forward(jm, d))


def _jax_step(name, jm):
    """The JAX package's step of model jm (world `name` with its integrator
    edited) on a batch, in fwd.step's order: forward, then rk4 (whose three
    forward calls are the same function), or the warm start set and
    implicit, implicitfast or euler. forward is compiled once per world,
    each integrator's update apart (one program of all of it takes the
    JAX compiler minutes a world on the CPU)."""
    forward = _jax_forward(name)
    integrator = jm.opt.integrator
    if integrator == int(IntegratorType.RK4):
        def rk4(d):
            real = jfwd.forward
            jfwd.forward = lambda m, dd, *hooks: forward(dd)
            try:
                return jax.vmap(lambda dd: jfwd.rk4(jm, dd))(d)
            finally:
                jfwd.forward = real
        return lambda d: rk4(jax.vmap(forward)(d))
    update = {int(IntegratorType.IMPLICIT): jfwd.implicit,
              int(IntegratorType.IMPLICITFAST): jfwd.implicitfast,
              int(IntegratorType.EULER): jfwd.euler}[integrator]
    after = jax.jit(jax.vmap(lambda d: update(jm, d.replace(qacc_warmstart=d.qacc))))
    return lambda d: after(jax.vmap(forward)(d))


def _steps(name, jm, pm, jd, tols, nsteps=(1, 5)):
    """_jax_step and fwd.step from the same batch: after each count of
    steps in nsteps, every field of tols within its tolerance."""
    jstep = _jax_step(name, jm)
    pd = _to_port(jd)
    for k in range(1, max(nsteps) + 1):
        jd, pd = jstep(jd), fwd.step(pm, pd)
        if k in nsteps:
            for field, tol in tols(k).items():
                _close(f"{field} after {k}", getattr(pd, field), getattr(jd, field), tol)
    return jd, pd


def _hinge_batch(jm, seed):
    rng = np.random.default_rng(seed)
    jd = _jax_batch(jm, 0.4 * rng.normal(size=(NENV, 2)), rng.normal(size=(NENV, 2)),
                    jnp.float64, seed=seed)
    return jd.replace(ctrl=jnp.asarray(rng.uniform(-1, 1, size=(NENV, 2))))


def _smooth_tols(k):
    tol = 1e-12 if k == 1 else 1e-10
    return {"qpos": tol, "qvel": tol, "qacc": tol, "time": tol}


@pytest.mark.parametrize("integrator", ["IMPLICITFAST", "IMPLICIT", "RK4"])
def test_two_hinge_steps_match_jax(integrator):
    """TWO_HINGE with random applied forces and ctrl: qpos, qvel, qacc and
    time within 1e-12 of each field's scale after 1 step, 1e-10 after 5."""
    jm, pm = _with("two_hinge", integrator)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    _, pd = _steps("two_hinge", jm, pm, _hinge_batch(jm, seed=1), _smooth_tols)
    assert bool(torch.isfinite(pd.qpos).all())


def test_gyroscopic_integrators_match_jax_and_differ():
    """GYRO spinning (qvel GYRO_QVEL0 and a random part): implicit and
    implicitfast within 1e-10 of each field's scale after 5 steps; their
    qvel apart by more than 1e-6 (implicit folds in d qfrc_bias / d qvel)."""
    rng = np.random.default_rng(2)
    qpos = np.zeros((NENV, 5))
    qpos[:, 0] = 1.0
    qvel = np.asarray(GYRO_QVEL0) + rng.normal(size=(NENV, 4))
    out = {}
    for integrator in ("IMPLICIT", "IMPLICITFAST"):
        jm, pm = _with("gyro", integrator)
        jd = _jax_batch(jm, qpos, qvel, jnp.float64)
        out[integrator] = _steps("gyro", jm, pm, jd, lambda k: {
            "qpos": 1e-10, "qvel": 1e-10, "qacc": 1e-10}, nsteps=(5,))[1]
    assert float((out["IMPLICIT"].qvel - out["IMPLICITFAST"].qvel).abs().max()) > 1e-6


@pytest.mark.parametrize("world", ["panda", "humanoid", "cross_tree"])
def test_qderiv_sparsity_matches_jax(world):
    """forward.qderiv_sparsity against the JAX package's _qderiv_sparsity
    on the port's compile, with (implicitfast) and without (implicit) the
    simple-dof truncation: PANDA_PICK_IF (the truncation drops the box's
    off-diagonal entries; its dof_simple is the JAX compile's,
    tests/test_torch_panda.py), HUMANOID, and the two tendon-coupled trees
    (no entry between them)."""
    xml = {"panda": PANDA_PICK_IF, "humanoid": HUMANOID, "cross_tree": CROSS_TREE_TENDON}
    pm = mjcf.load_model_from_string(xml[world])
    masks = []
    for truncate in (True, False):
        got = fwd.qderiv_sparsity(pm, truncate)
        np.testing.assert_array_equal(got, jfwd._qderiv_sparsity(pm, truncate))
        masks.append(got)
    assert (masks[0] <= masks[1]).all() and not masks[1].all()
    if world == "panda":
        assert masks[0].sum() < masks[1].sum() and pm.dof_simple
    if world == "cross_tree":
        assert not masks[1][0, 1] and masks[1].trace() == 2


def test_bias_jacobian_matches_jacfwd():
    """forward.bias_jacobian (forward-mode AD through com_vel and rne over
    B nv copies) against jax.jacfwd of the JAX package's com_vel + rne, on
    GYRO spinning (a ball joint's three dofs and a hinge), float64, 1e-12
    of its scale."""
    jm, pm = _models("gyro")
    rng = np.random.default_rng(3)
    q = rng.normal(size=(NENV, 5))
    q[:, :4] /= np.linalg.norm(q[:, :4], axis=1, keepdims=True)
    jd = _jax_batch(jm, q, np.asarray(GYRO_QVEL0) + 5 * rng.normal(size=(NENV, 4)),
                    jnp.float64)

    def jac(d):
        d = jsmooth.fwd_position_smooth(jm, d)

        def bias(v):
            return jsmooth.rne(jm, jsmooth.com_vel(jm, d.replace(qvel=v))).qfrc_bias
        return d, jax.jacfwd(bias)(d.qvel)
    jd, want = jax.jit(jax.vmap(jac))(jd)
    pd = smooth.fwd_position_smooth(pm, _to_port(jd))
    got = fwd.bias_jacobian(pm, pd)
    assert got.shape == (NENV, 4, 4) and float(got.abs().max()) > 1.0
    _close("d qfrc_bias / d qvel", got, want, 1e-12)


def _no_fused_newton(monkeypatch):
    """The fused Newton's gate off on both sides: the general Newton and
    `_solve_jnp` (ROADMAP C3)."""
    monkeypatch.setattr(solver_tpu, "supports", lambda e, nv: False)
    monkeypatch.setattr(jsolver_tpu, "supports", lambda e, nv: False)


def test_rk4_pendulum_with_contacts_matches_jax(monkeypatch):
    """RK4 on PENDULUM from seeded states in contact, the general Newton on
    both sides: qpos and qvel within 1e-9, qacc within 1e-6 of each field's
    scale after 1 and 5 steps; the warm start is stage 0's solution."""
    _no_fused_newton(monkeypatch)
    jm, pm = _with("pendulum", "RK4")
    qpos, qvel = _states(NENV, seed=4, tilt=0.8)
    jd, pd = _steps("pendulum", jm, pm, _jax_batch(jm, qpos, qvel, jnp.float64),
                    lambda k: {"qpos": 1e-9, "qvel": 1e-9, "qacc": 1e-6,
                               "qacc_warmstart": 1e-6})
    assert float(pd.qfrc_constraint.abs().max()) > 0.0
    assert torch.equal(pd.qacc, pd.qacc_warmstart)


def test_rk4_threads_a_stateful_hook():
    """RK4 with a control hook whose state counts its calls and scales
    ctrl: four calls a step on both sides (the JAX package's counted while
    its step is traced), the hook state 4 and 8 after 1 and 2 steps, and
    the trajectory within 1e-12 of each field's scale."""
    jm, pm = _with("two_hinge", "RK4")
    calls = {"jax": 0, "port": 0}

    def jhook(m, d, hs):
        calls["jax"] += 1
        return d.replace(ctrl=d.ctrl * (1.0 + 0.1 * hs)), hs + 1

    def phook(m, d, hs):
        calls["port"] += 1
        return d.replace(ctrl=d.ctrl * (1.0 + 0.1 * hs[:, None])), hs + 1
    jstep = jax.jit(jax.vmap(lambda d, hs: jfwd.step(jm, d, control_hook=jhook, hstate=hs)))
    jd = _hinge_batch(jm, seed=5)
    pd = _to_port(jd)
    jhs, phs = jnp.zeros(NENV), torch.zeros(NENV, dtype=torch.float64)
    for k in (1, 2):
        jd, jhs = jstep(jd, jhs)
        pd, phs = fwd.step(pm, pd, control_hook=phook, hstate=phs)
        assert calls == {"jax": 4, "port": 4 * k}, calls
        np.testing.assert_array_equal(phs.numpy(), np.asarray(jhs))
        assert float(phs[0]) == 4 * k
        for field in ("qpos", "qvel", "qacc", "ctrl"):
            _close(f"hooked {field} after {k}", getattr(pd, field), getattr(jd, field), 1e-12)


def test_make_plan_takes_every_integrator_and_solver():
    """make_plan: PENDULUM on the general route with each integrator and
    each solver; BOXES on the fused route with Euler and Newton only; a
    fluid medium (which raised when this test was written) on the general
    route too."""
    base = mjcf.load_model_from_string(worlds.PENDULUM)
    boxes = mjcf.load_model_from_string(worlds.BOXES)
    assert isinstance(fwd.make_plan(boxes), step_tpu.Plan)
    for integrator in IntegratorType:
        for solver in SolverType:
            opt = dict(integrator=int(integrator), solver=int(solver))
            m = dataclasses.replace(base, opt=dataclasses.replace(base.opt, **opt))
            assert fwd.make_plan(m) == fwd.GeneralPlan(), opt
            b = dataclasses.replace(boxes, opt=dataclasses.replace(boxes.opt, **opt))
            fused = integrator == IntegratorType.EULER and solver == SolverType.NEWTON
            assert isinstance(fwd.make_plan(b), step_tpu.Plan) == fused, opt
    fluid = mjcf.load_model_from_string(
        worlds.PENDULUM.replace("<option ", '<option integrator="implicit" density="1.2" ', 1))
    assert fluid.has_fluid and fwd.make_plan(fluid) == fwd.GeneralPlan()
