"""PANDA_PICK (tests/torch_problems: a Panda-style 7-DoF arm with a
tendon-coupled two-finger gripper and a free box on the floor; nv 15, 102
rows) through the port's general route, against the JAX package.

Inputs are seeded numpy states (tests/torch_problems.panda_states: the
pads around the box at its height, the fingers open, some past their
limits, or closed on the box) handed to both packages; the port's Data is carried across with
tests/test_torch_general._to_port. One JAX model is loaded, in float64
(module-scope cache).

- compile: nv 15, nu 8 (seven joint servos, one `<general>` on the
  `split` tendon), one joint equality, one limited tendon; 102 rows: 1
  'eq', 7 'fri', 10 'lim' (9 joints, the tendon), 28 condim-3 slots;
  every field equal to model_from_numpy of the JAX compile (within 1e-12
  of each value's size);
- float64 stages at 1e-12 (within 1e-12 of each field's scale: the box's
  rotational terms reach 1e4): the tendon, the servos' and the tendon
  actuator's forces, qacc_smooth, and every efc row, friction-loss, limit
  and tendon rows active in some env;
- whole steps through fwd.step against jax.vmap(fwd.step), both solving
  the 102 rows with the general Newton (`_solve_jnp`): qpos and qvel
  within 1e-9 and qacc within 1e-6 of each field's scale after 1 and 5
  steps;
- MujocoServer(PANDA_PICK) on the CPU: set_ctrl of nu 8, the gripper
  closed by its tendon;
- PANDA_PICK_IF (panda.xml's own integrator, implicitfast, edited on
  both models): one step through fwd.step against jax.vmap(fwd.step),
  qpos and qvel within 1e-9, qacc within 1e-6 of each field's scale, and
  not Euler's step; the simple dofs that implicitfast's mask truncates
  are the JAX compile's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import IntegratorType, TrnType
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _to_port
from tests.torch_problems import (PANDA_CLOSED, PANDA_OPEN, PANDA_PICK, PANDA_PICK_IF,
                                  panda_grasp, panda_states)
from tests.torch_jax import jax_load

NENV = 4


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, port model, jitted vmapped JAX step), float64."""
    jm = jax_load(PANDA_PICK)
    return (jm, mjcf.load_model_from_string(PANDA_PICK),
            jax.jit(jax.vmap(lambda d: jfwd.step(jm, d))))


def _batch(seed):
    jm, pm, _ = _models()
    qpos, qvel, ctrl = panda_states(pm, NENV, seed)
    d1 = jfwd.make_data(jm)
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (NENV,) + x.shape), d1)
    return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def _close(name, got, want, tol):
    """got against want within tol of want's scale max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=name)


def test_panda_compiles_as_jax():
    """nv 15 (7 arm hinges, 2 finger slides, the box's free joint), nu 8,
    the `split` tendon (0.5 of each finger, limited to 0..0.04) driven by
    actuator8; 102 rows: the fingers' equality, the arm's 7 friction-loss
    rows, 9 joint limits and the tendon's, then 28 condim-3 slots; the
    general route; every field equal to the converted JAX compile."""
    jm, pm, _ = _models()
    assert (pm.nv, pm.nu, pm.na, pm.ntendon, pm.neq) == (15, 8, 0, 1, 1)
    assert pm.actuator_trntype == (int(TrnType.JOINT),) * 7 + (int(TrnType.TENDON),)
    assert pm.dof_floss_adr == tuple(range(7)) and pm.tendon_limited == (1,)
    layout = efc.row_layout(pm)
    assert layout["nrow"] == 102 and layout["con"][0] == 18 and len(layout["con"]) == 28
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)), rtol=1e-12)
    np.testing.assert_array_equal(pm.actuator_gainprm[:7, 0].numpy(),
                                  [4500, 4500, 3500, 3500, 2000, 2000, 2000])
    np.testing.assert_allclose(pm.tendon_invweight0.numpy(),
                               np.asarray(jm.tendon_invweight0), rtol=1e-12)


_STAGES = ("qpos", "xpos", "xmat", "geom_xpos", "ten_length", "ten_J", "ten_velocity",
           "qM", "actuator_length", "actuator_moment", "actuator_velocity",
           "actuator_force", "qfrc_actuator", "qfrc_passive", "qfrc_bias", "qacc_smooth")
_ROWS = ("J", "D", "R", "aref", "pos", "margin", "frictionloss")


def test_panda_stages_match_jax():
    """Every stage up to the rows within 1e-12 of each field's scale
    (float64): the pads around the box, the arm's servos and the tendon
    actuator (its gear-scaled moment 0.5 on each finger), every row row
    by row; the equality and friction-loss rows active in every env, the
    finger and tendon limits in some, the pads on the box where the
    gripper is closed."""
    jm, pm, _ = _models()
    jd = _batch(seed=1)
    pd = _to_port(jd)

    def jrows(d):
        d = jcollision.collide(jm, jsmooth.fwd_position_smooth(jm, d))
        d = jsmooth.fwd_acceleration_smooth(
            jm, jsmooth.actuation(jm, jsmooth.fwd_velocity_smooth(jm, d)))
        return d, jefc.make_efc(jm, d)
    jd, je = jax.jit(jax.vmap(jrows))(jd)
    pd = collision.collide(pm, smooth.fwd_position_smooth(pm, pd))
    pd = smooth.fwd_acceleration_smooth(
        pm, smooth.actuation(pm, smooth.fwd_velocity_smooth(pm, pd)))
    pe = efc.make_efc(pm, pd)
    for field in _STAGES:
        _close(f"panda {field}", getattr(pd, field), getattr(jd, field), 1e-12)
    assert pe.kinds == je.kinds
    assert pe.kinds[:18] == ("eq",) + ("fri",) * 7 + ("lim",) * 10
    assert (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    for field in _ROWS:
        _close(f"panda efc.{field}", getattr(pe, field), getattr(je, field), 1e-12)
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))
    np.testing.assert_array_equal(pd.actuator_moment[0, 7, 7:9].numpy(), [0.5, 0.5])
    active = pe.active.numpy()
    assert active[:, :8].all(), "the equality and friction-loss rows are always on"
    assert active[:, 15:18].any(0).all(), "no finger or tendon limit active"
    assert bool(pe.con_active[1::2].any(1).all()), "a closed gripper not on the box"


@pytest.mark.parametrize("nsteps", [1, 5])
def test_panda_steps_match_jax(nsteps):
    """fwd.step against jax.vmap(fwd.step) in float64, both solving the 102
    rows with the general Newton: qpos and qvel within 1e-9 and qacc within
    1e-6 of each field's scale after 1 and 5 steps."""
    _, pm, jstep = _models()
    jd = _batch(seed=2)
    pd = _to_port(jd)
    for _ in range(nsteps):
        jd, pd = jstep(jd), fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("qacc", 1e-6)):
        _close(f"panda {field} after {nsteps}", getattr(pd, field), getattr(jd, field), tol)
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


def test_panda_grasp_pose_and_server():
    """panda_grasp puts the pads' midpoint over the box's place, the hand
    pointing down; MujocoServer(PANDA_PICK) on the CPU takes set_ctrl of nu
    8 and steps finite from the grasp pose (set_qpos); the gripper's ctrl at
    PANDA_OPEN lengthens the `split` tendon, at PANDA_CLOSED shortens it
    again."""
    pm = _models()[1]
    q = panda_grasp(pm)
    srv = MujocoServer(PANDA_PICK, nenv=2, device="cpu", unpause=False)
    qpos = pm.qpos0.numpy().copy()
    qpos[:7] = q
    assert srv.set_qpos(qpos, zero_qvel=True).success
    assert not srv.set_ctrl(np.zeros(7)).success
    lengths = []
    for gripper in (PANDA_OPEN, PANDA_CLOSED):
        assert srv.set_ctrl(np.append(q, gripper)).success
        assert srv.step(30).success
        d = srv.d
        assert all(bool(torch.isfinite(t).all()) for t in (d.qpos, d.qvel, d.qacc, d.ten_length))
        lengths.append(d.ten_length[:, 0].clone())
    assert bool((lengths[0] > 0.005).all()) and bool((lengths[1] < lengths[0]).all()), lengths


def test_panda_pick_if_step_matches_jax():
    """PANDA_PICK_IF: PANDA_PICK with integrator="implicitfast" (both
    models edited; the XML of tests/torch_problems.PANDA_PICK_IF compiles
    to it), one float64 step from seeded grasp states on both sides'
    general Newton, qpos and qvel within 1e-9, qacc within 1e-6 of each
    field's scale; the servos' velocity terms make it differ from Euler's
    step; dof_simple, whose off-diagonals implicitfast's mask drops, is
    the JAX compile's."""
    jm, pm, _ = _models()
    i = int(IntegratorType.IMPLICITFAST)
    jm = jm.replace(opt=jm.opt.replace(integrator=i))
    euler, pm = pm, dataclasses.replace(pm, opt=dataclasses.replace(pm.opt, integrator=i))
    assert mjcf.load_model_from_string(PANDA_PICK_IF).opt.integrator == i
    assert pm.dof_simple == tuple(int(v) for v in jm.dof_simple) and pm.dof_simple
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    jd = _batch(seed=6)
    pd = _to_port(jd)
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    got = fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("qacc", 1e-6)):
        _close(f"panda implicitfast {field}", getattr(got, field), getattr(jd, field), tol)
    assert float((fwd.step(euler, pd).qvel - got.qvel).abs().max()) > 1e-6
