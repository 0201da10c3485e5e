"""TENDON_ACT (tests/torch_problems: nv 6, a limited ball joint on a hinge
chain, two fixed tendons coupled by a tendon equality, a site thruster, an
<intvelocity>, a <damper> and a filterexact <general> on a tendon; 26 rows)
through the port's general route, against the JAX package.

Inputs are seeded numpy states (tests/torch_problems.tendon_act_states)
handed to both packages; the port's Data is carried across with
tests/test_torch_general._to_port (act, ten_J and the other new fields
among them). One JAX model is loaded, in float64 (module-scope cache).

- compile: every field equal to model_from_numpy of the JAX compile (the
  tendon and wrap columns, length0 and invweight0, the activation layout,
  dynprm, actrange), 26 rows in K2's layout: 1 tendon equality, 2
  friction-loss rows (a dof's and t1's), 2 limit rows (the ball's and
  t1's), 7 condim-3 contact slots;
- float64 stages at 1e-12: ten_length, ten_J, ten_velocity, the
  transmissions (site, joint, tendon), act_dot, actuator forces,
  qfrc_passive (t1's spring with its deadband and its damping),
  qacc_smooth, and every efc row (J, D, R, aref, pos, margin,
  frictionloss, active exactly), each new row kind active in some env;
- whole steps with the same solver on both sides (ROADMAP C3): the port's
  general Newton (`ops/solver.newton`, the K2-sized layout's route to K2
  switched off) against `_solve_jnp`, 1 and 5 steps, qpos, qvel and act
  at 1e-9, qacc at 1e-6; and one step through K2's plain version, the
  route make_plan gives, against `_solve_jnp` (another Newton on the same
  rows); 1 and 3 steps on implicitfast (every term of its qDeriv);
- spatial tendons and muscles still raise by name; a CPU server serves
  nu 4 with set_ctrl, zeroes act on reset and resumes a checkpoint with
  act in it bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf
from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import (DynType, EqType, GainType,
                                                   IntegratorType, TrnType)
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from mujoco_ros_pkgs_tpu_torch.server import checkpoint
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _to_port
from tests.torch_problems import TENDON_ACT, tendon_act_states
from tests.torch_jax import jax_load

NENV = 6


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, port model, jitted vmapped JAX step), float64."""
    jm = jmjcf.load_model_from_string(TENDON_ACT)
    return (jm, mjcf.load_model_from_string(TENDON_ACT),
            jax.jit(jax.vmap(lambda d: jfwd.step(jm, d))))


def _batch(seed):
    jm = _models()[0]
    qpos, qvel, act, ctrl = tendon_act_states(NENV, seed)
    d1 = jfwd.make_data(jm)
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (NENV,) + x.shape), d1)
    return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), act=jnp.asarray(act),
                     ctrl=jnp.asarray(ctrl))


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_tendon_act_compiles_as_jax():
    """nv 6, nu 4 (site, intvelocity, damper, general on a tendon), na 2,
    two fixed tendons of two entries each, one tendon equality; 26 rows in
    K2's layout: 1 'eq', 2 'fri' (h1's dof, t1), 2 'lim' (the ball, t1),
    then 7 condim-3 slots; every field equal to the converted JAX
    compile."""
    jm, pm, _ = _models()
    assert (pm.nv, pm.nu, pm.na, pm.ntendon, pm.nwrap) == (6, 4, 2, 2, 4)
    assert pm.actuator_trntype == tuple(int(t) for t in (
        TrnType.SITE, TrnType.JOINT, TrnType.JOINT, TrnType.TENDON))
    assert pm.actuator_dyntype == tuple(int(t) for t in (
        DynType.NONE, DynType.INTEGRATOR, DynType.NONE, DynType.FILTEREXACT))
    assert pm.actuator_gaintype[2] == int(GainType.AFFINE)
    assert pm.actuator_actadr == (-1, 0, -1, 1) and pm.actuator_actlimited == (0, 1, 0, 1)
    assert pm.eq_type == (int(EqType.TENDON),) and pm.eq_obj2id == (0,)
    assert (pm.dof_floss_adr, pm.tendon_floss_adr) == ((3,), (0,))
    layout = efc.row_layout(pm)
    assert layout["nrow"] == 26 and layout["con"][0] == 5 and len(layout["con"]) == 7
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    np.testing.assert_allclose(pm.tendon_lengthspring[0].numpy(), [-0.1, 0.1])


_STAGES = ("ten_length", "ten_J", "ten_velocity", "site_xpos", "site_xmat",
           "actuator_length", "actuator_moment", "actuator_velocity", "actuator_force",
           "act_dot", "qfrc_actuator", "qfrc_passive", "qfrc_bias", "qacc_smooth")
_ROWS = ("J", "D", "R", "aref", "pos", "margin", "frictionloss")


def _stages(jd):
    """Both packages through the smooth stages and the efc rows, float64:
    (JAX data, JAX rows, port data, port rows)."""
    jm, pm, _ = _models()
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
    return jd, je, pd, efc.make_efc(pm, pd)


def test_tendon_act_stages_match_jax():
    """Every stage up to the rows at 1e-12 (float64): the tendons, the
    site, joint and tendon transmissions, act_dot (integrator: ctrl;
    filterexact: (ctrl - act) / tau) and the forces (the damper's affine
    gain), t1's spring and damping, and every row: the tendon equality
    with its quadratic polycoef, the friction-loss rows of h1 and t1, the
    ball's and t1's limit rows, the contacts; each row kind active in
    some env and the limits inactive in some."""
    jd, je, pd, pe = _stages(_batch(seed=1))
    for field in _STAGES:
        _close(f"tendon_act {field}", getattr(pd, field), getattr(jd, field), 1e-12)
    assert pe.kinds == je.kinds == ("eq", "fri", "fri", "lim", "lim") + ("con",) * 21
    assert (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    for field in _ROWS:
        _close(f"tendon_act efc.{field}", getattr(pe, field), getattr(je, field), 1e-12)
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))
    active = pe.active.numpy()
    assert active[:, :3].all() and active[:, 3:5].any(0).all() and not active[:, 3:5].all()
    assert pe.con_active.any(), "no contact"
    np.testing.assert_array_equal(pe.frictionloss[0, 1:3].numpy(), [0.05, 0.2])
    # t1's deadband: a spring force only outside [-0.1, 0.1]
    L = pd.ten_length[:, 0]
    assert bool(((L < -0.1) | (L > 0.1)).any() and ((L > -0.1) & (L < 0.1)).any())


def _no_k2(monkeypatch):
    """Switch the K2-sized layout's route to K2 off: the port then solves
    with its general Newton, the JAX package's `_solve_jnp` counterpart."""
    monkeypatch.setattr(solver_tpu, "supports", lambda e, nv: False)


@pytest.mark.parametrize("nsteps", [1, 5])
def test_tendon_act_steps_match_jax(monkeypatch, nsteps):
    """fwd.step against jax.vmap(fwd.step) in float64, the general Newton on
    both sides: qpos, qvel and act (the integrator's, and filterexact's
    exact update, clamped to actrange) within 1e-9, qacc within 1e-6,
    after 1 and 5 steps."""
    _no_k2(monkeypatch)
    _, pm, jstep = _models()
    jd = _batch(seed=2)
    pd = _to_port(jd)
    for _ in range(nsteps):
        jd, pd = jstep(jd), fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("act", 1e-9), ("qacc", 1e-6)):
        _close(f"tendon_act {field} after {nsteps}", getattr(pd, field),
               getattr(jd, field), tol)
    assert float(pd.qfrc_constraint.abs().max()) > 0.0
    # the clamped activation sits at its range's ends in some env
    assert bool((pd.act[:, 1].abs() == 0.5).any())


def test_tendon_act_k2_plain_step_matches_jax():
    """One float64 step on make_plan's route: the 26 rows go to K2's plain
    version (nv 6 <= 16, 26 <= 64 rows), `_solve_jnp` on the JAX side,
    another Newton on the same rows (both stop when a trip improves the
    cost by less than 1e-8 of its scale): qacc at rtol / atol 1e-6, qpos
    and qvel at 1e-8."""
    _, pm, jstep = _models()
    jd = _batch(seed=3)
    pd = _to_port(jd)
    e = efc.make_efc(pm, smooth.fwd_velocity_smooth(pm, collision.collide(
        pm, smooth.fwd_position_smooth(pm, pd))))
    assert solver_tpu.supports(e, pm.nv) and set(e.kinds) == {"eq", "fri", "lim", "con"}
    jd = jstep(jd)
    with pytest.warns(UserWarning, match="truncated"):
        pd = fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-8), ("qvel", 1e-8), ("qacc", 1e-6)):
        _close(f"tendon_act K2 plain {field}", getattr(pd, field), getattr(jd, field), tol)


def test_tendon_act_implicitfast_steps_match_jax(monkeypatch):
    """TENDON_ACT on implicitfast (both models edited), the general Newton
    on both sides: 1 and 3 steps against jax.vmap(fwd.step) in float64,
    qpos, qvel and act within 1e-9, qacc within 1e-6. Its qDeriv holds
    every term of _qderiv_smooth: joint damping, t1's damping through
    ten_J, the damper's affine gain (its ctrl clamped), the intvelocity's
    and the filterexact general's activations as their input and the
    general's affine bias."""
    _no_k2(monkeypatch)
    jm, pm, _ = _models()
    i = int(IntegratorType.IMPLICITFAST)
    jm = jm.replace(opt=jm.opt.replace(integrator=i))
    pm = dataclasses.replace(pm, opt=dataclasses.replace(pm.opt, integrator=i))
    jstep = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))
    jd = _batch(seed=4)
    pd = _to_port(jd)
    for k in range(1, 4):
        jd, pd = jstep(jd), fwd.step(pm, pd)
        if k in (1, 3):
            for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("act", 1e-9),
                               ("qacc", 1e-6)):
                _close(f"tendon_act implicitfast {field} after {k}", getattr(pd, field),
                       getattr(jd, field), tol)


# the cases keep the ids they had when the port refused spatial tendons and
# muscles: "spatial" now compiles; the muscles are ones whose lengthrange
# cannot be computed (a hinge with no range, a tendon nothing bounds), which
# both packages refuse
_RAISES = {
    "spatial": ('<tendon><spatial name="s"><site site="a"/><site site="b"/></spatial>'
                "</tendon>", None),
    "muscle": ('<actuator><muscle joint="j"/></actuator>', "joint has no range"),
    "general_muscle": ('<tendon><spatial name="s"><site site="a"/><site site="b"/>'
                       '</spatial></tendon><actuator><general tendon="s" dyntype="muscle" '
                       'gaintype="muscle" biastype="muscle"/></actuator>',
                       "nothing bounds the tendon"),
}


@pytest.mark.parametrize("case", sorted(_RAISES))
def test_spatial_tendons_and_muscles_raise(case):
    """A <spatial> tendon compiles as the JAX package compiles it (length0
    and invweight0 included) and plans on the general route; a <muscle> on
    a joint with no range and a <general> muscle on a tendon that nothing
    bounds raise ValueError at compile in both packages, naming why."""
    extra, match = _RAISES[case]
    xml = ('<mujoco><worldbody><body><joint name="j"/><geom type="sphere" size="0.1"/>'
           '<site name="a"/><site name="b" pos="0 0 0.1"/></body></worldbody>'
           f"{extra}</mujoco>")
    if match is None:
        pm = mjcf.load_model_from_string(xml)
        assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(
            jax_load(xml))))
        assert fwd.make_plan(pm) == fwd.GeneralPlan()
        return
    with pytest.raises(ValueError, match=match):
        mjcf.load_model_from_string(xml)
    with pytest.raises(ValueError, match=match):
        jax_load(xml)


def test_tendon_act_server_act_and_checkpoint(tmp_path):
    """MujocoServer(TENDON_ACT) on the CPU: set_ctrl takes nu 4, the
    activations integrate (the intvelocity's act += h ctrl), a checkpoint
    holds act and resumes bit for bit, reset zeroes act."""
    srv = MujocoServer(TENDON_ACT, nenv=3, device="cpu", unpause=False)
    assert not srv.set_ctrl(np.zeros(3)).success
    assert srv.set_ctrl(np.array([3.0, 0.8, 0.5, -0.6])).success
    assert srv.step(5).success
    act = srv.d.act.clone()
    assert act.shape == (3, 2) and bool((act[:, 0] > 0).all()) and bool((act[:, 1] < 0).all())
    checkpoint.save(srv, str(tmp_path / "ckpt"))
    assert srv.step(4).success
    after = (srv.d.qpos.clone(), srv.d.act.clone())
    checkpoint.load(srv, str(tmp_path / "ckpt"))
    assert torch.equal(srv.d.act, act)
    assert srv.step(4).success
    assert torch.equal(srv.d.qpos, after[0]) and torch.equal(srv.d.act, after[1])
    assert srv.reset().success and float(srv.d.act.abs().max()) == 0.0
