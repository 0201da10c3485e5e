"""HUMANOID (nv 27, 21 limited hinges, 21 torque motors) through the port's
general route, against the JAX package.

Inputs are seeded numpy states handed to both packages (the port's Data is
carried across with tests/test_torch_general._to_port); on the CPU the
port's K1 and K2 calls run their plain versions. One JAX model is loaded
per dtype and world (module-scope caches).

- compile: nv 27, nu 21, 21 limited joints, 408 rows (21 limit rows, then
  129 elliptic condim-3 contacts), the general route; every field,
  actuator fields included, equal to model_from_numpy of the JAX compile;
- float64 stages at 1e-12 on states with hinges pushed past their ranges
  and ctrl drawn from [-1.5, 1.5] (some clamp): transmission (length,
  moment, velocity), actuation (force, qfrc_actuator) and every efc row
  (J, D, R, aref, pos, margin, active), the limit rows first;
- one float32 fwd.step of HUMANOID in floor contact with limits active,
  against jax.vmap(fwd.step) at tests/test_torch_pile.py's tolerances;
- a PENDULUM with two limited hinges and two motors (forcerange,
  actuatorfrcrange), whose 35 rows K2's plain version solves: its
  actuation at 1e-12 and one float64 step against the JAX package's
  `_solve_jnp` (another Newton on the same rows);
- what the port does not run raises by name; the server's set_ctrl.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.models.humanoid import HUMANOID as JHUMANOID
from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.models.humanoid import HUMANOID
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, narrowphase, smooth, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _states as pendulum_states
from tests.test_torch_general import _to_port
from tests.torch_problems import PENDULUM_LIMITED, humanoid_states as _states_of
from tests.torch_jax import jax_load

NENV = 4
_XML = {"humanoid": HUMANOID, "pendulum": PENDULUM_LIMITED}


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    """(JAX model, port model) of a world in float64 or float32."""
    jdt, pdt = {"f64": (None, None), "f32": (jnp.float32, torch.float32)}[dtype]
    return (jax_load(_XML[name], dtype=jdt),
            mjcf.load_model_from_string(_XML[name], dtype=pdt))


def humanoid_states(nenv, seed, drop=0.0):
    """tests/torch_problems.humanoid_states of the port's float64 HUMANOID."""
    return _states_of(_models("humanoid", "f64")[1], nenv, seed, drop)


def _jax_batch(jm, qpos, qvel, ctrl, dtype):
    d1 = jfwd.make_data(jm, dtype=dtype)
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (qpos.shape[0],) + x.shape),
                               d1)
    return d.replace(qpos=jnp.asarray(qpos, dtype), qvel=jnp.asarray(qvel, dtype),
                     ctrl=jnp.asarray(ctrl, dtype))


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_humanoid_compiles_as_jax():
    """nv 27, nu 21, 21 limited hinges; 408 rows: 21 limit rows, then 129
    contact slots of elliptic condim 3; the general route; every field of
    the port's compile equal to the converted JAX compile, the actuator
    fields among them."""
    assert HUMANOID == JHUMANOID, "the port's copy of HUMANOID drifted"
    jm, pm = _models("humanoid", "f64")
    assert (pm.nv, pm.nu, pm.na, sum(pm.jnt_limited)) == (27, 21, 0, 21)
    layout = efc.row_layout(pm)
    assert layout["nrow"] == 408 and layout["con"][0] == 21
    assert len(narrowphase.slot_meta(pm)[0]) == 129 and set(layout["con_nrows"]) == {3}
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    cm = model_from_numpy(*jax_model_to_numpy(jm))
    assert_models_equal(pm, cm)
    assert pm.actuator_names == jm.actuator_names
    assert pm.actuator_trnid == tuple(map(tuple, jm.actuator_trnid))
    assert all(pm.actuator_ctrllimited) and not any(pm.actuator_forcelimited)
    np.testing.assert_array_equal(pm.actuator_gear[:, 0].numpy(),
                                  np.asarray(jm.actuator_gear)[:, 0])


def _stages(name, jm, pm, jd):
    """Both packages up to the efc rows, float64: (JAX data, JAX rows, port
    data, port rows)."""
    pd = _to_port(jd)

    def jrows(d):
        d = jsmooth.fwd_position_smooth(jm, d)
        d = jcollision.collide(jm, d)
        d = jsmooth.actuation(jm, jsmooth.fwd_velocity_smooth(jm, d))
        return d, jefc.make_efc(jm, d)
    jd, je = jax.jit(jax.vmap(jrows))(jd)
    pd = smooth.fwd_position_smooth(pm, pd)
    pd = smooth.actuation(pm, smooth.fwd_velocity_smooth(pm, collision.collide(pm, pd)))
    return jd, je, pd, efc.make_efc(pm, pd)


_ACT = ("actuator_length", "actuator_moment", "actuator_velocity", "actuator_force",
        "qfrc_actuator")
_ROWS = ("J", "D", "R", "aref", "pos", "margin", "frictionloss")


@pytest.mark.parametrize("name", ["humanoid", "pendulum"])
def test_actuation_and_rows_match_jax(name):
    """transmission, actuation and every efc row at 1e-12 (float64), with
    ctrl past the motors' range and hinges past their limits; limit rows
    come first, kind 'lim', some active and some not."""
    jm, pm = _models(name, "f64")
    if name == "humanoid":
        qpos, qvel, ctrl = humanoid_states(NENV, seed=1, drop=0.11)
    else:
        qpos, qvel = pendulum_states(NENV, seed=2, tilt=0.8)
        ctrl = np.random.default_rng(2).uniform(-1.5, 1.5, size=(NENV, 2))
    jd, je, pd, pe = _stages(name, jm, pm, _jax_batch(jm, qpos, qvel, ctrl, jnp.float64))
    for field in _ACT:
        _close(f"{name} {field}", getattr(pd, field), getattr(jd, field), 1e-12)
    assert pe.kinds == je.kinds and (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    nlim = sum(pm.jnt_limited)
    assert pe.kinds[:nlim] == ("lim",) * nlim and pe.con_base[0] == nlim
    for field in _ROWS:
        _close(f"{name} efc.{field}", getattr(pe, field), getattr(je, field), 1e-12)
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))
    lim_active = pe.active[:, :nlim]
    assert bool(lim_active.any()) and not bool(lim_active.all())
    assert np.abs(ctrl).max() > 1.0
    clamped = (pd.actuator_force.abs() == 1.0) if name == "humanoid" else None
    if clamped is not None:
        assert bool(clamped.any()), "no ctrl clamped"
    else:
        # joint1's force range and joint2's total actuator force range bite
        assert float(pd.actuator_force[:, 0].max()) <= 0.8
        assert float(pd.qfrc_actuator[:, 5].min()) >= -3.0
        assert bool((pd.actuator_force[:, 0] == 0.8).any()
                    or (pd.actuator_force[:, 0] == -0.6).any())


def test_humanoid_step_matches_jax_float32():
    """One float32 step of HUMANOID dropped 0.11 m (the feet in the floor)
    with hinges past their limits, through fwd.step against
    jax.vmap(fwd.step): qpos rtol 1e-5 / atol 1e-6, qvel and qacc rtol /
    atol 1e-4 (tests/test_torch_pile.py's tolerances: float32 on both
    sides, the same algorithm, sums in another order)."""
    jm, pm = _models("humanoid", "f32")
    qpos, qvel, ctrl = humanoid_states(2, seed=3, drop=0.11)
    lo, hi = pm.jnt_range[1:, 0].double().numpy(), pm.jnt_range[1:, 1].double().numpy()
    assert ((qpos[:, 7:] < lo) | (qpos[:, 7:] > hi)).any(), "no limit active"
    jd = _jax_batch(jm, qpos, qvel, ctrl, jnp.float32)
    pd = _to_port(jd)
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    pd = fwd.step(pm, pd)
    for field, rtol, atol in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-4, 1e-4)):
        np.testing.assert_allclose(getattr(pd, field).numpy(),
                                   np.asarray(getattr(jd, field)), rtol=rtol, atol=atol,
                                   err_msg=f"humanoid {field} 1 step")
    assert int((pd.contact.dist < pd.contact.includemargin).sum()) > 0, "no floor contact"
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


def test_limited_pendulum_step_float64():
    """PENDULUM with two limited hinges and two motors: 2 limit rows ahead
    of 33 contact rows, which K2's plain version takes (nv 11, 35 rows);
    one float64 step against jax.vmap(fwd.step), whose solve in float64 is
    `_solve_jnp`, another Newton on the same rows: both stop when a trip
    improves the cost by less than 1e-8 of its scale, so qacc agrees to
    rtol / atol 1e-6 and qpos, qvel to 1e-9."""
    jm, pm = _models("pendulum", "f64")
    qpos, qvel = pendulum_states(NENV, seed=4, tilt=0.8)
    ctrl = np.random.default_rng(4).uniform(-1.5, 1.5, size=(NENV, 2))
    jd = _jax_batch(jm, qpos, qvel, ctrl, jnp.float64)
    pd = _to_port(jd)
    e = efc.make_efc(pm, smooth.fwd_velocity_smooth(pm, collision.collide(
        pm, smooth.fwd_position_smooth(pm, pd))))
    assert e.kinds[:2] == ("lim", "lim") and len(e.kinds) == 35
    assert solver_tpu.supports(e, pm.nv) and bool(e.active[:, :2].any())
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    with pytest.warns(UserWarning, match="truncated"):
        pd = fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("qacc", 1e-6)):
        _close(f"limited pendulum {field}", getattr(pd, field), getattr(jd, field), tol)
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


_RAISES = {
    # each case keeps the id it had when it held a feature the port now
    # runs (a servo on a ball joint, then a mesh geom, <general>, a fixed
    # tendon, a ball joint's limit, then the implicitfast integrator, then
    # a sphere's fluidshape, a muscle gain, a spatial tendon and a fluid
    # medium) and holds one that still raises in both packages: fluidshape
    # on a mesh, a muscle on a joint with no range, a spatial tendon that
    # does not start at a site, gravcomp
    "position": ('<asset><mesh name="m" vertex="0 0 0 0.1 0 0 0 0.1 0 0 0 0.1"/></asset>',
                 "", ValueError, "fluidshape"),
    "general": ("", '<actuator><general joint="j" gaintype="muscle"/></actuator>',
                ValueError, "muscle"),
    "tendon": ("", '<tendon><spatial name="t"><pulley divisor="2"/><site site="s"/>'
                   '</spatial></tendon><actuator><motor tendon="t"/></actuator>',
               ValueError, "spatial"),
    "ball_limit": ('<option density="1.2"/>', "", ValueError, "gravcomp"),
}


@pytest.mark.parametrize("case", sorted(_RAISES))
def test_unported_features_raise(case):
    """Fluidshape on a mesh, a muscle whose lengthrange cannot be
    computed, a malformed spatial tendon and gravcomp raise ValueError at
    compile in the port and in the JAX package (which compiles gravcomp but
    never applies it: the port refuses it), each naming what is wrong."""
    head, tail, exc, match = _RAISES[case]
    joint = {"ball_limit": '<joint name="j" type="ball" range="0 0.5"/>',
             "position": '<joint name="j" type="ball"/><geom type="mesh" mesh="m" '
                         'fluidshape="ellipsoid"/>'}.get(
                 case, '<joint name="j" type="hinge"/>')
    body = '<body gravcomp="1">' if case == "ball_limit" else "<body>"
    xml = (f'<mujoco>{head}<worldbody>{body}{joint}'
           f'<geom type="sphere" size="0.1"/><site name="s"/></body></worldbody>'
           f'{tail}</mujoco>')
    with pytest.raises(exc, match=match):
        fwd.make_plan(mjcf.load_model_from_string(xml))
    if case != "ball_limit":
        with pytest.raises(exc, match=match):
            jax_load(xml)


def test_jax_compiled_position_actuator_raises():
    """A model compiled elsewhere (the JAX package) with a <position>
    actuator converts and plans on the general route, and so do one whose
    servo adds an activation (<intvelocity>: an integrator, na = 1), one
    with an affine gain (<damper>) and one with a <muscle> (which the port
    refused to step when this test was written), its lengthrange and acc0
    carried across."""
    def converted(act):
        xml = ('<mujoco><worldbody><body><joint name="j"/><geom type="sphere" '
               f'size="0.1"/></body></worldbody><actuator>{act}</actuator></mujoco>')
        return model_from_numpy(*jax_model_to_numpy(jax_load(xml)))
    assert fwd.make_plan(converted('<position joint="j" kp="10"/>')) == fwd.GeneralPlan()
    m = converted('<intvelocity joint="j" kp="10"/>')
    assert m.na == 1 and fwd.make_plan(m) == fwd.GeneralPlan()
    assert fwd.make_plan(converted('<damper joint="j" kv="1"/>')) == fwd.GeneralPlan()
    m = converted('<muscle joint="j" lengthrange="0.5 1.5"/>')
    assert fwd.make_plan(m) == fwd.GeneralPlan()
    assert m.actuator_lengthrange.tolist() == [[0.5, 1.5]] and float(m.actuator_acc0[0]) > 0


def test_set_ctrl_and_humanoid_server():
    """set_ctrl as the JAX server's: the shape (nu,) and env_id are checked,
    one env or every env is written, in place on the batch's device; then
    HUMANOID steps on the CPU with it, finite, its motors' forces the
    clamped ctrl."""
    srv = MujocoServer(HUMANOID, nenv=3, device="cpu", unpause=False)
    ctrl = srv.d.ctrl
    res = srv.set_ctrl(np.zeros(20))
    assert not res.success and "(21,)" in res.status_message
    for bad in (3, -1):
        res = srv.set_ctrl(np.zeros(21), env_id=bad)
        assert not res.success and "env_id" in res.status_message
    vals = np.linspace(-1.5, 1.5, 21)
    assert srv.set_ctrl(vals, env_id=1).success
    assert srv.d.ctrl is ctrl
    np.testing.assert_array_equal(ctrl[1].numpy(), vals.astype(np.float32))
    assert float(ctrl[[0, 2]].abs().max()) == 0.0
    assert srv.set_ctrl(-vals).success
    np.testing.assert_array_equal(ctrl.numpy(), np.tile(-vals.astype(np.float32), (3, 1)))
    assert srv.step(3).success
    d = srv.d
    assert all(bool(torch.isfinite(t).all()) for t in (d.qpos, d.qvel, d.qacc))
    np.testing.assert_allclose(d.actuator_force.numpy(),
                               np.tile(np.clip(-vals, -1, 1), (3, 1)), rtol=1e-6)
    assert srv.sim_time == pytest.approx(0.009, abs=1e-6)


def test_humanoid_modules_import_no_jax():
    code = ("import sys; import mujoco_ros_pkgs_tpu_torch.models.humanoid, "
            "mujoco_ros_pkgs_tpu_torch.ops.smooth, mujoco_ros_pkgs_tpu_torch.ops.forward; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mujoco_ros_pkgs_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
