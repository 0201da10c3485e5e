"""ARM7 (BASELINE config 4's scene: nv 7, 7 limited hinges, 4 position
servos and 3 motors, a mocap target and the `ee_target` weld from it to the
last link) through the port's general route, against the JAX package.

Inputs are seeded numpy states (tests/torch_problems.arm7_states) handed to
both packages; the port's Data is carried across with
tests/test_torch_general._to_port (eq_active, mocap_pos and mocap_quat
among the fields). On the CPU the port's K1 calls run their plain version.
One JAX model is loaded per world (module-scope cache), in float64.

- compile: nv 7, nu 7, one mocap body, one weld; 100 rows (6 weld rows, 7
  limit rows, 29 condim-3 contact slots); every field, the eq_* columns
  (the weld's relpose at qpos0), body_mocapid, the servos' gain and bias
  prms and body_invweight0 among them, equal to model_from_numpy of the
  JAX compile;
- float64 stages at rtol / atol 1e-12 with the weld active in all envs
  but one and its target 0.1-0.3 m off, hinges past their limits and
  ctrl past its range: kinematics (the mocap body at its target), velocity
  and bias, actuation, qacc_smooth, and every efc row (J, D, R, aref, pos,
  margin, active exactly), the weld rows first;
- whole steps through fwd.step against jax.vmap(fwd.step), both solving
  the 100 rows with the general Newton (the JAX package's `_solve_jnp`):
  1 step within 1e-12, 5 steps within 1e-10, of each field's scale;
- a small world with a connect, two joint equalities and a weld to the
  world given an unnormalised relpose: the compile, the rows at 1e-12 and
  one step through K2's plain version against `_solve_jnp` (another Newton
  on the same rows: qacc at 1e-6, qpos and qvel at 1e-8);
- what the port does not run raises by name.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.models import worlds as jworlds
from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import EqType
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _to_port
from tests.torch_problems import arm7_states
from tests.torch_jax import jax_load

NENV = 4

# two hinges and a slide + hinge body: a connect from the chain's tip to
# the second body, a quadratic joint coupling, a joint held at 0.2 and an
# inactive weld of the second body to the world with an unnormalised relpose
EQUALITIES = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    <body name="a" pos="0 0 1">
      <joint name="ja" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"/>
      <body name="b" pos="0.4 0 0">
        <joint name="jb" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"/>
      </body>
    </body>
    <body name="c" pos="0.8 0 1.3">
      <joint name="jc" type="slide" axis="0 0 1"/>
      <joint name="jd" type="hinge" axis="1 0 0"/>
      <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <connect name="tip" body1="b" body2="c" anchor="0.4 0 0" solref="0.05 1"/>
    <joint name="couple" joint1="jb" joint2="ja" polycoef="0.1 -0.5 0.2 0.05 0"/>
    <joint name="hold" joint1="jd" polycoef="0.2 0 0 0 0" solimp="0.8 0.9 0.01 0.5 2"/>
    <weld name="pin" body1="c" relpose="0.8 0 1.25 2 0.2 0 0" torquescale="0.5"
          active="false"/>
  </equality>
</mujoco>
"""
_XML = {"arm7": (worlds.ARM7, jworlds.ARM7), "equalities": (EQUALITIES, EQUALITIES)}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, port model, jitted vmapped JAX step) of a world, float64."""
    xml, jxml = _XML[name]
    jm = jax_load(jxml)
    return (jm, mjcf.load_model_from_string(xml),
            jax.jit(jax.vmap(lambda d: jfwd.step(jm, d))))


def _jax_batch(jm, **fields):
    d1 = jfwd.make_data(jm)
    nenv = fields["qpos"].shape[0]
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (nenv,) + x.shape), d1)
    return d.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def _arm7_batch(seed=1):
    jm, pm, _ = _models("arm7")
    qpos, qvel, ctrl, mpos, mquat, active = arm7_states(pm, NENV, seed)
    return _jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl, mocap_pos=mpos,
                      mocap_quat=mquat, eq_active=active)


def _equalities_batch(seed=2):
    rng = np.random.default_rng(seed)
    qpos = rng.uniform(-0.4, 0.4, size=(NENV, 4))
    active = np.ones((NENV, 4), dtype=bool)
    active[0, 0] = False              # the connect off in env 0
    active[1:3, 3] = True             # the weld on in envs 1 and 2
    return _jax_batch(_models("equalities")[0], qpos=qpos,
                      qvel=0.5 * rng.normal(size=(NENV, 4)), eq_active=active)


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_arm7_compiles_as_jax():
    """nv 7, nu 7, one mocap body, one weld (inactive at load); 100 rows: 6
    weld rows, 7 limit rows, then 29 condim-3 contact slots; the general
    route; every field of the port's compile equal to the converted JAX
    compile, and the weld's relpose the last link's pose in the target's
    frame at qpos0."""
    assert worlds.ARM7 == jworlds.ARM7, "the port's copy of ARM7 drifted"
    jm, pm, _ = _models("arm7")
    assert (pm.nv, pm.nu, pm.nmocap, pm.neq, sum(pm.jnt_limited)) == (7, 7, 1, 1, 7)
    assert pm.body_mocapid[pm.body("mocap_target")] == 0
    assert pm.eq_type == (int(EqType.WELD),) and pm.eq_active0 == (0,)
    layout = efc.row_layout(pm)
    assert layout["nrow"] == 100 and layout["con"][0] == 13
    assert len(layout["con"]) == 29 and set(layout["con_nrows"]) == {3}
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    np.testing.assert_allclose(pm.eq_data[0].numpy(), [0, 0, 0, -0.5, 0, 0.4, 1, 0, 0, 0, 1],
                               atol=1e-12)
    np.testing.assert_array_equal(pm.actuator_gainprm[:, 0].numpy(),
                                  [40, 40, 30, 30, 1, 1, 1])
    np.testing.assert_array_equal(pm.actuator_biasprm[:, 1:3].numpy(),
                                  [[-40, -4], [-40, -4], [-30, -3], [-30, -3]] + [[0, 0]] * 3)
    assert float(pm.body_invweight0[pm.body("mocap_target")].abs().max()) == 0.0


def _stages(name, jd):
    """Both packages through the position, velocity and actuation stages
    and the efc rows, float64: (JAX data, JAX rows, port data, port rows)."""
    jm, pm, _ = _models(name)
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


_SMOOTH = ("qpos", "xpos", "xquat", "xmat", "xipos", "geom_xpos", "site_xpos",
           "subtree_com", "cinert", "cdof", "qM", "cvel", "cdof_dot", "qfrc_bias",
           "qfrc_passive", "actuator_length", "actuator_velocity", "actuator_moment",
           "actuator_force", "qfrc_actuator", "qfrc_smooth", "qacc_smooth")
_ROWS = ("J", "D", "R", "aref", "pos", "margin", "frictionloss")


def _rows_match(name, je, pe, neq):
    assert pe.kinds == je.kinds and (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    assert pe.kinds[:neq] == ("eq",) * neq
    for field in _ROWS:
        _close(f"{name} efc.{field}", getattr(pe, field), getattr(je, field), 1e-12)
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))


def test_arm7_stages_match_jax():
    """Every stage of one ARM7 step up to the rows at 1e-12 (float64): the
    mocap body at its target, the servos' bias forces, the weld's 6 rows
    (gated off in env 0), the limit rows (some active) and the contact
    rows (the folded env in contact), row by row."""
    jd0 = _arm7_batch()
    jd, je, pd, pe = _stages("arm7", jd0)
    for field in _SMOOTH:
        _close(f"arm7 {field}", getattr(pd, field), getattr(jd, field), 1e-12)
    mocap = pd.xpos[:, _models("arm7")[1].body("mocap_target")]
    np.testing.assert_array_equal(mocap.numpy(), np.asarray(jd0.mocap_pos)[:, 0])
    _rows_match("arm7", je, pe, 6)
    assert pe.active[:, :6].tolist() == [[False] * 6] + [[True] * 6] * (NENV - 1)
    assert bool(pe.active[:, 6:13].any()), "no limit row active"
    # the target moved 0.1-0.3 m and turned up to 0.3 rad about its origin
    assert float(pe.pos[1:, :3].norm(dim=-1).min()) > 0.05
    assert bool(pe.con_active.any()), "no contact"
    assert float(pd.actuator_force[:, :4].abs().max()) > 0.0


@pytest.mark.parametrize("nsteps,tol", [(1, 1e-12), (5, 1e-10)])
def test_arm7_steps_match_jax(nsteps, tol):
    """fwd.step against jax.vmap(fwd.step) in float64: both solve the 100
    rows with the general Newton; qpos, qvel and qacc after 1 step within
    1e-12, after 5 within 1e-10, of each field's scale max(1, max |x|)
    over the batch. The scale, not each element's own size: the stiff
    weld and the contacts give constraint forces of some 1e4, so qacc
    reaches 3e3 and a small qvel entry carries the rounding of those sums
    (1.9e-12 on an entry of 0.7 after 1 step, 2.3e-11 on qvel's scale of
    22 after 5)."""
    _, pm, jstep = _models("arm7")
    jd = _arm7_batch(seed=3)
    pd = _to_port(jd)
    for _ in range(nsteps):
        jd, pd = jstep(jd), fwd.step(pm, pd)
    for field in ("qpos", "qvel", "qacc"):
        want = np.asarray(getattr(jd, field))
        np.testing.assert_allclose(getattr(pd, field).numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()),
                                   err_msg=f"arm7 {field} after {nsteps}")
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


def test_equalities_compile_and_rows_match_jax():
    """The small world's compile (connect's anchor in body2 at qpos0, the
    weld's relpose normalised, polycoef, torquescale) equals the JAX
    package's; its rows (3 connect, 1 + 1 joint, 6 weld, then contacts)
    at 1e-12, each equality gated in some envs."""
    jm, pm, _ = _models("equalities")
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    assert pm.eq_type == tuple(int(t) for t in (EqType.CONNECT, EqType.JOINT, EqType.JOINT,
                                                EqType.WELD))
    np.testing.assert_allclose(pm.eq_data[0, 3:6].numpy(), [0, 0, -0.3], atol=1e-12)
    np.testing.assert_allclose(pm.eq_data[3, 6:11].numpy(),
                               [2 / np.sqrt(4.04), 0.2 / np.sqrt(4.04), 0, 0, 0.5], atol=1e-12)
    _, je, _, pe = _stages("equalities", _equalities_batch())
    _rows_match("equalities", je, pe, 11)


def test_equalities_step_matches_jax():
    """One float64 step of the small world: its 23 rows go to K2's plain
    version in the port and to `_solve_jnp` in the JAX package, another
    Newton on the same rows (both stop when a trip improves the cost by
    less than 1e-8 of its scale): qacc at rtol / atol 1e-6, and qvel (qvel
    + h qacc, |qacc| to 20 here) and qpos at 1e-8."""
    _, pm, jstep = _models("equalities")
    jd = _equalities_batch(seed=4)
    pd = _to_port(jd)
    e = efc.make_efc(pm, smooth.fwd_velocity_smooth(pm, collision.collide(
        pm, smooth.fwd_position_smooth(pm, pd))))
    assert solver_tpu.supports(e, pm.nv) and e.kinds[:11] == ("eq",) * 11
    jd = jstep(jd)
    with pytest.warns(UserWarning, match="truncated"):
        pd = fwd.step(pm, pd)
    for field, tol in (("qpos", 1e-8), ("qvel", 1e-8), ("qacc", 1e-6)):
        _close(f"equalities {field}", getattr(pd, field), getattr(jd, field), tol)
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


_BODY = ('<body name="b"><joint name="j" type="hinge"/><geom type="sphere" size="0.1"/>'
         '<site name="s"/></body>')
# "tendon_equality" and "general" keep the ids they had when they held a
# tendon equality and a <general> with dynamics, and then a spatial tendon
# and a muscle gain, which the port now compiles; they hold a spatial
# tendon that does not start at a site and a muscle gain on a joint with no
# range (no lengthrange can be computed), which raise in both packages
_RAISES = {
    "tendon_equality": ('<tendon><spatial name="t"><pulley divisor="2"/><site site="s"/>'
                        '</spatial></tendon><equality><tendon tendon1="t"/></equality>',
                        "must start and end at sites"),
    "distance_equality": ('<equality><distance geom1="g" geom2="h"/></equality>',
                          "distance"),
    "unknown_body": ('<equality><weld body1="ghost"/></equality>', "ghost"),
    "general": ('<actuator><general joint="j" gaintype="muscle"/></actuator>',
                "joint has no range"),
    "muscle": ('<actuator><muscle joint="j"/></actuator>', "muscle"),
    "mocap_with_joint": ("", "mocap"),
}


@pytest.mark.parametrize("case", sorted(_RAISES))
def test_unported_elements_raise(case):
    """A spatial tendon that does not start at a site, distance
    equalities, an unknown body, muscles whose lengthrange cannot be
    computed and a mocap body with a joint raise ValueError at compile,
    naming what is wrong."""
    extra, match = _RAISES[case]
    body = _BODY.replace('name="b"', 'name="b" mocap="true"') if case.startswith(
        "mocap") else _BODY
    xml = f"<mujoco><worldbody>{body}</worldbody>{extra}</mujoco>"
    with pytest.raises(ValueError, match=match):
        mjcf.load_model_from_string(xml)
    if case in ("tendon_equality", "general"):
        with pytest.raises(ValueError, match=match):
            jax_load(xml)
