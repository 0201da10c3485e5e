"""Muscles and their automatic lengthrange in the torch port against the JAX package.

- ops/muscle.py: dynamics (with and without tausmooth), gain (a given and a
  derived peak force) and bias on seeded grids across every branch of the
  curves, against the JAX package's ops/muscle.py, to 1e-12;
- tests/test_muscle.py's worlds (a two-muscle elbow on a joint, a muscle on
  a spatial tendon): the compile (actuator_acc0 and the muscle
  parameters among the fields) equals the JAX package's; and both in one
  model, one batch of seeded states steps 3 times as jax.vmap(fwd.step)
  does, one jit (qpos, qvel 1e-9, act 1e-9, qacc 1e-6);
- core/lengthrange.py: the joint route (analytic) and the tendon route
  (the damped push probe, all (actuator, direction) pairs one batch) give
  the JAX package's ranges (1e-12 and 1e-9: 400 damped steps, each env's
  extreme reached where the push balances the limit), and both packages
  raise the same ValueError for a ball-joint muscle, a joint with no range,
  a tendon nothing bounds and a site transmission; MUSCLE_ARM's probe gives
  tests/torch_problems.MUSCLE_ARM_PROBED;
- MUSCLE_ARM's save_xml: written, reloaded and stepped once, bit for bit.

The JAX models load through tests/torch_jax.jax_load (set_constants under
one jit).
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import muscle as jmuscle

from mujoco_ros_pkgs_tpu_torch.core import lengthrange, mjcf, mjcf_writer
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import GainType
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import muscle

from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.torch_problems import (
    MUSCLE_ARM, MUSCLE_ARM_PROBED, muscle_arm_states,
)
from tests.torch_jax import jax_load

# tests/test_muscle.py's worlds
MUSCLE_JOINT = """
<mujoco model="muscle_joint">
  <option timestep="0.002"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="elbow" type="hinge" axis="0 1 0" range="-1.2 1.2"
             damping="0.08"/>
      <geom type="capsule" size="0.03 0.15" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <actuator>
    <muscle name="flex" joint="elbow" gear="0.05"
            lengthrange="-0.06 0.06" force="120"/>
    <muscle name="ext" joint="elbow" gear="-0.05"
            lengthrange="-0.06 0.06" scale="400" tausmooth="0.05"/>
  </actuator>
</mujoco>
"""

MUSCLE_TENDON = """
<mujoco model="muscle_tendon">
  <option timestep="0.002"/>
  <worldbody>
    <site name="anchor" pos="0 0 1"/>
    <body name="arm" pos="0 0 0.7">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.03 0.12" fromto="0 0 0 0 0 -0.24"/>
      <site name="tip" pos="0.05 0 -0.1"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="tendon1">
      <site site="anchor"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <muscle name="m" tendon="tendon1" lengthrange="0.25 0.45"/>
  </actuator>
</mujoco>
"""
# the tendon world with a limited joint and no lengthrange: the probe's
MUSCLE_TENDON_AUTO = MUSCLE_TENDON.replace('damping="0.05"', 'damping="0.05" range="-50 70"') \
    .replace(' lengthrange="0.25 0.45"', "")


def _close(name, got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol,
                               err_msg=name)


def test_muscle_curves_match_jax():
    """act_dot over ctrl and act in and out of [0, 1], hard and smooth
    time constants; gain over normalised lengths past lmin and lmax and
    velocities past -1 and fvmax - 1, with force given and derived from
    scale / acc0; the passive bias past lmax."""
    rng = np.random.default_rng(0)
    n = 4096
    ctrl, act = rng.uniform(-0.3, 1.3, n), rng.uniform(-0.2, 1.2, n)
    dynprm = np.stack([rng.uniform(0.005, 0.03, n), rng.uniform(0.02, 0.08, n),
                       np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0.01, 0.2, n))], 1)
    _close("dynamics", muscle.dynamics(*(torch.from_numpy(a) for a in (ctrl, act, dynprm))),
           jmuscle.dynamics(*(jnp.asarray(a) for a in (ctrl, act, dynprm))), 1e-12)
    prm = np.stack([np.full(n, 0.75), np.full(n, 1.05),
                    np.where(rng.random(n) < 0.5, -1.0, rng.uniform(10, 200, n)),
                    rng.uniform(100, 400, n), rng.uniform(0.3, 0.7, n), rng.uniform(1.3, 1.8, n),
                    rng.uniform(1.0, 2.0, n), rng.uniform(1.0, 1.6, n),
                    rng.uniform(1.1, 1.5, n)], 1)
    lr = np.stack([rng.uniform(0.1, 0.2, n), rng.uniform(0.3, 0.4, n)], 1)
    length = rng.uniform(0.0, 0.6, n)
    vel = rng.uniform(-1.5, 1.5, n)
    acc0 = rng.uniform(1.0, 100.0, n)
    args = (length, vel, lr, acc0, prm)
    _close("gain", muscle.gain(*(torch.from_numpy(a) for a in args)),
           jmuscle.gain(*(jnp.asarray(a) for a in args)), 1e-12)
    args = (length, lr, acc0, prm)
    _close("bias", muscle.bias(*(torch.from_numpy(a) for a in args)),
           jmuscle.bias(*(jnp.asarray(a) for a in args)), 1e-12)


# both worlds as one model (the tendon world's body renamed), so that one
# jit of the JAX package's step steps them
MUSCLE_BOTH = """
<mujoco model="muscle_both">
  <option timestep="0.002"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="elbow" type="hinge" axis="0 1 0" range="-1.2 1.2" damping="0.08"/>
      <geom type="capsule" size="0.03 0.15" fromto="0 0 0 0.3 0 0"/>
    </body>
    <site name="anchor" pos="1 0 1"/>
    <body name="arm2" pos="1 0 0.7">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.03 0.12" fromto="0 0 0 0 0 -0.24"/>
      <site name="tip" pos="0.05 0 -0.1"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="tendon1"><site site="anchor"/><site site="tip"/></spatial>
  </tendon>
  <actuator>
    <muscle name="flex" joint="elbow" gear="0.05" lengthrange="-0.06 0.06" force="120"/>
    <muscle name="ext" joint="elbow" gear="-0.05" lengthrange="-0.06 0.06" scale="400"
            tausmooth="0.05"/>
    <muscle name="m" tendon="tendon1" lengthrange="0.25 0.45"/>
  </actuator>
</mujoco>
"""


@pytest.mark.parametrize("name", ["joint", "tendon"])
def test_muscle_worlds_compile_as_jax(name):
    """The compile (acc0, dyntype/gaintype/biastype muscle, the <muscle>
    defaults) equals the JAX package's."""
    xml = {"joint": MUSCLE_JOINT, "tendon": MUSCLE_TENDON}[name]
    pm = mjcf.load_model_from_string(xml)
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jax_load(xml))))
    assert all(float(a) > 0 for a in pm.actuator_acc0)


def test_muscle_worlds_step_as_jax():
    """Both worlds in one model: 8 seeded envs step 3 times as
    jax.vmap(fwd.step) (one jit): qpos, qvel, act and the muscles' forces
    1e-9, qacc 1e-6."""
    pm, jm = mjcf.load_model_from_string(MUSCLE_BOTH), jax_load(MUSCLE_BOTH)
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    rng = np.random.default_rng(1)
    B = 8
    qpos = rng.uniform(-0.6, 0.6, size=(B, pm.nq))
    qvel = rng.normal(size=(B, pm.nv))
    act = rng.uniform(0, 1, size=(B, pm.na))
    ctrl = rng.uniform(-0.2, 1.2, size=(B, pm.nu))
    pd = fwd.make_data(pm, B).replace(**{k: torch.from_numpy(v) for k, v in
                                         zip(("qpos", "qvel", "act", "ctrl"),
                                             (qpos, qvel, act, ctrl))})
    d0 = jfwd.make_data(jm)
    jd = jax.vmap(lambda q, v, a, c: d0.replace(qpos=q, qvel=v, act=a, ctrl=c))(
        *(jnp.asarray(x) for x in (qpos, qvel, act, ctrl)))
    jstep = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))
    plan = fwd.make_plan(pm)
    for k in range(3):
        pd, jd = fwd.step(pm, pd, plan), jstep(jd)
        for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("act", 1e-9), ("qacc", 1e-6),
                           ("actuator_force", 1e-9)):
            _close(f"{field} step {k}", getattr(pd, field).numpy(), getattr(jd, field), tol)
    assert bool((pd.actuator_force.abs() > 0).all(0).all())


def test_lengthrange_joint_route_matches_jax():
    """A muscle on a limited hinge with no lengthrange: gear0 times the
    range, ordered (the negative gear's flipped), as the JAX package."""
    xml = MUSCLE_JOINT.replace(' lengthrange="-0.06 0.06"', "")
    pm, jm = mjcf.load_model_from_string(xml), jax_load(xml)
    _close("joint route", pm.actuator_lengthrange, jm.actuator_lengthrange, 1e-12)
    lo, hi = pm.actuator_lengthrange[1].tolist()
    assert lo < 0 < hi


def test_lengthrange_probe_matches_jax():
    """The damped push probe on the tendon world with a limited joint: the
    port's one batch of 2 envs against the JAX package's two loops, 1e-9;
    the range lies inside the tendon lengths the joint's range allows."""
    pm = mjcf.load_model_from_string(MUSCLE_TENDON_AUTO)
    jm = jax_load(MUSCLE_TENDON_AUTO)
    _close("probe", pm.actuator_lengthrange, jm.actuator_lengthrange, 1e-9)
    lo, hi = pm.actuator_lengthrange[0].tolist()
    assert 0.2 < lo < hi < 0.6
    assert lengthrange.LAST_PROBE_SECONDS > 0


_ERRORS = {
    "ball": ('<body name="b"><joint name="j" type="ball" range="0 1"/>'
             '<geom type="sphere" size="0.1"/><site name="s"/></body>',
             '<muscle name="m" joint="j"/>', "scalar"),
    "unlimited": ('<body name="b"><joint name="j"/><geom type="sphere" size="0.1"/>'
                  '<site name="s"/></body>', '<muscle name="m" joint="j"/>', "no range"),
    "unbounded": ('<site name="a" pos="0 0 1"/><body name="b"><joint name="j"/>'
                  '<geom type="sphere" size="0.1"/><site name="s" pos="0.1 0 0"/></body>',
                  '<muscle name="m" tendon="t"/>', "nothing bounds"),
    "site": ('<body name="b"><joint name="j" range="-1 1"/><geom type="sphere" size="0.1"/>'
             '<site name="s"/></body>', '<muscle name="m" site="s"/>', "explicit lengthrange"),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_lengthrange_errors_match_jax(case):
    """A muscle on a ball joint, on a joint with no range, on a spatial
    tendon nothing bounds and on a site: the same ValueError, message and
    all, from both packages."""
    body, act, match = _ERRORS[case]
    tendon = ('<tendon><spatial name="t"><site site="a"/><site site="s"/></spatial></tendon>'
              if case == "unbounded" else "")
    xml = (f"<mujoco><worldbody>{body}</worldbody>{tendon}<actuator>{act}</actuator>"
           "</mujoco>")
    with pytest.raises(ValueError, match=match) as got:
        mjcf.load_model_from_string(xml)
    with pytest.raises(ValueError, match=match) as want:
        jax_load(xml)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def arm():
    return mjcf.load_model_from_string(MUSCLE_ARM)


def test_muscle_arm_probe(arm):
    """MUSCLE_ARM's biceps (a wrapped tendon) and wrist muscle (a joint)
    get the ranges tests/torch_problems.MUSCLE_ARM_PROBED holds, 1e-9; the
    other muscles keep their explicit ones."""
    for name, rng in MUSCLE_ARM_PROBED.items():
        _close(name, arm.actuator_lengthrange[arm.actuator(name)], rng, 1e-9)
    _close("delt", arm.actuator_lengthrange[arm.actuator("delt")], (0.1, 0.3), 0.0)


def test_muscle_arm_save_xml_round_trip(arm):
    """save_xml of MUSCLE_ARM (spatial tendons with sidesites and pulleys,
    muscles as <general> with their lengthranges, all 36 sensor types):
    every muscle of the XML carries the model's lengthrange, probed ones
    among them, the XML reloads to the same model with no probe, and one
    step from seeded states is bit for bit the original's."""
    xml = mjcf_writer.model_to_xml(arm)
    written = {e.get("name"): e.get("lengthrange")
               for e in ET.fromstring(xml).find("actuator")}
    muscles = np.nonzero(np.asarray(arm.actuator_gaintype) == int(GainType.MUSCLE))[0]
    assert set(MUSCLE_ARM_PROBED) <= {arm.actuator_names[i] for i in muscles}
    for i in muscles:
        name = arm.actuator_names[i]
        assert written[name] is not None, name
        assert [float(v) for v in written[name].split()] == \
            arm.actuator_lengthrange[i].tolist(), name
    lengthrange.LAST_PROBE_SECONDS = 0.0
    m2 = mjcf.load_model_from_string(xml)
    assert lengthrange.LAST_PROBE_SECONDS == 0.0
    assert_models_equal(m2, arm, tol=0.0)
    qpos, qvel, act, ctrl = muscle_arm_states(arm, 4, seed=9)
    d = fwd.make_data(arm, 4).replace(**{k: torch.from_numpy(v) for k, v in zip(
        ("qpos", "qvel", "act", "ctrl"), (qpos, qvel, act, ctrl))})
    a, b = fwd.step(arm, d), fwd.step(m2, d)
    for field in ("qpos", "qvel", "act", "sensordata"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
