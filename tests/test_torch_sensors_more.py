"""The 25 sensor types added to the torch port, and MUSCLE_ARM's steps, against the JAX package.

- MUSCLE_ARM (tests/torch_problems.MUSCLE_ARM_EXPLICIT: all 36 sensor
  types, spatial tendons, muscles, a fingertip on a table, Euler and the
  K2-sized Newton): 16 seeded envs step 3 times as jax.vmap(fwd.step)
  (one jit): qpos, qvel and act to 1e-9, qacc to 1e-6; the first step's
  sensordata (the forward at the seeded states) per stage: the position
  and velocity stages' types to 1e-12, the acceleration stage's (which
  read qacc, cacc and the solver's row forces) to 1e-6; the touch sensor
  0 where the fingertip's contact is inactive and non-zero in most envs
  where it is active, a joint's and the limited tendon's limit rows active
  in some envs;
- each stage writes its own types and no others (sensor_pos, sensor_vel,
  sensor_acc on a zeroed sensordata);
- touch on a pile of three spheres with elliptic cones, plain and under
  con_topk = 2 (the solver sees each env's two deepest contacts), against
  jax.vmap(forward) to 1e-9: under compaction the JAX package's row forces
  keep the canonical layout, so touch reads them as it does without;
- check_general takes every SensorType, and MUSCLE_ARM holds them all;
  the sensors plugin serves MUSCLE_ARM with a noise model on the CPU.

The JAX models load through tests/torch_jax.jax_load (set_constants under
one jit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import SensorType
from mujoco_ros_pkgs_tpu_torch.msgs import SensorNoiseModel
from mujoco_ros_pkgs_tpu_torch.ops import efc, forward as fwd, sensor_impl, solver_tpu
from mujoco_ros_pkgs_tpu_torch.plugins.sensors import SensorsPlugin
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer

from tests.torch_problems import MUSCLE_ARM_EXPLICIT, muscle_arm_states
from tests.torch_jax import jax_load

NENV = 16
NSTEP = 3
S = SensorType
POS_TYPES = {S.FRAMEPOS, S.FRAMEQUAT, S.FRAMEXAXIS, S.FRAMEYAXIS, S.FRAMEZAXIS, S.JOINTPOS,
             S.BALLQUAT, S.TENDONPOS, S.ACTUATORPOS, S.JOINTLIMITPOS, S.TENDONLIMITPOS,
             S.SUBTREECOM, S.MAGNETOMETER, S.RANGEFINDER, S.CLOCK}
VEL_TYPES = {S.VELOCIMETER, S.GYRO, S.JOINTVEL, S.BALLANGVEL, S.TENDONVEL, S.ACTUATORVEL,
             S.FRAMELINVEL, S.FRAMEANGVEL, S.SUBTREELINVEL, S.SUBTREEANGMOM,
             S.JOINTLIMITVEL, S.TENDONLIMITVEL}
ACC_TYPES = set(S) - POS_TYPES - VEL_TYPES


def _columns(m, types):
    return np.asarray([m.sensor_adr[i] + k for i in range(m.nsensor)
                       if m.sensor_type[i] in types for k in range(m.sensor_dim[i])])


@pytest.fixture(scope="module")
def arm():
    """MUSCLE_ARM's states and each step's Data from both packages."""
    pm = mjcf.load_model_from_string(MUSCLE_ARM_EXPLICIT)
    jm = jax_load(MUSCLE_ARM_EXPLICIT)
    qpos, qvel, act, ctrl = muscle_arm_states(pm, NENV, seed=11)
    names = ("qpos", "qvel", "act", "ctrl")
    pd = fwd.make_data(pm, NENV).replace(**{k: torch.from_numpy(v) for k, v in
                                            zip(names, (qpos, qvel, act, ctrl))})
    d0 = jfwd.make_data(jm)
    jd = jax.vmap(lambda *a: d0.replace(**dict(zip(names, a))))(
        *(jnp.asarray(x) for x in (qpos, qvel, act, ctrl)))
    jstep = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))
    plan = fwd.make_plan(pm)
    steps = []
    for _ in range(NSTEP):
        pd, jd = fwd.step(pm, pd, plan), jstep(jd)
        steps.append((pd, jd))
    return pm, plan, steps


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=name)


def test_muscle_arm_steps_match_jax(arm):
    pm, plan, steps = arm
    for k, (pd, jd) in enumerate(steps):
        for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("act", 1e-9), ("qacc", 1e-6),
                           ("actuator_force", 1e-6), ("ten_length", 1e-9)):
            _close(f"{field} step {k}", getattr(pd, field), getattr(jd, field), tol)
    assert torch.isfinite(steps[-1][0].sensordata).all()
    # the route: Euler, K2's Newton (nv 5, 8 rows)
    rows = efc.row_layout(pm)["nrow"]
    assert pm.nv == 5 and rows == 8 and solver_tpu.supports_rows(("x",) * rows, (), pm.nv)


@pytest.mark.parametrize("stage", ["pos", "vel", "acc"])
def test_sensors_match_jax(arm, stage):
    """The first step's sensordata (its forward at the seeded states),
    stage by stage: position and velocity to 1e-12, acceleration to 1e-6."""
    pm, _, steps = arm
    pd, jd = steps[0]
    types, tol = {"pos": (POS_TYPES, 1e-12), "vel": (VEL_TYPES, 1e-12),
                  "acc": (ACC_TYPES, 1e-6)}[stage]
    assert {SensorType(t) for t in pm.sensor_type} >= types
    cols = _columns(pm, types)
    _close(f"{stage} sensors", pd.sensordata[:, cols], np.asarray(jd.sensordata)[:, cols], tol)


def test_touch_and_limit_sensors_are_live(arm):
    """touch is 0 in the envs whose fingertip contact is inactive and > 0
    in most of those where it is active (a contact that separates fast
    enough carries no force); the elbow's and the extensor tendon's limit
    forces non-zero in some envs, 0 where their rows are inactive."""
    pm, _, steps = arm
    pd, _ = steps[0]
    sd = pd.sensordata
    touch = sd[:, pm.sensor_adr[pm.sensor("touch")]]
    active = (pd.contact.dist < pd.contact.includemargin).any(1)
    assert bool(active.any()) and not bool(active.all())
    assert bool((touch[~active] == 0).all()) and bool((touch >= 0).all())
    assert 2 * int((touch[active] > 0).sum()) >= int(active.sum())
    for frc, pos in (("elbow_lim_frc", "elbow_lim_pos"), ("ext_lim_frc", "ext_lim_pos")):
        f = sd[:, pm.sensor_adr[pm.sensor(frc)]]
        dist = sd[:, pm.sensor_adr[pm.sensor(pos)]]
        assert bool((f != 0).any()), frc
        assert bool((f[dist == 0] == 0).all()), frc


def test_each_stage_writes_its_own_types(arm):
    """sensor_pos, sensor_vel and sensor_acc on the forward's Data with
    sensordata zeroed: each fills exactly its stage's columns, with the
    forward's values."""
    pm, _, steps = arm
    d = fwd.forward(pm, steps[0][0])
    zero = d.replace(sensordata=torch.zeros_like(d.sensordata))
    for fn, types in ((sensor_impl.sensor_pos, POS_TYPES), (sensor_impl.sensor_vel, VEL_TYPES),
                      (sensor_impl.sensor_acc, ACC_TYPES)):
        out = fn(pm, zero).sensordata
        cols = _columns(pm, types)
        others = np.setdiff1d(np.arange(pm.nsensordata), cols)
        assert torch.equal(out[:, cols], d.sensordata[:, cols]), fn.__name__
        assert bool((out[:, others] == 0).all()), fn.__name__


TOUCH_PILE = """<mujoco model="touch_pile"><option cone="elliptic"/>
<worldbody><geom name="floor" type="plane" size="1 1 0.1"/>
<body name="a" pos="0 0 0.05"><freejoint/><geom type="sphere" size="0.05"/><site name="sa"/></body>
<body name="b" pos="0.12 0 0.05"><freejoint/><geom type="sphere" size="0.05"/><site name="sb"/>
</body>
<body name="c" pos="0.06 0 0.13"><freejoint/><geom type="sphere" size="0.05"/><site name="sc"/>
</body></worldbody>
<sensor><touch name="ta" site="sa"/><touch name="tb" site="sb"/><touch name="tc" site="sc"/>
</sensor></mujoco>"""


@pytest.mark.parametrize("topk", [0, 2])
def test_touch_matches_jax(topk):
    """Three spheres (nv 18: the general Newton) pressed by up to 6 mm
    into the floor and each other: touch against jax.vmap(forward), 1e-9,
    plain and with con_topk = 2 (which changes the forces in the envs with
    more than two contacts)."""
    pm = mjcf.load_model_from_string(TOUCH_PILE, con_topk=topk)
    jm = jax_load(TOUCH_PILE, con_topk=topk)
    rng = np.random.default_rng(4)
    qpos = np.tile(pm.qpos0.numpy(), (8, 1))
    qpos[:, [2, 9, 16]] -= rng.uniform(0.0, 0.006, (8, 3))
    d0 = jfwd.make_data(jm)
    jd = jax.jit(jax.vmap(lambda q: jfwd.forward(jm, d0.replace(qpos=q))))(jnp.asarray(qpos))
    pd = fwd.forward(pm, fwd.make_data(pm, 8).replace(qpos=torch.from_numpy(qpos)))
    assert pd.efc_force_contact.shape == tuple(jd.efc_force_contact.shape)
    _close(f"touch topk={topk}", pd.sensordata, jd.sensordata, 1e-9)
    assert bool((pd.sensordata > 0).any()) and bool((pd.sensordata == 0).any())


def test_check_general_takes_every_sensor_type():
    """MUSCLE_ARM holds all 36 types and plans on the general route; a type
    outside mjtSensor raises NotImplementedError."""
    pm = mjcf.load_model_from_string(MUSCLE_ARM_EXPLICIT)
    assert {SensorType(t) for t in pm.sensor_type} == set(SensorType)
    fwd.check_general(pm)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    import dataclasses
    bad = dataclasses.replace(pm, sensor_type=(99,) + pm.sensor_type[1:])
    with pytest.raises(NotImplementedError, match="99"):
        fwd.check_general(bad)


def test_muscle_arm_server_with_sensors_plugin():
    """MUSCLE_ARM served on the CPU with the sensors plugin and a noise
    model on a ball quaternion and the touch sensor: finite noisy and
    ground-truth readings, the noise where it was set and nowhere else."""
    srv = MujocoServer(MUSCLE_ARM_EXPLICIT, nenv=2, device="cpu", plugins=[SensorsPlugin()],
                       seed=0)
    models = [SensorNoiseModel("shoulder_quat", [0.0] * 3, [0.05] * 3, 0x7),
              SensorNoiseModel("touch", [0.0], [0.5], 0x1)]
    assert srv.register_noise_models(models).success
    assert srv.step(3).success
    noisy, gt = srv.sensor_outputs(1)
    assert np.isfinite(noisy).all() and np.isfinite(gt).all()
    m = srv.m
    noisy_cols = set(_columns(m, {S.BALLQUAT}).tolist()) | {m.sensor_adr[m.sensor("touch")]}
    diff = np.nonzero(noisy != gt)[0]
    assert len(diff) and set(diff.tolist()) <= noisy_cols
