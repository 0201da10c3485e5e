"""The port's mocap and ros_control plugins, its URDF reader and the
server's equality and mocap services, against the JAX package.

The JAX plugins' hooks act on one env; here they run under jax.vmap on the
same seeded float64 states the port's batched hooks take, and the results
(the batch's qpos, qvel, qfrc_applied, mocap pose and the plugin state)
are held at rtol / atol 1e-12. One JAX ARM7 model is loaded for the file.

- URDF: parse_urdf and joints_config_from_urdf give the JAX package's
  dataclasses and tables (the PID upgrade, soft limits, the errors);
- ros_control: a table of every control method (EFFORT, POSITION,
  POSITION_PID, VELOCITY, VELOCITY_PID) with hard and soft limits, and a
  URDF-driven table with PID gains, each through 6 control calls with a
  control period of 3 steps (the PID decimation), e-stop on in some envs
  and some calls; quarantine on a missing joint, an unknown hardware sim
  or no joints; the HardwareSim seam; POSITION, VELOCITY and e-stop in a
  CPU server (tests/test_plugins.py's semantics);
- mocap: set_state (the quaternion normalised, every env or one) and the
  control hook against the JAX plugin; the server's set_mocap_state
  (tests/test_plugins.py::test_mocap_plugin);
- the server's equality services (tests/test_server.py::
  test_equality_services), per env, with reset restoring eq_active0; new
  parameters reach the next step exactly as if compiled (no stale cache);
  BASELINE config 4's server: both plugins, the weld on, bench_config4's
  ctrl, the end effector drawn to the target;
- the plugin modules and chip_smoke.py import no JAX.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.models import worlds as jworlds
from mujoco_ros_pkgs_tpu.msgs import MocapState as JMocapState
from mujoco_ros_pkgs_tpu.msgs import Pose as JPose
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.plugins import mocap as jmocap
from mujoco_ros_pkgs_tpu.plugins import ros_control as jros
from mujoco_ros_pkgs_tpu.plugins import urdf as jurdf

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.msgs import EqualityConstraintParameters, MocapState, Pose
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import smooth
from mujoco_ros_pkgs_tpu_torch.plugins import urdf
from mujoco_ros_pkgs_tpu_torch.plugins.mocap import MocapPlugin
from mujoco_ros_pkgs_tpu_torch.plugins.ros_control import (
    ControlMethod, HardwareSim, RosControlPlugin, register_hardware_sim,
)
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from tests.test_ros_control_urdf import ARM_URDF
from tests.torch_problems import ARM7_CTRL
from tests.torch_jax import jax_load

NENV = 4
# every control method, hard and soft limits, PID with an integral clamp
TABLE = {"control_period": 0.006, "joints": {
    "j0": {"method": "EFFORT", "effort_limit": 5.0},
    "j1": {"method": "POSITION", "position_limits": [-1.0, 1.0], "velocity_limit": 2.0,
           "soft_limits": {"lower": -0.5, "upper": 0.5, "k_position": 10.0,
                           "k_velocity": 3.0}},
    "j2": {"method": "POSITION_PID", "pid": [20.0, 4.0, 0.5, 0.01], "effort_limit": 8.0,
           "position_limits": [-0.8, 0.8]},
    "j3": {"method": "VELOCITY", "velocity_limit": 0.7,
           "soft_limits": {"lower": -0.3, "upper": 0.3, "k_position": 5.0,
                           "k_velocity": 2.0}},
    "j4": {"method": "VELOCITY_PID", "pid": [6.0, 2.0, 0.1, 0.5], "effort_limit": 4.0,
           "velocity_limit": 1.5},
    "j5": {"method": "POSITION_PID", "pid": [15.0, 0.0, 1.0, 0.0], "effort_limit": 10.0,
           "soft_limits": {"lower": -0.2, "upper": 0.2, "k_position": 20.0,
                           "k_velocity": 8.0}},
    "j6": {"method": "EFFORT", "effort_limit": 2.0, "velocity_limit": 1.0,
           "soft_limits": {"lower": -0.1, "upper": 0.1, "k_position": 4.0,
                           "k_velocity": 6.0}}}}
URDF = {"robot_description": ARM_URDF, "pid_gains": {"j4": [10.0, 1.0, 0.2, 1.0]},
        "control_period": 0.004}


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX ARM7, port ARM7), float64."""
    return (jax_load(jworlds.ARM7),
            mjcf.load_model_from_string(worlds.ARM7))


def _batches(seed):
    """The same seeded float64 ARM7 batch as the JAX package's (per-env
    Data stacked) and the port's Data."""
    jm, pm = _models()
    rng = np.random.default_rng(seed)
    qpos = rng.uniform(-0.8, 0.8, size=(NENV, 7))
    qvel = rng.normal(size=(NENV, 7))
    frc = rng.normal(size=(NENV, 7))
    jd = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (NENV,) + x.shape),
                                jfwd.make_data(jm))
    jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    qfrc_applied=jnp.asarray(frc))
    pd = fwd.make_data(pm, NENV).replace(qpos=torch.from_numpy(qpos),
                                         qvel=torch.from_numpy(qvel),
                                         qfrc_applied=torch.from_numpy(frc))
    return jd, pd


def _close(name, got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_urdf_matches_jax():
    """parse_urdf and joints_config_from_urdf (with and without PID gains)
    give the JAX package's results; its errors raise alike."""
    got, want = urdf.parse_urdf(ARM_URDF), jurdf.parse_urdf(ARM_URDF)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for gains in (None, {"j4": [10, 0, 1, 2]}):
        assert (urdf.joints_config_from_urdf(got, gains)
                == jurdf.joints_config_from_urdf(want, gains))
    for bad, match in (("<notrobot/>", "expected <robot>"), ("<robot", "parse error"),
                       ('<robot name="x"><transmission name="t"><joint name="j"/>'
                        "</transmission></robot>", "hardwareInterface")):
        with pytest.raises(ValueError, match=match):
            urdf.parse_urdf(bad)
    with pytest.raises(ValueError, match="no transmissions"):
        urdf.joints_config_from_urdf(urdf.parse_urdf('<robot name="empty"/>'))


@pytest.mark.parametrize("name,cfg", [("table", TABLE), ("urdf", URDF)])
def test_ros_control_matches_jax(name, cfg):
    """6 control calls, the time advancing one timestep a call (the PID
    updates every third call at a control period of 3 steps, or every
    second at 2), seeded commands, e-stop on in env 1 from the third call:
    the batch's qpos, qvel, qfrc_applied and the state (integral,
    prev_err, last_update) against the JAX plugin at 1e-12 after each."""
    jm, pm = _models()
    jp, pp = jros.RosControlPlugin(cfg), RosControlPlugin(cfg)
    assert jp.load(jm, None) and pp.load(pm, None)
    assert (pp.joint_ids, pp.methods) == (jp.joint_ids, jp.methods)
    if name == "table":
        assert sorted(set(pp.methods)) == [int(c) for c in ControlMethod]
    jd, pd = _batches(seed=5)
    nj = len(pp.joint_ids)
    jps = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (NENV,) + x.shape),
                                 jp.init_state(jm, 1))
    pps = pp.init_state(pm, NENV)
    control = jax.vmap(lambda d, ps: jp.control(jm, d, ps))
    rng = np.random.default_rng(6)
    dt = float(pm.opt.timestep)
    for call in range(6):
        cmd = rng.uniform(-1.2, 1.2, size=(NENV, nj))
        jps = dict(jps, command=jnp.asarray(cmd))
        pps = pp.set_commands(pps, cmd)
        if call == 2:
            estop = np.arange(NENV) == 1
            jps = dict(jps, estop=jnp.asarray(estop))
            pps = dict(pps, estop=torch.from_numpy(estop))
        jd, jps = control(jd, jps)
        pd, pps = pp.control(pm, pd, pps)
        for field in ("qpos", "qvel", "qfrc_applied"):
            _close(f"{name} call {call} {field}", getattr(pd, field), getattr(jd, field))
        for key in ("integral", "prev_err", "last_update"):
            _close(f"{name} call {call} {key}", pps[key], jps[key])
        jd = jd.replace(time=jd.time + dt)
        pd = pd.replace(time=pd.time + dt)
    assert float(pps["integral"].abs().max()) > 0.0


def test_ros_control_quarantines_and_seam():
    """A missing joint, no joints or an unknown hardware sim quarantine the
    plugin and the server steps on; a HardwareSim registered by name
    replaces the default one and reads the joints' state."""
    bad = [RosControlPlugin({"robot_description": ARM_URDF.replace('name="j0"',
                                                                   'name="ghost_joint"')}),
           RosControlPlugin({}),
           RosControlPlugin({"robot_description": ARM_URDF,
                             "hardware": {"type": "no/SuchHW"}})]
    s = MujocoServer(worlds.ARM7, nenv=1, device="cpu", plugins=bad)
    assert [p.loaded for p in bad] == [False] * 3
    assert "ghost_joint" in bad[0].load_error and "no joints" in bad[1].load_error
    assert "no/SuchHW" in bad[2].load_error
    assert s.step(2).success

    class ConstantEffort(HardwareSim):
        def write_sim(self, m, d, ps):
            dofs = torch.tensor(self.plugin.dof_adr)
            qfrc = d.qfrc_applied.clone()
            qfrc[:, dofs] = torch.where(ps["estop"][:, None], 0.0, 3.0).to(qfrc.dtype)
            return d.replace(qfrc_applied=qfrc), ps

    register_hardware_sim("test/ConstantEffort", ConstantEffort)
    p = RosControlPlugin({"robot_description": ARM_URDF,
                          "hardware": {"type": "test/ConstantEffort"}})
    s = MujocoServer(worlds.ARM7, nenv=2, device="cpu", plugins=[p])
    assert type(p.hw).__name__ == "ConstantEffort" and s.step(3).success
    np.testing.assert_array_equal(s.d.qfrc_applied[:, p.dof_adr].numpy(), 3.0)
    state = p.hw.read_sim(s.m, s.d)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "position": (2, 3), "velocity": (2, 3), "effort": (2, 3)}


def _rc_server(joints, nenv=1):
    p = RosControlPlugin({"joints": joints})
    s = MujocoServer(worlds.ARM7, nenv=nenv, device="cpu", plugins=[p])
    i, _ = s._plugin_of(RosControlPlugin)
    return s, i, p


@pytest.mark.parametrize("method", ["POSITION", "VELOCITY", "ESTOP"])
def test_ros_control_in_server(method):
    """tests/test_plugins.py's server cases: POSITION writes qpos (0.7 after
    20 steps), VELOCITY writes qvel (0.4 held over 30 steps, the joint
    moving), and e-stop zeroes an EFFORT command."""
    joint = {"POSITION": "j4", "VELOCITY": "j4", "ESTOP": "j0"}[method]
    s, i, p = _rc_server({joint: {"method": "EFFORT" if method == "ESTOP" else method}})
    ps = p.set_commands(s.pstates[i], {"POSITION": [0.7], "VELOCITY": [0.4],
                                       "ESTOP": [5.0]}[method])
    if method == "ESTOP":
        ps = p.set_estop(ps, True)
    s.pstates = tuple(ps if k == i else x for k, x in enumerate(s.pstates))
    assert s.step({"POSITION": 20, "VELOCITY": 30, "ESTOP": 5}[method]).success
    j = s.m.joint(joint)
    q = float(s.d.qpos[0, s.m.jnt_qposadr[j]])
    v = float(s.d.qvel[0, s.m.jnt_dofadr[j]])
    if method == "POSITION":
        assert abs(q - 0.7) < 1e-3, q
    elif method == "VELOCITY":
        assert abs(v - 0.4) < 0.05 and q > 0.02, (v, q)
    else:
        assert float(s.d.qfrc_applied[0, s.m.jnt_dofadr[j]]) == 0.0


def test_mocap_plugin_matches_jax():
    """set_state (all envs, then one env; the quaternion normalised) and the
    control hook against the JAX plugin at 1e-12; unknown and non-mocap
    names rejected alike."""
    jm, pm = _models()
    jp, pp = jmocap.MocapPlugin(), MocapPlugin()
    assert jp.load(jm, None) and pp.load(pm, None)
    jps = {k: np.broadcast_to(v, (NENV,) + v.shape).copy()
           for k, v in jp.init_state(jm, NENV).items()}
    pps = pp.init_state(pm, NENV)
    _close("init pos", pps["pos"], jps["pos"])
    for env_id, pos, quat in ((None, [0.1, 0.2, 0.9], [2.0, 0, 0, 0]),
                              (2, [-0.3, 0.4, 0.6], [0.3, -0.2, 0.5, 0.1])):
        jps, jres = jp.set_state(jps, JMocapState(["mocap_target"],
                                                  [JPose(np.array(pos), np.array(quat))],
                                                  env_id))
        pps, pres = pp.set_state(pps, MocapState(["mocap_target"],
                                                 [Pose(np.array(pos), np.array(quat))],
                                                 env_id))
        assert jres.success and pres.success
        for key in ("pos", "quat"):
            _close(f"set_state env {env_id} {key}", pps[key], jps[key])
    for name in ("link0", "ghost"):
        jres = jp.validate(JMocapState([name], [JPose()]))
        pres = pp.validate(MocapState([name], [Pose()]))
        assert (pres.success, pres.status_message) == (False, jres.status_message)
    jd, pd = _batches(seed=7)
    jd, _ = jax.vmap(lambda d, ps: jp.control(jm, d, ps))(
        jd, {k: jnp.asarray(v) for k, v in jps.items()})
    pd, _ = pp.control(pm, pd, pps)
    _close("mocap_pos", pd.mocap_pos, jd.mocap_pos)
    _close("mocap_quat", pd.mocap_quat, jd.mocap_quat)


def test_mocap_server():
    """tests/test_plugins.py::test_mocap_plugin on the port's CPU server: an
    unnormalised target quaternion lands normalised, the mocap body at the
    target after two steps; a target for one env moves that env only;
    non-mocap and unknown names and a bad env_id are rejected; without
    the plugin the service fails."""
    s = MujocoServer(worlds.ARM7, nenv=2, device="cpu", plugins=[MocapPlugin()])
    st = MocapState(name=["mocap_target"],
                    pose=[Pose(np.array([0.1, 0.2, 0.9]), np.array([2.0, 0, 0, 0]))])
    assert s.set_mocap_state(st).success
    assert s.step(2).success
    b = s.m.body("mocap_target")
    np.testing.assert_allclose(s.d.xpos[:, b].double().numpy(), [[0.1, 0.2, 0.9]] * 2,
                               atol=1e-6)
    np.testing.assert_array_equal(s.d.xquat[0, b].numpy(), [1, 0, 0, 0])
    st.env_id, st.pose[0].position = 1, np.array([0.4, 0.0, 0.5])
    # the control hook writes the target after the position stage, so the
    # kinematics read it from the next step on (as in the JAX package)
    assert s.set_mocap_state(st).success and s.step(1).success
    np.testing.assert_allclose(s.d.mocap_pos[1, 0].double().numpy(), [0.4, 0.0, 0.5],
                               atol=1e-6)
    assert s.step(1).success
    np.testing.assert_allclose(s.d.xpos[:, b].double().numpy(),
                               [[0.1, 0.2, 0.9], [0.4, 0.0, 0.5]], atol=1e-6)
    for bad in (MocapState(name=["link0"], pose=[Pose()]),
                MocapState(name=["ghost"], pose=[Pose()]),
                MocapState(name=["mocap_target"], pose=[Pose()], env_id=2)):
        assert not s.set_mocap_state(bad).success
    plain = MujocoServer(worlds.ARM7, nenv=1, device="cpu")
    assert not plain.set_mocap_state(MocapState(["mocap_target"], [Pose()])).success


def test_equality_services():
    """tests/test_server.py::test_equality_services on the port's CPU
    server, and per env: activation in one env only, the parameters
    replaced for all on the batch's device in its dtype, reset back to
    eq_active0 with the parameters kept; unknown names and bad env_ids
    rejected."""
    s = MujocoServer(worlds.ARM7, nenv=2, device="cpu")
    p = s.get_eq_constraint_parameters("ee_target")
    assert not p.active and p.element1 == "mocap_target" and p.element2 == "link6"
    np.testing.assert_allclose(p.relpose.position, [-0.5, 0, 0.4], atol=1e-7)
    p.active, p.torquescale, p.solverParameters.timeconst = True, 0.5, 0.05
    assert s.set_eq_constraint_parameters(p).success
    rd = s.get_eq_constraint_parameters("ee_target")
    assert rd.active and np.isclose(rd.torquescale, 0.5)
    assert np.isclose(rd.solverParameters.timeconst, 0.05)
    assert s.m.eq_data.dtype == s.m.eq_solref.dtype == torch.float32
    assert not s.set_eq_constraint_parameters(
        EqualityConstraintParameters(name="ghost")).success
    p.active, p.env_id = False, 1
    assert s.set_eq_constraint_parameters(p).success
    assert s.d.eq_active[:, 0].tolist() == [True, False]
    p.env_id = 2
    assert not s.set_eq_constraint_parameters(p).success
    assert s.step(2).success and s.reset().success
    assert s.d.eq_active[:, 0].tolist() == [False, False]
    assert np.isclose(s.get_eq_constraint_parameters("ee_target").torquescale, 0.5)


def test_arm7_config4_server():
    """BASELINE config 4's server on the CPU at 2 envs: MocapPlugin and
    RosControlPlugin (POSITION_PID on j4-j6), bench_config4's ctrl, the
    weld switched on with its anchor at the end-effector site and no
    relative pose, the target moved 0.59 m away: after 100 steps the
    site lies within 0.01 m of it, everything finite."""
    rc = RosControlPlugin({"joints": {j: {"method": "POSITION_PID",
                                          "pid": [20.0, 1.0, 0.5, 5.0],
                                          "effort_limit": 20.0}
                                      for j in ("j4", "j5", "j6")}})
    s = MujocoServer(worlds.ARM7, nenv=2, device="cpu", plugins=[MocapPlugin(), rc])
    p = s.get_eq_constraint_parameters("ee_target")
    p.active, p.anchor = True, np.array([0.0, 0.0, 0.1])
    p.relpose = Pose(np.zeros(3), np.array([1.0, 0, 0, 0]))
    assert s.set_eq_constraint_parameters(p).success
    assert s.set_ctrl(np.array(ARM7_CTRL)).success
    target = np.array([0.35, 0.15, 0.85])
    assert s.set_mocap_state(MocapState(["mocap_target"], [Pose(target)])).success

    def dist():
        site = smooth.fwd_position_smooth(s.m, s.d).site_xpos[:, s.m.site("ee_site")]
        return np.linalg.norm(site.double().numpy() - target, axis=1)
    before = dist()
    assert s.step(100).success
    after = dist()
    assert before.min() > 0.5 and after.max() < 0.01, (before, after)
    assert all(bool(torch.isfinite(t).all()) for t in (s.d.qpos, s.d.qvel, s.d.qacc))


def test_plugin_modules_and_chip_smoke_import_no_jax():
    """The new plugin modules, the URDF reader and chip_smoke.py (which
    drives ARM7 with them on the card) import nothing of JAX or of the JAX
    package."""
    code = ("import sys; import mujoco_ros_pkgs_tpu_torch.plugins.mocap, "
            "mujoco_ros_pkgs_tpu_torch.plugins.ros_control, "
            "mujoco_ros_pkgs_tpu_torch.plugins.urdf, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mujoco_ros_pkgs_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eq_parameters_take_effect_on_the_next_step():
    """Nothing cached keeps old equality parameters: after
    set_eq_constraint_parameters (anchor, relpose, torquescale, solref,
    solimp, on), 3 steps of the server equal, bit for bit, those of a
    server whose MJCF compiles the same weld."""
    edited = worlds.ARM7.replace(
        'solref="0.02 1" active="false"',
        'solref="0.05 0.8" solimp="0.8 0.9 0.002 0.4 2" anchor="0 0 0.1" '
        'relpose="0.1 0 0 1 0 0 0" torquescale="0.5"')
    assert edited != worlds.ARM7
    s = MujocoServer(worlds.ARM7, nenv=2, device="cpu")
    ref = MujocoServer(edited, nenv=2, device="cpu")
    p = s.get_eq_constraint_parameters("ee_target")
    p.active, p.anchor, p.torquescale = True, np.array([0.0, 0.0, 0.1]), 0.5
    p.relpose = Pose(np.array([0.1, 0.0, 0.0]), np.array([1.0, 0, 0, 0]))
    p.solverParameters.timeconst, p.solverParameters.dampratio = 0.05, 0.8
    sp = p.solverParameters
    sp.dmin, sp.dmax, sp.width, sp.midpoint, sp.power = 0.8, 0.9, 0.002, 0.4, 2.0
    assert s.step(2).success and ref.reset().success
    assert s.reset().success and s.set_eq_constraint_parameters(p).success
    for name in ("eq_data", "eq_solref", "eq_solimp"):
        assert torch.equal(getattr(s.m, name), getattr(ref.m, name)), name
    assert s.step(3).success and ref.step(3).success
    for field in ("qpos", "qvel", "qacc", "efc_force_contact"):
        assert torch.equal(getattr(s.d, field), getattr(ref.d, field)), field
    assert float(s.d.qfrc_constraint.abs().max()) > 0.0
