"""The port's server services against the JAX package's server.

The semantics of tests/test_server.py and tests/test_operator_surface.py
(eval-mode hash gating, step edge cases and the clock, reset with initial
joint states, body state in static TF frames, a body's mass, geom
properties and a geom's type, physics options, qpos, wrenches), held
against one JAX MujocoServer: after each edit, 3 steps of the port's server
(CPU, float64) equal the JAX server's (float64) within 1e-12 in qpos and
qvel.

The shared world is BOXES with 7 box geoms on its free body (84 contact
rows): more than the 64 rows K2 and K3 take, so the port steps it with the
general Newton, the counterpart of the JAX package's float64 solver
(ROADMAP C3: the same solver on both sides). The fused route's plan, which
every model edit rebuilds, is held against its plain step in float32 on
BOXES itself, and edits the port cannot step must leave the served model,
plan and batch untouched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu import msgs as jmsgs
from mujoco_ros_pkgs_tpu.server import MujocoServer as JaxServer

from mujoco_ros_pkgs_tpu_torch import msgs
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin
from mujoco_ros_pkgs_tpu_torch.server import AdminHashError, MujocoServer
from tests.torch_problems import box_cluster

NENV = 4
CLUSTER = box_cluster(7).replace("<freejoint/>", '<freejoint name="root"/>')


@pytest.fixture(scope="module")
def pair():
    j = JaxServer(CLUSTER, nenv=NENV, unpause=False)
    p = MujocoServer(CLUSTER, nenv=NENV, device="cpu", dtype=torch.float64)
    assert p._plan == fwd.GeneralPlan()
    return j, p


def _both(pair, method, *args, **kw):
    """Call a service on both servers (its message arguments built from the
    port's dataclasses in each package's own types); both must agree."""
    def conv(a, mod):
        if dataclasses.is_dataclass(a) and not isinstance(a, type):
            return getattr(mod, type(a).__name__)(
                **{f.name: conv(getattr(a, f.name), mod) for f in dataclasses.fields(a)})
        return a
    j, p = pair
    rj = getattr(j, method)(*(conv(a, jmsgs) for a in args),
                            **{k: conv(v, jmsgs) for k, v in kw.items()})
    rp = getattr(p, method)(*args, **kw)
    if hasattr(rj, "success"):
        assert rj.success == rp.success, (method, rj, rp)
    return rj, rp


def _same_state(pair, atol=1e-12):
    j, p = pair
    for f in ("qpos", "qvel", "ctrl", "xfrc_applied"):
        np.testing.assert_allclose(getattr(p.d, f).numpy(), np.asarray(getattr(j.d, f)),
                                   rtol=0, atol=atol, err_msg=f)
    assert p.sim_time == pytest.approx(j.sim_time, abs=1e-12)


def _same_steps(pair, n=3):
    rj, rp = _both(pair, "step", n)
    assert rj.success and rp.success
    _same_state(pair)


def _placed(pair):
    """Both servers reset, each env's box pressed into the floor, tilted and
    moving (in contact, sliding)."""
    _both(pair, "reset")
    for e in range(NENV):
        q = np.array([1.0, 0.1 * e, 0.05, 0.02])
        st = msgs.BodyState(name="box", env_id=e,
                            pose=msgs.Pose(np.array([0.1 * e, 0.0, 0.09]), q / np.linalg.norm(q)),
                            twist=msgs.Twist(np.array([0.3, 0.1 * e, -0.2]),
                                             np.array([0.5, -0.2, 0.1 * e])))
        rj, rp = _both(pair, "set_body_state", st)
        assert rp.success
    _same_state(pair)


def test_eval_mode_gates_every_mutating_call():
    """Eval mode needs a hash; every mutating call with a wrong hash fails
    with "invalid admin hash" and leaves the state, and with the right one
    gets past the gate (callbacks.cpp:213-223)."""
    with pytest.raises(AdminHashError):
        MujocoServer(worlds.BOXES, nenv=1, device="cpu", eval_mode=True)
    srv = MujocoServer(worlds.BOXES, nenv=2, device="cpu", eval_mode=True,
                       admin_hash="sekrit")
    calls = {
        "set_pause": (False,), "set_speed": (0.5,), "reset": (), "reload": (),
        "set_gravity": ((0, 0, -1.0),), "set_ctrl": (np.zeros(0),),
        "set_qpos": (np.array([0, 0, 1.0, 1, 0, 0, 0]),),
        "set_body_state": (msgs.BodyState(name="box"),),
        "set_geom_properties": (msgs.GeomProperties(name="box", size_0=0.2),),
        "set_physics_properties": ({"iterations": 5},),
        "set_eq_constraint_parameters": (msgs.EqualityConstraintParameters(name="x"),),
        "set_mocap_state": (msgs.MocapState(),), "register_noise_models": ([],),
        "load_initial_joint_states": ({}, {}), "apply_body_wrench": ("box", (0, 0, 1.0)),
        "clear_body_wrenches": (), "set_float": ("k", 1.0),
    }
    m, d = srv.m, srv.d
    for name, args in calls.items():
        res = getattr(srv, name)(*args, admin_hash="wrong")
        assert not res.success and res.status_message == "invalid admin hash", name
    assert srv.m is m and srv.d is d and srv.paused and srv.get_float("k") is None
    for name, args in calls.items():
        res = getattr(srv, name)(*args, admin_hash="sekrit")
        assert res.status_message != "invalid admin hash", name
    assert not srv.paused and srv.get_float("k") == 1.0


def test_step_edge_cases_and_the_clock(pair):
    """step(0) and step(-5) are rejected, step(3) advances sim time by 3 dt
    exactly, the clock stream gets it, and both servers step alike."""
    _placed(pair)
    j, p = pair
    assert not p.step(0).success and not p.step(-5).success
    ticks = []
    p.subscribe_clock(ticks.append)
    t0 = p.sim_time
    _same_steps(pair)
    p._clock_subs.clear()
    assert p.sim_time - t0 == pytest.approx(3 * 0.002, abs=1e-15)
    assert ticks == [p.sim_time]


def test_reset_applies_initial_joint_states(pair):
    """load_initial_joint_states applies at once and on every reset
    (ros_interface_test.cpp:263-425), on both servers alike."""
    _placed(pair)
    q = np.array([0.2, -0.1, 0.095, 0.99, 0.0, 0.1, 0.0])
    q[3:] /= np.linalg.norm(q[3:])
    v = [0.1, 0.0, -0.3, 0.0, 0.4, 0.0]
    _both(pair, "load_initial_joint_states", {"root": q.tolist()}, {"root": v})
    _same_state(pair)
    _same_steps(pair)
    _both(pair, "reset")
    j, p = pair
    np.testing.assert_allclose(p.d.qpos.numpy(), np.tile(q, (NENV, 1)), atol=1e-15)
    np.testing.assert_allclose(p.d.qvel.numpy(), np.tile(v, (NENV, 1)), atol=1e-15)
    assert p.sim_time == 0.0
    _same_steps(pair)
    rj, rp = _both(pair, "load_initial_joint_states", {}, {})
    assert rp.success and not p.load_initial_joint_states({"nope": [1.0]}, {}).success


def test_set_body_state_in_a_static_frame_and_its_mass(pair):
    """A pose in a chained static TF frame is applied in world coordinates
    (callbacks.cpp:298-302), an unknown frame is named in the failure, and
    a mass change re-derives the model's constants (invweight0) as the JAX
    server's does."""
    _placed(pair)
    s2 = np.sqrt(0.5)
    for srv in pair:
        srv.register_static_transform("world", "table", pos=(1.0, 0.5, 0.25),
                                      quat=(s2, 0, 0, s2))
        srv.register_static_transform("table", "shelf", pos=(0.0, 0.0, -0.16))
    st = msgs.BodyState(name="box", env_id=2,
                        pose=msgs.Pose(np.array([0.2, 0.0, 0.0]), np.array([1.0, 0, 0, 0]),
                                       frame_id="shelf"))
    _both(pair, "set_body_state", st, set_twist=False)
    j, p = pair
    np.testing.assert_allclose(p.get_body_state("box", 2).pose.position, [1.0, 0.7, 0.09],
                               atol=1e-12)
    _same_steps(pair)
    st.pose.frame_id = "mars"
    res = p.set_body_state(st)
    assert not res.success and "mars" in res.status_message
    st = msgs.BodyState(name="box", mass=2.0)
    rj, rp = _both(pair, "set_body_state", st, set_pose=False, set_twist=False, set_mass=True)
    assert rp.success and p.get_body_state("box").mass == 2.0
    for f in ("body_mass", "dof_invweight0", "body_invweight0"):
        np.testing.assert_allclose(getattr(p.m, f).numpy(), np.asarray(getattr(j.m, f)),
                                   rtol=1e-12, atol=1e-15, err_msg=f)
    _same_steps(pair)
    assert not p.set_body_state(msgs.BodyState(name="nope")).success


def test_geom_properties(pair):
    """get / set_geom_properties: friction, size (with the bounding radius)
    and the body's mass reach the step as on the JAX server."""
    _placed(pair)
    j, p = pair
    props = p.get_geom_properties("box")
    jprops = j.get_geom_properties("box")
    assert dataclasses.asdict(props) == pytest.approx(dataclasses.asdict(jprops))
    props.friction_slide, props.friction_spin, props.friction_roll = 0.3, 0.02, 0.001
    props.size_0, props.body_mass = 0.12, 0.8
    _both(pair, "set_geom_properties", props, set_friction=True, set_size=True,
          set_mass=True)
    assert dataclasses.asdict(p.get_geom_properties("box")) == pytest.approx(
        dataclasses.asdict(j.get_geom_properties("box")))
    for f in ("geom_friction", "geom_size", "geom_rbound", "body_mass", "dof_invweight0"):
        np.testing.assert_allclose(getattr(p.m, f).numpy(), np.asarray(getattr(j.m, f)),
                                   rtol=1e-12, atol=1e-15, err_msg=f)
    _same_steps(pair)
    assert not p.set_geom_properties(msgs.GeomProperties(name="missing"),
                                     set_friction=True).success


def test_set_type_rebuilds_the_contact_capacity(pair):
    """A geom made a sphere rebuilds the pair table and the batch's contact
    and row buffers to the JAX server's sizes, and steps alike; made a box
    again, it has its old capacity back."""
    _placed(pair)
    j, p = pair
    cap = p.d.contact.dist.shape[1]
    sphere = msgs.GeomProperties(name="box", type=int(msgs.GeomTypeMsg.SPHERE), size_0=0.1)
    _both(pair, "set_geom_properties", sphere, set_type=True, set_size=True)
    assert p.m.collision_pairs == tuple(map(tuple, j.m.collision_pairs))
    assert p.d.contact.dist.shape == np.asarray(j.d.contact.dist).shape != (NENV, cap)
    assert p.d.efc_force_contact.shape == np.asarray(j.d.efc_force_contact).shape
    _same_steps(pair)
    box = msgs.GeomProperties(name="box", type=int(msgs.GeomTypeMsg.BOX), size_0=0.1,
                              size_1=0.1, size_2=0.1)
    _both(pair, "set_geom_properties", box, set_type=True, set_size=True)
    assert p.d.contact.dist.shape == (NENV, cap)
    _same_steps(pair)


def test_physics_properties(pair):
    """get / set_physics_properties: array fields, an enum by name (and on
    the port iterations); a cone change rebuilds the row buffer to the JAX server's size;
    unknown fields and values are refused by both."""
    _placed(pair)
    j, p = pair

    def same_props():
        a, b = p.get_physics_properties(), j.get_physics_properties()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == (pytest.approx(b[k]) if not isinstance(b[k], str) else b[k]), k
    same_props()
    _both(pair, "set_physics_properties", {"timestep": 0.001, "tolerance": 1e-9,
                                           "impratio": 2.0, "gravity": [0.5, 0.0, -9.0]})
    same_props()
    # an integer field, on the port alone (on the JAX server it recompiles)
    assert p.set_physics_properties({"iterations": 7}).success
    assert p.get_physics_properties()["iterations"] == 7 and p.m.opt.iterations == 7
    assert p.set_physics_properties({"iterations": 100}).success
    _same_steps(pair)
    nefc = p.d.efc_force_contact.shape[1]
    _both(pair, "set_physics_properties", {"cone": "pyramidal"})
    assert p.d.efc_force_contact.shape == np.asarray(j.d.efc_force_contact).shape
    assert p.d.efc_force_contact.shape[1] != nefc
    same_props()
    _same_steps(pair)
    _both(pair, "set_physics_properties", {"cone": "ELLIPTIC", "timestep": 0.002,
                                           "tolerance": 1e-8, "impratio": 1.0,
                                           "gravity": [0, 0, -9.81]})
    same_props()
    for bad in ({"bogus": 1}, {"cone": "round"}):
        rj, rp = _both(pair, "set_physics_properties", bad)
        assert not rp.success


def test_set_qpos(pair):
    """set_qpos of every env and of one env (zero_qvel stills it)."""
    _placed(pair)
    j, p = pair
    q = np.array([0.0, 0.1, 0.092, 1.0, 0.0, 0.0, 0.0])
    _both(pair, "set_qpos", q)
    _both(pair, "set_qpos", q + [0.1, 0, 0, 0, 0, 0, 0], env_id=1, zero_qvel=True)
    assert float(p.d.qvel[1].abs().max()) == 0.0
    _same_steps(pair)
    assert not p.set_qpos(np.zeros(3)).success
    assert not p.set_qpos(q, env_id=NENV).success


def test_apply_body_wrench(pair):
    """A wrench on every env and another on one env reach the step as on the
    JAX server; cleared, the batch steps without them."""
    _placed(pair)
    j, p = pair
    _both(pair, "apply_body_wrench", "box", force=(1.0, 2.0, 3.0), torque=(0.1, 0.0, 0.0))
    _both(pair, "apply_body_wrench", "box", force=(0.0, 0.0, 30.0), env_id=3)
    assert p._applied
    _same_steps(pair)
    _both(pair, "clear_body_wrenches")
    assert not p._applied and float(p.d.xfrc_applied.abs().max()) == 0.0
    _same_steps(pair)
    assert not p.apply_body_wrench("nope").success


class _GeomWatcher(MujocoPlugin):
    def __init__(self):
        super().__init__()
        self.changed = []

    def on_geom_changed(self, m, geom_id):
        self.changed.append((geom_id, float(m.geom_friction[geom_id, 0])))


def test_unported_edits_fail_and_leave_the_served_model():
    """A geom type a geom cannot be set to (a mesh needs its asset) fails
    with the served model, its float64 master, the plan and the batch
    untouched; a geom edit that succeeds tells the plugins
    (on_geom_changed). Fluid (density, viscosity), which failed when this
    test was written, now succeeds: it takes BOXES off the fused route,
    and back when the medium is gone."""
    watcher = _GeomWatcher()
    srv = MujocoServer(worlds.BOXES, nenv=2, device="cpu", plugins=[watcher])
    before = (srv.m, srv._m64, srv._plan, srv.d)
    mesh = msgs.GeomProperties(name="box", type=int(msgs.GeomTypeMsg.MESH))
    assert not srv.set_geom_properties(mesh, set_type=True).success
    assert (srv.m, srv._m64, srv._plan, srv.d) == before and watcher.changed == []
    for props in ({"density": 1.2}, {"viscosity": 0.1}):
        assert srv.set_physics_properties(props).success, props
        assert srv._m64.has_fluid and not isinstance(srv._plan, type(before[2]))
        assert srv.step(2).success
    assert srv.set_physics_properties({"density": 0.0, "viscosity": 0.0}).success
    assert not srv._m64.has_fluid and isinstance(srv._plan, type(before[2]))
    props = srv.get_geom_properties("box")
    props.friction_slide = 0.4
    assert srv.set_geom_properties(props, set_friction=True).success
    assert watcher.changed == [(srv.m.geom("box"), pytest.approx(0.4))]


def test_fused_plan_follows_every_edit(monkeypatch):
    """BOXES in float32 on the fused route: after each edit (physics
    options, friction and size, the body's mass) the plan is rebuilt from
    the edited model and one server step equals the fused step's plain
    version of the edited model; a pyramidal cone moves it to the general
    route; a wrench steps on the general route (the fused kernel reads no
    applied force) and, cleared, the fused route returns."""
    srv = MujocoServer(worlds.BOXES, nenv=3, device="cpu")
    box = msgs.GeomProperties(name="box", friction_slide=0.5, friction_spin=0.01,
                              friction_roll=0.001, size_0=0.12, size_1=0.1, size_2=0.08)
    edits = [("set_physics_properties", ({"timestep": 0.001, "tolerance": 1e-6,
                                          "impratio": 3.0},), {}),
             ("set_geom_properties", (box,), dict(set_friction=True, set_size=True)),
             ("set_body_state", (msgs.BodyState(name="box", mass=1.5),),
              dict(set_pose=False, set_twist=False, set_mass=True))]
    q = np.array([0.02, -0.01, 0.095, 0.99, 0.05, -0.1, 0.0])
    q[3:] /= np.linalg.norm(q[3:])
    for method, args, kw in edits:
        params = srv._plan.params.clone()
        assert getattr(srv, method)(*args, **kw).success
        plan = srv._plan
        assert isinstance(plan, step_tpu.Plan) and not torch.equal(plan.params, params)
        torch.testing.assert_close(plan.params, fwd.make_plan(srv.m).params, rtol=0, atol=0)
        assert srv.set_qpos(q).success
        d = srv.d
        want = step_tpu.step_batched_plain(srv.m, d.qpos, d.qvel, d.qacc_warmstart,
                                           plan.params, plan.idx)
        assert srv.step(1).success
        for got, w in zip((srv.d.qpos, srv.d.qvel, srv.d.qacc), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert float(srv.m.body_mass[1]) == 1.5
    assert srv.set_physics_properties({"cone": "pyramidal"}).success
    assert srv._plan == fwd.GeneralPlan()
    assert srv.set_physics_properties({"cone": "elliptic"}).success
    assert isinstance(srv._plan, step_tpu.Plan)
    calls = []
    real = step_tpu.step
    monkeypatch.setattr(step_tpu, "step", lambda *a: calls.append(1) or real(*a))
    assert srv.set_gravity((0.0, 0.0, 0.0)).success
    assert srv.set_body_state(msgs.BodyState(name="box", pose=msgs.Pose(np.array([0, 0, 1.0]))),
                              set_twist=False).success
    v0 = srv.d.qvel.clone()
    assert srv.apply_body_wrench("box", force=(3.0, 0.0, 0.0)).success
    assert srv.step(1).success and calls == []
    dv = (srv.d.qvel - v0)[:, 0]
    torch.testing.assert_close(dv, torch.full_like(dv, 3.0 / 1.5 * 0.001), rtol=1e-5, atol=1e-7)
    assert srv.clear_body_wrenches().success
    assert srv.step(1).success and calls == [1]


def test_integrator_edit_leaves_the_fused_plan_and_euler_returns():
    """BOXES in float32 on the CPU, on the fused route: an RK4 edit by name
    moves it to the general route, where a server step equals fwd.step of
    the edited model from the same batch (RK4's four forward calls) bit for
    bit, and so do CG and PGS edits by name; an unknown name fails and
    changes nothing; Euler and Newton bring the fused plan back, whose step
    equals the fused step's plain version."""
    srv = MujocoServer(worlds.BOXES, nenv=3, device="cpu")
    q = np.array([0.02, -0.01, 0.095, 0.99, 0.05, -0.1, 0.0])
    q[3:] /= np.linalg.norm(q[3:])
    assert isinstance(srv._plan, step_tpu.Plan) and srv.set_qpos(q).success

    def steps_as_fwd_step():
        d = srv.d
        want = fwd.step(srv.m, d)
        assert srv.step(1).success
        for f in ("qpos", "qvel", "qacc", "qacc_warmstart", "time"):
            torch.testing.assert_close(getattr(srv.d, f), getattr(want, f), rtol=0, atol=0)
    assert srv.set_physics_properties({"integrator": "rk4"}).success
    assert srv._plan == fwd.GeneralPlan()
    assert srv.get_physics_properties()["integrator"] == "RK4"
    steps_as_fwd_step()
    for solver in ("CG", " pgs "):
        assert srv.set_physics_properties({"solver": solver}).success
        assert srv._plan == fwd.GeneralPlan()
        steps_as_fwd_step()
    assert srv.get_physics_properties()["solver"] == "PGS"
    before = (srv.m, srv._m64, srv._plan)
    res = srv.set_physics_properties({"integrator": "midpoint"})
    assert not res.success and "IMPLICITFAST" in res.status_message
    assert (srv.m, srv._m64, srv._plan) == before
    assert srv.set_physics_properties({"integrator": "Euler", "solver": "Newton"}).success
    plan = srv._plan
    assert isinstance(plan, step_tpu.Plan)
    d = srv.d
    want = step_tpu.step_batched_plain(srv.m, d.qpos, d.qvel, d.qacc_warmstart,
                                       plan.params, plan.idx)
    assert srv.step(1).success
    for got, w in zip((srv.d.qpos, srv.d.qvel, srv.d.qacc), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
