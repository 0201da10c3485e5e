"""The port's watch (server/watch.py and MujocoServer.start_watch) over
localhost on the CPU: the endpoints of tests/test_watch_control.py and
tests/test_watch_picking.py against the port's server, with no JAX
imported by this file.

- control: pause, step, reset, speed, ctrl and qpos (whole vectors and the
  page's one-slider form), keyframe load and save, physics options,
  wrenches, stats and the page's profiler figures, a 404 for an unknown
  endpoint and a 400 for a body that is not JSON, eval mode's admin hash,
  step refused while the physics loop runs unpaused;
- frames: /frame.png decodes to the screenshot of env 0;
- picking and drag: select at the centre pixel hits the ball, at a corner
  the background; perturb sets a mass-scaled spring wrench that moves the
  ball under stepping, clear_perturb removes it; minfo's layout and the
  model upload, a broken upload keeping the old model.
"""

import json
import os
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest

from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from mujoco_ros_pkgs_tpu_torch.utils import png

CONTROL_WORLD = """
<mujoco model="watchctl">
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="arm" pos="0 0 0.5">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom name="g" type="capsule" size="0.04 0.2" mass="0.3"/>
    </body>
    <body name="cambody" pos="0 -2 1">
      <camera name="maincam" mode="fixed" quat="0.7933533 0.6087614 0 0"/>
    </body>
  </worldbody>
  <actuator><motor name="m" joint="j" gear="1"/></actuator>
  <keyframe><key name="k0" qpos="0.4"/></keyframe>
</mujoco>
"""

PICK_WORLD = """
<mujoco model="pickworld">
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="ball" pos="0 0 0.5">
      <freejoint/>
      <geom name="bg" type="sphere" size="0.15" mass="0.5"/>
    </body>
    <body name="cambody" pos="0 -2 0.5">
      <camera name="maincam" mode="fixed" quat="0.7071068 0.7071068 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""
W, H = 64, 48


def _post(port, name, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/{name}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=60) as r:
        return r.read()


def _watched(xml, nenv, **kw):
    s = MujocoServer(xml, nenv=nenv, device="cpu", **kw)
    res = s.start_watch(port=0, fps=5.0, width=W, height=H)
    assert res.success, res.status_message
    return s, int(res.status_message)


@pytest.fixture(scope="module")
def control():
    s, port = _watched(CONTROL_WORLD, 2)
    yield s, port
    s.stop_watch()
    s.shutdown()


@pytest.fixture(scope="module")
def picking():
    s, port = _watched(PICK_WORLD, 2)
    yield s, port
    s.stop_watch()
    s.shutdown()


def test_pause_step_reset(control):
    s, port = control
    assert _post(port, "pause", {"paused": True})["success"]
    t0 = s.sim_time
    assert _post(port, "step", {"n": 50})["success"]
    assert s.sim_time > t0
    assert _post(port, "reset", {})["success"]
    assert abs(s.sim_time) < 1e-9


def test_speed(control):
    s, port = control
    assert _post(port, "speed", {"factor": 0.5})["success"]
    assert abs(s.realtime_factor - 0.5) < 1e-9
    assert _post(port, "speed", {"factor": -1})["success"]
    assert s.realtime_factor == -1.0


def test_ctrl_and_qpos_live_edit(control):
    s, port = control
    assert _post(port, "ctrl", {"values": [0.7]})["success"]
    np.testing.assert_allclose(s.d.ctrl.numpy(), 0.7, rtol=1e-6)
    assert _post(port, "ctrl", {"values": [0.1], "env_id": 1})["success"]
    np.testing.assert_allclose(s.d.ctrl[0].numpy(), 0.7, rtol=1e-6)
    np.testing.assert_allclose(s.d.ctrl[1].numpy(), 0.1, rtol=1e-6)
    assert not _post(port, "ctrl", {"values": [1, 2, 3]})["success"]
    assert _post(port, "ctrl", {"index": 0, "value": -0.3, "env_id": 1})["success"]
    np.testing.assert_allclose(s.d.ctrl.numpy()[:, 0], [0.7, -0.3], rtol=1e-6)
    assert _post(port, "qpos", {"values": [0.3], "zero_qvel": True})["success"]
    np.testing.assert_allclose(s.d.qpos.numpy(), 0.3, rtol=1e-6)
    np.testing.assert_allclose(s.d.qvel.numpy(), 0.0)


def test_keyframe_load_save(control):
    s, port = control
    assert _post(port, "keyframe", {"action": "load", "key": 0})["success"]
    np.testing.assert_allclose(s.d.qpos.numpy(), 0.4, rtol=1e-6)
    assert _post(port, "qpos", {"values": [-0.2]})["success"]
    assert _post(port, "keyframe", {"action": "save", "key": 0})["success"]
    assert _post(port, "qpos", {"values": [0.0]})["success"]
    assert _post(port, "keyframe", {"action": "load", "key": "k0"})["success"]
    np.testing.assert_allclose(s.d.qpos.numpy(), -0.2, atol=1e-6)
    assert not _post(port, "keyframe", {"action": "bogus"})["success"]


def test_physics_and_wrench(control):
    s, port = control
    assert _post(port, "physics", {"props": {"gravity": [0, 0, -5.0]}})["success"]
    np.testing.assert_allclose(s.m.opt.gravity.numpy(), [0, 0, -5.0])
    assert not _post(port, "physics", {"props": {"nope": 1}})["success"]
    assert _post(port, "wrench", {"body": "arm", "force": [0, 0, 1.0]})["success"]
    np.testing.assert_allclose(s.d.xfrc_applied[:, s.m.body("arm"), 2].numpy(), 1.0)
    assert not _post(port, "wrench", {"body": "ghost"})["success"]


def test_stats_frames_and_page(control):
    """GET /api/stats, /frame.png (the screenshot of env 0) and the page
    with its profiler canvases wired to the stats' fields."""
    s, port = control
    st = json.loads(_get(port, "api/stats"))
    assert "sim_time" in st and "solver_iterations_realized" in st
    assert st["paused"] is True and "gravity" in st["physics"]
    frame = png.decode(_get(port, "frame.png"))
    assert frame.shape == (H, W, 3) and frame.std() > 1.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "shot.png")
        assert s.screenshot(path=path, width=W, height=H).success
        np.testing.assert_array_equal(frame, png.read(path))
    html = _get(port, "").decode()
    assert 'id="prof_rt"' in html and 'id="prof_solver"' in html
    for field in ("measured_slowdown", "ncon_active", "solver_iterations_realized"):
        assert field in html


def test_unknown_endpoint_and_bad_json(control):
    s, port = control
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "nonsense", {})
    assert e.value.code == 404
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/pause", data=b"not json",
                                 headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def test_admin_hash_rejection():
    s, port = _watched(CONTROL_WORLD, 1, eval_mode=True, admin_hash="sekrit")
    try:
        r = _post(port, "pause", {"paused": True})
        assert not r["success"] and "hash" in r["message"]
        assert not _post(port, "ctrl", {"values": [0.5]})["success"]
        assert not _post(port, "perturb", {"body": "arm", "x": 1, "y": 1})["success"]
        assert _post(port, "pause", {"paused": True, "admin_hash": "sekrit"})["success"]
    finally:
        s.stop_watch()
        s.shutdown()


def test_step_rejected_while_running():
    s, port = _watched(CONTROL_WORLD, 1, unpause=True)
    s.start_physics_loop()
    try:
        assert not _post(port, "step", {"n": 10})["success"]
        assert _post(port, "pause", {"paused": True})["success"]
        assert _post(port, "step", {"n": 10})["success"]
    finally:
        s.stop_watch()
        s.shutdown()


def test_select(picking):
    s, port = picking
    r = _post(port, "select", {"x": W / 2, "y": H / 2})     # the camera looks at the ball
    assert r["success"] and r["body_name"] == "ball" and r["geom_name"] == "bg"
    assert 1.0 < r["dist"] < 2.5
    np.testing.assert_allclose(r["point"][1], -0.15, atol=0.05)
    r = _post(port, "select", {"x": 1, "y": 1})             # the sky
    assert r["success"] and r["body"] in (-1, 0)


def test_perturb_drag_moves_body(picking):
    s, port = picking
    _post(port, "reset", {})
    sel = _post(port, "select", {"x": W / 2, "y": H / 2})
    assert sel["body_name"] == "ball"
    r = _post(port, "perturb", {"body": "ball", "x": W * 0.75, "y": H * 0.25,
                                "dist": sel["dist"]})
    assert r["success"]
    assert np.linalg.norm(r["force"]) > 0.1
    b = s.m.body("ball")
    assert np.linalg.norm(s.d.xfrc_applied[:, b, :3].numpy()) > 0.1
    x0 = s.d.qpos[0, :3].numpy().copy()
    assert _post(port, "step", {"n": 100})["success"]
    assert s.d.qpos[0, 0].item() - x0[0] > 1e-3          # toward +x, the screen's right
    assert _post(port, "clear_perturb", {"body": "ball"})["success"]
    assert not s.d.xfrc_applied[:, b].numpy().any()


def test_minfo_sliders_and_model_upload(picking):
    s, port = picking
    mi = _post(port, "minfo", {})
    assert mi["success"] and mi["nq"] == 7 and mi["nu"] == 0
    assert "ball" in mi["bodies"] and len(mi["qpos"]) == 7
    assert _post(port, "qpos", {"index": 2, "value": 1.25, "zero_qvel": True})["success"]
    assert abs(s.d.qpos[0, 2].item() - 1.25) < 1e-6
    r = _post(port, "reload", {"model": PICK_WORLD.replace('size="0.15"', 'size="0.25"')})
    assert r["success"], r["message"]
    assert abs(s.m.geom_size[s.m.geom("bg"), 0].item() - 0.25) < 1e-6
    assert _post(port, "select", {"x": W / 2, "y": H / 2})["body_name"] == "ball"
    r = _post(port, "reload", {"model": "<mujoco><worldbody><geom type='mesh' mesh='nope'/>"
                                        "</worldbody></mujoco>"})
    assert not r["success"]
    assert _post(port, "select", {"x": W / 2, "y": H / 2})["success"]
