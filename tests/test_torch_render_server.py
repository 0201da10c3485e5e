"""The port server's cameras, TF frames and save_xml on the CPU, against the
JAX package where it has the same service.

- the camera streams (render/offscreen.py): frames at the stream's
  frequency (a chunk of `step` ends where a frame is due), the configured
  envs in one batch, laziness (no render and no read of the clock while no
  one takes the frames), the PNG dump's file names and its 16-bit seg;
- `screenshot`: the PNG holds the render;
- `camera_frames` and a body pose given in a `<cam>_link` and a
  `<cam>_optical_frame` frame, against a JAX server in float64 at 1e-12;
- the static TF registry: every camera's optical frame, chains through a
  camera's live frame, kept across reload;
- a plugin's render markers in the frames;
- `save_xml`: the file the port writes, loaded by the JAX package, gives
  the JAX package's own compile of the source at 1e-12 (MESH_PILE_CAM's
  hulls, exclude, pair and keyframe; SAVE_WORLD's height field, tendon,
  equality, motor and sensors); the port's compile of the written
  TERRAIN_CAM (the humanoid's limits and motors on a height field),
  TENDON_ACT (filterexact, integrator and site actuators, tendon limits
  and springs, a tendon equality) and PANDA_PICK equals its compile of the
  source at 1e-12, and reads as float32 to the same bits; a served model edited by services, saved and loaded again
  steps 20 float64 steps as the edited one; a writer that fails leaves the
  load-time source.
"""

import os

import numpy as np
import pytest
import torch

import mujoco_ros_pkgs_tpu as mrt
from mujoco_ros_pkgs_tpu.server import MujocoServer as JaxServer
from mujoco_ros_pkgs_tpu_torch.core import mjcf, mjcf_writer
from mujoco_ros_pkgs_tpu_torch.core import types as ptypes
from mujoco_ros_pkgs_tpu_torch.msgs import BodyState, GeomProperties, Pose
from mujoco_ros_pkgs_tpu_torch.ops.math import quat_to_mat
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin
from mujoco_ros_pkgs_tpu_torch.render import camera as rcam
from mujoco_ros_pkgs_tpu_torch.render.offscreen import StreamType
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from mujoco_ros_pkgs_tpu_torch.server import server as server_mod
from mujoco_ros_pkgs_tpu_torch.utils import png
from tests.test_torch_compile import assert_models_equal
from tests.torch_problems import MESH_PILE_CAM, PANDA_PICK, TENDON_ACT, TERRAIN_CAM

# CAMWORLD (tests/test_render_services.py) with a second camera riding on
# the ball
CAMWORLD = """
<mujoco model="camworld">
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" rgba="0.5 0.5 0.5 1"/>
    <body name="ball" pos="0 0 0.5">
      <freejoint/>
      <geom name="b" type="sphere" size="0.15" mass="0.2" rgba="1 0 0 1"/>
      <camera name="ballcam" pos="0 0 0.3" quat="0.9238795 0.3826834 0 0" fovy="60"/>
    </body>
    <body name="cambody" pos="0 -2 1">
      <camera name="maincam" mode="fixed" quat="0.7933533 0.6087614 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""
W, H = 32, 24
ALL = int(StreamType.RGB | StreamType.DEPTH | StreamType.SEGMENTED)


def _fmt(a) -> str:
    return " ".join(repr(float(x)) for x in np.ravel(a))


# a small world with what save_xml writes: a hull, a height field, a hinge
# with a limit, damping and a motor, a fixed tendon, an equality, sensors,
# a camera, a contact exclude and a keyframe
_HULL = np.random.default_rng(7).normal(size=(12, 3)) * (0.06, 0.05, 0.04)
_ELEV = np.random.default_rng(8).uniform(0.0, 1.0, (8, 8))
SAVE_WORLD = f"""
<mujoco model="save_world">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic" iterations="20"/>
  <asset>
    <mesh name="hull" vertex="{_fmt(_HULL)}"/>
    <hfield name="field" nrow="8" ncol="8" size="1 1 0.1 0.05" elevation="{_fmt(_ELEV)}"/>
  </asset>
  <worldbody>
    <geom name="ground" type="hfield" hfield="field" rgba="0.3 0.6 0.3 1"/>
    <camera name="top" pos="0 -1.2 1.0" quat="0.9238795 0.3826834 0 0"/>
    <site name="rf" pos="0 0 0.8" zaxis="0 0 -1"/>
    <body name="hull" pos="0.1 0 0.25" euler="0.3 0.2 0.1">
      <freejoint/>
      <geom name="hullg" type="mesh" mesh="hull" mass="0.4" rgba="0.8 0.2 0.2 1"/>
    </body>
    <body name="box" pos="-0.2 0.1 0.3">
      <freejoint/>
      <geom name="boxg" type="box" size="0.04 0.05 0.03" mass="0.3"/>
    </body>
    <body name="arm" pos="0.4 0.4 0.5">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1" range="-1 1" limited="true"/>
      <geom name="link1" type="capsule" fromto="0 0 0 0.2 0 0" size="0.02"/>
      <body name="arm2" pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom name="link2" type="capsule" fromto="0 0 0 0.2 0 0" size="0.02"/>
        <site name="tip" pos="0.2 0 0"/>
      </body>
    </body>
  </worldbody>
  <contact><exclude body1="hull" body2="box"/></contact>
  <tendon><fixed name="t"><joint joint="j1" coef="1"/><joint joint="j2" coef="-0.5"/></fixed>
  </tendon>
  <equality><joint joint1="j2" joint2="j1" polycoef="0 0.3 0 0 0"/></equality>
  <actuator><motor name="m1" joint="j1" gear="2" ctrlrange="-1 1"/></actuator>
  <sensor>
    <rangefinder name="range" site="rf"/>
    <jointpos name="q1" joint="j1"/>
    <framepos name="tip_pos" objtype="site" objname="tip"/>
  </sensor>
  <keyframe><key name="k" qpos="0.1 0 0.25 1 0 0 0 -0.2 0.1 0.3 1 0 0 0 0.2 -0.1" ctrl="0.5"/>
  </keyframe>
</mujoco>
"""


def cam_server(nenv=3, **cfg):
    conf = {"maincam": dict(dict(stream_type=ALL, frequency=100.0, width=W, height=H,
                                 env_ids=(0, 2)), **cfg)}
    return MujocoServer(CAMWORLD, nenv=nenv, device="cpu", dtype=torch.float64,
                        cam_config=conf)


def test_stream_frames_at_its_frequency():
    """100 Hz at dt 0.002: a frame every 5 steps, the first after step 1;
    envs 0 and 2 in one batch; the red ball in the seg, its depth near the
    camera's distance; the other camera's stream stays idle."""
    srv = cam_server()
    got = []
    srv.render_manager.subscribe("maincam", got.append)
    assert srv.step(20).success
    assert [round(m["time"] / 0.002) for m in got] == [1, 6, 11, 16]
    msg = got[-1]
    assert msg["env_ids"] == (0, 2)
    assert msg["rgb"].shape == (2, H, W, 3) and msg["depth"].shape == (2, H, W)
    assert msg["segmented"].shape == (2, H, W) and msg["segmented"].dtype == np.int32
    ball = srv.m.geom("b")
    px = msg["segmented"][0] == ball
    assert px.sum() > 5 and (msg["rgb"][0][px][:, 0] > msg["rgb"][0][px][:, 1] + 0.1).all()
    assert 1.0 < msg["depth"][0][px].mean() < 3.0
    np.testing.assert_array_equal(msg["segmented"][0], msg["segmented"][1])
    assert srv.render_manager.streams["ballcam"].frame_count == 0
    info = srv.render_manager.streams["maincam"].camera_info(srv.m)
    assert info["width"] == W and abs(info["cy"] - H / 2) < 1e-12


def test_stream_is_lazy(monkeypatch):
    """No subscriber and no png_dir: no render and no read of the clock (on
    the card, each read waits for the steps in flight); once subscribed,
    both."""
    srv = cam_server()
    reads, renders = [], []
    real_time = server_mod.MujocoServer.sim_time
    monkeypatch.setattr(server_mod.MujocoServer, "sim_time",
                        property(lambda s: reads.append(1) or real_time.fget(s)))
    real_render = rcam.render
    monkeypatch.setattr(rcam, "render", lambda *a, **k: renders.append(1) or real_render(*a, **k))
    assert srv.step(30).success
    assert not reads and not renders
    srv.render_manager.subscribe("maincam", lambda msg: None)
    assert srv.step(5).success
    assert reads and len(renders) == 1


def test_png_dump(tmp_path):
    """png_dir: <cam>_<frame>_env<e>_{rgb,depth,seg}.png for each env of a
    frame; rgb as the float frame scaled, depth in millimetres, seg + 1 in
    16 bits (the background 0)."""
    srv = cam_server(png_dir=str(tmp_path), frequency=200.0)
    got = []
    srv.render_manager.subscribe("maincam", got.append)
    assert srv.step(7).success          # frames after steps 1, 4 and 7
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"maincam_{k:06d}_env{e}_{kind}.png" for k in (1, 2, 3)
                           for e in (0, 2) for kind in ("rgb", "depth", "seg"))
    last = got[-1]
    seg = png.read(str(tmp_path / "maincam_000003_env2_seg.png"))
    np.testing.assert_array_equal(seg, last["segmented"][1] + 1)
    rgb = png.read(str(tmp_path / "maincam_000003_env0_rgb.png"))
    np.testing.assert_array_equal(rgb, np.clip(last["rgb"][0] * 255.0, 0, 255).astype(np.uint8))
    depth = png.read(str(tmp_path / "maincam_000003_env0_depth.png"))
    np.testing.assert_array_equal(depth, np.clip(last["depth"][0] * 1000.0, 0, 65535)
                                  .astype(np.uint16))


def test_screenshot(tmp_path):
    srv = cam_server()
    assert srv.step(3).success
    path = str(tmp_path / "shot.png")
    r = srv.screenshot("maincam", path, env_id=1, width=W, height=H)
    assert r.success and r.status_message == path
    d = srv._derived(srv.d)
    rgb, _, _ = rcam.render(srv.m, d, srv.m.cam_names.index("maincam"), W, H, env_ids=[1])
    np.testing.assert_array_equal(png.read(path), np.clip(rgb[0].numpy() * 255.0, 0, 255)
                                  .astype(np.uint8))
    assert not srv.screenshot("nope", path).success
    assert not srv.screenshot("maincam", path, env_id=3).success
    assert srv.screenshot().success          # the first camera, no file


@pytest.fixture(scope="module")
def servers():
    """A port server and a JAX server of CAMWORLD in float64, two envs each
    with the same seeded qpos, stepped once (the kinematics of that qpos)."""
    rng = np.random.default_rng(11)
    ps = MujocoServer(CAMWORLD, nenv=2, device="cpu", dtype=torch.float64)
    js = JaxServer(CAMWORLD, nenv=2, unpause=False)
    for e in range(2):
        q = np.concatenate([rng.uniform(-0.3, 0.3, 3) + [0, 0, 0.6], rng.normal(size=4)])
        q[3:] /= np.linalg.norm(q[3:])
        assert ps.set_qpos(q, env_id=e).success and js.set_qpos(q, env_id=e).success
    assert ps.step(1).success and js.step(1).success
    yield ps, js
    js.shutdown()


def test_camera_frames_and_poses_in_camera_frames_vs_jax(servers):
    ps, js = servers
    for e in range(2):
        pf, jf = ps.camera_frames(e), js.camera_frames(e)
        assert pf.keys() == jf.keys() == {"maincam_link", "ballcam_link"}
        for k in pf:
            for a, b in zip(pf[k], jf[k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12, err_msg=k)
    pose = Pose(position=np.array([0.1, -0.2, 1.5]),
                orientation=np.array([0.9, 0.1, -0.3, 0.2]))
    for frame in ("ballcam_link", "maincam_optical_frame"):
        pose.frame_id = frame
        st = BodyState(name="ball", pose=pose, env_id=1)
        assert ps.set_body_state(st, set_twist=False).success
        assert js.set_body_state(st, set_twist=False).success
        np.testing.assert_allclose(ps.get_batch_state()["qpos"],
                                   np.asarray(js.d.qpos), rtol=0, atol=1e-12, err_msg=frame)
    pose.frame_id = "nocam_link"
    assert not ps.set_body_state(BodyState(name="ball", pose=pose), set_twist=False).success


def test_static_tf():
    srv = cam_server()
    for cam in ("maincam", "ballcam"):
        parent, pos, quat = srv.lookup_transform(f"{cam}_optical_frame")
        assert parent == f"{cam}_link"
        np.testing.assert_array_equal(pos, 0.0)
        np.testing.assert_array_equal(quat, [0.5, -0.5, 0.5, -0.5])
    assert set(srv.static_transforms()) == {"maincam_optical_frame", "ballcam_optical_frame"}
    assert srv.lookup_transform("nope") is None
    # a static frame under a camera's live frame resolves through it
    srv.register_static_transform("maincam_link", "lens", pos=(0.0, 0.0, -0.5))
    link_pos, link_quat = srv.camera_frames(0)["maincam_link"]
    pos, quat = srv._resolve_frame("lens", 0)
    np.testing.assert_allclose(pos, link_pos + rcam._mv(torch.from_numpy(np.asarray(
        quat_to_mat(torch.from_numpy(link_quat)))), torch.tensor([0.0, 0.0, -0.5], dtype=torch.float64)).numpy(),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(quat, link_quat, rtol=0, atol=1e-12)
    assert srv.reload().success
    assert {"maincam_optical_frame", "ballcam_optical_frame", "lens"} <= set(
        srv.static_transforms())


def test_plugin_markers_are_drawn():
    class Beacon(MujocoPlugin):
        seen = []

        def render_callback(self, m, d, sim_time):
            Beacon.seen.append((d.qpos.shape[0], sim_time))
            return [rcam.RenderMarker(pos=torch.tensor([0.4, -0.6, 0.7], dtype=torch.float64),
                                      size=torch.tensor([0.15, 0.0, 0.0], dtype=torch.float64),
                                      rgba=torch.tensor([0.0, 0.0, 1.0, 1.0]))]
    srv = MujocoServer(CAMWORLD, nenv=2, device="cpu", dtype=torch.float64, plugins=[Beacon()],
                       cam_config={"maincam": {"stream_type": ALL, "width": W, "height": H}})
    got = []
    srv.render_manager.subscribe("maincam", got.append)
    assert srv.step(2).success
    assert Beacon.seen and Beacon.seen[0][0] == 2
    seg, rgb = got[0]["segmented"][0], got[0]["rgb"][0]
    mine = seg == srv.m.ngeom
    assert mine.sum() > 5 and (rgb[mine][:, 2] > rgb[mine][:, 0] + 0.2).all()


def _jax_fields(jm):
    """The JAX model's values of every field of the port's Model."""
    arrays = {f"opt.{k}": np.asarray(getattr(jm.opt, k)) for k in ptypes.array_fields(ptypes.Option)}
    arrays.update({k: np.asarray(getattr(jm, k)) for k in ptypes.array_fields(ptypes.Model)})
    static = {f"opt.{k}": getattr(jm.opt, k) for k in ptypes.static_fields(ptypes.Option)}
    static.update({k: getattr(jm, k) for k in ptypes.static_fields(ptypes.Model)
                   if k != "name"})
    return arrays, static


@pytest.mark.parametrize("world", ["MESH_PILE_CAM", "SAVE_WORLD"])
def test_saved_xml_loads_in_the_jax_package(world, tmp_path):
    xml = {"MESH_PILE_CAM": MESH_PILE_CAM, "SAVE_WORLD": SAVE_WORLD}[world]
    srv = MujocoServer(xml, nenv=1, device="cpu", dtype=torch.float64)
    path = str(tmp_path / "saved.xml")
    assert srv.save_xml(path).status_message == path
    want_a, want_s = _jax_fields(mrt.load_model_from_string(xml))
    got_a, got_s = _jax_fields(mrt.load_model_from_string(open(path).read()))
    assert got_s == want_s
    for k, want in want_a.items():
        assert got_a[k].shape == want.shape, k
        np.testing.assert_allclose(got_a[k], want, rtol=0, atol=1e-12, err_msg=k)


def test_save_xml_reload_steps_as_the_edited_model(tmp_path, monkeypatch):
    for xml in (TERRAIN_CAM, TENDON_ACT, PANDA_PICK):
        m = mjcf.load_model_from_string(xml)
        m2 = mjcf.load_model_from_string(mjcf_writer.model_to_xml(m))
        assert_models_equal(m2, m)
        for k in ptypes.array_fields(ptypes.Model):
            assert torch.equal(getattr(m2, k).float(), getattr(m, k).float()), k
    def served():
        srv = MujocoServer(SAVE_WORLD, nenv=2, device="cpu", dtype=torch.float64)
        assert srv.set_gravity([0.5, 0.0, -7.0]).success
        assert srv.set_geom_properties(GeomProperties(name="boxg", friction_slide=0.4,
                                                      friction_spin=0.01, friction_roll=0.001),
                                       set_friction=True).success
        assert srv.set_physics_properties({"integrator": "implicitfast"}).success
        assert srv.load_keyframe("k").success
        return srv
    srv = served()
    path = str(tmp_path / "live.xml")
    assert srv.save_xml(path).success
    again = MujocoServer(path, nenv=2, device="cpu", dtype=torch.float64)
    assert again.load_keyframe("k").success
    assert srv.set_ctrl([0.7]).success and again.set_ctrl([0.7]).success
    assert srv.step(20).success and again.step(20).success
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(again.get_batch_state()[k], srv.get_batch_state()[k],
                                   rtol=0, atol=1e-12, err_msg=k)
    # a writer that fails: the load-time source, said in the message
    monkeypatch.setattr(mjcf_writer, "model_to_xml", lambda m: 1 / 0)
    r = served().save_xml(str(tmp_path / "src.xml"))
    assert r.success and "load-time source" in r.status_message
    assert open(tmp_path / "src.xml").read() == SAVE_WORLD
