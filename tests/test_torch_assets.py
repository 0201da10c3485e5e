"""MJCF's <asset>, <include>, <contact>, <keyframe> and cameras through the
port's compiler, against the JAX package.

One world, written under tmp_path with its asset files, holds every form
the port reads: five meshes (inline with a scale, binary and ASCII STL, OBJ
and MuJoCo's legacy MSH, under <compiler meshdir>), three height fields
(inline, MuJoCo's binary file and a gray PNG whose rows use all five PNG
filters), bodies from a nested <include>, a <contact> exclude and pair, two
keyframes (act, ctrl, mocap poses) and two cameras. The JAX package
compiles it once (its PNG reader is PIL).

- compile: every field equal to model_from_numpy of the JAX compile
  (integers exactly, floats within 1e-12 of each value's size): the
  hulls and their padding, the
  grids, geom frames folded with the hulls' principal frames, masses and
  inertias from the hulls' volumes, the keys, the cameras, the pair table
  with its exclude and pair;
- the file formats: each mesh file's hull equals the inline one's within
  float32's rounding (STL and MSH store float32);
- the PNG decoder (utils/png.py) against PIL on gray and RGB images with
  every filter type, luminance as PIL's convert("L");
- <include>: nested, a missing file, a cycle;
- what still raises: mesh-fitting, an undefined mesh, a degenerate hull, a
  <pair>'s own contact parameters, an unknown name in <contact>, an asset
  type the port does not read;
- the server's load_keyframe (by name and index, into every env) and
  save_keyframe, on the CPU.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.server import MujocoServer
from mujoco_ros_pkgs_tpu_torch.utils import png
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy

_RNG = np.random.default_rng(21)
# a 16-point hull on a 4 cm ellipsoid, and a bin's 5 x 4 and 4 x 6 grids
HULL = _RNG.normal(size=(16, 3))
HULL = HULL / np.linalg.norm(HULL, axis=1, keepdims=True) * (0.04, 0.03, 0.025)
GRID_BIN = _RNG.uniform(-1.0, 2.0, size=(5, 4))
GRID_PNG = _RNG.integers(0, 256, size=(4, 6), dtype=np.uint8)


def _fmt(a):
    return " ".join(f"{x:.17g}" for x in np.ravel(a))


def _png_bytes(img, filters):
    """A PNG of img (H, W) or (H, W, 3) uint8, row r filtered with
    filters[r % len(filters)] (PNG spec section 9)."""
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    raw, prev = bytearray(), bytearray(w * nch)
    for r in range(h):
        line = bytearray(img[r].tobytes())
        ft = filters[r % len(filters)]
        out = bytearray(len(line))
        for i, x in enumerate(line):
            left = line[i - nch] if i >= nch else 0
            up, up_left = prev[i], (prev[i - nch] if i >= nch else 0)
            pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
                    4: png._paeth(left, up, up_left)}[ft]
            out[i] = (x - pred) & 0xFF
        raw += bytes([ft]) + out
        prev = line

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if nch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _write_assets(d):
    """The mesh and height-field files of WORLD under directory d/assets."""
    from scipy.spatial import ConvexHull
    a = os.path.join(d, "assets")
    os.makedirs(a, exist_ok=True)
    tris = HULL[ConvexHull(HULL).simplices]
    with open(os.path.join(a, "hull.stl"), "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(np.zeros(3, np.float32).tobytes() + t.astype(np.float32).tobytes()
                    + b"\0\0")
    with open(os.path.join(a, "hull_ascii.stl"), "w") as f:
        f.write("solid hull\n" + "".join(
            "facet normal 0 0 0\nouter loop\n" + "".join(
                f"vertex {_fmt(v)}\n" for v in t) + "endloop\nendfacet\n" for t in tris)
            + "endsolid hull\n")
    with open(os.path.join(a, "hull.obj"), "w") as f:
        f.write("".join(f"v {_fmt(v)}\n" for v in HULL) + "f 1 2 3\n")
    with open(os.path.join(a, "hull.msh"), "wb") as f:
        f.write(struct.pack("<4i", len(HULL), 0, 0, 0) + HULL.astype(np.float32).tobytes())
    with open(os.path.join(a, "grid.bin"), "wb") as f:
        f.write(struct.pack("<2i", *GRID_BIN.shape) + GRID_BIN.astype(np.float32).tobytes())
    with open(os.path.join(a, "grid.png"), "wb") as f:
        f.write(_png_bytes(GRID_PNG, (0, 1, 2, 3, 4)))


PARTS = """<mujoco>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
      <camera name="wrist" pos="0.3 0 0" xyaxes="0 1 0 0 0 1" fovy="60"/>
    </body>
    <include file="parts/more.xml"/>
  </worldbody>
  <actuator>
    <motor name="m" joint="hinge"/>
    <intvelocity name="iv" joint="hinge" kp="5" actrange="-1 1"/>
  </actuator>
</mujoco>"""
MORE = """<mujoco>
  <body name="target" mocap="true" pos="0.5 0 1.2">
    <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
  </body>
</mujoco>"""
WORLD = f"""<mujoco model="assets">
  <compiler meshdir="assets"/>
  <option timestep="0.002" cone="elliptic"/>
  <asset>
    <mesh name="inline" vertex="{_fmt(HULL)}" scale="1.5 1 0.8"/>
    <mesh name="stl" file="hull.stl"/>
    <mesh name="stl_ascii" file="hull_ascii.stl"/>
    <mesh file="hull.obj"/>
    <mesh name="msh" file="hull.msh"/>
    <hfield name="flat" nrow="3" ncol="4" size="1 0.5 0.2 0.1"
            elevation="0 1 2 3 4 5 6 7 8 9 10 11"/>
    <hfield name="bin" file="grid.bin" size="2 2 0.3 0.1"/>
    <hfield name="img" file="grid.png" size="1 1.5 0.1 0.05"/>
    <material name="unused" rgba="1 0 0 1"/>
  </asset>
  <worldbody>
    <camera name="overview" pos="0 -3 2" euler="60 0 0"/>
    <geom name="floor" type="hfield" hfield="bin"/>
    <geom name="step" type="hfield" hfield="img" pos="3 0 0"/>
    <geom name="tile" type="hfield" hfield="flat" pos="-3 0 0"/>
    <body name="a" pos="0 0 0.3"><freejoint/>
      <geom name="ga" type="mesh" mesh="inline" pos="0.01 0 0" euler="10 20 30"/></body>
    <body name="b" pos="0.2 0 0.3"><freejoint/><geom name="gb" type="mesh" mesh="stl"/></body>
    <body name="c" pos="0.4 0 0.3"><freejoint/>
      <geom name="gc" type="mesh" mesh="stl_ascii" mass="0.7"/></body>
    <body name="d" pos="0.6 0 0.3"><freejoint/><geom name="gd" type="mesh" mesh="hull"/></body>
    <body name="e" pos="0.8 0 0.3"><freejoint/>
      <geom name="ge" type="mesh" mesh="msh" density="500"/></body>
  </worldbody>
  <include file="parts/bodies.xml"/>
  <contact>
    <exclude body1="a" body2="b"/>
    <pair geom1="ga" geom2="tile"/>
  </contact>
  <keyframe>
    <key name="home" qpos="{_fmt(np.arange(36) * 0.01 + 0.1)}" ctrl="0.5" act="0.25"/>
    <key time="1.5" qvel="{_fmt(np.arange(31) * -0.02)}" mpos="0.1 0.2 1.3"
         mquat="0 1 0 0"/>
  </keyframe>
</mujoco>"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("assets"))
    _write_assets(d)
    os.makedirs(os.path.join(d, "parts"))
    for name, xml in (("bodies.xml", PARTS), ("more.xml", MORE)):
        with open(os.path.join(d, "parts", name), "w") as f:
            f.write(xml)
    path = os.path.join(d, "world.xml")
    with open(path, "w") as f:
        f.write(WORLD)
    return path


def test_assets_compile_as_jax(world):
    """Every field of the port's compile equals the JAX compile's: five
    hulls (16 points each, padded alike), three grids, the geoms folded
    with their hulls' frames, hull masses and inertias, two keys, two
    cameras, the pair table with its exclude and explicit pair."""
    pm = mjcf.load_model(world)
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jmjcf.load_model(world))),
                        rtol=1e-12)
    assert pm.mesh_names == ("inline", "stl", "stl_ascii", "hull", "msh")
    assert pm.mesh_vertnum == (16,) * 5 and pm.mesh_vert.shape == (5, 16, 3)
    assert (pm.hfield_names, pm.hfield_nrow, pm.hfield_ncol) == (
        ("flat", "bin", "img"), (3, 5, 4), (4, 4, 6))
    assert pm.geom_type[pm.geom("floor")] == int(GeomType.HFIELD)
    assert pm.geom_dataid[pm.geom("gd")] == 3 and pm.geom_dataid[pm.geom("step")] == 2
    assert (pm.nkey, pm.key_names, pm.ncam, pm.cam_names) == (
        2, ("home", ""), 2, ("overview", "wrist"))
    assert pm.pair_exclude == ((pm.body("a"), pm.body("b")),)
    assert pm.pair_explicit == ((pm.geom("ga"), pm.geom("tile")),)
    assert (pm.geom("ga"), pm.geom("gb")) not in pm.collision_pairs
    assert pm.na == 1 and pm.nmocap == 1 and float(pm.key_time[1]) == 1.5


def test_mesh_files_give_the_inline_hull(world):
    """The STL (binary and ASCII), OBJ and MSH files of HULL compile to the
    hull of HULL given inline (without the scale): its vertices (in the
    order qhull lists them, which follows the file's), volume-derived mass
    and inertia, within float32's rounding of the binary files."""
    pm = mjcf.load_model(world)
    inline = mjcf._Mesh("x", HULL)

    def rows(v):
        return v[np.lexsort(np.round(v, 5).T)]
    for did in range(1, 5):
        tol = 1e-12 if pm.mesh_names[did] in ("stl_ascii", "hull") else 1e-6
        np.testing.assert_allclose(rows(pm.mesh_vert[did].numpy()), rows(inline.verts),
                                   rtol=0, atol=tol, err_msg=pm.mesh_names[did])
    np.testing.assert_allclose(float(pm.body_mass[pm.body("b")]), 1000.0 * inline.volume,
                               rtol=1e-5)
    assert float(pm.body_mass[pm.body("c")]) == 0.7


@pytest.mark.parametrize("rgb", [False, True])
def test_png_decoder_matches_pil(rgb, tmp_path):
    """utils/png.py decodes 8-bit gray and RGB PNGs whose rows use every
    filter type as PIL does, and luminance equals PIL's convert("L")."""
    from PIL import Image
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(9, 7, 3) if rgb else (9, 7), dtype=np.uint8)
    path = tmp_path / "img.png"
    path.write_bytes(_png_bytes(img, (4, 3, 2, 1, 0)))
    got = png.read(str(path))
    pil = Image.open(path)
    np.testing.assert_array_equal(got, np.asarray(pil))
    np.testing.assert_array_equal(png.luminance(got), np.asarray(pil.convert("L")))


@pytest.mark.parametrize("case", ["nested", "missing", "cycle"])
def test_include(case, tmp_path):
    """<include> splices a file's top-level children, files including
    files; a missing file and a cycle raise ValueError naming them."""
    files = {
        "nested": {"a.xml": '<mujoco><worldbody><include file="b.xml"/></worldbody></mujoco>',
                   "b.xml": '<mujoco><body name="x"><freejoint/><geom size="0.1"/></body>'
                            '<include file="c.xml"/></mujoco>',
                   "c.xml": '<mujoco><geom name="g" type="plane" size="1 1 1"/></mujoco>'},
        "missing": {"a.xml": '<mujoco><include file="nowhere.xml"/></mujoco>'},
        "cycle": {"a.xml": '<mujoco><include file="b.xml"/></mujoco>',
                  "b.xml": '<mujoco><include file="a.xml"/></mujoco>'}}[case]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    xml = '<mujoco><include file="a.xml"/><worldbody/></mujoco>'
    if case == "nested":
        m = mjcf.load_model_from_string(xml, base_dir=str(tmp_path))
        assert m.body_names == ("world", "x") and m.geom_names == ("", "g")
        assert m.collision_pairs == ((1, 0),)
    else:
        with pytest.raises(ValueError, match="nowhere.xml" if case == "missing" else "cycle"):
            mjcf.load_model_from_string(xml, base_dir=str(tmp_path))


_RAISES = (
    ('<asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>'
     '<worldbody><geom type="box" mesh="m"/></worldbody>', "mesh-fitting"),
    ('<worldbody><geom type="mesh" mesh="nope"/></worldbody>', "undefined mesh 'nope'"),
    ('<asset><mesh name="m" vertex="0 0 0 1 0 0 2 0 0 3 0 0"/></asset>', "degenerate"),
    ('<worldbody><geom name="g" size="0.1"/><body name="b"><geom name="h" size="0.1"/>'
     '</body></worldbody><contact><pair geom1="g" geom2="h" condim="1"/></contact>',
     "condim"),
    ('<worldbody/><contact><exclude body1="world" body2="nobody"/></contact>',
     "unknown body 'nobody'"),
    ('<asset><skin name="s"/></asset>', "skin"),
)


def test_unported_asset_forms_raise():
    """Mesh-fitting, an undefined mesh, a degenerate hull, a <pair>'s own
    contact parameters, an unknown body in <exclude> and an asset type the
    port does not read raise ValueError naming them."""
    for xml, match in _RAISES:
        with pytest.raises(ValueError, match=match):
            mjcf.load_model_from_string(f"<mujoco>{xml}</mujoco>")


def test_server_keyframes(world):
    """load_keyframe by name into every env (qpos, act, ctrl; qvel and the
    unset mocap pose zero), by index (time, qvel, the mocap pose);
    a bad name or index fails; save_keyframe stores one env's state in the
    served model's slot, and loading it back restores it everywhere."""
    srv = MujocoServer(world, nenv=3, device="cpu", dtype=torch.float64)
    m = srv._m64
    assert srv.load_keyframe("home").success
    d = srv.d
    np.testing.assert_array_equal(d.qpos.numpy(), np.tile(m.key_qpos[0].numpy(), (3, 1)))
    assert (d.ctrl[:, 0] == 0.5).all() and (d.ctrl[:, 1] == 0).all()
    assert (d.act == 0.25).all() and (d.qvel == 0).all()
    # an unset mpos is zeros, as the JAX package compiles it
    assert (d.mocap_pos == 0).all() and (d.mocap_quat[..., 0] == 1).all()
    assert srv.load_keyframe(1).success
    d = srv.d
    assert (d.time == 1.5).all()
    np.testing.assert_array_equal(d.qvel[2].numpy(), np.arange(31) * -0.02)
    np.testing.assert_array_equal(d.mocap_quat[0, 0].numpy(), [0, 1, 0, 0])
    assert not srv.load_keyframe("nope").success and not srv.load_keyframe(2).success
    assert srv.step(5).success
    qpos = srv.d.qpos[1].clone()
    assert srv.save_keyframe(0, env_id=1).success
    np.testing.assert_array_equal(srv._m64.key_qpos[0].numpy(), qpos.numpy())
    assert not srv.save_keyframe(0, env_id=3).success
    assert srv.load_keyframe("home").success
    np.testing.assert_array_equal(srv.d.qpos.numpy(), np.tile(qpos.numpy(), (3, 1)))
