"""The port's ray-cast cameras (render/camera.py) and PNG encoder against the
JAX package's, in float64 on the CPU.

The world is tests/test_render_services.py's ALLGEOMS (every geom type: a
plane, sphere, capsule, box, cylinder, ellipsoid, a tetrahedron mesh and a
height field) with CAMWORLD's free red ball and its `maincam` added, and
three more cameras aimed at the row, the mesh and the height field. Both
packages render from the same kinematics (the port's, handed to the JAX
Data), so what is compared is the renderer alone:

- seg equal at every pixel but where the JAX package's two nearest hits lie
  within 1e-9 of each other (a tie either side may win on a rounding):
  those are counted, printed and held to 0.5% of the pixels; rgb and depth
  within 1e-9 where the seg agrees; at rest and after 40 steps of the ball.
  A height field's ray marches 64 samples and bisects the bracket where it
  first goes below the surface (sensor_impl._ray_hfield); where a sample
  lies within 1e-9 of the surface (ALLGEOMS's flat field puts sample 42 on
  it on every ray that crosses its box from top to bottom), a rounding
  moves the bracket by one sample and the depth by one final bisection
  step, (span / 63) / 2^10. Those march ties are counted and printed, their
  depth held to 1e-4 and the rgb of the pixels whose normal reads them
  (the pixel, its left and upper neighbours) to 1e-3. A pixel's normal is
  the cross product of its differences to its right and lower neighbours:
  on a silhouette (a neighbour on another geom or the background) the two
  are nearly parallel to the view, and the shade amplifies the 1e-14 by
  which the packages' depths differ (their 3 x 3 products round otherwise)
  to some 1e-7; those pixels' rgb is held to 1e-6, every other pixel's to
  1e-9;
- a marker (RenderMarker) drawn as the JAX package draws it;
- pixel_ray, pick and camera_intrinsics at 1e-12;
- three envs rendered at once equal each env alone, and a small ray chunk
  equals one chunk, bit for bit;
- png.encode gives the JAX package's bytes, and decode(encode(x)) = x.

The JAX package renders op by op (vmap over pixels, no jit), as the port
evaluates: jitted, XLA contracts multiplies and adds into FMAs, and a
height-field march sample that lies on the surface (ALLGEOMS's flat field
puts one there on every ray that crosses its box from top to bottom) may
land on the other side of it, which moves the bisection's bracket: 1.7e-5
in a depth, the JAX package against itself. Its mesh rays read the hull's
faces with np.asarray (sensor_impl._hull_faces), which a trace cannot, so
the faces are computed once first, as tests/test_torch_convex.py does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_ros_pkgs_tpu as mrt
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import sensor_impl as jsensor_impl
from mujoco_ros_pkgs_tpu.render import camera as jcam
from mujoco_ros_pkgs_tpu.utils import png as jpng
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import smooth
from mujoco_ros_pkgs_tpu_torch.render import camera as rcam
from mujoco_ros_pkgs_tpu_torch.utils import png
from tests.test_render_services import ALLGEOMS
from tests.torch_problems import look_at

W, H = 32, 24
CAMERAS = {"row": ((6.0, -8.0, 3.0), (6.0, 0.0, 0.9), 80),
           "mesh": ((10.2, -1.2, 1.9), (10.1, 0.1, 1.1), 45),
           "hfield": ((12.3, -2.2, 2.4), (12.0, 0.0, 0.5), 60)}
WORLD = ALLGEOMS.replace('<mujoco model="allgeoms">', '<mujoco model="allgeoms_cam">').replace(
    '    <geom name="floor" type="plane" size="20 20 0.1"/>\n',
    '    <geom name="floor" type="plane" size="20 20 0.1"/>\n'
    + "".join(f'    <camera name="{n}" pos="{p[0]} {p[1]} {p[2]}" quat="{look_at(p, t)}" '
              f'fovy="{f}"/>\n' for n, (p, t, f) in CAMERAS.items())
    + """    <body name="ball" pos="0 0 0.5">
      <freejoint/>
      <geom name="b" type="sphere" size="0.15" mass="0.2" rgba="1 0 0 1"/>
    </body>
    <body name="cambody" pos="0 -2 1">
      <camera name="maincam" mode="fixed" quat="0.7933533 0.6087614 0 0"/>
    </body>
""")


@pytest.fixture(scope="module")
def worlds():
    pm = mjcf.load_model_from_string(WORLD)
    jm = mrt.load_model_from_string(WORLD)
    hull_faces = jsensor_impl._hull_faces
    faces = [hull_faces(jm, did) for did in range(jm.nmesh)]
    jsensor_impl._hull_faces = lambda m, did: faces[did] if m is jm else hull_faces(m, did)
    yield pm, jm
    jsensor_impl._hull_faces = hull_faces


def port_state(pm, nenv=1, steps=0, seed=0):
    """nenv envs of the port's float64 batch, the ball moved per env by a
    seed, `steps` general steps, then the kinematics of the state."""
    d = fwd.make_data(pm, nenv)
    rng = np.random.default_rng(seed)
    qpos = d.qpos.clone()
    if seed:
        qpos[:, :3] += torch.from_numpy(rng.uniform(-0.3, 0.3, (nenv, 3)))
    d = d.replace(qpos=qpos)
    for _ in range(steps):
        d = fwd.step(pm, d)
    return smooth.fwd_position_smooth(pm, d)


def jax_data(jm, d, env=0):
    """The JAX package's Data of env `env` with the port's kinematics."""
    jd = jfwd.make_data(jm)
    return jd.replace(**{k: jnp.asarray(getattr(d, k)[env].numpy())
                         for k in ("qpos", "xpos", "xmat", "geom_xpos", "geom_xmat")})


def jax_gap(jm, jd, cam):
    """Per pixel, the distance between the JAX package's two nearest hits
    (inf where fewer than two geoms are hit)."""
    pos, rot = jcam.cam_pose(jm, jd, cam)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    _, dirs = jax.vmap(lambda x, y: jcam.pixel_ray(jm, jd, cam, x, y, W, H))(
        jnp.asarray(jj.ravel(), jnp.float64), jnp.asarray(ii.ravel(), jnp.float64))
    ts = jax.vmap(lambda v: jnp.stack([jsensor_impl._ray_geom(jm, jd, g, pos, v)
                                       for g in range(jm.ngeom)]))(dirs)
    ts = np.sort(np.asarray(ts), axis=1)
    return (ts[:, 1] - ts[:, 0]).reshape(H, W)


def march_ties(jm, jd, cam, seg):
    """Pixels whose ray meets a height field with a march sample within
    1e-9 of its surface, in the JAX package's own evaluation."""
    from mujoco_ros_pkgs_tpu.ops import hfield as jhfield
    out = np.zeros(seg.shape, bool)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    origin, dirs = jax.vmap(lambda x, y: jcam.pixel_ray(jm, jd, cam, x, y, W, H))(
        jnp.asarray(jj.ravel(), jnp.float64), jnp.asarray(ii.ravel(), jnp.float64))
    for g in range(jm.ngeom):
        if jm.geom_type[g] != int(GeomType.HFIELD) or not (seg == g).any():
            continue
        hid, rot = jm.geom_dataid[g], np.asarray(jd.geom_xmat[g])
        t = (np.asarray(origin) - np.asarray(jd.geom_xpos[g])) @ rot
        v = np.asarray(dirs) @ rot
        size = np.asarray(jm.hfield_size[hid])
        lo, hi = np.array([-size[0], -size[1], -size[3]]), size[:3]
        va = np.where(np.abs(v) > 1e-12, v, 1e-12)
        t1, t2 = (lo - t) / va, (hi - t) / va
        tmin = np.maximum(0.0, np.minimum(t1, t2).max(1))
        tmax = np.minimum(1e9, np.maximum(t1, t2).min(1))
        ss = tmin[:, None] + (tmax - tmin)[:, None] * np.asarray(jnp.linspace(0.0, 1.0, 64))
        p = t[:, None] + ss[..., None] * v[:, None]
        z = np.asarray(jhfield.sample_height(jm, hid, jnp.asarray(p[..., 0]),
                                             jnp.asarray(p[..., 1]))[0])
        out |= (np.abs(p[..., 2] - z).min(1) < 1e-9).reshape(H, W) & (seg == g)
    return out


def compare(pm, jm, d, cam, label, markers=(), jmarkers=()):
    prgb, pdepth, pseg = (t[0].numpy() for t in rcam.render(pm, d, cam, W, H, markers))
    jd = jax_data(jm, d)
    jrgb, jdepth, jseg = (np.asarray(t) for t in jcam.render(jm, jd, cam, W, H, jmarkers))
    differ = pseg != jseg
    ties = int(differ.sum())
    if ties:
        gap = jax_gap(jm, jd, cam)
        assert (gap[differ] <= 1e-9).all(), f"{label}: seg differs off a tie"
    mt = march_ties(jm, jd, cam, jseg) & ~differ
    reads = mt.copy()                   # the pixels whose normal reads a march tie
    reads[:, :-1] |= mt[:, 1:]
    reads[:-1, :] |= mt[1:, :]
    right = np.concatenate([pseg[:, 1:], pseg[:, -1:]], 1)
    down = np.concatenate([pseg[1:], pseg[-1:]], 0)
    edge = (right != pseg) | (down != pseg)         # the normal's stencil leaves the geom
    print(f"[render {label}] seg ties {ties}, height-field march ties {int(mt.sum())}, "
          f"silhouette pixels {int(edge.sum())} of {pseg.size}; geoms seen "
          f"{sorted(set(np.unique(pseg).tolist()))}")
    assert ties <= 0.005 * pseg.size, label
    same = ~differ
    np.testing.assert_allclose(pdepth[same & ~mt], jdepth[same & ~mt], rtol=0, atol=1e-9,
                               err_msg=label)
    np.testing.assert_allclose(pdepth[mt], jdepth[mt], rtol=0, atol=1e-4, err_msg=label)
    np.testing.assert_allclose(prgb[same & ~reads & ~edge], jrgb[same & ~reads & ~edge],
                               rtol=0, atol=1e-9, err_msg=label)
    np.testing.assert_allclose(prgb[same & ~reads & edge], jrgb[same & ~reads & edge],
                               rtol=0, atol=1e-6, err_msg=label)
    np.testing.assert_allclose(prgb[same & reads], jrgb[same & reads], rtol=0, atol=1e-3,
                               err_msg=label)
    return pseg


# the geom types each camera's pixels meet: all eight between them
SEEN = {"row": {"plane", "sphere", "capsule", "box", "cylinder", "ellipsoid", "hfield"},
        "mesh": {"plane", "mesh", "hfield"}, "hfield": {"plane", "hfield", "mesh"},
        "maincam": {"plane", "sphere"}}


@pytest.mark.parametrize("cam", sorted(SEEN))
def test_render_matches_jax_at_rest(worlds, cam):
    pm, jm = worlds
    seg = compare(pm, jm, port_state(pm), pm.cam_names.index(cam), cam)
    assert {GeomType(pm.geom_type[g]).name.lower() for g in np.unique(seg) if g >= 0} == SEEN[cam]


def test_render_matches_jax_after_steps(worlds):
    pm, jm = worlds
    d = port_state(pm, steps=40)
    assert float(d.qpos[0, 2]) < 0.5 - 1e-3          # the ball has fallen
    seg = compare(pm, jm, d, pm.cam_names.index("maincam"), "maincam after 40 steps")
    assert (seg == pm.geom("b")).sum() > 5


def test_render_marker(worlds):
    pm, jm = worlds
    cam = pm.cam_names.index("maincam")
    f64 = dict(dtype=torch.float64)
    marker = rcam.RenderMarker(pos=torch.tensor([0.3, -0.5, 0.6], **f64),
                               size=torch.tensor([0.2, 0, 0], **f64),
                               rgba=torch.tensor([0.0, 1.0, 0.0, 1.0], **f64))
    jmarker = jcam.RenderMarker(pos=jnp.array([0.3, -0.5, 0.6]), size=jnp.array([0.2, 0, 0]),
                                rgba=jnp.array([0.0, 1.0, 0.0, 1.0]))
    seg = compare(pm, jm, port_state(pm), cam, "maincam + marker", (marker,), (jmarker,))
    assert (seg == pm.ngeom).sum() > 5


def test_pixel_ray_pick_intrinsics(worlds):
    pm, jm = worlds
    d = port_state(pm, seed=3)
    jd = jax_data(jm, d)
    for cam in range(pm.ncam):
        ji = jcam.camera_intrinsics(jm, cam, W, H)
        pi = rcam.camera_intrinsics(pm, cam, W, H)
        assert pi.keys() == ji.keys()
        np.testing.assert_allclose([pi[k] for k in pi], [ji[k] for k in pi], rtol=1e-12)
        for x, y in ((0, 0), (W / 2, H / 2), (W - 1, H - 1), (7.25, 19.5)):
            po, pv = rcam.pixel_ray(pm, d, cam, x, y, W, H)
            jo, jv = jcam.pixel_ray(jm, jd, cam, x, y, W, H)
            np.testing.assert_allclose(po[0].numpy(), np.asarray(jo), rtol=0, atol=1e-12)
            np.testing.assert_allclose(pv[0].numpy(), np.asarray(jv), rtol=0, atol=1e-12)
            pt, pg, pp = rcam.pick(pm, d, cam, x, y, W, H)
            jt, jg, jp = jcam.pick(jm, jd, cam, x, y, W, H)
            assert int(pg[0]) == int(jg), (cam, x, y)
            if int(jg) >= 0:
                np.testing.assert_allclose(float(pt[0]), float(jt), rtol=0, atol=1e-12)
            np.testing.assert_allclose(pp[0].numpy(), np.asarray(jp), rtol=0, atol=1e-12)


def test_batch_and_chunks_change_nothing(worlds, monkeypatch):
    pm, _ = worlds
    d = port_state(pm, nenv=3, seed=5)
    cam = pm.cam_names.index("row")
    whole = rcam.render(pm, d, cam, W, H)
    for e in range(3):
        alone = rcam.render(pm, d, cam, W, H, env_ids=[e])
        for a, b in zip(alone, whole):
            assert torch.equal(a[0], b[e])
    monkeypatch.setattr(rcam, "RAY_CHUNK", 37)
    for a, b in zip(rcam.render(pm, d, cam, W, H), whole):
        assert torch.equal(a, b)


_IMAGES = {
    "float rgb": lambda rng: np.concatenate([rng.uniform(-0.1, 1.1, (9, 13, 3)),
                                             np.full((1, 13, 3), np.nan)]),
    "uint8 rgb": lambda rng: rng.integers(0, 256, (10, 13, 3), dtype=np.uint8),
    "float depth": lambda rng: rng.uniform(0.0, 70.0, (11, 7)),
    "uint16 seg": lambda rng: rng.integers(0, 65536, (6, 17), dtype=np.uint16),
}


@pytest.mark.parametrize("kind", sorted(_IMAGES))
def test_png_encode_matches_jax(kind):
    img = _IMAGES[kind](np.random.default_rng(len(kind)))
    data = png.encode(img)
    assert data == jpng.encode(img)
    back = png.decode(data)
    if img.dtype.kind == "u":
        assert np.array_equal(back, img)
    else:
        assert np.array_equal(back, jpng.decode(data))
