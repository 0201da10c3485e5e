"""Height fields (ops/hfield.py) and TERRAIN through the port's general
route, against the JAX package in float64.

TERRAIN (tests/torch_problems: the humanoid bench on a 32 x 32 height field
in place of its floor, a rangefinder on the torso) is compiled once by the
JAX package; its JAX model also serves the routine tests, with the other
geom's size and bounding radius set per case (and, for a hull, the hull of
MESH_PILE's 20-point mesh put in its mesh table).

- compile: every field equal to model_from_numpy of the JAX compile; the
  grid normalised to [0, 1], the floor's size the field's, three
  hfield_pair groups (sphere, capsules, boxes); the general route;
- `sample_height` at seeded points on and off the field: height and both
  slopes at 1e-12;
- `hfield_pair` against a sphere, capsule, ellipsoid, cylinder, box and a
  hull on 32 seeded poses each (some off the field, some over it, some in
  it): dist in every slot and pos and frame of the active ones at 1e-10;
- one forward and Euler step of 2 seeded humanoids standing in the terrain
  (terrain_states), stage by stage: the contacts as above, the active rows
  row by row at 1e-10 of each field's scale, qacc within 1e-6 and qpos,
  qvel within 1e-9 of their scale, the rangefinder at 1e-12.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import hfield as jhfield

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.ops import efc, hfield, narrowphase, step_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_convex import _rot
from tests.test_torch_general import _jax_batch, _to_port
from tests.torch_problems import MESH_PILE, TERRAIN, terrain_states
from tests.torch_jax import jax_load

NENV = 2
NPOSE = 32
OTHERS = {"sphere": (GeomType.SPHERE, (0.09, 0.0, 0.0)),
          "capsule": (GeomType.CAPSULE, (0.05, 0.17, 0.0)),
          "ellipsoid": (GeomType.ELLIPSOID, (0.1, 0.07, 0.05)),
          "cylinder": (GeomType.CYLINDER, (0.06, 0.1, 0.0)),
          "box": (GeomType.BOX, (0.09, 0.045, 0.03)),
          "hull": (GeomType.MESH, (0.05, 0.04, 0.035))}


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX TERRAIN, the port's TERRAIN, the port's MESH_PILE for its hull)."""
    return (jax_load(TERRAIN), mjcf.load_model_from_string(TERRAIN),
            mjcf.load_model_from_string(MESH_PILE))


def _close(name, got, want, tol, scale=False):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0))) if scale else tol
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=name)


def test_terrain_compiles_as_jax():
    """Every field equals the converted JAX compile; the 32 x 32 grid in
    [0, 1] with its size (10 10 0.3 0.1), the floor's geom size and data
    id; hfield_pair groups for the sphere, the 11 capsules and the 2 boxes;
    the general route, which the fused gate refuses."""
    jm, pm, _ = _models()
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    assert (pm.nhfield, pm.hfield_nrow, pm.hfield_ncol, pm.hfield_names) == (
        1, (32,), (32,), ("terrain",))
    data = pm.hfield_data[0].numpy()
    assert data.min() == 0.0 and data.max() == 1.0
    floor = pm.geom("floor")
    assert pm.geom_type[floor] == int(GeomType.HFIELD) and pm.geom_dataid[floor] == 0
    np.testing.assert_array_equal(pm.geom_size[floor].numpy(), [10.0, 10.0, 0.3])
    groups = {g["key"][2]: len(g["pairs"]) for g in narrowphase.pair_groups(pm)
              if g["key"][1] == GeomType.HFIELD}
    assert groups == {GeomType.SPHERE: 1, GeomType.CAPSULE: 11, GeomType.BOX: 2}
    assert not step_tpu.supports(pm) and fwd.make_plan(pm) == fwd.GeneralPlan()


def test_sample_height_matches_jax():
    """sample_height at 256 seeded points, some off the field (clamped to
    its border): height and both slopes at 1e-12."""
    jm, pm, _ = _models()
    rng = np.random.default_rng(5)
    x, y = rng.uniform(-11.0, 11.0, size=(2, 256))
    got = hfield.sample_height(pm, 0, torch.from_numpy(x), torch.from_numpy(y))
    want = jax.jit(jax.vmap(lambda a, b: jhfield.sample_height(jm, 0, a, b)))(
        jnp.asarray(x), jnp.asarray(y))
    for name, g, w in zip(("z", "dz/dx", "dz/dy"), got, want):
        _close(name, g.numpy(), w, 1e-12)
    assert float(got[0].max()) > 0.2 and float(got[1].abs().max()) > 0.1


def _poses(pm, seed):
    """NPOSE poses of a geom over the field: x, y within 11 m (some off
    it), z within 0.12 m of the terrain's height there, turned at random."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-11.0, 11.0, size=(NPOSE, 2))
    z, _, _ = hfield.sample_height(pm, 0, torch.from_numpy(xy[:, 0]),
                                   torch.from_numpy(xy[:, 1]))
    xpos = np.concatenate([xy, z.numpy()[:, None] + rng.uniform(-0.12, 0.12, (NPOSE, 1))], 1)
    return xpos, _rot(rng, NPOSE)


@pytest.mark.parametrize("other", sorted(OTHERS))
def test_hfield_pair_matches_jax(other):
    """hfield_pair of the field against `other` on NPOSE seeded poses: dist
    in every slot, pos and frame in the active ones, at 1e-10; some
    contacts active, some poses off the field (dist 1e10)."""
    jm, pm, mesh_pile = _models()
    t2, size = OTHERS[other]
    g1, g2 = pm.geom("floor"), pm.geom("head")
    verts = mesh_pile.mesh_vert[0, :mesh_pile.mesh_vertnum[0]]
    rbound = float(verts.norm(dim=-1).max()) if t2 == GeomType.MESH else \
        mjcf._geom_rbound(t2, np.asarray(size))
    xpos, xmat = _poses(pm, seed=40 + int(t2))
    jm2 = jm.replace(geom_size=jm.geom_size.at[g2].set(jnp.asarray(size)),
                     geom_rbound=jm.geom_rbound.at[g2].set(rbound),
                     nmesh=1, mesh_vertnum=(verts.shape[0],),
                     mesh_vert=jnp.asarray(verts.numpy())[None])
    d1 = jfwd.make_data(jm2)
    gx = np.tile(np.asarray(d1.geom_xpos), (NPOSE, 1, 1))
    gm = np.tile(np.asarray(d1.geom_xmat), (NPOSE, 1, 1, 1))
    gx[:, g1], gm[:, g1] = 0.0, np.eye(3)
    gx[:, g2], gm[:, g2] = xpos, xmat
    want = jax.jit(jax.vmap(lambda a, b: jhfield.hfield_pair(
        jm2, d1.replace(geom_xpos=a, geom_xmat=b), g1, g2, (GeomType.HFIELD, t2, 0, 0))))(
            jnp.asarray(gx), jnp.asarray(gm))
    want = [np.asarray(w) for w in want]
    T = torch.from_numpy
    got = hfield.hfield_pair(
        pm, 0, t2, T(gx[:, g1])[:, None], T(gm[:, g1])[:, None], T(xpos)[:, None],
        T(xmat)[:, None], torch.tensor(size, dtype=torch.float64)[None, None],
        torch.tensor(rbound, dtype=torch.float64),
        verts if t2 == GeomType.MESH else None)
    dist, pos, frame = (g[:, 0].numpy() for g in got)
    _close(f"{other} dist", dist, want[0], 1e-10)
    active = want[0] < 0
    _close(f"{other} pos", pos[active], want[1][active], 1e-10)
    _close(f"{other} frame", frame[active], want[2][active], 1e-10)
    assert active.any() and (want[0] == 1e10).all(-1).any(), other


@functools.lru_cache(maxsize=None)
def _stepped():
    """The JAX package's and the port's forward, rows and Euler step of
    terrain_states(pm, NENV, 6)."""
    jm, pm, _ = _models()
    qpos, qvel, ctrl = terrain_states(pm, NENV, seed=6)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64).replace(ctrl=jnp.asarray(ctrl))

    def forward_step(d):
        df = jfwd.forward(jm, d)
        return df, jefc.make_efc(jm, df), jfwd.euler(jm, df.replace(qacc_warmstart=df.qacc))
    want = jax.jit(jax.vmap(forward_step))(jd)
    df = fwd.forward(pm, _to_port(jd))
    return want, (df, efc.make_efc(pm, df), fwd.euler(pm, df.replace(qacc_warmstart=df.qacc)))


def test_terrain_contacts_match_jax():
    """TERRAIN's contacts after the port's collision: dist in every slot
    and pos and frame in the active ones at 1e-10; the feet and some limbs
    in the terrain in each env, hfield_pair contacts among the active."""
    (jdf, _, _), (df, _, _) = _stepped()
    _, pm, _ = _models()
    c, jc = df.contact, jdf.contact
    _close("dist", c.dist.numpy(), jc.dist, 1e-10)
    _close("includemargin", c.includemargin.numpy(), jc.includemargin, 1e-12)
    active = np.asarray(jc.dist) < np.asarray(jc.includemargin)
    _close("pos", c.pos.numpy()[active], np.asarray(jc.pos)[active], 1e-10)
    _close("frame", c.frame.numpy()[active], np.asarray(jc.frame)[active], 1e-10)
    g1, _, _ = narrowphase.slot_meta(pm)
    on_field = np.array(g1) == pm.geom("floor")
    assert (active & on_field).any(1).all(), active.sum(1)


def test_terrain_step_matches_jax():
    """The active rows row by row (J, D, R, aref, pos) at 1e-10 of each
    field's scale; qacc within 1e-6 and, after the Euler step, qpos and
    qvel within 1e-9 of their scale; the rangefinder at 1e-12 (it sees the
    terrain under the torso)."""
    (jdf, je, jd2), (df, e, d2) = _stepped()
    active = np.asarray(je.active)
    np.testing.assert_array_equal(e.active.numpy(), active)
    for name in ("J", "D", "R", "aref", "pos"):
        got, want = getattr(e, name).numpy(), np.asarray(getattr(je, name))
        _close(f"efc.{name}", got[active], want[active], 1e-10, scale=True)
    _close("qacc", df.qacc.numpy(), jdf.qacc, 1e-6, scale=True)
    for name in ("qpos", "qvel"):
        _close(name, getattr(d2, name).numpy(), getattr(jd2, name), 1e-9, scale=True)
    _close("rangefinder", df.sensordata.numpy(), jdf.sensordata, 1e-12)
    assert (df.sensordata > 0).all()
