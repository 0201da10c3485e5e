"""MPR (ops/gjk.py) and MESH_PILE through the port's general route, against
the JAX package in float64.

The JAX side runs in a process of its own (`python -m
tests.test_torch_convex OUT`, tests/torch_problems.run_jax_reference) with
XLA held to AVX: with FMA contraction a jitted MPR differs from the same
ops evaluated one at a time by up to 1e-8 in depth (the JAX package
against itself), and the port evaluates them one at a time. That process
compiles MESH_PILE once, runs `gjk.convex_pair` and `gjk.plane_convex` on
seeded poses and one forward of MESH_PILE; the inputs are made with numpy
from seeds in both processes.

- compile: MESH_PILE's every field equal to model_from_numpy of the JAX
  compile (two hulls, the exclude and the pair, the key); the general
  route, and `step_tpu.supports` refuses it, a free cylinder on a box and
  a free mesh on a plane, as the JAX gate does;
- `convex_pair` for each of the 21 type pairs of sphere, capsule,
  ellipsoid, cylinder, box and the two hulls that MPR takes, 16 seeded
  poses each (some apart, some in each other), and MESH_PILE's contacts:
  nine in ten slots at 1e-10 in dist, pos and frame, and every slot
  within what MPR's stopping rule leaves. The refinement stops once the
  new support point gains less than 1e-7 along the portal's normal; on a
  flat face or a cylinder's rim many portals pass that test, and a
  rounding of 1e-16 (a sum in another order) lands on another one: its
  normal turns by up to 1e-7 over the face's size (2.2e-6 measured), its
  witness slides along the face (1.8e-5), and a patch sample's depth,
  which follows the normal, moves by up to 1e-7 (6.7e-8). So every slot's
  dist at 1e-7; in the slots a hit keeps, pos within 1e-7 along the
  normal and 1e-4 in all, frame at 1e-5 (a separated pair's witness
  points and a dropped patch sample's are by-products, not held);
- `plane_convex` against each hull: dist, pos and frame at 1e-10;
- one MESH_PILE forward and Euler step of 4 seeded heaps (mesh_pile_heap),
  stage by stage: the contacts as above; from the reference's contacts,
  the active rows row by row at 1e-10 of each field's scale, qacc within
  1e-6 and qpos, qvel within 1e-9 of their scale, the rangefinder at 1e-12
  (the JAX package's `sensor_impl._hull_faces` reads a mesh's vertices
  with np.asarray, which its jit trace cannot: the reference process
  computes those hull faces before tracing).
"""

import sys

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.ops import efc, gjk
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase, step_tpu
from tests.torch_problems import MESH_PILE, mesh_pile_heap, run_jax_reference

# the convex kinds of the pose tests: (type, size, mesh id in MESH_PILE)
KINDS = {"sphere": (GeomType.SPHERE, (0.05, 0.0, 0.0), -1),
         "capsule": (GeomType.CAPSULE, (0.04, 0.05, 0.0), -1),
         "ellipsoid": (GeomType.ELLIPSOID, (0.05, 0.04, 0.035), -1),
         "cylinder": (GeomType.CYLINDER, (0.04, 0.05, 0.0), -1),
         "box": (GeomType.BOX, (0.05, 0.045, 0.04), -1),
         "hull20": (GeomType.MESH, (0.0, 0.0, 0.0), 0),
         "wedge": (GeomType.MESH, (0.0, 0.0, 0.0), 1)}
# the kind pairs MPR takes, geom 1 of the lower type
PAIRS = [(k1, k2) for i, k1 in enumerate(KINDS) for k2 in list(KINDS)[i:]
         if narrowphase._DISPATCH[(KINDS[k1][0], KINDS[k2][0])].name == "convex_pair"]
NPOSE = 16
NENV = 4
# a free cylinder on a box, a free mesh on a plane: MPR and plane_convex
SINGLE = {
    "cylinder on box": """<mujoco><option cone="elliptic"/><worldbody>
      <geom type="box" pos="0 0 0.1" size="0.3 0.3 0.1"/>
      <body pos="0 0 0.3"><freejoint/><geom type="cylinder" size="0.04 0.06"/></body>
    </worldbody></mujoco>""",
    "mesh on plane": """<mujoco><option cone="elliptic"/>
      <asset><mesh name="m" vertex="0 0 0 0.1 0 0 0 0.1 0 0 0 0.1"/></asset>
      <worldbody><geom type="plane" size="1 1 1"/>
      <body pos="0 0 0.3"><freejoint/><geom type="mesh" mesh="m"/></body>
    </worldbody></mujoco>"""}


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                               2 * (x * z + w * y)], -1),
                     np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                               2 * (y * z - w * x)], -1),
                     np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                               1 - 2 * (x * x + y * y)], -1)], 1)


def _rbound(pm, kind):
    t, size, did = KINDS[kind]
    if t == GeomType.MESH:
        return float(np.linalg.norm(pm.mesh_vert[did].numpy(), axis=1).max())
    return mjcf._geom_rbound(t, np.asarray(size))


def poses(pm, k1, k2, seed):
    """NPOSE poses of a pair (xpos (n, 2, 3), xmat (n, 2, 3, 3)): geom 1
    near the origin, geom 2 in a random direction at 0.2 to 1.3 of the sum
    of their bounding radii, both turned at random."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(NPOSE, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dist = (_rbound(pm, k1) + _rbound(pm, k2)) * rng.uniform(0.2, 1.3, NPOSE)
    xpos = np.zeros((NPOSE, 2, 3))
    xpos[:, 0] = 0.01 * rng.normal(size=(NPOSE, 3))
    xpos[:, 1] = xpos[:, 0] + u * dist[:, None]
    return xpos, np.stack([_rot(rng, NPOSE), _rot(rng, NPOSE)], 1)


def plane_poses(seed):
    """A tilted plane through a point and a hull around it, NPOSE times."""
    rng = np.random.default_rng(seed)
    xpos = np.zeros((NPOSE, 2, 3))
    xpos[:, 0] = 0.05 * rng.normal(size=(NPOSE, 3))
    xpos[:, 1] = xpos[:, 0] + 0.04 * rng.normal(size=(NPOSE, 3))
    return xpos, np.stack([_rot(rng, NPOSE), _rot(rng, NPOSE)], 1)


def heap(pm):
    return mesh_pile_heap(pm, NENV, seed=3)


# ---------------------------------------------------------------------------
# the JAX side (run as a module in its own process)
# ---------------------------------------------------------------------------

def _reference(out_path):
    import jax
    # as tests/conftest.py pins it: a backend plugin may ignore JAX_PLATFORMS
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf
    from mujoco_ros_pkgs_tpu.ops import efc as jefc
    from mujoco_ros_pkgs_tpu.ops import forward as jfwd
    from mujoco_ros_pkgs_tpu.ops import gjk as jgjk
    from mujoco_ros_pkgs_tpu.ops import step_tpu as jstep_tpu
    from tests.test_torch_compile import jax_model_to_numpy
    from tests.test_torch_general import _jax_batch

    out = {}
    jm = jmjcf.load_model_from_string(MESH_PILE)
    pm = mjcf.load_model_from_string(MESH_PILE)
    fields, meta = jax_model_to_numpy(jm)
    out.update({"model." + k: v for k, v in fields.items()})
    out["supports"] = np.array([jstep_tpu.supports(jmjcf.load_model_from_string(x))
                                for x in [MESH_PILE, *SINGLE.values()]])
    d1 = jfwd.make_data(jm)

    def batch(xpos, xmat):
        gx = np.tile(np.asarray(d1.geom_xpos), (NPOSE, 1, 1))
        gm = np.tile(np.asarray(d1.geom_xmat), (NPOSE, 1, 1, 1))
        gx[:, :2], gm[:, :2] = xpos, xmat
        return jax.vmap(lambda a, b: d1.replace(geom_xpos=a, geom_xmat=b))(
            jnp.asarray(gx), jnp.asarray(gm))
    for k, (k1, k2) in enumerate(PAIRS):
        (t1, s1, did1), (t2, s2, did2) = KINDS[k1], KINDS[k2]
        jm2 = jm.replace(geom_size=jm.geom_size.at[0].set(jnp.asarray(s1))
                         .at[1].set(jnp.asarray(s2)))
        fn = jax.jit(jax.vmap(lambda d, jm2=jm2, st=(t1, t2, did1, did2):
                              jgjk.convex_pair(jm2, d, 0, 1, st)))
        res = fn(batch(*poses(pm, k1, k2, seed=100 + k)))
        for name, r in zip(("dist", "pos", "frame"), res):
            out[f"pair.{k1}.{k2}.{name}"] = np.asarray(r)
    for did, kind in ((0, "hull20"), (1, "wedge")):
        fn = jax.jit(jax.vmap(lambda d, st=(GeomType.PLANE, GeomType.MESH, -1, did):
                              jgjk.plane_convex(jm, d, 0, 1, st)))
        res = fn(batch(*plane_poses(seed=200 + did)))
        for name, r in zip(("dist", "pos", "frame"), res):
            out[f"plane.{kind}.{name}"] = np.asarray(r)

    # the JAX package's rangefinder reads a mesh's vertices with np.asarray
    # (sensor_impl._hull_faces), which a jit trace cannot: the same hull
    # faces, computed before tracing
    from mujoco_ros_pkgs_tpu.ops import sensor_impl as jsensor_impl
    faces = [jsensor_impl._hull_faces(jm, did) for did in range(jm.nmesh)]
    jsensor_impl._hull_faces = lambda m, did: faces[did]

    def forward_step(d):
        df = jfwd.forward(jm, d)
        e = jefc.make_efc(jm, df)
        return df, e, jfwd.euler(jm, df.replace(qacc_warmstart=df.qacc))
    qpos, qvel = heap(pm)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64)
    df, e, d2 = jax.jit(jax.vmap(forward_step))(jd)
    for name in ("dist", "pos", "frame", "includemargin"):
        out["contact." + name] = np.asarray(getattr(df.contact, name))
    for name in ("J", "D", "R", "aref", "pos", "active"):
        out["efc." + name] = np.asarray(getattr(e, name))
    for name in ("geom_xpos", "geom_xmat", "qacc", "sensordata"):
        out["forward." + name] = np.asarray(getattr(df, name))
    for name in ("qpos", "qvel"):
        out["step." + name] = np.asarray(getattr(d2, name))
    for name in ("xfrc_applied", "qfrc_applied"):
        out["input." + name] = np.asarray(getattr(jd, name))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference(sys.argv[1])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_jax_reference("tests.test_torch_convex",
                             tmp_path_factory.mktemp("jax") / "convex.npz")


@pytest.fixture(scope="module")
def pm():
    return mjcf.load_model_from_string(MESH_PILE)


def _close(name, got, want, tol, scale=False):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0))) if scale else tol
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=name)


def test_mesh_pile_compiles_as_jax(ref, pm):
    """Every array field of MESH_PILE equals the JAX compile's (1e-12);
    its hulls (20 and 6 points), the <exclude> (pb0, pb4) and the <pair>
    (pg11 with the floor), the key; 110 pairs, 15 of whose 19 groups take
    MPR; the general route."""
    from mujoco_ros_pkgs_tpu_torch.core import types
    for name in types.array_fields(types.Model):
        want = ref["model." + name]
        got = getattr(pm, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=name)
    assert (pm.nmesh, pm.mesh_vertnum, pm.nkey, pm.key_names) == (2, (20, 6), 1, ("drop",))
    assert pm.pair_exclude == ((1, 5),) and pm.pair_explicit == ((16, 0),)
    groups = narrowphase.pair_groups(pm)
    mpr = [g for g in groups if narrowphase._DISPATCH[g["key"][1:3]].name == "convex_pair"]
    assert (len(pm.collision_pairs), len(groups), len(mpr)) == (110, 19, 15)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()


def test_supports_refuses_mpr_mesh_and_single_bodies(ref):
    """step_tpu.supports refuses MESH_PILE, a single free cylinder on a box
    (MPR) and a single free mesh on a plane (plane_convex), as the JAX gate
    does: they step on the general route."""
    got = [step_tpu.supports(mjcf.load_model_from_string(x))
           for x in [MESH_PILE, *SINGLE.values()]]
    assert got == list(ref["supports"]) == [False, False, False]
    for xml in SINGLE.values():
        assert fwd.make_plan(mjcf.load_model_from_string(xml)) == fwd.GeneralPlan()


def _hold_contacts(label, dist, pos, frame, want, kept):
    """Every slot's dist at 1e-7; in the kept slots pos within 1e-7 along
    the reference's normal and 1e-4 in all, frame at 1e-5; nine in ten of
    the slots (dist alone where not kept) at 1e-10."""
    _close(f"{label} dist", dist, want["dist"], 1e-7)
    dp = pos - want["pos"]
    normal = want["frame"][..., 0, :]
    _close(f"{label} pos along the normal", (dp * normal).sum(-1)[kept], 0.0, 1e-7)
    _close(f"{label} pos", dp[kept], 0.0, 1e-4)
    _close(f"{label} frame", frame[kept], want["frame"][kept], 1e-5)
    exact = np.abs(dist - want["dist"]) <= 1e-10
    exact &= ~kept | ((np.abs(dp).max(-1) <= 1e-10)
                      & (np.abs(frame - want["frame"]).max((-1, -2)) <= 1e-10))
    assert exact.mean() >= 0.9, (label, exact.mean())


def _port_pair(pm, k1, k2, xpos, xmat):
    (t1, s1, did1), (t2, s2, did2) = KINDS[k1], KINDS[k2]

    def side(k, s, did):
        size = torch.tensor(s, dtype=torch.float64)[None, None]
        verts = pm.mesh_vert[did][None, None] if did >= 0 else None
        return (size, torch.from_numpy(xpos[:, k])[:, None],
                torch.from_numpy(xmat[:, k])[:, None], verts)
    (sz1, x1, r1, v1), (sz2, x2, r2, v2) = side(0, s1, did1), side(1, s2, did2)
    return gjk.convex_pair((t1,), (t2,), sz1, x1, r1, sz2, x2, r2, v1, v2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_convex_pair_matches_jax(ref, pm, kind):
    """convex_pair of every MPR pair whose geom 1 is `kind` on NPOSE seeded
    poses against gjk.convex_pair: dist at 1e-10 in every slot, pos and
    frame at 1e-10 in the slots a hit keeps; some pairs hit, some not."""
    pairs = [(k, p) for k, p in enumerate(PAIRS) if p[0] == kind]
    assert pairs
    for k, (k1, k2) in pairs:
        xpos, xmat = poses(pm, k1, k2, seed=100 + k)
        dist, pos, frame = (t[:, 0].numpy() for t in _port_pair(pm, k1, k2, xpos, xmat))
        want = {n: ref[f"pair.{k1}.{k2}.{n}"] for n in ("dist", "pos", "frame")}
        hit = want["dist"][:, 0] <= 0
        _hold_contacts(f"{k1}-{k2}", dist, pos, frame, want,
                       hit[:, None] & (want["dist"] < 1e9))
        assert 0 < hit.sum() < NPOSE, (k1, k2, hit.sum())


def test_plane_convex_matches_jax(ref, pm):
    """plane_convex of a tilted plane against each hull on NPOSE seeded
    poses: the 4 deepest vertices' dist, pos and frame at 1e-10."""
    for did, kind in ((0, "hull20"), (1, "wedge")):
        xpos, xmat = plane_poses(seed=200 + did)
        xpos, xmat = torch.from_numpy(xpos), torch.from_numpy(xmat)
        got = gjk.plane_convex(xmat[:, 0, :, 2], xpos[:, 0], xpos[:, 1], xmat[:, 1],
                               pm.mesh_vert[did, :pm.mesh_vertnum[did]])
        for name, g in zip(("dist", "pos", "frame"), got):
            _close(f"plane-{kind} {name}", g.numpy(), ref[f"plane.{kind}.{name}"], 1e-10)
        assert (got[0] < 0).any() and (got[0] > 0).any()


def _heap(ref, pm):
    """heap(pm) as the port's Data, with the applied forces _jax_batch drew."""
    qpos, qvel = heap(pm)
    return fwd.make_data(pm, NENV).replace(
        qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel),
        xfrc_applied=torch.from_numpy(ref["input.xfrc_applied"]),
        qfrc_applied=torch.from_numpy(ref["input.qfrc_applied"]))


def test_mesh_pile_contacts_match_jax(ref, pm):
    """MESH_PILE's 431 slots after the port's own collision: dist at 1e-10
    in every slot, includemargin at 1e-12, pos and frame of the active
    slots as _hold_contacts holds them; MPR, plane_convex and plane pairs
    among them, and contacts in every env."""
    df = fwd.forward(pm, _heap(ref, pm))
    c = df.contact
    _close("geom_xpos", df.geom_xpos.numpy(), ref["forward.geom_xpos"], 1e-12)
    _close("includemargin", c.includemargin.numpy(), ref["contact.includemargin"], 1e-12)
    active = ref["contact.dist"] < ref["contact.includemargin"]
    _hold_contacts("MESH_PILE", c.dist.numpy(), c.pos.numpy(), c.frame.numpy(),
                   {k: ref["contact." + k] for k in ("dist", "pos", "frame")}, active)
    g1, g2, _ = narrowphase.slot_meta(pm)
    routines = {narrowphase._DISPATCH[(GeomType(pm.geom_type[a]), GeomType(pm.geom_type[b]))].name
                for a, b in zip(np.array(g1)[active.any(0)], np.array(g2)[active.any(0)])}
    assert {"convex_pair", "plane_convex"} <= routines, routines
    assert active.any(1).all()


def test_mesh_pile_step_matches_jax(ref, pm, monkeypatch):
    """From the reference's contacts (the port's collision with its dist,
    pos, frame and includemargin put in): the active rows row by row (J,
    D, R, aref, pos) at 1e-10 of each field's scale; qacc within 1e-6 and,
    after the Euler step, qpos and qvel within 1e-9 of their scale; the
    rangefinder at 1e-12 (it sees the pile)."""
    from mujoco_ros_pkgs_tpu_torch.ops import collision
    own = collision.collide

    def reference_contacts(m, d):
        d = own(m, d)
        return d.replace(contact=d.contact.replace(**{
            k: torch.from_numpy(ref["contact." + k])
            for k in ("dist", "pos", "frame", "includemargin")}))
    monkeypatch.setattr(collision, "collide", reference_contacts)
    df = fwd.forward(pm, _heap(ref, pm))
    e = efc.make_efc(pm, df)
    d2 = fwd.euler(pm, df.replace(qacc_warmstart=df.qacc))
    active = ref["efc.active"]
    np.testing.assert_array_equal(e.active.numpy(), active)
    for name in ("J", "D", "R", "aref", "pos"):
        got, want = getattr(e, name).numpy(), ref["efc." + name]
        _close(f"efc.{name}", got[active], want[active], 1e-10, scale=True)
    _close("qacc", df.qacc.numpy(), ref["forward.qacc"], 1e-6, scale=True)
    for name in ("qpos", "qvel"):
        _close(name, getattr(d2, name).numpy(), ref["step." + name], 1e-9, scale=True)
    _close("rangefinder", df.sensordata.numpy(), ref["forward.sensordata"], 1e-12)
    assert (df.sensordata > 0).any()
    assert float(df.qfrc_constraint.abs().max()) > 0
