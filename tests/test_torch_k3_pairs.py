"""The fused step's twelve pair primitives and the worlds that take them onto
it, against the JAX package.

- the twelve plain primitives (ops/narrowphase_soa.SOA_FNS) against the
  JAX package's SoA primitives in float64 at 1e-12, on seeded random poses
  and on the degenerate poses of tests/test_narrowphase_soa.py (stacked
  boxes, an upright cylinder, a box flat on a plane, a sphere at a box's
  centre) and two more (a sphere on a cylinder's axis, an ellipsoid flat
  on a plane);
- the cylinder and ellipsoid compile (tests/torch_problems.PEGS) against
  the JAX compiler, field by field at 1e-12;
- step_tpu.supports against the JAX gate on BOX_BIN, the five PEGS worlds,
  BOXES, PENDULUM, PILE and a cylinder on a box, which the port also
  refuses with a ValueError that names the pair;
- one and five fused steps of BOX_BIN (60 rows) through step_batched_plain
  against the JAX package's fused kernel in interpret mode, at the
  tolerances of tests/test_torch_step_fused.py;
- each PEGS world's general step (fwd.GeneralPlan) in float32 against
  jax.vmap(fwd.step) at the tolerances of tests/test_torch_general.py.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import narrowphase_soa as jsoa
from mujoco_ros_pkgs_tpu.ops import step_tpu as jstep_tpu

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase_soa as soa
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu
from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.test_torch_general import _jax_batch, _to_port
from tests.test_torch_narrowphase import E, P, _components, _flat, _poses
from tests.torch_problems import BOX_BIN, PEGS, box_bin_states, pegs_states
from tests.torch_jax import jax_load

# a free cylinder on a world box: the pair needs MPR (convex_pair)
CYLINDER_ON_BOX = """
<mujoco>
  <option cone="elliptic"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 1"/>
    <geom name="table" type="box" pos="0 0 0.1" size="0.3 0.3 0.1"/>
    <body pos="0 0 0.3">
      <freejoint/>
      <geom name="can" type="cylinder" size="0.04 0.06"/>
    </body>
  </worldbody>
</mujoco>
"""
# BOX_BIN's floor and its +x wall only
BIN_ONE_WALL = re.sub(r'\s*<geom name="wall_(xm|yp|ym)"[^>]*/>', "", BOX_BIN)


def _pose(pos, size, rot=None):
    """(pos, rot, size) of one geom over the (E, P) batch, from one pose."""
    rot = np.eye(3) if rot is None else np.asarray(rot, float)
    return (np.broadcast_to(np.asarray(pos, float), (E, P, 3)),
            np.broadcast_to(rot, (E, P, 3, 3)),
            np.broadcast_to(np.asarray(size, float), (E, P, 3)))


def _degenerate():
    """Poses on which argmins and argmaxes tie: tests/test_narrowphase_soa.py's
    test_soa_matches_aos_degenerate_ties (boxes stacked exactly, an upright
    cylinder, a box flat on a plane, a sphere at a box's centre), a sphere
    on a cylinder's axis, inside and above it, and an upright ellipsoid."""
    return [("_box_box", _pose([0, 0, 0], [0.05] * 3), _pose([0, 0, 0.099], [0.05] * 3)),
            ("_plane_cylinder", _pose([0, 0, 0], [0] * 3),
             _pose([0, 0, 0.049], [0.05, 0.05, 0])),
            ("_plane_box", _pose([0, 0, 0], [0] * 3), _pose([0, 0, 0.049], [0.05] * 3)),
            ("_sphere_box", _pose([0, 0, 0], [0.05, 0, 0]), _pose([0, 0, 0], [0.05] * 3)),
            ("_sphere_cylinder", _pose([0, 0, 0.02], [0.05, 0, 0]),
             _pose([0, 0, 0], [0.06, 0.08, 0])),
            ("_sphere_cylinder", _pose([0, 0, 0.12], [0.05, 0, 0]),
             _pose([0, 0, 0], [0.06, 0.08, 0])),
            ("_plane_ellipsoid", _pose([0, 0, 0], [0] * 3),
             _pose([0, 0, 0.05], [0.06, 0.08, 0.1]))]


@pytest.mark.parametrize("poses", ["random", "degenerate"])
def test_primitives_match_jax(poses):
    """Every contact's distance, position and frame of the twelve
    primitives, in SOA_FNS's (the JAX package's) order, float64 at rtol /
    atol 1e-12; the random poses of tests/test_torch_narrowphase.py, where
    each primitive has contacts and separated pairs."""
    assert list(soa.SOA_FNS) == list(jsoa.SOA_FNS)
    assert soa.PRIM_ID == {name: i for i, name in enumerate(jsoa.SOA_FNS)}
    if poses == "random":
        cases = [(name, *_poses(np.random.default_rng(100 + i), name))
                 for i, name in enumerate(soa.SOA_FNS)]
    else:
        cases = _degenerate()
    for name, g1, g2 in cases:
        want = _flat(jsoa.SOA_FNS[name](*_components(g1, "jax"), *_components(g2, "jax")))
        got = _flat(soa.SOA_FNS[name](*_components(g1, "torch"), *_components(g2, "torch")))
        for label, a, b in zip(("dist", "pos", "frame"), got, want):
            assert len(a) == len(b)
            for k, (x, y) in enumerate(zip(a, b)):
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{name} {poses} {label} {k}")
        if poses == "random":
            dist = np.stack(got[0])
            assert (dist < 0).any() and (dist[dist < 1e9] > 0).any(), name


@pytest.mark.parametrize("body", ["cylinder", "ellipsoid"])
def test_compile_matches_jax(body):
    """PEGS(cylinder) and PEGS(ellipsoid) through the port's compiler
    against the JAX compile in float64, every field at 1e-12 (geom_size,
    body_mass, body_inertia, body_iquat, geom_rbound among them); a
    cylinder by `fromto` as a capsule is."""
    xmls = [PEGS[body]]
    if body == "cylinder":
        xmls.append(PEGS[body].replace('type="cylinder" size="0.05 0.07"',
                                       'type="cylinder" fromto="0 -0.07 0 0 0.07 0" '
                                       'size="0.05"'))
    for xml in xmls:
        assert_models_equal(mjcf.load_model_from_string(xml), model_from_numpy(
            *jax_model_to_numpy(jax_load(xml))))


def test_supports_matches_jax():
    """The port's gate is the JAX package's on every world: BOX_BIN, the
    five PEGS worlds and BOXES take the fused step, PENDULUM, PILE and a
    cylinder on a box do not; the port's make_plan then sends the cylinder
    on the box to the general route, whose MPR (ops/gjk.py) collides it.
    The JAX models are compiled in float32 (the gate reads no float)."""
    xmls = {"BOX_BIN": BOX_BIN, **{f"PEGS {t}": xml for t, xml in PEGS.items()},
            "BOXES": worlds.BOXES, "PENDULUM": worlds.PENDULUM, "PILE": worlds.PILE,
            "cylinder on box": CYLINDER_ON_BOX}
    got = {}
    for name, xml in xmls.items():
        pm = mjcf.load_model_from_string(xml)
        got[name] = step_tpu.supports(pm)
        jm = jax_load(xml, dtype=jnp.float32)
        assert got[name] == jstep_tpu.supports(jm), name
    assert [n for n, v in got.items() if not v] == ["PENDULUM", "PILE", "cylinder on box"]
    pm = mjcf.load_model_from_string(CYLINDER_ON_BOX)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()


def test_box_bin_fused_step_matches_jax():
    """BOX_BIN's floor and one wall (plane-box and box-box, 24 rows)
    through step_batched_plain against the JAX package's fused kernel in
    interpret mode: 1 step qpos rtol 1e-5 / atol 1e-6, qvel and qacc 1e-4;
    5 steps qpos atol 1e-4 (tests/test_torch_step_fused.py). 16 seeded
    envs, every other one 12 cm lower than box_bin_states drops it (into
    the floor), the others 0.4 m along x (into the wall). One wall, because
    the interpret compile grows with the box-box pairs: 23 s with none, 46
    s with one, and with all four it ran past 14 minutes and 11 GB on a
    CPU of this suite."""
    jm = jax_load(BIN_ONE_WALL, dtype=jnp.float32)
    jparams, _ = jstep_tpu._pack_params(jm)
    jstep = jax.jit(lambda q, v, w, p: jstep_tpu.step_batched(jm, q, v, w, p))
    pm = mjcf.load_model_from_string(BIN_ONE_WALL, dtype=torch.float32)
    plan = fwd.make_plan(pm)
    assert isinstance(plan, step_tpu.Plan) and plan.rows == (24, 8)
    np.testing.assert_allclose(plan.params.numpy(), np.asarray(jparams), rtol=1e-7, atol=0)
    qpos, qvel = box_bin_states(16, seed=4)
    qpos[::2, 2] -= 0.12
    qpos[1::2, 0] = 0.4
    ws = (0.5 * np.random.default_rng(5).normal(size=(16, 6))).astype(np.float32)
    pr = step_tpu._problem(pm, torch.from_numpy(qpos), torch.from_numpy(qvel), plan.params,
                           plan.idx)
    active = pr.act[:, [b for b, _ in pr.con_base]]
    assert active[:, :4].any() and active[:, 4:].any(), "floor and wall both in contact"
    jq, jv, jw = jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ws)
    tq, tv, tw = torch.from_numpy(qpos), torch.from_numpy(qvel), torch.from_numpy(ws)
    for k in range(5):
        jq, jv, jw = jstep(jq, jv, jw, jparams)
        tq, tv, tw = step_tpu.step_batched(pm, tq, tv, tw, plan)
        if k == 0:
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6,
                                       err_msg="qpos, 1 step")
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4,
                                       err_msg="qvel, 1 step")
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4,
                                       err_msg="qacc, 1 step")
    assert np.isfinite(tq.numpy()).all()
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-4,
                               err_msg="qpos, 5 steps")


@pytest.mark.parametrize("body", sorted(PEGS))
def test_pegs_general_step_matches_jax(body):
    """One float32 step of PEGS(body) on the general route (collide with
    the plain primitives, the general Newton) against jax.vmap(fwd.step),
    which solves with `_solve_jnp`: qpos rtol 1e-5 / atol 1e-6, qvel and
    qacc rtol / atol 1e-4 (tests/test_torch_general.py); 5 seeded envs,
    each against another target, in contact."""
    xml = PEGS[body]
    jm = jax_load(xml, dtype=jnp.float32)
    pm = mjcf.load_model_from_string(xml, dtype=torch.float32)
    assert isinstance(fwd.make_plan(pm), step_tpu.Plan)
    qpos, qvel = pegs_states(pm, 5, seed=6)
    jd = _jax_batch(jm, qpos, qvel, jnp.float32, seed=6)
    pd = fwd.step(pm, _to_port(jd), fwd.GeneralPlan())
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    for field, rtol, atol in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-4, 1e-4)):
        np.testing.assert_allclose(getattr(pd, field).numpy(), np.asarray(getattr(jd, field)),
                                   rtol=rtol, atol=atol, err_msg=f"{body} {field} 1 step")
    assert int((pd.contact.dist < pd.contact.includemargin).sum()) >= 3
