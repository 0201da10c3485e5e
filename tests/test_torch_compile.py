"""Compile parity of the torch port against the JAX package.

For each world, the port's own MJCF compiler (numpy parse + torch constants)
must reproduce the JAX package's compiled Model field by field: float fields
to 1e-12 in float64, integer and static metadata exactly. `model_from_numpy`
of the JAX compile is the other side, so the converter is checked too. The
narrowphase slot layout, which the fused step's rows follow, must match row
by row.
"""

import types

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu.core import assemble as jassemble
from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf
from mujoco_ros_pkgs_tpu.models import worlds as jworlds
from mujoco_ros_pkgs_tpu.ops import narrowphase as jnphase
from mujoco_ros_pkgs_tpu.ops import step_tpu as jstep_tpu

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core import types as ptypes
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase as nphase
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu


def jax_model_to_numpy(jm):
    """The JAX package's compiled Model as (fields, meta) for model_from_numpy."""
    fields, meta = {}, {}
    for name in ptypes.array_fields(ptypes.Model):
        fields[name] = np.asarray(getattr(jm, name))
    for name in ptypes.static_fields(ptypes.Model):
        meta[name] = getattr(jm, name)
    for name in ptypes.array_fields(ptypes.Option):
        fields["opt." + name] = np.asarray(getattr(jm.opt, name))
    for name in ptypes.static_fields(ptypes.Option):
        meta["opt." + name] = getattr(jm.opt, name)
    return fields, meta


# fields that come through a matrix inverse (LAPACK's in the port, XLA's in
# the JAX package), held to tol of their largest entry: acc0 = |M^-1 moment|
# runs to thousands on light links
_SCALED = ("actuator_acc0",)


def assert_models_equal(pm, cm, tol=1e-12, rtol=0.0):
    """Every field of the port's Model against the converted JAX Model
    (float fields within atol tol plus rtol of their size; _SCALED's within
    tol of their scale)."""
    for obj_p, obj_c, cls, prefix in ((pm, cm, ptypes.Model, ""),
                                      (pm.opt, cm.opt, ptypes.Option, "opt.")):
        for name in ptypes.array_fields(cls):
            a, b = getattr(obj_p, name), getattr(obj_c, name)
            assert a.shape == b.shape, f"{prefix}{name}: {a.shape} vs {b.shape}"
            if b.is_floating_point():
                atol = tol * max(1.0, float(b.abs().max())) if (
                    name in _SCALED and b.numel()) else tol
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                           atol=atol, err_msg=prefix + name)
            else:
                assert torch.equal(a.to(b.dtype), b), prefix + name
        for name in ptypes.static_fields(cls):
            assert getattr(obj_p, name) == getattr(obj_c, name), prefix + name


_WORLDS = [("BOXES", worlds.BOXES, jworlds.BOXES),
           ("PENDULUM", worlds.PENDULUM, jworlds.PENDULUM)]


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for name, xml, jxml in _WORLDS:
        assert xml == jxml, f"{name}: the port's copy of the world drifted"
        jm = jmjcf.load_model_from_string(jxml)
        out[name] = (mjcf.load_model_from_string(xml), jm,
                     model_from_numpy(*jax_model_to_numpy(jm)))
    return out


@pytest.mark.parametrize("name", [w[0] for w in _WORLDS])
def test_compile_matches_jax(compiled, name):
    pm, _, cm = compiled[name]
    assert pm.qpos0.dtype == torch.float64
    assert_models_equal(pm, cm)


@pytest.mark.parametrize("name", [w[0] for w in _WORLDS])
def test_invweight0_matches_jax(compiled, name):
    """The tree kinematics/com_pos/crb path (PENDULUM: ball + hinges) and
    the free-body path (BOXES) behind mj_setConst's invweight0."""
    pm, jm, _ = compiled[name]
    np.testing.assert_allclose(pm.body_invweight0.numpy(),
                               np.asarray(jm.body_invweight0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm.dof_invweight0.numpy(),
                               np.asarray(jm.dof_invweight0), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", [w[0] for w in _WORLDS])
def test_slot_table_matches_jax(compiled, name):
    pm, jm, _ = compiled[name]
    assert nphase.slot_meta(pm) == jnphase.slot_meta(jm)
    pairs, slots = step_tpu._slot_table(pm)
    jpairs, jslots = jstep_tpu._slot_table(jm)
    assert slots == jslots
    assert pairs == [dict(p, cap=int(p["cap"])) for p in jpairs]
    pg, jg = nphase.pair_groups(pm), jnphase.pair_groups(jm)
    assert [g["pairs"] for g in pg] == [g["pairs"] for g in jg]
    assert [list(g["bases"]) for g in pg] == [list(g["bases"]) for g in jg]


def test_pile_pair_table_matches_jax():
    """A contact-rich world: the pair table, capacities and slot order of
    every geom-type pair (sphere/capsule/box against each other and walls),
    from the JAX package's table builders fed the port's geoms."""
    pm = mjcf.load_model_from_string(worlds.PILE)
    assert worlds.PILE == jworlds.PILE
    ordered, ncon_max = jassemble.collision_pair_table(
        pm.geom_type, pm.geom_contype, pm.geom_conaffinity, pm.geom_bodyid,
        pm.body_weldid, pm.body_parentid, True, (), ())
    assert (pm.collision_pairs, pm.ncon_max) == (ordered, ncon_max)
    view = types.SimpleNamespace(**{k: getattr(pm, k) for k in (
        "collision_pairs", "geom_type", "geom_dataid", "geom_priority",
        "geom_condim", "pair_topk")})
    assert nphase.slot_meta(pm) == jnphase.slot_meta(view)


def test_model_to_casts_floats_only():
    m = mjcf.load_model_from_string(worlds.BOXES, dtype=torch.float32)
    assert m.geom_size.dtype == torch.float32
    assert m.opt.gravity.dtype == torch.float32
    assert m.device.type == "cpu"
    m64 = m.to(dtype=torch.float64)
    assert m64.body_mass.dtype == torch.float64
    assert m64.body_names == ("world", "box") and m64.opt.iterations == 100


@pytest.mark.parametrize("xml,feature", [
    # the case keeps the id it had when it held a camera, which the port now
    # compiles; gravcomp still raises
    pytest.param('<mujoco><worldbody><body gravcomp="1"><geom size="0.1"/></body>'
                 '</worldbody></mujoco>', "gravcomp",
                 id='<mujoco><worldbody><body><camera name="c"/></body></worldbody>'
                    '</mujoco>-camera'),
    # the case keeps the id it had when it held a cylinder, and then a mesh
    # geom, which the port now compiles; mesh-fitting still raises
    pytest.param('<mujoco><asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>'
                 '<worldbody><geom type="box" mesh="m"/></worldbody></mujoco>',
                 "mesh-fitting",
                 id='<mujoco><worldbody><geom type="cylinder" size="1 1"/></worldbody>'
                    '</mujoco>-cylinder'),
    # the case keeps the id it had when it held a <velocity> servo, and
    # then an <intvelocity>, which the port now compiles; a <muscle> on a
    # joint with no range still raises (its lengthrange cannot be computed)
    pytest.param('<mujoco><worldbody><body><joint name="j"/></body></worldbody>'
                 '<actuator><muscle joint="j"/></actuator></mujoco>', "actuator",
                 id='<mujoco><worldbody><body><joint name="j"/></body></worldbody>'
                    '<actuator><velocity joint="j"/></actuator></mujoco>-actuator'),
])
def test_unsupported_feature_raises(xml, feature):
    with pytest.raises(ValueError, match=feature):
        mjcf.load_model_from_string(xml)


def test_math_matches_jax():
    """Quaternion helpers on random inputs, float64."""
    import jax.numpy as jnp
    from mujoco_ros_pkgs_tpu.ops import math as jmath
    from mujoco_ros_pkgs_tpu_torch.ops import math as pmath

    rng = np.random.default_rng(7)
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    u, v, w = rng.normal(size=(6, 4)), rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    for i in range(6):
        cases = [
            (pmath.quat_mul(torch.from_numpy(q[i]), torch.from_numpy(u[i])),
             jmath.quat_mul(jnp.asarray(q[i]), jnp.asarray(u[i]))),
            (pmath.quat_to_mat(torch.from_numpy(q[i])),
             jmath.quat_to_mat(jnp.asarray(q[i]))),
            (pmath.rot_vec_quat(torch.from_numpy(v[i]), torch.from_numpy(q[i])),
             jmath.rot_vec_quat(jnp.asarray(v[i]), jnp.asarray(q[i]))),
            (pmath.quat_integrate(torch.from_numpy(q[i]), torch.from_numpy(w[i]), 0.01),
             jmath.quat_integrate(jnp.asarray(q[i]), jnp.asarray(w[i]), 0.01)),
        ]
        for got, want in cases:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=1e-12)


def test_smooth_matches_jax_off_qpos0(compiled):
    """kinematics, com_pos and crb of the PENDULUM tree (ball + 2 hinges +
    free ball) at a random configuration, against the JAX package, f64."""
    import jax.numpy as jnp
    from mujoco_ros_pkgs_tpu.ops import forward as jfwd
    from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth
    from mujoco_ros_pkgs_tpu_torch.ops import smooth

    pm, jm, _ = compiled["PENDULUM"]
    rng = np.random.default_rng(8)
    qpos = np.asarray(jm.qpos0) + 0.3 * rng.normal(size=jm.nq)
    jd = jfwd.make_data(jm).replace(qpos=jnp.asarray(qpos))
    jd = jsmooth.crb(jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, jd)))
    kin = smooth.kinematics(pm, torch.from_numpy(qpos)[None])
    subtree_com, cinert, cdof = smooth.com_pos(pm, kin)
    qM = smooth.crb(pm, cinert, cdof)
    for name, got, want in (
            ("qpos", kin.qpos, jd.qpos), ("xpos", kin.xpos, jd.xpos),
            ("xquat", kin.xquat, jd.xquat), ("xipos", kin.xipos, jd.xipos),
            ("xanchor", kin.xanchor, jd.xanchor), ("xaxis", kin.xaxis, jd.xaxis),
            ("geom_xpos", kin.geom_xpos, jd.geom_xpos),
            ("geom_xmat", kin.geom_xmat, jd.geom_xmat),
            ("subtree_com", subtree_com, jd.subtree_com),
            ("cinert", cinert, jd.cinert), ("cdof", cdof, jd.cdof),
            ("qM", qM, jd.qM)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("xml,feature", [
    ('<mujoco><option integrator="Verlet"/><worldbody/></mujoco>', "integrator"),
    ('<mujoco><worldbody><body><joint type="screw"/></body></worldbody></mujoco>',
     "type"),
    ('<mujoco><worldbody><body><joint limited="maybe"/></body></worldbody></mujoco>',
     "limited"),
])
def test_bad_keyword_raises_value_error(xml, feature):
    with pytest.raises(ValueError, match=feature):
        mjcf.load_model_from_string(xml)
