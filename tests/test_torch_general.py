"""The port's general step path against the JAX package on PENDULUM.

Inputs are made with numpy from a seed and handed to both packages (the
port's Data is carried across with core/convert.data_from_numpy). On the
CPU the port runs the plain versions of its kernels; the JAX side runs as
its own tests run it.

- stage by stage in float64: kinematics, com_pos/crb, com_vel, passive
  (damping and springs), rne, xfrc_accumulate and fwd_acceleration_smooth
  at 1e-12; the contact set (dist, pos, frame, params) and the efc rows
  (J, D, R, aref, pos, margin, active) row by row at 1e-12, for elliptic
  condim 1/3/6 and pyramidal cones;
- the whole slice: fwd.step of the port against jax.vmap(fwd.step) in
  float32 for 1 and 5 steps, with the JAX package's solver and Cholesky
  kernels pinned (MRP_PALLAS_SOLVER=1, MRP_PALLAS_LINALG=1), as
  tests/test_step_fusion.py pins them. Tolerances are those of the fused
  step's check: float32 on both sides, the same algorithm, sums in another
  order.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf, types
from mujoco_ros_pkgs_tpu_torch.core.convert import data_from_numpy
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import smooth
from tests.torch_jax import jax_load

# joint damping and springs (passive forces, Euler's implicit damping solve)
PENDULUM_DAMPED = (worlds.PENDULUM
                   .replace('type="ball" pos="0 0 1"/>',
                            'type="ball" pos="0 0 1" damping="0.2" stiffness="1.5"/>')
                   .replace('pos="0 0 0.6" axis="0 1 0"/>',
                            'pos="0 0 0.6" axis="0 1 0" damping="0.1" stiffness="2"/>')
                   .replace('<freejoint/>', '<joint type="free" damping="0.01"/>'))
# condim 6 on the ball, condim 1 on the end link (priority wins the pair)
PENDULUM_CONDIM = (worlds.PENDULUM
                   .replace('<geom type="sphere" size="0.05" mass="0.1"/>',
                            '<geom type="sphere" size="0.05" mass="0.1" condim="6" '
                            'friction="0.8 0.01 0.001"/>')
                   .replace('<geom name="EE" type="capsule"',
                            '<geom name="EE" type="capsule" condim="1" priority="1"'))
PENDULUM_PYRAMIDAL = worlds.PENDULUM.replace('cone="elliptic"', 'cone="pyramidal"')
_WORLDS = {"pendulum": worlds.PENDULUM, "damped": PENDULUM_DAMPED,
           "condim": PENDULUM_CONDIM, "pyramidal": PENDULUM_PYRAMIDAL}
NENV = 4


def _states(nenv, seed, tilt=0.3):
    """PENDULUM states (qpos 13, qvel 11): a tilted ball joint, bent hinges,
    the free ball around its resting place, some envs in penetration."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 13))
    q = rng.normal(size=(nenv, 4)) * tilt
    q[:, 0] += 1.0
    qpos[:, :4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 4:6] = 0.6 * rng.normal(size=(nenv, 2))
    qpos[:, 6] = 1.0 + 0.05 * rng.normal(size=nenv)
    qpos[:, 7] = 0.05 * rng.normal(size=nenv)
    qpos[:, 8] = 0.01 + 0.06 * rng.uniform(size=nenv)
    q = rng.normal(size=(nenv, 4)) * 0.5
    q[:, 0] += 1.0
    qpos[:, 9:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = 0.5 * rng.normal(size=(nenv, 11))
    return qpos, qvel


def _jax_batch(jm, qpos, qvel, dtype, seed=0):
    d1 = jfwd.make_data(jm, dtype=dtype)
    d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (qpos.shape[0],) + x.shape), d1)
    rng = np.random.default_rng(seed)
    return d.replace(qpos=jnp.asarray(qpos, dtype), qvel=jnp.asarray(qvel, dtype),
                     qfrc_applied=jnp.asarray(0.3 * rng.normal(size=qvel.shape), dtype),
                     xfrc_applied=jnp.asarray(
                         0.2 * rng.normal(size=d.xfrc_applied.shape), dtype))


def _to_port(jd) -> types.Data:
    """The JAX batch's state and derived fields as the port's Data."""
    fields = {f.name: np.asarray(getattr(jd, f.name))
              for f in dataclasses.fields(types.Data) if f.name != "contact"}
    meta = {}
    for f in dataclasses.fields(types.Contact):
        val = getattr(jd.contact, f.name)
        if f.name in ("geom1", "geom2", "dim"):
            meta["contact." + f.name] = val
        else:
            fields["contact." + f.name] = np.asarray(val)
    return data_from_numpy(fields, meta)


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _models64(name):
    xml = _WORLDS.get(name) or worlds.PILE
    return jax_load(xml), mjcf.load_model_from_string(xml)


@pytest.fixture(scope="module", params=sorted(_WORLDS))
def world64(request):
    return (request.param,) + _models64(request.param)


@pytest.mark.parametrize("name", sorted(_WORLDS) + ["pile"])
def test_variants_compile_alike(name):
    """The test worlds' variants and PILE compile to the same model in both
    packages (damping, springs, condim, priority, cone, iterations) and take
    the general route."""
    jm, pm = _models64(name)
    np.testing.assert_allclose(pm.dof_damping.numpy(), np.asarray(jm.dof_damping))
    np.testing.assert_allclose(pm.jnt_stiffness.numpy(), np.asarray(jm.jnt_stiffness))
    assert pm.has_damping == jm.has_damping == (name == "damped")
    assert pm.opt.cone == jm.opt.cone
    assert (pm.opt.iterations, pm.opt.ls_iterations) == (jm.opt.iterations,
                                                         jm.opt.ls_iterations)
    assert pm.nv == jm.nv and pm.collision_pairs == tuple(map(tuple, jm.collision_pairs))
    assert fwd.make_plan(pm) == fwd.GeneralPlan()


_SMOOTH = ("qpos", "xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
           "geom_xpos", "geom_xmat", "subtree_com", "cinert", "cdof", "qM", "cvel",
           "cdof_dot", "qfrc_passive", "qfrc_bias", "qfrc_smooth", "qacc_smooth")


def test_smooth_stages_match_jax(world64):
    """Smooth dynamics in float64 at 1e-12, with random applied forces."""
    name, jm, pm = world64
    qpos, qvel = _states(NENV, seed=1)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64)
    pd = _to_port(jd)

    def jstages(d):
        d = jsmooth.fwd_position_smooth(jm, d)
        d = jsmooth.fwd_velocity_smooth(jm, d)
        return jsmooth.fwd_acceleration_smooth(jm, d)
    jd = jax.jit(jax.vmap(jstages))(jd)
    pd = smooth.fwd_acceleration_smooth(
        pm, smooth.fwd_velocity_smooth(pm, smooth.fwd_position_smooth(pm, pd)))
    for field in _SMOOTH:
        _close(f"{name} {field}", getattr(pd, field), getattr(jd, field), 1e-12)
    assert float(pd.qfrc_passive.abs().max()) > (0.0 if name == "damped" else -1.0)


def test_contacts_and_rows_match_jax(world64):
    """The contact set and the efc rows of every slot, row by row, float64."""
    name, jm, pm = world64
    qpos, qvel = _states(NENV, seed=2, tilt=0.8)
    jd = _jax_batch(jm, qpos, qvel, jnp.float64)
    pd = _to_port(jd)

    def jrows(d):
        d = jsmooth.fwd_position_smooth(jm, d)
        d = jcollision.collide(jm, d)
        d = jsmooth.fwd_velocity_smooth(jm, d)
        return d, jefc.make_efc(jm, d)
    jd, je = jax.jit(jax.vmap(jrows))(jd)
    pd = smooth.fwd_velocity_smooth(pm, collision.collide(
        pm, smooth.fwd_position_smooth(pm, pd)))
    pe = efc.make_efc(pm, pd)
    for field in ("dist", "pos", "frame", "includemargin", "friction", "solref",
                  "solimp"):
        _close(f"{name} contact.{field}", getattr(pd.contact, field),
               getattr(jd.contact, field), 1e-12)
    assert pd.contact.dim == jd.contact.dim and pd.contact.geom1 == jd.contact.geom1
    assert bool((pd.contact.dist < pd.contact.includemargin).any())
    assert pe.kinds == je.kinds
    assert (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    for field in ("J", "D", "R", "aref", "pos", "margin", "frictionloss"):
        _close(f"{name} efc.{field}", getattr(pe, field), getattr(je, field), 1e-12)
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))
    _close(f"{name} con_mu", pe.con_mu, je.con_mu, 1e-12)
    np.testing.assert_array_equal(pe.con_active.numpy(), np.asarray(je.con_active))


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pinned_kernels():
    import os
    saved = {k: os.environ.get(k) for k in ("MRP_PALLAS_SOLVER", "MRP_PALLAS_LINALG")}
    os.environ.update(MRP_PALLAS_SOLVER="1", MRP_PALLAS_LINALG="1")
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("name", ["pendulum", "damped"])
def test_step_matches_jax(pinned_kernels, name):
    """fwd.step in float32 against jax.vmap(fwd.step): 1 step (qpos rtol
    1e-5 / atol 1e-6, qvel and qacc rtol/atol 1e-4) and 5 steps (qpos atol
    1e-4), with the JAX package's Newton kernel pinned on its side."""
    xml = _WORLDS[name]
    jm = jax_load(xml, dtype=jnp.float32)
    pm = mjcf.load_model_from_string(xml, dtype=torch.float32)
    qpos, qvel = _states(NENV, seed=3)
    jd = _jax_batch(jm, qpos, qvel, jnp.float32)
    pd = _to_port(jd)
    jstep = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))
    plan = fwd.make_plan(pm)
    for k in range(5):
        jd = jstep(jd)
        pd = fwd.step(pm, pd, plan)
        if k == 0:
            np.testing.assert_allclose(pd.qpos.numpy(), np.asarray(jd.qpos), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} qpos 1 step")
            np.testing.assert_allclose(pd.qvel.numpy(), np.asarray(jd.qvel), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} qvel 1 step")
            np.testing.assert_allclose(pd.qacc.numpy(), np.asarray(jd.qacc), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} qacc 1 step")
    assert torch.isfinite(pd.qpos).all()
    np.testing.assert_allclose(pd.qpos.numpy(), np.asarray(jd.qpos), rtol=0, atol=1e-4,
                               err_msg=f"{name} qpos 5 steps")
    np.testing.assert_allclose(pd.time.numpy(), np.asarray(jd.time), rtol=1e-6)
    assert torch.equal(pd.qacc, pd.qacc_warmstart)
