"""Fluid forces in the torch port against the JAX package.

- the ellipsoid model's 12 numbers per geom (core/mjcf._fluid_ellipsoid_coefs:
  the added-mass kappas by quadrature, virtual mass and inertia) for
  seeded semiaxes, to 1e-12;
- tests/test_fluid.py's worlds (the inertia-box model on a free box and a
  ball-jointed capsule; the ellipsoid model on mixed bodies, one of them
  with an inactive geom; wind on a light sphere): the compile equals the
  JAX package's (invweight0 to 1e-12 of its scale), and qfrc_passive at seeded states equals the JAX
  package's smooth.passive (one jit) on the port's velocity stage, to
  1e-12;
- SWIMMER (tests/torch_problems.SWIMMER: the inertia-box and the ellipsoid
  model on one chain, wind, implicitfast): the compile equals the JAX
  package's (body_invweight0 to 1e-12 of its scale: a 10 g link on
  armature 1e-6), and 3 steps of 16 seeded envs with each of Euler,
  implicitfast (the fluid's d / d qvel masked by the simple-dof sparsity)
  and implicit equal the JAX package's forward and integrator (each jitted
  once): qpos and qvel to 1e-9, qacc to 1e-7;
- SWIMMER at 5 rad/s links (ROADMAP C14): the JAX package's implicitfast
  gives NaN in exactly the envs where the port's M - h qD is indefinite,
  the port's step equals it elsewhere, and libmujoco steps them all; and
  swimmer_states' speeds cover libmujoco's full-ctrl gaits, along which
  M - h qD stays positive definite;
- SWIMMER's save_xml: written, reloaded and stepped once, bit for bit.

The JAX models load through tests/torch_jax.jax_load (set_constants under
one jit).
"""

import dataclasses
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.core import mjcf as jmjcf
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth

from mujoco_ros_pkgs_tpu_torch.core import mjcf, mjcf_writer
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.core.types import IntegratorType
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import smooth

from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.torch_problems import SWIMMER, swimmer_gait_states, swimmer_states
from tests.torch_jax import jax_load

# tests/test_fluid.py's worlds
FLUID_XML = """<mujoco>
<option timestep="0.002" density="1.2" viscosity="0.3" wind="0.5 -0.2 0.1"
 integrator="Euler"><flag contact="disable"/></option>
<compiler angle="radian"/>
<worldbody>
<body pos="0 0 1"><freejoint/>
  <geom type="box" size="0.1 0.05 0.3" mass="2"/></body>
<body pos="1 0 1"><joint type="ball" damping="0.1"/>
  <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03" mass="0.5"/></body>
</worldbody></mujoco>"""

WIND_XML = """<mujoco>
<option timestep="0.002" density="1.2" wind="3 0 0">
<flag contact="disable"/></option>
<worldbody><body pos="0 0 2"><freejoint/>
<geom type="sphere" size="0.05" mass="0.01"/></body></worldbody></mujoco>"""

ELLIPSOID_XML = """<mujoco>
<option timestep="0.002" density="1.2" viscosity="0.3" wind="0.5 -0.2 0.1"
 integrator="Euler"><flag contact="disable"/></option>
<compiler angle="radian"/>
<worldbody>
<body pos="0 0 1"><freejoint/>
  <geom type="ellipsoid" size="0.1 0.05 0.2" euler="0.3 0.5 0.7"
   fluidshape="ellipsoid" mass="0.2"/>
  <geom type="capsule" size="0.03 0.2" fluidshape="ellipsoid"
   fluidcoef="0.4 0.2 1.0 0.9 0.8" mass="0.1" pos="0.3 0 0"
   euler="0.2 0 1.4"/></body>
<body pos="1 0 1"><joint type="ball" damping="0.1"/>
  <geom type="box" size="0.1 0.05 0.3" mass="2"/></body>
<body pos="2 0 1"><freejoint/>
  <geom type="sphere" size="0.08" fluidshape="ellipsoid" mass="0.3"/>
  <geom type="box" size="0.05 0.05 0.05" mass="0.2" pos="0.2 0 0"/></body>
</worldbody></mujoco>"""

NENV = 16
NSTEP = 3


def _close(name, got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol,
                               err_msg=name)


def test_ellipsoid_coefs_match_jax():
    """Spheres, prolate, oblate and triaxial semiaxes (the axisymmetric
    virtual inertia's zero included), with seeded fluidcoef."""
    rng = np.random.default_rng(0)
    semis = [(0.1, 0.1, 0.1), (0.05, 0.05, 0.2), (0.2, 0.2, 0.05)] + [
        tuple(rng.uniform(0.01, 0.3, 3)) for _ in range(5)]
    with threadpool_limits(1):
        for semi in semis:
            coef = rng.uniform(0.1, 2.0, 5)
            got = mjcf._fluid_ellipsoid_coefs(np.asarray(semi), coef)
            _close(f"coefs {semi}", got, jmjcf._fluid_ellipsoid_coefs(np.asarray(semi), coef),
                   1e-12)


def _port_state(pm, nenv, seed):
    rng = np.random.default_rng(seed)
    d = fwd.make_data(pm, nenv)
    qpos = d.qpos.numpy().copy()
    qpos += 0.3 * rng.normal(size=qpos.shape)
    d = d.replace(qpos=torch.from_numpy(qpos),
                  qvel=torch.from_numpy(2.0 * rng.normal(size=(nenv, pm.nv))))
    return smooth.com_vel(pm, smooth.fwd_position_smooth(pm, d))


@pytest.mark.parametrize("name", ["fluid", "ellipsoid", "wind"])
def test_qfrc_passive_matches_jax(name):
    """The compile, then qfrc_passive of 8 seeded states (quaternions
    renormalised by the position stage) against the JAX package's passive
    on the port's velocity stage, 1e-12; the fluid part non-zero."""
    xml = {"fluid": FLUID_XML, "ellipsoid": ELLIPSOID_XML, "wind": WIND_XML}[name]
    pm, jm = mjcf.load_model_from_string(xml), jax_load(xml)
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)), rtol=1e-12)
    d = _port_state(pm, 8, seed=3)
    fields = ("qpos", "qvel", "cvel", "cdof", "xipos", "ximat", "subtree_com",
              "geom_xpos", "geom_xmat")
    d0 = jfwd.make_data(jm)
    jd = jax.jit(jax.vmap(lambda *a: jsmooth.passive(jm, d0.replace(**dict(zip(fields, a))))))(
        *(jnp.asarray(getattr(d, f).numpy()) for f in fields))
    got = smooth.passive(pm, d).qfrc_passive
    _close(f"{name} qfrc_passive", got, jd.qfrc_passive, 1e-12)
    assert float(smooth.fluid_qfrc(pm, d).abs().max()) > 1e-6


@pytest.fixture(scope="module")
def swimmer():
    """SWIMMER in both packages, its seeded states, and the JAX package's
    forward and integrators, each jitted once."""
    pm, jm = mjcf.load_model_from_string(SWIMMER), jax_load(SWIMMER)
    qpos, qvel, ctrl = swimmer_states(pm, NENV, seed=2)
    names = ("qpos", "qvel", "ctrl")
    d0 = jfwd.make_data(jm)
    jd = jax.vmap(lambda *a: d0.replace(**dict(zip(names, a))))(
        *(jnp.asarray(x) for x in (qpos, qvel, ctrl)))
    pd = fwd.make_data(pm, NENV).replace(**{k: torch.from_numpy(v) for k, v in
                                            zip(names, (qpos, qvel, ctrl))})
    jforward = jax.jit(jax.vmap(lambda d: jfwd.forward(jm, d)))
    return pm, jm, pd, jd, jforward, {}


def _jax_integrator(swimmer, integrator: str):
    """The JAX package's integrator on SWIMMER with opt.integrator set to
    `integrator`, vmapped and jitted once a module: (jm, the function)."""
    _, jm, _, _, _, jints = swimmer
    if integrator not in jints:
        jm = jm.replace(opt=jm.opt.replace(integrator=int(IntegratorType[integrator])))
        jints[integrator] = jm, jax.jit(jax.vmap(
            {"EULER": lambda d: jfwd.euler(jm, d),
             "IMPLICITFAST": lambda d: jfwd.implicitfast(jm, d),
             "IMPLICIT": lambda d: jfwd.implicit(jm, d)}[integrator]))
    return jints[integrator]


def _port_data(pm, qpos, qvel, ctrl):
    return fwd.make_data(pm, len(qpos)).replace(**{k: torch.from_numpy(v) for k, v in zip(
        ("qpos", "qvel", "ctrl"), (qpos, qvel, ctrl))})


def test_swimmer_compiles_as_jax(swimmer):
    pm, jm, *_ = swimmer
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)), rtol=1e-12)
    assert pm.has_fluid and sum(pm.geom_fluid_active) == 3
    assert pm.opt.integrator == int(IntegratorType.IMPLICITFAST)


@pytest.mark.parametrize("integrator", ["EULER", "IMPLICITFAST", "IMPLICIT"])
def test_swimmer_steps_match_jax(swimmer, integrator):
    pm, _, pd, jd, jforward, _ = swimmer
    it = int(IntegratorType[integrator])
    pm = dataclasses.replace(pm, opt=dataclasses.replace(pm.opt, integrator=it))
    _, jint = _jax_integrator(swimmer, integrator)
    plan = fwd.make_plan(pm)
    for k in range(NSTEP):
        jd = jforward(jd)
        jd = jint(jd.replace(qacc_warmstart=jd.qacc))
        pd = fwd.step(pm, pd, plan)
        for field, tol in (("qpos", 1e-9), ("qvel", 1e-9), ("qacc", 1e-7)):
            _close(f"{integrator} {field} step {k}", getattr(pd, field).numpy(),
                   getattr(jd, field), tol)
    assert float(pd.qfrc_passive.abs().max()) > 0 and bool(torch.isfinite(pd.qpos).all())


def test_swimmer_fast_links_lose_definiteness_as_jax(swimmer):
    """ROADMAP C14: at links of 5 rad/s (swimmer_states' link_speed; a 99th
    percentile of 13 rad/s, past the 5.6 that libmujoco's gaits peak at)
    implicitfast's M - h qD is indefinite in some envs. Of 512 seeded envs,
    8 indefinite and 8 definite ones step once in both packages: the JAX
    package's Cholesky gives NaN in exactly the 8 indefinite envs, and its
    qpos and qvel equal the port's in the others (1e-9), so the two build
    the same matrix; libmujoco steps all 16 to finite values (its LDL^T
    takes no square root, and its qDeriv is its own)."""
    import mujoco

    pm, _, _, _, jforward, _ = swimmer
    states = swimmer_states(pm, 512, seed=5, link_speed=5.0)
    A = fwd.implicitfast_matrix(pm, fwd.forward(pm, _port_data(pm, *states)))
    indefinite = (torch.linalg.eigvalsh(A).min(-1).values <= 0).numpy()
    assert indefinite.sum() >= 8 and (~indefinite).sum() >= 8
    pick = np.r_[np.nonzero(indefinite)[0][:8], np.nonzero(~indefinite)[0][:8]]
    assert len(pick) == NENV
    qpos, qvel, ctrl = (x[pick] for x in states)
    d0 = jfwd.make_data(swimmer[1])
    jd = jax.vmap(lambda *a: d0.replace(qpos=a[0], qvel=a[1], ctrl=a[2]))(
        *(jnp.asarray(x) for x in (qpos, qvel, ctrl)))
    jd = jforward(jd)
    jd = _jax_integrator(swimmer, "IMPLICITFAST")[1](jd.replace(qacc_warmstart=jd.qacc))
    jnan = np.isnan(np.asarray(jd.qvel)).any(-1)
    assert jnan.tolist() == [True] * 8 + [False] * 8
    pd = fwd.step(pm, _port_data(pm, qpos, qvel, ctrl))
    for field in ("qpos", "qvel"):
        _close(f"definite envs' {field}", getattr(pd, field)[8:].numpy(),
               np.asarray(getattr(jd, field))[8:], 1e-9)
    mm = mujoco.MjModel.from_xml_string(SWIMMER)
    md = mujoco.MjData(mm)
    for k in range(NENV):
        mujoco.mj_resetData(mm, md)
        md.qpos[:], md.qvel[:], md.ctrl[:] = qpos[k], qvel[k], ctrl[k]
        mujoco.mj_step(mm, md)
        assert np.isfinite(md.qvel).all(), f"libmujoco env {k}"


def test_swimmer_states_cover_libmujoco_gaits():
    """swimmer_states' link speeds cover those of users' swimming:
    libmujoco's SWIMMER from rest under SWIMMER_GAITS (0.5 and 1.5 Hz
    bang-bang, a 1 Hz sine; 8 s each) has its link speeds' 99th percentile
    and peak below the seeded states', and at every 10th state it visits
    the port's implicitfast matrix M - h qD is positive definite (ROADMAP
    C14 shows only at speeds uncorrelated from link to link)."""
    speeds, visited = swimmer_gait_states()
    pm = mjcf.load_model_from_string(SWIMMER)
    seeded = np.abs(swimmer_states(pm, 4096, seed=2)[1][:, 3:])
    assert 2.0 < np.percentile(speeds, 99) <= np.percentile(seeded, 99)
    assert 4.0 < speeds.max() <= seeded.max()
    A = fwd.implicitfast_matrix(pm, fwd.forward(pm, _port_data(pm, *visited)))
    assert bool((torch.linalg.eigvalsh(A).min(-1).values > 0).all())


def test_swimmer_save_xml_round_trip(swimmer):
    """save_xml of SWIMMER (the medium, fluidshape and fluidcoef, motors,
    limits) reloads to the same model, and one step is bit for bit."""
    pm, _, pd, *_ = swimmer
    m2 = mjcf.load_model_from_string(mjcf_writer.model_to_xml(pm))
    assert_models_equal(m2, pm, tol=0.0)
    a, b = fwd.step(pm, pd), fwd.step(m2, pd)
    for field in ("qpos", "qvel", "sensordata"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_wind_pushes_a_light_sphere():
    """A 10 g sphere at rest in a 3 m/s wind accelerates downwind; with
    the medium's density 0 it does not."""
    pm = mjcf.load_model_from_string(WIND_XML)
    d = fwd.step(pm, fwd.make_data(pm, 1))
    assert float(d.qacc[0, 0]) > 0.1
    still = dataclasses.replace(pm, opt=dataclasses.replace(
        pm.opt, density=torch.tensor(0.0, dtype=torch.float64)), has_fluid=False)
    assert float(fwd.step(still, fwd.make_data(still, 1)).qacc[0, 0]) == 0.0
