"""PILE (BASELINE config 5's scene) and the 5-body bin through the port's
whole general step, against the JAX package.

- PILE plans the general route: nv 72, 17 geoms, 9 pair groups (four of
  them the primitives PILE brought: sphere-sphere, sphere-box, capsule-box,
  box-box), 261 contact slots, 783 rows; so does a pile of nv 102, and
  17 of PILE's bodies (nv 102, past K1's n = 96) step at float64 as the
  JAX package steps them, through the library Cholesky;
- one float32 step of the bin (4 envs) and of PILE (2 envs) through
  fwd.step against jax.vmap(fwd.step), which solves both with
  `_solve_jnp`: qpos rtol 1e-5 / atol 1e-6, qvel and qacc rtol / atol 1e-4
  (test_torch_general.test_step_matches_jax's tolerances: float32 on both
  sides, the same algorithm, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import efc, linalg_tpu, narrowphase
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from tests.test_torch_general import _jax_batch, _to_port
from tests.test_torch_newton import _batch, _slots
from tests.torch_problems import BIN, PILE17, pile_heap
from tests.torch_jax import jax_load


@pytest.mark.parametrize("name", ["bin", "pile"])
def test_step_matches_jax_float32(name):
    """One float32 step through fwd.step against jax.vmap(fwd.step) (the
    JAX package solves both with `_solve_jnp`): qpos rtol 1e-5 / atol 1e-6,
    qvel and qacc rtol / atol 1e-4. PILE runs at 2 envs from the model's own
    start, dropped 0.6 s into the bin so that its bodies touch."""
    xml = BIN if name == "bin" else worlds.PILE
    jm = jax_load(xml, dtype=jnp.float32)
    pm = mjcf.load_model_from_string(xml, dtype=torch.float32)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    if name == "bin":
        jd = _batch(jm, "bin", jnp.float32)
    else:
        jd = _pile_batch(jm)
    pd = _to_port(jd)
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    pd = fwd.step(pm, pd)
    for field, rtol, atol in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-4, 1e-4)):
        np.testing.assert_allclose(getattr(pd, field).numpy(),
                                   np.asarray(getattr(jd, field)), rtol=rtol, atol=atol,
                                   err_msg=f"{name} {field} 1 step")
    assert int((pd.contact.dist < pd.contact.includemargin).sum()) > 0
    assert float(pd.qfrc_constraint.abs().max()) > 0.0


def _pile_batch(jm, nenv=2):
    """PILE's start (qpos0), every body moved down by the distance it falls
    in 0.6 s (at most to 2 cm over its start height) and shifted sideways
    by a seeded 2 cm, with random velocities: a heap in contact."""
    rng = np.random.default_rng(11)
    qpos = np.tile(np.asarray(jm.qpos0), (nenv, 1)).reshape(nenv, 12, 7)
    qpos[..., 2] = np.maximum(qpos[..., 2] - 1.2, 0.02 + 0.05 * np.arange(12) % 0.1)
    qpos[..., :2] += 0.02 * rng.uniform(-1, 1, (nenv, 12, 2))
    qvel = 0.2 * rng.normal(size=(nenv, 72))
    return _jax_batch(jm, qpos.reshape(nenv, 84), qvel, jnp.float32, seed=11)


def test_pile_plans_the_general_route():
    """PILE (nv 72, 17 geoms, 9 pair groups, 261 slots, 783 rows) takes the
    general route, its four new routines included; so does PILE with five
    more spheres (nv 102), past K1's n = 96, whose solves take the library
    Cholesky (ops/linalg_tpu.solve; tests/test_torch_topk.py steps such a
    world)."""
    m = mjcf.load_model_from_string(worlds.PILE)
    assert fwd.make_plan(m) == fwd.GeneralPlan()
    assert (m.nv, m.ngeom, len(narrowphase.pair_groups(m))) == (72, 17, 9)
    assert len(narrowphase.slot_meta(m)[0]) == 261
    assert efc.row_layout(m)["nrow"] == 783
    assert {"_sphere_sphere", "_sphere_box", "_capsule_box", "_box_box"} <= set(_slots(m))
    big = worlds.PILE.replace("</worldbody>", "".join(
        f'<body pos="{k} 3 1"><freejoint/><geom type="sphere" size="0.05"/></body>'
        for k in range(5)) + "</worldbody>")
    wide = mjcf.load_model_from_string(big)
    assert wide.nv == 102 and fwd.make_plan(wide) == fwd.GeneralPlan()


def test_nv102_steps_through_the_library_solve():
    """17 of PILE's bodies (nv 102, past K1's n = 96): the general route,
    whose every solve the library Cholesky takes (linalg_tpu.solve), one
    float64 step of seeded heaps against jax.vmap(fwd.step) at rtol / atol
    1e-8; linalg_tpu.chol_solve against numpy's solve."""
    pm = mjcf.load_model_from_string(PILE17, con_topk=64)
    jm = jax_load(PILE17, con_topk=64)
    assert pm.nv == 102 and fwd.make_plan(pm) == fwd.GeneralPlan()
    qpos, qvel = pile_heap(pm, 2, seed=7)
    jd0 = _jax_batch(jm, qpos, qvel, jnp.float64, seed=7)
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd0)
    pd = fwd.step(pm, _to_port(jd0))
    for f in ("qpos", "qvel", "qacc"):
        np.testing.assert_allclose(getattr(pd, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    assert float(pd.qfrc_constraint.abs().max()) > 0
    H = pd.qM + 0.1 * torch.eye(102, dtype=torch.float64)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 102)))
    np.testing.assert_allclose(linalg_tpu.chol_solve(H, g).numpy(),
                               np.linalg.solve(H.numpy(), g.numpy()[..., None])[..., 0],
                               rtol=1e-10, atol=1e-10)
    assert torch.isnan(linalg_tpu.chol_solve(-H, g)).all()
