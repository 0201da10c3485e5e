"""The port's general Newton solve (ops/solver.newton) against the JAX
package's `_solve_jnp`, and the rows of the 5-body bin and the chain stage
by stage.

Inputs are seeded numpy states handed to both packages; the JAX side runs
its stages under jit and vmap, and the port takes the JAX batch's state,
contacts and derived fields across (tests/test_torch_general._to_port), so
that both solve the same rows. On the CPU the port's K1 calls run the plain
Cholesky.

- the solve, float64, on three problems: PENDULUM forced through the
  general Newton on both sides (the JAX package's own route for it is the
  fused kernel), a hinge chain of nv 18 with ground and self contacts, and
  the 5-body bin (nv 30): qacc, qfrc_constraint and the row forces at
  rtol / atol 1e-8, with equal Newton trips per env;
- the row model (`forces_and_weights`) against `_forces_and_weights` at
  1e-12;
- the bin and the chain stage by stage in float64: contacts slot by slot
  and the efc rows at 1e-12, every pair group with an active contact in
  the batch (tests/test_torch_pile.py takes the bin and PILE on to whole
  float32 steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import collision as jcollision
from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth
from mujoco_ros_pkgs_tpu.ops import solver as jsolver

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import efc, narrowphase, solver
from tests.test_torch_general import _jax_batch, _states, _to_port
from tests.torch_problems import BIN, CHAIN, bin_states, chain_states
from tests.torch_jax import jax_load

NENV = 4
_PROBLEMS = {"pendulum": (worlds.PENDULUM, lambda n, s: _states(n, s, tilt=0.8)),
             "chain": (CHAIN, chain_states), "bin": (BIN, bin_states)}


def _batch(jm, name, dtype, nenv=NENV, seed=5):
    """The JAX batch of a problem's seeded states, with random applied
    forces and a random warm start (some envs start from it, some from
    qacc_smooth)."""
    qpos, qvel = _PROBLEMS[name][1](nenv, seed)
    jd = _jax_batch(jm, qpos, qvel, dtype, seed=seed)
    ws = 0.5 * np.random.default_rng(seed + 1).normal(size=qvel.shape)
    return jd.replace(qacc_warmstart=jnp.asarray(ws, dtype))


@pytest.fixture(scope="module", params=sorted(_PROBLEMS))
def solved(request):
    """One problem in float64 through the JAX stages, rows and `_solve_jnp`
    (with its realized iterations), and the port's rows and solve of the
    same state."""
    name = request.param
    xml = _PROBLEMS[name][0]
    jm, pm = jax_load(xml), mjcf.load_model_from_string(xml)

    def rows(d):
        d = jsmooth.fwd_position_smooth(jm, d)
        d = jcollision.collide(jm, d)
        d = jsmooth.fwd_acceleration_smooth(jm, jsmooth.fwd_velocity_smooth(jm, d))
        return d, jefc.make_efc(jm, d)

    def solve(d, e):
        sink = {}
        out = jsolver._solve_jnp(jm, d, e, _stats_sink=sink)
        return out, sink["iterations"]
    # two programs: XLA compiles them in a fraction of the time of one
    jd, je = jax.jit(jax.vmap(rows))(_batch(jm, name, jnp.float64))
    jout, jit = jax.jit(jax.vmap(solve))(jd, je)
    pd = _to_port(jd)
    pe = efc.make_efc(pm, pd)
    trips = []
    pout = solver.newton(pm, pd, pe, trips=trips)
    return name, jm, pm, jd, je, jout, np.asarray(jit), pd, pe, pout, trips[0]


def test_general_newton_matches_jax(solved):
    """qacc, qfrc_constraint and the row forces at rtol / atol 1e-8 against
    `_solve_jnp` on the same rows in float64, with the same Newton trips in
    every env; the problems have active contacts and take several trips."""
    name, _, pm, _, _, jout, jit, pd, pe, pout, (taken, ran, syncs) = solved
    for field in ("qacc", "qfrc_constraint", "efc_force_contact", "qacc_warmstart"):
        np.testing.assert_allclose(getattr(pout, field).numpy(),
                                   np.asarray(getattr(jout, field)), rtol=1e-8,
                                   atol=1e-8, err_msg=f"{name} {field}")
    np.testing.assert_array_equal(taken.numpy(), jit, err_msg=f"{name} trips")
    assert int(pe.active.sum()) > 0 and int(taken.max()) >= 2
    assert ran >= int(taken.max()) and ran <= pm.opt.iterations
    assert syncs == (min(ran, pm.opt.iterations - 1)) // solver.SYNC_EVERY
    assert float(pout.efc_force_contact.abs().max()) > 0.0


@pytest.mark.parametrize("solved", ["bin"], indirect=True)
def test_forces_and_weights_match_jax(solved):
    """The row model at a point off the solution: flat forces, simple-row
    weights, cost and the dense cone blocks against `_forces_and_weights`
    (float64, 1e-12)."""
    name, jm, _, _, je, _, _, pd, pe, _, _ = solved
    jar = np.random.default_rng(9).normal(size=pe.aref.shape) * 0.05
    f, w, cost, blocks = solver.forces_and_weights(pe, torch.from_numpy(jar))

    def jrows(e, jar):
        jf, jw, jc, groups = jsolver._forces_and_weights(jm, e, jar)
        return jf, jw, jc, [W for _, W in groups]
    jf, jw, jc, jW = jax.jit(jax.vmap(jrows))(je, jnp.asarray(jar))
    for label, a, b in (("f", f, jf), ("w", w, jw), ("cost", cost, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} {label}")
    assert len(blocks) == len(jW)
    for (_, W), Wj in zip(blocks, jW):
        np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} cone blocks")


def _slots(m):
    """name -> the contact slots of each pair group's routine."""
    out = {}
    for grp in narrowphase.pair_groups(m):
        name = narrowphase._DISPATCH[grp["key"][1:3]].name
        out.setdefault(name, []).extend(
            int(b) + k for b in grp["bases"] for k in range(grp["cap"]))
    return out


@pytest.mark.parametrize("solved", ["bin", "chain"], indirect=True)
def test_contacts_and_rows_match_jax(solved):
    """The bin's and the chain's contacts slot by slot and efc rows row by
    row, float64 at 1e-12 (PENDULUM's: tests/test_torch_general.py); every
    pair group has an active contact in the batch, so that no primitive
    passes on inactive slots alone."""
    name, _, pm, jd, je, _, _, pd, pe, _, _ = solved
    for field in ("dist", "pos", "frame", "includemargin", "friction", "solref",
                  "solimp"):
        np.testing.assert_allclose(getattr(pd.contact, field).numpy(),
                                   np.asarray(getattr(jd.contact, field)), rtol=1e-12,
                                   atol=1e-12, err_msg=f"{name} contact.{field}")
    assert pe.kinds == je.kinds and (pe.con_base, pe.con_dim) == (je.con_base, je.con_dim)
    for field in ("J", "D", "R", "aref", "pos", "margin"):
        np.testing.assert_allclose(getattr(pe, field).numpy(),
                                   np.asarray(getattr(je, field)), rtol=1e-12,
                                   atol=1e-12, err_msg=f"{name} efc.{field}")
    np.testing.assert_array_equal(pe.active.numpy(), np.asarray(je.active))
    active = (pd.contact.dist < pd.contact.includemargin).numpy()
    for routine, slots in _slots(pm).items():
        assert active[:, slots].any(), f"{name}: no active {routine} contact"
