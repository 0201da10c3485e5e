"""The port's CG and PGS solvers (ops/solver.cg, ops/solver.pgs, reached
through solver.solve by opt.solver) against the JAX package's
`_solve_cg_jnp` and `_solve_pgs_jnp`.

The rows are the port's (ops/efc.make_efc of seeded states; the row-by-row
parity of the port's rows with the JAX package's is held in
tests/test_torch_newton.py, test_torch_arm7.py and test_torch_general.py),
handed to the JAX solvers as the JAX package's Efc, the flat rows and the
block view alike (_jax_efc), so that both solvers take the same problem.
Both run the model's own iterations (PENDULUM and ARM7 100, BIN 20), each
stopping where its own test says. On the CPU the port's K1 calls run the
plain Cholesky. Options (solver, cone, disableflags, con_topk) are edited
on the port's model and read by both solvers from it. The float32 steps
load one JAX model, PENDULUM's.

- solve, float64: CG and PGS on PENDULUM (whose rows K2 would take under
  Newton: the fused Newton must not be called), the 5-body bin (nv 30)
  and ARM7's 100 rows (a weld, limits, contacts): qacc, qfrc_constraint,
  the row forces and the warm start at rtol / atol 1e-9 (_match). PGS
  decides between a cone's ray step and its normal step by t >= fn -
  1e-12, a slack below the rounding of t where fn is in the thousands: an
  env in which a decision came within 64 float64 epsilons of fn of that
  threshold (the port's `saturation_margin`) may take the other branch
  than the JAX solver, and its iterates then part until the fixed point.
  Such an env is named and left out of the comparison; at most one env of
  a batch may be so;
- PENDULUM with pyramidal cones, and the bin with the warm start disabled,
  each through both solvers, at the same tolerance;
- the bin under con_topk: CG on the compacted cone group against the JAX
  CG on the same compacted group, PGS on the flat rows (make_efc does not
  compact for PGS, as the JAX package's flat rows hold every slot)
  against the JAX PGS and against the port's PGS without compaction;
- one float32 step of PENDULUM through fwd.step with each solver against
  jax.vmap(fwd.step): qpos rtol 1e-5 / atol 1e-6, qvel and qacc rtol /
  atol 1e-4 (tests/test_torch_general.py's float32 tolerances).
"""

import dataclasses
import functools
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import efc as jefc
from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import solver as jsolver

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.types import DisableBit, SolverType
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth, solver, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from tests.test_torch_general import _jax_batch, _states, _to_port
from tests.torch_problems import BIN, arm7_states, bin_states
from tests.torch_jax import jax_load

NENV = 4
_XML = {"pendulum": worlds.PENDULUM, "bin": BIN, "arm7": worlds.ARM7}
_JAX_SOLVE = {"CG": jsolver._solve_cg_jnp, "PGS": jsolver._solve_pgs_jnp}
_FIELDS = ("qacc", "qfrc_constraint", "efc_force_contact", "qacc_warmstart")
TOL = 1e-9
# a saturation test within this many epsilons of fn of its threshold
NEAR_TIE = 64 * np.finfo(np.float64).eps
# a float32 step's worst env against float64, as a multiple of the JAX
# package's float32 step's (chip_smoke.py's WORST_FACTOR)
WORST_FACTOR = 2.0


@functools.lru_cache(maxsize=None)
def _model(name):
    return mjcf.load_model_from_string(_XML[name])


def _edit(pm, con_topk=None, **opt):
    pm = dataclasses.replace(pm, opt=dataclasses.replace(pm.opt, **opt))
    return pm if con_topk is None else dataclasses.replace(pm, con_topk=con_topk)


def _rows(name, pm, seed=5):
    """The port's batch of a world's seeded states, float64, through the
    stages to its rows, with random applied forces and a random warm start
    (some envs start from it, some from qacc_smooth): (data, rows)."""
    rng = np.random.default_rng(seed)
    extra = {}
    if name == "arm7":
        qpos, qvel, ctrl, mpos, mquat, active = arm7_states(pm, NENV, seed)
        extra = dict(ctrl=ctrl, mocap_pos=mpos, mocap_quat=mquat, eq_active=active)
    elif name == "pendulum":
        qpos, qvel = _states(NENV, seed, tilt=0.8)
    else:
        qpos, qvel = bin_states(NENV, seed)
    d = fwd.make_data(pm, NENV)
    d = d.replace(qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel),
                  qfrc_applied=torch.from_numpy(0.3 * rng.normal(size=qvel.shape)),
                  xfrc_applied=torch.from_numpy(0.2 * rng.normal(size=d.xfrc_applied.shape)),
                  qacc_warmstart=torch.from_numpy(0.5 * rng.normal(size=qvel.shape)),
                  **{k: torch.from_numpy(v) for k, v in extra.items()})
    d = collision.collide(pm, smooth.fwd_position_smooth(pm, d))
    d = smooth.fwd_acceleration_smooth(pm, smooth.actuation(pm, smooth.fwd_velocity_smooth(pm, d)))
    return d, efc.make_efc(pm, d)


@functools.lru_cache(maxsize=None)
def _problem(name):
    pm = _model(name)
    return (pm,) + _rows(name, pm)


class _JaxData(NamedTuple):
    """What the JAX solvers read of a Data; `replace` gives their result."""
    qpos: jax.Array
    qM: jax.Array
    qacc_smooth: jax.Array
    qacc_warmstart: jax.Array

    def replace(self, **kw):
        return kw


def _j(t):
    return jnp.asarray(t.numpy())


def _jax_efc(e):
    """The port's rows e as the JAX package's Efc (batched): the flat
    canonical rows, and the block view of the port's solver (_views: the
    simple rows, each cone group, a compacted group with its rows per env)."""
    sp, simple, cones = solver._views(e)
    kind = np.where(sp.eq.numpy(), "eq", np.where(sp.fri.numpy(), "fri", "lim"))
    B = e.J.shape[0]
    dyn = [g.idx.dim() == 3 for g in cones]
    return jefc.Efc(
        J=_j(e.J), pos=_j(e.pos), margin=_j(e.margin), D=_j(e.D), R=_j(e.R),
        aref=_j(e.aref), frictionloss=_j(e.frictionloss), active=_j(e.active),
        con_base=e.con_base, con_dim=e.con_dim, kinds=e.kinds, con_mu=_j(e.con_mu),
        con_active=_j(e.con_active), simple_J=_j(simple.J), simple_D=_j(simple.D),
        simple_R=_j(e.R[:, sp.simple]), simple_aref=_j(simple.aref),
        simple_floss=_j(simple.floss), simple_active=_j(simple.act),
        simple_kinds=tuple(kind.tolist()), simple_dest=tuple(sp.simple.tolist()),
        cb_J=tuple(_j(g.J) for g in cones), cb_aref=tuple(_j(g.aref) for g in cones),
        cb_D=tuple(_j(g.D) for g in cones), cb_R=tuple(_j(g.R) for g in cones),
        cb_sigma=tuple(_j(g.sigma) for g in cones), cb_act=tuple(_j(g.act) for g in cones),
        cb_dim=tuple(g.dim for g in cones),
        cb_dest=tuple(None if y else tuple(g.idx.flatten().tolist())
                      for g, y in zip(cones, dyn)),
        cb_dest_dyn=tuple(_j(g.idx.flatten(1)) if y else jnp.zeros((B, 0), jnp.int32)
                          for g, y in zip(cones, dyn)))


def _jax_solve(name, pm, pd, pe):
    """The JAX solver `name` on the port's rows, reading nv and the solver
    options from the port's model."""
    o = pm.opt
    jm = types.SimpleNamespace(nv=pm.nv, opt=types.SimpleNamespace(
        iterations=int(o.iterations), ls_iterations=int(o.ls_iterations),
        tolerance=jnp.asarray(float(o.tolerance)), disableflags=int(o.disableflags)))
    jd = _JaxData(*(_j(t) for t in (pd.qpos, pd.qM, pd.qacc_smooth, pd.qacc_warmstart)))
    return jax.jit(jax.vmap(lambda d, e: _JAX_SOLVE[name](jm, d, e)))(jd, _jax_efc(pe))


def _port_solve(name, pm, pd, pe):
    """solver.solve with opt.solver = name: (its result, the stats of a PGS
    solve, solver.pgs's `stats`)."""
    stats = {}
    real = solver.pgs
    solver.pgs = functools.partial(real, stats=stats)
    try:
        out = solver.solve(_edit(pm, solver=int(SolverType[name])), pd, pe)
    finally:
        solver.pgs = real
    assert bool(stats) == (name == "PGS")
    return out, stats


@functools.lru_cache(maxsize=None)
def _solved(name, world):
    """_port_solve of a world's seeded problem."""
    return _port_solve(name, *_problem(world))


def _match(label, pout, jout, stats=None):
    """pout against jout at rtol / atol TOL in every env, but for at most
    one env whose PGS saturation margin is below NEAR_TIE: that env is
    named and not compared."""
    off = np.zeros(pout.qacc.shape[0], dtype=bool)
    for field in _FIELDS:
        got, want = getattr(pout, field).numpy(), np.asarray(jout[field])
        off |= (np.abs(got - want) > TOL + TOL * np.abs(want)).any(-1)
    if off.any():
        assert stats and off.sum() <= 1, (label, np.flatnonzero(off))
        margin = stats["saturation_margin"].numpy()
        assert (margin[off] < NEAR_TIE).all(), (label, margin)
        print(f"{label}: env {np.flatnonzero(off).tolist()} took a saturation test "
              f"within {margin[off].tolist()} of fn of its threshold: not compared")
    for field in _FIELDS:
        np.testing.assert_allclose(getattr(pout, field).numpy()[~off],
                                   np.asarray(jout[field])[~off], rtol=TOL, atol=TOL,
                                   err_msg=f"{label} {field}")


@pytest.fixture
def no_fused_newton(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("CG and PGS must not reach the fused Newton")
    monkeypatch.setattr(solver_tpu, "solve_batched", refuse)


@pytest.mark.parametrize("world", ["pendulum", "bin", "arm7"])
@pytest.mark.parametrize("name", ["CG", "PGS"])
def test_solve_matches_jax(no_fused_newton, name, world):
    """solver.solve with CG / PGS against the JAX solver on the same rows,
    float64, the model's own iterations: qacc, qfrc_constraint, the row
    forces and the warm start at rtol / atol 1e-9 (PGS: _match's rule);
    the rows have active contacts and the solution constraint forces;
    PENDULUM's rows are of the size K2 takes under Newton."""
    pm, pd, pe = _problem(world)
    assert int(pe.active.sum()) > 0
    if world == "pendulum":
        assert solver_tpu.supports(pe, pm.nv)
    if world == "arm7":
        assert len(pe.kinds) == 100 and pe.kinds[0] == "eq"
    pout, stats = _solved(name, world)
    _match(f"{world} {name}", pout, _jax_solve(name, pm, pd, pe), stats)
    assert float(pout.qfrc_constraint.abs().max()) > 0.0


def test_pyramidal_cones_match_jax(no_fused_newton):
    """PENDULUM with pyramidal cones (facet rows, 'lim' kinds, no cone
    group) through CG and PGS against the JAX solvers, float64, 1e-9."""
    pm = _edit(_model("pendulum"), cone=0)
    pd, pe = _rows("pendulum", pm)
    assert "con" not in pe.kinds and pe.groups == () and int(pe.active.sum()) > 0
    for name in ("CG", "PGS"):
        pout, stats = _port_solve(name, pm, pd, pe)
        _match(f"pyramidal {name}", pout, _jax_solve(name, pm, pd, pe), stats)


def test_warmstart_disabled_matches_jax():
    """The bin with DisableBit.WARMSTART: CG from qacc_smooth, PGS from
    zero forces, against the JAX solvers, float64 (_match's rule), and
    not the warm-started solution."""
    pm0, pd, pe = _problem("bin")
    pm = _edit(pm0, disableflags=int(pm0.opt.disableflags) | int(DisableBit.WARMSTART))
    for name in ("CG", "PGS"):
        pout, stats = _port_solve(name, pm, pd, pe)
        _match(f"bin cold {name}", pout, _jax_solve(name, pm, pd, pe), stats)
        assert not torch.equal(pout.qacc, _solved(name, "bin")[0].qacc), name


def test_con_topk_matches_jax():
    """The bin at con_topk = 6: make_efc compacts its cone group for CG
    (Efc.cb) and not for PGS, whose rows are those of the bin without
    con_topk, exactly; CG against the JAX CG on the compacted group, PGS
    against the JAX PGS on the flat rows, float64 (_match's rule)."""
    pm0, _, pe0 = _problem("bin")
    pm = _edit(pm0, con_topk=6)
    pd, pe = _rows("bin", pm)
    assert any(cb is not None for cb in pe.cb)
    pe_pgs = efc.make_efc(_edit(pm, solver=int(SolverType.PGS)), pd)
    assert all(cb is None for cb in pe_pgs.cb) and pe_pgs.kinds == pe0.kinds
    for field in ("J", "aref", "D", "R", "frictionloss", "active", "con_mu", "con_active"):
        assert torch.equal(getattr(pe_pgs, field), getattr(pe0, field)), field
    _match("con_topk CG", _port_solve("CG", pm, pd, pe)[0], _jax_solve("CG", pm, pd, pe))
    pout, stats = _port_solve("PGS", pm, pd, pe_pgs)
    _match("con_topk PGS", pout, _jax_solve("PGS", pm, pd, pe_pgs), stats)


@pytest.mark.parametrize("name", ["CG", "PGS"])
def test_float32_step_matches_jax(name):
    """One float32 step of PENDULUM with opt.solver = CG / PGS through
    fwd.step against jax.vmap(fwd.step): qpos rtol 1e-5 / atol 1e-6, qvel
    and qacc rtol / atol 1e-4. Where envs are past them (PGS in float32:
    both its saturation test and its stopping test, improvement < 1e-8 of
    the scale, sit below float32's rounding, so two orderings of the same
    sums take other branches and stop after other sweeps), both float32
    steps are held against the port's float64 step, each env's error its
    largest |x - x64| over the tolerance's rtol + atol |x64|: the port's
    worst env within WORST_FACTOR times the JAX step's worst, or within 1."""
    solver_id = int(SolverType[name])
    jm = _jax_pendulum32()
    jm = jm.replace(opt=jm.opt.replace(solver=solver_id))
    pm64 = _edit(_model("pendulum"), solver=solver_id)
    pm = pm64.to(dtype=torch.float32)
    assert fwd.make_plan(pm) == fwd.GeneralPlan()
    qpos, qvel = _states(NENV, seed=3)
    jd = _jax_batch(jm, qpos, qvel, jnp.float32)
    pd0 = _to_port(jd)
    pd = fwd.step(pm, pd0)
    x64 = fwd.step(pm64, pd0.replace(**{
        f.name: getattr(pd0, f.name).double() for f in dataclasses.fields(pd0)
        if torch.is_tensor(getattr(pd0, f.name)) and getattr(pd0, f.name).is_floating_point()}))
    jd = jax.jit(jax.vmap(lambda d: jfwd.step(jm, d)))(jd)
    for field, rtol, atol in (("qpos", 1e-5, 1e-6), ("qvel", 1e-4, 1e-4),
                              ("qacc", 1e-4, 1e-4)):
        got, want = getattr(pd, field).numpy(), np.asarray(getattr(jd, field))
        if np.allclose(got, want, rtol=rtol, atol=atol):
            continue
        ref = getattr(x64, field).numpy()
        unit = atol + rtol * np.abs(ref)
        worst, worst_jax = (float((np.abs(x - ref) / unit).max()) for x in (got, want))
        print(f"{name} float32 {field}: past rtol {rtol:g} / atol {atol:g} of the JAX step; "
              f"against float64 worst env {worst:.3f} units, the JAX step's {worst_jax:.3f}")
        assert name == "PGS" and worst <= max(WORST_FACTOR * worst_jax, 1.0), \
            (name, field, worst, worst_jax)
    assert pd.qpos.dtype == torch.float32 and float(pd.qfrc_constraint.abs().max()) > 0.0


@functools.lru_cache(maxsize=None)
def _jax_pendulum32():
    return jax_load(worlds.PENDULUM, dtype=jnp.float32)
