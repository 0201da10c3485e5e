"""K2's plain version (the port's ops/solver_tpu.solve_batched on the CPU)
against the JAX package's fused Newton kernel in interpret mode.

The JAX side runs `solver_tpu.solve_batched` as its own tests run it (the
Pallas kernel in interpret mode on the CPU); the inputs are seeded numpy
float32 problems (tests/torch_problems.random_problem) with rows of every
kind: 'eq', 'fri', 'lim', condim-1, -3, -4 and -6 contacts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import solver_tpu as jsolver_tpu

from mujoco_ros_pkgs_tpu_torch.ops import solver_tpu
from tests.torch_problems import DEFAULT_FRICTION, random_problem, solve_cost

NENV = 4


# rows of every kind; the last 'con' row belongs to no contact and is then
# one-sided, as the JAX kernel solves it
_MIXED_KINDS = ("eq", "eq", "fri", "fri", "lim", "lim") + ("con",) * 15
_MIXED_BASE = ((6, 1), (7, 3), (10, 4), (14, 6))


@pytest.mark.parametrize("nv", [11, 16])
def test_solve_batched_matches_jax(nv):
    """solve_batched (qacc, qfrc, row forces) on mixed rows, float32, at the
    general path's trip counts (32 trips, 8 polish steps): rtol/atol 1e-4
    (float32 on both sides, the same algorithm, sums in another order)."""
    p = random_problem(np.random.default_rng(nv), NENV, nv, _MIXED_KINDS,
                                  _MIXED_BASE)
    jx, jq, jf = jsolver_tpu.solve_batched(
        _MIXED_KINDS, _MIXED_BASE, nv, 32, 8, 1e-8, True,
        **{k: jnp.asarray(v) for k, v in p.items()})
    x, q, f = solver_tpu.solve_batched(_MIXED_KINDS, _MIXED_BASE, nv, 32, 8, 1e-8,
                                       True, **{k: torch.from_numpy(v) for k, v in p.items()})
    for name, got, want in (("qacc", x, jx), ("qfrc", q, jq), ("f_rows", f, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"nv {nv} {name}")


@pytest.fixture(scope="module")
def default_friction():
    """The seeded problem at MuJoCo's default friction (nv 16, 32 envs) and
    the JAX kernel's x after `niter` trips (interpret mode), each trip count
    run once."""
    nv, nenv = 16, 32
    p = random_problem(np.random.default_rng(7), nenv, nv, _MIXED_KINDS, _MIXED_BASE,
                       friction=DEFAULT_FRICTION)
    runs = {}

    def jax_x(niter):
        if niter not in runs:
            runs[niter] = np.array(jsolver_tpu.solve_batched(
                _MIXED_KINDS, _MIXED_BASE, nv, niter, 8, 1e-8, True,
                **{k: jnp.asarray(v) for k, v in p.items()})[0])
        return runs[niter]
    return nv, p, jax_x


def test_solve_batched_matches_jax_at_default_friction(default_friction):
    """The same at MuJoCo's default friction, nv 16. Its stiff cones leave
    flat directions, where float32 rounding moves qacc by up to 2e-2 between
    two orders of the same sums, so the check is on the objective: on the
    envs that converged within 32 trips, the port's and the JAX kernel's
    final costs agree to 1e-3 relative (float32 against float64 solves of
    these problems differ by up to 2e-4)."""
    nv, p, jax_x = default_friction
    nenv = p["J"].shape[0]
    jx = jax_x(32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    trips = []
    x, _ = solver_tpu.newton_tiles(nv, _MIXED_KINDS, _MIXED_BASE, 32, 8, True, 1e-8,
                                   *pt.values(), trips=trips)
    done = trips[0] < 32
    assert int(done.sum()) >= 8, f"{int(done.sum())} of {nenv} envs converged"
    got = solve_cost(_MIXED_KINDS, _MIXED_BASE, p, x)[done]
    want = solve_cost(_MIXED_KINDS, _MIXED_BASE, p, torch.from_numpy(jx))[done]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3)


def test_default_friction_converges_on_the_envs_jax_does(default_friction):
    """The envs whose solve converges within 31 trips are the same for the
    port's plain solve and the JAX kernel. The JAX kernel reports no trips;
    an env that has converged stays frozen, so its x after 31 trips and
    after 32 are equal bit for bit, and an env that has not moves in trip
    32. The port's plain solve counts its trips: fewer than 32. Some but not
    all envs converge."""
    nv, p, jax_x = default_friction
    jdone = (jax_x(31) == jax_x(32)).all(-1)
    trips = []
    solver_tpu.newton_tiles(nv, _MIXED_KINDS, _MIXED_BASE, 32, 8, True, 1e-8,
                            *(torch.from_numpy(v) for v in p.values()), trips=trips)
    done = (trips[0] < 32).numpy()
    np.testing.assert_array_equal(done, jdone)
    assert 0 < int(done.sum()) < done.size


def test_kernel_meta_codes():
    """Row codes of csrc/solver.cu: condim-1 contact rows, and 'con' rows of
    no contact, solve as limits."""
    meta = solver_tpu.kernel_meta(_MIXED_KINDS, _MIXED_BASE, 16, 32, 8, True)
    nefc = len(_MIXED_KINDS)
    assert meta[:6] == [16, nefc, 4, 32, 8, 1]
    assert meta[6:6 + nefc] == [0, 0, 1, 1, 2, 2, 2] + [3] * 13 + [2]
    assert meta[6 + nefc:] == [6, 1, 7, 3, 10, 4, 14, 6]


def test_supports_is_the_jax_gate():
    """The kernel's gate matches the JAX package's: condim 1/3/4/6 cones,
    1..64 rows, nv <= 16."""
    from types import SimpleNamespace
    for dims, nrows, nv in (((3,), 3, 11), ((1, 6), 7, 16), ((3,), 64, 6), ((2,), 2, 6),
                            ((3,), 65, 6), ((3,), 3, 17), ((), 0, 4)):
        e = SimpleNamespace(con_dim=dims, kinds=("con",) * nrows)
        assert solver_tpu.supports(e, nv) == jsolver_tpu.supports(e, nv), (dims, nrows, nv)


def test_solve_semantics_of_the_general_path(monkeypatch):
    """ops/solver.py takes _solve_dispatch_tpu's trip counts (iterations
    truncated to 32 with a warning, max(2, min(ls_iterations, 24) // 3)
    polish steps), and a CG model's rows, which the kernel would take under
    Newton, go to solver.cg before the kernel's gate, as the JAX package
    sends CG and PGS to their own solvers."""
    import dataclasses
    from mujoco_ros_pkgs_tpu_torch.core import mjcf
    from mujoco_ros_pkgs_tpu_torch.core.types import SolverType
    from mujoco_ros_pkgs_tpu_torch.models import worlds
    from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth
    from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
    from mujoco_ros_pkgs_tpu_torch.ops import solver
    m = mjcf.load_model_from_string(worlds.PENDULUM, dtype=torch.float32)
    with pytest.warns(UserWarning, match="truncated to 32"):
        assert solver_tpu.trip_counts(m) == (32, 8)
    short = dataclasses.replace(m, opt=dataclasses.replace(m.opt, iterations=5,
                                                           ls_iterations=3))
    assert solver_tpu.trip_counts(short) == (5, 2)
    cg = dataclasses.replace(m, opt=dataclasses.replace(m.opt, solver=int(SolverType.CG)))
    assert fwd.make_plan(cg) == fwd.GeneralPlan()
    d = collision.collide(cg, smooth.fwd_position_smooth(cg, fwd.make_data(cg, 2)))
    d = smooth.fwd_acceleration_smooth(cg, smooth.fwd_velocity_smooth(cg, d))
    e = efc.make_efc(cg, d)
    assert solver_tpu.supports(e, cg.nv)
    want = solver.cg(cg, d, e)

    def refuse(*args, **kw):
        raise AssertionError("a CG model reached the fused Newton")
    monkeypatch.setattr(solver_tpu, "solve_batched", refuse)
    assert torch.equal(solver.solve(cg, d, e).qacc, want.qacc)


def test_newton_trips_are_reported():
    """newton_tiles reports the Newton trips each env took (chip_smoke.py
    counts the operations of a solve from them): between 1 and niter, and
    the solution does not depend on asking."""
    p = {k: torch.from_numpy(v) for k, v in random_problem(
        np.random.default_rng(3), 8, 6, _MIXED_KINDS, _MIXED_BASE).items()}
    args = (6, _MIXED_KINDS, _MIXED_BASE, 32, 8, True, 1e-8, p["J"], p["aref"], p["D"],
            p["floss"], p["active"], p["mu"], p["M"], p["a_s"], p["ws"])
    trips = []
    x, f = solver_tpu.newton_tiles(*args, trips=trips)
    x0, f0 = solver_tpu.newton_tiles(*args)
    assert trips[0].shape == (8,) and int(trips[0].min()) >= 1
    assert int(trips[0].max()) <= 32
    assert torch.equal(x, x0) and torch.equal(f, f0)


@pytest.mark.parametrize("shape,nenv,width", [
    ((11, 33, 11), 4096, 16), ((11, 33, 11), 65536, 16), ((6, 12, 4), 4096, 16),
    ((6, 12, 4), 65536, 8), ((6, 20, 4), 4224, 16), ((6, 20, 4), 4225, 8),
    ((16, 64, 18), 4096, 16), ((16, 64, 64), 4096, 16), ((6, 13, 3), 4096, 16),
    ((11, 20, 4), 65536, 16), ((8, 20, 4), 65536, 8), ((6, 36, 12), 65536, 16),
    ((6, 60, 20), 65536, 16)])
def test_group_width_rule(shape, nenv, width):
    """kernels.group_width picks the lanes per env of K2 and K3 from (nv,
    rows, contacts) and the batch: PENDULUM, BOXES (at 65536 envs past one
    wave at 16 lanes, so 8), 20 rows at nv 6 on either side of one wave
    (32 envs per SM at 16 lanes on 132 SMs), the maxima (nv 16, 64 rows,
    with cones or all condim 1), the capsule world, few rows past one wave
    at nv 11 and 8 (a lane owns one dof, so G >= nv), and 3 and 5 boxes on
    one body past one wave (more than three rows a lane at 8). That each width's
    block fits the card's shared memory is checked against the C layout
    itself (tests/test_torch_csrc_host.py)."""
    from mujoco_ros_pkgs_tpu_torch import kernels
    assert kernels.group_width(*shape, nenv) == width
    assert width in kernels.GROUP_WIDTHS and width >= shape[0]
