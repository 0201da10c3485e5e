"""The port's CUDA kernels against their plain torch versions.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tests marked `gpu` skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch import kernels
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, solver_tpu, step_tpu
from tests.torch_problems import (BOXES_DAMPED, CAPSULE_CONDIM6, DEFAULT_FRICTION,
                                  FULL_BASE, FULL_KINDS, MIXED_BASE, MIXED_KINDS,
                                  box_cluster, fused_states, random_problem, solve_cost)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_kernel_wrapper_rejects_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises instead of falling back."""
    z = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="not a CUDA device"):
        kernels.step_fused(torch.zeros(4, dtype=torch.int32), torch.zeros(4), z,
                           z[:, :6], z[:, :6], (12, 4))


def test_solve_wrappers_reject_cpu_tensors():
    """The K1 and K2 wrappers raise on CPU tensors as well (the modules'
    entry points take the plain version for those, never the wrappers)."""
    with pytest.raises(ValueError, match="not a CUDA device"):
        kernels.psd_solve(torch.eye(3)[None], torch.zeros(1, 3))
    p = {k: torch.from_numpy(v) for k, v in random_problem(
        np.random.default_rng(0), 2, 6, MIXED_KINDS, MIXED_BASE).items()}
    meta = torch.tensor(solver_tpu.kernel_meta(MIXED_KINDS, MIXED_BASE, 6, 4, 2, True),
                        dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        kernels.newton_solve(meta, torch.ones(1), p["J"], p["aref"], p["D"], p["floss"],
                             p["active"], p["mu"], p["M"], p["a_s"], p["ws"])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 8, 9, 11, 16, 17, 24, 25, 27, 33, 72, 96])
def test_psd_solve_kernel_matches_plain_on_card(n):
    """K1 against psd_solve_plain on 4097 seeded SPD systems, a partial last
    block of the row kernel at every width (rtol 1e-4, atol 1e-5: float32,
    the same algorithm, rsqrt and sums in another order), one launch at the
    width of kernels.psd_width; above n = 16 the block kernel on each side
    of its panel edges (24, 25; 33), at PILE's 72 and at the cap. NaN above
    the diagonal leaves x as it was, bit for bit."""
    _card()
    rng = np.random.default_rng(n)
    B = 4097
    A = rng.normal(size=(B, n, n))
    H = torch.from_numpy((A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32))
    H, g = H.cuda(), g.cuda()
    before = kernels.psd_solve.launches
    x = linalg_tpu.psd_solve(H, g)
    torch.cuda.synchronize()
    assert kernels.psd_solve.launches == before + 1
    assert kernels.psd_solve.width == kernels.psd_width(n) == (
        8 if n <= 8 else 16 if n <= 16 else kernels.PSD_BLOCK_THREADS)
    torch.testing.assert_close(x, linalg_tpu.psd_solve_plain(H, g), rtol=1e-4, atol=1e-5)
    upper = torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1)
    junk = H.masked_fill(upper, float("nan"))
    assert torch.equal(linalg_tpu.psd_solve(junk, g), x)
    with pytest.raises(ValueError):
        linalg_tpu.psd_solve(H.double(), g.double())


@pytest.mark.gpu
def test_psd_solve_refuses_n_above_96_on_card():
    """No kernel takes n > 96 or another dtype than float32: both raise."""
    _card()
    with pytest.raises(ValueError, match="n <= 96"):
        linalg_tpu.psd_solve(torch.eye(97, device="cuda")[None],
                             torch.zeros(1, 97, device="cuda"))
    with pytest.raises(ValueError, match="1 <= n <= 96"):
        kernels.psd_solve(torch.eye(97, device="cuda")[None],
                          torch.zeros(1, 97, device="cuda"))


def test_psd_width_covers_every_n():
    """K1's width rule: one lane per row at 8 lanes to n = 8 and 16 lanes to
    n = 16 (as measured, PERF.md), a block of 4 warps per env to n = 96;
    the wrapper refuses n > 96 and dtypes other than float32 before it
    looks for a card."""
    assert kernels.PSD_BLOCK_THREADS == 128
    for n in range(1, 97):
        assert kernels.psd_width(n) == (8 if n <= 8 else 16 if n <= 16
                                        else kernels.PSD_BLOCK_THREADS)
    with pytest.raises(ValueError, match="1 <= n <= 96"):
        kernels.psd_solve(torch.eye(97)[None], torch.zeros(1, 97))
    with pytest.raises(ValueError, match="float32"):
        kernels.psd_solve(torch.eye(11, dtype=torch.float64)[None],
                          torch.zeros(1, 11, dtype=torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("nv", [6, 11, 16])
def test_newton_solve_kernel_matches_plain_on_card(nv):
    """K2 against solve_batched_plain on mixed rows at the general path's
    trip counts (rtol/atol 2e-3: both float32, sums in another order; the
    solve stops at improved_est < tol * scale, where on such problems the
    plain version in float32 and in float64 already differ by up to 4e-4)."""
    _card()
    p = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(nv), 300, nv, MIXED_KINDS, MIXED_BASE).items()}
    args = (MIXED_KINDS, MIXED_BASE, nv, 32, 8, 1e-8, True)
    before = kernels.newton_solve.launches
    got = solver_tpu.solve_batched(*args, **p)
    torch.cuda.synchronize()
    assert kernels.newton_solve.launches == before + 1
    want = solver_tpu.solve_batched_plain(*args, **p)
    for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_newton_solve_kernel_at_default_friction_on_card():
    """K2 at MuJoCo's default friction, nv 16: on the envs whose plain solve
    converged within 32 trips, the final costs agree to 1e-3 relative (the
    stiff cones leave flat directions where qacc itself is not determined
    to float32 rounding)."""
    _card()
    p = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(7), 300, 16, MIXED_KINDS, MIXED_BASE,
        friction=DEFAULT_FRICTION).items()}
    x, _, _ = solver_tpu.solve_batched(MIXED_KINDS, MIXED_BASE, 16, 32, 8, 1e-8, True, **p)
    trips = []
    xp, _ = solver_tpu.newton_tiles(16, MIXED_KINDS, MIXED_BASE, 32, 8, True, 1e-8,
                                    *p.values(), trips=trips)
    done = trips[0] < 32
    assert int(done.sum()) >= 30
    torch.testing.assert_close(solve_cost(MIXED_KINDS, MIXED_BASE, p, x)[done],
                               solve_cost(MIXED_KINDS, MIXED_BASE, p, xp)[done],
                               rtol=1e-3, atol=0.0)


def test_kernel_sources_hash_into_library_name():
    for name in ("step_fused", "linalg", "solver"):
        assert kernels.library_path(name).name.startswith(f"libmrp_{name}_")
        assert kernels.library_path(name) == kernels.library_path(name)


@pytest.mark.gpu
@pytest.mark.parametrize("xml", [worlds.BOXES, BOXES_DAMPED, CAPSULE_CONDIM6],
                         ids=["boxes", "boxes_damped", "capsule_condim6"])
def test_kernel_matches_plain_on_card(xml):
    """One fused step on the card, kernel against plain version, at the
    tolerances of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    rng = np.random.default_rng(5)
    n = 512
    qpos = np.zeros((n, 7), np.float32)
    qpos[:, 2] = 0.02 + 0.25 * rng.uniform(size=n)
    quat = rng.normal(size=(n, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(n, 6))).astype(np.float32)
    qpos, qvel = torch.from_numpy(qpos).cuda(), torch.from_numpy(qvel).cuda()
    ws = torch.zeros_like(qvel)
    before = kernels.step_fused.launches
    kq, kv, kx = step_tpu.step_batched(m, qpos, qvel, ws, plan)
    torch.cuda.synchronize()
    assert kernels.step_fused.launches == before + 1
    pq, pv, px = step_tpu.step_batched_plain(m, qpos, qvel, ws, plan.params, plan.idx)
    torch.testing.assert_close(kq, pq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kx, px, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_newton_solve_groups_leaving_at_different_trips_on_card():
    """K2 where envs that share a warp need very different trip counts:
    alternate envs of one seeded batch at soft friction (4-15 trips) and at
    MuJoCo's default friction (many of them all 32). At nv 6, 20 rows and
    8192 envs (past one wave at 16 lanes) the rule packs 4 envs into a warp.
    A group that leaves the Newton loop early
    must neither stall nor corrupt its neighbours: the soft envs match the
    plain version at rtol/atol 2e-3, the default envs that converged match
    its final cost to 1e-3 relative."""
    _card()
    nv, n = 6, 8192
    assert kernels.group_width(nv, len(MIXED_KINDS), len(MIXED_BASE), n) == 8
    soft, stiff = (random_problem(np.random.default_rng(s), n, nv, MIXED_KINDS, MIXED_BASE,
                                  **kw) for s, kw in ((11, {}),
                                                      (12, {"friction": DEFAULT_FRICTION})))
    p = {k: torch.from_numpy(np.where(
        (np.arange(n) % 2 == 0).reshape((n,) + (1,) * (soft[k].ndim - 1)),
        soft[k], stiff[k])).cuda() for k in soft}
    args = (MIXED_KINDS, MIXED_BASE, nv, 32, 8, 1e-8, True)
    got = solver_tpu.solve_batched(*args, **p)
    trips = []
    xp, _ = solver_tpu.newton_tiles(nv, MIXED_KINDS, MIXED_BASE, 32, 8, True, 1e-8,
                                    *p.values(), trips=trips)
    want = solver_tpu.solve_batched_plain(*args, **p)
    t = trips[0].reshape(-1, 4)
    assert int((t.max(1).values - t.min(1).values).max()) >= 10, t
    even = torch.arange(n, device="cuda") % 2 == 0
    for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
        torch.testing.assert_close(a[even], b[even], rtol=2e-3, atol=2e-3,
                                   msg=lambda m: f"{name}: {m}")
    done = ~even & (trips[0] < 32)
    assert int(done.sum()) >= 300
    torch.testing.assert_close(solve_cost(MIXED_KINDS, MIXED_BASE, p, got[0])[done],
                               solve_cost(MIXED_KINDS, MIXED_BASE, p, xp)[done],
                               rtol=1e-3, atol=0.0)


# (nv, rows, contacts, envs) at which the rule picks each width
K2_CASES = [(6, MIXED_KINDS, MIXED_BASE, 8192), (11, MIXED_KINDS, MIXED_BASE, 300),
            (16, FULL_KINDS, FULL_BASE, 300)]
K3_CASES = [(1, 8192), (1, 512), (5, 512)]          # (boxes on the body, envs)


@pytest.mark.gpu
@pytest.mark.parametrize("nv,kinds,base,nenv", K2_CASES,
                         ids=["nv6_8192envs", "nv11", "nv16_rows64"])
def test_newton_solve_at_every_group_width_on_card(nv, kinds, base, nenv):
    """K2 at each width the rule picks (these cases cover every width of
    kernels.GROUP_WIDTHS between them) against solve_batched_plain at
    rtol/atol 2e-3, as test_newton_solve_kernel_matches_plain_on_card."""
    _card()
    p = {k: torch.from_numpy(v).cuda() for k, v in random_problem(
        np.random.default_rng(20 + nv), nenv, nv, kinds, base).items()}
    args = (kinds, base, nv, 32, 8, 1e-8, True)
    got = solver_tpu.solve_batched(*args, **p)
    want = solver_tpu.solve_batched_plain(*args, **p)
    for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3, msg=lambda m: f"{name}: {m}")


def test_group_widths_are_covered_by_the_card_cases():
    """The card cases reach every width the rule can pick, for K2 and K3."""
    k2 = {kernels.group_width(nv, len(k), len(b), n) for nv, k, b, n in K2_CASES}
    k3 = {kernels.group_width(
        6, *fwd.make_plan(mjcf.load_model_from_string(box_cluster(nbox))).rows, n)
        for nbox, n in K3_CASES}
    assert k2 == k3 == set(kernels.GROUP_WIDTHS)


@pytest.mark.gpu
@pytest.mark.parametrize("nbox,nenv", K3_CASES)
def test_fused_step_at_every_group_width_on_card(nbox, nenv):
    """K3 on BOXES at 8192 and 512 envs (8 and 16 lanes) and on one body
    with 5 boxes (five pairs, 60 rows) against step_batched_plain, one step
    of seeded envs: qpos and qvel at the tolerances of chip_smoke.py. The
    solver's x gets its 1e-4 budget plus twice the plain version's own
    float32-vs-float64 gap, element by element: at these states x reaches
    300, and the plain version in float32 already misses its float64 result
    by up to 1.6 times the 1e-4 budget on small components of such envs."""
    _card()
    xml = box_cluster(nbox)
    m = mjcf.load_model_from_string(xml, dtype=torch.float32).to("cuda")
    plan = fwd.make_plan(m)
    qpos, qvel = (torch.from_numpy(a).cuda() for a in fused_states(nenv, seed=nbox))
    ws = torch.zeros_like(qvel)
    kq, kv, kx = step_tpu.step_batched(m, qpos, qvel, ws, plan)
    pq, pv, px = step_tpu.step_batched_plain(m, qpos, qvel, ws, plan.params, plan.idx)
    torch.testing.assert_close(kq, pq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-4, atol=1e-4)
    m64 = mjcf.load_model_from_string(xml, dtype=torch.float64).to("cuda")
    plan64 = fwd.make_plan(m64)
    x64 = step_tpu.step_batched_plain(m64, qpos.double(), qvel.double(), ws.double(),
                                      plan64.params, plan64.idx)[2]
    budget = 1e-4 + 1e-4 * px.abs() + 2 * (x64 - px.double()).abs().float()
    worst = float(((kx - px).abs() / budget).max())
    assert worst <= 1.0, f"x: {worst:.3f} of its budget"
