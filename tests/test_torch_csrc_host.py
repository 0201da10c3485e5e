"""The per-env bodies of K1, K2 and K3, compiled for the host.

g++ builds tests/csrc_host_harness.cpp, which runs K2's body `solve_env<G>`
(csrc/solver.cuh: the group Newton body K2 and K3 share), K3's
`step_env<G>` (csrc/step_fused.cuh), K1's row body `psd_rows_env<G>`
(csrc/linalg.cuh, n <= 16) and K1's block body `psd_block_env`
(csrc/linalg.cuh, 17 <= n <= 96) with one std::thread per lane,
group-masked syncs and shuffles that abort on any mask but the calling
lane's own group, block barriers, and as many threads to a block as on the
card. Their results are held against
the port's plain versions, solve_batched_plain, step_batched_plain and
psd_solve_plain, on seeded float32 inputs. Without a card this is the only
run of the kernels' bodies. Skips where g++ is absent.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mujoco_ros_pkgs_tpu_torch import kernels
from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import collision, efc, smooth
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, solver_tpu, step_tpu
from tests.torch_problems import (BOX_BIN, BOXES_DAMPED, CAPSULE_CONDIM6, MIXED_BASE,
                                  MIXED_KINDS, PEGS, TENDON_ACT, box_bin_states, box_cluster,
                                  fused_states, pegs_states, random_problem,
                                  tendon_act_states)

HARNESS = Path(__file__).resolve().parent / "csrc_host_harness.cpp"
NENV = 8


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("csrc_host") / "csrc_host_harness"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-I", str(kernels.CSRC),
                    "-o", str(exe), str(HARNESS)], check=True, timeout=240)
    return exe


def _run(exe, tmp_path, group, nv, kinds, base, p, niter=32, nls=8, tol=1e-8):
    nefc, ncon = len(kinds), len(base)
    meta = np.array(solver_tpu.kernel_meta(kinds, base, nv, niter, nls, True), np.int32)
    src, dst = tmp_path / f"in{group}", tmp_path / f"out{group}"
    with open(src, "wb") as f:
        np.array([NENV, nv, nefc, ncon, group, meta.size], np.int32).tofile(f)
        meta.tofile(f)
        np.array([tol], np.float32).tofile(f)
        for name in ("J", "aref", "D", "floss"):
            np.ascontiguousarray(p[name], np.float32).tofile(f)
        p["active"].astype(np.uint8).tofile(f)
        for name in ("mu", "M", "a_s", "ws"):
            np.ascontiguousarray(p[name], np.float32).tofile(f)
    subprocess.run([str(exe), "solve", str(src), str(dst)], check=True, timeout=120)
    out = np.fromfile(dst, np.float32)
    return (out[:NENV * nv].reshape(NENV, nv),
            out[NENV * nv:2 * NENV * nv].reshape(NENV, nv),
            out[2 * NENV * nv:].reshape(NENV, nefc))


@pytest.mark.parametrize("niter,nls", [(32, 8), (3, 2)])
@pytest.mark.parametrize("group,nv", [(8, 6), (8, 8), (16, 11), (16, 16)])
def test_group_newton_body_matches_plain(harness, tmp_path, group, nv, niter, nls):
    """qacc, qfrc and row forces of 8 seeded envs (rows of every kind: 'eq',
    'fri', 'lim', condim 1/3/4/6) against solve_batched_plain at rtol/atol
    2e-3, as the card test of K2 (both float32, sums in another order; the
    solve stops at improved_est < tol * scale, where the plain version in
    float32 and float64 already differ by up to 4e-4). At the general path's
    32 trips and 8 polish steps the solves converge; cut to 3 trips and 2
    polish steps they stop midway, where every step's arithmetic shows. At
    G = 8 and 16 a simulated warp holds 4 and 2 envs, and at 32 trips some of
    them leave the Newton loop at other trips than their warp neighbours; at
    nv = G every lane owns a dof."""
    p = random_problem(np.random.default_rng(40 + nv), NENV, nv, MIXED_KINDS, MIXED_BASE)
    got = _run(harness, tmp_path, group, nv, MIXED_KINDS, MIXED_BASE, p, niter, nls)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    trips = []
    solver_tpu.newton_tiles(nv, MIXED_KINDS, MIXED_BASE, niter, nls, True, 1e-8,
                            *t.values(), trips=trips)
    want = solver_tpu.solve_batched_plain(MIXED_KINDS, MIXED_BASE, nv, niter, nls, 1e-8,
                                          True, **t)
    for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=f"G {group} {name}")
    per_warp = 32 // group
    if niter == 32:
        by_warp = trips[0].reshape(-1, per_warp)
        assert bool((by_warp.max(1).values > by_warp.min(1).values).any()), by_warp


@pytest.mark.parametrize("group", [8, 16])
def test_group_newton_body_on_tendon_act_rows(harness, tmp_path, group):
    """K2's body on TENDON_ACT's model-made rows (float32, 8 seeded envs:
    the tendon equality, the friction-loss rows of a dof and a tendon, the
    ball's and the tendon's limit rows, 7 condim-3 contacts; nv 6, 26
    rows), each row kind active in some env, against solve_batched_plain
    at rtol / atol 2e-3, as the synthetic rows above."""
    m = mjcf.load_model_from_string(TENDON_ACT, dtype=torch.float32)
    qpos, qvel, act, ctrl = (torch.from_numpy(a.astype(np.float32))
                             for a in tendon_act_states(NENV, seed=31))
    d = fwd.make_data(m, NENV).replace(qpos=qpos, qvel=qvel, act=act, ctrl=ctrl)
    d = collision.collide(m, smooth.fwd_position_smooth(m, d))
    d = smooth.fwd_acceleration_smooth(m, smooth.actuation(m, smooth.fwd_velocity_smooth(m, d)))
    e = efc.make_efc(m, d)
    kinds, base = e.kinds, tuple(zip(e.con_base, e.con_dim))
    assert kinds[:5] == ("eq", "fri", "fri", "lim", "lim") and len(kinds) == 26
    assert bool(e.active[:, 3:5].any(0).all()) and bool(e.con_active.any())
    p = dict(J=e.J, aref=e.aref, D=e.D, floss=e.frictionloss, active=e.active,
             mu=e.con_mu, M=d.qM, a_s=d.qacc_smooth,
             ws=torch.from_numpy(0.1 * np.random.default_rng(31).normal(
                 size=(NENV, m.nv)).astype(np.float32)))
    got = _run(harness, tmp_path, group, m.nv, kinds, base,
               {k: v.numpy() for k, v in p.items()})
    want = solver_tpu.solve_batched_plain(kinds, base, m.nv, 32, 8, 1e-8, True, **p)
    for name, a, b in zip(("qacc", "qfrc", "f_rows"), got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=f"G {group} TENDON_ACT {name}")


# (nv, rows, contacts, envs): BOXES, PENDULUM, the maxima with cones and
# all condim 1, 5 boxes on one body or BOX_BIN past one wave, nv 3 with
# one row
@pytest.mark.parametrize("nv,nefc,ncon,nenv", [(6, 12, 4, 65536), (11, 33, 11, 4096),
                                               (16, 64, 18, 4096), (16, 64, 64, 4096),
                                               (6, 60, 20, 65536), (3, 1, 0, 4096)])
def test_block_shared_memory_fits_the_card(harness, nv, nefc, ncon, nenv):
    """One K2 / K3 block at the width kernels.group_width picks takes at most
    the 227 KB of shared memory an H100 block may have: 128 / G env slices of
    csrc/solver.cuh's env_layout, the size the launches ask for."""
    out = subprocess.run([str(harness), "layout", str(nv), str(nefc), str(ncon)],
                         check=True, capture_output=True, text=True, timeout=60)
    group = kernels.group_width(nv, nefc, ncon, nenv)
    assert 128 // group * int(out.stdout) * 4 <= 227 * 1024


@pytest.mark.parametrize("name,group", [("boxes", 8), ("boxes", 16),
                                        ("boxes_damped", 8), ("capsule_condim6", 16),
                                        ("box_cluster5", 8), ("box_bin", 16),
                                        ("pegs_sphere", 8), ("pegs_capsule", 16),
                                        ("pegs_box", 8), ("pegs_cylinder", 16),
                                        ("pegs_ellipsoid", 8)])
def test_fused_step_body_matches_plain(harness, tmp_path, name, group):
    """One fused step of 16 seeded envs (K3's step_env on the group body;
    box_cluster5: five box pairs, 60 rows; box_bin: BOX_BIN, a free box
    against the floor and four walls, 60 rows, every other env 12 cm lower
    than box_bin_states drops it; pegs_*: the PEGS worlds from pegs_states,
    which with box_bin take all twelve pair primitives, each in contact in
    some env) against step_batched_plain, at the tolerances of the card
    check: qpos rtol 1e-5 / atol 1e-6, qvel and the solver's x rtol/atol
    1e-4 (float32, the same algorithm, sums in another order)."""
    xml = {"boxes": worlds.BOXES, "boxes_damped": BOXES_DAMPED,
           "capsule_condim6": CAPSULE_CONDIM6, "box_cluster5": box_cluster(5),
           "box_bin": BOX_BIN, **{f"pegs_{t}": x for t, x in PEGS.items()}}[name]
    m = mjcf.load_model_from_string(xml, dtype=torch.float32)
    plan = fwd.make_plan(m)
    meta = np.array(step_tpu.kernel_meta(m, plan.idx), np.int32)
    params = plan.params.numpy()
    nenv = 16
    if name == "box_bin":
        qpos, qvel = box_bin_states(nenv, seed=9)
        qpos[::2, 2] -= 0.12
    elif name.startswith("pegs"):
        qpos, qvel = pegs_states(m, nenv, seed=9)
    else:
        qpos, qvel = fused_states(nenv, seed=9)
    ws = (0.5 * np.random.default_rng(10).normal(size=(nenv, 6))).astype(np.float32)
    nefc, ncon = plan.rows
    src, dst = tmp_path / "in", tmp_path / "out"
    with open(src, "wb") as f:
        np.array([nenv, nefc, ncon, group, meta.size, params.size], np.int32).tofile(f)
        meta.tofile(f)
        for a in (params, qpos, qvel, ws):
            np.ascontiguousarray(a, np.float32).tofile(f)
    subprocess.run([str(harness), "step", str(src), str(dst)], check=True, timeout=120)
    out = np.fromfile(dst, np.float32)
    got = out[:nenv * 7].reshape(nenv, 7), out[nenv * 7:nenv * 13].reshape(nenv, 6), \
        out[nenv * 13:].reshape(nenv, 6)
    tq, tv = torch.from_numpy(qpos), torch.from_numpy(qvel)
    want = step_tpu.step_batched_plain(m, tq, tv, torch.from_numpy(ws), plan.params, plan.idx)
    for label, a, b, rtol, atol in zip(("qpos", "qvel", "x"), got, want,
                                       (1e-5, 1e-4, 1e-4), (1e-6, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, b.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{name} G {group} {label}")
    if name == "box_bin" or name.startswith("pegs"):
        pairs, slots = step_tpu._slot_table(m)
        active = step_tpu._problem(m, tq, tv, plan.params, plan.idx).act
        seen = {pairs[pi]["fn"] for (pi, *_), (row, _) in
                zip(slots, step_tpu.contact_layout(m)) if bool(active[:, row].any())}
        assert seen == {p["fn"] for p in pairs}, f"{name}: only {sorted(seen)} in contact"


def _k1_against_plain(exe, tmp_path, group, n, nenv, seed):
    """K1's body at `group` lanes or threads per env on nenv seeded SPD
    systems with NaN above the diagonal, against psd_solve_plain at rtol
    1e-4, atol 1e-5, as the card check (float32, the same algorithm; the
    back substitution's sums in another order)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(nenv, n, n))
    H = (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    g = rng.normal(size=(nenv, n)).astype(np.float32)
    junk = np.where(np.triu(np.ones((n, n), bool), 1), np.float32(np.nan), H)
    src, dst = tmp_path / "in", tmp_path / "out"
    with open(src, "wb") as f:
        np.array([nenv, n, group], np.int32).tofile(f)
        junk.tofile(f)
        g.tofile(f)
    subprocess.run([str(exe), "chol", str(src), str(dst)], check=True, timeout=60)
    got = np.fromfile(dst, np.float32).reshape(nenv, n)
    want = linalg_tpu.psd_solve_plain(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5,
                               err_msg=f"group {group} n {n}")


@pytest.mark.parametrize("group,n", [(8, 1), (8, 7), (8, 8), (16, 9), (16, 11), (16, 16)])
def test_k1_group_body_matches_plain(harness, tmp_path, group, n):
    """K1's row body on 13 seeded SPD systems (_k1_against_plain; the back
    substitution's sums as a butterfly). 13 envs leave the last block
    partial: a simulated warp then holds live groups beside groups past the
    batch, which must run along (the shuffles name the whole warp, and a
    lane that left would hang the harness) and store nothing. Above the
    diagonal H holds NaN, which only the lower triangle's reads keep out of
    x."""
    _k1_against_plain(harness, tmp_path, group, n, 13, 60 + n)


@pytest.mark.parametrize("n", [17, 24, 27, 33, 72, 96])
def test_k1_block_body_matches_plain(harness, tmp_path, n):
    """K1's block body (n > 16: one block of 4 warps per env, panels of 8
    columns) on 5 seeded SPD systems (_k1_against_plain), one block per
    env. n = 17, 24, 27, 33: each side of a panel edge, padded to 24, 24, 32
    and 40 with the identity; 72: PILE's nv; 96: the cap, whose first panel
    (100 rows with g's) nearly fills the block's 128 threads. n % 4 == 0 takes the 16-byte copies,
    which also bring entries above the diagonal in. Above the diagonal H
    holds NaN, and shared memory starts as NaN: only the lower triangle's
    reads keep both out of x."""
    _k1_against_plain(harness, tmp_path, kernels.PSD_BLOCK_THREADS, n, 5, 80 + n)


def _k1_refines(exe, tmp_path, group, n, nenv, seed):
    """K1's body at `group` on nenv seeded systems of condition 1e6: its x is
    within 2e-4 of float64's largest |x| (the float32 solve without the
    refinement step misses by more than 2e-3 on some env), and within 2e-4
    of psd_solve_plain, which takes the same step."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(nenv, n, n)))[0]
    H = ((Q * np.logspace(0, 6, n)) @ Q.transpose(0, 2, 1)).astype(np.float32)
    g = rng.normal(size=(nenv, n)).astype(np.float32)
    src, dst = tmp_path / "in", tmp_path / "out"
    with open(src, "wb") as f:
        np.array([nenv, n, group], np.int32).tofile(f)
        H.tofile(f)
        g.tofile(f)
    subprocess.run([str(exe), "chol", str(src), str(dst)], check=True, timeout=60)
    got = np.fromfile(dst, np.float32).reshape(nenv, n)
    x64 = np.linalg.solve(H.astype(np.float64), g.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(x64).max(-1, keepdims=True)
    H_t, g_t = torch.from_numpy(H), torch.from_numpy(g)
    unrefined = linalg_tpu.chol_solve_plain(H_t, g_t).numpy()
    assert (np.abs(unrefined - x64) / scale).max() > 2e-3
    assert (np.abs(got - x64) / scale).max() < 2e-4
    np.testing.assert_allclose(got, linalg_tpu.psd_solve_plain(H_t, g_t).numpy(), rtol=0,
                               atol=2e-4 * scale.max())


@pytest.mark.parametrize("n", [27, 72])
def test_k1_block_body_refines_ill_conditioned(harness, tmp_path, n):
    """K1's block body ends with one step of iterative refinement (a
    float64 residual from H's lower triangle, the correction solved with
    the float32 factor), on 8 systems (_k1_refines)."""
    _k1_refines(harness, tmp_path, kernels.PSD_BLOCK_THREADS, n, 8, 200 + n)


@pytest.mark.parametrize("group,n", [(8, 7), (16, 11), (16, 16)])
def test_k1_row_body_refines_ill_conditioned(harness, tmp_path, group, n):
    """K1's row body takes the same step (its float64 residual summed by a
    reduce-scatter butterfly over the group, linalg.cuh
    group_residual_rows), on 13 systems: a partial last block, as
    test_k1_group_body_matches_plain (_k1_refines)."""
    _k1_refines(harness, tmp_path, group, n, 13, 300 + n)
