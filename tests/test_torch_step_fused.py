"""The torch port's fused step against the JAX package's fused Pallas step.

On the CPU the port runs its plain-torch versions; the JAX side runs its
kernels in interpret mode (pallas_call falls back to it off-TPU). Inputs are
made with numpy from a seed and handed to both. Tolerances are those of the
on-card kernel check in chip_smoke.py: float32 on both sides, the same
algorithm, sums in a different order.

- `_row_forces` and `newton_tiles` against solver_tpu.solve_batched;
- one and five whole steps against step_tpu.step_batched, on BOXES, BOXES
  with a damped free joint, and a capsule + sphere body (condim 6 and 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import solver_tpu as jsolver_tpu
from mujoco_ros_pkgs_tpu.ops import step_tpu as jstep_tpu

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, solver_tpu, step_tpu
from tests.torch_jax import jax_load

BOXES_DAMPED = worlds.BOXES.replace(
    "<freejoint/>", '<joint type="free" damping="0.05" armature="0.01"/>')

CAPSULE = """
<mujoco model="capsule_on_plane">
  <option timestep="0.002" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 1"/>
    <body name="capsule" pos="0 0 0.12">
      <freejoint/>
      <geom type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.05" mass="0.3"
            condim="6" friction="0.8 0.01 0.001"/>
      <geom type="sphere" pos="0 0.08 0" size="0.04" mass="0.1" condim="1"
            priority="1"/>
    </body>
  </worldbody>
</mujoco>
"""

_MODELS = {"boxes": worlds.BOXES, "boxes_damped": BOXES_DAMPED,
           "capsule": CAPSULE}
NENV = 8


def _states(nenv, seed, z0):
    """Random poses near the plane, tilted quaternions, random velocities."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 7), np.float32)
    qpos[:, 2] = z0 + 0.25 * rng.uniform(size=nenv) - 0.05
    quat = rng.normal(size=(nenv, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(nenv, 6))).astype(np.float32)
    ws = (0.5 * rng.normal(size=(nenv, 6))).astype(np.float32)
    return qpos, qvel, ws


@pytest.fixture(scope="module", params=sorted(_MODELS))
def pair(request):
    xml = _MODELS[request.param]
    jm = jax_load(xml, dtype=jnp.float32)
    jparams, _ = jstep_tpu._pack_params(jm)
    jstep = jax.jit(lambda q, v, w, p: jstep_tpu.step_batched(jm, q, v, w, p))
    pm = mjcf.load_model_from_string(xml, dtype=torch.float32)
    return request.param, jm, jparams, jstep, pm, fwd.make_plan(pm)


def test_params_match_jax(pair):
    _, _, jparams, _, _, plan = pair
    np.testing.assert_allclose(plan.params.numpy(), np.asarray(jparams),
                               rtol=1e-7, atol=0)


def test_steps_match_jax(pair):
    """1 step: qpos rtol 1e-5 / atol 1e-6, qvel and qacc 1e-4; 5 steps: qpos
    atol 1e-4 (the JAX kernel's x is the port's qacc)."""
    name, jm, jparams, jstep, pm, plan = pair
    qpos, qvel, ws = _states(NENV, seed=0, z0=float(pm.qpos0[2]))
    jq, jv, jw = jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ws)
    tq, tv, tw = torch.from_numpy(qpos), torch.from_numpy(qvel), torch.from_numpy(ws)
    for k in range(5):
        jq, jv, jw = jstep(jq, jv, jw, jparams)
        tq, tv, tw = step_tpu.step_batched(pm, tq, tv, tw, plan)
        if k == 0:
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} qpos, 1 step")
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} qvel, 1 step")
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} qacc, 1 step")
    assert np.isfinite(tq.numpy()).all()
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-4,
                               err_msg=f"{name} qpos, 5 steps")


def test_data_step_updates_state(pair):
    """forward.step advances time by dt and carries x into qacc and the
    warmstart, as the JAX package's step_tpu.step does."""
    _, _, _, _, pm, plan = pair
    d = fwd.make_data(pm, 3)
    d2 = fwd.step(pm, d, plan)
    np.testing.assert_allclose(d2.time.numpy(), np.full(3, 0.002, np.float32))
    assert torch.equal(d2.qacc, d2.qacc_warmstart)
    assert d2.qpos.shape == (3, 7) and d2.qvel.shape == (3, 6)


# ---------------------------------------------------------------------------
# Newton body (K2's) against the JAX fused solver
# ---------------------------------------------------------------------------

_KINDS = ("eq", "fri", "lim") + ("con",) * 14
_CON_BASE = ((3, 1), (4, 3), (7, 4), (11, 6))


def _random_rows(seed, nenv=NENV):
    """Random rows of every class (row math only: no solve runs on them)."""
    rng = np.random.default_rng(seed)
    nefc = len(_KINDS)
    D = (np.abs(rng.normal(size=(nenv, nefc))) + 0.5).astype(np.float32)
    floss = np.zeros((nenv, nefc), np.float32)
    floss[:, 1] = 0.2
    active = rng.uniform(size=(nenv, nefc)) < 0.85
    mu = np.tile(np.array([0.9, 0.9, 0.005, 1e-4, 1e-4], np.float32),
                 (nenv, len(_CON_BASE), 1))
    mu *= rng.uniform(0.5, 1.5, size=(nenv, len(_CON_BASE), 1)).astype(np.float32)
    jar = (0.5 * rng.normal(size=(nenv, nefc))).astype(np.float32)
    return dict(D=D, floss=floss, active=active, mu=mu, jar=jar)


def test_row_forces_match_jax():
    """Forces, weights, cost and cone Hessian blocks of every row class
    ('eq', 'fri', 'lim', condim 1/3/4/6 contacts) on random rows, against
    the JAX kernel's row math evaluated on (B,) arrays."""
    p = _random_rows(1)
    con_rows = {r for b, d in _CON_BASE for r in range(b, b + d)}
    mu_l = [[jnp.asarray(p["mu"][:, c, k]) for k in range(5)]
            for c in range(len(_CON_BASE))]

    def cols(a):
        return [jnp.asarray(a[:, r]) for r in range(a.shape[1])]
    jf, jw, jcost, jW = jsolver_tpu._row_forces(
        _KINDS, con_rows, _CON_BASE, mu_l, cols(p["D"]), cols(p["floss"]),
        cols(p["active"]), cols(p["jar"]), True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    f, w, cost, W = solver_tpu._row_forces(
        _KINDS, _CON_BASE, t["mu"], t["D"], t["floss"], t["active"], t["jar"],
        True)
    np.testing.assert_allclose(f.numpy(), np.stack([np.asarray(a) for a in jf], 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.stack([np.asarray(a) for a in jw], 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cost.numpy(), np.asarray(sum(jcost)),
                               rtol=1e-5, atol=1e-5)
    for ci, (base, dim) in enumerate(_CON_BASE):
        if dim == 1:
            assert jW[ci] is None
            continue
        idx, Wm = W[dim]
        c = [int(r) for r in idx[:, 0]].index(base)
        for i in range(dim):
            for j in range(i + 1):
                np.testing.assert_allclose(
                    Wm[:, c, i, j].numpy(), np.asarray(jW[ci][(i, j)]),
                    rtol=1e-5, atol=1e-5, err_msg=f"W[{i},{j}] contact {ci}")


def test_newton_matches_jax_solve_batched():
    """The whole Newton solve (warmstart, grid bracket, polish, masking) on
    the contact rows of the capsule world (condim 6 and 1) at random
    states, against the JAX fused solver kernel, at the fused step's trip
    counts. Both sides get the same rows."""
    m = mjcf.load_model_from_string(CAPSULE, dtype=torch.float32)
    plan = fwd.make_plan(m)
    qpos, qvel, ws = (torch.from_numpy(a) for a in _states(NENV, 6, 0.04))
    pr = step_tpu._problem(m, qpos, qvel, plan.params, plan.idx)
    kinds = ("con",) * pr.J.shape[1]
    inputs = dict(J=pr.J, aref=pr.aref, D=pr.D, floss=torch.zeros_like(pr.D),
                  active=pr.act, mu=pr.mu, M=pr.M, a_s=pr.a_s, ws=ws)
    assert bool(pr.act.any())
    jx, _, jf = jsolver_tpu.solve_batched(
        kinds, pr.con_base, 6, niter=32, nls=8, tol=1e-8, warmstart=True,
        **{k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
    x, f = solver_tpu.newton_tiles(6, kinds, pr.con_base, 32, 8, True, 1e-8,
                                   *inputs.values())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)


def test_chol_solve_matches_numpy():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 6, 6))
    H = A @ A.transpose(0, 2, 1) + np.eye(6)
    g = rng.normal(size=(5, 6))
    x = linalg_tpu.psd_solve_plain(torch.from_numpy(H), torch.from_numpy(g))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(H, g[..., None])[..., 0],
                               rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# gate and kernel metadata
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,ok", [("BOXES", True), ("BOXES_DAMPED", True),
                                     ("CAPSULE", True), ("PENDULUM", False),
                                     ("PILE", False)])
def test_supports_gate(name, ok):
    xml = {"BOXES_DAMPED": BOXES_DAMPED, "CAPSULE": CAPSULE}.get(
        name) or getattr(worlds, name)
    m = mjcf.load_model_from_string(xml)
    assert step_tpu.supports(m) is ok
    if not ok:
        # outside the fused gate, the general route steps it (PILE: box-box
        # pairs, nv = 72, through the general Newton)
        assert fwd.make_plan(m) == fwd.GeneralPlan()
        d = fwd.step(m, fwd.make_data(m, 2))
        assert torch.isfinite(d.qpos).all()
        assert float(d.time[0]) == pytest.approx(float(m.opt.timestep))


def test_kernel_meta_layout():
    """Pairs in slot order; per-geom params laid out (size, pos, quat)."""
    m = mjcf.load_model_from_string(CAPSULE, dtype=torch.float32)
    params, idx = step_tpu._pack_params(m)
    meta = step_tpu.kernel_meta(m, idx)
    head = len(step_tpu._META_HEADER) + len(step_tpu._META_PARAMS)
    npairs, nrows = meta[0], meta[1]
    assert (npairs, nrows) == (2, 2 * 6 + 1)
    assert meta[2:4] == [32, 8]
    recs = [meta[head + k * step_tpu._PAIR_STRIDE:head + (k + 1) * step_tpu._PAIR_STRIDE]
            for k in range(npairs)]
    assert [r[-1] for r in recs] == [6, 1]            # capsule pair first
    for g in range(m.ngeom):
        assert idx[f"gpos{g}"][0] == idx[f"gsize{g}"][0] + 3
        assert idx[f"gquat{g}"][0] == idx[f"gsize{g}"][0] + 6


@pytest.mark.parametrize("name", ["BOXES", "BOXES_DAMPED", "CAPSULE"])
def test_kernel_meta_carries_the_solve_block(name):
    """K3's metadata ends with the block K2 reads (solver_tpu.kernel_meta of
    the step's contact rows: row codes by row_codes, condim-1 rows
    one-sided, then (first row, condim) per contact, as _problem lays the
    rows out), and the plan carries (rows, contacts)."""
    xml = {"BOXES_DAMPED": BOXES_DAMPED, "CAPSULE": CAPSULE}.get(name) or worlds.BOXES
    m = mjcf.load_model_from_string(xml, dtype=torch.float32)
    plan = fwd.make_plan(m)
    qpos, qvel, _ = (torch.from_numpy(a) for a in _states(2, 0, float(m.qpos0[2])))
    con_base = step_tpu._problem(m, qpos, qvel, plan.params, plan.idx).con_base
    nrows = sum(d for _, d in con_base)
    block = solver_tpu.kernel_meta(("con",) * nrows, con_base, 6, 32, 8, True)
    meta = step_tpu.kernel_meta(m, plan.idx)
    assert meta[-len(block):] == block
    assert block[6:6 + nrows] == solver_tpu.row_codes(("con",) * nrows, con_base)
    head = len(step_tpu._META_HEADER) + len(step_tpu._META_PARAMS)
    assert len(meta) == head + meta[0] * step_tpu._PAIR_STRIDE + len(block)
    assert plan.rows == (nrows, len(con_base))
    if name == "CAPSULE":
        assert block[6:6 + nrows] == [3] * 12 + [2]


# ---------------------------------------------------------------------------
# K3's x on saved envs against the JAX kernel (a CPU tool, not a test)
# ---------------------------------------------------------------------------

def k3_x_against_jax(path="chip_smoke_out/k3_x_envs.npz"):
    """The fused step's solver x on saved envs against the JAX package's own
    fused kernel:

        python -m tests.test_torch_step_fused [chip_smoke_out/k3_x_envs.npz]

    chip_smoke.py saves, for every K3 width and shape on 3 and 5 boxes, the
    envs where K3's x leaves 1e-4 + 1e-4 |x| plus twice the plain version's
    float32-vs-float64 gap and the SAVED_TOP envs where K3's x and the plain
    step's float32 x lie farthest from float64: their states, K3's x, the
    plain step's in float32 and in float64, and over all envs (plain
    float32's worst, K3's, their 99th percentiles) against float64. This
    runs `step_tpu.step_batched` of the JAX package (its Pallas kernel in
    interpret mode on the CPU; one XLA compile per world, minutes for 5
    boxes) on the same states and prints, env by env, how far each float32
    x lies from float64 in units of 1e-4 + 1e-4 |x64|, then per shape each
    float32 x's worst env as a multiple of plain float32's worst over all
    envs: the JAX kernel's reading is the factor its own float32 rounding
    reaches on those envs."""
    from tests.torch_problems import box_cluster
    saved = np.load(path)
    keys = sorted({k.rsplit("_", 1)[0] for k in saved.files})
    np.set_printoptions(precision=4, linewidth=160)
    for label in sorted({key.split("_")[0] for key in keys}):
        group = [key for key in keys if key.split("_")[0] == label]
        nbox = int(label[0])
        jm = jax_load(box_cluster(nbox), dtype=jnp.float32)
        params, _ = jstep_tpu._pack_params(jm)
        # every shape's envs in one batch: one compile per world
        q, v, w = (np.concatenate([saved[f"{key}_{name}"] for key in group])
                   for name in "qvw")
        _, _, jx = jax.jit(lambda q, v, w, p: jstep_tpu.step_batched(jm, q, v, w, p))(
            q, v, w, params)
        jx, start = np.asarray(jx), 0
        for key in group:
            x64 = saved[f"{key}_p64"]
            kx = jx[start:start + len(x64)]
            start += len(x64)
            unit = 1e-4 + 1e-4 * np.abs(x64)
            worst_p32, worst_k3, q99_p32, q99_k3 = saved[f"{key}_stats"]
            print(f"{key}: envs {saved[f'{key}_idx'].tolist()}, max |x| "
                  f"{np.abs(x64).max(-1)}")
            reading = {}
            for name, x in (("K3", saved[f"{key}_k3"]),
                            ("plain float32", saved[f"{key}_p32"]), ("JAX kernel", kx)):
                reading[name] = (np.abs(x - x64) / unit).max(-1)
                print(f"  {name:14s} vs float64: {reading[name]}")
            print(f"  {'K3':14s} vs JAX kernel: "
                  f"{(np.abs(saved[f'{key}_k3'] - kx) / unit).max(-1)}")
            print(f"  over all envs: K3 worst {worst_k3:.3f}, 99th percentile "
                  f"{q99_k3:.3f}; plain float32 worst {worst_p32:.3f}, 99th percentile "
                  f"{q99_p32:.3f}")
            print(f"  worst saved env over plain float32's worst: " + ", ".join(
                f"{name} {reading[name].max() / worst_p32:.3f}" for name in reading))


def jax_x_over_all_envs(nbox, nenv):
    """The JAX package's fused kernel (interpret mode, CPU) on all of
    chip_smoke.py's timing states of one K3 shape (nbox boxes, nenv envs,
    seed 1), against the port's plain step in float64 on the CPU:

        python -m tests.test_torch_step_fused --all 5 65536

    prints the JAX kernel's worst env, 99th percentile and top envs in
    units of 1e-4 + 1e-4 |x64|, beside which chip_smoke.py prints K3's and
    the plain float32 step's on the card."""
    import chip_smoke
    from tests.torch_problems import box_cluster
    xml = box_cluster(nbox)
    q, v, w = chip_smoke.states(nenv, seed=1, device="cpu")
    m64 = mjcf.load_model_from_string(xml, dtype=torch.float64)
    plan64 = fwd.make_plan(m64)
    x64 = step_tpu.step_batched_plain(m64, q.double(), v.double(), w.double(),
                                      plan64.params, plan64.idx)[2].numpy()
    jm = jax_load(xml, dtype=jnp.float32)
    params, _ = jstep_tpu._pack_params(jm)
    _, _, jx = jax.jit(lambda q, v, w, p: jstep_tpu.step_batched(jm, q, v, w, p))(
        q.numpy(), v.numpy(), w.numpy(), params)
    err = (np.abs(np.asarray(jx) - x64) / (1e-4 + 1e-4 * np.abs(x64))).max(-1)
    top = np.argsort(err)[::-1][:8]
    print(f"{nbox} boxes, {nenv} envs: JAX kernel vs float64 worst env {err.max():.3f}, "
          f"99th percentile {np.quantile(err, 0.99):.3f}; top envs {top.tolist()} at "
          f"{np.round(err[top], 4).tolist()}")


if __name__ == "__main__":
    import sys
    jax.config.update("jax_enable_x64", True)     # as tests/conftest.py runs JAX
    if sys.argv[1:2] == ["--all"]:
        jax_x_over_all_envs(int(sys.argv[2]), int(sys.argv[3]))
    else:
        k3_x_against_jax(*sys.argv[1:])
