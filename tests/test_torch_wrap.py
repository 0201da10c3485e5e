"""Spatial-tendon wrapping of the torch port against the JAX package.

- ops/wrap.py against the JAX package's ops/wrap.py on seeded sweeps of
  every branch: the circle with no sidesite, with one outside and with one
  inside (the Fermat bisection), the sphere and the cylinder through
  wrap_geom in rotated and shifted geom frames (colinear endpoints among
  the sphere's), and the cases of tests/test_wrap_unit.py. The JAX side
  runs op by op under jax.vmap, no jit. Tangent points, arcs and the
  active flags agree to 1e-12, except where a sidesite is inside: there the
  bend point is a 26-step bisection whose comparisons sit at rounding level
  near the root, so the two packages may take a different half at the last
  steps; the bound is 2^-20 of the arc (4e-6 rad times the radius), and the
  active flag is exact;
- MUSCLE_ARM (tests/torch_problems.MUSCLE_ARM_EXPLICIT): the compile
  equals the JAX package's, and at seeded states the JAX package's
  smooth.tendon (one jit) on the port's own position stage gives the port's lengths, ten_J and velocities to 1e-12, with
  each kind of wrap bending in some envs and straight in others;
- malformed spatial tendons raise ValueError in both packages alike.

The JAX models load through tests/torch_jax.jax_load (set_constants under
one jit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import forward as jfwd
from mujoco_ros_pkgs_tpu.ops import smooth as jsmooth
from mujoco_ros_pkgs_tpu.ops import wrap as jwrap

from mujoco_ros_pkgs_tpu_torch.core import mjcf
from mujoco_ros_pkgs_tpu_torch.core.convert import model_from_numpy
from mujoco_ros_pkgs_tpu_torch.ops import forward as fwd
from mujoco_ros_pkgs_tpu_torch.ops import smooth
from mujoco_ros_pkgs_tpu_torch.ops import wrap

from tests.test_torch_compile import assert_models_equal, jax_model_to_numpy
from tests.torch_problems import MUSCLE_ARM_EXPLICIT, muscle_arm_states
from tests.torch_jax import jax_load

N = 384
INSIDE_TOL = 2.0 ** -20


def _polar(rng, n, lo, hi):
    ang = rng.uniform(-np.pi, np.pi, n)
    rad = rng.uniform(lo, hi, n)
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)


def _circle_case(mode, seed):
    """Endpoints 1.05 to 3 radii out, sidesites outside (1.05-2 radii) or
    inside (0-0.95 radii) the circle."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 1.5, N)
    p0 = _polar(rng, N, 1.05, 3.0) * r[:, None]
    p1 = _polar(rng, N, 1.05, 3.0) * r[:, None]
    side = (_polar(rng, N, 0.0, 0.95) if mode == "inside"
            else _polar(rng, N, 1.05, 2.0)) * r[:, None]
    return p0, p1, r, side


def _close(name, got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("mode", ["none", "outside", "inside"])
def test_wrap_circle_matches_jax(mode):
    p0, p1, r, side = _circle_case(mode, seed={"none": 1, "outside": 2, "inside": 3}[mode])
    has_side = mode != "none"
    inside = np.linalg.norm(side, axis=1) < r
    got = wrap.wrap_circle(*(torch.from_numpy(a) for a in (p0, p1, r, side)),
                           torch.tensor(has_side), torch.from_numpy(inside))
    want = jax.vmap(lambda a, b, rr, s, si: jwrap.wrap_circle(a, b, rr, s, has_side, si))(
        *(jnp.asarray(a) for a in (p0, p1, r, side, inside)))
    assert torch.equal(got[3], torch.from_numpy(np.asarray(want[3])))
    tol = INSIDE_TOL * float(r.max()) if mode == "inside" else 1e-12
    for k, name in enumerate(("t0", "t1", "arc")):
        _close(f"{mode} {name}", got[k], want[k], tol)
    # both outcomes occur in the sweep
    assert 0 < int(got[3].sum()) < N


def _frames(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                  2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                  2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                 1).reshape(n, 3, 3)
    return rng.uniform(-1, 1, size=(n, 3)), R


@pytest.mark.parametrize("kind", ["sphere", "cylinder"])
def test_wrap_geom_matches_jax(kind):
    """wrap_geom in random frames, every sidesite mode in one sweep (no
    sidesite, outside, inside), a sixteenth of the sphere's chords through
    the centre (colinear endpoints)."""
    rng = np.random.default_rng(7 if kind == "sphere" else 8)
    gpos, R = _frames(rng, N)
    r = rng.uniform(0.3, 1.0, N)
    sphere = kind == "sphere"

    def local_points(lo, hi):
        v = rng.normal(size=(N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        if not sphere:            # the cylinder's cable runs off its axis
            v[:, 2] *= 2.0
        return v * (r * rng.uniform(lo, hi, N))[:, None]
    p0l, p1l = local_points(1.1, 3.0), local_points(1.1, 3.0)
    if sphere:
        p1l[::16] = -p0l[::16] * 1.3
    mode = rng.integers(0, 3, N)                  # 0 none, 1 outside, 2 inside
    sidel = np.where((mode == 2)[:, None], local_points(0.0, 0.9), local_points(1.1, 2.0))
    if not sphere:                                # inside: within the cylinder's disk
        sidel[mode == 2, 2] = rng.uniform(-1, 1, int((mode == 2).sum()))
    world = [gpos + np.einsum("nij,nj->ni", R, p) for p in (p0l, p1l, sidel)]
    got = wrap.wrap_geom(torch.from_numpy(world[0]), torch.from_numpy(world[1]),
                         torch.from_numpy(gpos), torch.from_numpy(R), torch.from_numpy(r),
                         torch.tensor(sphere), torch.from_numpy(world[2]),
                         torch.from_numpy(mode > 0))
    for has_side, sel in ((False, mode == 0), (True, mode > 0)):
        idx = np.nonzero(sel)[0]
        want = jax.vmap(lambda a, b, gp, gm, rr, s: jwrap.wrap_geom(
            a, b, gp, gm, rr, sphere, s, has_side))(
            *(jnp.asarray(x[idx]) for x in (world[0], world[1], gpos, R, r, world[2])))
        act = got[3][idx]
        assert torch.equal(act, torch.from_numpy(np.asarray(want[3]))), (kind, has_side)
        inside = mode[idx] == 2
        for k, name in enumerate(("t0", "t1", "arc")):
            for part, tol in ((~inside, 1e-12), (inside, INSIDE_TOL * float(r.max()) * 4)):
                if part.any():
                    _close(f"{kind} side={has_side} {name}", got[k][idx][part],
                           np.asarray(want[k])[part], tol)
        assert 0 < int(act.sum()) < len(idx), (kind, has_side)


def test_wrap_unit_cases_match_jax():
    """tests/test_wrap_unit.py's degenerate and boundary cases: the
    port's results equal the JAX package's and keep the properties those
    tests state."""
    cases = [((-2.0, 1.5), (2.0, 1.5), (0.0, 0.0), False, False),
             ((0.2, 0.0), (3.0, 0.1), (0.0, 0.0), False, False),
             ((-2.0, 0.9), (2.0, 0.9), (0.0, 0.0), False, True),
             ((-2.0, -1.5), (2.0, -1.5), (0.0, 2.0), True, True),
             ((-2.0, -1.5), (2.0, -1.5), (0.0, -2.0), True, False)]
    for p0, p1, side, has_side, bends in cases:
        a = [torch.tensor(x, dtype=torch.float64) for x in (p0, p1, side)]
        got = wrap.wrap_circle(a[0], a[1], torch.tensor(1.0, dtype=torch.float64), a[2],
                               torch.tensor(has_side), torch.tensor(False))
        want = jwrap.wrap_circle(*(jnp.asarray(x) for x in (p0, p1)), 1.0,
                                 jnp.asarray(side), has_side)
        assert bool(got[3]) == bool(want[3]) == bends, (p0, p1, side)
        for k in range(3):
            _close(f"unit case {p0} {p1}", got[k], want[k], 1e-12)
    t0, t1, arc, act = wrap.wrap_circle(
        torch.tensor([-2.0, 0.9]), torch.tensor([2.0, 0.9]), torch.tensor(1.0),
        torch.zeros(2), torch.tensor(False), torch.tensor(False))
    assert 0.0 < float(arc) < 1.0 and abs(float(t0.norm()) - 1.0) < 1e-6
    # the sphere with colinear endpoints and no sidesite does not bend
    I = torch.eye(3, dtype=torch.float64)
    z = torch.zeros(3, dtype=torch.float64)
    _, _, arc, act = wrap.wrap_geom(torch.tensor([0.0, 0.0, 2.0]).double(),
                                    torch.tensor([0.0, 0.0, -2.0]).double(), z, I,
                                    torch.tensor(0.5).double(), torch.tensor(True), z,
                                    torch.tensor(False))
    assert not bool(act) and float(arc) == 0.0
    # the cylinder's helix: the arc exceeds the planar one, z in between
    p0 = torch.tensor([-2.0, 0.9, 0.0]).double()
    p1 = torch.tensor([2.0, 0.9, 1.0]).double()
    t0, t1, arc3d, act = wrap.wrap_geom(p0, p1, z, I, torch.tensor(1.0).double(),
                                        torch.tensor(False), z, torch.tensor(False))
    want = jwrap.wrap_cylinder(jnp.asarray(p0.numpy()), jnp.asarray(p1.numpy()), 1.0,
                               jnp.zeros(3), False)
    for k in range(3):
        _close("helix", (t0, t1, arc3d)[k], want[k], 1e-12)
    assert bool(act) and 0.0 < float(t0[2]) <= float(t1[2]) < 1.0


@pytest.fixture(scope="module")
def arm():
    pm = mjcf.load_model_from_string(MUSCLE_ARM_EXPLICIT)
    jm = jax_load(MUSCLE_ARM_EXPLICIT)
    return pm, jm


def test_muscle_arm_compiles_as_jax(arm):
    """Every field of MUSCLE_ARM's compile, the wrap columns (sidesites,
    pulley divisors), the tendons' length0 and invweight0 and the
    actuators' acc0 and lengthranges among them."""
    pm, jm = arm
    assert_models_equal(pm, model_from_numpy(*jax_model_to_numpy(jm)))
    assert -1 in pm.wrap_sidesite and 2.0 in pm.wrap_divisor


def test_muscle_arm_tendons_match_jax(arm):
    """ten_length, ten_J and ten_velocity of every spatial tendon at 24
    seeded states against the JAX package's smooth.tendon on the port's
    position stage (sites, geom frames, subtree coms, cdof), to 1e-12; the
    shoulder's sphere, the elbow's cylinder (both sidesites) and the
    wrist's sphere (sidesite inside) each bend in some envs and not in
    others."""
    pm, jm = arm
    qpos, qvel, act, ctrl = muscle_arm_states(pm, 24, seed=5)
    d = fwd.make_data(pm, 24).replace(qpos=torch.from_numpy(qpos),
                                      qvel=torch.from_numpy(qvel))
    pd = smooth.fwd_position_smooth(pm, d)
    d0 = jfwd.make_data(jm)
    fields = ("qpos", "qvel", "site_xpos", "geom_xpos", "geom_xmat", "subtree_com", "cdof")
    jd = jax.jit(jax.vmap(lambda *a: jsmooth.tendon(jm, d0.replace(**dict(zip(fields, a))))))(
        *(jnp.asarray(getattr(pd, f).numpy()) for f in fields))
    for field in ("ten_length", "ten_J", "ten_velocity"):
        _close(field, getattr(pd, field), getattr(jd, field), 1e-12)
    # each wrap's branch in the batch
    _, w, _, _ = smooth.tendon_meta(pm)
    gid = torch.from_numpy(w["geom"])
    side = pd.site_xpos[:, torch.from_numpy(np.maximum(w["side"], 0))]
    _, _, _, bent = wrap.wrap_geom(pd.site_xpos[:, torch.from_numpy(w["prev"])],
                                   pd.site_xpos[:, torch.from_numpy(w["next"])],
                                   pd.geom_xpos[:, gid], pd.geom_xmat[:, gid],
                                   pm.geom_size[gid, 0], torch.from_numpy(w["sphere"]),
                                   side, torch.from_numpy(w["side"] >= 0))
    names = [pm.geom_names[g] for g in w["geom"]]
    assert names == ["shoulder_wrap", "elbow_wrap", "elbow_wrap", "wrist_wrap"]
    frac = bent.double().mean(0)
    assert bool(((frac > 0) & (frac < 1)).all()), dict(zip(names, frac.tolist()))


_BAD = {
    "start": ('<pulley divisor="2"/><site site="a"/><site site="b"/>',
              "must start and end at sites"),
    "bracket": ('<site site="a"/><geom geom="ball"/><pulley divisor="2"/><site site="b"/>',
                "bracketed by sites"),
    "box": ('<site site="a"/><geom geom="box"/><site site="b"/>', "sphere or cylinder"),
    "sidesite": ('<site site="a"/><geom geom="ball" sidesite="nowhere"/><site site="b"/>',
                 "nowhere"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_malformed_spatial_tendons_raise(case):
    """A path that starts at a pulley, a wrap geom not between two sites,
    a box as a wrap geom and an unknown sidesite raise ValueError at
    compile in both packages."""
    path, match = _BAD[case]
    xml = ('<mujoco><worldbody><body><joint name="j" range="-1 1"/>'
           '<geom name="ball" type="sphere" size="0.05"/>'
           '<geom name="box" type="box" size="0.05 0.05 0.05" pos="0 0 -0.2"/>'
           '<site name="a" pos="0.1 0 0.1"/><site name="b" pos="-0.1 0 0.1"/></body>'
           f'</worldbody><tendon><spatial name="t">{path}</spatial></tendon></mujoco>')
    with pytest.raises(ValueError, match=match):
        mjcf.load_model_from_string(xml)
    with pytest.raises(ValueError, match=match):
        jax_load(xml)
