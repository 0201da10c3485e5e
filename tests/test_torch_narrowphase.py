"""The port's pair primitives (ops/narrowphase_soa.SOA_FNS) against the
JAX package's structure-of-arrays primitives of the same name.

Inputs are seeded numpy poses at tests/test_narrowphase_soa.py's sizes
(CASES), handed to both packages in float64; every contact's distance,
position and frame must agree to rtol 1e-9 / atol 1e-12. Face-on boxes tie
on several separating axes, so `_box_box` also runs on axis-aligned stacks,
where a different tie rule would pick another normal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mujoco_ros_pkgs_tpu.ops import narrowphase_soa as jsoa

from mujoco_ros_pkgs_tpu_torch.ops import narrowphase_soa as soa
from tests.test_narrowphase_soa import CASES

E, P = 5, 7  # envs, pairs


def _rotations(rng, shape):
    q = rng.standard_normal(shape + (4,))
    w, x, y, z = np.moveaxis(q / np.linalg.norm(q, axis=-1, keepdims=True), -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _poses(rng, name):
    """(pos, rot, size) of geom 1 and geom 2, each (E, P, 3) / (E, P, 3, 3) /
    (E, P, 3); planes sit at the origin unrotated, as in the JAX test."""
    size1, size2 = CASES[name]
    out = []
    for k, size in enumerate((size1, size2)):
        pos = rng.uniform(-0.15, 0.15, (E, P, 3))
        rot = _rotations(rng, (E, P))
        if k == 0 and name.startswith("_plane"):
            pos[:] = 0.0
            rot[:] = np.eye(3)
        out.append((pos, rot, np.broadcast_to(np.asarray(size, float), (E, P, 3))))
    return out


def _face_on_boxes():
    """Box pairs stacked along x, y or z, some offset so that two or three
    separating axes tie exactly; the last two turned 45 degrees about z (an
    exact sqrt(1/2) rotation), so that two faces of the incident box tie."""
    size1, size2 = CASES["_box_box"]
    pos1 = np.zeros((E, P, 3))
    pos2 = np.zeros((E, P, 3))
    offsets = [(0, 0, 0.14), (0.13, 0, 0), (0, 0.12, 0), (0.02, 0.03, 0.145),
               (0.11, 0.13, 0), (0.15, 0, 0), (0, 0.14, 0.02)]
    for p, off in enumerate(offsets):
        pos2[:, p] = off
    pos2 += np.arange(E)[:, None, None] * 0.004
    rot1 = np.broadcast_to(np.eye(3), (E, P, 3, 3)).copy()
    rot2 = rot1.copy()
    h = np.sqrt(0.5)
    rot2[:, 5:] = [[h, -h, 0], [h, h, 0], [0, 0, 1]]
    return [(pos1, rot1, np.broadcast_to(np.asarray(size1, float), (E, P, 3))),
            (pos2, rot2, np.broadcast_to(np.asarray(size2, float), (E, P, 3)))]


def _components(pose, lib):
    pos, rot, size = pose
    t = (lambda a: jnp.asarray(np.ascontiguousarray(a))) if lib == "jax" else \
        (lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return (tuple(t(pos[..., k]) for k in range(3)),
            tuple(tuple(t(rot[..., i, j]) for j in range(3)) for i in range(3)),
            tuple(t(size[..., k]) for k in range(3)))


def _flat(out):
    dists, poss, frames = out
    return ([np.asarray(d) for d in dists],
            [np.stack([np.asarray(c) for c in p], -1) for p in poss],
            [np.stack([np.stack([np.asarray(c) for c in row], -1) for row in f], -2)
             for f in frames])


@pytest.mark.parametrize("name,poses", [(n, "random") for n in sorted(soa.SOA_FNS)]
                         + [("_box_box", "face_on")])
def test_primitive_matches_jax(name, poses):
    """Every primitive, float64, rtol 1e-9 / atol 1e-12: the twelve of the
    fused step and the general route, plus face-on box stacks."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    g1, g2 = _poses(rng, name) if poses == "random" else _face_on_boxes()
    want = _flat(jsoa.SOA_FNS[name](*_components(g1, "jax"), *_components(g2, "jax")))
    got = _flat(soa.SOA_FNS[name](*_components(g1, "torch"),
                                  *_components(g2, "torch")))
    for label, a, b in zip(("dist", "pos", "frame"), got, want):
        assert len(a) == len(b)
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{name} {poses} {label} {k}")
    dist = np.stack(got[0])
    assert (dist < 0).any() and (dist[dist < 1e9] > 0).any(), f"{name}: no mix of contacts"
