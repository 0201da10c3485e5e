"""Broadphase: the bounding-volume scores behind the top-k pair compaction.

Counterpart of mujoco_ros_pkgs_tpu/ops/broadphase.py. With m.pair_topk = K
> 0, a narrowphase group of more than K pairs whose geom types have a
bounding volume (`compactable`) scores every pair of every env in one
pass (`pair_scores`), and only the K most-overlapping pairs of each env run
the narrowphase (ops/narrowphase.collide), into dynamic contact slots whose
geom pair is per env (Contact.dyn_pair). When more than K pairs of a group
overlap, the contact set is approximate: `candidate_overflow` counts the
overlapping pairs that were dropped, per env.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, GeomType, Model
from mujoco_ros_pkgs_tpu_torch.ops.math import static_tensor


def pair_scores(m: Model, d: Data, g1s: np.ndarray, g2s: np.ndarray,
                t1: GeomType) -> torch.Tensor:
    """Separation score (B, P) of the pairs (g1s[p], g2s[p]) in every env,
    negative where the bounding volumes overlap: |x1 - x2| - r1 - r2 for
    finite geoms, n . (x2 - x1) - r2 when geom1 is a plane (n its +z axis),
    less the pair's larger margin, so that margin contacts stay visible."""
    dev = d.qpos.device
    i1, i2 = static_tensor(g1s, dev), static_tensor(g2s, dev)
    x1, x2 = d.geom_xpos[:, i1], d.geom_xpos[:, i2]
    rb = m.geom_rbound.to(x1.dtype)
    margin = torch.maximum(m.geom_margin[i1], m.geom_margin[i2]).to(x1.dtype)
    if t1 == GeomType.PLANE:
        n = d.geom_xmat[:, i1][..., 2]
        sep = (n * (x2 - x1)).sum(-1) - rb[i2]
    else:
        v = x2 - x1 + 1e-12
        sep = torch.sqrt((v * v).sum(-1)) - rb[i1] - rb[i2]
    return sep - margin


def compactable(t1: GeomType, t2: GeomType) -> bool:
    """Whether a (t1, t2) group may be compacted: both geoms need a bounding
    volume the score understands (height fields have none, and a plane
    only as geom1)."""
    if t1 == GeomType.HFIELD or t2 == GeomType.HFIELD:
        return False
    return t2 != GeomType.PLANE


def candidate_overflow(m: Model, d: Data) -> torch.Tensor:
    """The overlapping pairs (B,) int64 the compaction dropped in each env
    at d's geom poses, summed over the compacted groups (0: the contact set
    is exact)."""
    from mujoco_ros_pkgs_tpu_torch.ops import narrowphase

    total = torch.zeros(d.qpos.shape[0], dtype=torch.int64, device=d.qpos.device)
    for grp in narrowphase.pair_groups(m):
        if grp["topk"]:
            sep = pair_scores(m, d, grp["g1s"], grp["g2s"], grp["key"][1])
            total = total + torch.clamp((sep < 0).sum(-1) - grp["topk"], min=0)
    return total
