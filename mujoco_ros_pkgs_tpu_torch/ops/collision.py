"""Collision entry point: the disable-flag and empty-pair-table gate in
front of ops/narrowphase.collide (counterpart of
mujoco_ros_pkgs_tpu/ops/collision.py).
"""

from __future__ import annotations

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, Model
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase


def collide(m: Model, d: Data) -> Data:
    if m.ncon_max == 0 or (m.opt.disableflags & DisableBit.CONTACT):
        return d
    return narrowphase.collide(m, d)
