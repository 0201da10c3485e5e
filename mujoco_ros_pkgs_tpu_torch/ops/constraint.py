"""Constraint assembly + solve (mj_fwdConstraint analogue).

Counterpart of mujoco_ros_pkgs_tpu/ops/constraint.py: a model with no
constraint source takes the smooth acceleration; every other one goes
through the efc rows and the solver (ops/efc.fwd_constraint).
"""

from __future__ import annotations

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, Model
from mujoco_ros_pkgs_tpu_torch.ops import efc


def _has_constraints(m: Model) -> bool:
    if m.opt.disableflags & DisableBit.CONSTRAINT:
        return False
    if m.ncon_max and not (m.opt.disableflags & DisableBit.CONTACT):
        return True
    if m.neq and not (m.opt.disableflags & DisableBit.EQUALITY):
        return True
    if ((any(m.jnt_limited) or any(m.tendon_limited))
            and not (m.opt.disableflags & DisableBit.LIMIT)):
        return True
    if ((m.dof_floss_adr or m.tendon_floss_adr)
            and not (m.opt.disableflags & DisableBit.FRICTIONLOSS)):
        return True
    return False


def fwd_constraint(m: Model, d: Data) -> Data:
    if not _has_constraints(m):
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    return efc.fwd_constraint(m, d)
