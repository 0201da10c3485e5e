"""Forward entry points: batched Data construction and the step.

Counterpart of mujoco_ros_pkgs_tpu/ops/forward.py for what the port runs
today: `step` takes the fused path (ops/step_tpu.py) for models it
supports and raises for every other model; the general pipeline is not
ported yet, and there is no fallback to anything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model
from mujoco_ros_pkgs_tpu_torch.ops import step_tpu


def make_data(m: Model, nenv: int) -> Data:
    """A float32 batch of `nenv` envs at qpos0 (mj_makeData + mj_resetData),
    on the model's device."""
    def z(*shape):
        return torch.zeros((nenv,) + shape, dtype=torch.float32, device=m.device)

    qpos = m.qpos0.to(torch.float32).expand(nenv, m.nq).clone()
    return Data(time=z(), qpos=qpos, qvel=z(m.nv), qacc=z(m.nv),
                qacc_warmstart=z(m.nv), ctrl=z(m.nu), qfrc_applied=z(m.nv),
                xfrc_applied=z(m.nbody, 6))


def make_plan(m: Model) -> step_tpu.Plan:
    """What `step` needs besides the state (packed params, kernel metadata);
    raises NotImplementedError for a model the port cannot step yet."""
    if not step_tpu.supports(m):
        raise NotImplementedError(
            "general step not yet ported: the torch port steps only "
            "single-free-body models over static plane geoms "
            "(ops/step_tpu.supports)")
    return step_tpu.make_plan(m)


def step(m: Model, d: Data, plan: Optional[step_tpu.Plan] = None) -> Data:
    """mj_step of the whole batch. A `plan` from make_plan(m) may be made
    once and reused across steps."""
    return step_tpu.step(m, d, plan if plan is not None else make_plan(m))
