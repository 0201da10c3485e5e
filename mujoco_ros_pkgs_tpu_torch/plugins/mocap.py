"""Mocap plugin: pose injection for mocap bodies (mujoco_ros_mocap_plugin).

Counterpart of mujoco_ros_pkgs_tpu/plugins/mocap.py. Reference
(mujoco_ros_mocap_plugin/src/mocap_plugin.cpp): `set_mocap_state` checks
that every name is a mocap body (:50-70); every step the control callback
writes d->mocap_pos / d->mocap_quat from the last state received, the
quaternion normalised (:80-105). Typical use: drive a weld to pull a
dynamic body toward a target (mujoco_ros_mocap_plugin/README.md:7).

The state holds every env's targets, tensors pos (nenv, nmocap, 3) and quat
(nenv, nmocap, 4) on the model's device; `set_state` is the host-side
setter, and the control hook copies the targets into the batch each step,
so host writes land at step boundaries.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model
from mujoco_ros_pkgs_tpu_torch.msgs import MocapState, ServiceResult
from mujoco_ros_pkgs_tpu_torch.ops import smooth
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin


class MocapPlugin(MujocoPlugin):

    def load(self, m: Model, d: Data) -> bool:
        self._m = m
        return True

    def init_state(self, m: Model, nenv: int) -> Any:
        """Every env's targets at the mocap bodies' model poses."""
        pos, quat = smooth.mocap_defaults(m, nenv, m.qpos0.dtype, m.device)
        return dict(pos=pos.clone(), quat=quat.clone())

    def validate(self, state: MocapState) -> ServiceResult:
        """The reference's name check (:50-70)."""
        for name in state.name:
            if name not in self._m.body_names:
                return ServiceResult(False, f"body '{name}' does not exist")
            if self._m.body_mocapid[self._m.body(name)] < 0:
                return ServiceResult(False, f"body '{name}' is not a mocap body")
        return ServiceResult(True, "")

    def set_state(self, ps: Any, state: MocapState) -> Tuple[Any, ServiceResult]:
        """New state with each named body's target set in every env
        (state.env_id None) or in one; the quaternion normalised (:96-99)."""
        res = self.validate(state)
        if not res.success:
            return ps, res
        pos, quat = ps["pos"].clone(), ps["quat"].clone()
        envs = slice(None) if state.env_id is None else state.env_id
        for name, pose in zip(state.name, state.pose):
            mid = self._m.body_mocapid[self._m.body(name)]
            q = np.asarray(pose.orientation, dtype=np.float64)
            q = q / max(np.linalg.norm(q), 1e-15)
            pos[envs, mid] = torch.as_tensor(np.asarray(pose.position, dtype=np.float64),
                                             dtype=pos.dtype)
            quat[envs, mid] = torch.as_tensor(q, dtype=quat.dtype)
        return dict(pos=pos, quat=quat), res

    def control(self, m: Model, d: Data, ps: Any) -> Tuple[Data, Any]:
        if m.nmocap == 0:
            return d, ps
        return d.replace(mocap_pos=ps["pos"].to(d.qpos.dtype),
                         mocap_quat=ps["quat"].to(d.qpos.dtype)), ps
