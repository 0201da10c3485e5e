"""Sensors plugin: noisy and ground-truth sensor readouts with Gaussian noise
models registered at run time (mujoco_ros_sensors).

Counterpart of mujoco_ros_pkgs_tpu/plugins/sensors.py. Reference behaviour
(mujoco_ros_sensors/src/mujoco_sensor_handler_plugin.cpp):
- once per server step (lastStageCallback) every sensor has a noisy value
  and a ground truth; the ground truth is withheld in eval mode
  (:64-68, 230, 262);
- reading = sensordata[adr] / cutoff where cutoff > 0 (:175-437);
- noise: value + N(0, 1) * std + mean per dim, where set_flag's bits
  0x01 / 0x02 / 0x04 enable it (:233-269); quaternion sensors get an RPY
  Euler perturbation quaternion composed onto the reading (:393-425);
- noise models are registered through `sensors/register_noise_models`
  (:123-173).

The state holds, per env, the per-dim noise parameters and the last
outputs, tensors (nenv, nsensordata). `load` must run before the hook (the
registry calls it). The draw is split from its use:
`last_stage` draws N(0, 1) from the server's torch.Generator on the batch's
device (utils/rng.randn: the global batch's draw, cut to the rank's rows,
where the batch is split over ranks) and hands it to `apply_noise`, a pure
function of its inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, Model, SensorType
from mujoco_ros_pkgs_tpu_torch.msgs import SensorNoiseModel
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.plugins.base import MujocoPlugin
from mujoco_ros_pkgs_tpu_torch.utils import rng

_QUAT_TYPES = (int(SensorType.FRAMEQUAT), int(SensorType.BALLQUAT))


def quat_adrs(m: Model) -> Tuple[int, ...]:
    """sensordata addresses of the quaternion sensors."""
    return tuple(m.sensor_adr[i] for i in range(m.nsensor)
                 if m.sensor_type[i] in _QUAT_TYPES)


def cutoff_scale(m: Model, dtype) -> torch.Tensor:
    """(nsensordata,) on the model's device: 1 / cutoff on the dims of a
    sensor with cutoff > 0, else 1 (reads the cutoffs back to the host)."""
    scale = np.ones(m.nsensordata)
    cut = m.sensor_cutoff.double().cpu().numpy()
    for i in range(m.nsensor):
        if cut[i] > 0:
            adr = m.sensor_adr[i]
            scale[adr:adr + m.sensor_dim[i]] = 1.0 / max(cut[i], mmath.MINVAL)
    return mmath.static_tensor(scale, m.device, dtype)


def apply_noise(gt: torch.Tensor, normal: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor, enabled: torch.Tensor, quat_adr=()) -> torch.Tensor:
    """The noisy reading of the (cutoff-scaled) ground truth gt (B, n), given
    N(0, 1) draws `normal` (B, n) and per-dim mean, std and enabled (0 / 1)
    that broadcast against it: gt + enabled * (normal * std + mean), except
    that each quaternion at an address in quat_adr is rotated by the
    perturbation quaternion of the Euler angles (extrinsic XYZ) that its
    first three dims' noise gives."""
    noise = enabled * (normal * std + mean)
    noisy = gt + noise
    if not quat_adr:
        return noisy
    parts, at = [], 0
    for adr in quat_adr:
        dq = mmath.euler_to_quat(noise[..., adr:adr + 3])
        parts += [noisy[..., at:adr], mmath.quat_mul(dq, gt[..., adr:adr + 4])]
        at = adr + 4
    return torch.cat(parts + [noisy[..., at:]], -1)


class SensorsPlugin(MujocoPlugin):
    """State: dict(mean, std, enabled, noisy, gt), each (nenv, nsensordata);
    the noise parameters are per data dim, expanded from the per-sensor
    models registered."""

    def __init__(self, config=None):
        super().__init__(config)
        self.eval_mode = bool((config or {}).get("eval_mode", False))
        self._models: Dict[str, SensorNoiseModel] = {}

    def load(self, m: Model, d: Data) -> bool:
        self._m = m
        # read once here: last_stage then copies nothing from the device
        self._scale = cutoff_scale(m, m.qpos0.dtype)
        self._quat_adr = quat_adrs(m)
        return True

    def init_state(self, m: Model, nenv: int) -> Any:
        # registered noise models persist across reset (the reference keeps
        # them as plugin members): the per-dim arrays are rebuilt from them
        dtype = m.qpos0.dtype
        mean, std, enabled = (a.expand(nenv, -1).clone() for a in self.noise_arrays(m))
        z = torch.zeros(nenv, m.nsensordata, dtype=dtype, device=m.device)
        return dict(mean=mean, std=std, enabled=enabled, noisy=z, gt=z.clone())

    # -- control plane --
    def register_noise_models(self, models) -> int:
        """Keeps the models of known sensors; returns how many it rejected."""
        rejected = 0
        for nm in models:
            if nm.sensor_name not in self._m.sensor_names:
                rejected += 1
                continue
            self._models[nm.sensor_name] = nm
        return rejected

    def noise_arrays(self, m: Model):
        """The registered models as per-dim (mean, std, enabled) tensors
        (nsensordata,) on the model's device, in its dtype; models of
        sensors that m lacks are skipped."""
        mean, std, enabled = (np.zeros(m.nsensordata) for _ in range(3))
        for name, nm in self._models.items():
            if name not in m.sensor_names:
                continue
            s = m.sensor(name)
            adr, dim = m.sensor_adr[s], m.sensor_dim[s]
            for k in range(3 if m.sensor_type[s] in _QUAT_TYPES else dim):
                if nm.set_flag & (1 << k):
                    if k < len(nm.mean):
                        mean[adr + k] = nm.mean[k]
                    if k < len(nm.std):
                        std[adr + k] = nm.std[k]
                    enabled[adr + k] = 1.0
        return tuple(torch.as_tensor(a, dtype=m.qpos0.dtype, device=m.device)
                     for a in (mean, std, enabled))

    # -- the hook --
    def last_stage(self, m: Model, d: Data, ps: Any,
                   generator: torch.Generator) -> Tuple[Data, Any]:
        gt = d.sensordata * self._scale.to(d.sensordata.dtype)
        normal = rng.randn(gt.shape, generator, gt.dtype, gt.device)
        noisy = apply_noise(gt, normal, ps["mean"], ps["std"], ps["enabled"],
                            self._quat_adr)
        return d, dict(ps, noisy=noisy, gt=gt)
