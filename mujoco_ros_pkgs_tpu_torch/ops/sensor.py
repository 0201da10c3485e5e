"""Sensor evaluation stages (mj_sensorPos / mj_sensorVel / mj_sensorAcc).

Counterpart of mujoco_ros_pkgs_tpu/ops/sensor.py: this module owns the
stage split and the sensor-disable gate, ops/sensor_impl.py the sensor
types. A model without sensors, or with DisableBit.SENSOR set, passes
through each stage untouched.
"""

from __future__ import annotations

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, Model
from mujoco_ros_pkgs_tpu_torch.ops import sensor_impl


def _off(m: Model) -> bool:
    return m.nsensor == 0 or bool(m.opt.disableflags & DisableBit.SENSOR)


def sensor_pos(m: Model, d: Data) -> Data:
    return d if _off(m) else sensor_impl.sensor_pos(m, d)


def sensor_vel(m: Model, d: Data) -> Data:
    return d if _off(m) else sensor_impl.sensor_vel(m, d)


def sensor_acc(m: Model, d: Data) -> Data:
    return d if _off(m) else sensor_impl.sensor_acc(m, d)
