"""Typed control-plane messages the port's server answers with.

Copies of the dataclasses in mujoco_ros_pkgs_tpu/msgs (one type per
mujoco_ros_msgs payload); the port cannot import that package, whose
__init__ imports JAX.
"""

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

import numpy as np


@dataclass
class Pose:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0, 0, 0]))  # (w,x,y,z)
    # the TF frame the pose is expressed in ("" / "world" = world frame)
    frame_id: str = ""


@dataclass
class Twist:
    linear: np.ndarray = field(default_factory=lambda: np.zeros(3))
    angular: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class BodyState:
    """mujoco_ros_msgs/BodyState (name, pose, twist, mass)."""
    name: str = ""
    pose: Pose = field(default_factory=Pose)
    twist: Twist = field(default_factory=Twist)
    mass: float = 0.0
    env_id: Optional[int] = None   # batched extension: which env (None = all)


@dataclass
class StateUint:
    """mujoco_ros_msgs/StateUint (loading request state)."""
    value: int = 0
    description: str = ""


@dataclass
class ServiceResult:
    """Common .srv response payload (success + status message)."""
    success: bool = True
    status_message: str = ""


@dataclass
class StepResult:
    success: bool = True


class EqConstraintType(IntEnum):
    """mujoco_ros_msgs/EqualityConstraintType."""
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3


@dataclass
class SolverParameters:
    """mujoco_ros_msgs/SolverParameters (solimp + solref)."""
    dmin: float = 0.9
    dmax: float = 0.95
    width: float = 0.001
    midpoint: float = 0.5
    power: float = 2.0
    timeconst: float = 0.02
    dampratio: float = 1.0


@dataclass
class EqualityConstraintParameters:
    """mujoco_ros_msgs/EqualityConstraintParameters."""
    name: str = ""
    type: int = int(EqConstraintType.CONNECT)
    active: bool = True
    solverParameters: SolverParameters = field(default_factory=SolverParameters)
    # connect
    anchor: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # weld
    relpose: Pose = field(default_factory=Pose)
    torquescale: float = 1.0
    # joint / tendon
    element1: str = ""
    element2: str = ""
    polycoef: np.ndarray = field(default_factory=lambda: np.zeros(5))
    env_id: Optional[int] = None


@dataclass
class MocapState:
    """mujoco_ros_msgs/MocapState (parallel arrays of names and poses)."""
    name: List[str] = field(default_factory=list)
    pose: List[Pose] = field(default_factory=list)
    env_id: Optional[int] = None


@dataclass
class SensorNoiseModel:
    """mujoco_ros_msgs/SensorNoiseModel."""
    sensor_name: str = ""
    mean: np.ndarray = field(default_factory=lambda: np.zeros(0))
    std: np.ndarray = field(default_factory=lambda: np.zeros(0))
    set_flag: int = 0     # bitmask 0x01/02/04 per dim
